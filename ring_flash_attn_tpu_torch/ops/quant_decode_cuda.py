"""Launcher of kernel B4, decode over a contiguous quantized cache
(``csrc/quant_decode.cu``), and the work plan that B4, B5 and B6 share.

It replaces the TPU kernel ``ring_flash_attn_tpu/ops/quant_decode_pallas.py
::_kernel``. ``ops/quant.py::quant_decode_attention`` sends CUDA tensors
here and CPU tensors to the kernel's plain version,
``ops/quant.py::_plain_quant_decode``. See ``csrc/quant_decode.cuh`` for
what bounds the kernel on the H100 and how its design answers that.
"""

import ctypes
import functools

import torch

from . import _build
from .flash_fwd_cuda import head_dim_error

HEAD_DIMS = (64, 128, 256)  # the head dims the decode loop is built for
# the most of a kv head's G * Tq query rows that the small-row loop serves,
# by head dim (csrc/quant_decode.cuh::max_rows); past it the row-tile loop
# serves tiles of ROW_TILE rows (row_tile: a consumer warpgroup's 64 rows,
# two of them up to 128), a group of the plan a tile. The workspace is
# laid out by them and each launch passes the rows a partial holds
# (``row_groups``): a library that lays them out otherwise refuses the
# launch (rfa_qd::dispatch_rows)
MAX_ROWS = {64: 16, 128: 16, 256: 8}
ROW_TILE = {64: 128, 128: 128, 256: 64}
CHUNK = 64  # tokens per chunk in the kernels (C in quant_decode.cuh)
# The blocks a launch cuts its groups over (one per SM of 132: a block runs
# 1 to 3 pipelines side by side) and the fewest chunks worth a block beyond
# one a group (TARGET_BLOCKS and MIN_CHUNKS in quant_decode.cuh::
# plan_piece).
TARGET_BLOCKS = 132
MIN_CHUNKS = 4
# The row-tile loop's blocks come in clusters of TILE_CLUSTER, the unit of
# its plan (a cluster takes a piece and deals its chunks out to its blocks,
# which merge their rows across the cluster), a group cut over up to
# TILE_CLUSTERS of them (as many as the H100 holds at once), at a load of
# at least TILE_MIN_CHUNKS chunks a block (quant_decode.cuh::TILE_CLUSTER,
# TILE_CLUSTERS, TILE_MIN_CHUNKS).
TILE_CLUSTER = 4
TILE_CLUSTERS = 30
TILE_MIN_CHUNKS = 2
QTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}

# rfa_quant_decode(q, q_bf16, k_q, v_q, k_scale, v_scale, len_ptr, len_val,
#                  out, lse, part_acc, part_ml, counters, B, Hq, Hkv, Tq,
#                  head_dim, S, qtype, grid, rp, scale, softcap, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _lib():
    lib = _build.library("quant_decode")
    lib.rfa_quant_decode.argtypes = _ARGTYPES
    lib.rfa_quant_decode.restype = ctypes.c_int
    return lib


def check_operand(name, x, dev, dtypes, ndim):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {tuple(dtypes)} for the "
                        f"kernel, got {x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_rows(hq, hkv, tq, d):
    """The decode kernels take head dims HEAD_DIMS and any whole group of
    q heads a kv head (any number of rows (Hq / Hkv) * Tq)."""
    if d not in HEAD_DIMS:
        head_dim_error(d, "the decode kernels B4, B5 and B6", HEAD_DIMS)
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq must be a multiple of Hkv, got Hq={hq} "
                         f"Hkv={hkv} Tq={tq}")


def row_groups(rows, d):
    """(row groups a kv head, rows a row group's partials hold) of a launch
    with ``rows`` = (Hq / Hkv) * Tq rows a kv head at head dim d: one group
    of all rows up to MAX_ROWS[d]; past it the row tiles,
    ceil(rows / ROW_TILE[d]) groups whose partials hold ROW_TILE[d] rows
    (the last tile may hold fewer rows)."""
    if rows <= MAX_ROWS[d]:
        return 1, rows
    per = ROW_TILE[d]
    return -(-rows // per), per


def plan_grid(groups, max_chunks, tiles=False):
    """Blocks of a launch of B4, B5 or B6 from shapes alone (no host sync):
    one a group at least, so that a block holds at most one piece; beyond
    that up to the card's SMs, and no more than one a MIN_CHUNKS chunks of
    ``groups`` lanes of ``max_chunks`` chunks (the longest the cache
    allows). The device's plan (``work_plan``) uses up to this many, and
    cuts a group over several only within TARGET_BLOCKS. With ``tiles``
    (the row-tile loop, past MAX_ROWS rows a kv head) the same in clusters
    of TILE_CLUSTER blocks (``tile_plan``), up to TILE_CLUSTERS of them, at
    TILE_MIN_CHUNKS chunks a block. The plan counts chunks in 32 bits with room to spare: a launch
    of 2^30 or more raises."""
    if groups * max_chunks >= 2**30:
        raise ValueError(f"{groups} groups of up to {max_chunks} chunks are "
                         "more than the decode plan counts")
    cs, units, least = ((TILE_CLUSTER, TILE_CLUSTERS,
                         TILE_CLUSTER * TILE_MIN_CHUNKS) if tiles
                        else (1, TARGET_BLOCKS, MIN_CHUNKS))
    return cs * max(1, groups, min(units, -(-groups * max_chunks // least)))


def paged_plan_grid(b, hkv, npages, page_size, nrg=1, tiles=False):
    """``plan_grid`` of a paged cache (B5, B6): B * Hkv * nrg groups (nrg
    row groups a kv head, ``row_groups``), each lane at most npages pages
    of ceil(page_size / CHUNK) chunks; with ``tiles`` the row-tile loop's
    chunks (``tile_max_chunks``)."""
    most = (tile_max_chunks(npages, page_size) if tiles
            else npages * -(-page_size // CHUNK))
    return plan_grid(b * hkv * nrg, most, tiles)


def tile_max_chunks(npages, page_size):
    """The most chunks a paged lane of ``npages`` pages holds in the
    row-tile loop (``tile_chunks``)."""
    return -(-npages // pages_a_chunk(page_size)) * -(-page_size // CHUNK)


def lane_chunks(length, page_size=None):
    """The live chunks of a lane of ``length`` tokens: CHUNK-token chunks,
    which in a paged cache never span a page (quant_decode.cuh::
    PagedLanes::chunks; no page size: B4's contiguous cache)."""
    if length <= 0:
        return 0
    if page_size is None:
        return -(-length // CHUNK)
    full = (length - 1) // page_size  # pages before the last live one
    return full * -(-page_size // CHUNK) + -(-(length - full * page_size)
                                            // CHUNK)


def pages_a_chunk(page_size):
    """Pages a chunk of the row-tile loop holds: CHUNK // page_size where
    pages of 2 to CHUNK / 2 tokens divide CHUNK (a chunk is then CHUNK
    positions of the lane over whole pages), else 1
    (quant_decode.cuh::pages_a_chunk)."""
    if page_size is not None and 2 <= page_size < CHUNK and \
            CHUNK % page_size == 0:
        return CHUNK // page_size
    return 1


def tile_chunks(length, page_size=None):
    """The live chunks of a lane of ``length`` tokens in the row-tile loop
    (quant_decode.cuh::TileLanes): ceil(length / CHUNK) where a chunk holds
    several pages (``pages_a_chunk``), else ``lane_chunks``."""
    if pages_a_chunk(page_size) > 1:
        return -(-max(length, 0) // CHUNK)
    return lane_chunks(length, page_size)


def work_plan(chunks, groups_per_lane, grid):
    """The device's work plan (``csrc/quant_decode.cuh::plan_piece``, made
    in every block from the lanes' live chunks), step by step as the
    kernel takes it. ``chunks[b]``: lane b's live chunks (every kv head's
    and row group's alike); group g = b * groups_per_lane + x. Each live
    group takes ceil(n / L) whole blocks, its n chunks cut into that many
    near-equal runs of consecutive chunks, at the least load L of at least
    min(MIN_CHUNKS, the longest lane's chunks) whose blocks fit in
    max(live groups, min(grid, TARGET_BLOCKS)); the groups take the blocks
    in order.

    Returns (used blocks, [block p's pieces]), at most one piece a block, a
    piece a dict: group, first (its first chunk in the group), chunks,
    whole (the group in one piece: it writes (out, lse) itself), and
    otherwise slot (its partial's slot, its block p), first_slot and
    pieces (the group's pieces, in consecutive slots, merged in that order
    by the group's last block, whose counter target that is)."""
    return _plan(chunks, groups_per_lane, grid, TARGET_BLOCKS, MIN_CHUNKS)


def tile_plan(chunks, groups_per_lane, grid):
    """The row-tile loop's plan (``plan_piece<TILE_CLUSTER>`` and
    ``decode_tiles``): ``work_plan``'s in clusters of cs = TILE_CLUSTER
    blocks, grid // cs of them, TILE_CLUSTERS cut, at a load of at least cs
    * TILE_MIN_CHUNKS chunks (``chunks``: ``tile_chunks``). Cluster c's
    piece is dealt out to its blocks c * cs + r, r = 0 .. cs - 1, the
    first (chunks % cs) of them a chunk more.

    Returns (used blocks, [block p's pieces]): each block of a used
    cluster one piece, a dict of its cluster's piece (group; whole, or
    slot, first_slot and pieces of the cluster partials, counted in
    clusters) with its own first and chunks (0 in a block past the
    cluster's chunks), its cluster and rank, and counter, the group's
    counter of that rank (group * TILE_CLUSTER + rank)."""
    cs = TILE_CLUSTER
    used, runs_c = _plan(chunks, groups_per_lane, grid // cs, TILE_CLUSTERS,
                         cs * TILE_MIN_CHUNKS)
    runs = [[] for _ in range(grid)]
    for c, run in enumerate(runs_c):
        for piece in run:
            q, rem = divmod(piece["chunks"], cs)
            for r in range(cs):
                runs[c * cs + r].append(dict(
                    piece, first=piece["first"] + r * q + min(r, rem),
                    chunks=q + (r < rem), cluster=c, rank=r,
                    counter=piece["group"] * cs + r))
    return used * cs, runs


def _plan(chunks, groups_per_lane, grid, target, least):
    """``work_plan`` over ``grid`` units (blocks, or clusters), ``target``
    of them cut, at a load of at least ``least`` chunks."""
    gl = groups_per_lane
    runs = [[] for _ in range(grid)]
    live = [n for n in chunks if n > 0]
    if not live:
        return 0, runs
    cap = max(len(live) * gl, min(grid, target))
    nmax = max(live)

    def blocks_at(load):
        return gl * sum(-(-n // load) for n in live)

    load = max(min(least, nmax), -(-sum(live) * gl // cap))
    if blocks_at(load) > cap:  # load nmax fits: a block a live group
        lo, hi = load, nmax
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if blocks_at(mid) <= cap else (mid, hi)
        load = hi
    p = 0
    for b, n in enumerate(chunks):
        s = -(-n // load)
        for x in range(gl if n else 0):
            for k in range(s):
                piece = dict(group=b * gl + x, first=k * n // s,
                             chunks=(k + 1) * n // s - k * n // s,
                             whole=s == 1)
                if s > 1:
                    piece.update(slot=p, first_slot=p - k, pieces=s)
                runs[p].append(piece)
                p += 1
    return p, runs


def plan_counters(groups, tiles):
    """The counters of a launch's workspace: one a group; in the row-tile
    loop (``tiles``) one a rank of the group's clusters, TILE_CLUSTER a
    group."""
    return groups * (TILE_CLUSTER if tiles else 1)


_WORKSPACES = {}  # (device, stream) -> (fp32 partials, int32 counters)


def _buffers(floats, groups, dev, stream):
    """The (device, stream)'s workspace, grown to at least ``floats``
    partial floats and ``groups`` counters. Counters are zeroed once, when
    allocated: a launch leaves them zero (each group's last block resets
    its own). Launches on one stream run in order, so they share it; two
    streams never do."""
    ws = _WORKSPACES.get((dev, stream))
    if ws is None or ws[0].numel() < floats or ws[1].numel() < groups:
        old_f, old_g = (0, 0) if ws is None else (ws[0].numel(),
                                                  ws[1].numel())
        ws = (torch.empty(max(floats, old_f), dtype=torch.float32,
                          device=dev),
              torch.zeros(max(groups, old_g), dtype=torch.int32, device=dev))
        _WORKSPACES[(dev, stream)] = ws
    return ws


def scratch_ptrs(groups, grid, rows, d, dev, stream):
    """The scratch of a launch of B4, B5 or B6 over ``grid`` blocks at head
    dim d on ``stream``, as the kernels take it: part_acc (slots, rows, d)
    and part_ml (slots, rows, 2) fp32, slots = min(grid, TARGET_BLOCKS), a
    slot for each piece of a group cut across blocks (its block:
    ``work_plan``), which the group's last block merges, one after the
    other in the workspace, and counters (groups,) int32; with row groups,
    ``groups`` counts them and ``rows`` is a row group's (``row_groups``).
    Three nulls with one block: it writes every (out, lse) itself."""
    if grid == 1:
        return None, None, None
    slots = min(grid, TARGET_BLOCKS)
    n_acc = slots * rows * d
    part, counters = _buffers(n_acc + slots * rows * 2, groups, dev, stream)
    ptr = part.data_ptr()
    return ptr, ptr + 4 * n_acc, counters.data_ptr()


def quant_decode_cuda(q, k_q, k_scale, v_q, v_scale, length, scale,
                      softcap=None):
    """Quantized-cache decode on the card: fp32 (out (B,Hq,Tq,D), lse
    (B,Hq,Tq)).

    q (B, Hq, Tq, D) bf16 or fp32; k_q, v_q (B, Hkv, S, D) int8,
    float8_e4m3fn or float8_e5m2 with D 64, 128 or 256 and any S >= 1;
    scales (B, Hkv, S) fp32; any whole group Hq / Hkv and any Tq (past
    MAX_ROWS[D] rows a kv head, a group of the plan a tile of ROW_TILE[D]
    of them).
    ``length`` is a Python int or
    a 1-element int32 CUDA tensor, which the kernel reads on the device
    (no host sync); it is clamped to [0, S]."""
    dev = q.device
    check_operand("q", q, dev, (torch.bfloat16, torch.float32), 4)
    check_operand("k_q", k_q, dev, tuple(QTYPES), 4)
    check_operand("v_q", v_q, dev, (k_q.dtype,), 4)
    check_operand("k_scale", k_scale, dev, (torch.float32,), 3)
    check_operand("v_scale", v_scale, dev, (torch.float32,), 3)
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k_q.shape
    if (k_q.shape[0] != b or k_q.shape[3] != d or v_q.shape != k_q.shape
            or k_scale.shape != (b, hkv, s) or v_scale.shape != (b, hkv, s)):
        raise ValueError(
            f"q {tuple(q.shape)}, cache {tuple(k_q.shape)}/"
            f"{tuple(v_q.shape)} and scales {tuple(k_scale.shape)}/"
            f"{tuple(v_scale.shape)} do not match")
    check_rows(hq, hkv, tq, d)
    if s < 1:
        raise ValueError("the cache holds no position")
    if isinstance(length, torch.Tensor):
        if (not length.is_cuda or length.device != dev
                or length.dtype != torch.int32 or length.numel() != 1):
            raise TypeError("a tensor length must be one int32 on q's device "
                            f"(or pass a Python int), got {length.dtype} "
                            f"{tuple(length.shape)} on {length.device}")
        len_ptr, len_val = length.data_ptr(), 0
    else:
        len_ptr, len_val = None, max(0, min(int(length), s))
    out = torch.empty((b, hq, tq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    nrg, rows = row_groups((hq // hkv) * tq, d)
    tiles = rows > MAX_ROWS[d]
    grid = plan_grid(b * hkv * nrg, -(-s // CHUNK), tiles)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part_acc, part_ml, counters = scratch_ptrs(
            plan_counters(b * hkv * nrg, tiles), grid, rows, d, dev, stream)
        rc = lib.rfa_quant_decode(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
            v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), len_ptr,
            len_val, out.data_ptr(), lse.data_ptr(), part_acc, part_ml,
            counters, b, hq, hkv, tq, d, s, QTYPES[k_q.dtype], grid, rows,
            float(scale), float(softcap or 0.0), stream,
        )
        quant_decode_cuda.launches += 1
    _build.check_launch(lib, rc, "quant_decode")
    return out, lse


quant_decode_cuda.launches = 0
