"""Launcher of kernel B4, decode over a contiguous quantized cache
(``csrc/quant_decode.cu``), and the split plan that B4, B5 and B6 share.

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
# the most of a kv head's G * Tq query rows that one block serves, by head
# dim (csrc/quant_decode.cuh::max_rows); past it a launch takes one block
# row per row group of that many rows. The workspace is laid out by it and
# each launch passes its row group's rows (``row_groups``): a library whose
# max_rows differs refuses the launch (rfa_qd::dispatch_rows)
MAX_ROWS = {64: 16, 128: 16, 256: 8}
CHUNK = 64  # tokens per chunk in the kernels (C in quant_decode.cuh)
# Blocks to aim for (one per SM of 132: a block runs 1 to 3 pipelines
# side by side, quant_decode.cuh) and the fewest chunks worth a block.
TARGET_BLOCKS = 132
MIN_CHUNKS = 8
QTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}

# rfa_quant_decode(q, q_bf16, k_q, v_q, k_scale, v_scale, len_ptr, len_val,
#                  out, lse, part_acc, part_ml, counters, B, Hq, Hkv, Tq,
#                  head_dim, S, qtype, nsplit, rp, scale, softcap, stream)
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
    of all rows up to MAX_ROWS[d], else ceil(rows / MAX_ROWS[d]) groups of
    MAX_ROWS[d] (the last may hold fewer)."""
    per = MAX_ROWS[d]
    if rows <= per:
        return 1, rows
    return -(-rows // per), per


def num_splits(groups, max_chunks):
    """Blocks that share one (batch, kv head) group's tokens: as many as
    fill the card's SMs without a second wave, each with at least
    MIN_CHUNKS chunks of the longest possible sequence (a block takes
    ceil(max_chunks / splits) chunks of it). Depends on shapes only, so
    results are reproducible (the partials merge in split order)."""
    return max(1, min(TARGET_BLOCKS // groups, max_chunks // MIN_CHUNKS))


def paged_num_splits(b, hkv, npages, page_size, nrg=1):
    """``num_splits`` of a paged cache (B5, B6): B * Hkv * nrg groups (nrg
    row groups a kv head, ``row_groups``), each lane at most npages pages
    of ceil(page_size / CHUNK) chunks."""
    return num_splits(b * hkv * nrg, npages * -(-page_size // CHUNK))


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


def scratch_ptrs(groups, nsplit, rows, d, dev, stream):
    """The scratch of a split launch of B4, B5 or B6 at head dim d on
    ``stream``, as the kernels take it: part_acc (groups, nsplit, rows, d)
    and part_ml (groups, nsplit, rows, 2) fp32, the partials that each
    group's last block merges, one after the other in the workspace, and
    counters (groups,) int32; with row groups, ``groups`` counts them and
    ``rows`` is a row group's (``row_groups``). Three nulls with one split:
    the block then writes (out, lse) itself."""
    if nsplit == 1:
        return None, None, None
    n_acc = groups * nsplit * rows * d
    part, counters = _buffers(n_acc + groups * nsplit * rows * 2, groups,
                              dev, stream)
    ptr = part.data_ptr()
    return ptr, ptr + 4 * n_acc, counters.data_ptr()


def quant_decode_cuda(q, k_q, k_scale, v_q, v_scale, length, scale,
                      softcap=None):
    """Quantized-cache decode on the card: fp32 (out (B,Hq,Tq,D), lse
    (B,Hq,Tq)).

    q (B, Hq, Tq, D) bf16 or fp32; k_q, v_q (B, Hkv, S, D) int8,
    float8_e4m3fn or float8_e5m2 with D 64, 128 or 256 and any S >= 1;
    scales (B, Hkv, S) fp32; any whole group Hq / Hkv and any Tq (past
    MAX_ROWS[D] rows a kv head, one block row per row group of them).
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
    nsplit = num_splits(b * hkv * nrg, -(-s // CHUNK))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part_acc, part_ml, counters = scratch_ptrs(b * hkv * nrg, nsplit,
                                                   rows, d, dev, stream)
        rc = lib.rfa_quant_decode(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
            v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), len_ptr,
            len_val, out.data_ptr(), lse.data_ptr(), part_acc, part_ml,
            counters, b, hq, hkv, tq, d, s, QTYPES[k_q.dtype], nsplit, rows,
            float(scale), float(softcap or 0.0), stream,
        )
        quant_decode_cuda.launches += 1
    _build.check_launch(lib, rc, "quant_decode")
    return out, lse


quant_decode_cuda.launches = 0
