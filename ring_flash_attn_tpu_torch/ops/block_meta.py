"""Tile bounds of segment ids and positions for the block kernels' skip
and dispatch.

The port of ``ring_flash_attn_tpu/ops/pallas_fwd.py::_block_bounds`` and
``::block_meta``, in torch on the tensors' device (no ``.item()``, no
``nonzero``, no host sync), at a kernel's own tile sizes, with a ragged
last tile bounded over its valid entries only. The kernels B1, B2,
B3a and B3b read the rows to skip a tile whose segments cannot meet or
whose positions lie wholly above the diagonal or, under a causal window,
wholly left of it, to run their unmasked body where one segment covers
both sides inside the mask, and their masked body otherwise; rows 4 and 5
bound the loop. Positions reach the kernels under a causal mask on them,
under ALiBi, a window or dropout (``mask.kernel_positions``), whose
distance, band or hash they give; rows 4 and 5 skip on positions only
under the causal mask, as the JAX package's do (the kernels' own classes
also take a non-causal window's band, ``csrc/band.cuh``).

This module also holds what every launch of the four kernels passes
beside the tensors: ``launch_masked`` picks the instantiation (mask-free,
segmented, with softcap/ALiBi, ``csrc/xform.cuh``, or with a window or
dropout, ``csrc/band.cuh``) and builds its arguments.

Tile sizes of the kernels (``csrc/flash_fwd.cuh``, ``csrc/flash_bwd.cuh``,
``csrc/flash_bwd_split.cu``): B1 128 q rows and 128 keys, B3a 128 q rows
and 64 keys, B2 and B3b 128 keys a block and 64 q rows a step.
"""

import collections
import ctypes

import torch

from .mask import (MaskArgs, as_int, causal_offset, dropout_threshold,
                   kernel_positions)

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
LOG2E = 1.4426950408889634


def _tile_bounds(x, blk):
    """(min, max) int32 of each tile of ``blk`` entries of the 1-D x, the
    last tile over the entries it has."""
    x = x.to(torch.int32)
    n = x.shape[0]
    pad = -n % blk
    lo, hi = x, x
    if pad:
        lo = torch.cat([x, x.new_full((pad,), INT32_MAX)])
        hi = torch.cat([x, x.new_full((pad,), INT32_MIN)])
    return lo.view(-1, blk).amin(1), hi.view(-1, blk).amax(1)


def tile_steps(x, blk):
    """(n_tiles,) int32 of the 1-D x in tiles of ``blk``: the step s where
    a tile's valid entries run x[first] + s i (0 for one entry), else
    INT32_MIN. The XFORM instantiations take ALiBi's distance on such a
    tile from its first position and step, without the masked body."""
    x = x.to(torch.int32)
    n = x.shape[0]
    n_t = -(-n // blk)
    pad = n_t * blk - n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    v = x.view(n_t, blk)
    if blk == 1:
        return torch.zeros(n_t, dtype=torch.int32, device=x.device)
    d = v[:, 1:] - v[:, :-1]
    valid = (torch.arange(n_t * blk, device=x.device) < n).view(
        n_t, blk)[:, 1:]
    step = torch.where(valid[:, 0], d[:, 0], torch.zeros_like(d[:, 0]))
    ok = ((d == step[:, None]) | ~valid).all(1)
    return torch.where(ok, step, torch.full_like(step, INT32_MIN))


def _needed_range(needed, dim):
    """First and last True index along ``dim`` of a 2-D bool matrix, 0
    and 0 where there is none, int32."""
    n = needed.shape[dim]
    as_int = needed.to(torch.int8)
    any_ = needed.any(dim=dim)
    first = torch.argmax(as_int, dim=dim)
    last = n - 1 - torch.argmax(as_int.flip(dim), dim=dim)
    zero = torch.zeros_like(first)
    return (torch.where(any_, first, zero).to(torch.int32),
            torch.where(any_, last, zero).to(torch.int32))


def block_meta(mask: MaskArgs, blk_q, blk_kv, sq, skv, device=None):
    """(q_meta (6, n_q), kv_meta (6, n_kv)) int32 on ``device``, n_q =
    ceil(Sq / blk_q) and n_kv = ceil(Skv / blk_kv):

      q_meta rows:  seg_min, seg_max, pos_min, pos_max, first and last
                    needed kv tile
      kv_meta rows: seg_min, seg_max, pos_min, pos_max, first and last
                    needed q tile

    A (q tile, kv tile) pair is not needed when its segment ranges are
    disjoint, or, causal with positions, when every q position is below
    every kv position or, with ``window_left``, every distance is past
    it. Rows of a field the mask lacks are 0. The causal
    bound by index is the kernels' own arithmetic, not here."""
    use_seg = mask.q_segids is not None
    use_pos = mask.q_pos is not None
    n_q, n_kv = -(-sq // blk_q), -(-skv // blk_kv)
    zq = torch.zeros(n_q, dtype=torch.int32, device=device)
    zk = torch.zeros(n_kv, dtype=torch.int32, device=device)
    qsmin = qsmax = qpmin = qpmax = zq
    ksmin = ksmax = kpmin = kpmax = zk

    def ids(x, n):
        t = torch.as_tensor(x, device=device)
        if t.shape != (n,):
            raise ValueError(f"segment ids and positions must be ({n},), got "
                             f"{tuple(t.shape)}")
        return t

    skip = torch.zeros((n_q, n_kv), dtype=torch.bool, device=device)
    if use_seg:
        qsmin, qsmax = _tile_bounds(ids(mask.q_segids, sq), blk_q)
        ksmin, ksmax = _tile_bounds(ids(mask.kv_segids, skv), blk_kv)
        skip |= (qsmax[:, None] < ksmin[None, :]) | (
            ksmax[None, :] < qsmin[:, None])
    if use_pos:
        qpmin, qpmax = _tile_bounds(ids(mask.q_pos, sq), blk_q)
        kpmin, kpmax = _tile_bounds(ids(mask.kv_pos, skv), blk_kv)
        if mask.causal:
            skip |= qpmax[:, None] < kpmin[None, :]
            if mask.window_left is not None:
                skip |= (qpmin[:, None] - kpmax[None, :]) > mask.window_left
    needed = ~skip
    kv_first, kv_last = _needed_range(needed, 1)
    q_first, q_last = _needed_range(needed, 0)
    q_meta = torch.stack([qsmin, qsmax, qpmin, qpmax, kv_first, kv_last])
    kv_meta = torch.stack([ksmin, ksmax, kpmin, kpmax, q_first, q_last])
    return q_meta.contiguous(), kv_meta.contiguous()


# ---- what the launchers of the segmented instantiations pass ----


class SegArgs(ctypes.Structure):
    """``rfa_seg_args`` of ``csrc/segments.cuh``."""
    _fields_ = [("q_seg", ctypes.c_void_p), ("kv_seg", ctypes.c_void_p),
                ("q_pos", ctypes.c_void_p), ("kv_pos", ctypes.c_void_p),
                ("q_meta", ctypes.c_void_p), ("kv_meta", ctypes.c_void_p),
                ("n_q", ctypes.c_int), ("n_kv", ctypes.c_int),
                ("tri", ctypes.c_int), ("pos_causal", ctypes.c_int),
                ("q_step", ctypes.c_void_p), ("kv_step", ctypes.c_void_p)]


class XformArgs(ctypes.Structure):
    """``rfa_xform_args`` of ``csrc/xform.cuh``."""
    _fields_ = [("slopes", ctypes.c_void_p), ("cap2", ctypes.c_float),
                ("pos_off", ctypes.c_int), ("alibi_abs", ctypes.c_int)]


class BandArgs(ctypes.Structure):
    """``rfa_band_args`` of ``csrc/band.cuh``."""
    _fields_ = [("wl", ctypes.c_int), ("wr", ctypes.c_int),
                ("thr", ctypes.c_uint32), ("inv_keep", ctypes.c_float),
                ("seed", ctypes.c_uint32), ("seed_ptr", ctypes.c_void_p),
                ("head_offset", ctypes.c_uint32),
                ("q_pos0", ctypes.c_uint32), ("kv_pos0", ctypes.c_uint32)]


NO_BOUND = INT32_MAX  # a window side without a bound


def segmented(mask: MaskArgs):
    """True when the mask needs the kernels' segmented instantiations:
    segment ids, or explicit positions that reach the kernels
    (``kernel_positions``: causal on them, or ALiBi)."""
    return mask.has_segment_mask or kernel_positions(mask)


def has_xform(mask: MaskArgs):
    """True when the mask has softcap or ALiBi: the kernels' XFORM
    instantiations."""
    return bool(mask.softcap) or mask.alibi_slopes is not None


def has_band(mask: MaskArgs):
    """True when the mask has a window or dropout: the kernels' BAND
    instantiations (``csrc/band.cuh``), which carry softcap and ALiBi too."""
    return mask.has_window or bool(mask.dropout_p)


def band_all(mask: MaskArgs):
    """True when a BAND mask takes the kernels' ALL build (dropout,
    softcap or ALiBi beside the window), not the build of a window alone;
    the C entry points pick it by the same test."""
    return has_band(mask) and (bool(mask.dropout_p) or has_xform(mask))


# a block's shared memory on the H100 (csrc/segments.cuh::MAX_SMEM)
MAX_SMEM = 232448


def max_class_tiles(smem_bytes):
    """The most tiles whose segment classes (two bits a tile, in 4-byte
    words: ``csrc/segments.cuh::class_bytes``) fit in shared memory beside
    a kernel's own ``smem_bytes`` (its tiles, barriers and 1024-byte
    alignment pad)."""
    return max(0, MAX_SMEM - smem_bytes) // 4 * 16


def index_causal(mask: MaskArgs):
    """The kernels' ``causal`` flag: causal by index (at the mask's
    offset); a mask causal by positions passes 0 and its positions."""
    return bool(mask.causal) and mask.q_pos is None


def _id_operand(name, x, n, dev):
    """x as a contiguous int32 (n,) tensor on ``dev``; a tensor must lie
    there already, an array or list is copied there. int64 is narrowed,
    past int32's range it raises."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {x.device}")
    else:
        x = torch.as_tensor(x, device=dev)
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{name} must be ({n},), got {tuple(x.shape)}")
    if x.dtype == torch.int64:
        if n:
            lo, hi = torch.aminmax(x)
            if int(lo) < INT32_MIN or int(hi) > INT32_MAX:
                raise ValueError(f"{name} lies past int32's range")
        x = x.to(torch.int32)
    elif x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 or int64, got {x.dtype}")
    return x.contiguous()


# the last launches' SegArgs, keyed by the identity and version counter of
# the mask's tensors (held alive by the entry, so an id is not reused while
# cached; an in-place write bumps the version): a ring's steps and a
# forward's backward pass the same segment tensors again, and the bounds
# cost some 50 small launches of host time
_CACHE = collections.OrderedDict()
_CACHE_SIZE = 16


def kernel_segments(mask: MaskArgs, dev, sq, skv, blk_q, blk_kv):
    """(SegArgs, the tensors it points at) for a segmented launch at the
    kernel's tiles of ``blk_q`` q rows and ``blk_kv`` keys. The caller
    holds the tensors until the launch is queued."""
    pos = kernel_positions(mask)
    fields = (mask.q_segids, mask.kv_segids) + (
        (mask.q_pos, mask.kv_pos) if pos else (None, None))
    key = None
    if all(x is None or isinstance(x, torch.Tensor) for x in fields):
        key = (tuple(None if x is None else (id(x), x._version)
                     for x in fields),
               pos and bool(mask.causal), pos and mask.packed_self,
               pos and _needs_steps(mask), pos and mask.window_left,
               str(dev), sq, skv, blk_q, blk_kv)
        if key in _CACHE:
            _CACHE.move_to_end(key)
            return _CACHE[key][:2]
    args, keep = _kernel_segments(mask, pos, dev, sq, skv, blk_q, blk_kv)
    if key is not None:
        _CACHE[key] = (args, keep, fields)
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    return args, keep


# the slopes times log2(e) on the device, by the source tensor's identity
# and version (the entry holds the source, so its id is not reused): a
# schedule's steps pass the same slopes to every launch
_SLOPES = collections.OrderedDict()


def _kernel_slopes(alibi_slopes, hq, dev):
    key = None
    if isinstance(alibi_slopes, torch.Tensor):
        key = (id(alibi_slopes), alibi_slopes._version, hq, str(dev))
        if key in _SLOPES:
            _SLOPES.move_to_end(key)
            return _SLOPES[key][0]
    slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=dev).reshape(-1)
    if slopes.shape[0] != hq:
        raise ValueError(f"alibi_slopes must hold one slope per q head "
                         f"({hq}), got {slopes.shape[0]}")
    slopes = (slopes * LOG2E).contiguous()
    if key is not None:
        _SLOPES[key] = (slopes, alibi_slopes)
        if len(_SLOPES) > _CACHE_SIZE:
            _SLOPES.popitem(last=False)
    return slopes


def _needs_steps(mask: MaskArgs):
    """ALiBi or dropout on explicit positions: each tile's position step
    (``tile_steps``), which keeps an arithmetic tile in the unmasked body."""
    return mask.alibi_slopes is not None or bool(mask.dropout_p)


def kernel_xform(mask: MaskArgs, hq, dev):
    """(XformArgs, the slopes tensor it points at or None) for a launch
    with softcap or ALiBi (or a window or dropout, whose instantiations
    carry both): the slopes (Hq,) float32 on ``dev`` times log2(e), cap2 =
    softcap * log2(e), the offset of positions by index (where ALiBi or a
    window reads it) and whether ALiBi takes |distance| (not causal). The
    caller holds the tensor until the launch is queued."""
    slopes = None
    if mask.alibi_slopes is not None:
        slopes = _kernel_slopes(mask.alibi_slopes, hq, dev)
    pos_off = 0
    if mask.q_pos is None and (slopes is not None or mask.has_window
                               or index_causal(mask)):
        pos_off = causal_offset(mask)
        if not isinstance(pos_off, int) or abs(pos_off) >= 2**30:
            raise TypeError(f"the kernel takes a static int offset, got "
                            f"{pos_off!r}")
    cap2 = float(mask.softcap) * LOG2E if mask.softcap else 0.0
    args = XformArgs(None if slopes is None else slopes.data_ptr(), cap2,
                     pos_off, int(not mask.causal))
    return args, slopes


def _u32(x):
    return x & 0xFFFFFFFF


def kernel_band(mask: MaskArgs, dev):
    """(BandArgs, the seed tensor it points at or None) for a launch with
    a window or dropout: the window's sides (``NO_BOUND`` where unbounded;
    the right side only when not causal), the dropout threshold (0: none),
    1 / (1 - p), the seed (an int, or a one-element tensor on ``dev`` that
    the kernel reads), the head offset and the absolute positions of q row
    0 and of key 0 (the offsets), the last four as uint32 bits."""
    wl = NO_BOUND if mask.window_left is None else int(mask.window_left)
    wr = NO_BOUND
    if mask.window_right is not None and not mask.causal:
        wr = int(mask.window_right)
    if not (0 <= wl <= NO_BOUND and 0 <= wr <= NO_BOUND):
        raise ValueError(f"window sides must be >= 0, got {wl}, {wr}")
    thr, inv_keep, seed, seed_t = 0, 1.0, 0, None
    if mask.dropout_p:
        thr = dropout_threshold(mask.dropout_p)
        inv_keep = 1.0 / (1.0 - mask.dropout_p)
        if isinstance(mask.dropout_seed, torch.Tensor):
            seed_t = mask.dropout_seed.reshape(-1)
            if seed_t.numel() != 1:
                raise ValueError("dropout_seed must be a scalar")
            seed_t = seed_t.to(device=dev, dtype=torch.int32)
        else:
            seed = as_int(mask.dropout_seed, "dropout_seed")
    args = BandArgs(wl, wr, thr, inv_keep, _u32(seed),
                    None if seed_t is None else seed_t.data_ptr(),
                    _u32(as_int(mask.head_offset, "head_offset")),
                    _u32(as_int(mask.offset, "offset")),
                    _u32(as_int(mask.kv_offset, "kv_offset")))
    return args, seed_t


def launch_masked(fns, args, mask, q, k, tiles, stream):
    """Launch the instantiation the mask needs, for q (B, Hq, Sq, D) and k
    (B, Hkv, Skv, D); ``fns`` are the kernel's (mask-free, segmented,
    softcap/ALiBi, window/dropout) entry points: ``plain(*args, stream)``,
    ``seg(*args, seg, stream)`` with the tile bounds at ``tiles`` (q rows,
    keys) of the kernel, ``xform(*args, seg or None, xform, stream)``,
    ``band(*args, seg or None, xform, band, stream)``. Returns the
    launch's code."""
    plain_fn, seg_fn, xform_fn, band_fn = fns
    seg = None
    if segmented(mask):
        seg, _held = kernel_segments(mask, q.device, q.shape[2], k.shape[2],
                                     *tiles)
        seg = ctypes.byref(seg)
    if has_band(mask):
        xf, _slopes = kernel_xform(mask, q.shape[1], q.device)
        band, _seed = kernel_band(mask, q.device)
        return band_fn(*args, seg, ctypes.byref(xf), ctypes.byref(band),
                       stream)
    if has_xform(mask):
        xf, _slopes = kernel_xform(mask, q.shape[1], q.device)
        return xform_fn(*args, seg, ctypes.byref(xf), stream)
    if seg is None:
        return plain_fn(*args, stream)
    return seg_fn(*args, seg, stream)


def _kernel_segments(mask, pos, dev, sq, skv, blk_q, blk_kv):
    q_seg = kv_seg = q_pos = kv_pos = None
    if mask.has_segment_mask:
        q_seg = _id_operand("q_segids", mask.q_segids, sq, dev)
        kv_seg = _id_operand("kv_segids", mask.kv_segids, skv, dev)
    if pos:
        q_pos = _id_operand("q_pos", mask.q_pos, sq, dev)
        kv_pos = _id_operand("kv_pos", mask.kv_pos, skv, dev)
    pos_causal = pos and bool(mask.causal)
    meta_mask = MaskArgs(causal=pos_causal, q_segids=q_seg,
                         kv_segids=kv_seg, q_pos=q_pos, kv_pos=kv_pos,
                         window_left=mask.window_left if pos else None)
    q_meta, kv_meta = block_meta(meta_mask, blk_q, blk_kv, sq, skv, dev)
    keep = (q_seg, kv_seg, q_pos, kv_pos, q_meta, kv_meta)
    q_step = kv_step = None
    if pos and _needs_steps(mask):
        q_step, kv_step = tile_steps(q_pos, blk_q), tile_steps(kv_pos, blk_kv)
        keep += (q_step, kv_step)

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = SegArgs(ptr(q_seg), ptr(kv_seg), ptr(q_pos), ptr(kv_pos),
                   ptr(q_meta), ptr(kv_meta), q_meta.shape[1],
                   kv_meta.shape[1], int(pos_causal and mask.packed_self),
                   int(pos_causal), ptr(q_step), ptr(kv_step))
    return args, keep
