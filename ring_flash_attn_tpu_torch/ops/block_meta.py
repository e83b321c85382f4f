"""Tile bounds of segment ids and positions for the block kernels' skip
and dispatch.

The port of ``ring_flash_attn_tpu/ops/pallas_fwd.py::_block_bounds`` and
``::block_meta``, in torch on the tensors' device (no ``.item()``, no
``nonzero``, no host sync), at a kernel's own tile sizes, with a ragged
last tile bounded over its valid entries only. The kernels B1, B2,
B3a and B3b read the rows to skip a tile whose segments cannot meet or
whose positions lie wholly above the diagonal, to run their unmasked body
where one segment covers both sides below the diagonal, and their masked
body otherwise; rows 4 and 5 bound the loop.

Tile sizes of the kernels (``csrc/flash_fwd.cuh``, ``csrc/flash_bwd.cuh``,
``csrc/flash_bwd_split.cu``): B1 128 q rows and 128 keys, B3a 128 q rows
and 64 keys, B2 and B3b 128 keys a block and 64 q rows a step.
"""

import collections
import ctypes

import torch

from .mask import MaskArgs

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


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
    every kv position. Rows of a field the mask lacks are 0. The causal
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
                ("tri", ctypes.c_int)]


def segmented(mask: MaskArgs):
    """True when the mask needs the kernels' segmented instantiations:
    segment ids, or a causal mask on explicit positions (positions without
    causal constrain nothing)."""
    return mask.has_segment_mask or (mask.causal and mask.q_pos is not None)


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
    pos = mask.causal and mask.q_pos is not None
    fields = (mask.q_segids, mask.kv_segids) + (
        (mask.q_pos, mask.kv_pos) if pos else (None, None))
    key = None
    if all(x is None or isinstance(x, torch.Tensor) for x in fields):
        key = (tuple(None if x is None else (id(x), x._version)
                     for x in fields),
               pos and mask.packed_self, str(dev), sq, skv, blk_q, blk_kv)
        if key in _CACHE:
            _CACHE.move_to_end(key)
            return _CACHE[key][:2]
    args, keep = _kernel_segments(mask, pos, dev, sq, skv, blk_q, blk_kv)
    if key is not None:
        _CACHE[key] = (args, keep, fields)
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    return args, keep


def launch_masked(plain_fn, seg_fn, args, mask, q, k, tiles, stream):
    """Launch ``plain_fn(*args, stream)``, or for a segmented mask
    ``seg_fn(*args, seg, stream)`` with the tile bounds at ``tiles`` (q
    rows, keys) of the kernel, for q (B, Hq, Sq, D) and k (B, Hkv, Skv,
    D). Returns the launch's code."""
    if not segmented(mask):
        return plain_fn(*args, stream)
    seg, _held = kernel_segments(mask, q.device, q.shape[2], k.shape[2],
                                 *tiles)
    return seg_fn(*args, ctypes.byref(seg), stream)


def _kernel_segments(mask, pos, dev, sq, skv, blk_q, blk_kv):
    q_seg = kv_seg = q_pos = kv_pos = None
    if mask.has_segment_mask:
        q_seg = _id_operand("q_segids", mask.q_segids, sq, dev)
        kv_seg = _id_operand("kv_segids", mask.kv_segids, skv, dev)
    if pos:
        q_pos = _id_operand("q_pos", mask.q_pos, sq, dev)
        kv_pos = _id_operand("kv_pos", mask.kv_pos, skv, dev)
    meta_mask = MaskArgs(causal=pos, q_segids=q_seg, kv_segids=kv_seg,
                         q_pos=q_pos, kv_pos=kv_pos)
    q_meta, kv_meta = block_meta(meta_mask, blk_q, blk_kv, sq, skv, dev)
    keep = (q_seg, kv_seg, q_pos, kv_pos, q_meta, kv_meta)

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = SegArgs(ptr(q_seg), ptr(kv_seg), ptr(q_pos), ptr(kv_pos),
                   ptr(q_meta), ptr(kv_meta), q_meta.shape[1],
                   kv_meta.shape[1], int(pos and mask.packed_self))
    return args, keep
