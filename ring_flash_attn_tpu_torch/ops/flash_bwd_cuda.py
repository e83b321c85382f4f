"""Launcher of kernel B2, the fused flash backward (``csrc/flash_bwd.cu``).

It replaces the TPU kernel ``ring_flash_attn_tpu/ops/pallas_bwd_fused.py::
_bwd_fused_kernel``. ``ops/flash.py::block_bwd`` sends CUDA tensors here
(or to the split kernels B3a/B3b, ``flash_bwd_split_cuda``) and CPU
tensors to the kernels' plain version, ``ops/naive.py::naive_block_bwd``.
See the sources' headers for what bounds the kernels on the H100 and how
their design answers that.

This module also holds what B2 and B3a/B3b share: the operand checks, the
delta pre-pass launcher and the selector between them,
``fused_bwd_takes``: ``fused_bwd_supported``, and B2's room for the
segment classes of a long packing. The kv-major loop of B2, B3b and B8
reads q, k, v and dout through TMA tensor maps, whose terms
``tma_layout_error`` (``flash_fwd_cuda``) states. A mask with segment
ids, or with explicit positions that reach the kernels (causal on them, or
ALiBi), goes to the kernels' segmented instantiations (``csrc/segments.cuh``) with the tile
bounds of ``ops/block_meta.py``; a mask with softcap or ALiBi to their
XFORM instantiations (``csrc/xform.cuh``), a mask with a window or
dropout to their BAND ones (``csrc/band.cuh``). Each launcher counts
``launches``, ``xform_launches`` and ``band_launches``
(``flash_fwd_cuda.count_launch``).
"""

import ctypes

import torch

from . import _build
from .block_meta import (SegArgs, band_all, index_causal, launch_masked,
                         max_class_tiles, segmented)
from .flash_fwd_cuda import (BAND_TAIL, XFORM_TAIL, _check_operand,
                             check_qkv, count_launch,
                             kernel_offset)
from .mask import MaskArgs, check_supported

# The JAX package's limit for the fused kernel (pallas_bwd_fused.py:56): the
# TPU's VMEM budget for a head's resident fp32 dk/dv, not a Hopper limit.
# Kept so that the same shapes pick the same kernel in both packages.
FUSED_MAX_KV_BYTES = 32 * 1024 * 1024

_STRIDES = ctypes.c_longlong * 12
_DELTA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
# rfa_flash_bwd(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Hq, Hkv, Sq,
#               Skv, D, strides, scale, causal, offset, dkv_bf16, stream)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_SEG_ARGTYPES = _ARGTYPES[:-1] + [ctypes.POINTER(SegArgs), ctypes.c_void_p]
_XF_ARGTYPES = _ARGTYPES[:-1] + XFORM_TAIL
_BAND_ARGTYPES = _ARGTYPES[:-1] + BAND_TAIL
_OUT_DTYPES = (None, torch.float32, torch.bfloat16)
# the kv-major loop of B2 and B3b (csrc/flash_bwd.cuh): 64 q rows a step,
# 128 keys a block
KV_MAJOR_TILES = (64, 128)


def kv_major_tiles(d):
    """(q rows a step, keys a block) of the kv-major loop of B2 and B3b at
    head_dim d: 64 keys a block at 256 (``csrc/flash_bwd.cuh::kv_keys``)."""
    return (64, 64) if d > 128 else KV_MAJOR_TILES


def fused_bwd_supported(skv, d):
    """True when the fused backward (B2) takes Skv keys of head_dim d."""
    return 2 * skv * d * 4 <= FUSED_MAX_KV_BYTES


def fused_bwd_seg_max_q_tiles(d, mask: MaskArgs):
    """The most q tiles (of 64 rows) whose segment classes B2's segmented
    builds hold at head_dim d in the build the mask picks: 1824 (116,736
    rows) at 256 in the ALL build, 3872 in the others. The bytes before the
    classes are ``csrc/flash_bwd.cuh::KvSmem``'s with dQ."""
    bm, bn = kv_major_tiles(d)
    split = d > 128  # Q in two stages, dout in one, P^T beside dS^T
    tiles = 2 * bn * d * 2 + (3 if split else 4) * bm * d * 2
    tiles += (4 if split else 2) * bn * bm * 2  # dS^T (and P^T), twice
    tiles += 2 * bm * (64 if split else d) * 4  # two fp32 dQ tiles or panels
    rows = 2 * (3 if band_all(mask) else 2) * bm * 4  # ALL: a third array
    barriers = (5 + (2 if split else 0)) * 8
    return max_class_tiles(tiles + rows + barriers + 1024)


def fused_bwd_takes(mask: MaskArgs, sq, skv, d):
    """The selector of ``ops/flash.py::block_bwd``: True when B2 takes the
    call, ``fused_bwd_supported`` and, for a segmented mask, the classes
    of its Sq rows' q tiles within B2's shared memory. The split kernels
    B3a/B3b compute the same function past either limit."""
    if not fused_bwd_supported(skv, d):
        return False
    return (not segmented(mask)
            or -(-sq // 64) <= fused_bwd_seg_max_q_tiles(d, mask))


def _lib():
    lib = _build.library("flash_bwd")
    lib.rfa_bwd_delta.argtypes = _DELTA_ARGTYPES
    lib.rfa_bwd_delta.restype = ctypes.c_int
    lib.rfa_flash_bwd.argtypes = _ARGTYPES
    lib.rfa_flash_bwd.restype = ctypes.c_int
    lib.rfa_flash_bwd_seg.argtypes = _SEG_ARGTYPES
    lib.rfa_flash_bwd_seg.restype = ctypes.c_int
    lib.rfa_flash_bwd_xf.argtypes = _XF_ARGTYPES
    lib.rfa_flash_bwd_xf.restype = ctypes.c_int
    lib.rfa_flash_bwd_band.argtypes = _BAND_ARGTYPES
    lib.rfa_flash_bwd_band.restype = ctypes.c_int
    return lib


def _check_rows(name, x, shape, dev):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be float32 {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_bwd(dout, q, k, v, lse, delta, mask: MaskArgs, out, dtypes):
    """Check the operands of B2/B3a/B3b; returns the static int offset.

    ``delta`` may be None when ``out`` (the forward output, bf16) is given.
    ``dtypes`` are the requested output dtypes (None, float32 or bfloat16).
    """
    check_supported(mask)
    offset = kernel_offset(mask)
    dev = q.device
    b, hq, _, sq, _, d = check_qkv(q, k, v)
    _check_operand("dout", dout, dev)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    _check_rows("lse", lse, (b, hq, sq), dev)
    if delta is None:
        if out is None:
            raise ValueError("delta=None requires the forward out")
        _check_operand("out", out, dev)
        if out.shape != q.shape:
            raise ValueError(f"out {tuple(out.shape)} must match q "
                             f"{tuple(q.shape)}")
    else:
        _check_rows("delta", delta, (b, hq, sq), dev)
    for dt in dtypes:
        if dt not in _OUT_DTYPES:
            raise TypeError(f"gradient dtype must be float32 or bfloat16, "
                            f"got {dt}")
    return offset


def bwd_strides(q, k, v, dout):
    return _STRIDES(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *dout.stride()[:3])


def bwd_delta(dout, out):
    """delta = rowsum(dout * out), fp32 (B, H, S), by the pre-pass kernel
    of ``csrc/flash_bwd.cu``, for B2 and B3a/B3b alike."""
    b, h, s, d = dout.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dout.device)
    if delta.numel() == 0:
        return delta
    lib = _lib()
    strides = (ctypes.c_longlong * 6)(*dout.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        rc = lib.rfa_bwd_delta(dout.data_ptr(), out.data_ptr(),
                               delta.data_ptr(), b, h, s, d, strides, stream)
    _build.check_launch(lib, rc, "bwd_delta")
    return delta


def flash_bwd_cuda(dout, q, k, v, lse, delta, scale, mask: MaskArgs,
                   out=None, dq_dtype=None, dkv_dtype=None):
    """Fused block backward on the card: (dq, dk, dv).

    q, dout (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) in bf16, D in
    {64, 128, 256},
    Hq % Hkv == 0; lse (and delta, or else the forward ``out``
    in bf16) fp32 (B, Hq, Sq). dq is fp32 unless dq_dtype narrows it (a
    cast of the kernel's fp32 accumulator); dk, dv fp32 unless dkv_dtype
    narrows them (written so by the kernel), summed over the GQA group.
    dq sums by TMA reduce-adds: its last bits vary from run to run. q,
    k, v and dout are read through TMA tensor maps (``tma_layout_error``
    states their terms)."""
    offset = check_bwd(dout, q, k, v, lse, delta, mask, out,
                       (dq_dtype, dkv_dtype))
    dev = q.device
    dkv_dtype = dkv_dtype or torch.float32
    launch = q.numel() > 0 and k.numel() > 0
    new = torch.empty if launch else torch.zeros  # the kernel writes dk, dv
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dk = new(k.shape, dtype=dkv_dtype, device=dev)
    dv = new(k.shape, dtype=dkv_dtype, device=dev)
    if launch:
        lib = _lib()
        if delta is None:
            delta = bwd_delta(dout, out)
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        n_q, n_max = -(-sq // 64), fused_bwd_seg_max_q_tiles(d, mask)
        if segmented(mask) and n_q > n_max:
            raise ValueError(
                f"flash_bwd: the segmented build at head_dim {d} holds the "
                f"classes of at most {n_max} q tiles of 64 rows in shared "
                f"memory, Sq = {sq} needs {n_q}: the split kernels "
                "(flash_bwd_split_cuda) take it")
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, d,
                bwd_strides(q, k, v, dout), float(scale),
                int(index_causal(mask)), offset,
                int(dkv_dtype == torch.bfloat16))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = launch_masked(
                (lib.rfa_flash_bwd, lib.rfa_flash_bwd_seg,
                 lib.rfa_flash_bwd_xf, lib.rfa_flash_bwd_band),
                args, mask, q, k, kv_major_tiles(d), stream)
            count_launch(flash_bwd_cuda, mask)
        _build.check_launch(lib, rc, "flash_bwd")
    if dq_dtype not in (None, torch.float32):
        dq = dq.to(dq_dtype)
    return dq, dk, dv


flash_bwd_cuda.launches = 0
flash_bwd_cuda.xform_launches = 0
flash_bwd_cuda.band_launches = 0
