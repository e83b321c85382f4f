"""Launchers of kernels B3a and B3b, the split flash backward
(``csrc/flash_bwd_split.cu``).

They replace the TPU kernels ``ring_flash_attn_tpu/ops/pallas_bwd.py::
_dq_kernel`` (B3a) and ``::_dkv_kernel`` (B3b). ``ops/flash.py::block_bwd``
sends CUDA tensors here when ``fused_bwd_supported`` is false or the
caller passes ``fused=False`` (``flash_attn_func(deterministic=True)``
does), and CPU tensors to the kernels' plain version,
``ops/naive.py::naive_block_bwd``. Each output element is summed by one
thread in a fixed order (no atomics or reduce-adds), so their results are
bitwise reproducible. See the source's header for what bounds
them on the H100. Segmented masks go to their segmented instantiations,
masks with softcap or ALiBi to their XFORM ones, masks with a window or
dropout to their BAND ones (``launch_masked``). Each launcher counts
``launches``, ``xform_launches`` and ``band_launches``
(``flash_fwd_cuda.count_launch``).
"""

import ctypes

import torch

from . import _build
from .block_meta import SegArgs, index_causal, launch_masked
from .flash_bwd_cuda import bwd_delta, bwd_strides, check_bwd, kv_major_tiles
from .flash_fwd_cuda import BAND_TAIL, XFORM_TAIL, count_launch
from .mask import MaskArgs

# rfa_flash_bwd_dq(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, D,
#                  strides, scale, causal, offset, dq_bf16, stream)
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
# rfa_flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Skv,
#                   D, strides, scale, causal, offset, dkv_bf16, stream)
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_SEG_TAIL = [ctypes.POINTER(SegArgs), ctypes.c_void_p]
DQ_TILES = (128, 64)  # B3a: 128 q rows a block, 64 keys a tile


def dq_tiles(d):
    """(q rows a block, keys a tile) of B3a at head_dim d: 64-row q tiles
    at 256 (``csrc/flash_bwd_split.cu::dq_rows``)."""
    return (64, 64) if d > 128 else DQ_TILES


def _lib():
    lib = _build.library("flash_bwd_split")
    lib.rfa_flash_bwd_dq.argtypes = _DQ_ARGTYPES
    lib.rfa_flash_bwd_dq.restype = ctypes.c_int
    lib.rfa_flash_bwd_dkv.argtypes = _DKV_ARGTYPES
    lib.rfa_flash_bwd_dkv.restype = ctypes.c_int
    lib.rfa_flash_bwd_dq_seg.argtypes = _DQ_ARGTYPES[:-1] + _SEG_TAIL
    lib.rfa_flash_bwd_dq_seg.restype = ctypes.c_int
    lib.rfa_flash_bwd_dkv_seg.argtypes = _DKV_ARGTYPES[:-1] + _SEG_TAIL
    lib.rfa_flash_bwd_dkv_seg.restype = ctypes.c_int
    lib.rfa_flash_bwd_dq_xf.argtypes = _DQ_ARGTYPES[:-1] + XFORM_TAIL
    lib.rfa_flash_bwd_dq_xf.restype = ctypes.c_int
    lib.rfa_flash_bwd_dkv_xf.argtypes = _DKV_ARGTYPES[:-1] + XFORM_TAIL
    lib.rfa_flash_bwd_dkv_xf.restype = ctypes.c_int
    lib.rfa_flash_bwd_dq_band.argtypes = _DQ_ARGTYPES[:-1] + BAND_TAIL
    lib.rfa_flash_bwd_dq_band.restype = ctypes.c_int
    lib.rfa_flash_bwd_dkv_band.argtypes = _DKV_ARGTYPES[:-1] + BAND_TAIL
    lib.rfa_flash_bwd_dkv_band.restype = ctypes.c_int
    return lib


def _dims(q, k):
    b, hq, sq, d = q.shape
    return b, hq, k.shape[1], sq, k.shape[2], d


def _dq(dout, q, k, v, lse, delta, scale, mask, offset, dq_dtype):
    """Launch B3a on checked operands."""
    dq_dtype = dq_dtype or torch.float32
    if not k.numel():
        return torch.zeros(q.shape, dtype=dq_dtype, device=q.device)
    dq = torch.empty(q.shape, dtype=dq_dtype, device=q.device)
    if not q.numel():
        return dq
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(q, k),
            bwd_strides(q, k, v, dout), float(scale),
            int(index_causal(mask)), offset, int(dq_dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch_masked(
            (lib.rfa_flash_bwd_dq, lib.rfa_flash_bwd_dq_seg,
             lib.rfa_flash_bwd_dq_xf, lib.rfa_flash_bwd_dq_band),
            args, mask, q, k, dq_tiles(q.shape[3]), stream)
        count_launch(flash_bwd_dq_cuda, mask)
    _build.check_launch(lib, rc, "flash_bwd_dq")
    return dq


def _dkv(dout, q, k, v, lse, delta, scale, mask, offset, dkv_dtype):
    """Launch B3b on checked operands."""
    dkv_dtype = dkv_dtype or torch.float32
    launch = q.numel() > 0 and k.numel() > 0
    new = torch.empty if launch else torch.zeros  # the kernel writes both
    dk = new(k.shape, dtype=dkv_dtype, device=k.device)
    dv = new(k.shape, dtype=dkv_dtype, device=k.device)
    if not launch:
        return dk, dv
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k), bwd_strides(q, k, v, dout), float(scale),
            int(index_causal(mask)), offset,
            int(dkv_dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch_masked(
            (lib.rfa_flash_bwd_dkv, lib.rfa_flash_bwd_dkv_seg,
             lib.rfa_flash_bwd_dkv_xf, lib.rfa_flash_bwd_dkv_band),
            args, mask, q, k, kv_major_tiles(q.shape[3]), stream)
        count_launch(flash_bwd_dkv_cuda, mask)
    _build.check_launch(lib, rc, "flash_bwd_dkv")
    return dk, dv


def flash_bwd_dq_cuda(dout, q, k, v, lse, delta, scale, mask: MaskArgs,
                      dq_dtype=None):
    """B3a: dq (B, Hq, Sq, D), fp32 unless dq_dtype narrows it (written so
    by the kernel). Operands as ``flash_bwd_cuda``, with delta given."""
    offset = check_bwd(dout, q, k, v, lse, delta, mask, None, (dq_dtype,))
    return _dq(dout, q, k, v, lse, delta, scale, mask, offset, dq_dtype)


def flash_bwd_dkv_cuda(dout, q, k, v, lse, delta, scale, mask: MaskArgs,
                       dkv_dtype=None):
    """B3b: (dk, dv) (B, Hkv, Skv, D) summed over the GQA group, fp32
    unless dkv_dtype narrows them. Operands as ``flash_bwd_cuda``, with
    delta given."""
    offset = check_bwd(dout, q, k, v, lse, delta, mask, None, (dkv_dtype,))
    return _dkv(dout, q, k, v, lse, delta, scale, mask, offset, dkv_dtype)


def flash_bwd_split_cuda(dout, q, k, v, lse, delta, scale, mask: MaskArgs,
                         out=None, dq_dtype=None, dkv_dtype=None):
    """Split block backward on the card: (dq, dk, dv) from B3a and B3b.

    Same contract as ``flash_bwd_cuda``; with delta=None the pre-pass
    computes it from ``out`` first, as ``pallas_block_bwd`` does."""
    offset = check_bwd(dout, q, k, v, lse, delta, mask, out,
                       (dq_dtype, dkv_dtype))
    if delta is None:
        delta = bwd_delta(dout, out)
    dq = _dq(dout, q, k, v, lse, delta, scale, mask, offset, dq_dtype)
    dk, dv = _dkv(dout, q, k, v, lse, delta, scale, mask, offset, dkv_dtype)
    return dq, dk, dv


flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.xform_launches = 0
flash_bwd_dkv_cuda.xform_launches = 0
flash_bwd_dq_cuda.band_launches = 0
flash_bwd_dkv_cuda.band_launches = 0
