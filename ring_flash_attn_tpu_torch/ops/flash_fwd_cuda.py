"""Launcher of kernel B1, the flash forward (``csrc/flash_fwd.cu``).

It replaces the TPU kernel ``ring_flash_attn_tpu/ops/pallas_fwd.py::
_fwd_kernel``. ``ops/flash.py::block_fwd`` sends CUDA tensors here and CPU
tensors to the kernel's plain version, ``ops/naive.py::naive_block_fwd``.
See the source's header for what bounds
the kernel on the H100 and how its design answers that. A mask with
segment ids, or with explicit positions that reach the kernel (causal on
them, or ALiBi), goes to the segmented instantiation (``rfa_flash_fwd_seg``,
``csrc/segments.cuh``) with the tile bounds of ``ops/block_meta.py``; a
mask with softcap or ALiBi to the XFORM instantiations
(``rfa_flash_fwd_xf``, ``csrc/xform.cuh``), with or without segments; a
mask with a window or dropout to the BAND instantiations
(``rfa_flash_fwd_band``, ``csrc/band.cuh``), which carry softcap and ALiBi
too; the mask-free one stays as it was. ``launches`` counts every launch,
``xform_launches`` those with softcap or ALiBi (and no window or dropout),
``band_launches`` those with a window or dropout.

This module also holds the operand checks of every kernel that reads its
bf16 operands through TMA tensor maps (B1 and B7 here, B2, B3b and B8 in
the backward): ``tma_layout_error`` states the maps' terms.
"""

import ctypes

import torch

from . import _build
from .block_meta import (BandArgs, SegArgs, XformArgs, has_band, has_xform,
                         index_causal, launch_masked, segmented)
from .mask import MaskArgs, causal_offset, check_supported

TMA_MAX_STRIDE = 2**40  # bytes: the limit on a TMA tensor map's strides
Q_TILE = 128  # q rows a block of B1 and B7 (csrc/flash_fwd.cuh)
KV_TILE = 128  # keys a tile of B1 and B7 (80 or 64 at head_dim 256: kv_tile)
# head dims of every build of B1, B2, B3a, B3b, B7 and B8 (256: Gemma)
HEAD_DIMS = (64, 128, 256)
MAX_GRID_Y = 65535  # the q tiles ride in gridDim.y

# rfa_flash_fwd(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, strides, scale,
#               causal, offset, out_bf16, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


# rfa_flash_fwd_seg(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, strides,
#                   scale, causal, offset, out_bf16, seg, stream)
_SEG_ARGTYPES = _ARGTYPES[:-1] + [ctypes.POINTER(SegArgs), ctypes.c_void_p]
# rfa_flash_fwd_xf(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, strides,
#                  scale, causal, offset, out_bf16, seg or NULL, xform, stream)
XFORM_TAIL = [ctypes.POINTER(SegArgs), ctypes.POINTER(XformArgs),
              ctypes.c_void_p]
_XF_ARGTYPES = _ARGTYPES[:-1] + XFORM_TAIL
# rfa_flash_fwd_band(..., seg or NULL, xform, band, stream)
BAND_TAIL = XFORM_TAIL[:-1] + [ctypes.POINTER(BandArgs), ctypes.c_void_p]
_BAND_ARGTYPES = _ARGTYPES[:-1] + BAND_TAIL


def _lib():
    lib = _build.library("flash_fwd")
    lib.rfa_flash_fwd.argtypes = _ARGTYPES
    lib.rfa_flash_fwd.restype = ctypes.c_int
    lib.rfa_flash_fwd_seg.argtypes = _SEG_ARGTYPES
    lib.rfa_flash_fwd_seg.restype = ctypes.c_int
    lib.rfa_flash_fwd_xf.argtypes = _XF_ARGTYPES
    lib.rfa_flash_fwd_xf.restype = ctypes.c_int
    lib.rfa_flash_fwd_band.argtypes = _BAND_ARGTYPES
    lib.rfa_flash_fwd_band.restype = ctypes.c_int
    return lib


def kernel_offset(mask: MaskArgs):
    """The static int offset of the kernels' causal mask by index (0 where
    the mask is not causal by index), or raise."""
    if not index_causal(mask):
        return 0
    offset = causal_offset(mask)
    if not isinstance(offset, int) or abs(offset) >= 2**30:
        raise TypeError(
            f"the kernel takes a static int offset, got {offset!r}")
    return offset


def _check_operand(name, x, dev):
    """A bf16 (B, H, S, D) operand on ``dev`` in a layout the TMA maps
    read (``tma_layout_error``), or raise."""
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the kernel, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be 4-D (B, H, S, D), got {tuple(x.shape)}")
    err = tma_layout_error(x)
    if err:
        raise ValueError(f"{name}: {err}")


def tma_layout_error(x):
    """Why a TMA tensor map cannot read the (B, H, S, D) tensor x in place,
    or None. A map needs the last dim contiguous, a 16-byte aligned base,
    and along every other dim of more than one element a positive stride
    that is a multiple of 16 bytes below 2^40 (a dim of one element is
    never stepped along, so its stride is free). Views of a shard along S,
    like the zigzag ring's halves, keep their parent's strides and pass."""
    if x.stride(-1) != 1:
        return f"the last dim is not contiguous (strides {x.stride()})"
    if x.data_ptr() % 16:
        return "the base address is not 16-byte aligned"
    for n, st in zip(x.shape[:-1], x.stride()[:-1]):
        nbytes = st * x.element_size()
        if n > 1 and not (0 < nbytes < TMA_MAX_STRIDE and nbytes % 16 == 0):
            return (f"a stride of {nbytes} bytes along a dim of {n} is not a "
                    f"positive multiple of 16 below 2^40 (strides "
                    f"{x.stride()})")
    return None


def check_q_tiles(sq):
    """Raise ValueError past the q tiles one launch of B1 or B7 takes."""
    if -(-sq // Q_TILE) > MAX_GRID_Y:
        raise ValueError(f"Sq={sq} needs more than {MAX_GRID_Y} q tiles of "
                         f"{Q_TILE} rows (gridDim.y)")


def kv_tile(d, tile64=False):
    """Keys a tile of B1 and B7 at head_dim d (``csrc/flash_fwd.cuh::
    kv_tile``): at 256 80, or 64 in B1's builds with segments, a band or
    softcap/ALiBi (``tile64``)."""
    if d <= 128:
        return KV_TILE
    return 64 if tile64 else 80


def head_dim_error(d, what, dims=HEAD_DIMS):
    """Raise the ValueError of a head_dim that ``what`` has no build for."""
    raise ValueError(f"head_dim must be one of {dims} for {what}, got {d}")


def check_qkv(q, k, v, head_dims=HEAD_DIMS, what="this kernel"):
    """Operand checks of the attention kernels on q (B, Hq, Sq, D) and k, v
    (B, Hkv, Skv, D), D one of ``head_dims`` (else ``head_dim_error`` names
    ``what``); returns (B, Hq, Hkv, Sq, Skv, D)."""
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, dev)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if d not in head_dims:
        head_dim_error(d, what, head_dims)
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    return b, hq, hkv, sq, skv, d


def flash_fwd_cuda(q, k, v, scale, mask: MaskArgs, out_dtype=torch.float32):
    """One attention block on the card: (out (B,Hq,Sq,D), lse f32 (B,Hq,Sq)).

    q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) in bf16 with D in {64, 128,
    256} and Hq % Hkv == 0, each in a layout the TMA maps read
    (``tma_layout_error``: ``ops/flash.py::_kernel_layout`` gives one);
    ``mask`` causal or not, with a static int offset, with segment ids
    and explicit positions ((Sq,)/(Skv,) int32 on the card, or int64
    narrowed), softcap and ALiBi (Hq slopes), a window and dropout.
    out_dtype is float32 (the mergeable contract) or bfloat16."""
    check_supported(mask)
    offset = kernel_offset(mask)
    dev = q.device
    b, hq, hkv, sq, skv, d = check_qkv(q, k, v)
    check_q_tiles(sq)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty((b, hq, sq, d), dtype=out_dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    if skv == 0:
        raise ValueError("k and v hold no keys")
    lib = _lib()
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, hkv, sq, skv, d, strides, float(scale),
            int(index_causal(mask)), offset,
            int(out_dtype == torch.bfloat16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch_masked(
            (lib.rfa_flash_fwd, lib.rfa_flash_fwd_seg, lib.rfa_flash_fwd_xf,
             lib.rfa_flash_fwd_band),
            args, mask, q, k,
            (Q_TILE, kv_tile(d, segmented(mask) or has_xform(mask)
                             or has_band(mask))), stream)
        count_launch(flash_fwd_cuda, mask)
    _build.check_launch(lib, rc, "flash_fwd")
    return out, lse


def count_launch(fn, mask):
    """One launch of the kernel ``fn`` wraps: ``launches``, and
    ``band_launches`` or ``xform_launches`` by its instantiation."""
    fn.launches += 1
    band = has_band(mask)
    fn.band_launches += band
    fn.xform_launches += has_xform(mask) and not band


flash_fwd_cuda.launches = 0
flash_fwd_cuda.xform_launches = 0
flash_fwd_cuda.band_launches = 0
