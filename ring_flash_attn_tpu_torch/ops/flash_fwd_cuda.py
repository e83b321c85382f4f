"""Launcher of kernel B1, the flash forward (``csrc/flash_fwd.cu``).

It replaces the TPU kernel ``ring_flash_attn_tpu/ops/pallas_fwd.py::
_fwd_kernel``. ``ops/flash.py::block_fwd`` sends CUDA tensors here and CPU
tensors to the kernel's plain version, ``ops/naive.py::naive_block_fwd``.
See the source's header for what bounds
the kernel on the H100 and how its design answers that.

This module also holds the operand checks of every kernel that reads its
bf16 operands through TMA tensor maps (B1 and B7 here, B2, B3b and B8 in
the backward): ``tma_layout_error`` states the maps' terms.
"""

import ctypes

import torch

from . import _build
from .mask import MaskArgs, causal_offset, check_kernel_supported

TMA_MAX_STRIDE = 2**40  # bytes: the limit on a TMA tensor map's strides
Q_TILE = 128  # q rows a block of B1 and B7 (csrc/flash_fwd.cuh)
MAX_GRID_Y = 65535  # the q tiles ride in gridDim.y

# rfa_flash_fwd(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, strides, scale,
#               causal, offset, out_bf16, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _lib():
    lib = _build.library("flash_fwd")
    lib.rfa_flash_fwd.argtypes = _ARGTYPES
    lib.rfa_flash_fwd.restype = ctypes.c_int
    return lib


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


def check_qkv(q, k, v):
    """Operand checks of the attention kernels on q (B, Hq, Sq, D) and k, v
    (B, Hkv, Skv, D); returns (B, Hq, Hkv, Sq, Skv, D)."""
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, dev)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if d not in (64, 128):
        raise ValueError(f"head_dim must be 64 or 128, got {d}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    return b, hq, hkv, sq, skv, d


def flash_fwd_cuda(q, k, v, scale, mask: MaskArgs, out_dtype=torch.float32):
    """One attention block on the card: (out (B,Hq,Sq,D), lse f32 (B,Hq,Sq)).

    q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) in bf16 with D in {64, 128}
    and Hq % Hkv == 0, each in a layout the TMA maps read
    (``tma_layout_error``: ``ops/flash.py::_kernel_layout`` gives one);
    ``mask`` causal or not, with a static int offset. out_dtype is float32
    (the mergeable contract) or bfloat16."""
    check_kernel_supported(mask)
    offset = causal_offset(mask)
    if not isinstance(offset, int) or abs(offset) >= 2**30:
        raise TypeError(f"the kernel takes a static int offset, got {offset!r}")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rfa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, hkv, sq, skv, d, strides, float(scale),
            int(bool(mask.causal)), offset, int(out_dtype == torch.bfloat16),
            stream,
        )
        flash_fwd_cuda.launches += 1
    _build.check_launch(lib, rc, "flash_fwd")
    return out, lse


flash_fwd_cuda.launches = 0
