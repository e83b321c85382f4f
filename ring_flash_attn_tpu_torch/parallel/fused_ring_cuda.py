"""Launchers of kernels B7 and B8, the fused ring's step kernels
(``csrc/fused_ring_fwd.cu``, ``csrc/fused_ring_bwd.cu``).

They replace the TPU kernels ``ring_flash_attn_tpu/parallel/fused_ring.py::
_fused_ring_fwd_kernel`` and ``::_fused_ring_bwd_kernel``.
``parallel/fused_ring.py`` sends CUDA tensors here and CPU tensors to the
kernels' plain versions beside its step loops. See the sources' headers for
what bounds the kernels on the H100 and why the TPU kernels' credit
protocol has no counterpart.
"""

import ctypes

import torch

from ..ops import _build
from ..ops.flash_bwd_cuda import _check_rows, bwd_strides
from ..ops.flash_fwd_cuda import (HEAD_DIMS, _check_operand, check_q_tiles,
                                  check_qkv)

# rfa_fused_ring_fwd(q, k, v, m, l, acc, slopes, out, lse, B, Hq, Hkv, Sq,
#                    Skv, D, strides, diagonal, q_row0, cap2, q_pos0, kv_pos0,
#                    alibi_abs, first, last, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# rfa_fused_ring_bwd(q, k, v, dout, lse2, delta, slopes, dq, dk, dv, B, Hq,
#                    Hkv, Sq, Skv, D, strides, diagonal, q_row0, cap2, q_pos0,
#                    kv_pos0, alibi_abs, accumulate, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib(name, argtypes):
    lib = _build.library(name)
    fn = getattr(lib, f"rfa_{name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check_shapes(q, k, v):
    """Operand checks shared by both kernels; returns (B, Hq, Hkv, Sq, Skv,
    D)."""
    dims = check_qkv(q, k, v, HEAD_DIMS, "the fused ring's kernels B7 and B8")
    if 0 in dims:
        raise ValueError("a ring step needs at least one query and one key")
    return dims


def _slopes_ptr(slopes2, hq, dev):
    if slopes2 is None:
        return None
    _check_rows("slopes", slopes2, (hq,), dev)
    return slopes2.data_ptr()


def _positions(q_row0, q_pos0, kv_pos0, sq, skv):
    """(q_row0, global position of q's row 0, of key 0) as checked ints.
    A negative q_row0 leaves the first rows without a key, as a negative
    offset does in B1."""
    vals = (q_row0, q_pos0 + q_row0, kv_pos0)
    if (not all(isinstance(x, int) for x in vals) or q_pos0 < 0 or kv_pos0 < 0
            or max(abs(q_row0), vals[1] + sq, kv_pos0 + skv) >= 2**30):
        raise ValueError(f"positions must be ints below 2^30, q_pos0 and "
                         f"kv_pos0 not negative, got q_row0={q_row0!r} "
                         f"q_pos0={q_pos0!r} kv_pos0={kv_pos0!r}")
    return vals


def fused_ring_fwd_cuda(qs, k, v, m, l, acc, *, diagonal, first, last,
                        q_row0=0, q_pos0=0, kv_pos0=0, cap2=0.0,
                        slopes2=None, alibi_abs=False):
    """B7, one forward ring step on the card; updates (m, l, acc) in place.

    qs (B, Hq, Sq, D) is q * scale * log2(e) in bf16, k and v (B, Hkv, Skv,
    D) the resident shard, D in {64, 128, 256}; m, l fp32 (B, Hq, Sq) and acc
    fp32 (B, Hq, Sq, D) the running state in base 2 (not read when
    ``first``, not written when ``last``). ``diagonal``: mask keys past
    ``row + q_row0``. ``cap2`` is softcap * log2(e) (0: none), ``slopes2``
    the fp32 (Hq,) ALiBi slopes * log2(e) on global positions ``q_pos0 +
    q_row0 + row`` and ``kv_pos0 + col``. Returns (out bf16 (B, Hq, Sq, D),
    lse fp32 natural log) when ``last``, else None."""
    b, hq, hkv, sq, skv, d = _check_shapes(qs, k, v)
    dev = qs.device
    _check_rows("m", m, (b, hq, sq), dev)
    _check_rows("l", l, (b, hq, sq), dev)
    _check_rows("acc", acc, (b, hq, sq, d), dev)
    check_q_tiles(sq)
    row0, qp, kp = _positions(q_row0, q_pos0, kv_pos0, sq, skv)
    out = lse = None
    if last:
        out = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=dev)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    lib, fn = _lib("fused_ring_fwd", _FWD_ARGTYPES)
    strides = (ctypes.c_longlong * 9)(*qs.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
                l.data_ptr(), acc.data_ptr(), _slopes_ptr(slopes2, hq, dev),
                out.data_ptr() if last else None,
                lse.data_ptr() if last else None, b, hq, hkv, sq, skv, d,
                strides, int(bool(diagonal)), row0, float(cap2), qp, kp,
                int(bool(alibi_abs)), int(bool(first)), int(bool(last)),
                stream)
        fused_ring_fwd_cuda.launches += 1
    _build.check_launch(lib, rc, "fused_ring_fwd")
    return (out, lse) if last else None


def fused_ring_bwd_cuda(qs, k, vs, dout, lse2, delta, dq, dk, dv, *, diagonal,
                        accumulate, q_row0=0, q_pos0=0, kv_pos0=0, cap2=0.0,
                        slopes2=None, alibi_abs=False):
    """B8, one backward ring step on the card; adds in place.

    qs is q * scale * log2(e), vs is v * scale, k raw, dout (B, Hq, Sq, D),
    all bf16; lse2 = max(lse * log2 e, NEG_INF / 2) and delta = scale *
    rowsum(dout * out), fp32 (B, Hq, Sq). dq fp32 (B, Hq, Sq, D) is added
    to (by TMA reduce-adds: its last bits vary from run to run); dk, dv fp32
    (B, Hkv, Skv, D) are added to when ``accumulate``, else written, dk in
    units of scale * log2(e). Mask and transform arguments as
    ``fused_ring_fwd_cuda``."""
    b, hq, hkv, sq, skv, d = _check_shapes(qs, k, vs)
    dev = qs.device
    _check_operand("dout", dout, dev)
    if dout.shape != qs.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must match q "
                         f"{tuple(qs.shape)}")
    _check_rows("lse2", lse2, (b, hq, sq), dev)
    _check_rows("delta", delta, (b, hq, sq), dev)
    _check_rows("dq", dq, (b, hq, sq, d), dev)
    _check_rows("dk", dk, (b, hkv, skv, d), dev)
    _check_rows("dv", dv, (b, hkv, skv, d), dev)
    row0, qp, kp = _positions(q_row0, q_pos0, kv_pos0, sq, skv)
    lib, fn = _lib("fused_ring_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qs.data_ptr(), k.data_ptr(), vs.data_ptr(), dout.data_ptr(),
                lse2.data_ptr(), delta.data_ptr(),
                _slopes_ptr(slopes2, hq, dev), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, hq, hkv, sq, skv, d,
                bwd_strides(qs, k, vs, dout), int(bool(diagonal)), row0,
                float(cap2), qp, kp, int(bool(alibi_abs)),
                int(bool(accumulate)), stream)
        fused_ring_bwd_cuda.launches += 1
    _build.check_launch(lib, rc, "fused_ring_bwd")


fused_ring_fwd_cuda.launches = 0
fused_ring_bwd_cuda.launches = 0
