"""Launcher of kernel B6, decode over a quantized paged cache
(``csrc/paged_quant_decode.cu``).

It replaces the TPU kernel ``ring_flash_attn_tpu/ops/paged.py::
_quant_paged_kernel``. ``ops/paged.py::paged_quant_decode_attention`` sends
CUDA tensors here and CPU tensors to the kernel's plain version,
``ops/paged.py::_plain_quant_paged_decode``. See ``csrc/quant_decode.cuh``
for what bounds the kernel on the H100 and how its design answers that.
"""

import ctypes

import torch

from . import _build
from .quant_decode_cuda import (QTYPES, check_operand, check_rows,
                                paged_num_splits, partials)

# rfa_paged_quant_decode(q, q_bf16, k_pages, v_pages, k_scales, v_scales,
#                        block_tables, seq_lens, out, lse, part_acc, part_ml,
#                        B, Hq, Hkv, Tq, head_dim, num_pages, page_size,
#                        npages, qtype, nsplit, scale, softcap, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10 + [
    ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _lib():
    lib = _build.library("paged_quant_decode")
    lib.rfa_paged_quant_decode.argtypes = _ARGTYPES
    lib.rfa_paged_quant_decode.restype = ctypes.c_int
    return lib


def paged_quant_decode_cuda(q, k_pages, k_scales, v_pages, v_scales,
                            block_tables, seq_lens, scale, softcap=None):
    """Quantized paged decode on the card: fp32 (out (B,Hq,Tq,D), lse
    (B,Hq,Tq)).

    q (B, Hq, Tq, D) bf16 or fp32; pages (num_pages, Hkv, page_size, D)
    int8, float8_e4m3fn or float8_e5m2 with D = 128; scales
    (num_pages, Hkv, 1, page_size) fp32; block_tables (B, npages) and
    seq_lens (B,) int32; (Hq / Hkv) * Tq <= 16. On int8 pages q is
    quantized per row to int8 inside the kernel (the int8-native QK of the
    TPU kernel). Out-of-range page ids are clamped into the pool, as the
    plain version's gather does."""
    dev = q.device
    check_operand("q", q, dev, (torch.bfloat16, torch.float32), 4)
    check_operand("k_pages", k_pages, dev, tuple(QTYPES), 4)
    check_operand("v_pages", v_pages, dev, (k_pages.dtype,), 4)
    check_operand("k_scales", k_scales, dev, (torch.float32,), 4)
    check_operand("v_scales", v_scales, dev, (torch.float32,), 4)
    check_operand("block_tables", block_tables, dev, (torch.int32,), 2)
    check_operand("seq_lens", seq_lens, dev, (torch.int32,), 1)
    b, hq, tq, d = q.shape
    num_pages, hkv, page_size, _ = k_pages.shape
    npages = block_tables.shape[1]
    sshape = (num_pages, hkv, 1, page_size)
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d
            or k_scales.shape != sshape or v_scales.shape != sshape):
        raise ValueError(
            f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)} and scales {tuple(k_scales.shape)}/"
            f"{tuple(v_scales.shape)} do not match")
    check_rows(hq, hkv, tq, d)
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError("block_tables and seq_lens must have one row per "
                         f"lane ({b})")
    if num_pages < 1 or page_size < 1 or npages < 1:
        raise ValueError("the cache holds no page")
    out = torch.empty((b, hq, tq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    rows = (hq // hkv) * tq
    nsplit = paged_num_splits(b, hkv, npages, page_size)
    part_acc, part_ml = partials(b * hkv, nsplit, rows, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rfa_paged_quant_decode(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            lse.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, hq,
            hkv, tq, d, num_pages, page_size, npages, QTYPES[k_pages.dtype],
            nsplit, float(scale), float(softcap or 0.0), stream,
        )
        paged_quant_decode_cuda.launches += 1
    _build.check_launch(lib, rc, "paged_quant_decode")
    return out, lse


paged_quant_decode_cuda.launches = 0
