"""Launcher of kernel B5, bf16 paged decode (``csrc/paged_decode.cu``).

It replaces the TPU kernel ``ring_flash_attn_tpu/ops/paged.py::
_paged_kernel``. ``ops/paged.py::paged_decode_attention`` sends CUDA
tensors here and CPU tensors to the kernel's plain version,
``ops/paged.py::_plain_paged_decode``. A lane's tokens are split over
``paged_num_splits`` blocks (shapes only: no host sync, the same plan
every call) and the partials merged in split order; see the source's
header for what bounds the kernel on the H100 and how its design answers
that.
"""

import ctypes

import torch

from . import _build
from .quant_decode_cuda import (check_operand, check_rows, paged_num_splits,
                                partials)

# rfa_paged_decode(q, q_bf16, k_pages, v_pages, block_tables, seq_lens,
#                  new_counts, out, lse, part_acc, part_ml, B, Hq, Hkv, Tq,
#                  head_dim, num_pages, page_size, npages, nsplit, scale,
#                  softcap, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
    ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _lib():
    lib = _build.library("paged_decode")
    lib.rfa_paged_decode.argtypes = _ARGTYPES
    lib.rfa_paged_decode.restype = ctypes.c_int
    return lib


def paged_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale,
                      softcap=None, new_counts=None):
    """Paged decode on the card: fp32 (out (B,Hq,Tq,D), lse (B,Hq,Tq)).

    q (B, Hq, Tq, D) bf16 or fp32; pages (num_pages, Hkv, page_size, D)
    bf16 with D = 128; block_tables (B, npages) and seq_lens, new_counts
    (B,) int32; (Hq / Hkv) * Tq <= 16. Out-of-range page ids are clamped
    into the pool, as the plain version's gather does."""
    dev = q.device
    check_operand("q", q, dev, (torch.bfloat16, torch.float32), 4)
    check_operand("k_pages", k_pages, dev, (torch.bfloat16,), 4)
    check_operand("v_pages", v_pages, dev, (torch.bfloat16,), 4)
    check_operand("block_tables", block_tables, dev, (torch.int32,), 2)
    check_operand("seq_lens", seq_lens, dev, (torch.int32,), 1)
    if new_counts is not None:
        check_operand("new_counts", new_counts, dev, (torch.int32,), 1)
    b, hq, tq, d = q.shape
    num_pages, hkv, page_size, _ = k_pages.shape
    npages = block_tables.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} differ")
    check_rows(hq, hkv, tq, d)
    if block_tables.shape[0] != b or seq_lens.shape != (b,) or (
            new_counts is not None and new_counts.shape != (b,)):
        raise ValueError("block_tables, seq_lens and new_counts must have "
                         f"one row per lane ({b})")
    if num_pages < 1 or page_size < 1:
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
        rc = lib.rfa_paged_decode(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            None if new_counts is None else new_counts.data_ptr(),
            out.data_ptr(), lse.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), b, hq, hkv, tq, d, num_pages, page_size,
            npages, nsplit, float(scale), float(softcap or 0.0), stream,
        )
        paged_decode_cuda.launches += 1
    _build.check_launch(lib, rc, "paged_decode")
    return out, lse


paged_decode_cuda.launches = 0
