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

MAX_ROWS = 16  # G * Tq query rows per kv head that one block serves
HEAD_DIM = 128
CHUNK = 64  # tokens per chunk in the kernels (C in quant_decode.cuh)
# Blocks to aim for (one per SM of 132: a block runs 2 or 3 pipelines
# side by side, quant_decode.cuh) and the fewest chunks worth a block.
TARGET_BLOCKS = 132
MIN_CHUNKS = 8
QTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}

# rfa_quant_decode(q, q_bf16, k_q, v_q, k_scale, v_scale, len_ptr, len_val,
#                  out, lse, part_acc, part_ml, counters, B, Hq, Hkv, Tq,
#                  head_dim, S, qtype, nsplit, scale, softcap, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
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
    if d != HEAD_DIM:
        raise ValueError(f"head_dim must be {HEAD_DIM}, got {d}")
    if hq % hkv or (hq // hkv) * tq > MAX_ROWS:
        raise ValueError(f"(Hq/Hkv)*Tq must divide evenly and be <= {MAX_ROWS}"
                         f", got Hq={hq} Hkv={hkv} Tq={tq}")


def num_splits(groups, max_chunks):
    """Blocks that share one (batch, kv head) group's tokens: as many as
    fill the card's SMs without a second wave, each with at least
    MIN_CHUNKS chunks of the longest possible sequence (a block takes
    ceil(max_chunks / splits) chunks of it). Depends on shapes only, so
    results are reproducible (the partials merge in split order)."""
    return max(1, min(TARGET_BLOCKS // groups, max_chunks // MIN_CHUNKS))


def paged_num_splits(b, hkv, npages, page_size):
    """``num_splits`` of a paged cache (B5, B6): B * Hkv groups, each lane
    at most npages pages of ceil(page_size / CHUNK) chunks."""
    return num_splits(b * hkv, npages * -(-page_size // CHUNK))


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


def scratch_ptrs(groups, nsplit, rows, dev, stream):
    """The scratch of a split launch of B4, B5 or B6 on ``stream``, as the
    kernels take it: part_acc (groups, nsplit, rows, D) and part_ml
    (groups, nsplit, rows, 2) fp32, the partials that each group's last
    block merges, one after the other in the workspace, and counters
    (groups,) int32. Three nulls with one split: the block then writes
    (out, lse) itself."""
    if nsplit == 1:
        return None, None, None
    n_acc = groups * nsplit * rows * HEAD_DIM
    part, counters = _buffers(n_acc + groups * nsplit * rows * 2, groups,
                              dev, stream)
    ptr = part.data_ptr()
    return ptr, ptr + 4 * n_acc, counters.data_ptr()


def quant_decode_cuda(q, k_q, k_scale, v_q, v_scale, length, scale,
                      softcap=None):
    """Quantized-cache decode on the card: fp32 (out (B,Hq,Tq,D), lse
    (B,Hq,Tq)).

    q (B, Hq, Tq, D) bf16 or fp32; k_q, v_q (B, Hkv, S, D) int8,
    float8_e4m3fn or float8_e5m2 with D = 128 and any S >= 1; scales
    (B, Hkv, S) fp32; (Hq / Hkv) * Tq <= 16. ``length`` is a Python int or
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
    rows = (hq // hkv) * tq
    nsplit = num_splits(b * hkv, -(-s // CHUNK))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part_acc, part_ml, counters = scratch_ptrs(b * hkv, nsplit, rows,
                                                   dev, stream)
        rc = lib.rfa_quant_decode(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(),
            v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), len_ptr,
            len_val, out.data_ptr(), lse.data_ptr(), part_acc, part_ml,
            counters, b, hq, hkv, tq, d, s, QTYPES[k_q.dtype], nsplit,
            float(scale), float(softcap or 0.0), stream,
        )
        quant_decode_cuda.launches += 1
    _build.check_launch(lib, rc, "quant_decode")
    return out, lse


quant_decode_cuda.launches = 0
