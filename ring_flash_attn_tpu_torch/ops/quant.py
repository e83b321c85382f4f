"""Quantized KV-cache ops for long-context decode.

The port of ``ring_flash_attn_tpu/ops/quant.py``. Decode attention reads
the whole KV cache for every token, so it is bound by memory bandwidth; a
cache of one byte per value (int8, or fp8 e4m3 / e5m2; symmetric, one fp32
scale per token and head over the head dim) halves the bytes of a bf16
cache. Dequantization folds into the attention math, ``(q . k_q) *
k_scale`` and ``(p * v_scale) @ v_q``, so no wide copy of the cache exists.

Layout: values (B, Hkv, S, D) in the quantized type; scales fp32
(B, Hkv, S).

The JAX functions return new caches; ``update_cache`` here writes the
cache IN PLACE, as the paged cache's writers do, so K and V (and their
scales) are four separate tensors (JAX's ``make_cache`` aliases them).

``quant_decode_attention`` sends a CUDA tensor to kernel B4
(``quant_decode_cuda``) and a CPU tensor, or ``backend="plain"``, to
``_plain_quant_decode``. The kernel takes every cache length S >= 1, so
the JAX package's rule that only multiples of 128 reach its kernel has no
counterpart here.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device, use_kernel
from .mask import NEG_INF
from .quant_decode_cuda import quant_decode_cuda


class QuantizedKV(NamedTuple):
    k_q: torch.Tensor  # int8 / fp8 (B, Hkv, S, D)
    k_scale: torch.Tensor  # f32 (B, Hkv, S)
    v_q: torch.Tensor  # int8 / fp8 (B, Hkv, S, D)
    v_scale: torch.Tensor  # f32 (B, Hkv, S)


_QDTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}


def qdtype_of(x):
    """The qdtype name of a quantized tensor."""
    for name, (dt, _) in _QDTYPES.items():
        if dt == x.dtype:
            return name
    raise TypeError(f"{x.dtype} is not a quantized cache type "
                    f"({[dt for dt, _ in _QDTYPES.values()]})")


def as_bytes(x):
    """A one-byte integer view of a quantized tensor: torch implements
    indexed writes for int8/uint8 but only partly for the fp8 types."""
    return x if x.dtype == torch.int8 else x.view(torch.uint8)


def quantize_tensor(x, qdtype="int8"):
    """Symmetric quantization over the last dim: x ~= x_q * scale[..., None].

    qdtype: "int8" (default), "fp8_e4m3", "fp8_e5m2". Bit-identical to the
    JAX function: a true division by the scale, round half to even and a
    clip for int8, a plain (round-to-nearest-even) cast for fp8."""
    dt, qmax = _QDTYPES[qdtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true quotient in the last bit
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax / torch.full_like(amax, qmax))
    scaled = xf / scale[..., None]
    if qdtype == "int8":
        x_q = torch.round(scaled).clamp(-qmax, qmax).to(dt)
    else:
        x_q = scaled.to(dt)
    return x_q, scale


def quantize_kv(k, v, qdtype="int8"):
    k_q, k_s = quantize_tensor(k, qdtype)
    v_q, v_s = quantize_tensor(v, qdtype)
    return QuantizedKV(k_q, k_s, v_q, v_s)


def make_cache(batch, kv_heads, max_len, head_dim, qdtype="int8",
               device="cuda"):
    """Empty quantized cache (decode-time rolling buffer): zero values,
    unit scales, four separate tensors."""
    dt, _ = _QDTYPES[qdtype]
    device = resolve_device(device)

    def zeros():
        return torch.zeros((batch, kv_heads, max_len, head_dim),
                           dtype=torch.uint8, device=device).view(dt)

    def ones():
        return torch.ones((batch, kv_heads, max_len), dtype=torch.float32,
                          device=device)

    return QuantizedKV(zeros(), ones(), zeros(), ones())


def values_from_numpy(a, qdtype, device):
    """A quantized tensor from a numpy array: int8 values for "int8", the
    uint8 bit patterns of the fp8 values otherwise (numpy has no fp8)."""
    dt, _ = _QDTYPES[qdtype]
    a = np.ascontiguousarray(a)
    want = np.int8 if qdtype == "int8" else np.uint8
    if a.dtype != want:
        raise TypeError(f"{qdtype} values come as {np.dtype(want)}, got "
                        f"{a.dtype}")
    return torch.from_numpy(a.copy()).to(device).view(dt)


def quantized_kv_from_jax(k_q, k_scale, v_q, v_scale, qdtype="int8",
                          device="cuda"):
    """A QuantizedKV holding a JAX ``QuantizedKV``'s arrays, given as numpy
    (fp8 values as their uint8 bit patterns, ``np.asarray(x).view(np.uint8)``),
    so that both packages read the same cache."""
    device = resolve_device(device)

    def scale(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return QuantizedKV(values_from_numpy(k_q, qdtype, device), scale(k_scale),
                       values_from_numpy(v_q, qdtype, device), scale(v_scale))


def update_cache(cache: QuantizedKV, k_new, v_new, index):
    """Quantize new k/v (B, Hkv, T_new, D) and write them at position
    ``index`` (a Python int, or an int tensor on the cache's device, which
    costs no host sync), in place; returns the cache.

    The start is clamped so that the update fits, as JAX's
    ``dynamic_update_slice`` clamps it."""
    qdtype = qdtype_of(cache.k_q)
    s, t_new = cache.k_q.shape[2], k_new.shape[2]
    if t_new > s:
        raise ValueError(f"{t_new} new tokens do not fit a cache of {s}")
    dev = cache.k_q.device
    start = torch.as_tensor(index, device=dev).long().clamp(0, s - t_new)
    pos = start + torch.arange(t_new, device=dev)
    for buf, scales, x in ((cache.k_q, cache.k_scale, k_new),
                           (cache.v_q, cache.v_scale, v_new)):
        x_q, x_s = quantize_tensor(x, qdtype)
        as_bytes(buf).index_copy_(2, pos, as_bytes(x_q))
        scales.index_copy_(2, pos, x_s)
    return cache


def quant_decode_attention(q, cache: QuantizedKV, length, scale,
                           pos_offset=0, softcap=None, backend=None):
    """Decode attention of q (B, Hq, Tq, D) against the quantized cache.

    length: number of valid cache positions, a Python int or a 1-element
    int32 tensor on q's device (no host sync either way); positions >=
    length are masked. pos_offset: global position of this cache shard's
    first token (for sequence-sharded caches; it does not enter the math,
    as in the JAX function). No causality within the new tokens (decode Tq
    is typically 1). Returns fp32 (out (B, Hq, Tq, D), lse (B, Hq, Tq))
    partials so that shards can be LSE-merged; with no live position a row
    gives out=0, lse=NEG_INF.
    """
    if use_kernel(q, backend):
        return quant_decode_cuda(q, cache.k_q, cache.k_scale, cache.v_q,
                                 cache.v_scale, length, scale,
                                 softcap=softcap)
    return _plain_quant_decode(q, cache, length, scale, softcap)


def _plain_quant_decode(q, cache, length, scale, softcap=None):
    """The plain version of kernel B4, in fp32: scales folded after the QK
    product and before the PV product, whole-cache logits."""
    b, hq, tq, d = q.shape
    hkv, s = cache.k_q.shape[1], cache.k_q.shape[2]
    g = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, hkv, g * tq, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, cache.k_q.float()) \
        * cache.k_scale[:, :, None, :] * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    length = torch.as_tensor(length, device=dev).reshape(())
    valid = torch.arange(s, device=dev) < length
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * cache.v_scale[:, :, None, :]
    out = torch.einsum("bhqk,bhkd->bhqd", pv, cache.v_q.float()) / l
    lse = (m + torch.log(l))[..., 0]
    dead = m[..., 0] <= NEG_INF / 2
    out = out.masked_fill(dead[..., None], 0.0)
    lse = lse.masked_fill(dead, NEG_INF)
    return out.reshape(b, hq, tq, d), lse.reshape(b, hq, tq)
