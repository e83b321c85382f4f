"""Paged KV cache and paged decode attention.

The port of ``ring_flash_attn_tpu/ops/paged.py``. The cache lives in a global pool of fixed-size pages; sequences map logical
blocks to pages through int32 block tables; decode attention reads pages
through the table.

Layout:
  k_pages, v_pages  (num_pages, Hkv, page_size, D)  global page pool
  block_tables      (B, pages_per_seq) int32        logical -> physical
  seq_lens          (B,) int32                      valid tokens per lane

The JAX functions return new caches; here the writers (``paged_prefill``,
``paged_append``, ``copy_pages``) update the page pools IN PLACE, where
JAX donates the buffers, and return the cache with its new lengths.
JAX's scatter drops out-of-range writes (mode "drop"); torch indexing has
no such mode, so the writers filter those indices out first.

``paged_decode_attention`` sends a CUDA tensor to kernel B5
(``paged_decode_cuda``) and a CPU tensor, or ``backend="plain"``, to
``_plain_paged_decode``.

The quantized paged cache (``QuantPagedKVCache``: int8 or fp8 pages with
one fp32 scale per token and head, see ``ops/quant.py``) composes paging
with KV quantization. Its scales keep the JAX layout
(num_pages, Hkv, 1, page_size) so that a cache carries across the two
packages. ``paged_quant_decode_attention`` sends a CUDA tensor to kernel B6
(``paged_quant_decode_cuda``) and a CPU tensor, or ``backend="plain"``, to
``_plain_quant_paged_decode``.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device, use_kernel
from .mask import NEG_INF
from .paged_decode_cuda import paged_decode_cuda
from .paged_quant_decode_cuda import paged_quant_decode_cuda
from .quant import (_QDTYPES, as_bytes, qdtype_of, quantize_tensor,
                    values_from_numpy)


class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor  # (num_pages, Hkv, page_size, D)
    v_pages: torch.Tensor  # (num_pages, Hkv, page_size, D)
    block_tables: torch.Tensor  # (B, pages_per_seq) int32
    seq_lens: torch.Tensor  # (B,) int32

    @property
    def page_size(self):
        return self.k_pages.shape[2]


def paged_init(hkv, num_pages, page_size, d, block_tables=None,
               dtype=torch.bfloat16, device="cuda", *, batch=None,
               pages_per_seq=None):
    """Empty cache on ``device`` with the given (B, pages_per_seq) block
    tables (the serving allocator owns them) and zero lengths. Without
    tables, ``batch`` lanes of ``pages_per_seq`` pages each get the JAX
    package's default: lane b the contiguous pages [b * pages_per_seq,
    (b + 1) * pages_per_seq)."""
    device = resolve_device(device)
    if block_tables is None:
        if batch is None or pages_per_seq is None:
            raise ValueError("paged_init without block_tables needs batch "
                             "and pages_per_seq")
        if num_pages < batch * pages_per_seq:
            raise ValueError(f"{batch} lanes of {pages_per_seq} pages need "
                             f"{batch * pages_per_seq} pages, got "
                             f"{num_pages}")
        block_tables = torch.arange(batch * pages_per_seq).reshape(
            batch, pages_per_seq)
    z = torch.zeros((num_pages, hkv, page_size, d), dtype=dtype,
                    device=device)
    tables = torch.as_tensor(block_tables, dtype=torch.int32, device=device)
    return PagedKVCache(
        z, torch.zeros_like(z), tables,
        torch.zeros((tables.shape[0],), dtype=torch.int32, device=device),
    )


def paged_prefill(cache: PagedKVCache, k, v, seq_lens):
    """Bulk-write dense k/v (B, Hkv, S, D) into the cache's pages, in place,
    and set seq_lens. S must be a multiple of page_size; positions past
    seq_lens[b] are written but masked at read. Page ids outside
    [0, num_pages) in block_tables drop their write."""
    num_pages, hkv, ps, d = cache.k_pages.shape
    b, _, s, _ = k.shape
    if s % ps:
        raise ValueError(f"S={s} is not a multiple of page_size={ps}")
    nblk = s // ps
    bt = cache.block_tables[:, :nblk].reshape(-1).long()
    keep = (bt >= 0) & (bt < num_pages)
    for pages, x in ((cache.k_pages, k), (cache.v_pages, v)):
        # x (B, Hkv, S, D) -> blocks (B * nblk, Hkv, ps, D)
        xb = x.reshape(b, hkv, nblk, ps, d).transpose(1, 2).reshape(
            b * nblk, hkv, ps, d)
        pages[bt[keep]] = xb[keep].to(pages.dtype)
    return cache._replace(seq_lens=torch.as_tensor(
        seq_lens, dtype=torch.int32, device=cache.seq_lens.device))


def paged_append(cache: PagedKVCache, k_new, v_new, mask=None):
    """Append ONE token per sequence, in place: k_new/v_new (B, Hkv, 1, D).
    Returns the cache with seq_lens advanced.

    A row at capacity (seq_lens == pages_per_seq * page_size) drops its
    write and stays pinned at capacity. mask (B,) bool: rows with
    mask=False append nothing — a dead lane's zeroed block table aliases
    page 0, which may belong to another sequence."""
    ps = cache.page_size
    capacity = cache.block_tables.shape[1] * ps
    lens = cache.seq_lens.long()
    pos = lens.clamp(max=capacity - 1)
    write = lens < capacity
    if mask is not None:
        write = write & torch.as_tensor(mask, dtype=torch.bool,
                                        device=lens.device)
    page = torch.gather(cache.block_tables.long(), 1,
                        (pos // ps)[:, None])[:, 0]
    rows = torch.nonzero(write)[:, 0]
    page, off = page[rows], pos[rows] % ps
    for pages, x in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        pages[page, :, off, :] = x[rows, :, 0, :].to(pages.dtype)
    return cache._replace(
        seq_lens=(lens + write.long()).clamp(max=capacity).to(torch.int32))


def copy_pages(cache, src, dst):
    """Copy-on-write page copies from the serving allocator, in place:
    pages `src` (M,) over pages `dst` (M,) in both pools."""
    dev = cache.k_pages.device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for pages in (cache.k_pages, cache.v_pages):
        pages[dst] = pages[src]
    return cache


def paged_gather_dense(cache: PagedKVCache):
    """(k, v) dense (B, Hkv, pages_per_seq * page_size, D); positions past
    seq_lens are garbage (mask by length)."""
    num_pages, hkv, ps, d = cache.k_pages.shape
    b, npages = cache.block_tables.shape
    # out-of-range ids clamp, as JAX's gather does
    bt = cache.block_tables.long().clamp(0, num_pages - 1)

    def gather(pages):
        g = pages[bt]  # (B, npages, Hkv, ps, D)
        return g.transpose(1, 2).reshape(b, hkv, npages * ps, d)

    return gather(cache.k_pages), gather(cache.v_pages)


def paged_decode_attention(q, cache: PagedKVCache, scale, softcap=None,
                           backend=None, new_counts=None):
    """Decode attention of q (B, Hq, Tq, D) against the paged cache.

    new_counts (B,) int32 (optional): row-causal bounds for multi-query
    decode: row t attends only kv index j < seq_lens[b] -
    (new_counts[b] - 1 - t). None applies no causality within the new
    tokens (plain decode, Tq typically 1). Dead lanes (seq_lens == 0) give
    out=0, lse=NEG_INF.

    Returns fp32 (out (B, Hq, Tq, D), lse (B, Hq, Tq)) partials.

    Kernel B5 takes any number of rows a kv head ((Hq / Hkv) * Tq): past
    the rows one block serves, its grid takes the row groups side by
    side, each row with its own bound."""
    if use_kernel(q, backend):
        return paged_decode_cuda(q, cache.k_pages, cache.v_pages,
                                 cache.block_tables, cache.seq_lens, scale,
                                 softcap=softcap, new_counts=new_counts)
    return _plain_paged_decode(q, cache, scale, softcap, new_counts)


def _plain_paged_decode(q, cache, scale, softcap=None, new_counts=None):
    """The plain version of kernel B5: gather pages dense, mask, softmax."""
    b, hq, tq, d = q.shape
    hkv = cache.k_pages.shape[1]
    g = hq // hkv
    k, v = paged_gather_dense(cache)
    s_tot = k.shape[2]
    dev = q.device
    qf = q.float().reshape(b, hkv, g * tq, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    # per-row causal bound; rows are (g major, tq minor) so t = row % tq
    t_idx = torch.arange(g * tq, device=dev) % tq
    lens = cache.seq_lens.long()
    counts = (torch.ones_like(lens) if new_counts is None
              else torch.as_tensor(new_counts, device=dev).long())
    bound = lens[:, None] - (counts[:, None] - 1 - t_idx[None]).clamp(min=0)
    valid = (torch.arange(s_tot, device=dev)[None, None, :]
             < bound[:, :, None])[:, None]  # (B, 1, g*tq, s_tot)
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    dead = (lens == 0)[:, None, None]
    out = out.masked_fill(dead[..., None], 0.0)
    lse = lse.masked_fill(dead, NEG_INF)
    return out.reshape(b, hq, tq, d), lse.reshape(b, hq, tq)


# ---------------------------------------------------------------------------
# Quantized paged cache: int8/fp8 pages + per-token scales
# ---------------------------------------------------------------------------


class QuantPagedKVCache(NamedTuple):
    k_pages: torch.Tensor  # int8/fp8 (num_pages, Hkv, page_size, D)
    k_scales: torch.Tensor  # f32 (num_pages, Hkv, 1, page_size)
    v_pages: torch.Tensor
    v_scales: torch.Tensor
    block_tables: torch.Tensor  # (B, pages_per_seq) int32
    seq_lens: torch.Tensor  # (B,) int32

    @property
    def page_size(self):
        return self.k_pages.shape[2]


def paged_quant_init(batch, hkv, num_pages, page_size, pages_per_seq, d,
                     qdtype="int8", block_tables=None, device="cuda"):
    """Empty quantized cache on ``device``: zero pages, unit scales, zero
    lengths; block tables as given, else lane b owns pages
    [b * pages_per_seq, (b + 1) * pages_per_seq)."""
    dt, _ = _QDTYPES[qdtype]
    device = resolve_device(device)
    if block_tables is None:
        if num_pages < batch * pages_per_seq:
            raise ValueError(f"{num_pages} pages do not hold {batch} lanes "
                             f"of {pages_per_seq} pages")
        block_tables = torch.arange(batch * pages_per_seq).reshape(
            batch, pages_per_seq)

    def zeros():
        return torch.zeros((num_pages, hkv, page_size, d), dtype=torch.uint8,
                           device=device).view(dt)

    def ones():
        return torch.ones((num_pages, hkv, 1, page_size),
                          dtype=torch.float32, device=device)

    return QuantPagedKVCache(
        zeros(), ones(), zeros(), ones(),
        torch.as_tensor(block_tables, dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def quant_paged_cache_from_jax(k_pages, k_scales, v_pages, v_scales,
                               block_tables, seq_lens, qdtype="int8",
                               device="cuda"):
    """A QuantPagedKVCache holding a JAX ``QuantPagedKVCache``'s arrays,
    given as numpy (fp8 pages as their uint8 bit patterns), so that both
    packages read the same cache."""
    device = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return QuantPagedKVCache(
        values_from_numpy(k_pages, qdtype, device), f32(k_scales),
        values_from_numpy(v_pages, qdtype, device), f32(v_scales),
        i32(block_tables), i32(seq_lens))


def paged_quant_prefill(cache: QuantPagedKVCache, k, v, seq_lens):
    """Quantize dense k/v (B, Hkv, S, D) per token and write them into the
    cache's pages, in place; same layout rules as ``paged_prefill``."""
    num_pages, hkv, ps, d = cache.k_pages.shape
    b, _, s, _ = k.shape
    if s % ps:
        raise ValueError(f"S={s} is not a multiple of page_size={ps}")
    nblk = s // ps
    bt = cache.block_tables[:, :nblk].reshape(-1).long()
    keep = (bt >= 0) & (bt < num_pages)
    qdtype = qdtype_of(cache.k_pages)
    for pages, scales, x in ((cache.k_pages, cache.k_scales, k),
                             (cache.v_pages, cache.v_scales, v)):
        x_q, x_s = quantize_tensor(x, qdtype)
        # (B, Hkv, S, D) -> blocks (B * nblk, Hkv, ps, D); scales
        # (B, Hkv, S) -> (B * nblk, Hkv, 1, ps)
        xb = as_bytes(x_q).reshape(b, hkv, nblk, ps, d).transpose(
            1, 2).reshape(b * nblk, hkv, ps, d)
        sb = x_s.reshape(b, hkv, nblk, ps).transpose(1, 2).reshape(
            b * nblk, hkv, 1, ps)
        as_bytes(pages)[bt[keep]] = xb[keep]
        scales[bt[keep]] = sb[keep]
    return cache._replace(seq_lens=torch.as_tensor(
        seq_lens, dtype=torch.int32, device=cache.seq_lens.device))


def paged_quant_append(cache: QuantPagedKVCache, k_new, v_new, mask=None):
    """Quantize and append ONE token per sequence, in place: k_new/v_new
    (B, Hkv, 1, D). Same capacity and mask semantics as ``paged_append``:
    rows at capacity or with mask=False write nothing and their seq_lens
    stay put."""
    ps = cache.page_size
    capacity = cache.block_tables.shape[1] * ps
    lens = cache.seq_lens.long()
    pos = lens.clamp(max=capacity - 1)
    write = lens < capacity
    if mask is not None:
        write = write & torch.as_tensor(mask, dtype=torch.bool,
                                        device=lens.device)
    page = torch.gather(cache.block_tables.long(), 1,
                        (pos // ps)[:, None])[:, 0]
    rows = torch.nonzero(write)[:, 0]
    page, off = page[rows], pos[rows] % ps
    qdtype = qdtype_of(cache.k_pages)
    for pages, scales, x in ((cache.k_pages, cache.k_scales, k_new),
                             (cache.v_pages, cache.v_scales, v_new)):
        x_q, x_s = quantize_tensor(x, qdtype)  # (B,Hkv,1,D), (B,Hkv,1)
        as_bytes(pages)[page, :, off, :] = as_bytes(x_q)[rows, :, 0, :]
        scales[page, :, 0, off] = x_s[rows, :, 0]
    return cache._replace(
        seq_lens=(lens + write.long()).clamp(max=capacity).to(torch.int32))


def paged_quant_decode_attention(q, cache: QuantPagedKVCache, scale,
                                 softcap=None, backend=None):
    """Decode attention of q (B, Hq, Tq, D) against the quantized paged
    cache; same fp32 (out, lse) partial contract as
    ``paged_decode_attention`` (no ``new_counts``: every row sees the whole
    lane). On int8 pages q * scale is quantized per row to int8 and QK is an
    exact integer product times q_scale * k_scale, as the JAX kernel
    computes it; fp8 pages are widened and q stays as it is."""
    if use_kernel(q, backend):
        return paged_quant_decode_cuda(
            q, cache.k_pages, cache.k_scales, cache.v_pages, cache.v_scales,
            cache.block_tables, cache.seq_lens, scale, softcap=softcap)
    return _plain_quant_paged_decode(q, cache, scale, softcap)


def _plain_quant_paged_decode(q, cache, scale, softcap=None):
    """The plain version of kernel B6, in fp32: gather pages dense, the
    kernel's int8 q quantization on int8 pages, scales folded after QK and
    before PV, and the kernel's answer (0, NEG_INF) for dead lanes."""
    num_pages, hkv, ps, d = cache.k_pages.shape
    b, npages = cache.block_tables.shape
    hq, tq = q.shape[1], q.shape[2]
    g = hq // hkv
    dev = q.device
    # out-of-range ids clamp, as JAX's gather does
    bt = cache.block_tables.long().clamp(0, num_pages - 1)

    def gather(pages, scales):
        # (B, npages, Hkv, ps, D); fp8 is gathered as bytes
        x = as_bytes(pages)[bt].view(pages.dtype).float()
        s_ = scales[bt][:, :, :, 0, :]  # (B, npages, Hkv, ps)
        return (x.transpose(1, 2).reshape(b, hkv, npages * ps, d),
                s_.transpose(1, 2).reshape(b, hkv, npages * ps))

    k, k_s = gather(cache.k_pages, cache.k_scales)
    v, v_s = gather(cache.v_pages, cache.v_scales)
    qf = (q.float() * scale).reshape(b, hkv, g * tq, d)
    if cache.k_pages.dtype == torch.int8:
        amax = qf.abs().amax(dim=-1, keepdim=True)
        # a tensor divisor, for the true quotient (see quantize_tensor)
        q_s = (amax / torch.full_like(amax, 127.0)).clamp(min=1e-20)
        q_i = torch.round(qf / q_s).clamp(-127, 127)
        # exact in fp32: |sum| <= 128 * 127 * 127 < 2**24
        logits = torch.einsum("bhqd,bhkd->bhqk", q_i, k) * q_s \
            * k_s[:, :, None, :]
    else:
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, k) * k_s[:, :, None, :]
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    lens = cache.seq_lens.long()
    valid = (torch.arange(npages * ps, device=dev)[None, :]
             < lens[:, None])[:, None, None, :]
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p * v_s[:, :, None, :], v) / l
    lse = (m + torch.log(l))[..., 0]
    dead = (lens == 0)[:, None, None]
    out = out.masked_fill(dead[..., None], 0.0)
    lse = lse.masked_fill(dead, NEG_INF)
    return out.reshape(b, hq, tq, d), lse.reshape(b, hq, tq)
