"""Kernels B1, B5, B2, B3a and B3b against their plain versions on the card.

CUDA kernels have no CPU mode, so this test skips without an NVIDIA GPU.
It imports neither JAX nor the JAX package, so it also runs on a machine
without JAX; skip the repository's conftest (which sets JAX up) there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The full check, at the serving shapes and with timings, is chip_smoke.py.
"""

import pytest
import torch

from ring_flash_attn_tpu_torch.ops import paged as tpaged
from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
from ring_flash_attn_tpu_torch.ops.naive import naive_block_fwd


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """B1 (causal with offset, GQA, ragged tiles) and B5 (a dead lane,
    shuffled tables) against their plain versions, bf16 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(1, 8, 200, 128), rnd(1, 2, 300, 128), rnd(1, 2, 300, 128)
    mask = MaskArgs(causal=True, offset=100)
    out, lse = flash_fwd_cuda(q, k, v, 0.088, mask)
    ref_out, ref_lse = naive_block_fwd(q, k, v, 0.088, mask)
    assert float((out - ref_out).abs().max()) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3

    pages = rnd(12, 2, 64, 128), rnd(12, 2, 64, 128)
    tables = torch.randperm(12, generator=g, device=dev).reshape(3, 4).to(
        torch.int32)
    lens = torch.tensor([0, 70, 256], dtype=torch.int32, device=dev)
    cache = tpaged.PagedKVCache(*pages, tables, lens)
    qd = rnd(3, 8, 1, 128)
    out, lse = paged_decode_cuda(qd, *pages, tables, lens, 0.088)
    ref_out, ref_lse = tpaged._plain_paged_decode(qd, cache, 0.088)
    assert float((out - ref_out).abs().max()) <= 2e-3
    assert float((lse - ref_lse).abs().max()) <= 2e-3


@pytest.mark.cuda
def test_cuda_kernels_other_instantiations():
    """B1 at head_dim 64, non-causal, fp32 out; B5 with 16-token pages (a
    chunk shorter than the kernel's 64) and 8 query rows per kv head
    (Tq=2 with new_counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(2, 4, 130, 64), rnd(2, 4, 77, 64), rnd(2, 4, 77, 64)
    out, lse = flash_fwd_cuda(q, k, v, 0.125, MaskArgs())
    ref_out, ref_lse = naive_block_fwd(q, k, v, 0.125, MaskArgs())
    assert out.dtype == torch.float32
    assert float((out - ref_out).abs().max()) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3

    pages = rnd(20, 2, 16, 128), rnd(20, 2, 16, 128)
    tables = torch.randperm(20, generator=g, device=dev)[:16].reshape(
        2, 8).to(torch.int32)
    lens = torch.tensor([37, 128], dtype=torch.int32, device=dev)
    counts = torch.tensor([2, 1], dtype=torch.int32, device=dev)
    cache = tpaged.PagedKVCache(*pages, tables, lens)
    qd = rnd(2, 8, 2, 128)
    out, lse = paged_decode_cuda(qd, *pages, tables, lens, 0.088,
                                 softcap=20.0, new_counts=counts)
    ref_out, ref_lse = tpaged._plain_paged_decode(qd, cache, 0.088, 20.0,
                                                  counts)
    assert float((out - ref_out).abs().max()) <= 2e-3
    assert float((lse - ref_lse).abs().max()) <= 2e-3


def _bwd_inputs(g, b, hq, hkv, sq, skv, d, mask, scale):
    """bf16 q, k, v, dout and the forward's bf16 out and fp32 lse."""
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
    dout = rnd(b, hq, sq, d)
    out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=torch.bfloat16)
    return q, k, v, dout, out, lse


def _rel_err(a, ref):
    return float((a.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-6)


# (B, Hq, Hkv, Sq, Skv, D, causal, offset): causal with an offset and GQA
# over ragged tiles; non-causal at head_dim 64; a negative offset whose
# first rows see no key (dead rows); one query row; three batches of odd
# tiles; 200 dead rows over fewer keys than rows
BWD_CASES = [
    (1, 8, 2, 200, 300, 128, True, 100),
    (2, 4, 4, 130, 77, 64, False, None),
    (1, 4, 2, 100, 70, 128, True, -5),
    (1, 2, 1, 1, 5, 64, True, 4),
    (3, 6, 2, 33, 129, 128, True, 96),
    (1, 4, 1, 257, 64, 64, True, -200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(BWD_CASES)))
def test_cuda_bwd_kernels_match_plain_version(case):
    """B2 and B3a/B3b against naive_block_bwd, in the single-call mode
    (delta=None, bf16 gradients) and the ring mode (delta given, fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    b, hq, hkv, sq, skv, d, causal, offset = BWD_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(case)
    mask = MaskArgs(causal=causal, offset=offset)
    scale = d**-0.5
    q, k, v, dout, out, lse = _bwd_inputs(g, b, hq, hkv, sq, skv, d, mask,
                                          scale)
    delta = compute_delta(dout, out)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
    for bwd in (flash_bwd_cuda, flash_bwd_split_cuda):
        got = bwd(dout, q, k, v, lse, None, scale, mask, out=out,
                  dq_dtype=torch.bfloat16, dkv_dtype=torch.bfloat16)
        assert all(x.dtype == torch.bfloat16 for x in got)
        for x, r in zip(got, ref):
            assert _rel_err(x, r) <= 2e-2, bwd.__name__
        got = bwd(dout, q, k, v, lse, delta, scale, mask)
        assert all(x.dtype == torch.float32 for x in got)
        for x, r in zip(got, ref):
            assert _rel_err(x, r) <= 2e-2, bwd.__name__
    if offset is not None and offset < 0:  # dead rows get no gradient
        assert torch.all(got[0][:, :, :-offset] == 0)


@pytest.mark.cuda
def test_cuda_split_bwd_is_bitwise_reproducible():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)

    g = torch.Generator(device="cuda").manual_seed(7)
    mask = MaskArgs(causal=True)
    q, k, v, dout, out, lse = _bwd_inputs(g, 1, 8, 2, 512, 512, 128, mask,
                                          0.088)
    a = flash_bwd_split_cuda(dout, q, k, v, lse, None, 0.088, mask, out=out)
    c = flash_bwd_split_cuda(dout, q, k, v, lse, None, 0.088, mask, out=out)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_train_step_matches_plain():
    """A narrow two-layer model: loss and gradients of the kernel path
    against the same model on the plain versions, then one train_step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, loss_fn, train_step)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda

    cfg = ModelConfig(vocab=512, dim=256, layers=2, heads=4, kv_heads=2,
                      head_dim=64, mlp_dim=512, dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    s = 300
    tokens = torch.randint(0, cfg.vocab, (1, s), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    pos = torch.arange(s, device="cuda")
    params = list(model.parameters())
    res = {}
    for backend in (None, "plain"):
        loss = loss_fn(model, tokens, labels, pos, backend=backend)
        res[backend] = (float(loss.detach()),
                        torch.autograd.grad(loss, params))
    assert abs(res[None][0] - res["plain"][0]) <= 1e-2
    for gk, gp in zip(res[None][1], res["plain"][1]):
        err = float((gk.float() - gp.float()).norm() / gp.float().norm())
        assert err <= 5e-2
    n = flash_bwd_cuda.launches
    _, loss = train_step(model, tokens, labels, pos)
    assert flash_bwd_cuda.launches == n + cfg.layers
    assert abs(float(loss) - res[None][0]) <= 1e-2


QDTYPE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
          "fp8_e5m2": torch.float8_e5m2}
# fp32 math on both sides; only the summation order, __expf and tanhf
# differ: a few ulps of fp32
QUANT_TOL = 1e-5


def _quant_cache(g, b, hkv, s, qdtype):
    from ring_flash_attn_tpu_torch.ops.quant import quantize_kv

    k = torch.randn((b, hkv, s, 128), generator=g, device="cuda")
    v = torch.randn((b, hkv, s, 128), generator=g, device="cuda")
    return quantize_kv(k, v, qdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", sorted(QDTYPE))
def test_cuda_quantize_tensor_is_bitwise_the_cpu_one(qdtype):
    """The cache must be bit-identical wherever it is written (and to the
    JAX package's, which the CPU tests hold the CPU result against)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.quant import as_bytes, quantize_tensor

    x = torch.randn((4, 2, 300, 128),
                    generator=torch.Generator().manual_seed(3)) * 3
    x[0, 0, 0] = 0
    for xin in (x, x.to(torch.bfloat16)):
        cq, cs = quantize_tensor(xin, qdtype)
        gq, gs = quantize_tensor(xin.cuda(), qdtype)
        assert torch.equal(as_bytes(gq).cpu(), as_bytes(cq))
        assert torch.equal(gs.cpu(), cs)


# (qdtype, B, Hq, Hkv, Tq, S, length, softcap, q dtype): a ragged last
# chunk with a length as a CUDA tensor; fp8 with softcap, 8 rows, S not a
# multiple of anything; a tail-like cache; length 0
B4_CASES = [
    ("int8", 2, 8, 2, 1, 1280, "tensor:1001", None, torch.bfloat16),
    ("fp8_e4m3", 1, 8, 2, 2, 333, 333, 12.0, torch.float32),
    ("fp8_e5m2", 1, 4, 4, 1, 32, 7, None, torch.bfloat16),
    ("int8", 1, 32, 2, 1, 200, 0, None, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(B4_CASES)))
def test_cuda_quant_decode_matches_plain_version(case):
    """B4 against _plain_quant_decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.quant import _plain_quant_decode
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    qdtype, b, hq, hkv, tq, s, length, softcap, qdt = B4_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(case)
    cache = _quant_cache(g, b, hkv, s, qdtype)
    assert cache.k_q.dtype == QDTYPE[qdtype]
    q = torch.randn((b, hq, tq, 128), generator=g, device="cuda").to(qdt)
    if isinstance(length, str):
        length = torch.tensor([int(length.split(":")[1])], dtype=torch.int32,
                              device="cuda")
    n = quant_decode_cuda.launches
    out, lse = quant_decode_cuda(q, cache.k_q, cache.k_scale, cache.v_q,
                                 cache.v_scale, length, 0.088,
                                 softcap=softcap)
    assert quant_decode_cuda.launches == n + 1
    ref_out, ref_lse = _plain_quant_decode(q, cache, length, 0.088, softcap)
    assert float((out - ref_out).abs().max()) <= QUANT_TOL
    assert float((lse - ref_lse).abs().max()) <= QUANT_TOL
    if not isinstance(length, torch.Tensor) and length == 0:
        assert torch.all(out == 0) and torch.all(lse == -1e30)


# (qdtype, page size, Tq, softcap): int8 (q quantized in the kernel) with
# pages longer than a chunk and not a multiple of it; fp8 with short pages
B6_CASES = [("int8", 80, 1, None), ("int8", 16, 2, 20.0),
            ("fp8_e4m3", 16, 1, None), ("fp8_e5m2", 128, 2, 15.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(B6_CASES)))
def test_cuda_paged_quant_decode_matches_plain_version(case):
    """B6 against _plain_quant_paged_decode: shuffled tables, a dead lane,
    a full lane, a lane ending inside a page."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)

    qdtype, ps, tq, softcap = B6_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(case)
    b, hq, hkv, pps = 3, 8, 2, 4
    tables = torch.randperm(b * pps + 3, generator=g, device="cuda")[
        :b * pps].reshape(b, pps).to(torch.int32)
    cache = tpaged.paged_quant_init(b, hkv, b * pps + 3, ps, pps, 128,
                                    qdtype=qdtype, block_tables=tables)
    k = torch.randn((b, hkv, pps * ps, 128), generator=g, device="cuda")
    v = torch.randn((b, hkv, pps * ps, 128), generator=g, device="cuda")
    cache = tpaged.paged_quant_prefill(cache, k, v,
                                       [0, pps * ps, 2 * ps + ps // 3])
    q = torch.randn((b, hq, tq, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    out, lse = paged_quant_decode_cuda(
        q, cache.k_pages, cache.k_scales, cache.v_pages, cache.v_scales,
        cache.block_tables, cache.seq_lens, 0.088, softcap=softcap)
    ref_out, ref_lse = tpaged._plain_quant_paged_decode(q, cache, 0.088,
                                                       softcap)
    assert float((out - ref_out).abs().max()) <= QUANT_TOL
    assert float((lse - ref_lse).abs().max()) <= QUANT_TOL
    assert torch.all(out[0] == 0) and torch.all(lse[0] == -1e30)


@pytest.mark.cuda
def test_cuda_quant_kernels_check_their_operands():
    """Wrong dtype, a CPU tensor and mismatched shapes raise; nothing is
    sent to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    g = torch.Generator(device="cuda").manual_seed(0)
    c = _quant_cache(g, 1, 2, 64, "int8")
    q = torch.randn((1, 8, 1, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    args = (c.k_q, c.k_scale, c.v_q, c.v_scale, 64, 0.088)
    with pytest.raises(TypeError):
        quant_decode_cuda(q.half(), *args)
    with pytest.raises(ValueError):
        quant_decode_cuda(q.cpu(), *args)
    with pytest.raises(TypeError):
        quant_decode_cuda(q, c.k_q.float(), *args[1:])
    with pytest.raises(ValueError):
        quant_decode_cuda(q, c.k_q, c.k_scale[:, :, :32].contiguous(),
                          *args[2:])
    with pytest.raises(ValueError):
        quant_decode_cuda(q[..., :64].contiguous(), *args)
    with pytest.raises(TypeError):
        quant_decode_cuda(q, *args[:4], torch.tensor([64], device="cuda"),
                          0.088)
    cache = tpaged.paged_quant_init(1, 2, 4, 16, 4, 128)
    pargs = (cache.k_pages, cache.k_scales, cache.v_pages, cache.v_scales,
             cache.block_tables, cache.seq_lens, 0.088)
    with pytest.raises(ValueError):
        paged_quant_decode_cuda(q.cpu(), *pargs)
    with pytest.raises(TypeError):
        paged_quant_decode_cuda(q, *pargs[:5], cache.seq_lens.long(), 0.088)
    with pytest.raises(ValueError):
        paged_quant_decode_cuda(q, cache.k_pages, cache.k_scales[:, :, 0],
                                *pargs[2:])


@pytest.mark.cuda
def test_cuda_generate_matches_plain():
    """A narrow two-layer bf16 model at head_dim 128: generate through B1
    and B4 against the same run on the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, decode_step, generate, init_params, prefill)
    from ring_flash_attn_tpu_torch.ops.quant import make_cache
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    cfg = ModelConfig(vocab=512, dim=256, layers=2, heads=4, kv_heads=2,
                      head_dim=128, mlp_dim=512, dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(
        0, cfg.vocab, (1, 300), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    n = quant_decode_cuda.launches
    toks = generate(model, prompt, 5, max_new=8)
    assert quant_decode_cuda.launches == n + cfg.layers * 5 * 2
    assert toks.shape == (1, 5) and toks.dtype == torch.int32
    logits = {}
    for backend in (None, "plain"):
        lp, caches = prefill(model, prompt, backend=backend)
        tails = [make_cache(1, cfg.kv_heads, 8, cfg.head_dim)
                 for _ in model.layers]
        ld, _ = decode_step(model, lp[:, -1].argmax(-1), 300, 0, caches,
                            tails, backend=backend)
        logits[backend] = (lp[:, -1], ld)
    for k_, p_ in zip(logits[None], logits["plain"]):
        assert float((k_ - p_).abs().max()) <= 5e-2 * float(p_.abs().max())
