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
