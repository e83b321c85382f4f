"""The port's CUDA kernels against their plain versions on the card.

CUDA kernels have no CPU mode, so this test skips without an NVIDIA GPU.
It imports neither JAX nor the JAX package, so it also runs on a machine
without JAX; skip the repository's conftest (which sets JAX up) there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The full check, at the serving shapes and with timings, is chip_smoke.py.
"""

import pytest
import torch

from chip_smoke import (B1_EDGE_CASES, B1_LSE_TOL, B1_OUT_TOL, B3A_EDGE_CASES,
                        B5_TOL, B7_EDGE_CASES, BAND_EDGE_CASES, BWD_REL_TOL,
                        D256_BAND_EDGE_CASES, D256_EDGE_CASES,
                        D256_RING_CASES, D256_XFORM_EDGE_CASES, DECODE_CASES,
                        RING_OUT_REL_TOL, SEG_EDGE_CASES, XFORM_EDGE_CASES,
                        b5_case_inputs, b5_edge_cases, band_case_check,
                        d256_case_check, d256_growth_check,
                        d256_ring_case_check,
                        decode_case_check, xform_case_check,
                        band_keep_checks, rel_err_rows, ring_steps,
                        seg_case_mask)
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
    assert float((out - ref_out).abs().max()) <= B1_OUT_TOL
    assert rel_err_rows(out, ref_out) <= RING_OUT_REL_TOL
    assert float((lse - ref_lse).abs().max()) <= B1_LSE_TOL

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
    assert float((out - ref_out).abs().max()) <= B1_OUT_TOL
    assert rel_err_rows(out, ref_out) <= RING_OUT_REL_TOL
    assert float((lse - ref_lse).abs().max()) <= B1_LSE_TOL

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
# tiles; 200 dead rows over fewer keys than rows; then the kv-major loop's
# tile edges (128 keys a block, 64 q rows a step): Skv 127, 128, 129, 255,
# 257 against Sq 63, 64, 65, GQA groups of 8 and 1, both head dims, dead
# rows; then the q-major dq loop's (B3a: 128 q rows a block, 64 keys a
# tile), chip_smoke's B3A_EDGE_CASES
BWD_CASES = [
    (1, 8, 2, 200, 300, 128, True, 100),
    (2, 4, 4, 130, 77, 64, False, None),
    (1, 4, 2, 100, 70, 128, True, -5),
    (1, 2, 1, 1, 5, 64, True, 4),
    (3, 6, 2, 33, 129, 128, True, 96),
    (1, 4, 1, 257, 64, 64, True, -200),
    (1, 32, 4, 63, 127, 128, True, 64),
    (1, 8, 8, 64, 128, 64, False, None),
    (2, 4, 1, 65, 129, 128, True, 64),
    (1, 32, 4, 64, 255, 64, True, 191),
    (1, 8, 8, 65, 257, 128, True, -20),
    (1, 8, 1, 129, 257, 64, False, None),
] + B3A_EDGE_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(BWD_CASES)))
def test_cuda_bwd_kernels_match_plain_version(case):
    """B2 and B3a/B3b against naive_block_bwd, in the single-call mode
    (delta=None, bf16 gradients) and the ring mode (delta given, fp32);
    a second run gives the same bits: all of B3's gradients, B2's dk and dv
    (B2's dq sums through atomics)."""
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
        again = bwd(dout, q, k, v, lse, delta, scale, mask)
        same = [torch.equal(x, y) for x, y in zip(got, again)]
        assert same[1:] == [True, True], bwd.__name__
        assert same[0] or bwd is flash_bwd_cuda
    if offset is not None and offset < 0:  # dead rows get no gradient
        assert torch.all(got[0][:, :, :-offset] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(b5_edge_cases())))
def test_cuda_paged_decode_split_edges(case):
    """B5 at the split plan's edges (chip_smoke's b5_edge_cases: one
    32768-token lane, a lane ending on a split boundary, lanes of 0 and 1
    token, 16-token pages, R = 16 with new_counts, softcap with fp32 q)
    against its plain version within B5_TOL; two calls give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    spec = b5_edge_cases()[case]
    g = torch.Generator(device="cuda").manual_seed(300 + case)
    q, kp, vp, tables, lens, counts = b5_case_inputs(torch, spec, g, case)
    n = paged_decode_cuda.launches
    got, again = (paged_decode_cuda(q, kp, vp, tables, lens, 0.088,
                                    softcap=spec["cap"], new_counts=counts)
                  for _ in range(2))
    assert paged_decode_cuda.launches == n + 2
    ref_out, ref_lse = tpaged._plain_paged_decode(
        q, tpaged.PagedKVCache(kp, vp, tables, lens), 0.088, spec["cap"],
        counts)
    assert float((got[0] - ref_out).abs().max()) <= B5_TOL
    assert float((got[1] - ref_lse).abs().max()) <= B5_TOL
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    dead = lens == 0
    assert torch.all(got[0][dead] == 0) and torch.all(got[1][dead] == -1e30)


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["mask-free", "seg", "xform", "all"])
@pytest.mark.parametrize("d", [128, 256])
def test_cuda_split_bwd_is_bitwise_reproducible(d, build):
    """B3a's dq and B3b's dk, dv the same bits in two calls, at head_dim
    128 and 256, in the mask-free, segmented, softcap (XFORM) and window
    + softcap + dropout (BAND ALL) builds, each launch the build's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dq_cuda, flash_bwd_split_cuda)

    g = torch.Generator(device="cuda").manual_seed(7)
    seg = (torch.arange(512, device="cuda") // 200).to(torch.int32)
    mask = {"mask-free": MaskArgs(causal=True),
            "seg": MaskArgs(causal=True, q_segids=seg, kv_segids=seg),
            "xform": MaskArgs(causal=True, softcap=5.0),
            "all": MaskArgs(causal=True, softcap=5.0, window_left=100,
                            dropout_p=0.1, dropout_seed=3)}[build]
    scale = d ** -0.5
    q, k, v, dout, out, lse = _bwd_inputs(g, 1, 8, 2, 512, 512, d, mask,
                                          scale)
    counts = (flash_bwd_dq_cuda.xform_launches,
              flash_bwd_dq_cuda.band_launches)
    a = flash_bwd_split_cuda(dout, q, k, v, lse, None, scale, mask, out=out)
    c = flash_bwd_split_cuda(dout, q, k, v, lse, None, scale, mask, out=out)
    for x, y in zip(a, c):
        assert torch.equal(x, y)
    assert (flash_bwd_dq_cuda.xform_launches - counts[0],
            flash_bwd_dq_cuda.band_launches - counts[1]) == (
                2 * (build == "xform"), 2 * (build == "all"))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["1761", "B2's ceiling", "past it"])
def test_cuda_long_packing_past_b2_segment_classes(tiles):
    """A segmented backward at head_dim 256 in the ALL build (softcap and
    dropout) over 1024 keys, its q rows in 1761 q tiles of 64, in as many
    as B2's shared memory holds the classes of
    (``fused_bwd_seg_max_q_tiles``) or in one more: ``block_bwd`` gives
    the first two to B2 and the last to B3a/B3b, whose launches it
    counts, and B2's own launcher refuses the last with a ValueError.
    dq, dk and dv within BWD_REL_TOL of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash import block_bwd, compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import (
        flash_bwd_cuda, fused_bwd_seg_max_q_tiles)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    d, skv = 256, 1024
    kv_seg = (torch.arange(skv, device="cuda") // 256).to(torch.int32)
    mask = MaskArgs(kv_segids=kv_seg, softcap=20.0, dropout_p=0.1,
                    dropout_seed=5)
    most = fused_bwd_seg_max_q_tiles(d, mask)
    n = {"1761": 1761, "B2's ceiling": most, "past it": most + 1}[tiles]
    sq = 64 * n
    q_seg = ((torch.arange(sq, device="cuda") // 64) % 4).to(torch.int32)
    mask = mask._replace(q_segids=q_seg)
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, dout, out, lse = _bwd_inputs(g, 1, 1, 1, sq, skv, d, mask,
                                          d ** -0.5)
    delta = compute_delta(dout, out)
    before = (flash_bwd_cuda.launches, flash_bwd_dq_cuda.launches)
    got = block_bwd(dout, q, k, v, lse, delta, d ** -0.5, mask)
    split = n > most
    assert (flash_bwd_cuda.launches - before[0],
            flash_bwd_dq_cuda.launches - before[1]) == (int(not split),
                                                        int(split))
    if split:
        with pytest.raises(ValueError, match=f"at most {most} q tiles"):
            flash_bwd_cuda(dout, q, k, v, lse, delta, d ** -0.5, mask)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, d ** -0.5, mask)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_err(a, r) <= BWD_REL_TOL, (name, _rel_err(a, r))


@pytest.mark.cuda
def test_cuda_head_dim_256_dq_at_its_segment_class_ceiling():
    """B3a's segmented build at head_dim 256 over as many kv tiles as its
    shared memory holds the classes of (``dq_seg_max_kv_tiles``: 7968,
    509,952 keys; the build before the 128-row q tiles held ~139k), one
    q tile's segment over all but the last 512 keys, the other's over
    those: dq within BWD_REL_TOL of max|plain|; one tile more raises a
    ValueError that names the ceiling, not a launch error."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        dq_seg_max_kv_tiles, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    d, sq = 256, 256
    most = dq_seg_max_kv_tiles(d)
    assert most == 7968
    skv = 64 * most
    q_seg = (torch.arange(sq, device="cuda") >= 128).to(torch.int32)
    kv_seg = (torch.arange(skv, device="cuda") >= skv - 512).to(torch.int32)
    mask = MaskArgs(q_segids=q_seg, kv_segids=kv_seg)
    g = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, dout, out, lse = _bwd_inputs(g, 1, 2, 1, sq, skv, d, mask,
                                          d ** -0.5)
    delta = compute_delta(dout, out)
    dq = flash_bwd_dq_cuda(dout, q, k, v, lse, delta, d ** -0.5, mask)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, d ** -0.5, mask)[0]
    assert _rel_err(dq, ref) <= BWD_REL_TOL
    more = torch.cat([k, k[:, :, :64]], dim=2)
    longer = mask._replace(kv_segids=torch.cat([kv_seg, kv_seg[-64:]]))
    with pytest.raises(ValueError, match=f"at most {most} kv tiles"):
        flash_bwd_dq_cuda(dout, q, more, more, lse, delta, d ** -0.5, longer)


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
# the kernels' q and p in two fp16 halves (~22 bits) against exact cache
# values, fp32 on the plain side; the summation order, __expf and tanhf
# differ too: a few ulps of fp32
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
# multiple of anything; a tail-like cache; length 0. Then the pipelines'
# edges (quant_decode.cuh: 64-token chunks dealt out in turn to 3
# pipelines a block at 4 and 8 rows, 3 stages a ring): a few chunks; one
# split (S = 640) over C * NP * NST - 1, C * NP * NST and C * NP * NST + 1
# tokens, so that pipeline 0's last chunk (1 token) wraps its ring; S = 1;
# blocks with no chunk (100 tokens of 4096 over 8 splits); 2 splits of 32
# chunks each (64 groups), so every ring wraps and the merge runs; R = 8
# and 16 in every qtype.
B4_CASES = [
    ("int8", 2, 8, 2, 1, 1280, "tensor:1001", None, torch.bfloat16),
    ("fp8_e4m3", 1, 8, 2, 2, 333, 333, 12.0, torch.float32),
    ("fp8_e5m2", 1, 4, 4, 1, 32, 7, None, torch.bfloat16),
    ("int8", 1, 32, 2, 1, 200, 0, None, torch.bfloat16),
    ("int8", 1, 8, 2, 1, 257, 255, None, torch.bfloat16),
    ("fp8_e4m3", 1, 8, 2, 1, 257, 256, None, torch.bfloat16),
    ("fp8_e5m2", 1, 8, 2, 1, 257, 257, None, torch.bfloat16),
    ("int8", 1, 8, 2, 1, 640, 575, None, torch.bfloat16),
    ("fp8_e4m3", 1, 8, 2, 1, 640, 576, 15.0, torch.float32),
    ("fp8_e5m2", 1, 8, 2, 1, 640, 577, None, torch.bfloat16),
    ("int8", 1, 8, 2, 1, 1, 1, None, torch.bfloat16),
    ("int8", 1, 8, 2, 1, 4096, "tensor:100", None, torch.bfloat16),
    ("int8", 8, 32, 8, 1, 4096, 4000, None, torch.bfloat16),
    ("int8", 1, 32, 4, 1, 3000, 2999, 20.0, torch.float32),
    ("fp8_e4m3", 1, 32, 4, 1, 3000, 3000, None, torch.bfloat16),
    ("fp8_e5m2", 2, 16, 2, 2, 700, 650, None, torch.bfloat16),
    ("int8", 1, 8, 2, 4, 5000, 4999, None, torch.bfloat16),
    ("fp8_e4m3", 1, 8, 2, 4, 129, 129, 10.0, torch.float32),
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


# (qdtype, page size, Tq, softcap[, Hq, pages a lane, lens]): int8 (q
# quantized in the kernel) with pages longer than a chunk and not a
# multiple of it; fp8 with short pages. Then the pipelines' edges, each
# with a dead lane first: pages of one chunk, 10 a lane (one split), lanes
# of C * NP * NST - 1, C * NP * NST and C * NP * NST + 1 tokens (as in
# B4_CASES); lanes of 1 token; R = 8 (int8, s8 products) and R = 16
# (Tq = 2 or 4) in every qtype. By default Hq = 8, 4 pages a lane and
# lens [0, the whole lane, two pages and a third].
B6_CASES = [("int8", 80, 1, None), ("int8", 16, 2, 20.0),
            ("fp8_e4m3", 16, 1, None), ("fp8_e5m2", 128, 2, 15.0),
            ("int8", 64, 1, None, 8, 10, [0, 575, 576, 577]),
            ("fp8_e4m3", 64, 1, 30.0, 8, 10, [0, 577, 575, 576]),
            ("fp8_e5m2", 16, 1, None, 8, 4, [0, 1, 64, 1]),
            ("int8", 16, 1, 30.0, 16, 40, [0, 640, 333, 1]),
            ("int8", 80, 2, None, 16, 8, [0, 640, 257, 81]),
            ("fp8_e4m3", 256, 4, None, 8, 4, [0, 1024, 1000, 3]),
            ("fp8_e5m2", 100, 2, None, 16, 3, [0, 300, 299, 1])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(B6_CASES)))
def test_cuda_paged_quant_decode_matches_plain_version(case):
    """B6 against _plain_quant_paged_decode: shuffled tables, a dead lane,
    a full lane, a lane ending inside a page, the pipeline's edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)

    qdtype, ps, tq, softcap, *rest = B6_CASES[case]
    hq, pps, lens = rest or (8, 4, None)
    lens = lens or [0, pps * ps, 2 * ps + ps // 3]
    g = torch.Generator(device="cuda").manual_seed(case)
    b, hkv = len(lens), 2
    tables = torch.randperm(b * pps + 3, generator=g, device="cuda")[
        :b * pps].reshape(b, pps).to(torch.int32)
    cache = tpaged.paged_quant_init(b, hkv, b * pps + 3, ps, pps, 128,
                                    qdtype=qdtype, block_tables=tables)
    k = torch.randn((b, hkv, pps * ps, 128), generator=g, device="cuda")
    v = torch.randn((b, hkv, pps * ps, 128), generator=g, device="cuda")
    cache = tpaged.paged_quant_prefill(cache, k, v, lens)
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
def test_cuda_quant_decode_is_bitwise_reproducible_across_shapes():
    """B4 and B6 give the same bits call after call, also after a call of
    another shape (other groups, other splits) on the same workspace: the
    group counters are back at zero after every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import _plain_quant_decode
    from ring_flash_attn_tpu_torch.ops import quant_decode_cuda as qd
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        num_splits, quant_decode_cuda)

    g = torch.Generator(device="cuda").manual_seed(41)
    big, small = _quant_cache(g, 1, 8, 8192, "int8"), _quant_cache(
        g, 2, 2, 700, "fp8_e4m3")
    q1 = torch.randn((1, 32, 1, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    q2 = torch.randn((2, 8, 2, 128), generator=g, device="cuda").to(
        torch.bfloat16)

    def b4(q, c, n):
        return quant_decode_cuda(q, c.k_q, c.k_scale, c.v_q, c.v_scale, n,
                                 0.088)

    first = b4(q1, big, 8000)
    other = b4(q2, small, 650)
    again = b4(q1, big, 8000)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    ref = _plain_quant_decode(q2, small, 650, 0.088, None)
    assert float((other[0] - ref[0]).abs().max()) <= QUANT_TOL
    torch.cuda.synchronize()
    assert num_splits(8, 128) > 1 and num_splits(4, 11) == 1
    _, counters = qd._WORKSPACES[(q1.device,
                                  torch.cuda.current_stream().cuda_stream)]
    assert torch.all(counters == 0)

    b, hkv, ps, pps = 4, 8, 256, 16
    tables = torch.randperm(b * pps, generator=g, device="cuda").reshape(
        b, pps).to(torch.int32)
    cache = tpaged.paged_quant_init(b, hkv, b * pps, ps, pps, 128,
                                    block_tables=tables)
    k = torch.randn((b, hkv, pps * ps, 128), generator=g, device="cuda")
    cache = tpaged.paged_quant_prefill(cache, k, k.flip(-1),
                                       [4096, 3000, 0, 17])
    q4 = torch.randn((b, 32, 1, 128), generator=g, device="cuda").to(
        torch.bfloat16)

    def b6(q):
        return paged_quant_decode_cuda(
            q, cache.k_pages, cache.k_scales, cache.v_pages, cache.v_scales,
            cache.block_tables, cache.seq_lens, 0.088)

    first = b6(q4)
    b4(q2, small, 700)
    b6(q4[:, :8].contiguous())  # R = 1: another plan
    again = b6(q4)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


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


@pytest.mark.cuda
@pytest.mark.parametrize("causal,cap,alibi,d,ll,hq,hkv", [
    (True, None, False, 128, 200, 8, 2), (True, 20.0, True, 128, 200, 8, 2),
    (False, 25.0, True, 64, 200, 8, 2),
    # B8's tile edges (128 keys a block, 64 q rows a step), groups 8 and 1
    (True, None, True, 128, 129, 32, 4), (True, 30.0, False, 64, 257, 8, 8),
    (False, None, False, 128, 127, 8, 1), (True, 20.0, True, 64, 65, 8, 1),
    # head_dim 256 (Gemma 2: softcap 50), B8's 64-key blocks
    (True, 50.0, False, 256, 130, 8, 4), (False, 4.0, True, 256, 65, 4, 1),
])
def test_fused_ring_kernels_match_plain_versions(causal, cap, alibi, d, ll,
                                                 hq, hkv):
    """B7 and B8 through ``fused_ring_attention`` (one process: a ring of
    one, first and last step at once) and through a rank's three steps with
    the state carried, against their plain versions, bf16 inputs; B8's dk
    and dv are the same bits over two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr
    from ring_flash_attn_tpu_torch.parallel.fused_ring_cuda import (
        fused_ring_bwd_cuda, fused_ring_fwd_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    slopes = (torch.tensor([2.0 ** (-i - 1) for i in range(hq)], device=dev)
              if alibi else None)
    kw = dict(scale=d ** -0.5, causal=causal, softcap=cap,
              alibi_slopes=slopes, bwd_mode="fused")
    q, k, v, dout = rnd(1, hq, ll, d), rnd(1, hkv, ll, d), rnd(1, hkv, ll, d), \
        rnd(1, hq, ll, d)
    before = fused_ring_fwd_cuda.launches, fused_ring_bwd_cuda.launches
    res = {}
    for backend in (None, "plain", "again"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = fr.fused_ring_attention(
            *leaves, backend=None if backend == "again" else backend, **kw)
        res[backend] = (out, lse, *torch.autograd.grad(out, leaves, dout))
    assert (fused_ring_fwd_cuda.launches, fused_ring_bwd_cuda.launches) == (
        before[0] + 2, before[1] + 2)
    got, ref = res[None], res["plain"]
    assert torch.equal(got[3], res["again"][3])  # dk
    assert torch.equal(got[4], res["again"][4])  # dv
    # out and the gradients within 2e-2 of max|plain|, lse within 1e-3
    assert float((got[1] - ref[1]).abs().max()) <= 1e-3
    for a, b in zip((got[0], *got[2:]), (ref[0], *ref[2:])):
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2e-2 * float(b.float().abs().max())

    # rank 2 of 3: the diagonal, then the shards of ranks 1 and 0
    qs = fr._prescale(q, kw["scale"] * fr.LOG2E)
    tk = fr._transforms(q, causal, cap, slopes)
    shards = [(rnd(1, hkv, ll, d), rnd(1, hkv, ll, d)) for _ in range(3)]
    outs = {}
    for backend in (None, "plain"):
        state = fr.new_state(qs)
        for step, (ks, vs) in enumerate(shards):
            r = fr.fwd_step(qs, ks, vs, state, backend=backend,
                            diagonal=causal and step == 0, first=step == 0,
                            last=step == 2, q_pos0=2 * ll,
                            kv_pos0=(2 - step) * ll, **tk)
        outs[backend] = r
    plain_out = outs["plain"][0].float()
    assert float((outs[None][0].float() - plain_out).abs().max()) \
        <= 2e-2 * float(plain_out.abs().max())
    assert float((outs[None][1] - outs["plain"][1]).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(B1_EDGE_CASES)))
def test_cuda_fwd_tile_edges_match_plain_version(case):
    """B1 against naive_block_fwd at the tile edges (chip_smoke's
    B1_EDGE_CASES), bf16 inputs: out within B1_OUT_TOL and, row by row,
    within RING_OUT_REL_TOL of the row's max|plain|, lse within B1_LSE_TOL;
    rows with no key give (0, NEG_INF)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda

    b, hq, hkv, sq, skv, d, causal, offset, odt = B1_EDGE_CASES[case]
    odt = getattr(torch, odt)
    g = torch.Generator(device="cuda").manual_seed(100 + case)

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
    mask = MaskArgs(causal=causal, offset=offset)
    out, lse = flash_fwd_cuda(q, k, v, d**-0.5, mask, out_dtype=odt)
    ref_out, ref_lse = naive_block_fwd(q, k, v, d**-0.5, mask)
    assert out.dtype == odt
    assert float((out.float() - ref_out).abs().max()) <= B1_OUT_TOL
    assert rel_err_rows(out, ref_out) <= RING_OUT_REL_TOL
    assert float((lse - ref_lse).abs().max()) <= B1_LSE_TOL
    if causal and offset < 0:
        dead = min(sq, -offset)
        assert torch.all(out[:, :, :dead] == 0)
        assert torch.all(lse[:, :, :dead] == -1e30)


def _finish_state(m, l, acc):
    """(out fp32, lse) of a ring state as the last step gives them."""
    live = l > 0
    safe = torch.where(live, l, torch.ones_like(l))
    out = (acc / safe[..., None]) * live[..., None]
    lse = torch.where(live, (m + torch.log2(safe)) * 0.6931471805599453,
                      torch.full_like(m, -1e30))
    return out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(B7_EDGE_CASES)))
def test_cuda_fused_ring_fwd_tile_edges_match_plain_version(case):
    """B7 step by step against its plain version at the tile edges
    (chip_smoke's B7_EDGE_CASES), the state carried over, with and without
    softcap and ALiBi (XFORM): out within RING_OUT_REL_TOL of max|plain|
    after every step, lse within B1_LSE_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    hq, hkv, sq, skv, d, causal, cap, alibi, n = B7_EDGE_CASES[case]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(200 + case)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    slopes = (torch.tensor([2.0 ** (-i - 1) for i in range(hq)], device=dev)
              if alibi else None)
    q = rnd(1, hq, sq, d)
    qs = fr._prescale(q, d**-0.5 * fr.LOG2E)
    kw = fr._transforms(q, causal, cap, slopes)
    shards = [(rnd(1, hkv, skv, d), rnd(1, hkv, skv, d)) for _ in range(n)]
    states = {None: fr.new_state(qs), "plain": fr.new_state(qs)}
    for step, ((k, v), pos) in enumerate(zip(shards,
                                             ring_steps(n, skv, causal))):
        flags = dict(first=step == 0, last=step == n - 1, **pos, **kw)
        res = {be: fr.fwd_step(qs, k, v, states[be], backend=be, **flags)
               for be in (None, "plain")}
        if res[None] is None:
            res = {be: _finish_state(*states[be]) for be in res}
        got, ref = res[None], res["plain"]
        scale = max(float(ref[0].float().abs().max()), 1e-6)
        assert float((got[0].float() - ref[0].float()).abs().max()) \
            <= RING_OUT_REL_TOL * scale, step
        assert float((got[1] - ref[1]).abs().max()) <= B1_LSE_TOL, step


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ring", "zigzag_ring", "stripe"])
def test_cuda_ring_deterministic_dq_is_bitwise_reproducible(kind):
    """``deterministic=True`` on a ring, zigzag or stripe entry point (W=1,
    no process group) runs the split kernels: dq, dk and dv are the same
    bits over two backward calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dq_cuda)

    func = getattr(api, f"{kind}_flash_attn_func")
    g = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, dout = rnd(1, 1024, 8, 128), rnd(1, 1024, 2, 128), \
        rnd(1, 1024, 2, 128), rnd(1, 1024, 8, 128)
    n = flash_bwd_dq_cuda.launches, flash_bwd_cuda.launches
    grads = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = func(*leaves, causal=True, deterministic=True)
        grads.append(torch.autograd.grad(out, leaves, dout))
    # one step a call at W=1: B3a twice, B2 never
    assert (flash_bwd_dq_cuda.launches, flash_bwd_cuda.launches) == (
        n[0] + 2, n[1])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_stripe_w4_in_one_process_matches_plain(d):
    """Every rank's stripe steps at W=4 in one process (chip_smoke's
    ``_rank_fwd`` / ``_rank_bwd``: B1 at offset 0 and -1, merge_partials,
    B2) against the plain versions over the whole sequence after
    ``restore_stripe``; S=1024, 4/2 heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from chip_smoke import BWD_REL_TOL, _rank_bwd, _rank_fwd
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd
    from ring_flash_attn_tpu_torch.parallel import layouts, stripe

    world, s, hq, hkv = 4, 1024, 4, 2
    scale = d**-0.5
    g = torch.Generator(device="cuda").manual_seed(d)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, dout = rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d), \
        rnd(1, hq, s, d)
    qs, ks, vs, douts = ([layouts.extract_local_stripe(x, r, world, axis=2)
                          .contiguous() for r in range(world)]
                         for x in (q, k, v, dout))
    step_mask = stripe._step_masks(dict(softcap=None))
    n = flash_fwd_cuda.launches, flash_bwd_cuda.launches
    res = [_rank_fwd(qs, ks, vs, r, scale, step_mask) for r in range(world)]
    outs, lses = [o for o, _ in res], [x for _, x in res]
    dkvs = [torch.zeros((2,) + tuple(x.shape), device="cuda") for x in ks]
    dqs = [_rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                     step_mask) for r in range(world)]
    # every rank computes every step: W * W launches of each kernel
    assert (flash_fwd_cuda.launches, flash_bwd_cuda.launches) == (
        n[0] + world * world, n[1] + world * world)

    def restore(parts):
        return layouts.restore_stripe(torch.cat(parts, dim=2), world, axis=2)

    out, lse = restore(outs), restore(lses)
    mask = MaskArgs(causal=True)
    ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
    assert float((out.float() - ref_out).abs().max()) <= B1_OUT_TOL
    assert rel_err_rows(out, ref_out) <= RING_OUT_REL_TOL
    assert float((lse - ref_lse).abs().max()) <= B1_LSE_TOL
    ref = naive_block_bwd(dout, q, k, v, lse, compute_delta(dout, out),
                          scale, mask)
    got = (restore(dqs), restore([a[0] for a in dkvs]),
           restore([a[1] for a in dkvs]))
    for a, r in zip(got, ref):
        assert _rel_err(a, r) <= BWD_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("length", [192, 256, 320])
def test_cuda_llama3_shapes_match_plain(length):
    """B1, B2 and B3a/B3b at llama3's shapes: every rank r of W=4 holds
    ``length`` q rows against all 4 * length keys at offset r * length
    (the keys past the rank's last row have no row at all), against the
    plain versions; lengths on and off the tiles' edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from chip_smoke import BWD_REL_TOL
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    world, hq, hkv, d = 4, 8, 2, 128
    scale = d**-0.5
    g = torch.Generator(device="cuda").manual_seed(length)
    for rank in range(world):
        mask = MaskArgs(causal=True, offset=rank * length)
        q, k, v, dout, out, lse = _bwd_inputs(
            g, 1, hq, hkv, length, world * length, d, mask, scale)
        ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
        assert float((out.float() - ref_out).abs().max()) <= B1_OUT_TOL
        assert rel_err_rows(out, ref_out) <= RING_OUT_REL_TOL
        assert float((lse - ref_lse).abs().max()) <= B1_LSE_TOL
        f32, _ = flash_fwd_cuda(q, k, v, scale, mask)
        assert rel_err_rows(f32, ref_out) <= RING_OUT_REL_TOL
        delta = compute_delta(dout, out)
        ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
        for bwd in (flash_bwd_cuda, flash_bwd_split_cuda):
            got = bwd(dout, q, k, v, lse, delta, scale, mask)
            for a, r in zip(got, ref):
                assert _rel_err(a, r) <= BWD_REL_TOL, (bwd.__name__, rank)
            # keys no row of this rank reaches get no gradient
            assert torch.all(got[1][:, :, (rank + 1) * length:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [None, 1])
def test_cuda_llama3_backward_matches_plain(stride):
    """``llama3_attention``'s forward and backward at W=1 (no process
    group) on the kernels against ``backend="plain"`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from chip_smoke import BWD_REL_TOL
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.parallel import llama3_attention

    g = torch.Generator(device="cuda").manual_seed(21)

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, dout = rnd(2, 8, 640, 128), rnd(2, 2, 640, 128), \
        rnd(2, 2, 640, 128), rnd(2, 8, 640, 128)
    res = {}
    for backend in (None, "plain"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        n = flash_bwd_cuda.launches
        out, lse = llama3_attention(*leaves, scale=128**-0.5, causal=True,
                                    heads_k_stride=stride, backend=backend)
        grads = torch.autograd.grad(out, leaves, dout)
        launched = flash_bwd_cuda.launches - n
        assert launched == (0 if backend else 2 // (stride or 2)), backend
        assert all(x.dtype == torch.bfloat16 for x in (out, *grads))
        res[backend] = (out.detach(), lse, *grads)
    got, ref = res[None], res["plain"]
    assert rel_err_rows(got[0], ref[0]) <= RING_OUT_REL_TOL
    assert float((got[1] - ref[1]).abs().max()) <= B1_LSE_TOL
    for a, r in zip(got[2:], ref[2:]):
        assert _rel_err(a, r.float()) <= BWD_REL_TOL


@pytest.mark.cuda
def test_cuda_moe_train_step_matches_plain():
    """A 2-layer narrow MoE model on the card (B1 and B2 in attention, the
    fp32 experts) against the same model with ``backend="plain"``: the loss
    and every gradient, the plain run routed as the kernels' run was
    (``chip_smoke.moe_routes``: a token near an argmax tie may flip, and
    one flipped token moves its two experts' gradients by several per
    cent); then ``train_step`` with lr 0, whose loss is the kernels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from chip_smoke import GRAD_REL_TOL, LOSS_TOL, moe_routes
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, loss_fn, train_step)

    cfg = ModelConfig(vocab=512, dim=256, layers=2, heads=4, kv_heads=2,
                      head_dim=128, mlp_dim=512, moe_experts=4)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 512), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             2))
    batch = (toks, torch.cat([toks[:, 1:], torch.full_like(toks[:, :1],
                                                           -100)], 1),
             torch.arange(512, device="cuda"))
    params = list(model.parameters())
    with moe_routes() as kernel_routes:
        loss = loss_fn(model, *batch)
        grads_k = torch.autograd.grad(loss, params)
        loss_k = float(loss.detach())
    with moe_routes(force=kernel_routes["experts"]) as plain_routes:
        loss = loss_fn(model, *batch, backend="plain")
        grads_p = torch.autograd.grad(loss, params)
        loss_p = float(loss.detach())
    assert len(plain_routes["experts"]) == cfg.layers
    assert abs(loss_k - loss_p) <= LOSS_TOL
    for a, r in zip(grads_k, grads_p):
        assert torch.isfinite(a).all()
        assert float((a.float() - r.float()).norm()
                     / r.float().norm().clamp_min(1e-30)) <= GRAD_REL_TOL
    _, loss = train_step(model, *batch, lr=0.0)
    assert abs(float(loss) - loss_k) <= LOSS_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(SEG_EDGE_CASES)))
def test_cuda_segmented_kernels_match_plain_versions(case):
    """B1, B2 and B3a/B3b with segment ids and positions against their
    plain versions at the tile edges of chip_smoke's SEG_EDGE_CASES:
    causal on positions with packed_self, segments alone, segments with
    causal by index at an offset (Sq < Skv), shuffled segments with
    non-monotone positions (no bound by index may apply), a q segment that
    kv lacks (dead rows give (0, NEG_INF) and dq = 0; keys no row sees get
    dk = dv = 0); B3 bitwise the same twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import NEG_INF, allowed_mask
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    b, hq, hkv, sq, skv, d, kind, cu = SEG_EDGE_CASES[case]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(case)
    mask = seg_case_mask(torch, kind, sq, skv, cu, dev, seed=case)
    scale = d**-0.5
    q, k, v, dout, out, lse = _bwd_inputs(g, b, hq, hkv, sq, skv, d, mask,
                                          scale)
    got_out, got_lse = flash_fwd_cuda(q, k, v, scale, mask)
    ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
    errs = (float((got_out - ref_out).abs().max()),
            rel_err_rows(got_out, ref_out),
            float((got_lse - ref_lse).abs().max()))
    assert errs[0] <= B1_OUT_TOL and errs[1] <= RING_OUT_REL_TOL, errs
    assert errs[2] <= B1_LSE_TOL, errs
    allowed = allowed_mask(mask, sq, skv, dev)
    dead_rows, dead_keys = ~allowed.any(1), ~allowed.any(0)
    assert torch.all(got_lse[:, :, dead_rows] == NEG_INF)
    assert torch.all(got_out[:, :, dead_rows] == 0)
    delta = compute_delta(dout, out)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
    # where every row sees one key (T = 1) the softmax has no gradient: dq
    # and dk are rounding noise on both sides, held on dv's scale
    one_key = bool((allowed.sum(1) <= 1).all())
    floor = float(ref[2].abs().max()) if one_key else 0.0
    for bwd in (flash_bwd_cuda, flash_bwd_split_cuda):
        got = bwd(dout, q, k, v, lse, delta, scale, mask)
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            err = float((x.float() - r).abs().max()) / max(
                float(r.abs().max()), floor, 1e-6)
            assert err <= BWD_REL_TOL, (bwd.__name__, name, err)
        assert torch.all(got[0][:, :, dead_rows] == 0)
        assert torch.all(got[1][:, :, dead_keys] == 0)
        assert torch.all(got[2][:, :, dead_keys] == 0)
        again = bwd(dout, q, k, v, lse, delta, scale, mask)
        same = [torch.equal(x, y) for x, y in zip(got, again)]
        assert same[1:] == [True, True], bwd.__name__
        assert same[0] or bwd is flash_bwd_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(XFORM_EDGE_CASES)))
def test_cuda_xform_kernels_match_plain_versions(case):
    """B1, B2 and B3a/B3b with softcap and/or ALiBi (their XFORM
    instantiations) against their plain versions at the tile edges of
    chip_smoke's XFORM_EDGE_CASES: causal by index at an offset, no mask
    at offsets (ALiBi on |distance|), segments and explicit positions
    causal or not (ALiBi on their distance, from a tile's position step
    or in the masked body), shuffled positions, dead rows (0, NEG_INF)
    and unseen keys (dk = dv = 0), GQA groups 1 to 4, both head dims,
    caps of 2 to 5 that bend the logits on every build; every launch
    counted as an XFORM launch; B3 bitwise the same twice
    (``chip_smoke.xform_case_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    xform_case_check(torch, XFORM_EDGE_CASES[case], seed=case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(BAND_EDGE_CASES)))
def test_cuda_band_kernels_match_plain_versions(case):
    """B1, B2 and B3a/B3b with a window and/or dropout (their BAND
    instantiations) against their plain versions at the tile edges of
    chip_smoke's BAND_EDGE_CASES (``band_case_check``, phase 18 (a)):
    causal windows on and beside the tiles' edges, non-causal (left,
    right) windows that leave whole tiles out on either side, windows
    with softcap and ALiBi, dropout with and without segments and on
    explicit positions, windows on explicit positions, dead rows (0,
    NEG_INF, dq = 0) and unseen keys (dk = dv = 0); every launch counted
    as a BAND launch; B3 bitwise the same twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    band_case_check(torch, case)


@pytest.mark.cuda
def test_cuda_band_keep_mask_is_the_plain_one_bitwise():
    """The kernels' dropout keep mask bit for bit against the plain one:
    B1 with v the identity (q = 0, so every kept p is 1/Skv) gives out = 0
    exactly where a key was dropped; B2 and B3b with dout the identity give
    the same pattern in dv; over kv offsets up to and past 2^31, heads
    with a head offset, batch 2, segments, explicit positions
    (chip_smoke.band_keep_checks, phase 18 (b))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    failed = [what for what, ok in band_keep_checks(torch) if not ok]
    assert not failed, failed


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [4, 9, 16])
def test_cuda_verify_row_groups_match_plain(tq):
    """The speculative verify's B5 at G = 4 (32/8 heads): Tq rows with
    new_counts, one launch whose grid takes row groups of 16 rows past 16
    rows a kv head, against the plain version over all rows at once (a
    dead lane, lanes whose counts end before, inside and after a row
    group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(tq)
    b, pps, ps = 4, 8, 64
    pages = [torch.randn((b * pps, 8, ps, 128), generator=g,
                         device=dev).to(torch.bfloat16) for _ in range(2)]
    tables = torch.randperm(b * pps, generator=g, device=dev).reshape(
        b, pps).to(torch.int32)
    cache = tpaged.PagedKVCache(pages[0], pages[1], tables, torch.tensor(
        [300, 0, 512, 45], dtype=torch.int32, device=dev))
    counts = torch.tensor([tq, 0, max(1, tq // 2), min(tq, 5)],
                          dtype=torch.int32, device=dev)
    q = torch.randn((b, 32, tq, 128), generator=g,
                    device=dev).to(torch.bfloat16)
    before = paged_decode_cuda.launches
    out, lse = tpaged.paged_decode_attention(q, cache, 0.088,
                                             new_counts=counts)
    assert paged_decode_cuda.launches - before == 1
    ref_out, ref_lse = tpaged._plain_paged_decode(q, cache, 0.088, None,
                                                  counts)
    assert float((out - ref_out).abs().max()) <= B5_TOL
    assert float((lse - ref_lse).abs().max()) <= B5_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c,p_len", [(320, 1280), (192, 3840), (512, 0)])
def test_cuda_chunk_b1_skips_tiles_past_the_chunk(c, p_len):
    """A chunked prefill's B1: C rows (not always a multiple of the
    128-row q tile) causal at offset p_len over 4096 gathered keys,
    against the plain version, and bit for bit itself with the keys and
    values past the chunk's last kv tile set to NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import (KV_TILE,
                                                              flash_fwd_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(c)
    q = torch.randn((1, 32, c, 128), generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, 8, 4096, 128), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    mask = MaskArgs(causal=True, offset=p_len)
    out, lse = flash_fwd_cuda(q, k, v, 128**-0.5, mask)
    ref_out, ref_lse = naive_block_fwd(q, k, v, 128**-0.5, mask)
    assert float((out - ref_out).abs().max()) <= B1_OUT_TOL
    assert rel_err_rows(out, ref_out) <= RING_OUT_REL_TOL
    assert float((lse - ref_lse).abs().max()) <= B1_LSE_TOL
    end = -(-(p_len + c) // KV_TILE) * KV_TILE
    k[:, :, end:] = float("nan")
    v[:, :, end:] = float("nan")
    out2, lse2 = flash_fwd_cuda(q, k, v, 128**-0.5, mask)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(D256_EDGE_CASES)))
def test_cuda_head_dim_256_kernels_match_plain_versions(case):
    """B1, B2 and B3a/B3b at head_dim 256 (Gemma), mask-free and
    segmented, at their tiles' edges (``chip_smoke.D256_EDGE_CASES``)
    against their plain versions, both backward modes, at the head_dim
    128 limits (``chip_smoke.d256_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    d256_case_check(torch, D256_EDGE_CASES[case], seed=case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(D256_XFORM_EDGE_CASES)))
def test_cuda_head_dim_256_xform_kernels_match_plain_versions(case):
    """B1, B2 and B3a/B3b with softcap and/or ALiBi at head_dim 256 at the
    tile edges of ``chip_smoke.D256_XFORM_EDGE_CASES`` against their plain
    versions (``chip_smoke.xform_case_check``: the XFORM edge cases'
    limits, caps of 2 to 5 that bend the logits, dead rows, unseen keys,
    B3 bitwise the same twice, every launch an XFORM launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    xform_case_check(torch, D256_XFORM_EDGE_CASES[case], seed=case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(D256_BAND_EDGE_CASES)))
def test_cuda_head_dim_256_band_kernels_match_plain_versions(case):
    """B1, B2 and B3a/B3b with a window and/or dropout at head_dim 256 at
    the tile edges of ``chip_smoke.D256_BAND_EDGE_CASES``
    (``chip_smoke.band_case_check``), Gemma 2's window 4096 with softcap
    50 among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    band_case_check(torch, case, D256_BAND_EDGE_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap, window", [(0.0, (-1, -1)),
                                             (20.0, (16, 0))])
def test_cuda_head_dim_256_long_packing_matches_plain_version(softcap,
                                                              window):
    """``flash_attn_varlen_func`` at head_dim 256 on 3840 sequences of 64
    tokens: 3840 q tiles, whose segment classes B1 and B3a/B3b (past
    ``FUSED_MAX_KV_BYTES``) keep in shared memory beside their tiles,
    causal alone and with a window and softcap (the BAND ALL build). Out
    and the gradients of the first, a middle and the last sequence against
    the plain version on that sequence alone, within B1_OUT_TOL and
    BWD_REL_TOL of their max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.api import flash_attn_varlen_func

    n, seq, d = 3840, 64, 256
    gen = torch.Generator().manual_seed(11)
    q, k, v, dout = (torch.randn(n * seq, 1, d, generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, softcap=softcap, window_size=window)
    dev = [t.cuda().requires_grad_() for t in (q, k, v)]
    out = flash_attn_varlen_func(*dev, list(range(0, n * seq + 1, seq)), **kw)
    got = (out, *torch.autograd.grad(out, dev, dout.cuda()))
    for i in (0, n // 2, n - 1):
        rows = slice(seq * i, seq * (i + 1))
        cpu = [t[rows].float().requires_grad_() for t in (q, k, v)]
        ref = flash_attn_varlen_func(*cpu, [0, seq], **kw)
        want = (ref, *torch.autograd.grad(ref, cpu, dout[rows].float()))
        for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                                   (B1_OUT_TOL,) + (BWD_REL_TOL,) * 3):
            err = float((g[rows].float().cpu() - w).abs().max())
            assert err <= tol * float(w.abs().max()), (i, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(D256_RING_CASES)))
def test_cuda_head_dim_256_fused_ring_matches_plain_versions(case):
    """B7 step by step and B8 over a rank's steps at head_dim 256, with
    and without softcap and ALiBi, at the tile edges of
    ``chip_smoke.D256_RING_CASES`` (``chip_smoke.d256_ring_case_check``:
    out within RING_OUT_REL_TOL of max|plain| after every step, lse
    within B1_LSE_TOL, dq, dk, dv within BWD_REL_TOL, dk and dv the same
    bits twice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    d256_ring_case_check(torch, D256_RING_CASES[case], seed=case)


@pytest.mark.cuda
def test_cuda_head_dim_256_forward_catches_up_with_growing_maxes():
    """B1 and B7 at head_dim 256 on logits that grow along the sequence,
    so that a row's running max falls behind by more than the loop lets it
    and O is rescaled in late tiles (``chip_smoke.d256_growth_check``: B1
    causal, not, with softcap and with ALiBi, B7 over a ring of 3 steps
    with and without softcap, against the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    d256_growth_check(torch)


@pytest.mark.cuda
def test_cuda_timed_and_trace_timing():
    """``utils.timing.timed`` and ``utils.trace_timing`` on a chain of
    matrix products on the card: a positive per-call time, device time
    read from the profiler's trace, busy time at most the summed time of
    the same trace's events (two traces of the chain differ by their
    noise: busy time read from one against summed time read from another
    failed by 2e-8 s), and, in one trace, busy time between its longest
    event and the span from its first event's start to its last's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import shutil

    from ring_flash_attn_tpu_torch.utils.timing import timed
    from ring_flash_attn_tpu_torch.utils.trace_timing import (
        _device_events, _traced, parse_device_busy, trace_device_busy,
        trace_device_time)

    x0 = torch.randn(1024, 1024, device="cuda") / 32

    def step(x):
        return torch.tanh(x @ x)

    assert 0 < timed(step, x0, n=10, n0=2) < 1.0
    dev_s, by_name = trace_device_time(step, x0, n_iters=4)
    assert dev_s > 0 and by_name
    busy_s, busy_by_name = trace_device_busy(step, x0, n_iters=4)
    summed_s = sum(busy_by_name.values())
    assert 0 < busy_s <= summed_s * (1 + 1e-6)
    logdir = _traced(step, x0, 4)
    try:
        busy_us = parse_device_busy(logdir) * 1e6
        events = list(_device_events(logdir))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    assert len({ev[2] for ev in events}) == 1
    longest_us = max(end - start for *_, start, end in events)
    span_us = max(ev[4] for ev in events) - min(ev[3] for ev in events)
    assert longest_us * (1 - 1e-6) <= busy_us <= span_us * (1 + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B4", "B5", "B6"])
@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_cuda_decode_head_dims_and_row_groups(case, kernel):
    """B4, B5 and B6 at head dims 64 and 256 and past the rows one block
    serves (chip_smoke.DECODE_CASES: Llama-3.2-1B, Falcon-7B's 71/1 heads,
    Gemma-7B and Gemma-2B, StarCoder's 48/1, speculative rows with
    new_counts, softcap, a dead lane, pages of 16 to 256 tokens) against
    their plain versions, twice, the same bits
    (chip_smoke.decode_case_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    decode_case_check(torch, DECODE_CASES[case], kernel, seed=case)


@pytest.mark.cuda
@pytest.mark.parametrize("d, rows", [(64, 20), (128, 12), (256, 40)])
def test_cuda_decode_refuses_other_row_groups(d, rows):
    """The decode libraries lay a split's partials out by their own
    max_rows(D) (csrc/quant_decode.cuh::dispatch_rows, which B4, B5 and B6
    share) and refuse a launch whose rows a row group, by which the caller
    sized its workspace (ops/quant_decode_cuda.py::row_groups), differ:
    B5's entry point returns cudaErrorInvalidValue (1) and launches
    nothing; with the launcher's rows it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from ring_flash_attn_tpu_torch.ops import paged_decode_cuda as b5
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import row_groups

    dev = torch.device("cuda")
    q = torch.ones((1, rows, 1, d), dtype=torch.bfloat16, device=dev)
    pages = torch.ones((1, 1, 64, d), dtype=torch.bfloat16, device=dev)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lens = torch.tensor([64], dtype=torch.int32, device=dev)
    out = torch.zeros((1, rows, 1, d), dtype=torch.float32, device=dev)
    lse = torch.zeros((1, rows, 1), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, rp = row_groups(rows, d)

    def launch(rp):  # B=1, Hq=rows, Hkv=1, Tq=1, one page, one split
        return b5._lib().rfa_paged_decode(
            q.data_ptr(), 1, pages.data_ptr(), pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), None, out.data_ptr(),
            lse.data_ptr(), None, None, None, 1, rows, 1, 1, d, 1, 64, 1, 1,
            rp, 0.1, 0.0, stream)

    for other in (rp - 1, rp + 1, 2 * rp):
        assert launch(other) == 1
    assert float(out.abs().max()) == 0.0  # nothing ran
    assert launch(rp) == 0
    torch.cuda.synchronize()
    # every key and value is 1: each row's output is 1
    assert float((out - 1.0).abs().max()) <= B5_TOL
