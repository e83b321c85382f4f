"""The port's ops (ring_flash_attn_tpu_torch.ops) against the JAX package on
identical numpy inputs, in float32 on the CPU.

On the CPU the port's wrappers run the plain PyTorch versions of kernels
B1 (flash forward), B2/B3a/B3b (flash backward) and B5 (paged decode); the
JAX side runs its XLA path and its Pallas kernels in interpret mode. The
CUDA kernels themselves are held against the same plain versions on the
card (chip_smoke.py and tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.ops import paged as jpaged
from ring_flash_attn_tpu.ops.flash import block_fwd as jax_block_fwd
from ring_flash_attn_tpu.ops.flash import compute_delta as jax_compute_delta
from ring_flash_attn_tpu.ops.flash import (
    flash_attention as jax_flash_attention)
from ring_flash_attn_tpu.ops.mask import MaskArgs as JMask
from ring_flash_attn_tpu.ops.naive import naive_block_bwd as jax_naive_bwd
from ring_flash_attn_tpu.ops.naive import naive_block_fwd as jax_naive_fwd
from ring_flash_attn_tpu.ops.pallas_bwd import pallas_block_bwd
from ring_flash_attn_tpu.ops.pallas_bwd_fused import (
    fused_bwd_supported as jax_fused_bwd_supported)
from ring_flash_attn_tpu_torch.ops import paged as tpaged
from ring_flash_attn_tpu_torch.ops.flash import (
    _kernel_layout, block_bwd, block_fwd, compute_delta, flash_attention)
from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import fused_bwd_supported
from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import tma_layout_error
from ring_flash_attn_tpu_torch.ops.mask import (
    NEG_INF, MaskArgs, check_kernel_supported)
from ring_flash_attn_tpu_torch.ops.naive import (
    naive_block_bwd, naive_block_fwd)

TOL = 1e-5
# the Pallas kernels work in base 2 with scale*log2(e) folded into k and
# rescale blockwise: the same fp32 math in another order
PALLAS_TOL = 1e-4


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol):
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, err


# (B, Hq, Hkv, Sq, Skv, causal, offset): plain causal, prefix-style
# offset with Sq < Skv, GQA non-causal, and a negative offset whose first
# rows see no key at all (dead rows)
FWD_CASES = {
    "causal": (1, 2, 2, 64, 64, True, None),
    "offset_sq_lt_skv": (1, 4, 2, 32, 96, True, 64),
    "gqa_noncausal": (2, 4, 1, 32, 64, False, None),
    "dead_rows": (1, 4, 2, 32, 32, True, -3),
}


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_naive_block_fwd_matches_jax(case, backend):
    b, hq, hkv, sq, skv, causal, offset = FWD_CASES[case]
    d = 16
    q, k, v = (_np((b, hq, sq, d), 0), _np((b, hkv, skv, d), 1),
               _np((b, hkv, skv, d), 2))
    scale = d**-0.5
    jo, jl = jax_block_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale, JMask(causal=causal, offset=offset),
                           backend=backend)
    to, tl = naive_block_fwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), scale,
                             MaskArgs(causal=causal, offset=offset))
    tol = TOL if backend == "xla" else PALLAS_TOL
    _close(to, jo, tol)
    _close(tl, jl, tol)
    if case == "dead_rows":
        assert torch.all(tl[..., :3] == NEG_INF)
        assert torch.all(to[..., :3, :] == 0)


def test_block_fwd_cpu_uses_plain_version_and_narrows():
    q, k, v = (torch.from_numpy(_np((1, 2, 16, 8), s)) for s in range(3))
    mask = MaskArgs(causal=True)
    out, lse = block_fwd(q, k, v, 0.3, mask, out_dtype=torch.bfloat16)
    ref_out, ref_lse = naive_block_fwd(q, k, v, 0.3, mask)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, ref_out.to(torch.bfloat16))
    assert torch.equal(lse, ref_lse)


def test_unported_mask_fields_and_grad_raise():
    """Unported MaskArgs fields raise in block_fwd and block_bwd alike;
    softcap and ALiBi, which the plain versions have since the ring slice,
    raise in the block kernels' own check only; flash_attention,
    forward-only before the training slice, now differentiates."""
    q = torch.zeros((1, 1, 4, 8))
    lse = torch.zeros((1, 1, 4))
    for field in ({"window_left": 2}, {"dropout_p": 0.1},
                  {"q_segids": np.zeros(4)}, {"q_pos": np.zeros(4)}):
        mask = MaskArgs(causal=True, **field)
        with pytest.raises(NotImplementedError):
            block_fwd(q, q, q, 1.0, mask)
        with pytest.raises(NotImplementedError):
            block_bwd(q, q, q, q, lse, lse, 1.0, mask)
        with pytest.raises(NotImplementedError):
            check_kernel_supported(mask)
    for field in ({"softcap": 5.0}, {"alibi_slopes": np.ones(1)}):
        mask = MaskArgs(causal=True, **field)
        with pytest.raises(NotImplementedError):
            check_kernel_supported(mask)
        out, _ = block_fwd(q, q, q, 1.0, mask)  # the plain version has them
        assert torch.isfinite(out).all()
    x = torch.from_numpy(_np((1, 2, 8, 8), 0)).requires_grad_()
    out, lse = flash_attention(x, x, x, 1.0, MaskArgs(causal=True))
    assert out.requires_grad and not lse.requires_grad
    (grad,) = torch.autograd.grad(out.sum(), x)
    assert grad.shape == x.shape and torch.isfinite(grad).all()
    assert float(grad.abs().sum()) > 0


# ---- backward ----

BWD_TOL = 5e-5  # the JAX backward tests' tolerance (tests/test_ops.py)


def _bwd_case(case, d=16):
    """numpy q, k, v, dout and the JAX forward's out, lse and delta."""
    b, hq, hkv, sq, skv, causal, offset = FWD_CASES[case]
    q, k, v = (_np((b, hq, sq, d), 0), _np((b, hkv, skv, d), 1),
               _np((b, hkv, skv, d), 2))
    dout = _np((b, hq, sq, d), 3)
    jmask = JMask(causal=causal, offset=offset)
    out, lse = jax_naive_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             d**-0.5, jmask)
    delta = jax_compute_delta(jnp.asarray(dout), out)
    arrays = dict(q=q, k=k, v=v, dout=dout, out=np.asarray(out),
                  lse=np.asarray(lse), delta=np.asarray(delta))
    return arrays, jmask, MaskArgs(causal=causal, offset=offset), d**-0.5


def _blk(n):
    return 64 if n % 64 == 0 else 32


@pytest.mark.parametrize("backend", ["xla", "pallas_fused", "pallas_split"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_naive_block_bwd_matches_jax(case, backend):
    """The plain version of B2/B3a/B3b against JAX's naive_block_bwd and
    against its Pallas kernels in interpret mode (fused and split)."""
    a, jmask, mask, scale = _bwd_case(case)
    j = {n: jnp.asarray(x) for n, x in a.items()}
    jargs = (j["dout"], j["q"], j["k"], j["v"], j["lse"], j["delta"], scale,
             jmask)
    if backend == "xla":
        want = jax_naive_bwd(*jargs)
    else:
        want = pallas_block_bwd(
            *jargs, interpret=True, blk_q=_blk(a["q"].shape[2]),
            blk_kv=_blk(a["k"].shape[2]), fused=backend == "pallas_fused")
    t = {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    got = naive_block_bwd(t["dout"], t["q"], t["k"], t["v"], t["lse"],
                          t["delta"], scale, mask)
    for x, w in zip(got, want):
        _close(x, w, BWD_TOL)
    if case == "dead_rows":
        assert torch.all(got[0][..., :3, :] == 0)


def test_block_bwd_delta_none_equals_delta_given():
    a, _, mask, scale = _bwd_case("offset_sq_lt_skv")
    t = {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    args = (t["dout"], t["q"], t["k"], t["v"], t["lse"])
    given = block_bwd(*args, t["delta"], scale, mask)
    folded = block_bwd(*args, None, scale, mask, out=t["out"],
                       dq_dtype=torch.bfloat16, dkv_dtype=torch.bfloat16)
    _close(compute_delta(t["dout"], t["out"]), a["delta"], TOL)
    for x, y in zip(folded, given):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y.to(torch.bfloat16))
    with pytest.raises(ValueError, match="requires the forward out"):
        block_bwd(*args, None, scale, mask)


@pytest.mark.parametrize("skv,d", [(8192, 128), (64 * 1024, 128),
                                   (32768, 128), (32769, 128), (65536, 64),
                                   (65537, 64)])
def test_fused_bwd_supported_matches_jax(skv, d):
    """Same selector, same limit: the same shapes pick B2 or B3 in both
    packages (tests/test_ops.py::test_bwd_fused_gate_long_kv)."""
    assert fused_bwd_supported(skv, d) == jax_fused_bwd_supported(skv, d)


def _bf16(*shape):
    n = int(np.prod(shape))
    return (torch.arange(n, dtype=torch.float32) % 251).to(
        torch.bfloat16).reshape(shape)


# (view, whether the kv-major backward's TMA maps read it in place): the
# maps need a contiguous last dim, a 16-byte aligned base and, along dims
# of more than one element, positive strides of multiples of 16 bytes
TMA_LAYOUTS = {
    "contiguous": (lambda: _bf16(2, 4, 64, 128), True),
    "(B, S, H, D) transposed": (
        lambda: _bf16(2, 64, 4, 128).transpose(1, 2), True),
    "half shard along S": (lambda: _bf16(2, 4, 128, 64)[:, :, 64:], True),
    "odd stride on a dim of one": (
        lambda: _bf16(40000).as_strided((1, 4, 64, 128), (3, 8192, 128, 1)),
        True),
    "head expanded": (
        lambda: _bf16(2, 1, 64, 128).expand(2, 4, 64, 128), False),
    "rows of 136 bytes": (lambda: _bf16(2, 4, 64, 68)[..., :64], False),
    "base 2 bytes off": (
        lambda: _bf16(65536 + 8)[1:65537].view(2, 4, 64, 128), False),
    "last dim strided": (lambda: _bf16(2, 4, 64, 256)[..., ::2], False),
}


@pytest.mark.parametrize("name", sorted(TMA_LAYOUTS))
def test_tma_layout_error_on_views(name):
    make, readable = TMA_LAYOUTS[name]
    err = tma_layout_error(make())
    assert (err is None) == readable, err


@pytest.mark.parametrize("name", sorted(TMA_LAYOUTS))
def test_kernel_layout_gives_what_the_tma_maps_read(name):
    """_kernel_layout keeps a view the maps read (and every kernel takes)
    and copies any other into a contiguous tensor of the same values."""
    x = TMA_LAYOUTS[name][0]()
    y = _kernel_layout(x)
    assert tma_layout_error(y) is None
    assert torch.equal(y, x)
    kept = y.data_ptr() == x.data_ptr() and y.stride() == x.stride()
    assert kept == TMA_LAYOUTS[name][1]


@pytest.mark.parametrize("case", ["causal", "gqa_noncausal", "dead_rows"])
def test_flash_attention_grad_matches_jax(case):
    """torch.autograd.grad through the port's flash_attention against
    jax.grad of the JAX flash_attention (XLA backend)."""
    a, jmask, mask, scale = _bwd_case(case)

    def jloss(q, k, v):
        o, _ = jax_flash_attention(q, k, v, scale, jmask, "xla")
        return jnp.sum(o * jnp.asarray(a["dout"]))

    want = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(a[n]) for n in "qkv"))
    qkv = [torch.from_numpy(a[n].copy()).requires_grad_() for n in "qkv"]
    out, _ = flash_attention(*qkv, scale, mask)
    got = torch.autograd.grad((out * torch.from_numpy(a["dout"])).sum(), qkv)
    _close(out.detach(), a["out"], TOL)
    for x, w in zip(got, want):
        _close(x, w, BWD_TOL)


# ---- paged cache ----

B, HQ, HKV, D, PS, NPS = 3, 4, 2, 16, 8, 4
NUM_PAGES = B * NPS + 2


def _caches(lens, tables, seed=0):
    """A JAX and a torch cache holding the same pages."""
    kp = _np((NUM_PAGES, HKV, PS, D), seed)
    vp = _np((NUM_PAGES, HKV, PS, D), seed + 1)
    tables = np.asarray(tables, np.int32)
    lens = np.asarray(lens, np.int32)
    j = jpaged.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(tables), jnp.asarray(lens))
    t = tpaged.PagedKVCache(torch.from_numpy(kp.copy()),
                            torch.from_numpy(vp.copy()),
                            torch.from_numpy(tables), torch.from_numpy(lens))
    return j, t


def _tables():
    perm = np.random.default_rng(5).permutation(NUM_PAGES)[:B * NPS]
    return perm.reshape(B, NPS).astype(np.int32)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("mode", ["plain", "softcap", "new_counts"])
def test_plain_paged_decode_matches_jax(mode, backend):
    # lane 1 is dead (seq_len 0); lane 2 ends mid-page
    lens = [NPS * PS, 0, 13]
    jc, tc = _caches(lens, _tables())
    tq = 3 if mode == "new_counts" else 1
    q = _np((B, HQ, tq, D), 7)
    softcap = 4.0 if mode == "softcap" else None
    counts = np.asarray([3, 2, 2], np.int32) if mode == "new_counts" else None
    scale = D**-0.5
    jo, jl = jpaged.paged_decode_attention(
        jnp.asarray(q), jc, scale, softcap=softcap, backend=backend,
        new_counts=None if counts is None else jnp.asarray(counts))
    to, tl = tpaged.paged_decode_attention(
        torch.from_numpy(q), tc, scale, softcap=softcap,
        new_counts=None if counts is None else torch.from_numpy(counts))
    # the Pallas kernel casts q, K and p to bf16 for its matmuls
    tol = TOL if backend == "xla" else 1e-2
    _close(to, jo, tol)
    _close(tl, jl, tol)
    assert torch.all(tl[1] == NEG_INF) and torch.all(to[1] == 0)


def _pools_equal(tc, jc):
    _close(tc.k_pages, jc.k_pages, 0.0)
    _close(tc.v_pages, jc.v_pages, 0.0)


def test_paged_prefill_drops_out_of_range_pages():
    tables = _tables()
    tables[1, 2:] = NUM_PAGES  # a padded chunk tail: these writes drop
    jc, tc = _caches([0, 0, 0], tables)
    k, v = _np((B, HKV, NPS * PS, D), 3), _np((B, HKV, NPS * PS, D), 4)
    lens = np.asarray([30, 11, 32], np.int32)
    jc = jpaged.paged_prefill(jc, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens))
    tc = tpaged.paged_prefill(tc, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(lens))
    _pools_equal(tc, jc)
    assert tc.seq_lens.tolist() == lens.tolist()
    kd, vd = tpaged.paged_gather_dense(tc)
    jkd, jvd = jpaged.paged_gather_dense(jc)
    _close(kd, jkd, 0.0)
    _close(vd, jvd, 0.0)


def test_paged_append_drops_masked_and_full_rows():
    tables = _tables()
    tables[1] = 0  # a dead lane's zeroed table aliases page 0
    tables[0, 0] = 0  # ... which lane 0 owns and writes this step
    # lane 0 writes slot 0 of page 0; lane 1 (masked) would alias the same
    # slot; lane 2 is at capacity and must not write
    lens = [0, 0, NPS * PS]
    jc, tc = _caches(lens, tables)
    kn, vn = _np((B, HKV, 1, D), 8), _np((B, HKV, 1, D), 9)
    live = np.asarray([True, False, True])
    jc = jpaged.paged_append(jc, jnp.asarray(kn), jnp.asarray(vn),
                             mask=jnp.asarray(live))
    tc = tpaged.paged_append(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                             mask=torch.from_numpy(live))
    _pools_equal(tc, jc)
    _close(tc.k_pages[0, :, 0], kn[0, :, 0], 0.0)
    assert tc.seq_lens.tolist() == np.asarray(jc.seq_lens).tolist() == [
        1, 0, NPS * PS]


def test_copy_pages_matches_jax():
    jc, tc = _caches([5, 6, 7], _tables())
    src, dst = np.asarray([1, 4, 1]), np.asarray([NUM_PAGES - 1, 0, 3])
    jc = jpaged.copy_pages(jc, src, dst)
    tc = tpaged.copy_pages(tc, src, dst)
    _pools_equal(tc, jc)
