"""The port's quantized paged cache against the JAX package's on identical
numpy inputs (CPU, where the port runs the plain version of kernel B6):
the writers bit for bit, decode attention against JAX's Pallas kernel in
interpret mode (the function both kernels compute: int8 pages with q
quantized per row) and against its XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.ops import paged as jpaged
from ring_flash_attn_tpu_torch.ops import paged as tpaged
from ring_flash_attn_tpu_torch.ops.quant import as_bytes

B, HQ, HKV, D, PS, PPS = 3, 4, 2, 64, 128, 3
NUM_PAGES = B * PPS + 2
SCALE = D**-0.5
# the bar the JAX package's own tests set between its kernel and its XLA
# path (bf16 MXU operands, and for int8 the q quantization)
TOL = 5e-3


def _bits(x):
    if isinstance(x, torch.Tensor):
        return as_bytes(x).numpy() if x.dtype not in (
            torch.float32, torch.int32) else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 \
        else a


def _to_torch(jc, qdtype):
    return tpaged.quant_paged_cache_from_jax(
        *(_bits(x) for x in jc), qdtype=qdtype, device="cpu")


def _assert_same(tc, jc):
    for name, t, j in zip(jc._fields, tc, jc):
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)


def _tables(seed):
    perm = np.random.default_rng(seed).permutation(NUM_PAGES)[:B * PPS]
    return perm.reshape(B, PPS).astype(np.int32)


def _filled(qdtype, lens, seed=0, s=PPS * PS):
    """The same dense k/v prefilled into a JAX cache and a port cache over
    the same shuffled block tables."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, HKV, s, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, s, D)).astype(np.float32)
    tables = _tables(seed)
    jc = jpaged.paged_quant_init(B, HKV, NUM_PAGES, PS, PPS, D, qdtype=qdtype,
                                 block_tables=tables)
    tc = tpaged.paged_quant_init(B, HKV, NUM_PAGES, PS, PPS, D, qdtype=qdtype,
                                 block_tables=tables, device="cpu")
    _assert_same(tc, jc)
    jc = jpaged.paged_quant_prefill(jc, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens, jnp.int32))
    tc = tpaged.paged_quant_prefill(tc, torch.from_numpy(k),
                                    torch.from_numpy(v), lens)
    return jc, tc


@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_quant_prefill_is_bit_identical(qdtype):
    jc, tc = _filled(qdtype, [300, 0, 384])
    _assert_same(tc, jc)
    assert len({x.data_ptr() for x in tc[:4]}) == 4
    # a shorter prompt fills only its first pages
    jc, tc = _filled(qdtype, [100, 128, 7], seed=1, s=PS)
    _assert_same(tc, jc)


def test_paged_quant_init_default_tables():
    jc = jpaged.paged_quant_init(2, HKV, 8, 16, 3, D)
    tc = tpaged.paged_quant_init(2, HKV, 8, 16, 3, D, device="cpu")
    _assert_same(tc, jc)
    with pytest.raises(ValueError):
        tpaged.paged_quant_init(3, HKV, 8, 16, 3, D, device="cpu")


@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3"])
def test_paged_quant_append_is_bit_identical(qdtype):
    """Appends across a page boundary, into a lane at capacity (dropped,
    pinned) and with a mask (a dead lane writes nothing)."""
    lens = [PS - 2, PPS * PS - 1, 0]
    jc, tc = _filled(qdtype, lens)
    rng = np.random.default_rng(5)
    for step in range(4):
        k = rng.standard_normal((B, HKV, 1, D)).astype(np.float32)
        v = rng.standard_normal((B, HKV, 1, D)).astype(np.float32)
        mask = None if step == 0 else np.array([True, True, step % 2 == 0])
        jc = jpaged.paged_quant_append(
            jc, jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask))
        tc = tpaged.paged_quant_append(
            tc, torch.from_numpy(k), torch.from_numpy(v),
            None if mask is None else torch.from_numpy(mask))
        _assert_same(tc, jc)
    assert tc.seq_lens.tolist() == [PS + 2, PPS * PS, 2]


# (qdtype, lens, Tq, softcap). Lanes of a hundred tokens or more: the JAX
# kernel rounds p * v_scale to bf16 (2**-9 relative), which only an average
# over many tokens brings under the absolute bar; short lanes are held
# against the XLA path below.
DECODE_CASES = [
    ("int8", [300, 129, 384], 1, None),
    ("int8", [150, 384, 128], 2, 20.0),
    ("fp8_e4m3", [300, 129, 384], 1, None),
    ("fp8_e4m3", [177, 256, 140], 2, 15.0),
    ("fp8_e5m2", [300, 129, 384], 1, None),
]


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_paged_quant_decode_matches_jax(case):
    qdtype, lens, tq, softcap = DECODE_CASES[case]
    jc, tc = _filled(qdtype, lens, seed=case)
    q = np.random.default_rng(20 + case).standard_normal(
        (B, HQ, tq, D)).astype(np.float32)
    to, tl = tpaged.paged_quant_decode_attention(
        torch.from_numpy(q), tc, SCALE, softcap=softcap)
    assert to.dtype == tl.dtype == torch.float32
    for backend in ("pallas_interpret", "xla"):
        jo, jl = jpaged.paged_quant_decode_attention(
            jnp.asarray(q), jc, SCALE, softcap=softcap, backend=backend)
        assert np.abs(to.numpy() - np.asarray(jo)).max() <= TOL, backend
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= TOL, backend
    # the port reads the JAX cache to the same answer as its own
    to2, tl2 = tpaged.paged_quant_decode_attention(
        torch.from_numpy(q), _to_torch(jc, qdtype), SCALE, softcap=softcap,
        backend="plain")
    assert torch.equal(to, to2) and torch.equal(tl, tl2)


@pytest.mark.parametrize("qdtype", ["fp8_e4m3", "fp8_e5m2"])
def test_paged_quant_decode_short_lanes_match_jax_xla(qdtype):
    """fp8 pages, lanes of 1, 5 and 77 tokens: the same fp32 formula as
    JAX's XLA path (no q quantization on fp8 pages), so 1e-4."""
    jc, tc = _filled(qdtype, [1, 77, 5], seed=7)
    q = np.random.default_rng(8).standard_normal(
        (B, HQ, 2, D)).astype(np.float32)
    to, tl = tpaged.paged_quant_decode_attention(torch.from_numpy(q), tc,
                                                 SCALE, softcap=15.0)
    jo, jl = jpaged.paged_quant_decode_attention(
        jnp.asarray(q), jc, SCALE, softcap=15.0, backend="xla")
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1e-4
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-4


@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3"])
def test_paged_quant_decode_dead_lane_takes_the_kernels_answer(qdtype):
    """A lane with no token: JAX's kernel gives (0, NEG_INF), its XLA path
    the mean of V; the port's plain version takes the kernel's answer."""
    jc, tc = _filled(qdtype, [200, 0, 384])
    q = np.random.default_rng(3).standard_normal(
        (B, HQ, 1, D)).astype(np.float32)
    to, tl = tpaged.paged_quant_decode_attention(torch.from_numpy(q), tc,
                                                 SCALE)
    jo, jl = jpaged.paged_quant_decode_attention(
        jnp.asarray(q), jc, SCALE, backend="pallas_interpret")
    assert torch.all(to[1] == 0) and torch.all(tl[1] == -1e30)
    assert np.all(np.asarray(jo)[1] == 0) and np.all(np.asarray(jl)[1] == -1e30)
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= TOL
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= TOL


def test_int8_plain_version_quantizes_q_as_the_kernel_does():
    """On int8 pages the logits come from q rounded to int8 per row: the
    plain version differs from a float-q reference by that rounding, and
    agrees with it once q is exactly representable."""
    _, tc = _filled("int8", [300, 129, 384])
    rng = np.random.default_rng(4)
    q_int = rng.integers(-127, 128, size=(B, HQ, 1, D)).astype(np.float32)
    q_int[..., 0] = 127.0  # row maximum 127: the row scale is SCALE exactly
    k = as_bytes(tc.k_pages)[tc.block_tables.long()].float()  # (B,n,H,ps,D)
    ks = tc.k_scales[tc.block_tables.long()][:, :, :, 0]
    k = (k * ks[..., None]).transpose(1, 2).reshape(B, HKV, PPS * PS, D)
    _, tl = tpaged.paged_quant_decode_attention(torch.from_numpy(q_int), tc,
                                                SCALE)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk",
        torch.from_numpy(q_int).reshape(B, HKV, HQ // HKV, D), k) * SCALE
    valid = torch.arange(PPS * PS)[None, :] < tc.seq_lens[:, None]
    ref = torch.logsumexp(
        logits.masked_fill(~valid[:, None, None, :], float("-inf")), dim=-1)
    np.testing.assert_allclose(tl.reshape(B, HKV, -1).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-4)
