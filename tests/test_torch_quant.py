"""The port's quantized-KV ops against the JAX package's on identical
numpy inputs (CPU, where the port runs the plain version of kernel B4):
quantization bit for bit, the cache writers, decode attention against
JAX's XLA path and its Pallas kernel in interpret mode, and the partial
merge."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.ops import merge as jmerge
from ring_flash_attn_tpu.ops import quant as jquant
from ring_flash_attn_tpu_torch.ops import merge as tmerge
from ring_flash_attn_tpu_torch.ops import quant as tquant

QDTYPES = ["int8", "fp8_e4m3", "fp8_e5m2"]
NP_FP8 = {"fp8_e4m3": ml_dtypes.float8_e4m3fn, "fp8_e5m2": ml_dtypes.float8_e5m2}
XLA_TOL = 1e-4  # fp32 on both sides, the same formula
# JAX's Pallas kernel rounds q*scale and p*v_scale to bf16 for the MXU; the
# JAX package's own tests hold it to its XLA path within this
PALLAS_TOL = 5e-3


def _bits(x):
    """Quantized values as integers: numpy int8, or the bit patterns of fp8
    (a JAX array through ml_dtypes, a torch tensor through a uint8 view)."""
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.float32 else tquant.as_bytes(x)).numpy()
    a = np.asarray(x)
    return a if a.dtype in (np.int8, np.float32) else a.view(np.uint8)


def _to_torch(jcache, qdtype):
    return tquant.quantized_kv_from_jax(
        _bits(jcache.k_q), np.asarray(jcache.k_scale), _bits(jcache.v_q),
        np.asarray(jcache.v_scale), qdtype=qdtype, device="cpu")


def _assert_same_cache(tcache, jcache):
    for t, j in zip(tcache, jcache):
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_quantize_tensor_is_bit_identical(qdtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 70, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # amax == 0 -> scale 1
    x[0, 0, 1, :7] = [0.5, 1.5, 2.5, -0.5, -1.5, 1e-9, -1e-9]
    jq, js = jquant.quantize_tensor(jnp.asarray(x), qdtype)
    tq, ts = tquant.quantize_tensor(torch.from_numpy(x), qdtype)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    # the row maximum lands on the format's largest value
    _, qmax = jquant._QDTYPES[qdtype]
    assert float(tq.float().abs().max()) == qmax


@pytest.mark.parametrize("qdtype", QDTYPES[1:])
def test_fp8_cast_matches_ml_dtypes(qdtype):
    """torch's fp8 cast against ml_dtypes' on one numpy input: values that
    round up to the format's maximum, ties, subnormals."""
    _, qmax = jquant._QDTYPES[qdtype]
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-qmax, qmax, 4000),
        qmax * (1 - rng.uniform(0, 0.07, 2000)),  # rounds up to the maximum
        rng.standard_normal(2000) * 1e-2,
        rng.standard_normal(2000) * 1e-5,  # subnormal range
        [qmax, -qmax, 0.0, qmax * (1 + 2**-23)],
    ]).astype(np.float32)
    want = x.astype(NP_FP8[qdtype]).view(np.uint8)
    got = _bits(torch.from_numpy(x).to(tquant._QDTYPES[qdtype][0]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_make_and_update_cache_equal(qdtype):
    """Successive updates, one with an index past the end that both packages
    clamp so that the update fits."""
    rng = np.random.default_rng(2)
    b, hkv, s, d = 2, 2, 40, 64
    jc = jquant.make_cache(b, hkv, s, d, qdtype)
    tc = tquant.make_cache(b, hkv, s, d, qdtype, device="cpu")
    _assert_same_cache(tc, jc)
    ptrs = {x.data_ptr() for x in tc}
    assert len(ptrs) == 4  # written in place: no aliased buffers
    for t_new, index in ((8, 0), (1, 8), (5, 38), (3, 17), (2, 40)):
        k = rng.standard_normal((b, hkv, t_new, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, t_new, d)).astype(np.float32)
        jc = jquant.update_cache(jc, jnp.asarray(k), jnp.asarray(v), index)
        out = tquant.update_cache(tc, torch.from_numpy(k),
                                  torch.from_numpy(v), index)
        assert out is tc
        _assert_same_cache(tc, jc)
    # a tensor index writes the same positions as the int
    tc2 = tquant.make_cache(b, hkv, s, d, qdtype, device="cpu")
    tc3 = tquant.make_cache(b, hkv, s, d, qdtype, device="cpu")
    tquant.update_cache(tc2, torch.from_numpy(k), torch.from_numpy(v), 11)
    tquant.update_cache(tc3, torch.from_numpy(k), torch.from_numpy(v),
                        torch.tensor(11))
    for a, c in zip(tc2, tc3):
        np.testing.assert_array_equal(_bits(a), _bits(c))


def test_from_jax_rejects_wrong_value_type():
    z = np.zeros((1, 1, 4, 8), np.float32)
    with pytest.raises(TypeError):
        tquant.quantized_kv_from_jax(z, z[..., 0], z, z[..., 0],
                                     device="cpu")


# (qdtype, B, Hq, Hkv, Tq, S, length, softcap)
DECODE_CASES = [
    ("int8", 2, 4, 2, 1, 256, 256, None),
    ("int8", 2, 4, 2, 1, 256, 101, None),  # length masking
    ("int8", 1, 4, 4, 1, 128, 77, 12.0),  # softcap, no GQA
    ("int8", 1, 8, 2, 2, 1280, 1000, None),  # S=1280, 8 rows per kv head
    ("int8", 2, 4, 2, 1, 128, 0, None),  # nothing live
    ("fp8_e4m3", 2, 4, 2, 1, 256, 200, None),
    ("fp8_e5m2", 1, 4, 2, 1, 384, 384, 20.0),
]


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_quant_decode_matches_jax(case):
    qdtype, b, hq, hkv, tq, s, length, softcap = DECODE_CASES[case]
    rng = np.random.default_rng(10 + case)
    d = 64
    scale = d**-0.5
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    jc = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), qdtype)
    tc = _to_torch(jc, qdtype)
    _assert_same_cache(tquant.quantize_kv(torch.from_numpy(k),
                                          torch.from_numpy(v), qdtype), jc)
    to, tl = tquant.quant_decode_attention(
        torch.from_numpy(q), tc, length, scale, softcap=softcap)
    assert to.dtype == tl.dtype == torch.float32
    for backend, tol in (("xla", XLA_TOL), ("pallas_interpret", PALLAS_TOL)):
        jo, jl = jquant.quant_decode_attention(
            jnp.asarray(q), jc, length, scale, softcap=softcap,
            backend=backend)
        assert np.abs(to.numpy() - np.asarray(jo)).max() <= tol, backend
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= tol, backend
    if length == 0:
        assert torch.all(to == 0) and torch.all(tl == -1e30)
    # a tensor length, and backend="plain", give the same answer
    to2, tl2 = tquant.quant_decode_attention(
        torch.from_numpy(q), tc, torch.tensor([length], dtype=torch.int32),
        scale, softcap=softcap, backend="plain")
    assert torch.equal(to, to2) and torch.equal(tl, tl2)


def test_quant_decode_takes_any_length_of_cache():
    """S = 100 is no multiple of 128: JAX sends it to its XLA path, the
    port's one function takes it as any other."""
    rng = np.random.default_rng(30)
    k = rng.standard_normal((1, 2, 100, 64)).astype(np.float32)
    v = rng.standard_normal((1, 2, 100, 64)).astype(np.float32)
    q = rng.standard_normal((1, 4, 1, 64)).astype(np.float32)
    jc = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    jo, jl = jquant.quant_decode_attention(jnp.asarray(q), jc, 63, 0.125)
    to, tl = tquant.quant_decode_attention(torch.from_numpy(q),
                                           _to_torch(jc, "int8"), 63, 0.125)
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= XLA_TOL
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= XLA_TOL


@pytest.mark.parametrize("dead", ["none", "a", "b", "both"])
def test_merge_partials_matches_jax(dead):
    rng = np.random.default_rng(40)
    shape = (2, 4, 3)
    oa = rng.standard_normal(shape + (16,)).astype(np.float32)
    ob = rng.standard_normal(shape + (16,)).astype(np.float32)
    la = (rng.standard_normal(shape) * 3).astype(np.float32)
    lb = (rng.standard_normal(shape) * 3).astype(np.float32)
    if dead in ("a", "both"):
        oa[0], la[0] = 0.0, -1e30
    if dead in ("b", "both"):
        ob[0], lb[0] = 0.0, -1e30
    jo, jl = jmerge.merge_partials(*map(jnp.asarray, (oa, la, ob, lb)))
    to, tl = tmerge.merge_partials(*map(torch.from_numpy, (oa, la, ob, lb)))
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1e-6
    # lse spans 1e30 when a side is dead: compare relative to its size
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(to.numpy()).all()
    if dead == "a":
        np.testing.assert_array_equal(to.numpy()[0], ob[0])
    io, il = tmerge.merge_partials(None, None, torch.from_numpy(ob),
                                   torch.from_numpy(lb))
    assert torch.equal(io, torch.from_numpy(ob)) and io.dtype == torch.float32
    assert torch.equal(il, torch.from_numpy(lb))
