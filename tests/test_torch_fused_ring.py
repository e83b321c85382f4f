"""The port's fused ring attention against the JAX package's on identical
numpy inputs, on the CPU, at the JAX test's own shape
(``tests/test_fused_ring.py``).

The JAX function runs its Pallas kernels in interpret mode under
``shard_map`` over 8 (or 4) virtual CPU devices; the port runs one gloo
process per rank (``torch_dist_workers.py``), where its step functions take
the plain versions of kernels B7 and B8 because the tensors lie on the CPU.
The one-process W-rank ring functions that ``chip_smoke.py`` holds the
kernels with on the card are themselves held against full attention here.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import chip_smoke
import torch_dist_workers as workers
from oracle import full_attention, full_attention_lse
from ring_flash_attn_tpu.ops.flash import compute_delta as jax_compute_delta
from ring_flash_attn_tpu.ops.mask import MaskArgs as JMask
from ring_flash_attn_tpu.ops.naive import naive_block_bwd as jax_naive_bwd
from ring_flash_attn_tpu.ops.naive import naive_block_fwd as jax_naive_fwd
from ring_flash_attn_tpu.parallel import fused_ring as jfused
from ring_flash_attn_tpu_torch.parallel import fused_ring as tfused
from ring_flash_attn_tpu_torch.parallel.fused_ring_cuda import (
    fused_ring_bwd_cuda, fused_ring_fwd_cuda)

B, HQ, HKV, S, D = 1, 4, 2, 512, 64  # tests/test_fused_ring.py:21-23
SCALE = D**-0.5
SPEC4, SPEC3 = P(None, None, "sp", None), P(None, None, "sp")
SLOPES = np.array([2.0 ** (-8.0 * (i + 1) / HQ) for i in range(HQ)],
                  np.float32)

# name: (world, dtype, fused_ring_attention's keywords, out/lse tolerance,
# gradient tolerance or None for a forward-only case): the JAX test's
# cases and tolerances
CASES = {
    "causal fused": (8, "float32", dict(causal=True, bwd_mode="fused"),
                     2e-5, 1e-4),
    "full fused": (8, "float32", dict(causal=False, bwd_mode="fused"),
                   2e-5, 1e-4),
    "causal schedule": (8, "float32", dict(causal=True, bwd_mode="schedule"),
                        2e-5, 1e-4),
    "causal bf16 W=4": (4, "bfloat16", dict(causal=True), 2e-2, None),
    "causal softcap fused": (
        8, "float32", dict(causal=True, softcap=25.0, bwd_mode="fused"),
        3e-5, 2e-4),
    "causal alibi fused": (
        8, "float32", dict(causal=True, alibi_slopes=SLOPES,
                           bwd_mode="fused"), 3e-5, 2e-4),
    "full softcap alibi fused": (
        8, "float32", dict(causal=False, softcap=25.0, alibi_slopes=SLOPES,
                           bwd_mode="fused"), 3e-5, 2e-4),
    "causal softcap alibi schedule": (
        8, "float32", dict(causal=True, softcap=25.0, alibi_slopes=SLOPES,
                           bwd_mode="schedule"), 3e-5, 2e-4),
}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkvd(d=D, s=S):
    return (_np((B, HQ, s, d), 0), _np((B, HKV, s, d), 1),
            _np((B, HKV, s, d), 2), _np((B, HQ, s, d), 3))


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _jax_fused(world, dtype, kw, grads, inputs=None, scale=SCALE):
    """JAX's (out, lse[, dq, dk, dv]) with its kernels in interpret mode."""
    mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("sp",))
    kw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    q, k, v, dout = (jnp.asarray(x).astype(dtype)
                     for x in (inputs or _qkvd()))

    @functools.partial(shard_map, mesh=mesh, in_specs=(SPEC4,) * 3,
                       out_specs=(SPEC4, SPEC3), check_vma=False)
    def sharded(q, k, v):
        return jfused.fused_ring_attention(
            q, k, v, scale=scale, axis_name="sp", interpret=True, **kw)

    if not grads:
        return [np.asarray(x.astype(jnp.float32))
                for x in jax.jit(sharded)(q, k, v)]
    (out, lse), vjp = jax.vjp(jax.jit(sharded), q, k, v)
    return [np.asarray(x) for x in
            (out, lse, *vjp((dout, jnp.zeros_like(lse))))]


@functools.lru_cache(maxsize=None)
def _port(world):
    """Every case of this world size in one set of gloo processes."""
    q, k, v, dout = _qkvd()
    variants = {name: ("fused_ring", dtype, kw)
                for name, (w, dtype, kw, _, _) in CASES.items() if w == world}
    return workers.run_ranks("schedules", world, {
        "q": q, "k": k, "v": v, "dout": dout, "scale": SCALE,
        "variants": variants})


@pytest.mark.parametrize("name", CASES)
def test_fused_ring_matches_jax(name):
    world, dtype, kw, tol, gtol = CASES[name]
    want = _jax_fused(world, dtype, kw, gtol is not None)
    res = _port(world)
    keys = ("out", "lse", "dq", "dk", "dv")[:len(want)]
    for key, ref in zip(keys, want):
        got = np.concatenate([r[f"{name}/{key}"] for r in res], axis=2)
        limit = tol if key in ("out", "lse") else gtol
        assert _err(got, ref) <= limit, key
    if gtol is None:  # bf16: also against full attention in float32
        q, k, v, _ = (jnp.asarray(x).astype(dtype).astype(jnp.float32)
                      for x in _qkvd())
        ref = full_attention(q, k, v, SCALE, causal=True)
        got = np.concatenate([r[f"{name}/out"] for r in res], axis=2)
        assert _err(got, ref) <= tol


# head_dim 256 (Gemma 2: softcap 50), W = 4 over 128 tokens, float32: the
# fused backward (B8's plain version) and the schedule-level one (B2/B3
# with softcap and ALiBi); the softcap tolerances of CASES
D256, S256 = 256, 128
CASES256 = {
    "D=256 causal softcap alibi fused": dict(
        causal=True, softcap=50.0, alibi_slopes=SLOPES, bwd_mode="fused"),
    "D=256 causal softcap alibi schedule": dict(
        causal=True, softcap=50.0, alibi_slopes=SLOPES, bwd_mode="schedule"),
    "D=256 full softcap fused": dict(causal=False, softcap=50.0,
                                     bwd_mode="fused"),
}


@functools.lru_cache(maxsize=None)
def _port256():
    """The head_dim 256 cases in one set of gloo processes at W = 4."""
    q, k, v, dout = _qkvd(D256, S256)
    return workers.run_ranks("schedules", 4, {
        "q": q, "k": k, "v": v, "dout": dout, "scale": D256**-0.5,
        "variants": {name: ("fused_ring", "float32", kw)
                     for name, kw in CASES256.items()}})


@pytest.mark.parametrize("name", CASES256)
def test_fused_ring_head_dim_256_matches_jax(name):
    """``fused_ring_attention`` at head_dim 256 with softcap (and ALiBi),
    both backward modes, against JAX's (interpret mode under shard_map):
    out and lse within 3e-5, the gradients within 2e-4."""
    want = _jax_fused(4, "float32", CASES256[name], True,
                      _qkvd(D256, S256), D256**-0.5)
    res = _port256()
    for key, ref in zip(("out", "lse", "dq", "dk", "dv"), want):
        got = np.concatenate([r[f"{name}/{key}"] for r in res], axis=2)
        assert _err(got, ref) <= (3e-5 if key in ("out", "lse") else 2e-4), \
            key


def test_bwd_selector_equals_jax():
    """bwd_mode="auto" picks the same backward in both packages."""
    for shape in itertools.product((1024, 4096, 8192, 16384, 32768),
                                   (64, 128, 256), (1, 2, 4, 8), (2, 4)):
        assert (tfused.fused_ring_bwd_supported(*shape)
                == jfused.fused_ring_bwd_supported(*shape)), shape
    assert not tfused.fused_ring_bwd_supported(16384, 128, 1, 2)
    assert tfused.fused_ring_bwd_supported(8192, 128, 4, 2)
    with pytest.raises(ValueError, match="bwd_mode"):
        q = torch.zeros(1, 2, 8, 16)
        tfused.fused_ring_attention(q, q, q, scale=1.0, causal=True,
                                    bwd_mode="split")


@pytest.mark.parametrize("causal,extras", [
    (True, {}), (False, {}),
    (True, dict(softcap=25.0, alibi_slopes=SLOPES)),
    (False, dict(softcap=25.0, alibi_slopes=SLOPES)),
])
@pytest.mark.parametrize("world", [1, 4])
def test_one_device_ring_matches_full_attention(world, causal, extras):
    """``chip_smoke.py``'s W-rank ring in one process, on the plain step
    functions: skipped steps, global ALiBi positions and the home-coming of
    dk/dv, against attention over the whole sequence."""
    q, k, v, dout = _qkvd()
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    out, lse = chip_smoke.ring_forward_one_device(
        tq, tk, tv, world, SCALE, causal, **extras)
    grads = chip_smoke.ring_backward_one_device(
        tq, tk, tv, tdout, out, lse, world, SCALE, causal, **extras)
    jq, jk, jv, jdout = map(jnp.asarray, (q, k, v, dout))
    if extras:
        mask = JMask(causal=causal, softcap=extras["softcap"],
                     alibi_slopes=jnp.asarray(SLOPES))
        ref_out, ref_lse = jax_naive_fwd(jq, jk, jv, SCALE, mask)
    else:
        mask = JMask(causal=causal)
        ref_out = full_attention(jq, jk, jv, SCALE, causal=causal)
        ref_lse = full_attention_lse(jq, jk, jv, SCALE, causal=causal)
    ref_grads = jax_naive_bwd(jdout, jq, jk, jv, ref_lse,
                              jax_compute_delta(jdout, ref_out), SCALE, mask)
    assert _err(out, ref_out) <= 3e-5 and _err(lse, ref_lse) <= 3e-5
    for got, ref in zip(grads, ref_grads):
        assert _err(got, ref) <= 2e-4


def test_steps_carry_the_state_and_finish_once():
    """The step functions directly: a rank's state after a diagonal and an
    off-diagonal step equals one block over both shards; a row that saw no
    key finishes as (0, NEG_INF); a step given ``first`` ignores what the
    state held."""
    q, k, v, _ = (torch.from_numpy(x[:, :, :64]) for x in _qkvd())
    k2, v2 = (torch.from_numpy(x[:, :, 64:128]) for x in _qkvd()[1:3])
    qs = tfused._prescale(q, SCALE * tfused.LOG2E)
    state = tfused.new_state(qs)
    for t in state:
        t.fill_(float("nan"))  # uninitialised memory
    assert tfused.fwd_step(qs, k, v, state, diagonal=True, first=True,
                           last=False) is None
    out, lse = tfused.fwd_step(qs, k2, v2, state, diagonal=False,
                               first=False, last=True)
    # keys [k2, k] in global order: the diagonal shard comes last
    kk, vv = torch.cat([k2, k], dim=2), torch.cat([v2, v], dim=2)
    ref_out, ref_lse = jax_naive_fwd(
        *(jnp.asarray(x.numpy()) for x in (q, kk, vv)), SCALE,
        JMask(causal=True, offset=64))
    assert _err(out, ref_out) <= 2e-5 and _err(lse, ref_lse) <= 2e-5
    # rows before every key (a negative q_row0) stay dead through a
    # second, mask-free step only if that step has no key for them either;
    # after one diagonal step they finish as (0, NEG_INF)
    state = tfused.new_state(qs)
    out, lse = tfused.fwd_step(qs, k, v, state, diagonal=True, first=True,
                               last=True, q_row0=-5)
    assert bool((out[:, :, :5] == 0).all())
    assert bool((lse[:, :, :5] == -1e30).all())
    ref_out, ref_lse = jax_naive_fwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), SCALE,
        JMask(causal=True, offset=-5))
    assert _err(out, ref_out) <= 2e-5 and _err(lse, ref_lse) <= 2e-5


def test_cuda_tensors_go_to_the_kernels_or_raise():
    """On the CPU the wrappers take the plain versions only because the
    tensors lie there; the launchers refuse CPU tensors."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    state = tfused.new_state(q)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ring_fwd_cuda(q, q, q, *state, diagonal=True, first=True,
                            last=True)
    f32 = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ring_bwd_cuda(q, q, q, q, state[0], state[0], f32, f32, f32,
                            diagonal=True, accumulate=False)
    assert fused_ring_fwd_cuda.launches == 0
    assert fused_ring_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="backend"):
        tfused.fwd_step(q, q, q, state, backend="xla", diagonal=True,
                        first=True, last=True)
