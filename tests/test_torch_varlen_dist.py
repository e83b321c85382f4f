"""The port's ring-varlen and llama3-varlen schedules over a process group
against the JAX package's under ``shard_map``, on the CPU: the ring-varlen
api in its three forms, ``get_attention("ring_varlen")`` and
``llama3_flash_attn_varlen_func`` (metadata from
``llama3_flash_attn_prepare_cu_seqlens``, ``heads_k_stride`` 1 and Hkv),
causal and not, with causal windows and dropout, out, lse and the
gradients of q, k and v, with ``deterministic`` reaching every step's
``block_bwd``.

The port runs in spawned gloo processes (``torch_dist_workers.py``), one
set per world size (W=2 and W=4); JAX runs its XLA path over as many
virtual CPU devices. Inputs are identical numpy arrays, in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as workers
from ring_flash_attn_tpu import api as japi
from ring_flash_attn_tpu.ops import varlen as jvarlen
from ring_flash_attn_tpu.parallel.llama3 import llama3_attention

OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, JAX's tests/test_varlen.py limits
HQ, HKV, D = 4, 2, 32
# per world size, sequences divisible by it (the ring layout's contract)
CU = {2: [0, 40, 136, 168, 256], 4: [0, 64, 68, 200, 256]}

VARIANTS = {
    "ring_causal": ("ring", dict(causal=True)),
    "ring_full": ("ring", dict(causal=False)),
    "ring_deterministic": ("ring", dict(causal=True, deterministic=True)),
    "ring_kvpacked": ("ring_kvpacked", dict(causal=True)),
    "ring_qkvpacked": ("ring_qkvpacked", dict(causal=False)),
    "registry_causal": ("registry", dict(causal=True)),
    "registry_full": ("registry", dict(causal=False)),
    "llama3_causal_stride1": ("llama3", dict(causal=True, heads_k_stride=1)),
    "llama3_causal": ("llama3", dict(causal=True, heads_k_stride=HKV)),
    "llama3_full_stride1": ("llama3", dict(causal=False, heads_k_stride=1)),
    "llama3_full": ("llama3", dict(causal=False, heads_k_stride=HKV)),
    "llama3_deterministic": ("llama3", dict(causal=True, heads_k_stride=1,
                                            deterministic=True)),
    # windows (the global band on the sequences' positions) and dropout
    # (the hash of their positions and segments)
    "ring_window": ("ring", dict(causal=True, window_size=(30, 0))),
    "ring_dropout": ("ring", dict(causal=True, dropout_p=0.1,
                                  dropout_seed=5)),
    "ring_full_dropout": ("ring", dict(causal=False, dropout_p=0.2,
                                       dropout_seed=6)),
    "llama3_window_stride1": ("llama3", dict(causal=True, heads_k_stride=1,
                                             window_size=(30, 0))),
    "llama3_dropout": ("llama3", dict(causal=True, heads_k_stride=HKV,
                                      dropout_p=0.1, dropout_seed=7)),
    "registry_window_dropout": ("registry", dict(
        causal=True, window_left=30, dropout_p=0.1, dropout_seed=8)),
}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _data(world):
    """The inputs, with k_qkv and v_qkv of as many heads as q for the
    qkv-packed form."""
    t = CU[world][-1]
    return dict(q=_np((t, HQ, D), 0), k=_np((t, HKV, D), 1),
                v=_np((t, HKV, D), 2), dout=_np((t, HQ, D), 3),
                k_qkv=_np((t, HQ, D), 4), v_qkv=_np((t, HQ, D), 5),
                cu=CU[world])


@functools.lru_cache(maxsize=None)
def _port(world):
    """Every variant at this world size in one set of gloo processes,
    [rank 0's results, ...] with keys "varlen/<key>_<variant>"."""
    return workers.run_ranks("all", world, {
        "varlen": dict(_data(world), variants=VARIANTS)})


def _mesh(world):
    return Mesh(np.array(jax.devices("cpu")[:world]), ("sp",))


def _jax_ring(world, causal, data, **kw):
    """JAX's ring-varlen api under shard_map on the ring layout: (out, lse,
    dq, dk, dv), each rank's tokens in rank order; ``kw`` a window or
    dropout."""
    cu = np.asarray(data["cu"])
    loc = {x: np.concatenate([jvarlen.extract_local_ring_varlen(
        data[x], cu, r, world) for r in range(world)])
        for x in ("q", "k", "v", "dout")}
    cu_local = cu // world

    @functools.partial(shard_map, mesh=_mesh(world), in_specs=(P("sp"),) * 3,
                       out_specs=(P("sp"), P(None, "sp")), check_vma=False)
    def f(q, k, v):
        out, lse, _ = japi.ring_flash_attn_varlen_func(
            q, k, v, cu_local, causal=causal, return_attn_probs=True,
            group="sp", **kw)
        return out, lse

    (out, lse), vjp = jax.vjp(jax.jit(f), *(jnp.asarray(loc[x])
                                            for x in ("q", "k", "v")))
    grads = vjp((jnp.asarray(loc["dout"]), jnp.zeros_like(lse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def _jax_llama3(world, causal, stride, data, window_size=(-1, -1), **kw):
    """JAX's llama3 attention under shard_map with each rank's segment
    labels as its varlen api builds them from
    llama3_flash_attn_prepare_cu_seqlens: (out, lse, dq, dk, dv); ``kw``
    dropout, ``window_size`` a causal window."""
    if window_size[0] >= 0:
        kw["window_left"] = window_size[0]
    cu = np.asarray(data["cu"])
    n = cu[-1] // world
    labels = []
    for r in range(world):
        cu_q, cu_k, _, _, sl = japi.llama3_flash_attn_prepare_cu_seqlens(
            cu, causal, r, world)
        seg = np.searchsorted(cu_q, np.arange(n), side="right") - 1
        labels.append(sl.start + cu_k[seg])
    seg_all = jnp.asarray(np.concatenate(labels), jnp.int32)
    spec = P(None, None, "sp", None)

    @functools.partial(shard_map, mesh=_mesh(world),
                       in_specs=(spec,) * 3 + (P("sp"),),
                       out_specs=(spec, P(None, None, "sp")),
                       check_vma=False)
    def f(q, k, v, seg):
        return llama3_attention(q, k, v, seg, scale=D**-0.5, causal=causal,
                                heads_k_stride=stride, axis_name="sp", **kw)

    bhsd = [jnp.asarray(data[x]).transpose(1, 0, 2)[None]
            for x in ("q", "k", "v", "dout")]
    (out, lse), vjp = jax.vjp(jax.jit(lambda q, k, v: f(q, k, v, seg_all)),
                              *bhsd[:3])
    grads = vjp((bhsd[3], jnp.zeros_like(lse)))
    return [np.asarray(out)[0].transpose(1, 0, 2), np.asarray(lse)[0],
            *(np.asarray(g)[0].transpose(1, 0, 2) for g in grads)]


def _gathered(res, key, axis=0):
    return np.concatenate([r[f"varlen/{key}"] for r in res], axis=axis)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_varlen_schedules_match_jax(world, name):
    kind, kw = VARIANTS[name]
    causal = kw["causal"]
    data = _data(world)
    if kind == "ring_qkvpacked":
        data = dict(data, k=data["k_qkv"], v=data["v_qkv"])
    band = {k: x for k, x in kw.items()
            if k in ("window_size", "dropout_p", "dropout_seed")}
    if "window_left" in kw:  # the registry's keyword
        band["window_size"] = (kw["window_left"], 0)
    if kind == "llama3":
        want = _jax_llama3(world, causal, kw["heads_k_stride"], data, **band)
    else:
        want = _jax_ring(world, causal, data, **band)
    res = _port(world)
    keys = ("out", "lse", "dq", "dk", "dv")
    for key, ref, tol in zip(keys, want, (OUT_TOL,) * 2 + (GRAD_TOL,) * 3):
        if key == "lse" and kind == "registry":
            continue  # the registry returns out alone
        got = _gathered(res, f"{key}_{name}", axis=1 if key == "lse" else 0)
        assert _err(got, ref) <= tol, key
    # every step's block_bwd: fused=None, or False with deterministic
    fused = {int(f) for r in res for f in r[f"varlen/fused_{name}"]}
    assert fused == ({0} if kw.get("deterministic") else {-1}), fused
