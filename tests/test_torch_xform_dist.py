"""The port's schedules with softcap and ALiBi, with windows and dropout,
and zigzag varlen, over a process group against the JAX package's under
``shard_map``, on the CPU:

- zigzag varlen: ``zigzag_ring_flash_attn_varlen_func`` in its three forms
  and the registry's ``zigzag_varlen``, causal, with softcap, with ALiBi,
  on unequal and equal packings, with ``deterministic`` reaching every
  step's ``block_bwd``, at W=2 and W=4;
- ALiBi on the zigzag and stripe schedules (the layouts' global
  positions), softcap and ALiBi on llama3 (the slopes sliced a head chunk
  at a time, ``heads_k_stride`` 1 and Hkv) and on llama3 varlen, at W=4;
- sliding windows (the global band) and dropout on the ring (causal, and
  not causal with both sides; the steps outside the window launch no
  block), zigzag, stripe and llama3 schedules and zigzag varlen at W=4,
  and the distributed dropout against the port's single-device call.

Out, lse and the gradients of q, k and v. The port runs in spawned gloo
processes (``torch_dist_workers.py``), one set per world size; JAX runs
its XLA path over as many virtual CPU devices. Inputs are identical numpy
arrays, in float32.
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
from ring_flash_attn_tpu.parallel import layouts as jlayouts
from ring_flash_attn_tpu.parallel.llama3 import (
    llama3_attention as jax_llama3)
from ring_flash_attn_tpu.parallel.ring import ring_attention as jax_ring
from ring_flash_attn_tpu.parallel.stripe import (
    stripe_attention as jax_stripe)
from ring_flash_attn_tpu.parallel.zigzag import (
    zigzag_ring_attention as jax_zigzag)

OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, tests/test_torch_varlen_dist.py's
HQ, HKV, D, S = 4, 2, 32, 256
SCALE = D**-0.5
SLOPES = np.array([2.0 ** (-8.0 * (i + 1) / HQ) for i in range(HQ)],
                  np.float32)
CAP = 20.0
SPEC4, SPEC3 = P(None, None, "sp", None), P(None, None, "sp")
# per world size, packings whose every length divides by 2W (the grouped
# zigzag layout's contract): unequal, and equal
PACKINGS = {2: {"unequal": [0, 40, 136, 168, 256]},
            4: {"unequal": [0, 64, 72, 200, 256],
                "equal": [0, 64, 128, 192, 256]}}

# zigzag varlen: name -> (world sizes, form, keywords of both packages'
# functions; "packing" names the packing)
ZIGZAG_VARLEN = {
    "causal": ((2, 4), "func", dict(packing="unequal")),
    "softcap": ((4,), "func", dict(packing="unequal", softcap=CAP)),
    "alibi": ((4,), "func", dict(packing="unequal", alibi_slopes=SLOPES)),
    "alibi_deterministic": ((4,), "func", dict(
        packing="unequal", alibi_slopes=SLOPES, deterministic=True)),
    "softcap_alibi_kvpacked": ((2, 4), "kvpacked", dict(
        packing="unequal", softcap=CAP, alibi_slopes=SLOPES)),
    "alibi_qkvpacked": ((2, 4), "qkvpacked", dict(
        packing="unequal", alibi_slopes=SLOPES)),
    "registry_alibi": ((2, 4), "registry", dict(
        packing="unequal", alibi_slopes=SLOPES)),
    "alibi_equal": ((4,), "func", dict(packing="equal",
                                       alibi_slopes=SLOPES)),
    "window": ((4,), "func", dict(packing="unequal", window_size=(24, 0))),
    "dropout": ((2, 4), "func", dict(packing="unequal", dropout_p=0.1,
                                     dropout_seed=4)),
    "window_dropout_kvpacked": ((4,), "kvpacked", dict(
        packing="unequal", window_size=(24, 0), dropout_p=0.2,
        dropout_seed=5)),
}
# the batch schedules at W=4: name -> (schedule, keywords)
SCHEDULES = {
    "zigzag alibi": ("zigzag", dict(alibi_slopes=SLOPES)),
    "zigzag softcap alibi": ("zigzag", dict(softcap=CAP,
                                            alibi_slopes=SLOPES)),
    "stripe alibi": ("stripe", dict(alibi_slopes=SLOPES)),
    "stripe softcap alibi": ("stripe", dict(softcap=CAP,
                                            alibi_slopes=SLOPES)),
    "llama3 causal softcap": ("llama3", dict(
        causal=True, softcap=CAP, heads_k_stride=1)),
    "llama3 causal alibi": ("llama3", dict(
        causal=True, alibi_slopes=SLOPES, heads_k_stride=1)),
    "llama3 full softcap alibi": ("llama3", dict(
        causal=False, softcap=CAP, alibi_slopes=SLOPES,
        heads_k_stride=HKV)),
    # windows (global bands) and dropout; shards of 64 tokens: a causal
    # window of 40 leaves steps 2 and 3 of the ring out, (50, 30) not
    # causal the shards two away
    "ring causal window": ("ring", dict(causal=True, window_left=40)),
    "ring full window": ("ring", dict(causal=False, window_left=50,
                                      window_right=30)),
    "ring dropout": ("ring", dict(causal=True, dropout_p=0.1,
                                  dropout_seed=7)),
    "ring full window dropout alibi": ("ring", dict(
        causal=False, window_left=70, dropout_p=0.2, dropout_seed=8,
        alibi_slopes=SLOPES)),
    "zigzag window": ("zigzag", dict(window_left=40)),
    "zigzag dropout": ("zigzag", dict(dropout_p=0.1, dropout_seed=9)),
    "stripe window dropout": ("stripe", dict(window_left=40, dropout_p=0.1,
                                             dropout_seed=10)),
    "llama3 causal window": ("llama3", dict(
        causal=True, window_left=40, heads_k_stride=1)),
    "llama3 dropout": ("llama3", dict(
        causal=True, dropout_p=0.1, dropout_seed=11, heads_k_stride=1)),
    "llama3 full dropout": ("llama3", dict(
        causal=False, dropout_p=0.2, dropout_seed=12, heads_k_stride=HKV)),
}
# the blocks each rank's ring forward launches (the backward the same):
# causal, steps 0 to min(rank, 1); not causal, the shards at most one away
RING_BLOCKS = {"ring causal window": [1, 2, 2, 2],
               "ring full window": [2, 3, 3, 2]}
# llama3 varlen at W=4 on the unequal packing: name -> keywords
LLAMA3_VARLEN = {
    "llama3_causal_softcap_alibi": dict(causal=True, heads_k_stride=1,
                                        softcap=CAP, alibi_slopes=SLOPES),
    "llama3_full_alibi": dict(causal=False, heads_k_stride=HKV,
                              alibi_slopes=SLOPES),
}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _mesh(world):
    return Mesh(np.array(jax.devices("cpu")[:world]), ("sp",))


def _tokens(world):
    """The packed (T, H, D) inputs, with k_qkv and v_qkv of as many heads
    as q for the qkv-packed form."""
    return dict(q=_np((S, HQ, D), 0), k=_np((S, HKV, D), 1),
                v=_np((S, HKV, D), 2), dout=_np((S, HQ, D), 3),
                k_qkv=_np((S, HQ, D), 4), v_qkv=_np((S, HQ, D), 5),
                packings=PACKINGS[world], cu=PACKINGS[world]["unequal"])


def _batch():
    return dict(q=_np((1, HQ, S, D), 10), k=_np((1, HKV, S, D), 11),
                v=_np((1, HKV, S, D), 12), dout=_np((1, HQ, S, D), 13))


@functools.lru_cache(maxsize=None)
def _port(world):
    """Every case of this file at ``world`` in one set of gloo processes:
    [rank 0's results, ...] keyed "<task>/<key>"."""
    tokens = _tokens(world)
    payloads = {"zigzag_varlen": dict(tokens, variants={
        name: (form, kw) for name, (worlds, form, kw)
        in ZIGZAG_VARLEN.items() if world in worlds})}
    if world == 4:
        batch = _batch()
        payloads["schedules"] = dict(batch, scale=SCALE, variants={
            name: (kind, "float32", kw)
            for name, (kind, kw) in SCHEDULES.items()
            if kind in ("zigzag", "ring")})
        payloads["cp"] = {"scale": SCALE, "a2a": {"pairs": []},
                          "cases": {
            name: dict(batch, kind="stripe", layout="stripe", kw=kw)
            for name, (kind, kw) in SCHEDULES.items() if kind == "stripe"}}
        payloads["llama3"] = dict(batch, scale=SCALE, variants={
            name: kw for name, (kind, kw) in SCHEDULES.items()
            if kind == "llama3"})
        payloads["varlen"] = dict(tokens, variants={
            name: ("llama3", kw) for name, kw in LLAMA3_VARLEN.items()})
    return workers.run_ranks("all", world, payloads)


def _ranks(res, key, axis=0):
    return np.concatenate([r[key] for r in res], axis=axis)


# ---- zigzag varlen ----


@functools.lru_cache(maxsize=None)
def _jax_zigzag_varlen(world, name):
    """JAX's zigzag-varlen api under shard_map on the grouped layout:
    (out, lse, dq, dk, dv), each rank's tokens in rank order."""
    _, form, kw = ZIGZAG_VARLEN[name]
    kw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items() if k not in ("packing", "deterministic")}
    data = _tokens(world)
    if form == "qkvpacked":
        data = dict(data, k=data["k_qkv"], v=data["v_qkv"])
    cu = np.asarray(PACKINGS[world][ZIGZAG_VARLEN[name][2]["packing"]])
    loc = {x: np.concatenate([jvarlen.extract_local_zigzag_varlen(
        data[x], cu, r, world) for r in range(world)])
        for x in ("q", "k", "v", "dout")}

    @functools.partial(shard_map, mesh=_mesh(world), in_specs=(P("sp"),) * 3,
                       out_specs=(P("sp"), P(None, "sp")), check_vma=False)
    def f(q, k, v):
        out, lse, _ = japi.zigzag_ring_flash_attn_varlen_func(
            q, k, v, cu // world, causal=True, return_attn_probs=True,
            group="sp", **kw)
        return out, lse

    (out, lse), vjp = jax.vjp(jax.jit(f), *(jnp.asarray(loc[x])
                                            for x in ("q", "k", "v")))
    grads = vjp((jnp.asarray(loc["dout"]), jnp.zeros_like(lse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


@pytest.mark.parametrize("world,name", [
    (w, name) for name, (worlds, _, _) in ZIGZAG_VARLEN.items()
    for w in worlds])
def test_zigzag_varlen_matches_jax(world, name):
    _, form, kw = ZIGZAG_VARLEN[name]
    want = _jax_zigzag_varlen(world, name)
    res = _port(world)
    for key, ref, tol in zip(("out", "lse", "dq", "dk", "dv"), want,
                             (OUT_TOL,) * 2 + (GRAD_TOL,) * 3):
        if key == "lse" and form == "registry":
            continue  # the registry returns out alone
        got = _ranks(res, f"zigzag_varlen/{key}_{name}",
                     axis=1 if key == "lse" else 0)
        assert _err(got, ref) <= tol, key
    # every step's block_bwd, W of them: fused=None, or False with
    # deterministic
    for r in res:
        fused = r[f"zigzag_varlen/fused_{name}"].tolist()
        assert fused == [0 if kw.get("deterministic") else -1] * world


def test_zigzag_varlen_refuses_what_it_lacks():
    """Causal only; dropout and causal windows, which raised before their
    slice, compute: in one process (W=1) the grouped layout is the
    sequences in order, so the values are JAX's flash_attn_varlen_func's,
    the dropout hash included."""
    import torch

    from ring_flash_attn_tpu_torch import api, get_attention
    from ring_flash_attn_tpu_torch.parallel.zigzag_varlen import (
        zigzag_ring_attention_varlen)

    x = torch.zeros(16, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        api.zigzag_ring_flash_attn_varlen_func(x, x, x, [0, 16],
                                               causal=False)
    with pytest.raises(ValueError, match="causal"):
        get_attention("zigzag_varlen")(
            x[None], x[None], x[None], causal=False,
            segment_ids=torch.zeros(16, dtype=torch.int32),
            positions=torch.arange(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="causal"):
        zigzag_ring_attention_varlen(
            x.transpose(0, 1)[None], x.transpose(0, 1)[None],
            x.transpose(0, 1)[None], torch.zeros(16, dtype=torch.int32),
            torch.arange(16, dtype=torch.int32), scale=1.0, causal=False)
    with pytest.raises(ValueError, match="zigzag_varlen_info"):
        get_attention("zigzag_varlen")(x[None], x[None], x[None])
    xs = [_np((16, 2, 8), s) for s in range(3)]
    for kw in (dict(dropout_p=0.1), dict(window_size=(4, 0))):
        want = japi.flash_attn_varlen_func(
            *map(jnp.asarray, xs), np.array([0, 16], np.int32), causal=True,
            **kw)
        got = api.zigzag_ring_flash_attn_varlen_func(
            *map(torch.from_numpy, xs), [0, 16], **kw)
        assert _err(got, want) <= OUT_TOL, kw


# ---- zigzag, stripe and llama3 with softcap and ALiBi at W=4 ----


@functools.lru_cache(maxsize=None)
def _jax_schedule(name):
    """JAX's (out, lse, dq, dk, dv) in the layout order of the shards,
    under shard_map over 4 devices."""
    kind, kw = SCHEDULES[name]
    kw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    arrs = [jnp.asarray(x) for x in _batch().values()]
    if kind == "zigzag":
        arrs = [jlayouts.all_local_zigzag(x, 4, axis=2) for x in arrs]
    elif kind == "stripe":
        arrs = [jlayouts.all_local_stripe(x, 4, axis=2) for x in arrs]
    fn = {"zigzag": jax_zigzag, "stripe": jax_stripe,
          "llama3": jax_llama3, "ring": jax_ring}[kind]
    q, k, v, dout = arrs

    @functools.partial(shard_map, mesh=_mesh(4), in_specs=(SPEC4,) * 3,
                       out_specs=(SPEC4, SPEC3), check_vma=False)
    def sharded(q, k, v):
        return fn(q, k, v, scale=SCALE, axis_name="sp", **kw)

    (out, lse), vjp = jax.vjp(jax.jit(sharded), q, k, v)
    return [np.asarray(x) for x in
            (out, lse, *vjp((dout, jnp.zeros_like(lse))))]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_with_xform_match_jax(name):
    kind = SCHEDULES[name][0]
    want = _jax_schedule(name)
    res = _port(4)
    for key, ref, tol in zip(("out", "lse", "dq", "dk", "dv"), want,
                             (OUT_TOL,) * 2 + (GRAD_TOL,) * 3):
        # every result is sharded along axis 2, in the layout's order
        got = _ranks(res, {"zigzag": f"schedules/{name}/{key}",
                           "ring": f"schedules/{name}/{key}",
                           "stripe": f"cp/{name}/{key}",
                           "llama3": f"llama3/{key}_{name}"}[kind], axis=2)
        assert _err(got, ref) <= tol, key
    if name in RING_BLOCKS:
        # the steps outside the window launch nothing, forward or backward
        blocks = [list(r[f"schedules/{name}/blocks"]) for r in res]
        assert blocks == [[n, n] for n in RING_BLOCKS[name]], blocks


_LAYOUT = {"zigzag": jlayouts.all_local_zigzag,
           "stripe": jlayouts.all_local_stripe}


@pytest.mark.parametrize("name", sorted(
    n for n, (_, kw) in SCHEDULES.items() if kw.get("dropout_p")))
def test_distributed_dropout_is_the_single_device_dropout(name):
    """The port's distributed dropout against its own single-device call
    on the whole sequence (the same hash of global coordinates drops the
    same pairs): out and lse, to floating-point tolerance."""
    import torch

    from ring_flash_attn_tpu_torch.ops.flash import flash_attention
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs

    kind, kw = SCHEDULES[name]
    kw = dict(kw)
    kw.pop("heads_k_stride", None)
    batch = _batch()
    mask = MaskArgs(causal=kw.pop("causal", True), **kw)
    out, lse = flash_attention(*(torch.from_numpy(batch[x])
                                 for x in ("q", "k", "v")), SCALE, mask)
    res = _port(4)
    key = {"zigzag": "schedules/{}/{}", "ring": "schedules/{}/{}",
           "stripe": "cp/{}/{}", "llama3": "llama3/{1}_{0}"}[kind]
    for what, ref in (("out", out.numpy()), ("lse", lse.numpy())):
        got = _ranks(res, key.format(name, what), axis=2)
        if kind in _LAYOUT:  # the layout's order of the whole sequence
            ref = np.asarray(_LAYOUT[kind](jnp.asarray(ref), 4, axis=2))
        assert _err(got, ref) <= OUT_TOL, what


@functools.lru_cache(maxsize=None)
def _jax_llama3_varlen(name):
    """JAX's llama3 attention under shard_map with each rank's segment
    labels as its varlen api builds them: (out, lse, dq, dk, dv)."""
    kw = dict(LLAMA3_VARLEN[name])
    data = _tokens(4)
    cu, causal = np.asarray(data["cu"]), kw.pop("causal")
    stride = kw.pop("heads_k_stride")
    kw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    n = cu[-1] // 4
    labels = []
    for r in range(4):
        cu_q, cu_k, _, _, sl = japi.llama3_flash_attn_prepare_cu_seqlens(
            cu, causal, r, 4)
        seg = np.searchsorted(cu_q, np.arange(n), side="right") - 1
        labels.append(sl.start + cu_k[seg])
    seg_all = jnp.asarray(np.concatenate(labels), jnp.int32)

    @functools.partial(shard_map, mesh=_mesh(4),
                       in_specs=(SPEC4,) * 3 + (P("sp"),),
                       out_specs=(SPEC4, SPEC3), check_vma=False)
    def f(q, k, v, seg):
        return jax_llama3(q, k, v, seg, scale=D**-0.5, causal=causal,
                          heads_k_stride=stride, axis_name="sp", **kw)

    bhsd = [jnp.asarray(data[x]).transpose(1, 0, 2)[None]
            for x in ("q", "k", "v", "dout")]
    (out, lse), vjp = jax.vjp(jax.jit(lambda q, k, v: f(q, k, v, seg_all)),
                              *bhsd[:3])
    grads = vjp((bhsd[3], jnp.zeros_like(lse)))
    return [np.asarray(out)[0].transpose(1, 0, 2), np.asarray(lse)[0],
            *(np.asarray(g)[0].transpose(1, 0, 2) for g in grads)]


@pytest.mark.parametrize("name", sorted(LLAMA3_VARLEN))
def test_llama3_varlen_with_xform_matches_jax(name):
    want = _jax_llama3_varlen(name)
    res = _port(4)
    for key, ref, tol in zip(("out", "lse", "dq", "dk", "dv"), want,
                             (OUT_TOL,) * 2 + (GRAD_TOL,) * 3):
        got = _ranks(res, f"varlen/{key}_{name}",
                     axis=1 if key == "lse" else 0)
        assert _err(got, ref) <= tol, key
