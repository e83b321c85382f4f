"""The port's context-parallel attention and training over a process group
against the JAX package's on identical numpy inputs, on the CPU: softcap
and ALiBi in the plain block versions, the sequence layouts, the ring and
zigzag schedules (forward and gradients), their api functions, the
attention registry and ``train_step`` with a sequence group.

The port runs in spawned gloo processes (``torch_dist_workers.py``), one per
rank, at W=4 and W=8; the JAX functions run under ``shard_map`` over the
same number of virtual CPU devices, as ``tests/test_schedules.py`` and
``tests/test_model.py`` run them. On the CPU the port's block calls run the
plain versions of kernels B1 and B2/B3; JAX runs its XLA path.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as workers
from ring_flash_attn_tpu import api as japi
from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import transformer as jtransformer
from ring_flash_attn_tpu.ops.flash import compute_delta as jax_compute_delta
from ring_flash_attn_tpu.ops.mask import MaskArgs as JMask
from ring_flash_attn_tpu.ops.naive import naive_block_bwd as jax_naive_bwd
from ring_flash_attn_tpu.ops.naive import naive_block_fwd as jax_naive_fwd
from ring_flash_attn_tpu.parallel import layouts as jlayouts
from ring_flash_attn_tpu.parallel.ring import ring_attention as jax_ring
from ring_flash_attn_tpu.parallel.zigzag import (
    zigzag_ring_attention as jax_zigzag)
from ring_flash_attn_tpu_torch import (
    RingAttentionLayer, api, get_attention, list_attention,
    register_attention)
from ring_flash_attn_tpu_torch.models import (
    ModelConfig, loss_fn, params_from_jax, prepare_zigzag_batch, train_step)
from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
from ring_flash_attn_tpu_torch.ops.naive import (
    naive_block_bwd, naive_block_fwd)
from ring_flash_attn_tpu_torch.parallel import (
    layouts, ring_attention, zigzag_ring_attention)

# tests/test_schedules.py's shape
B, HQ, HKV, S, D = 1, 4, 2, 512, 64
SCALE = D**-0.5
OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, the JAX schedule tests' tolerances
SPEC4, SPEC3 = P(None, None, "sp", None), P(None, None, "sp")
SLOPES = np.array([2.0 ** (-8.0 * (i + 1) / HQ) for i in range(HQ)],
                  np.float32)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


# ---- softcap and ALiBi in the plain block versions ----


@pytest.mark.parametrize("causal,offsets", [
    (True, {}), (False, {}), (True, {"offset": 96, "kv_offset": 32}),
    (False, {"offset": 0, "kv_offset": 64}),
])
def test_naive_block_softcap_alibi_matches_jax(causal, offsets):
    """naive_block_fwd/bwd with softcap, then ALiBi on the mask's positions
    (|distance| when not causal), then the mask."""
    q, k, v, dout = (_np((2, HQ, 48, 16), 0), _np((2, HKV, 40, 16), 1),
                     _np((2, HKV, 40, 16), 2), _np((2, HQ, 48, 16), 3))
    kw = dict(causal=causal, softcap=7.0, **offsets)
    jm = JMask(alibi_slopes=jnp.asarray(SLOPES), **kw)
    jo, jl = jax_naive_fwd(*map(jnp.asarray, (q, k, v)), 0.3, jm)
    jg = jax_naive_bwd(jnp.asarray(dout), *map(jnp.asarray, (q, k, v)), jl,
                       jax_compute_delta(jnp.asarray(dout), jo), 0.3, jm)
    tm = MaskArgs(alibi_slopes=SLOPES, **kw)
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    to, tl = naive_block_fwd(tq, tk, tv, 0.3, tm)
    tg = naive_block_bwd(tdout, tq, tk, tv, tl, (tdout * to).sum(-1), 0.3, tm)
    assert _err(to, jo) <= 1e-5 and _err(tl, jl) <= 1e-5
    for a, b in zip(tg, jg):
        assert _err(a, b) <= 1e-5


# ---- layouts ----


@pytest.mark.parametrize("name", ["extract_local_contiguous",
                                  "extract_local_zigzag", "all_local_zigzag",
                                  "restore_zigzag", "zigzag_position_ids"])
def test_layouts_match_jax(name):
    x = _np((2, 48, 3), 0)
    tfn, jfn = getattr(layouts, name), getattr(jlayouts, name)
    for world in (1, 2, 4):
        if name == "zigzag_position_ids":
            for rank in range(world):
                got, want = tfn(rank, world, 16), jfn(rank, world, 16)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        elif name.startswith("extract"):
            for rank in range(world):
                np.testing.assert_array_equal(
                    tfn(torch.from_numpy(x), rank, world, axis=1).numpy(),
                    np.asarray(jfn(jnp.asarray(x), rank, world, axis=1)))
        else:
            np.testing.assert_array_equal(
                tfn(torch.from_numpy(x), world, axis=1).numpy(),
                np.asarray(jfn(jnp.asarray(x), world, axis=1)))
    back = layouts.restore_zigzag(
        layouts.all_local_zigzag(torch.from_numpy(x), 4), 4)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError):
        layouts.extract_local_zigzag(torch.from_numpy(x), 0, 5)


# ---- the schedules over gloo ----

# name: (world, schedule, keywords of both packages' functions)
SCHEDULES = {
    "ring causal": (4, "ring", dict(causal=True)),
    "ring full": (4, "ring", dict(causal=False)),
    "ring causal softcap alibi": (
        4, "ring", dict(causal=True, softcap=25.0, alibi_slopes=SLOPES)),
    "ring full softcap alibi": (
        4, "ring", dict(causal=False, softcap=25.0, alibi_slopes=SLOPES)),
    "zigzag": (4, "zigzag", {}),
    "zigzag softcap": (4, "zigzag", dict(softcap=25.0)),
    "ring causal W=8": (8, "ring", dict(causal=True)),
    "zigzag W=8": (8, "zigzag", {}),
}


def _qkvd():
    return (_np((B, HQ, S, D), 0), _np((B, HKV, S, D), 1),
            _np((B, HKV, S, D), 2), _np((B, HQ, S, D), 3))


def _jax_schedule(world, kind, kw):
    """JAX's (out, lse, dq, dk, dv) in global order, under shard_map."""
    mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("sp",))
    zig = kind == "zigzag"
    fn = jax_zigzag if zig else jax_ring
    kw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    q, k, v, dout = map(jnp.asarray, _qkvd())
    if zig:
        q, k, v, dout = (jlayouts.all_local_zigzag(x, world, axis=2)
                         for x in (q, k, v, dout))

    @functools.partial(shard_map, mesh=mesh, in_specs=(SPEC4,) * 3,
                       out_specs=(SPEC4, SPEC3), check_vma=False)
    def sharded(q, k, v):
        return fn(q, k, v, scale=SCALE, axis_name="sp", **kw)

    (out, lse), vjp = jax.vjp(jax.jit(sharded), q, k, v)
    res = (out, lse, *vjp((dout, jnp.zeros_like(lse))))
    if zig:
        res = [jlayouts.restore_zigzag(x, world, axis=2) for x in res]
    return [np.asarray(x) for x in res]


def _global(res, key, layout):
    """The ranks' shards of ``key`` along axis 2 in global order."""
    x = torch.from_numpy(np.concatenate([r[key] for r in res], axis=2))
    if layout == "zigzag":
        x = layouts.restore_zigzag(x, len(res), axis=2)
    return x.numpy()


@functools.lru_cache(maxsize=None)
def _port_schedules(world):
    q, k, v, dout = _qkvd()
    variants = {name: (kind, "float32", kw)
                for name, (w, kind, kw) in SCHEDULES.items() if w == world}
    payload = {"q": q, "k": k, "v": v, "dout": dout, "scale": SCALE,
               "variants": variants}
    if world == 4:  # every W=4 task of this file in one set of processes
        res = workers.run_ranks("all", 4, {
            "schedules": payload, "api": _api_payload(),
            "train": _train_payload(dp=1)})
        return res
    return workers.run_ranks("all", world, {"schedules": payload})


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_jax(name):
    world, kind, kw = SCHEDULES[name]
    want = _jax_schedule(world, kind, kw)
    res = _port_schedules(world)
    for key, ref, tol in zip(("out", "lse", "dq", "dk", "dv"), want,
                             (OUT_TOL, OUT_TOL) + (GRAD_TOL,) * 3):
        got = _global(res, f"schedules/{name}/{key}", kind)
        assert _err(got, ref) <= tol, key


# ---- api ----

API_S, API_D = 128, 16


def _api_payload():
    return {"q": _np((2, API_S, HQ, API_D), 10),
            "k": _np((2, API_S, HKV, API_D), 11),
            "v": _np((2, API_S, HKV, API_D), 12),
            "dout": _np((2, API_S, HQ, API_D), 13), "scale": 0.3}


@pytest.mark.parametrize("kind", ["ring", "zigzag_ring"])
def test_api_funcs_match_jax(kind):
    """{kind}_flash_attn_func, its gradients, lse with return_attn_probs,
    and the kv-packed form, at W=4; the qkv-packed form runs in process."""
    p = _api_payload()
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("sp",))
    zig = kind == "zigzag_ring"
    arrs = [jnp.asarray(p[n]) for n in ("q", "k", "v", "dout")]
    if zig:
        arrs = [jlayouts.all_local_zigzag(x, 4, axis=1) for x in arrs]
    q, k, v, dout = arrs
    jfunc = getattr(japi, f"{kind}_flash_attn_func")
    seq = P(None, "sp")

    @functools.partial(shard_map, mesh=mesh, in_specs=(seq,) * 3,
                       out_specs=(seq, SPEC3), check_vma=False)
    def sharded(q, k, v):
        out, lse, _ = jfunc(q, k, v, causal=True, softmax_scale=0.3,
                            return_attn_probs=True, group="sp")
        return out, lse

    (out, lse), vjp = jax.vjp(jax.jit(sharded), q, k, v)
    grads = vjp((dout, jnp.zeros_like(lse)))
    res = _port_schedules(4)

    def port(key, axis=1):
        x = torch.from_numpy(np.concatenate(
            [r[f"api/{kind}/{key}"] for r in res], axis=axis))
        return x.numpy()  # stays in the schedule's layout, as JAX's does

    assert _err(port("func"), out) <= OUT_TOL
    assert _err(port("kvpacked"), out) <= OUT_TOL
    assert _err(port("lse", axis=2), lse) <= OUT_TOL
    for key, ref in zip(("dq", "dk", "dv"), grads):
        assert _err(port(key), ref) <= GRAD_TOL
    # the qkv-packed form needs Hq == Hkv: one process, no group
    qkv = _np((1, 32, 3, 2, API_D), 14)
    tfn = getattr(api, f"{kind}_flash_attn_qkvpacked_func")
    got = tfn(torch.from_numpy(qkv), causal=True)
    want = japi.flash_attn_qkvpacked_func(jnp.asarray(qkv), causal=True)
    assert _err(got, want) <= OUT_TOL


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("form", ["func", "kvpacked_func", "qkvpacked_func"])
@pytest.mark.parametrize("kind", ["ring", "zigzag_ring"])
def test_deterministic_reaches_block_bwd(kind, form, deterministic,
                                         monkeypatch):
    """``deterministic=True`` on a ring entry point reaches every step's
    ``block_bwd`` as ``fused=False`` (the split kernels B3a/B3b on the
    card), the default as ``fused=None``; one process, no group (W=1),
    where the gradient is the JAX flash function's."""
    module = importlib.import_module(
        "ring_flash_attn_tpu_torch.parallel."
        + ("ring" if kind == "ring" else "zigzag"))
    seen = []
    real = module.block_bwd

    def recorder(*args, fused=None, **kw):
        seen.append(fused)
        return real(*args, fused=fused, **kw)

    monkeypatch.setattr(module, "block_bwd", recorder)
    qkv = _np((1, 32, 3, 2, API_D), 30)
    x = torch.from_numpy(qkv).requires_grad_()
    func = getattr(api, f"{kind}_flash_attn_{form}")
    kw = dict(causal=True, softmax_scale=0.3, deterministic=deterministic)
    if form == "qkvpacked_func":
        out = func(x, **kw)
    elif form == "kvpacked_func":
        out = func(x[:, :, 0], x[:, :, 1:], **kw)
    else:
        out = func(x[:, :, 0], x[:, :, 1], x[:, :, 2], **kw)
    dout = _np(out.shape, 31)
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(dout))
    assert seen == [False if deterministic else None]
    _, vjp = jax.vjp(lambda t: japi.flash_attn_qkvpacked_func(
        t, causal=True, softmax_scale=0.3), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(dout))
    assert _err(grad, want) <= GRAD_TOL


@pytest.mark.parametrize("kind", ["ring", "zigzag_ring"])
def test_deterministic_reaches_every_step_at_w4(kind):
    """At W=4 over gloo, every backward step of ``{kind}_flash_attn_func``
    and of its kv-packed form asks ``block_bwd`` for ``fused=False`` under
    ``deterministic=True``, and for ``fused=None`` by default: the ring's
    rank r computes r + 1 causal steps, the zigzag's every rank all 4
    (step 0, then the earlier ranks' and the later ranks' halves)."""
    res = _port_schedules(4)
    for rank, r in enumerate(res):
        seen = r[f"api/{kind}/fused"]
        n = rank + 1 if kind == "ring" else 4
        assert seen == {"default": [None] * n, "deterministic": [False] * n,
                        "kvpacked deterministic": [False] * n}, rank


# ---- registry ----


def test_registry_and_layer():
    assert list_attention() == ["flash", "fused_ring", "llama3", "ring",
                                "ring_varlen", "stripe", "ulysses", "zigzag",
                                "zigzag_varlen"]
    # every entry of the JAX package's registry is ported: zigzag_varlen
    # too, which needs the layout's segment ids and positions
    with pytest.raises(ValueError, match="zigzag_varlen_info"):
        get_attention("zigzag_varlen")(*(torch.zeros(1, 8, 2, 16),) * 3)
    with pytest.raises(KeyError, match="unknown"):
        get_attention("nope")
    with pytest.raises(ValueError):
        register_attention("flash", lambda *a, **k: None)
    register_attention("mine", get_attention("flash"))
    try:
        assert "mine" in list_attention()
    finally:
        from ring_flash_attn_tpu_torch.adapters import registry
        del registry._REGISTRY["mine"]
    # one process, no group: every entry equals the flash entry
    q, k, v = (torch.from_numpy(_np((1, 32, h, 16), i))
               for i, h in enumerate((HQ, HKV, HKV)))
    ref = RingAttentionLayer("flash")(q, k, v)
    assert ref.shape == q.shape
    for impl in ("ring", "zigzag", "fused_ring", "llama3", "stripe",
                 "ulysses"):
        layer = RingAttentionLayer(impl, scale=16**-0.5)
        assert _err(layer(q, k, v), ref) <= OUT_TOL, impl
        assert impl in repr(layer)
    full = RingAttentionLayer("ring")(q, k, v, causal=False)
    assert _err(full, RingAttentionLayer("flash", causal=False)(q, k, v)) \
        <= OUT_TOL
    with pytest.raises(ValueError):
        RingAttentionLayer("zigzag", causal=False)(q, k, v)
    with pytest.raises(NotImplementedError, match="varlen"):
        RingAttentionLayer("ring")(q, k, v, segment_ids=torch.zeros(32))
    with pytest.raises(ValueError):
        RingAttentionLayer("fused_ring")(q, k, v, window_left=4)
    # gradients flow through the fused entry, whichever backward it takes
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        RingAttentionLayer("flash")(*leaves).sum(), leaves)
    for kw in ({}, {"bwd_mode": "schedule"}, {"backend": "plain"}):
        got = torch.autograd.grad(
            RingAttentionLayer("fused_ring", **kw)(*leaves).sum(), leaves)
        for a, b in zip(got, want):
            assert _err(a, b) <= GRAD_TOL, kw


# ---- what raised before its slice computes ----


def _bhsd_out(fn):
    """A schedule call on (B, H, S, D) tensors as a (B, S, H, D) out."""
    return lambda q, k, v: fn(*(x.transpose(1, 2) for x in (q, k, v)))[
        0].transpose(1, 2)


@pytest.mark.parametrize("call,jax_kw", [
    (_bhsd_out(lambda q, k, v: ring_attention(
        q, k, v, scale=1.0, causal=True, dropout_p=0.1)),
     dict(causal=True, softmax_scale=1.0, dropout_p=0.1)),
    (_bhsd_out(lambda q, k, v: ring_attention(
        q, k, v, scale=1.0, causal=True, window_left=4)),
     dict(causal=True, softmax_scale=1.0, window_size=(4, 0))),
    (_bhsd_out(lambda q, k, v: ring_attention(
        q, k, v, scale=1.0, causal=False, window_right=4)),
     dict(causal=False, softmax_scale=1.0, window_size=(-1, 4))),
    # ALiBi on zigzag is ported (softcap/ALiBi slice): dropout with it
    (_bhsd_out(lambda q, k, v: zigzag_ring_attention(
        q, k, v, scale=1.0, alibi_slopes=np.ones(2), dropout_p=0.1)),
     dict(causal=True, softmax_scale=1.0, alibi_slopes=np.ones(2),
          dropout_p=0.1)),
    (_bhsd_out(lambda q, k, v: zigzag_ring_attention(
        q, k, v, scale=1.0, dropout_p=0.1)),
     dict(causal=True, softmax_scale=1.0, dropout_p=0.1)),
    (_bhsd_out(lambda q, k, v: zigzag_ring_attention(
        q, k, v, scale=1.0, window_left=4)),
     dict(causal=True, softmax_scale=1.0, window_size=(4, 0))),
    (lambda q, k, v: api.ring_flash_attn_func(
        q, k, v, causal=True, window_size=(4, 0)),
     dict(causal=True, window_size=(4, 0))),
    (lambda q, k, v: api.ring_flash_attn_func(q, k, v, dropout_p=0.1),
     dict(dropout_p=0.1)),
    (lambda q, k, v: api.zigzag_ring_flash_attn_func(
        q, k, v, causal=True, alibi_slopes=np.ones(2), dropout_p=0.1),
     dict(causal=True, alibi_slopes=np.ones(2), dropout_p=0.1)),
    (lambda q, k, v: api.zigzag_ring_flash_attn_func(
        q, k, v, causal=True, window_size=(4, 0)),
     dict(causal=True, window_size=(4, 0))),
])
def test_unported_ring_options_raise(call, jax_kw):
    """The ring and zigzag options that raised before the window/dropout
    slice (dropout, causal and non-causal windows, dropout with ALiBi)
    compute now, in one process (W=1), JAX's flash_attn_func's values."""
    q, k, v = (_np((1, 8, 2, 16), s) for s in range(3))
    want = japi.flash_attn_func(*map(jnp.asarray, (q, k, v)), **jax_kw)
    got = call(*map(torch.from_numpy, (q, k, v)))
    assert _err(got, want) <= OUT_TOL


def test_zigzag_is_causal_only_and_needs_an_even_length():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        api.zigzag_ring_flash_attn_func(q, q, q, causal=False)
    odd = torch.zeros(1, 2, 7, 16)
    with pytest.raises(ValueError, match="even"):
        zigzag_ring_attention(odd, odd, odd, scale=1.0)


# ---- train_step over a sequence group ----

# tests/test_model.py's configuration at two layers, in float32: the two
# frameworks round bf16 at different places (a bf16 run of this test moved
# the loss by 1.5e-4), and the point here is the schedule and the reductions
CFG_KW = dict(vocab=128, dim=64, layers=2, heads=4, kv_heads=2, head_dim=16,
              mlp_dim=128, dtype="float32")
TRAIN_S, LR = 128, 1e-2
LOSS_TOL, PARAM_TOL = 2e-5, 2e-5


@functools.lru_cache(maxsize=None)
def _jparams():
    return jtransformer.init_params(jax.random.PRNGKey(0),
                                    JaxConfig(**CFG_KW))


def _tokens(b):
    return np.random.default_rng(7).integers(
        0, CFG_KW["vocab"], size=(b, TRAIN_S)).astype(np.int32)


def _batches(tokens, sp):
    """{kind: (tokens, labels, positions)} in each schedule's layout."""
    labels = np.concatenate(
        [tokens[:, 1:], np.full_like(tokens[:, :1], -100)], axis=1)
    zz = [np.asarray(x) for x in jtransformer.prepare_zigzag_batch(
        jnp.asarray(tokens), sp)]
    return {"ring": (tokens, labels, np.arange(TRAIN_S, dtype=np.int32)),
            "zigzag": tuple(zz)}


def _train_payload(dp):
    world = 4
    return {"cfg": CFG_KW, "lr": LR, "dp": dp,
            "params": jax.tree.map(np.asarray, _jparams()),
            "batches": _batches(_tokens(2), world // dp)}


def _jax_train(kind, dp, batch):
    sp = 4 // dp
    cfg = JaxConfig(attention=kind, **CFG_KW)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(dp, sp),
                ("dp", "sp"))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("dp", "sp"), P("dp", "sp"), P("sp")),
        out_specs=(P(), P()), check_vma=False)
    def step(params, tokens, labels, pos):
        return jtransformer.train_step(
            params, cfg, tokens, labels, pos, lr=LR, axis_name="sp",
            data_axis="dp" if dp > 1 else None)

    return jax.jit(step)(_jparams(), *map(jnp.asarray, batch))


def _check_params(out, prefix, new):
    """The port's updated parameters (a rank's result dict) against JAX's
    new parameter tree."""
    flat = {"embed": new["embed"], "final_norm": new["final_norm"],
            "lm_head": new["lm_head"]}
    for i, layer in enumerate(new["layers"]):
        flat.update({f"layers.{i}.{n}": x for n, x in layer.items()})
    for name, ref in flat.items():
        ref = np.asarray(ref.astype(jnp.float32))
        assert _err(out[f"{prefix}/{name}"], ref) <= PARAM_TOL, name


@pytest.mark.parametrize("kind", ["zigzag", "ring"])
def test_train_step_over_sequence_group_matches_jax(kind):
    """One SGD step at W=4: the loss and every updated parameter, the same
    on every rank."""
    batch = _batches(_tokens(2), 4)[kind]
    new, jloss = _jax_train(kind, 1, batch)
    for out in _port_schedules(4):
        assert abs(float(out[f"train/{kind}/loss"]) - float(jloss)) \
            <= LOSS_TOL
        _check_params(out, f"train/{kind}", new)


def test_train_step_over_data_and_sequence_groups_matches_jax():
    """A 2 x 2 grid of processes: the sequence over rows, the batch over
    columns; gradients summed over both, the loss averaged over the data
    group."""
    res = workers.run_ranks("train", 4, _train_payload(dp=2))
    batches = _batches(_tokens(2), 2)
    for kind in ("zigzag", "ring"):
        new, jloss = _jax_train(kind, 2, batches[kind])
        for out in res:
            assert abs(float(out[f"{kind}/loss"]) - float(jloss)) <= LOSS_TOL
            _check_params(out, kind, new)


@pytest.mark.parametrize("kind", ["ring", "zigzag", "stripe", "usp",
                                  "llama3"])
def test_sequence_group_of_one_process_equals_the_flash_path(kind):
    """sp_group=None (and for USP ulysses_group=None) with no process group
    initialised is a ring of one: the loss and the step equal the
    single-device path's (sp_group=False, the default)."""
    tokens = torch.from_numpy(_tokens(2)).long()
    toks, labels, pos = prepare_zigzag_batch(tokens, 1)
    assert torch.equal(toks, tokens) and torch.equal(
        pos, torch.arange(TRAIN_S))
    tree = jax.tree.map(np.asarray, _jparams())
    models = [params_from_jax(tree, ModelConfig(attention=kind, **CFG_KW),
                              device="cpu") for _ in range(2)]
    groups = dict(sp_group=None)
    if kind == "usp":
        groups["ulysses_group"] = None
    flash = loss_fn(models[0], toks, labels, pos)
    ring = loss_fn(models[1], toks, labels, pos, **groups)
    assert abs(float(flash.detach()) - float(ring.detach())) <= 1e-6
    _, l0 = train_step(models[0], toks, labels, pos, lr=LR)
    _, l1 = train_step(models[1], toks, labels, pos, lr=LR, data_group=None,
                       **groups)
    assert abs(float(l0) - float(l1)) <= 1e-6
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert _err(a.detach().float(), b.detach().float()) <= 1e-6
