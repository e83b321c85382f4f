"""The port's stripe, Ulysses and USP schedules against the JAX package's
on identical numpy inputs, on the CPU: the stripe layouts, the
all-to-all, ``stripe_attention``, ``ulysses_attention`` and
``usp_attention`` (forward and gradients), the ``stripe_flash_attn_*``
api functions, the registry's ``stripe`` and ``ulysses`` entries and
``train_step`` with ``attention="stripe"`` and ``"usp"``.

The port runs in spawned gloo processes (``torch_dist_workers.py``), one
set at W=4 and one at W=8 (USP on a 2 x 4 grid); the JAX functions run
under ``shard_map`` over the same number of virtual CPU devices, as
``tests/test_schedules.py``, ``test_ulysses.py`` and ``test_usp.py`` run
them. On the CPU the port's block calls run the plain versions of kernels
B1 and B2/B3; JAX runs its XLA path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as workers
from ring_flash_attn_tpu import api as japi
from ring_flash_attn_tpu.adapters import registry as jregistry
from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import transformer as jtransformer
from ring_flash_attn_tpu.ops.flash import (
    flash_attention as jax_flash_attention)
from ring_flash_attn_tpu.ops.mask import MaskArgs as JMask
from ring_flash_attn_tpu.parallel import layouts as jlayouts
from ring_flash_attn_tpu.parallel.stripe import (
    stripe_attention as jax_stripe)
from ring_flash_attn_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses, usp_attention as jax_usp)
from ring_flash_attn_tpu_torch import (
    RingAttentionLayer, api, get_attention, list_attention)
from ring_flash_attn_tpu_torch.models import (
    ModelConfig, loss_fn, params_from_jax)
from ring_flash_attn_tpu_torch.parallel import (
    layouts, stripe_attention, ulysses_attention, usp_attention)
from test_torch_ring import CFG_KW, LR, _check_params, _err, _jparams, _np

# tests/test_schedules.py's shape; USP at tests/test_usp.py's 8 q heads
B, HQ, HKV, S, D = 1, 4, 2, 512, 64
SCALE = D**-0.5
OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, the JAX schedule tests' tolerances
LOSS_TOL = 2e-5
TRAIN_S = 128
SLOPES = np.array([2.0 ** (-8.0 * (i + 1) / HQ) for i in range(HQ)],
                  np.float32)


# ---- layouts ----


@pytest.mark.parametrize("name", ["extract_local_stripe", "all_local_stripe",
                                  "restore_stripe", "stripe_position_ids"])
def test_stripe_layouts_match_jax(name):
    x = _np((2, 48, 3), 0)
    tfn, jfn = getattr(layouts, name), getattr(jlayouts, name)
    for world in (1, 2, 4, 8):
        if name == "stripe_position_ids":
            for rank in range(world):
                got, want = tfn(rank, world, 6), jfn(rank, world, 6)
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
    back = layouts.restore_stripe(
        layouts.all_local_stripe(torch.from_numpy(x), 4), 4)
    np.testing.assert_array_equal(back.numpy(), x)


# ---- the schedules over gloo ----

# name: (world, case). A case names the port's function ("kind"), the
# layout of its shards, its head counts and the keywords that both
# packages' functions take; "wu" is USP's Ulysses group size
CASES = {
    "stripe": (4, dict(kind="stripe", layout="stripe", kw={})),
    "stripe softcap": (4, dict(kind="stripe", layout="stripe",
                               kw=dict(softcap=25.0))),
    "stripe W=8": (8, dict(kind="stripe", layout="stripe", kw={})),
    "stripe softcap W=8": (8, dict(kind="stripe", layout="stripe",
                                   kw=dict(softcap=25.0))),
    "ulysses causal hkv=2": (4, dict(kind="ulysses", layout="contiguous",
                                     kw=dict(causal=True))),
    "ulysses full hkv=2": (4, dict(kind="ulysses", layout="contiguous",
                                   kw=dict(causal=False))),
    "ulysses causal hkv=4": (4, dict(kind="ulysses", layout="contiguous",
                                     hkv=4, kw=dict(causal=True))),
    "ulysses full hkv=4": (4, dict(kind="ulysses", layout="contiguous",
                                   hkv=4, kw=dict(causal=False))),
    "ulysses softcap alibi": (4, dict(
        kind="ulysses", layout="contiguous",
        kw=dict(causal=True, softcap=25.0, alibi_slopes=SLOPES))),
    "usp ring causal": (8, dict(kind="usp", layout="contiguous", wu=4, hq=8,
                                kw=dict(causal=True, variant="ring"))),
    "usp ring full": (8, dict(kind="usp", layout="contiguous", wu=4, hq=8,
                              kw=dict(causal=False, variant="ring"))),
    "usp zigzag": (8, dict(kind="usp", layout="zigzag", wu=4, hq=8,
                           kw=dict(causal=True, variant="zigzag"))),
    "usp stripe": (8, dict(kind="usp", layout="stripe", wu=4, hq=8,
                           kw=dict(causal=True, variant="stripe"))),
    # windows and dropout at W=4: stripe's on its global positions,
    # Ulysses' and USP's (a 2 x 2 grid) dropout with each process's global
    # head ids
    "stripe window": (4, dict(kind="stripe", layout="stripe",
                              kw=dict(window_left=100))),
    "stripe dropout alibi": (4, dict(
        kind="stripe", layout="stripe",
        kw=dict(dropout_p=0.1, dropout_seed=3, alibi_slopes=SLOPES))),
    "ulysses dropout": (4, dict(kind="ulysses", layout="contiguous",
                                kw=dict(causal=True, dropout_p=0.1,
                                        dropout_seed=4))),
    "ulysses full dropout hkv=4": (4, dict(
        kind="ulysses", layout="contiguous", hkv=4,
        kw=dict(causal=False, dropout_p=0.2, dropout_seed=5))),
    "usp ring dropout": (4, dict(kind="usp", layout="contiguous", wu=2,
                                 kw=dict(causal=True, variant="ring",
                                         dropout_p=0.1, dropout_seed=6))),
    "usp zigzag dropout": (4, dict(kind="usp", layout="zigzag", wu=2,
                                   kw=dict(causal=True, variant="zigzag",
                                           dropout_p=0.1, dropout_seed=7))),
    "registry stripe": (4, dict(kind="registry stripe", layout="stripe",
                                kw=dict(causal=True))),
    "registry ulysses": (4, dict(kind="registry ulysses",
                                 layout="contiguous", kw=dict(causal=True))),
}

# (split, concat) dims of the all-to-all on (2, 8, 12, 4) per rank at W=4
A2A_PAIRS = [(1, 2), (2, 1), (3, 0), (2, 2)]
A2A_SHAPE = (2, 8, 12, 4)


def _arrays(case):
    hq, hkv = case.get("hq", HQ), case.get("hkv", HKV)
    return {"q": _np((B, hq, S, D), 0), "k": _np((B, hkv, S, D), 1),
            "v": _np((B, hkv, S, D), 2), "dout": _np((B, hq, S, D), 3)}


def _a2a_inputs():
    n = int(np.prod(A2A_SHAPE))
    x = np.stack([(r * 10000 + np.arange(n)).reshape(A2A_SHAPE)
                  for r in range(4)]).astype(np.float32)
    ct = np.stack([(r * 10000 + 5000 + np.arange(n))
                   for r in range(4)]).astype(np.float32)
    return x, ct


@functools.lru_cache(maxsize=None)
def _port_runs(world):
    """Every case of this file at ``world`` in one set of processes."""
    cases = {name: dict(case, **_arrays(case))
             for name, (w, case) in CASES.items() if w == world}
    # the port's all-to-all takes negative dims: split -1 is dim 3
    cp = {"scale": SCALE, "cases": cases,
          "a2a": {"pairs": [], "x": None, "ct": None}}
    if world == 8:
        return workers.run_ranks("cp", 8, cp)
    x, ct = _a2a_inputs()
    cp["a2a"] = {"pairs": [(s - 4 if s == 3 else s, c)
                           for s, c in A2A_PAIRS], "x": x, "ct": ct}
    return workers.run_ranks("all", 4, {
        "cp": cp, "api": _api_payload(), "train": _train_payload(),
        "ulysses_heads": {}})


def _jax_case(world, case):
    """JAX's (out, lse, dq, dk, dv) in the layout order of the shards
    (lse None for a registry entry), under shard_map."""
    kind, kw, layout = case["kind"], dict(case["kw"]), case["layout"]
    kw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    arrs = [jnp.asarray(a) for a in _arrays(case).values()]
    if "wu" in case:
        wu = case["wu"]
        mesh = Mesh(np.array(jax.devices("cpu")[:world]).reshape(
            world // wu, wu), ("rp", "up"))
        axes, wl = ("rp", "up"), world // wu
    else:
        mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("sp",))
        axes, wl = "sp", world
    relayout = {"zigzag": jlayouts.all_local_zigzag,
                "stripe": jlayouts.all_local_stripe}.get(layout)
    if relayout is not None:
        arrs = [relayout(x, wl, axis=2) for x in arrs]
    q, k, v, dout = arrs
    spec4, spec3 = P(None, None, axes, None), P(None, None, axes)
    if kind.startswith("registry"):
        impl = jregistry.get_attention(kind.split()[1])

        @functools.partial(shard_map, mesh=mesh, in_specs=(spec4,) * 3,
                           out_specs=spec4, check_vma=False)
        def sharded(q, k, v):
            t = functools.partial(jnp.swapaxes, axis1=1, axis2=2)
            return t(impl(t(q), t(k), t(v), scale=SCALE, axis_name="sp",
                          **kw))

        out, vjp = jax.vjp(jax.jit(sharded), q, k, v)
        return [np.asarray(out), None, *map(np.asarray, vjp(dout))]
    if kind == "stripe":
        fn = functools.partial(jax_stripe, axis_name="sp")
    elif kind == "ulysses":
        fn = functools.partial(jax_ulysses, axis_name="sp")
    else:
        fn = functools.partial(jax_usp, ulysses_axis="up", ring_axis="rp")

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec4,) * 3,
                       out_specs=(spec4, spec3), check_vma=False)
    def sharded(q, k, v):
        return fn(q, k, v, scale=SCALE, **kw)

    if kind == "usp" and kw.get("dropout_p"):
        # JAX's USP backward with dropout fails under jax.vjp (the head
        # offset it computes from the rank is a traced value its ring's
        # custom_vjp closes over): the forward under shard_map, the
        # gradients of JAX's single-device flash attention with the same
        # dropout, to which JAX's tests hold USP's dropout
        out, lse = jax.jit(sharded)(q, k, v)
        g = [jnp.asarray(a) for a in _arrays(case).values()]
        mask = JMask(causal=kw["causal"], dropout_p=kw["dropout_p"],
                     dropout_seed=kw["dropout_seed"])
        _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
            q, k, v, SCALE, mask)[0], *g[:3])
        grads = vjp(g[3])
        if relayout is not None:
            grads = [relayout(x, wl, axis=2) for x in grads]
        return [np.asarray(x) for x in (out, lse, *grads)]
    (out, lse), vjp = jax.vjp(jax.jit(sharded), q, k, v)
    return [np.asarray(x)
            for x in (out, lse, *vjp((dout, jnp.zeros_like(lse))))]


@pytest.mark.parametrize("name", CASES)
def test_schedule_matches_jax(name):
    """out, lse, dq, dk, dv of every rank, in the layout order of the
    shards, against JAX's under shard_map."""
    world, case = CASES[name]
    want = _jax_case(world, case)
    res = _port_runs(world)
    for key, ref, tol in zip(("out", "lse", "dq", "dk", "dv"), want,
                             (OUT_TOL, OUT_TOL) + (GRAD_TOL,) * 3):
        if ref is None:
            continue
        got = np.concatenate([r[f"cp/{name}/{key}" if world == 4
                                else f"{name}/{key}"] for r in res], axis=2)
        assert _err(got, ref) <= tol, key


@pytest.mark.parametrize("pair", A2A_PAIRS)
def test_all_to_all_matches_jax(pair):
    """all_to_all and its gradient on distinct values for each (rank,
    element) at W=4 against JAX's tiled ``lax.all_to_all``: a transposed
    chunk order shows."""
    split, concat = pair
    x, ct = _a2a_inputs()
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("sp",))

    @functools.partial(shard_map, mesh=mesh, in_specs=P("sp"),
                       out_specs=P("sp"), check_vma=False)
    def sharded(x):
        return lax.all_to_all(x[0], "sp", split, concat, tiled=True)[None]

    y, vjp = jax.vjp(jax.jit(sharded), jnp.asarray(x))
    (grad,) = vjp(jnp.asarray(ct).reshape(y.shape))
    res = _port_runs(4)
    key = f"cp/a2a/{split - 4 if split == 3 else split},{concat}"
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r[key], np.asarray(y[rank]))
        np.testing.assert_array_equal(r[f"{key}/grad"],
                                      np.asarray(grad[rank]))


# ---- api ----

API_S, API_D = 128, 16


def _api_payload():
    return {"q": _np((2, API_S, HQ, API_D), 10),
            "k": _np((2, API_S, HKV, API_D), 11),
            "v": _np((2, API_S, HKV, API_D), 12),
            "dout": _np((2, API_S, HQ, API_D), 13), "scale": 0.3,
            "kinds": [("stripe", "stripe")]}


def test_stripe_api_funcs_match_jax():
    """stripe_flash_attn_func, its gradients, lse with return_attn_probs,
    and the kv-packed form at W=4; every backward step asks block_bwd for
    fused=False under deterministic=True and fused=None by default (all 4
    steps on every rank: stripe skips none); the qkv-packed form in
    process."""
    p = _api_payload()
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("sp",))
    q, k, v, dout = (jlayouts.all_local_stripe(jnp.asarray(p[n]), 4, axis=1)
                     for n in ("q", "k", "v", "dout"))
    seq, spec3 = P(None, "sp"), P(None, None, "sp")

    @functools.partial(shard_map, mesh=mesh, in_specs=(seq,) * 3,
                       out_specs=(seq, spec3), check_vma=False)
    def sharded(q, k, v):
        out, lse, _ = japi.stripe_flash_attn_func(
            q, k, v, causal=True, softmax_scale=0.3, return_attn_probs=True,
            group="sp")
        return out, lse

    (out, lse), vjp = jax.vjp(jax.jit(sharded), q, k, v)
    grads = vjp((dout, jnp.zeros_like(lse)))
    res = _port_runs(4)

    def port(key, axis=1):
        return np.concatenate([r[f"api/stripe/{key}"] for r in res],
                              axis=axis)

    assert _err(port("func"), out) <= OUT_TOL
    assert _err(port("kvpacked"), out) <= OUT_TOL
    assert _err(port("lse", axis=2), lse) <= OUT_TOL
    for key, ref in zip(("dq", "dk", "dv"), grads):
        assert _err(port(key), ref) <= GRAD_TOL
    for rank, r in enumerate(res):
        assert r["api/stripe/fused"] == {
            "default": [None] * 4, "deterministic": [False] * 4,
            "kvpacked deterministic": [False] * 4}, rank
    qkv = _np((1, 32, 3, 2, API_D), 14)
    got = api.stripe_flash_attn_qkvpacked_func(torch.from_numpy(qkv),
                                               causal=True)
    want = japi.flash_attn_qkvpacked_func(jnp.asarray(qkv), causal=True)
    assert _err(got, want) <= OUT_TOL


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("form", ["func", "kvpacked_func", "qkvpacked_func"])
def test_stripe_deterministic_reaches_block_bwd(form, deterministic,
                                                monkeypatch):
    """``deterministic=True`` on a stripe entry point reaches the step
    loop's ``block_bwd`` as ``fused=False`` (the split kernels B3a/B3b on
    the card), the default as ``fused=None``; one process, no group (W=1),
    where the gradient is the JAX flash function's."""
    from ring_flash_attn_tpu_torch.parallel import ring as tring

    seen = []
    real = tring.block_bwd

    def recorder(*args, fused=None, **kw):
        seen.append(fused)
        return real(*args, fused=fused, **kw)

    monkeypatch.setattr(tring, "block_bwd", recorder)
    qkv = _np((1, 32, 3, 2, API_D), 30)
    x = torch.from_numpy(qkv).requires_grad_()
    func = getattr(api, f"stripe_flash_attn_{form}")
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


# ---- registry at W=1 ----


@pytest.mark.parametrize("impl", ["stripe", "ulysses"])
def test_registry_entry_of_one_process_equals_flash(impl):
    """With no process group the entry equals the flash entry, forward and
    gradients; stripe is causal-only, Ulysses takes a non-causal call."""
    assert impl in list_attention()
    assert get_attention(impl) is not None
    q, k, v = (torch.from_numpy(_np((1, 32, h, 16), i)).requires_grad_()
               for i, h in enumerate((HQ, HKV, HKV)))
    dout = torch.from_numpy(_np((1, 32, HQ, 16), 5))
    for causal in (True, False):
        if impl == "stripe" and not causal:
            with pytest.raises(ValueError, match="causal"):
                RingAttentionLayer(impl, causal=False)(q, k, v)
            continue
        ref = RingAttentionLayer("flash", causal=causal)(q, k, v)
        got = RingAttentionLayer(impl, causal=causal, scale=16**-0.5)(q, k, v)
        assert _err(got.detach(), ref.detach()) <= OUT_TOL
        for a, b in zip(torch.autograd.grad(got, (q, k, v), dout),
                        torch.autograd.grad(ref, (q, k, v), dout)):
            assert _err(a, b) <= GRAD_TOL


# ---- what raised before its slice computes; what is not allowed raises


def _vs_flash(fn, **jax_kw):
    """A call of the (B, H, S, D) schedule ``fn`` in one process (W=1) and
    JAX's flash_attn_func with ``jax_kw`` on the same inputs: (got, want),
    both (B, S, H, D)."""
    def call(q, k, v):
        got = fn(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)))
        want = japi.flash_attn_func(*map(jnp.asarray, (q, k, v)), **jax_kw)
        return got[0].transpose(1, 2), want

    return call


@pytest.mark.parametrize("call,error,match", [
    (lambda q: api.stripe_flash_attn_func(q, q, q, causal=False),
     ValueError, "causal"),
    # ALiBi on stripe is ported (softcap/ALiBi slice): dropout with it
    (_vs_flash(lambda q, k, v: stripe_attention(
        q, k, v, scale=1.0, alibi_slopes=np.ones(2), dropout_p=0.1),
        causal=True, softmax_scale=1.0, alibi_slopes=np.ones(2),
        dropout_p=0.1), None, None),
    (_vs_flash(lambda q, k, v: stripe_attention(
        q, k, v, scale=1.0, dropout_p=0.1),
        causal=True, softmax_scale=1.0, dropout_p=0.1), None, None),
    (_vs_flash(lambda q, k, v: stripe_attention(
        q, k, v, scale=1.0, window_left=4),
        causal=True, softmax_scale=1.0, window_size=(4, 0)), None, None),
    (_vs_flash(lambda q, k, v: (api.stripe_flash_attn_func(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=True,
        window_size=(4, 0)).transpose(1, 2),),
        causal=True, window_size=(4, 0)), None, None),
    (_vs_flash(lambda q, k, v: ulysses_attention(
        q, k, v, scale=1.0, causal=True, dropout_p=0.1),
        causal=True, softmax_scale=1.0, dropout_p=0.1), None, None),
    (lambda q: usp_attention(q, q, q, scale=1.0, causal=False,
                             variant="stripe"),
     ValueError, "causal"),
    (lambda q: usp_attention(q, q, q, scale=1.0, causal=True,
                             variant="llama3"),
     ValueError, "variant"),
    (lambda q: RingAttentionLayer("ulysses")(q, q, q, window_left=4),
     ValueError, "window"),
])
def test_unported_or_invalid_options_raise(call, error, match):
    """What is not allowed raises; the stripe and Ulysses options that
    raised before the window/dropout slice (dropout, with ALiBi too, and
    a causal window) compute, in one process, JAX's flash_attn_func's
    values (``error`` None)."""
    if error is None:
        got, want = call(*(_np((1, 8, 2, 16), s) for s in range(3)))
        assert _err(got.detach(), want) <= OUT_TOL
        return
    with pytest.raises(error, match=match):
        call(torch.zeros(1, 2, 8, 16))


def test_ulysses_needs_q_heads_divisible_by_the_group():
    """Hq % W != 0 raises before any collective; so does an Hkv that
    neither divides nor is divided by W. The check reads the group's size,
    so it is shown on a gloo group of 4 and on one process."""
    for r in _port_runs(4):
        assert "divisible" in r["ulysses_heads/hq"]
        assert "neither" in r["ulysses_heads/hkv"]


# ---- train_step with stripe and USP ----


def _train_batches():
    tokens = np.random.default_rng(7).integers(
        0, CFG_KW["vocab"], size=(2, TRAIN_S)).astype(np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], np.full_like(tokens[:, :1], -100)], axis=1)
    stripe = [np.asarray(jlayouts.all_local_stripe(jnp.asarray(x), 4,
                                                   axis=1))
              for x in (tokens, labels)]
    pos = np.concatenate([jlayouts.stripe_position_ids(r, 4, TRAIN_S // 4)
                          for r in range(4)])
    return {"stripe": (*stripe, pos),
            "usp": (tokens, labels, np.arange(TRAIN_S, dtype=np.int32))}


def _train_payload():
    return {"cfg": CFG_KW, "lr": LR, "dp": 1, "wu": 2,
            "params": jax.tree.map(np.asarray, _jparams()),
            "batches": _train_batches()}


def _jax_train(kind, batch):
    cfg = JaxConfig(attention=kind, **CFG_KW)
    devs = np.array(jax.devices("cpu")[:4])
    if kind == "usp":
        mesh, axes = Mesh(devs.reshape(2, 2), ("sp", "hp")), ("sp", "hp")
        kw = dict(axis_name="sp", ulysses_axis="hp")
    else:
        mesh, axes = Mesh(devs, ("sp",)), "sp"
        kw = dict(axis_name="sp")

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(None, axes), P(None, axes), P(axes)),
        out_specs=(P(), P()), check_vma=False)
    def step(params, tokens, labels, pos):
        return jtransformer.train_step(params, cfg, tokens, labels, pos,
                                       lr=LR, **kw)

    return jax.jit(step)(_jparams(), *map(jnp.asarray, batch))


@pytest.mark.parametrize("kind", ["stripe", "usp"])
def test_train_step_matches_jax(kind):
    """One SGD step: stripe over a sequence group of 4, USP on a 2 x 2 grid
    (the ring over 2, the all-to-all over 2); the loss and every updated
    parameter, the same on every rank."""
    new, jloss = _jax_train(kind, _train_batches()[kind])
    for out in _port_runs(4):
        assert abs(float(out[f"train/{kind}/loss"]) - float(jloss)) \
            <= LOSS_TOL
        _check_params(out, f"train/{kind}", new)


def test_usp_model_needs_a_ulysses_group():
    tree = jax.tree.map(np.asarray, _jparams())
    model = params_from_jax(tree, ModelConfig(attention="usp", **CFG_KW),
                            device="cpu")
    toks = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="ulysses_group"):
        loss_fn(model, toks, toks, torch.arange(16), sp_group=None)
