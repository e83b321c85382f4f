"""The port's tensor parallelism, switch MoE with expert parallelism,
llama3's backward and ``reduce_scatter`` against the JAX package's on
identical numpy inputs, on the CPU, in float32 at JAX's own test sizes:
``moe_mlp`` (in process, and over an ep group of 2), the Megatron forward
and ``train_step`` on a 2 x 4 (tp, sp) grid, the MoE ``train_step`` on a
2 x 4 (ep, sp) grid and in one process with the aux loss,
``shard_params`` against ``param_specs``' tiling, ``llama3_attention``'s
gradients and ``train_step(attention="llama3")``.

The port runs in spawned gloo processes (``torch_dist_workers.py``), one
set at each of W=2, 4 and 8; the JAX functions run under ``shard_map``
over the same number of virtual CPU devices, as ``tests/test_moe.py`` and
``tests/test_model.py`` run them. On the CPU the port's block calls run
the plain versions of kernels B1 and B2/B3; JAX runs its XLA path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_workers as workers
from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import moe as jmoe
from ring_flash_attn_tpu.models import transformer as jtransformer
from ring_flash_attn_tpu.parallel import llama3 as jllama3
from ring_flash_attn_tpu_torch import RingAttentionLayer
from ring_flash_attn_tpu_torch.models import (
    ModelConfig, MoELayer, init_params, moe_mlp, param_specs,
    params_from_jax, shard_params, train_step)
from test_torch_ring import (
    CFG_KW, LR, PARAM_TOL, _batches, _check_params, _err, _jax_train,
    _jparams, _np, _tokens)

# tests/test_moe.py's sizes
MB, MS, MD, MMLP, ME, EP = 2, 16, 32, 64, 4, 2
MOE_TOL = 1e-5
LOGITS_TOL, LOSS_TOL = 2e-4, 1e-5  # tests/test_model.py's TP tolerances
MOE_CFG = dict(vocab=128, dim=32, layers=2, heads=4, kv_heads=2,
               head_dim=8, mlp_dim=64, attention="zigzag", dtype="float32",
               moe_experts=4)
GRID_S = 64  # tests/test_model.py's S
# llama3: test_torch_generate.py's shapes (GQA group 2) and tolerance
L3 = dict(q=(2, 4, 128, 16), kv=(2, 2, 128, 16), scale=0.25)
L3_TOL = 1e-4
L3_VARIANTS = {"causal": {"causal": True},
               "stride1": {"causal": True, "heads_k_stride": 1},
               "full": {"causal": False}}
RS_DIMS = (0, 1, -1)


def _mesh(world, shape=None, names=("sp",)):
    devs = np.array(jax.devices("cpu")[:world])
    return Mesh(devs.reshape(shape or (world,)), names)


# ---- payloads: one set of processes per world size ----


@functools.lru_cache(maxsize=None)
def _moe_layer_np():
    layer = jmoe.init_moe_layer(jax.random.PRNGKey(0), MD, MMLP, ME,
                                jnp.float32)
    return {k: np.array(v) for k, v in layer.items()}  # writable


def _moe_payload():
    p = dict(_moe_layer_np(), d=MD, mlp=MMLP, e=ME, cap=MB * MS,
             norm=np.ones(MD, np.float32))
    p["x"], p["dout"] = _np((EP * MB, MS, MD), 20), _np((EP * MB, MS, MD), 21)
    return p


def _l3_payload():
    return {"q": _np(L3["q"], 30), "k": _np(L3["kv"], 31),
            "v": _np(L3["kv"], 32), "dout": _np(L3["q"], 33),
            "scale": L3["scale"], "variants": L3_VARIANTS}


def _rs_payload(world):
    return {"x": _np((world, 2 * world, 4 * world, world), 40 + world),
            "dims": RS_DIMS}


def _l3_train_payload():
    return {"cfg": CFG_KW, "lr": LR, "dp": 1,
            "params": jax.tree.map(np.asarray, _jparams()),
            "batches": {"llama3": _batches(_tokens(2), 4)["ring"]}}


@functools.lru_cache(maxsize=None)
def _tp_batch():
    tokens = np.random.default_rng(50).integers(
        0, CFG_KW["vocab"], size=(1, GRID_S)).astype(np.int32)
    return [np.asarray(x) for x in jtransformer.prepare_zigzag_batch(
        jnp.asarray(tokens), 4)]


@functools.lru_cache(maxsize=None)
def _moe_params():
    return jtransformer.init_params(jax.random.PRNGKey(0),
                                    JaxConfig(**_moe_cfg(8.0)))


def _moe_cfg(factor):
    return dict(MOE_CFG, moe_capacity_factor=factor)


@functools.lru_cache(maxsize=None)
def _moe_batch():
    tokens = np.random.default_rng(51).integers(
        0, MOE_CFG["vocab"], size=(EP, 32)).astype(np.int32)
    return [np.asarray(x) for x in jtransformer.prepare_zigzag_batch(
        jnp.asarray(tokens), 4)]


def _grid_payload():
    t_l, l_l, pos = _tp_batch()
    tp = {"cfg": CFG_KW, "lr": LR, "tokens": t_l, "labels": l_l, "pos": pos,
          "params": jax.tree.map(np.asarray, _jparams())}
    t_l, l_l, pos = _moe_batch()
    moe = {"cfg": _moe_cfg(8.0), "lr": LR, "tokens": t_l, "labels": l_l,
           "pos": pos, "params": jax.tree.map(np.asarray, _moe_params())}
    return {"tp": tp, "moe": moe}


@functools.lru_cache(maxsize=None)
def _port_runs(world):
    """Every task of this file at ``world`` in one set of processes."""
    payloads = {"reduce_scatter": _rs_payload(world)} if world < 8 else {}
    if world == 2:
        payloads.update(moe_ep=_moe_payload(), llama3=_l3_payload())
    elif world == 4:
        payloads.update(llama3=_l3_payload(), train=_l3_train_payload())
    else:
        payloads["grid"] = _grid_payload()
    return workers.run_ranks("all", world, payloads)


# ---- 1. moe_mlp in one process ----


def _moe_torch_layer(layer_np):
    layer = MoELayer(MD, MMLP, ME, torch.float32, "cpu")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(layer_np[name]))
    return layer


@pytest.mark.parametrize("cap", [EP * MB * MS, 2])
def test_moe_mlp_matches_jax(cap):
    """out, the aux statistics and the gradients of x, the router and the
    three expert stacks (through out and through probsum, as a trainer's
    aux loss reaches the router) at ample capacity and at capacity 2,
    where most tokens drop."""
    layer_np = _moe_layer_np()
    x, dout = _np((EP * MB, MS, MD), 20), _np((EP * MB, MS, MD), 21)
    norm = np.ones(MD, np.float32)
    w = np.arange(ME, dtype=np.float32)

    def jfn(layer, x):
        out, (count, probsum) = jmoe.moe_mlp(x, layer, jnp.asarray(norm), cap,
                                             return_aux=True)
        return jnp.sum(out * dout) + jnp.sum(probsum * w), (out, count,
                                                            probsum)

    (_, (jout, jcount, jprob)), (jgl, jgx) = jax.value_and_grad(
        jfn, (0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, layer_np), jnp.asarray(x))
    layer = _moe_torch_layer(layer_np)
    xt = torch.from_numpy(x).requires_grad_()
    out, (count, probsum) = moe_mlp(xt, layer, torch.from_numpy(norm), cap,
                                    return_aux=True)
    loss = (out * torch.from_numpy(dout)).sum() + (
        probsum * torch.from_numpy(w)).sum()
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(loss, [xt, *layer.parameters()])
    assert _err(out.detach(), jout) <= MOE_TOL
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert _err(probsum.detach(), jprob) <= MOE_TOL
    assert _err(grads[0], jgx) <= MOE_TOL
    for name, g in zip(names, grads[1:]):
        assert _err(g, jgl[name]) <= MOE_TOL, name
    if cap == 2:  # the drops happened, and left the residual alone
        assert int(np.asarray(jcount).max()) > cap
        kept = torch.from_numpy(x).reshape(-1, MD) != out.detach().reshape(
            -1, MD)
        assert int(kept.any(-1).sum()) <= ME * cap


# ---- 2. moe_mlp over an ep group of 2 ----


def test_moe_ep_matches_jax():
    """moe_mlp with ep_group at W=2 over gloo against JAX's EP shard_map
    (tests/test_moe.py): out, the gradients of x, of each rank's experts
    and of the router summed over the ranks; the aux statistics."""
    p = _moe_payload()
    layer = jax.tree.map(jnp.asarray, _moe_layer_np())
    norm, cap = jnp.asarray(p["norm"]), p["cap"]
    specs = {"router": P(), "we_gate": P("ep"), "we_up": P("ep"),
             "we_down": P("ep")}

    @functools.partial(shard_map, mesh=_mesh(EP, names=("ep",)),
                       in_specs=(specs, P("ep"), P("ep")),
                       out_specs=(P("ep"), P("ep"), specs, P("ep")),
                       check_vma=False)
    def run(layer, x, dout):
        def loss(layer, x):
            out = jmoe.moe_mlp(x, layer, norm, cap, ep_axis="ep")
            return jnp.sum(out * dout), out

        (_, out), (gl, gx) = jax.value_and_grad(loss, (0, 1),
                                                has_aux=True)(layer, x)
        _, (count, probsum) = jmoe.moe_mlp(x, layer, norm, cap, ep_axis="ep",
                                           return_aux=True)
        gl = dict(gl, router=lax.psum(gl["router"], "ep"))
        return out, gx, gl, jnp.stack([count, probsum])[None]

    out, gx, gl, stats = jax.jit(run)(layer, jnp.asarray(p["x"]),
                                      jnp.asarray(p["dout"]))
    res = _port_runs(2)

    def cat(key):
        return np.concatenate([r[f"moe_ep/{key}"] for r in res])

    assert _err(cat("out"), out) <= MOE_TOL
    assert _err(cat("dx"), gx) <= MOE_TOL
    for name in ("we_gate", "we_up", "we_down"):
        assert _err(cat(f"d{name}"), gl[name]) <= MOE_TOL, name
    router = sum(r["moe_ep/drouter"] for r in res)
    assert _err(router, gl["router"]) <= MOE_TOL
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["moe_ep/count"], stats[rank, 0])
        assert _err(r["moe_ep/probsum"], stats[rank, 1]) <= MOE_TOL


# ---- 3. tensor parallelism on a 2 x 4 (tp, sp) grid ----


def _jax_tp(fn, out_params):
    """JAX's ``fn`` (forward or train_step) under shard_map on the (tp, sp)
    grid with the weights tiled by ``param_specs``."""
    cfg = JaxConfig(**CFG_KW)
    specs = jtransformer.param_specs(cfg, "tp")
    seq = P(None, "sp")
    outs = (specs, P()) if out_params else seq
    return jax.jit(shard_map(
        functools.partial(fn, cfg=cfg), mesh=_mesh(8, (2, 4), ("tp", "sp")),
        in_specs=(specs, seq, seq, P("sp")), out_specs=outs,
        check_vma=False))


def _gathered(res, prefix, cfg, ranks, group):
    """{name: the whole parameter} from the given ranks' shards (in rank
    order of their tp or ep group), split as ``param_specs`` says."""
    specs = param_specs(cfg)
    out = {}
    for name, spec in specs.items():
        parts = [res[r][f"{prefix}/{name}"] for r in ranks]
        if spec is None or spec[0] != group:
            out[name] = parts[0]
        else:
            out[name] = np.concatenate(parts, axis=spec[1])
    return out


def test_tp_forward_matches_jax():
    """Logits of every rank on the (tp, sp) grid against JAX's
    ``forward(tp_axis="tp")``: the zigzag shards in rank order, the same
    on both tp ranks."""
    t_l, _, pos = _tp_batch()

    def fwd(params, tokens, labels, pos, cfg):
        del labels
        return jtransformer.forward(params, cfg, tokens, pos,
                                    axis_name="sp", tp_axis="tp")

    want = _jax_tp(fwd, False)(_jparams(), *map(jnp.asarray,
                                               (t_l, t_l, pos)))
    res = _port_runs(8)
    for tp_rank in range(2):
        got = np.concatenate([res[tp_rank * 4 + s]["grid/tp/logits"]
                              for s in range(4)], axis=1)
        assert _err(got, want) <= LOGITS_TOL, tp_rank


def test_tp_train_step_matches_jax():
    """One SGD step on the (tp, sp) grid against JAX's ``train_step`` with
    ``tp_axis``: the loss on every rank, every updated parameter gathered
    back to its full shape from the tp ranks' shards (on every sp rank)."""
    t_l, l_l, pos = _tp_batch()

    def step(params, tokens, labels, pos, cfg):
        return jtransformer.train_step(params, cfg, tokens, labels, pos,
                                       lr=LR, axis_name="sp", tp_axis="tp")

    new, jloss = _jax_tp(step, True)(_jparams(),
                                     *map(jnp.asarray, (t_l, l_l, pos)))
    res = _port_runs(8)
    cfg = ModelConfig(**CFG_KW)
    for r in res:
        assert abs(float(r["grid/tp/loss"]) - float(jloss)) <= LOSS_TOL
    for s in range(4):
        whole = _gathered(res, "grid/tp", cfg, (s, s + 4), "tp")
        _check_params({f"p/{n}": x for n, x in whole.items()}, "p", new)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_match_param_specs(tp):
    """Every leaf of ``shard_params(tree, tp_rank=r, tp=tp)`` equals rank
    r's shard of the JAX tree as ``param_specs`` tiles it over a tp mesh
    (``NamedSharding``, the tiling ``shard_map`` hands its body)."""
    kw = dict(CFG_KW, heads=8, kv_heads=4)
    jcfg = JaxConfig(**kw)
    params = jtransformer.init_params(jax.random.PRNGKey(3), jcfg)
    specs = jtransformer.param_specs(jcfg, "tp")
    mesh = _mesh(tp, names=("tp",))
    placed = jax.tree.map(
        lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec)),
        params, specs)
    flat = {"embed": placed["embed"], "final_norm": placed["final_norm"],
            "lm_head": placed["lm_head"]}
    for i, layer in enumerate(placed["layers"]):
        flat.update({f"layers.{i}.{n}": x for n, x in layer.items()})
    tree = jax.tree.map(np.asarray, params)
    devices = list(mesh.devices.flat)
    for rank in range(tp):
        model = shard_params(tree, ModelConfig(**kw), tp_rank=rank, tp=tp,
                             device="cpu")
        got = dict(model.named_parameters())
        assert set(got) == set(flat)
        for name, arr in flat.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(got[name].detach().numpy(),
                                          np.asarray(shard.data), name)


def test_tp_shards_are_checked():
    """A width that does not split over tp raises; so does a shard run
    over a tp group of another size (here one process: tp=1)."""
    tree = jax.tree.map(np.asarray, _jparams())
    cfg = ModelConfig(**CFG_KW)
    with pytest.raises(ValueError, match="split"):
        shard_params(tree, cfg, tp_rank=0, tp=3, device="cpu")
    shard = shard_params(tree, cfg, tp_rank=1, tp=2, device="cpu")
    toks = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="shard"):
        shard(toks, torch.arange(16), tp_group=None)


# ---- 4. the MoE transformer's train step ----


def test_moe_train_step_on_ep_sp_grid_matches_jax():
    """One MoE ``train_step`` on the (ep, sp) grid (capacity factor 8,
    drop-free; aux weight 0.01) against JAX's on the same grid
    (tests/test_moe.py): the loss on every rank and every parameter, the
    experts gathered from the ep ranks."""
    t_l, l_l, pos = _moe_batch()
    cfg = JaxConfig(**_moe_cfg(8.0))
    moe_specs = {"router": P(), "we_gate": P("ep"), "we_up": P("ep"),
                 "we_down": P("ep")}
    layer = {"attn_norm": P(), "wq": P(), "wk": P(), "wv": P(), "wo": P(),
             "mlp_norm": P(), "moe": moe_specs}
    specs = {"embed": P(), "layers": [dict(layer) for _ in range(2)],
             "final_norm": P(), "lm_head": P()}

    @functools.partial(
        shard_map, mesh=_mesh(8, (2, 4), ("ep", "sp")),
        in_specs=(specs, P("ep", "sp"), P("ep", "sp"), P("sp")),
        out_specs=(specs, P()), check_vma=False)
    def step(params, t, l, pos):
        return jtransformer.train_step(params, cfg, t, l, pos, lr=LR,
                                       axis_name="sp", ep_axis="ep")

    new, jloss = jax.jit(step)(_moe_params(),
                               *map(jnp.asarray, (t_l, l_l, pos)))
    res = _port_runs(8)
    for r in res:
        assert abs(float(r["grid/moe/loss"]) - float(jloss)) <= LOSS_TOL
    flat = {"embed": new["embed"], "final_norm": new["final_norm"],
            "lm_head": new["lm_head"]}
    for i, lyr in enumerate(new["layers"]):
        for n, x in lyr.items():
            if n == "moe":
                flat.update({f"layers.{i}.moe.{m}": y for m, y in x.items()})
            else:
                flat[f"layers.{i}.{n}"] = x
    for s in range(4):
        whole = _gathered(res, "grid/moe", ModelConfig(**_moe_cfg(8.0)),
                          (s, s + 4), "ep")
        assert set(whole) == set(flat)
        for name, ref in flat.items():
            assert _err(whole[name], ref) <= PARAM_TOL, name


def test_moe_train_step_in_one_process_matches_jax():
    """One MoE ``train_step`` with no groups at capacity factor 2 (tokens
    drop) and aux weight 0.01 against JAX's unsharded ``train_step``: the
    loss within 1e-5, every parameter within 2e-5."""
    kw = _moe_cfg(2.0)
    jcfg = JaxConfig(**kw)
    params = jtransformer.init_params(jax.random.PRNGKey(4), jcfg)
    tokens = np.random.default_rng(52).integers(
        0, kw["vocab"], size=(2, 64)).astype(np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], np.full_like(tokens[:, :1], -100)], axis=1)
    pos = np.arange(64, dtype=np.int32)
    new, jloss = jax.jit(functools.partial(
        jtransformer.train_step, cfg=jcfg, lr=LR))(
        params, tokens=jnp.asarray(tokens), labels=jnp.asarray(labels),
        positions=jnp.asarray(pos))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**kw), device="cpu")
    _, loss = train_step(model, torch.from_numpy(tokens).long(),
                         torch.from_numpy(labels).long(),
                         torch.from_numpy(pos).long(), lr=LR)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    got = dict(model.named_parameters())
    for i, lyr in enumerate(new["layers"]):
        for m, ref in lyr["moe"].items():
            assert _err(got[f"layers.{i}.moe.{m}"].detach(), ref) \
                <= PARAM_TOL, m
        for n in ("wq", "wo", "attn_norm", "mlp_norm"):
            assert _err(got[f"layers.{i}.{n}"].detach(), lyr[n]) \
                <= PARAM_TOL, n
    for n in ("embed", "lm_head", "final_norm"):
        assert _err(got[n].detach(), new[n]) <= PARAM_TOL, n


def test_moe_model_init_and_tree_checks():
    """A MoE model's layers hold a ``moe`` submodule and no dense MLP; the
    router is fp32 holding values of the model dtype (drawn there, as the
    JAX init draws it); a MoE tree does not load into a dense config."""
    cfg = ModelConfig(**dict(_moe_cfg(2.0), dtype="bfloat16"))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for layer in model.layers:
        assert not hasattr(layer, "w_gate")
        moe = layer.moe
        assert moe.router.dtype == torch.float32
        assert torch.equal(moe.router, moe.router.bfloat16().float())
        assert moe.we_gate.dtype == moe.we_down.dtype == torch.bfloat16
        assert tuple(moe.we_up.shape) == (4, 32, 64)
        assert tuple(moe.we_down.shape) == (4, 64, 32)
        std = float(moe.we_down.detach().float().std())
        assert abs(std * 64**0.5 - 1.0) < 0.1  # fan_in = dim -2
    tree = jax.tree.map(np.asarray, _moe_params())
    dense = {k: v for k, v in MOE_CFG.items() if k != "moe_experts"}
    with pytest.raises(ValueError, match="one side"):
        params_from_jax(tree, ModelConfig(**dense), device="cpu")


def test_tp_with_moe_is_refused():
    """Tensor parallelism over a MoE model, for which the JAX package has
    no reference, raises naming ROADMAP.md: a tp shard of the model, and a
    whole model run with a tp group."""
    cfg = ModelConfig(**_moe_cfg(2.0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        shard_params(jax.tree.map(np.asarray, _moe_params()), cfg,
                     tp_rank=0, tp=2, device="cpu")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(toks, torch.arange(16), tp_group=None)


# ---- 5. llama3's backward ----


def test_registry_llama3_is_differentiable():
    """The registry's llama3 entry with no process group (W=1) gives the
    flash entry's out and gradients."""
    q, k, v = (torch.from_numpy(_np((2, 32, h, 16), 60 + i)).requires_grad_()
               for i, h in enumerate((4, 2, 2)))
    dout = torch.from_numpy(_np((2, 32, 4, 16), 63))
    got = RingAttentionLayer("llama3", heads_k_stride=1)(q, k, v)
    ref = RingAttentionLayer("flash")(q, k, v)
    assert _err(got.detach(), ref.detach()) <= L3_TOL
    for a, b in zip(torch.autograd.grad(got, (q, k, v), dout),
                    torch.autograd.grad(ref, (q, k, v), dout)):
        assert _err(a, b) <= L3_TOL


@pytest.mark.parametrize("variant", list(L3_VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
def test_llama3_backward_matches_jax(world, variant):
    """out, lse and the gradients of q, k and v of every rank against JAX
    ``llama3_attention`` under shard_map (B=2, GQA group 2;
    heads_k_stride Hkv and 1; causal and not)."""
    p = _l3_payload()
    seq = P(None, None, "sp")

    @functools.partial(shard_map, mesh=_mesh(world), in_specs=(seq,) * 3,
                       out_specs=(seq, seq), check_vma=False)
    def run(q, k, v):
        return jllama3.llama3_attention(q, k, v, None, scale=p["scale"],
                                        axis_name="sp", backend="xla",
                                        **L3_VARIANTS[variant])

    (out, lse), vjp = jax.vjp(jax.jit(run),
                              *(jnp.asarray(p[n]) for n in ("q", "k", "v")))
    grads = vjp((jnp.asarray(p["dout"]), jnp.zeros_like(lse)))
    res = _port_runs(world)
    for key, ref in zip(("out", "lse", "dq", "dk", "dv"),
                        (out, lse, *grads)):
        got = np.concatenate([r[f"llama3/{key}_{variant}"] for r in res],
                             axis=2)
        assert _err(got, ref) <= L3_TOL, key


def test_llama3_train_step_matches_jax():
    """``train_step(attention="llama3", sp_group=...)`` at W=4 against
    JAX's: the loss and every updated parameter on every rank."""
    new, jloss = _jax_train("llama3", 1, _batches(_tokens(2), 4)["ring"])
    for out in _port_runs(4):
        assert abs(float(out["train/llama3/loss"]) - float(jloss)) \
            <= LOSS_TOL
        _check_params(out, "train/llama3", new)


# ---- 6. reduce_scatter ----


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_matches_jax(world):
    """reduce_scatter along dims 0, 1 and -1 against ``lax.psum_scatter(...,
    tiled=True)`` under shard_map, on distinct values per rank."""
    x = _rs_payload(world)["x"]
    res = _port_runs(world)
    for dim in RS_DIMS:
        @functools.partial(shard_map, mesh=_mesh(world), in_specs=P("sp"),
                           out_specs=P("sp"), check_vma=False)
        def run(x):
            return lax.psum_scatter(x[0], "sp", scatter_dimension=dim % 3,
                                    tiled=True)[None]

        want = np.asarray(jax.jit(run)(jnp.asarray(x)))
        for rank, r in enumerate(res):
            np.testing.assert_allclose(r[f"reduce_scatter/dim{dim}"],
                                       want[rank], rtol=1e-6, atol=1e-6)
