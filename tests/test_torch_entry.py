"""The port's entry points (ring_flash_attn_tpu_torch/entry.py) against the
JAX package's entry points (``__graft_entry__.py``) on identical
inputs: ``entry()``'s flagship forward at JAX's parameters, and
``dryrun_multichip(8)``'s seven configurations in 8 spawned gloo
processes (which join with ``utils.initialize_multihost`` and cut their
meshes with ``utils.make_cp_mesh``) against the losses JAX's
``dryrun_multichip(8)`` prints and against JAX's llama3 gradients and
decode logits."""

import contextlib
import io
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import __graft_entry__ as jax_entry
from ring_flash_attn_tpu.api import llama3_flash_attn_prepare_cu_seqlens
from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models.serve import _decode_body as jax_decode_body
from ring_flash_attn_tpu.models.transformer import init_params as jax_init
from ring_flash_attn_tpu.models.transformer import param_specs as jax_specs
from ring_flash_attn_tpu.ops import paged as jpaged
from ring_flash_attn_tpu.parallel.llama3 import llama3_attention as jax_llama3
from ring_flash_attn_tpu_torch.entry import dryrun_multichip, entry

N = 8  # processes of the dry run, as JAX's virtual CPU mesh
KW = dict(vocab=128, dim=64, layers=2, heads=4, kv_heads=2, head_dim=16,
          mlp_dim=128, dtype="float32")
DECODE_KW = dict(vocab=61, dim=32, layers=2, heads=4, kv_heads=2,
                 head_dim=16, mlp_dim=64, dtype="float32")
# JAX prints the losses to 4 decimals
LOSS_TOL = 2e-4
# float32 on both sides; the llama3 gradients sum over 8 ranks' gathers and
# reduce-scatters in another order
GRAD_TOL = 1e-4


def _tree(**kw):
    cfg = JaxConfig(**kw)
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))


def _tokens(key, shape, vocab=128):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0,
                                         vocab, jnp.int32))


def _jax_inputs():
    """The inputs JAX's ``dryrun_multichip(8)`` makes
    (``__graft_entry__.py:70-75, 109-113, 153-156, 193-197, 230-233,
    262-290, 328-340``), as numpy, for the port's ``inputs=``."""
    sp = N // 2
    moe = dict(KW, attention="zigzag", moe_experts=4,
               moe_capacity_factor=4.0)
    inputs = {
        "zigzag": {"params": _tree(attention="zigzag", **KW),
                   "tokens": _tokens(1, (N // sp, 8 * sp))},
        "usp": {"params": _tree(attention="usp", **KW),
                "tokens": _tokens(2, (N // 4, 64))},
        "tp": {"params": _tree(attention="zigzag", **KW),
               "tokens": _tokens(3, (N // 4, 16))},
        "gpipe": {"params": _tree(attention="zigzag", **dict(KW, layers=4)),
                  "tokens": _tokens(4, (4, 8 * (N // 2)))},
        "moe": {"params": _tree(**moe), "tokens": _tokens(5, (2, 8 * sp))},
    }
    s7 = 8 * N
    inputs["llama3"] = {n: np.asarray(jax.random.normal(
        jax.random.PRNGKey(key), (1, h, s7, 16), jnp.float32))
        for n, key, h in (("q", 6, 4), ("k", 7, 2), ("v", 8, 2))}
    caches = []
    for li in range(2):
        c = jpaged.paged_init(2, 2, 8, 8, 4, 16, dtype=jnp.float32)
        kk = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(9), li),
                               (2, 2, 8, 16), jnp.float32)
        caches.append(jpaged.paged_prefill(c, kk, kk,
                                           jnp.asarray([6, 3], jnp.int32)))
    inputs["decode"] = {"params": _tree(**DECODE_KW),
                        "caches": [tuple(np.asarray(x) for x in c)
                                   for c in caches]}
    return inputs, caches


def _jax_llama3_grads(inputs, devices):
    """JAX's llama3 varlen forward and backward of the dry run
    (``__graft_entry__.py:254-310``): the gradients of sum(out^2)."""
    s7 = 8 * N
    mesh = Mesh(np.array(devices[:N]), ("sp",))
    cu = np.asarray([0, 10, s7], np.int32)
    segs = []
    for r in range(N):
        cu_q, cu_k, _, _, k_slice = llama3_flash_attn_prepare_cu_seqlens(
            cu, True, r, N)
        seg_local = np.searchsorted(cu_q, np.arange(8), side="right") - 1
        segs.append(k_slice.start + cu_k[seg_local])
    seg = jnp.asarray(np.concatenate(segs), jnp.int32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None, "sp", None),) * 3 + (P("sp"),),
             out_specs=P(None, None, "sp", None), check_vma=False)
    def l3(q, k, v, s):
        return jax_llama3(q, k, v, s, scale=16**-0.5, causal=True,
                          heads_k_stride=1, axis_name="sp")[0]

    def loss(q, k, v):
        return jnp.sum(l3(q, k, v, seg) ** 2)

    q, k, v = (jnp.asarray(inputs["llama3"][n]) for n in ("q", "k", "v"))
    return [np.asarray(g) for g in jax.jit(jax.grad(loss, (0, 1, 2)))(q, k, v)]


def _jax_decode_logits(caches, devices):
    """JAX's TP-sharded paged decode step of the dry run
    (``__graft_entry__.py:317-364``)."""
    cfg = JaxConfig(**DECODE_KW)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    mesh = Mesh(np.array(devices[:2]), ("tp",))
    cspec = jpaged.PagedKVCache(P(None, "tp", None, None),
                                P(None, "tp", None, None), P(), P())

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(jax_specs(cfg, "tp"), P(), P(), [cspec] * 2),
             out_specs=(P(), [cspec] * 2), check_vma=False)
    def decode(p, t, lv, cs):
        return jax_decode_body(p, cfg, t, lv, cs, tp_axis="tp")

    logits, _ = decode(params, jnp.asarray([5, 9], jnp.int32),
                       jnp.asarray([True, True]), caches)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def dryruns(devices8):
    """JAX's ``dryrun_multichip(8)`` (its printed losses), its llama3
    gradients and decode logits, and the port's ``dryrun_multichip(8,
    "cpu")`` on JAX's inputs (its printed lines and its values)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_entry.dryrun_multichip(N)
    jax_out = buf.getvalue()
    inputs, caches = _jax_inputs()
    refs = {"losses": [float(x) for x in re.findall(r"loss=([-0-9.]+)",
                                                     jax_out)],
            "llama3": _jax_llama3_grads(inputs, devices8),
            "decode": _jax_decode_logits(caches, devices8)}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got, launches = dryrun_multichip(N, "cpu", inputs=inputs,
                                         return_launches=True)
    return jax_out, refs, buf.getvalue(), got, launches


def test_dryrun_losses_match_jax(dryruns):
    """The five training steps' losses (dp 2 x sp 4 zigzag: the
    multihost counterpart of tools/multihost_smoke.py, joined by
    ``initialize_multihost``; USP on dp 2 x hp 2 x sp 2; Megatron TP on
    dp 2 x tp 2 x sp 2; GPipe on pp 2 x sp 4; switch MoE on ep 2 x sp 4)
    against the losses JAX's dry run prints, to its 4 decimals."""
    _, refs, _, got, _ = dryruns
    names = ["zigzag", "usp", "tp", "gpipe", "moe"]
    assert len(refs["losses"]) == len(names)
    for name, ref in zip(names, refs["losses"]):
        assert abs(got[name] - ref) <= LOSS_TOL, (name, got[name], ref)


def test_dryrun_prints_jax_lines(dryruns):
    """Seven lines in JAX's format, the meshes and losses as JAX prints
    them."""
    jax_out, _, port_out, _, _ = dryruns
    mine = [ln for ln in port_out.splitlines()
            if ln.startswith("dryrun_multichip")]
    theirs = [ln for ln in jax_out.splitlines()
              if ln.startswith("dryrun_multichip")]
    assert len(mine) == len(theirs) == 7
    for a, b in zip(mine, theirs):
        # the same text, the losses apart at their last printed digit
        assert re.sub(r"loss=\S+", "", a) == re.sub(r"loss=\S+", "", b)


def test_dryrun_llama3_and_decode_match_jax(dryruns):
    """llama3's gradients of q, k, v over sp = 8 and the TP decode step's
    logits: finite, and JAX's to 1e-4."""
    _, refs, _, got, launches = dryruns
    for name, ref in zip(("dq", "dk", "dv"), refs["llama3"]):
        g = got[f"llama3/{name}"]
        assert g.shape == ref.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, ref, atol=GRAD_TOL, rtol=GRAD_TOL)
    assert np.isfinite(got["decode"]).all()
    np.testing.assert_allclose(got["decode"], refs["decode"], atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    # on the CPU the plain versions run: no kernel launches
    assert sum(launches.values()) == 0


def test_dryrun_draws_its_own_inputs(capsys):
    """Without ``inputs`` (as on the card) the weights and tokens come from
    seeded generators: at n = 2 only the first configuration runs (dp 1 x
    sp 2), with a finite loss, the same in a second run."""
    first = dryrun_multichip(2, "cpu")
    assert list(first) == ["zigzag"] and np.isfinite(first["zigzag"])
    assert dryrun_multichip(2, "cpu") == first
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"dryrun_multichip(2): mesh dp=1 sp=2 "
                        f"loss={first['zigzag']:.4f} OK")


def test_dryrun_cuda_needs_the_cards():
    """``device="cuda"`` asks for a card a process: without them it
    raises rather than run elsewhere."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("a host with 64 cards")
    with pytest.raises((RuntimeError, ValueError)):
        dryrun_multichip(64, "cuda")


def test_dryrun_defaults_to_the_card():
    """As every entry point, the dry run runs on the card unless the
    caller asks for the CPU: without a card a process it raises."""
    import inspect

    default = inspect.signature(dryrun_multichip).parameters["device"]
    assert default.default == "cuda"
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("a host with 64 cards")
    with pytest.raises((RuntimeError, ValueError)):
        dryrun_multichip(64)


@pytest.mark.parametrize("tokens", ["zeros", "random"])
def test_entry_matches_jax_entry(tokens):
    """``entry(device="cpu", params=JAX's)``: the flagship forward (bf16,
    as JAX's flagship config) against JAX's ``entry()`` at JAX's
    parameters, on its zero tokens (where attention gives every row the
    one v row back) and on random ones; bf16 rounds at other places in the
    two frameworks, so the limit is max|diff| <= 2e-2 max|JAX logits|."""
    fn_j, (params, toks_j, positions) = jax_entry.entry()
    if tokens == "random":
        toks_j = jnp.asarray(np.random.default_rng(0).integers(
            0, 2048, (1, 1024)), jnp.int32)
    ref = np.asarray(jax.jit(fn_j)(params, toks_j, positions), np.float32)
    fn, (model, toks, pos) = entry(
        device="cpu", params=jax.tree.map(np.asarray, params))
    assert model.cfg.head_dim == 64 and toks.shape == (1, 1024)
    if tokens == "random":
        toks = torch.from_numpy(np.asarray(toks_j)).long()
    with torch.no_grad():
        got = fn(model, toks, pos).float().numpy()
    assert got.shape == ref.shape == (1, 1024, 2048)
    err = np.abs(got - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_entry_draws_from_a_seed():
    """Without ``params`` the weights come from a generator seeded 0: two
    calls give the same model and logits."""
    fn, (m1, toks, pos) = entry(device="cpu")
    _, (m2, _, _) = entry(device="cpu")
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    with torch.no_grad():
        out = fn(m1, toks[:, :64], pos[:64])
    assert out.shape == (1, 64, 2048) and torch.isfinite(out).all()
