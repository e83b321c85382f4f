"""The port's HF adapter (ring_flash_attn_tpu_torch.adapters.adapter)
against the JAX package's (tests/test_hf_adapter.py): torch transformers'
Llama, Mistral and Gemma patched by ``substitute_hf_flash_attn`` at W=4
ranks over gloo (tests/torch_dist_workers.py) against the JAX package's
patched Flax Llama under shard_map on the same weights and against the
unpatched torch models on the whole sequence; ``ring_attention_forward``
with softcap and through DATA_PARAMS, with its gradients; the switch; and
the HF training example's loss."""

import os
import runpy
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import ring_flash_attn_tpu as jrfa
from ring_flash_attn_tpu.adapters import adapter as jadapter
from ring_flash_attn_tpu_torch import adapters
from ring_flash_attn_tpu_torch.adapters import adapter as tadapter

from torch_dist_workers import run_ranks

transformers = pytest.importorskip("transformers")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, S = 4, 256
DOCS = (96, 160)  # the packed batch: two documents, across shards
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=S)
# a sliding window shorter than both documents, so that it matters; Gemma
# at a small head_dim and at its published configurations' 256
FAMILIES = {"Mistral": dict(SMALL, sliding_window=40),
            "Gemma": dict(SMALL, head_dim=16),
            "Gemma-hd256": dict(SMALL, head_dim=256)}


def _family(name):
    """The transformers family of a FAMILIES entry."""
    return name.split("-")[0]


def _packed():
    tokens = np.random.default_rng(1).integers(0, 128, size=(1, S))
    pos = np.concatenate([np.arange(n) for n in DOCS])[None]
    return tokens.astype(np.int64), pos.astype(np.int64)


def _case(name, model, tokens, pos):
    return {"family": _family(name), "config": model.config.to_dict(),
            "state": {n: t.detach().numpy().copy()
                      for n, t in model.state_dict().items()},
            "tokens": tokens, "pos": pos}


def _unpatched(model, tokens, pos):
    """The stock model's logits on the whole packed sequence (transformers
    finds the documents from the restarting position_ids)."""
    tadapter.use_ring_attn(False)
    try:
        with torch.no_grad():
            return model(torch.from_numpy(tokens),
                         position_ids=torch.from_numpy(pos),
                         use_cache=False).logits.numpy()
    finally:
        tadapter.use_ring_attn(True)


def _qkv(seed, h=4, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, n, d)).astype(np.float32)
            for n in (h, hkv, hkv, h)]  # q, k, v, dout


def _seg_of(cu):
    return np.searchsorted(cu, np.arange(S), side="right") - 1


def _oracle(q, k, v, dout, seg, cap=None):
    """Dense causal attention within segments, (1, S, H, D), with its
    gradients by autograd in float64."""
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (q, k, v)]
    qt, kt, vt = (x[0].transpose(0, 1) for x in leaves)
    g = qt.shape[0] // kt.shape[0]
    kt, vt = kt.repeat_interleave(g, 0), vt.repeat_interleave(g, 0)
    logits = qt @ kt.transpose(1, 2) * q.shape[-1]**-0.5
    if cap:
        logits = cap * torch.tanh(logits / cap)
    i = torch.arange(S)
    seg = torch.as_tensor(seg)
    allowed = (i[:, None] >= i[None]) & (seg[:, None] == seg[None])
    p = torch.softmax(logits.masked_fill(~allowed, float("-inf")), -1)
    out = (p @ vt).transpose(0, 1)[None]
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout).double())
    return [x.detach().numpy() for x in (out, *grads)]


@pytest.fixture(scope="module")
def hf_run(devices8):
    """The JAX references and one gloo set of W=4 processes running every
    patched model and every ``ring_attention_forward`` case."""
    from transformers import LlamaConfig
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model)
    from transformers.models.llama.modeling_flax_llama import (
        FlaxLlamaForCausalLM)

    tokens, pos = _packed()
    mesh = Mesh(np.array(devices8[:W]), ("sp",))
    jrfa.substitute_hf_flash_attn(process_group="sp")
    jadapter.use_ring_attn(True)

    # Llama: the JAX package's patched Flax model, its weights carried over
    flax_model = FlaxLlamaForCausalLM(LlamaConfig(**SMALL),
                                      dtype=jnp.float32, seed=0)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(None, "sp"), P(None, "sp"), P(None, "sp")),
             out_specs=P(None, "sp"), check_vma=False)
    def sharded(params, toks, mask, pos_):
        return flax_model.module.apply({"params": params}, toks, mask,
                                       pos_)[0]

    jax_logits = np.asarray(jax.jit(sharded)(
        flax_model.params, jnp.asarray(tokens, jnp.int32),
        jnp.ones((1, S), jnp.int32), jnp.asarray(pos, jnp.int32)))
    models = {"Llama": transformers.LlamaForCausalLM(LlamaConfig(**SMALL))}
    load_flax_weights_in_pytorch_model(models["Llama"], flax_model.params)
    torch.manual_seed(0)
    for name, kw in FAMILIES.items():
        family = _family(name)
        models[name] = getattr(transformers, f"{family}ForCausalLM")(
            getattr(transformers, f"{family}Config")(**kw))
    models = {n: m.float().eval() for n, m in models.items()}
    unpatched = {n: _unpatched(m, tokens, pos) for n, m in models.items()}

    # ring_attention_forward: softcap on position_ids, and DATA_PARAMS
    q, k, v, dout = _qkv(0)
    cu_a, cu_b = np.array([0, 96, S]), np.array([0, 192, S])
    forward = {
        "softcap": (q, k, v, dout, {"position_ids": pos, "softcap": 10.0}),
        "data_a": (q, k, v, dout, {"cu_seqlens": cu_a}),
        "data_b": (q, k, v, dout, {"cu_seqlens": cu_b,
                                   "global_segids": True}),
    }

    @partial(shard_map, mesh=mesh, in_specs=(P(None, "sp"),) * 4,
             out_specs=P(None, "sp"), check_vma=False)
    def jax_softcap(q_, k_, v_, pos_):
        return jadapter.ring_attention_forward(q_, k_, v_, causal=True,
                                               position_ids=pos_,
                                               softcap=10.0)

    @partial(shard_map, mesh=mesh, in_specs=(P(None, "sp"),) * 3 + (P(),),
             out_specs=P(None, "sp"), check_vma=False)
    def jax_traced(q_, k_, v_, segids):
        return jadapter.ring_attention_forward(q_, k_, v_, causal=True,
                                               global_segids=segids)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jax_out = {"softcap": jax_softcap(jq, jk, jv, jnp.asarray(pos, jnp.int32))}
    for name, cu in (("data_a", cu_a), ("data_b", cu_b)):
        jrfa.update_ring_flash_attn_params(cu, group="sp")
        jax_out[name] = jax.jit(jax_traced)(
            jq, jk, jv, jrfa.current_ring_params()["global_segids"])
    oracles = {"softcap": _oracle(q, k, v, dout, _seg_of(np.array(
        [0, *np.cumsum(DOCS)])), cap=10.0),
               "data_a": _oracle(q, k, v, dout, _seg_of(cu_a)),
               "data_b": _oracle(q, k, v, dout, _seg_of(cu_b))}

    res = run_ranks("hf", W, {
        "models": {n: _case(n, m, tokens, pos) for n, m in models.items()},
        "forward": forward})
    return res, jax_logits, unpatched, jax_out, oracles


def _cat(res, key):
    return np.concatenate([r[key] for r in res], axis=1)


def test_patched_llama_matches_jax_and_unpatched(hf_run):
    """The patched torch Llama at W=4 (each rank its 64 tokens and their
    position_ids) against the JAX package's patched Flax Llama under
    shard_map on the same weights, and against the stock torch model on
    the whole packed sequence."""
    res, jax_logits, unpatched, _, _ = hf_run
    got = _cat(res, "Llama/logits")
    assert got.shape == (1, S, 128)
    np.testing.assert_allclose(got, jax_logits, atol=2e-4)
    np.testing.assert_allclose(got, unpatched["Llama"], atol=2e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_patched_families_match_unpatched(hf_run, family):
    """Mistral (a 40-token sliding window, which the route passes on as
    window_left 39) and Gemma (head_dim 16, and 256 as Gemma-2B and
    Gemma-7B have it) patched at W=4 against the stock models on the
    whole packed sequence."""
    res, _, unpatched, _, _ = hf_run
    np.testing.assert_allclose(_cat(res, f"{family}/logits"),
                               unpatched[family], atol=2e-5)


@pytest.mark.parametrize("name", ["softcap", "data_a", "data_b"])
def test_ring_attention_forward_matches_jax(hf_run, name):
    """``ring_attention_forward`` at W=4: softcap 10 with position_ids, the
    DATA_PARAMS labels of one packing, and ``current_ring_params()``'s
    labels of another: out against the JAX adapter under shard_map, out
    and the gradients against a dense float64 oracle."""
    res, _, _, jax_out, oracles = hf_run
    out = _cat(res, f"{name}/out")
    np.testing.assert_allclose(out, np.asarray(jax_out[name]), atol=2e-5)
    for key, ref in zip(("out", "dq", "dk", "dv"), oracles[name]):
        np.testing.assert_allclose(_cat(res, f"{name}/{key}"), ref,
                                   atol=2e-5, err_msg=key)


def test_switch_and_position_ids_reach_the_override(monkeypatch):
    """In one process (a world of one): the route reaches
    ``ring_attention_forward`` with each layer's position_ids while the
    switch is on, and the patched model is bit for bit the stock one
    while it is off."""
    from transformers import LlamaConfig

    tokens, pos = _packed()
    torch.manual_seed(2)
    model = transformers.LlamaForCausalLM(LlamaConfig(**SMALL)).eval()
    stock = _unpatched(model, tokens, pos)
    adapters.substitute_hf_flash_attn()
    seen = []
    override = tadapter.ring_attention_forward

    def recording(*args, **kw):
        seen.append(kw.get("position_ids"))
        return override(*args, **kw)

    monkeypatch.setattr(tadapter, "ring_attention_forward", recording)
    with torch.no_grad():
        on = model(torch.from_numpy(tokens), position_ids=torch.from_numpy(
            pos), use_cache=False).logits.numpy()
    assert len(seen) == SMALL["num_hidden_layers"]
    for p in seen:
        assert torch.equal(p, torch.from_numpy(pos))
    np.testing.assert_allclose(on, stock, atol=2e-5)
    adapters.use_ring_attn(False)
    try:
        with torch.no_grad():
            off = model(torch.from_numpy(tokens),
                        position_ids=torch.from_numpy(pos),
                        use_cache=False).logits.numpy()
    finally:
        adapters.use_ring_attn(True)
    assert len(seen) == SMALL["num_hidden_layers"]
    np.testing.assert_array_equal(off, stock)


def test_hf_train_example_loss_decreases(monkeypatch):
    """``examples/train_hf_ring.py`` trains a Llama-3.2-shaped model at W=2
    gloo ranks through the adapter; the loss falls (it asserts so)."""
    monkeypatch.setattr(sys, "argv", ["train_hf_ring.py", "--steps", "6",
                                      "--seq-len", "128", "--world", "2",
                                      "--device", "cpu"])
    runpy.run_path(os.path.join(ROOT, "ring_flash_attn_tpu_torch",
                                "examples", "train_hf_ring.py"),
                   run_name="__main__")
