"""The port's training path and single-device API against the JAX
package's on identical numpy inputs, in float32 on the CPU.

On the CPU the port's flash attention runs the plain versions of kernels
B1 (forward) and B2/B3a/B3b (backward); the JAX side runs its XLA path.
The kernels are held against the same plain versions on the card
(chip_smoke.py and tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu import api as japi
from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models.transformer import init_params as jax_init
from ring_flash_attn_tpu.models.transformer import loss_fn as jax_loss_fn
from ring_flash_attn_tpu.models.transformer import (
    train_step as jax_train_step)
from ring_flash_attn_tpu_torch import api
from ring_flash_attn_tpu_torch.models import (
    ModelConfig,
    loss_fn,
    params_from_jax,
    train_step,
)
from ring_flash_attn_tpu_torch.models.serve import _prefill_fn
from ring_flash_attn_tpu_torch.ops import flash as tflash

TOL = 1e-5
GRAD_TOL = 5e-5  # the JAX backward tests' tolerance (tests/test_ops.py)
# tests/test_model.py's configuration, single device
CFG_KW = dict(vocab=128, dim=64, layers=2, heads=4, kv_heads=2, head_dim=16,
              mlp_dim=128, dtype="float32")
S = 64


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol):
    a, b = t.detach().numpy(), np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, err


# ---- api ----

B, SQ, HQ, HKV, D = 2, 32, 4, 2, 16


def _api_inputs(variant):
    """Positional numpy inputs of api.<variant> in (B, S, H, D)."""
    if variant == "qkvpacked":
        return [_np((B, SQ, 3, HQ, D), 0)]
    q = _np((B, SQ, HQ, D), 0)
    if variant == "kvpacked":
        return [q, _np((B, SQ, 2, HKV, D), 1)]
    return [q, _np((B, SQ, HKV, D), 1), _np((B, SQ, HKV, D), 2)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("variant", ["func", "kvpacked", "qkvpacked"])
def test_flash_attn_funcs_match_jax(variant, causal):
    """Forward and gradients of the three single-device entry points."""
    name = f"flash_attn_{variant}_func".replace("_func_func", "_func")
    jfn, tfn = getattr(japi, name), getattr(api, name)
    xs = _api_inputs(variant)
    dout = _np((B, SQ, HQ, D), 3)
    kw = dict(causal=causal, softmax_scale=0.3)

    def jloss(*args):
        return jnp.sum(jfn(*args, **kw) * dout)

    jout = jfn(*map(jnp.asarray, xs), **kw)
    jgrads = jax.grad(jloss, tuple(range(len(xs))))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    out = tfn(*ts, **kw)
    tgrads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), ts)
    _close(out, jout, TOL)
    for t, j in zip(tgrads, jgrads):
        _close(t, j, GRAD_TOL)


def test_flash_attn_func_return_attn_probs():
    xs = _api_inputs("func")
    jout, jlse, jp = japi.flash_attn_func(*map(jnp.asarray, xs), causal=True,
                                          return_attn_probs=True)
    out, lse, p = api.flash_attn_func(*map(torch.from_numpy, xs),
                                      causal=True, return_attn_probs=True)
    assert p is None and jp is None
    assert tuple(lse.shape) == (B, HQ, SQ) and lse.dtype == torch.float32
    _close(out, jout, TOL)
    _close(lse, jlse, TOL)


@pytest.mark.parametrize("kw", [
    {"window_size": (8, 0)}, {"window_size": (4, 4)}, {"dropout_p": 0.1},
])
def test_flash_attn_func_unported_arguments_raise(kw):
    """The arguments that raised before the window/dropout slice compute:
    out, lse and the gradients against JAX's flash_attn_func (with
    causal=True a window's right side is a no-op in both)."""
    xs = _api_inputs("func")
    jout, jlse, _ = japi.flash_attn_func(*map(jnp.asarray, xs), causal=True,
                                         return_attn_probs=True, **kw)
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    out, lse, _ = api.flash_attn_func(*leaves, causal=True,
                                      return_attn_probs=True, **kw)
    _close(out.detach(), jout, TOL)
    _close(lse, jlse, TOL)
    dout = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda q, k, v: japi.flash_attn_func(
        q, k, v, causal=True, **kw), *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(dout))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kw", [
    {"softcap": 5.0}, {"alibi_slopes": np.linspace(0.1, 0.8, HQ,
                                                   dtype=np.float32)},
], ids=["softcap", "alibi"])
def test_flash_attn_func_softcap_alibi_match_jax(kw, causal):
    """softcap and ALiBi, which the plain versions have since the ring
    slice (the block kernels raise for them on the card): forward and
    gradients on CPU tensors."""
    xs = _api_inputs("func")
    dout = _np((B, SQ, HQ, D), 3)
    jkw = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for k, x in kw.items()}

    def jloss(*args):
        return jnp.sum(japi.flash_attn_func(*args, causal=causal, **jkw)
                       * dout)

    jout = japi.flash_attn_func(*map(jnp.asarray, xs), causal=causal, **jkw)
    jgrads = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    out = api.flash_attn_func(*ts, causal=causal, **kw)
    tgrads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), ts)
    _close(out, jout, TOL)
    for t, j in zip(tgrads, jgrads):
        _close(t, j, GRAD_TOL)


@pytest.mark.parametrize("deterministic,fused", [(True, False),
                                                 (False, None)])
def test_deterministic_selects_the_split_backward(monkeypatch, deterministic,
                                                  fused):
    """deterministic=True asks block_bwd for the split kernels B3a/B3b,
    which are bitwise reproducible on the card (B2's atomic dq is not)."""
    seen = []
    real = tflash.block_bwd

    def spy(*args, **kw):
        seen.append(kw["fused"])
        return real(*args, **kw)

    monkeypatch.setattr(tflash, "block_bwd", spy)
    xs = [torch.from_numpy(x).requires_grad_() for x in _api_inputs("func")]
    out = api.flash_attn_func(*xs, causal=True, deterministic=deterministic)
    torch.autograd.grad(out.sum(), xs)
    assert seen == [fused]


# ---- model: loss and train_step ----


@pytest.fixture(scope="module")
def jparams():
    return jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG_KW))


def _model(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           ModelConfig(**CFG_KW), device="cpu")


def _batch(seed, b=2):
    toks = np.random.default_rng(seed).integers(
        0, CFG_KW["vocab"], size=(b, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    return toks, labels, np.arange(S, dtype=np.int32)


def _torch_batch(toks, labels, pos):
    return (torch.from_numpy(toks).long(), torch.from_numpy(labels).long(),
            torch.from_numpy(pos))


def test_train_step_matches_jax(jparams):
    """One SGD step (lr 1e-2): the loss and every updated parameter."""
    toks, labels, pos = _batch(0)
    new, jloss = jax_train_step(jparams, JaxConfig(**CFG_KW),
                                jnp.asarray(toks), jnp.asarray(labels),
                                jnp.asarray(pos), lr=1e-2, axis_name=None)
    model, loss = train_step(_model(jparams), *_torch_batch(toks, labels, pos),
                             lr=1e-2)
    assert abs(float(loss) - float(jloss)) <= TOL
    _close(model.embed, new["embed"], TOL)
    _close(model.lm_head, new["lm_head"], TOL)
    _close(model.final_norm, new["final_norm"], TOL)
    for layer, src in zip(model.layers, new["layers"]):
        for name, leaf in src.items():
            _close(getattr(layer, name), leaf, TOL)


def test_loss_fn_with_ignored_labels_matches_jax(jparams):
    toks, labels, pos = _batch(1)
    labels[0, ::3] = -100  # padding
    labels[1, :40] = -100
    want = jax_loss_fn(jparams, JaxConfig(**CFG_KW), jnp.asarray(toks),
                       jnp.asarray(labels), jnp.asarray(pos))
    got = loss_fn(_model(jparams), *_torch_batch(toks, labels, pos))
    assert abs(float(got.detach()) - float(want)) <= TOL
    # no valid label at all: loss 0, as JAX's max(count, 1) gives
    none = np.full_like(labels, -100)
    assert float(loss_fn(_model(jparams),
                         *_torch_batch(toks, none, pos)).detach()) == 0.0


def test_train_steps_lower_the_loss(jparams):
    model = _model(jparams)
    batch = _torch_batch(*_batch(2))
    losses = [float(train_step(model, *batch, lr=5e-2)[1]) for _ in range(4)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.05, losses


def test_serving_builds_no_graph(jparams):
    """Parameters require grad for training; the serving functions run
    under torch.no_grad() and return tensors outside any graph."""
    model = _model(jparams)
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(_batch(3, b=1)[0][:, :16]).long()
    logits, ks, vs = _prefill_fn(model, toks)
    assert not logits.requires_grad and logits.grad_fn is None
    assert not any(t.requires_grad for t in ks + vs)
