"""The port's single-device varlen entry points against the JAX package's,
on the CPU: ``flash_attn_varlen_func`` and its kv-packed and qkv-packed
forms (out, lse and the gradients of q, k, v), causal and not, GQA, on the
reference's packings scaled to 256 tokens and edge packings; and
``llama3_flash_attn_prepare_cu_seqlens``, exactly.

On the CPU the port's block calls run the plain versions of kernels B1 and
B2/B3 with segment ids and positions; JAX runs its XLA path. The ring and
llama3 varlen schedules over gloo are ``tests/test_torch_varlen_dist.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu import api as japi
from ring_flash_attn_tpu_torch import api

OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, JAX's tests/test_varlen.py limits
HQ, HKV, D = 4, 2, 32

# the reference's packings (benchmark_varlen_kvpacked_func.py:45-50) scaled
# from 8192 to 256 tokens; one sequence, a 1-token sequence, T = 300
PACKINGS = [
    [0, 256], [0, 8, 239, 256], [0, 128, 256], [0, 97, 197, 247, 252, 256],
    [0, 1, 200], [0, 130, 131, 300],
]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _inputs(t):
    return (_np((t, HQ, D), 0), _np((t, HKV, D), 1), _np((t, HKV, D), 2),
            _np((t, HQ, D), 3))


def _pack(form, q, k, v, lib):
    """The entry point of ``form`` and its leading arguments."""
    if form == "func":
        return lib.flash_attn_varlen_func, (q, k, v)
    if form == "kvpacked":
        stack = torch.stack if lib is api else jnp.stack
        return lib.flash_attn_varlen_kvpacked_func, (q, stack([k, v], 1))
    stack = torch.stack if lib is api else jnp.stack
    return lib.flash_attn_varlen_qkvpacked_func, (stack([q, k, v], 1),)


@pytest.mark.parametrize("form", ["func", "kvpacked", "qkvpacked"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cu", PACKINGS)
def test_flash_attn_varlen_matches_jax(cu, causal, form):
    t = cu[-1]
    q, k, v, dout = _inputs(t)
    if form == "qkvpacked":  # one head count for all three
        k, v = _np((t, HQ, D), 1), _np((t, HQ, D), 2)
    jfn, jargs = _pack(form, *map(jnp.asarray, (q, k, v)), japi)
    tfn, targs = _pack(form, *map(torch.from_numpy, (q, k, v)), api)
    cu_np = np.asarray(cu, np.int32)

    def jf(*xs):
        return jfn(*xs, cu_np, causal=causal, return_attn_probs=True)[:2]

    (jo, jl), vjp = jax.vjp(jf, *jargs)
    jgrads = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
    leaves = [x.clone().requires_grad_() for x in targs]
    to, tl, p = tfn(*leaves, torch.tensor(cu), causal=causal,
                    return_attn_probs=True)
    assert p is None and to.shape == q.shape and tl.shape == (HQ, t)
    assert _err(to.detach(), jo) <= OUT_TOL and _err(tl, jl) <= OUT_TOL
    tgrads = torch.autograd.grad(to, leaves, torch.from_numpy(dout))
    for g, w in zip(tgrads, jgrads):
        assert _err(g, w) <= GRAD_TOL


def test_deterministic_reaches_block_bwd(monkeypatch):
    """deterministic=True asks block_bwd for the reproducible split kernels
    (fused=False), the default for the selector (None)."""
    from ring_flash_attn_tpu_torch.ops import flash

    seen = []
    real = flash.block_bwd

    def recorder(*args, fused=None, **kw):
        seen.append(fused)
        return real(*args, fused=fused, **kw)

    monkeypatch.setattr(flash, "block_bwd", recorder)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(64))
    for det in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = api.flash_attn_varlen_func(*leaves, [0, 30, 64], causal=True,
                                         deterministic=det)
        out.sum().backward()
    assert seen == [None, False]


def test_varlen_options_not_ported_raise():
    """The varlen options that raised before the window/dropout slice
    compute, against JAX's flash_attn_varlen_func: a causal window, and
    dropout without a causal mask (its hash on the sequences' positions
    and segments), out, lse and the gradients; a non-causal window raises
    in both packages."""
    cu = [0, 97, 197, 247, 252, 256]
    q, k, v, dout = _inputs(256)
    for kw in (dict(causal=True, window_size=(40, 0)),
               dict(dropout_p=0.1, dropout_seed=3)):
        def jf(*xs):
            return japi.flash_attn_varlen_func(
                *xs, np.asarray(cu, np.int32), return_attn_probs=True,
                **kw)[:2]

        (jo, jl), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
        jgrads = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        to, tl, _ = api.flash_attn_varlen_func(*leaves, cu,
                                               return_attn_probs=True, **kw)
        assert _err(to.detach(), jo) <= OUT_TOL and _err(tl, jl) <= OUT_TOL
        tgrads = torch.autograd.grad(to, leaves, torch.from_numpy(dout))
        for g, w in zip(tgrads, jgrads):
            assert _err(g, w) <= GRAD_TOL
    x = torch.zeros(16, HQ, D)
    with pytest.raises(NotImplementedError):
        api.flash_attn_varlen_func(x, x, x, [0, 16], window_size=(4, 0))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("cu", [[0, 64], [0, 7, 40, 41, 64],
                                [0, 16, 32, 48, 64], [0, 63, 64]])
def test_llama3_prepare_cu_seqlens_matches_jax(cu, world, causal):
    for rank in range(world):
        got = api.llama3_flash_attn_prepare_cu_seqlens(cu, causal, rank,
                                                       world)
        want = japi.llama3_flash_attn_prepare_cu_seqlens(
            np.asarray(cu), causal, rank, world)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        assert got[2:] == want[2:]


@pytest.mark.parametrize("causal", [True, False])
def test_registry_flash_takes_segments_and_positions(causal):
    """The registry's flash entry with segment_ids and positions (no
    packed_self: shuffled positions hold no index order) against JAX's,
    forward and gradients."""
    from ring_flash_attn_tpu.adapters.registry import (
        get_attention as jax_get_attention)
    from ring_flash_attn_tpu_torch import get_attention

    rng = np.random.default_rng(7)
    s = 96
    seg = rng.integers(0, 3, s).astype(np.int32)
    pos = rng.permutation(s).astype(np.int32)
    q, k, v, dout = (_np((1, s, HQ, D), 0), _np((1, s, HKV, D), 1),
                     _np((1, s, HKV, D), 2), _np((1, s, HQ, D), 3))
    jfn = jax_get_attention("flash")
    jo, vjp = jax.vjp(lambda *x: jfn(*x, causal=causal,
                                     segment_ids=jnp.asarray(seg),
                                     positions=jnp.asarray(pos)),
                      *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to = get_attention("flash")(*leaves, causal=causal,
                                segment_ids=torch.from_numpy(seg),
                                positions=torch.from_numpy(pos))
    assert _err(to.detach(), jo) <= OUT_TOL
    for g, w in zip(torch.autograd.grad(to, leaves, torch.from_numpy(dout)),
                    jgrads):
        assert _err(g, w) <= GRAD_TOL
