"""The layouts that the forward kernels' callers hand them, on the CPU.

B1 (``flash_fwd_cuda``) and B7 (``fused_ring_fwd_cuda``) read q, k and v
through TMA tensor maps, which take only some strided views
(``tma_layout_error``). Here every caller of the two kernels runs on small
CPU inputs with the kernel path forced on (``use_kernel`` True) and the
kernels replaced by recorders that check each operand's layout and return
the plain versions' results: ``flash_attn_func`` and its packed forms, the
ring and zigzag entry points, llama3's forward, the fused ring, and the
prefills of ``ServingEngine`` and ``generate`` at two layers. None of them
may make ``_kernel_layout`` copy an operand; a caller that hands over a
view the maps cannot read gets a copy, never a kernel launch on it.
"""

import importlib

import numpy as np
import pytest
import torch

from ring_flash_attn_tpu_torch import api
from ring_flash_attn_tpu_torch.config import check_backend
from ring_flash_attn_tpu_torch.models import (
    ModelConfig, ServingEngine, init_params, prefill)
from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import tma_layout_error
from ring_flash_attn_tpu_torch.ops.naive import naive_block_fwd
from ring_flash_attn_tpu_torch.parallel import (
    fused_ring_attention, llama3_attention)

tflash = importlib.import_module("ring_flash_attn_tpu_torch.ops.flash")
tring = importlib.import_module("ring_flash_attn_tpu_torch.parallel.ring")
tzigzag = importlib.import_module("ring_flash_attn_tpu_torch.parallel.zigzag")
tfused = importlib.import_module(
    "ring_flash_attn_tpu_torch.parallel.fused_ring")

B, S, HQ, HKV, D = 1, 64, 4, 2, 64


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture
def kernel_path(monkeypatch):
    """Force the kernel path on CPU tensors; count launches and copies."""
    seen = {"B1": 0, "B7": 0, "copies": 0}

    def readable(**operands):
        for name, x in operands.items():
            assert tma_layout_error(x) is None, (name, x.stride())

    def b1(q, k, v, scale, mask, out_dtype=torch.float32):
        readable(q=q, k=k, v=v)
        seen["B1"] += 1
        out, lse = naive_block_fwd(q, k, v, scale, mask)
        return out.to(out_dtype), lse

    def b7(qs, k, v, m, l, acc, **kw):
        readable(q=qs, k=k, v=v)
        seen["B7"] += 1
        return tfused._plain_fwd_step(qs, k, v, m, l, acc, **kw)

    real_layout = tflash._kernel_layout

    def layout(x):
        y = real_layout(x)
        seen["copies"] += y is not x
        return y

    def use_kernel(x, backend):
        return check_backend(backend) is None

    for mod in (tflash, tring, tzigzag, tfused):
        monkeypatch.setattr(mod, "use_kernel", use_kernel)
    for mod in (tflash, tfused):
        monkeypatch.setattr(mod, "_kernel_layout", layout)
    monkeypatch.setattr(tflash, "flash_fwd_cuda", b1)
    monkeypatch.setattr(tfused, "fused_ring_fwd_cuda", b7)
    return seen


def _qkv_bshd():
    """q (B, S, Hq, D), k and v (B, S, Hkv, D): the api's layout."""
    return (_bf16((B, S, HQ, D), 0), _bf16((B, S, HKV, D), 1),
            _bf16((B, S, HKV, D), 2))


def _qkv_bhsd():
    return tuple(x.transpose(1, 2) for x in _qkv_bshd())


def _api(name):
    def call():
        q, k, v = _qkv_bshd()
        fn = getattr(api, name)
        if name.endswith("qkvpacked_func"):
            qkv = torch.stack([q, k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1)],
                              dim=2)
            return fn(qkv, causal=True)
        if name.endswith("kvpacked_func"):
            return fn(q, torch.stack([k, v], dim=2), causal=True)
        return fn(q, k, v, causal=True)
    return call


def _llama3():
    q, k, v = _qkv_bhsd()
    return llama3_attention(q, k, v, scale=D**-0.5, causal=True,
                            heads_k_stride=1)[0]


def _fused_ring():
    q, k, v = _qkv_bhsd()
    return fused_ring_attention(q, k, v, scale=D**-0.5, causal=True)[0]


CFG = ModelConfig(vocab=97, dim=HQ * D, layers=2, heads=HQ, kv_heads=HKV,
                  head_dim=D, mlp_dim=128, dtype="bfloat16")


def _model():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _engine():
    eng = ServingEngine(_model(), num_pages=24, page_size=8, pages_per_seq=8,
                        max_batch=2, device="cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, CFG.vocab, size=40)
    eng.submit(0, prompt, 2)
    # a prompt sharing the first 32 tokens: its suffix prefills over them
    eng.submit(1, np.concatenate([prompt[:32], rng.integers(0, 97, 9)]), 2,
               prefix_of=0)
    out = eng.run(max_steps=20)
    assert sorted(out) == [0, 1]
    return torch.tensor([len(t) for t in out.values()])


def _generate_prefill():
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab, size=(1, 48)))
    return prefill(_model(), tokens)[0]


# caller -> (its run, the kernel it reaches)
CALLERS = {
    "flash_attn_func": (_api("flash_attn_func"), "B1"),
    "flash_attn_kvpacked_func": (_api("flash_attn_kvpacked_func"), "B1"),
    "flash_attn_qkvpacked_func": (_api("flash_attn_qkvpacked_func"), "B1"),
    "ring_flash_attn_func": (_api("ring_flash_attn_func"), "B1"),
    "ring_flash_attn_kvpacked_func": (
        _api("ring_flash_attn_kvpacked_func"), "B1"),
    "zigzag_ring_flash_attn_func": (_api("zigzag_ring_flash_attn_func"),
                                    "B1"),
    "zigzag_ring_flash_attn_qkvpacked_func": (
        _api("zigzag_ring_flash_attn_qkvpacked_func"), "B1"),
    "llama3_attention": (_llama3, "B1"),
    "fused_ring_attention": (_fused_ring, "B7"),
    "ServingEngine prefill and prefix prefill": (_engine, "B1"),
    "generate's prefill": (_generate_prefill, "B1"),
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_forward_kernels_get_readable_layouts_without_copies(caller,
                                                             kernel_path):
    run, kernel = CALLERS[caller]
    with torch.no_grad():
        out = run()
    assert bool(torch.isfinite(out.float()).all())
    assert kernel_path[kernel] > 0
    assert kernel_path["copies"] == 0


def test_an_unreadable_view_is_copied_before_the_kernel(kernel_path):
    """k and v with their heads expanded from one (stride 0) cannot be read
    by a TMA map: block_fwd hands the kernel contiguous copies."""
    q, k, v = _qkv_bhsd()
    k1, v1 = k[:, :1].expand_as(k), v[:, :1].expand_as(v)
    assert tma_layout_error(k1) is not None
    out, lse = tflash.block_fwd(q, k1, v1, D**-0.5, tflash.MaskArgs(
        causal=True))
    ref_out, ref_lse = naive_block_fwd(q, k1, v1, D**-0.5,
                                       tflash.MaskArgs(causal=True))
    assert kernel_path["B1"] == 1 and kernel_path["copies"] == 2
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
