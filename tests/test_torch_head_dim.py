"""Head_dim 256 (Gemma) on the port's single-device entry points against
the JAX package's, and the operand checks that send each head_dim to a
kernel instantiation that has it or raise naming ROADMAP F4(b).

On the CPU ``flash_attn_func`` and ``flash_attn_varlen_func`` run the
plain versions of kernels B1 (forward) and B2/B3a/B3b (backward) at
head_dim 256, against JAX's XLA path; the kernels' head_dim 256
instantiations are held against the same plain versions on the card
(chip_smoke.py phase 23, tests/test_torch_cuda.py). The checks run on CPU
tensors with the CUDA-operand test stubbed out, since they decide before
any launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu import api as japi
from ring_flash_attn_tpu_torch import api
from ring_flash_attn_tpu_torch.ops import flash_bwd_cuda as fbc
from ring_flash_attn_tpu_torch.ops import flash_bwd_split_cuda as fbs
from ring_flash_attn_tpu_torch.ops import flash_fwd_cuda as ffc
from ring_flash_attn_tpu_torch.ops import quant_decode_cuda as qdc
from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
from ring_flash_attn_tpu_torch.parallel import fused_ring_cuda as frc

D = 256
# float32 on both sides: JAX's api tests' limits (tests/test_varlen.py)
OUT_TOL, GRAD_TOL = 2e-5, 1e-4


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


# Gemma-7B's attention (as many kv heads as q heads) and Gemma-2B's (one
# kv head: the GQA sum in dk and dv), cut to 4 and 2 heads
@pytest.mark.parametrize("heads", [(4, 4), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_func_head_dim_256_matches_jax(heads, causal):
    """Forward (out, lse) and the gradients of q, k, v at head_dim 256."""
    hq, hkv = heads
    b, s = 2, 48
    q, k, v, dout = (_np((b, s, hq, D), 0), _np((b, s, hkv, D), 1),
                     _np((b, s, hkv, D), 2), _np((b, s, hq, D), 3))

    def jf(*xs):
        return japi.flash_attn_func(*xs, causal=causal,
                                    return_attn_probs=True)[:2]

    (jo, jl), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl, _ = api.flash_attn_func(*leaves, causal=causal,
                                    return_attn_probs=True)
    assert _err(to.detach(), jo) <= OUT_TOL and _err(tl, jl) <= OUT_TOL
    for g, w in zip(torch.autograd.grad(to, leaves, torch.from_numpy(dout)),
                    jgrads):
        assert _err(g, w) <= GRAD_TOL


@pytest.mark.parametrize("cu", [[0, 64], [0, 8, 40, 64], [0, 1, 33, 64]])
@pytest.mark.parametrize("deterministic", [False, True])
def test_flash_attn_varlen_head_dim_256_matches_jax(cu, deterministic):
    """Packed sequences at head_dim 256, causal, Gemma-2B's one kv head:
    out, lse and the gradients (the deterministic call takes the split
    backward's plain version on the CPU)."""
    t = cu[-1]
    q, k, v, dout = (_np((t, 4, D), 4), _np((t, 1, D), 5), _np((t, 1, D), 6),
                     _np((t, 4, D), 7))
    cu_np = np.asarray(cu, np.int32)

    def jf(*xs):
        return japi.flash_attn_varlen_func(*xs, cu_np, causal=True,
                                           return_attn_probs=True)[:2]

    (jo, jl), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl, _ = api.flash_attn_varlen_func(
        *leaves, torch.tensor(cu), causal=True, return_attn_probs=True,
        deterministic=deterministic)
    assert _err(to.detach(), jo) <= OUT_TOL and _err(tl, jl) <= OUT_TOL
    for g, w in zip(torch.autograd.grad(to, leaves, torch.from_numpy(dout)),
                    jgrads):
        assert _err(g, w) <= GRAD_TOL


@pytest.fixture
def cpu_operands(monkeypatch):
    """Operand checks that take CPU tensors: the checks of device, dtype
    and TMA layout stubbed out, the head_dim checks kept."""
    monkeypatch.setattr(ffc, "_check_operand", lambda *a: None)
    monkeypatch.setattr(fbc, "_check_operand", lambda *a: None)
    monkeypatch.setattr(frc, "_check_operand", lambda *a: None)

    def qkv(d, hq=4, hkv=2, s=8):
        return (torch.zeros(1, hq, s, d), torch.zeros(1, hkv, s, d),
                torch.zeros(1, hkv, s, d))
    return qkv


def test_block_kernels_take_head_dim_256(cpu_operands):
    """B1, B2, B3a and B3b take 64, 128 and 256, and at 256 their tiles
    are the head_dim 256 builds': B1 128 q rows x 64 keys, B2/B3b 64 keys
    a block x 64 q rows a step, B3a 64 x 64."""
    for d in (64, 128, 256):
        assert ffc.check_qkv(*cpu_operands(d))[-1] == d
    seg = torch.zeros(8, dtype=torch.int32)
    for mask in (MaskArgs(causal=True), MaskArgs(q_segids=seg, kv_segids=seg),
                 MaskArgs(causal=True, q_pos=seg, kv_pos=seg)):
        ffc.check_block_head_dim(256, mask)  # no raise
    assert ffc.kv_tile(256) == 64 and ffc.kv_tile(128) == 128
    assert fbc.kv_major_tiles(256) == (64, 64)
    assert fbc.kv_major_tiles(64) == fbc.KV_MAJOR_TILES == (64, 128)
    assert fbs.dq_tiles(256) == (64, 64) and fbs.dq_tiles(128) == (128, 64)


@pytest.mark.parametrize("extra", [
    {"softcap": 30.0}, {"alibi_slopes": [0.5, 0.25, 0.125, 0.0625]},
    {"window_left": 16}, {"dropout_p": 0.1, "dropout_seed": 3}])
def test_head_dim_256_transforms_raise_f4b(cpu_operands, extra):
    """Softcap, ALiBi, a window or dropout at head_dim 256 (the XFORM and
    BAND builds take 64 and 128): B1's and B2's launchers raise the
    ValueError naming ROADMAP F4(b) before anything is built; at 128 the
    same masks pass the check."""
    mask = MaskArgs(causal=True, **extra)
    q, k, v = cpu_operands(D)
    with pytest.raises(ValueError, match=r"F4\(b\)"):
        ffc.flash_fwd_cuda(q, k, v, 0.1, mask)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match=r"F4\(b\)"):
        fbc.check_bwd(q, q, k, v, lse, lse, mask, None, (None, None))
    ffc.check_block_head_dim(128, mask)


def test_other_kernels_raise_f4b_at_new_head_dims(cpu_operands):
    """The fused ring's B7 and B8 take 64 and 128: head_dim 256 there
    raises the F4(b) error. The decode loop of B4, B5 and B6 takes 64,
    128 and 256 at any whole group; a head_dim no kernel has raises
    plainly."""
    with pytest.raises(ValueError, match=r"B7 and B8.*F4\(b\)"):
        frc._check_shapes(*cpu_operands(D))
    assert frc._check_shapes(*cpu_operands(128))[-1] == 128
    for d in (64, 128, 256):
        qdc.check_rows(8, 8, 1, d)
        qdc.check_rows(71, 1, 5, d)  # no raise
    with pytest.raises(ValueError, match="must be one of"):
        ffc.check_qkv(*cpu_operands(96))
    with pytest.raises(ValueError, match="must be one of"):
        qdc.check_rows(8, 8, 1, 96)
