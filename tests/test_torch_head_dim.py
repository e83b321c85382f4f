"""Head_dim 256 (Gemma) on the port's single-device entry points against
the JAX package's, and the launchers that send each head_dim to a kernel
build that has it or raise.

On the CPU ``flash_attn_func`` and ``flash_attn_varlen_func`` run the
plain versions of kernels B1 (forward) and B2/B3a/B3b (backward) at
head_dim 256, also with Gemma 2's softcap and sliding window, ALiBi and
dropout, against JAX's XLA path; the kernels' head_dim 256 builds are held
against the same plain versions on the card (chip_smoke.py phases 23 and
25, tests/test_torch_cuda.py). The launchers run on CPU tensors with the
CUDA-operand test stubbed out and each kernel library replaced by a
recorder of its entry points' calls (``recorded``), since they decide
everything before the launch."""

import contextlib
import types

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


# Gemma 2's attention: softcap 50 and a causal sliding window (cut from
# 4096 to the test's size), then each transform alone: a cap that bends
# the N(0, 1) logits, ALiBi on the standard slopes, dropout, and a
# non-causal (left, right) window
TRANSFORMS = [
    (True, dict(softcap=50.0, window_size=(20, 0))),
    (True, dict(softcap=2.0)),
    (True, dict(alibi_slopes=[2.0 ** (-2.0 * (h + 1)) for h in range(4)])),
    (True, dict(dropout_p=0.1, dropout_seed=7)),
    (False, dict(window_size=(16, 8), softcap=3.0)),
]


def _jax_kw(extra):
    return {k: np.asarray(x, np.float32) if k == "alibi_slopes" else x
            for k, x in extra.items()}


def _torch_kw(extra):
    return {k: torch.tensor(x) if k == "alibi_slopes" else x
            for k, x in extra.items()}


@pytest.mark.parametrize("causal,extra", TRANSFORMS)
def test_flash_attn_func_head_dim_256_transforms_match_jax(causal, extra):
    """``flash_attn_func`` at head_dim 256 with softcap, ALiBi, a window
    and dropout (B1 to B3b's XFORM and BAND builds on the card; their
    plain versions here): out, lse and the gradients of q, k, v against
    JAX's at OUT_TOL and GRAD_TOL, on 4 q heads over 2 kv heads."""
    b, s, hq, hkv = 1, 96, 4, 2
    q, k, v, dout = (_np((b, s, hq, D), 10), _np((b, s, hkv, D), 11),
                     _np((b, s, hkv, D), 12), _np((b, s, hq, D), 13))

    def jf(*xs):
        return japi.flash_attn_func(*xs, causal=causal,
                                    return_attn_probs=True,
                                    **_jax_kw(extra))[:2]

    (jo, jl), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl, _ = api.flash_attn_func(*leaves, causal=causal,
                                    return_attn_probs=True,
                                    **_torch_kw(extra))
    assert _err(to.detach(), jo) <= OUT_TOL and _err(tl, jl) <= OUT_TOL
    for g, w in zip(torch.autograd.grad(to, leaves, torch.from_numpy(dout)),
                    jgrads):
        assert _err(g, w) <= GRAD_TOL


@pytest.mark.parametrize("causal,extra", TRANSFORMS[:4])
def test_flash_attn_varlen_head_dim_256_transforms_match_jax(causal, extra):
    """``flash_attn_varlen_func`` at head_dim 256 on three packed
    sequences with each transform (the segmented XFORM and BAND builds on
    the card): out, lse and the gradients against JAX's."""
    cu = [0, 8, 40, 64]
    q, k, v, dout = (_np((64, 4, D), 14), _np((64, 2, D), 15),
                     _np((64, 2, D), 16), _np((64, 4, D), 17))
    cu_np = np.asarray(cu, np.int32)

    def jf(*xs):
        return japi.flash_attn_varlen_func(*xs, cu_np, causal=causal,
                                           return_attn_probs=True,
                                           **_jax_kw(extra))[:2]

    (jo, jl), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(dout), jnp.zeros_like(jl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl, _ = api.flash_attn_varlen_func(
        *leaves, torch.tensor(cu), causal=causal, return_attn_probs=True,
        **_torch_kw(extra))
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


# the head_dim argument's place in each entry point's arguments
D_ARG = {"rfa_flash_fwd": 10, "rfa_flash_bwd": 14, "rfa_flash_bwd_dq": 12,
         "rfa_flash_bwd_dkv": 13}


@pytest.fixture
def recorded(monkeypatch, cpu_operands):
    """Drive B1's, B2's and B3a/B3b's launchers to their launch on CPU
    tensors: each library is a recorder whose entry points note (name,
    head_dim, the tiles ``launch_masked`` was given) and return 0, and the
    launch counters are restored afterwards. Returns run(d, mask) -> the
    calls of one forward, one B2 and one B3a + B3b backward."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                base = next(b for b in sorted(D_ARG, key=len, reverse=True)
                            if name.startswith(b))
                calls.append((name, args[D_ARG[base]], tiles[-1]))
                return 0
            return entry

    tiles = []

    def launch_masked(fns, args, mask, q, k, t, stream):
        tiles.append(t)
        return real_launch(fns, args, mask, q, k, t, stream)

    real_launch = ffc.launch_masked
    monkeypatch.setattr(fbc, "_check_rows", lambda *a: None)  # lse, delta
    for mod in (ffc, fbc, fbs):
        monkeypatch.setattr(mod, "_lib", Lib)
        monkeypatch.setattr(mod, "launch_masked", launch_masked)
    for fn in (ffc.flash_fwd_cuda, fbc.flash_bwd_cuda, fbs.flash_bwd_dq_cuda,
               fbs.flash_bwd_dkv_cuda):
        for counter in ("launches", "xform_launches", "band_launches"):
            monkeypatch.setattr(fn, counter, getattr(fn, counter))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=None))

    def run(d, mask):
        del calls[:]
        q, k, v = cpu_operands(d)
        lse = torch.zeros(q.shape[:3])
        ffc.flash_fwd_cuda(q, k, v, 0.1, mask)
        fbc.flash_bwd_cuda(q, q, k, v, lse, lse, 0.1, mask)
        fbs.flash_bwd_split_cuda(q, q, k, v, lse, lse, 0.1, mask)
        return list(calls)
    return run


def test_block_kernels_take_head_dim_256(recorded, cpu_operands):
    """B1, B2, B3a and B3b take 64, 128 and 256, and at 256 their tiles
    are the head_dim 256 builds': B1 128 q rows x 80 keys (64 keys in the
    segmented, softcap/ALiBi and band builds), B2/B3b 64 keys a block x
    64 q rows a step, B3a 128 q rows x 64 keys, as at every head_dim; the
    mask-free and segmented masks reach the mask-free and segmented entry
    points at 256."""
    for d in (64, 128, 256):
        assert ffc.check_qkv(*cpu_operands(d))[-1] == d
    seg = torch.zeros(8, dtype=torch.int32)
    for mask, tail in ((MaskArgs(causal=True), ""),
                       (MaskArgs(q_segids=seg, kv_segids=seg), "_seg"),
                       (MaskArgs(causal=True, q_pos=seg, kv_pos=seg),
                        "_seg")):
        assert recorded(256, mask) == [
            ("rfa_flash_fwd" + tail, 256, (128, 64 if tail else 80)),
            ("rfa_flash_bwd" + tail, 256, (64, 64)),
            ("rfa_flash_bwd_dq" + tail, 256, (128, 64)),
            ("rfa_flash_bwd_dkv" + tail, 256, (64, 64))]
    assert ffc.kv_tile(256) == 80 and ffc.kv_tile(256, tile64=True) == 64
    assert ffc.kv_tile(128) == ffc.kv_tile(128, tile64=True) == 128
    assert fbc.kv_major_tiles(256) == (64, 64)
    assert fbc.kv_major_tiles(64) == fbc.KV_MAJOR_TILES == (64, 128)
    assert fbs.DQ_TILES == (128, 64)


def test_segment_class_ceilings_and_the_backward_selector():
    """The most tiles whose segment classes each segmented backward build
    keeps beside its tiles in shared memory (the kernels' own layouts,
    ``KvSmem`` and ``DqSmem``, held on the card at these numbers by
    tests/test_torch_cuda.py), and ``block_bwd``'s selector: a segmented
    call whose q tiles' classes B2 cannot hold goes to B3a/B3b, as one
    past ``FUSED_MAX_KV_BYTES`` does."""
    seg = torch.zeros(8, dtype=torch.int32)
    packed = MaskArgs(causal=True, q_segids=seg, kv_segids=seg)
    gemma2 = packed._replace(softcap=50.0, window_left=4096)  # ALL
    window = packed._replace(window_left=4096)  # the WINDOW build
    assert fbc.fused_bwd_seg_max_q_tiles(256, gemma2) == 1824
    assert fbc.fused_bwd_seg_max_q_tiles(256, packed) == 3872
    assert fbc.fused_bwd_seg_max_q_tiles(256, window) == 3872
    assert fbc.fused_bwd_seg_max_q_tiles(128, gemma2) == 1888
    assert fbc.fused_bwd_seg_max_q_tiles(128, packed) == 3936
    assert fbs.dq_seg_max_kv_tiles(256) == 7968
    assert fbs.dq_seg_max_kv_tiles(128) == 401120
    for mask, n in ((gemma2, 1824), (packed, 3872)):
        assert fbc.fused_bwd_takes(mask, 64 * n, 16384, 256)
        assert not fbc.fused_bwd_takes(mask, 64 * n + 1, 16384, 256)
        assert not fbc.fused_bwd_takes(mask, 64, 16385, 256)
    # without segments only Skv decides, as in the JAX package
    assert fbc.fused_bwd_takes(MaskArgs(causal=True), 2**20, 16384, 256)
    assert not fbc.fused_bwd_takes(MaskArgs(causal=True), 64, 16385, 256)
    assert fbc.fused_bwd_takes(MaskArgs(), 2**20, 32768, 128)


@pytest.mark.parametrize("extra", [
    {"softcap": 30.0}, {"alibi_slopes": [0.5, 0.25, 0.125, 0.0625]},
    {"window_left": 16}, {"dropout_p": 0.1, "dropout_seed": 3}])
def test_head_dim_256_transforms_raise_f4b(recorded, extra):
    """Softcap, ALiBi, a window or dropout at head_dim 256, which the
    launchers once refused (ROADMAP F4(b), now closed): B1's, B2's and
    B3a/B3b's launchers pass every check and launch the XFORM build
    (softcap, ALiBi) or the BAND build (window, dropout) at head_dim 256
    on the 256 builds' tiles; at 128 the same masks keep the 128 tiles."""
    mask = MaskArgs(causal=True, **extra)
    tail = "_band" if "softcap" not in extra and "alibi_slopes" not in \
        extra else "_xf"
    assert recorded(D, mask) == [
        ("rfa_flash_fwd" + tail, D, (128, 64)),
        ("rfa_flash_bwd" + tail, D, (64, 64)),
        ("rfa_flash_bwd_dq" + tail, D, (128, 64)),
        ("rfa_flash_bwd_dkv" + tail, D, (64, 64))]
    assert [c[1:] for c in recorded(128, mask)] == [
        (128, (128, 128)), (128, (64, 128)), (128, (128, 64)),
        (128, (64, 128))]


def test_other_kernels_raise_f4b_at_new_head_dims(cpu_operands):
    """The fused ring's B7 and B8, which once refused head_dim 256
    (ROADMAP F4(b), now closed), take 64, 128 and 256. The decode loop of
    B4, B5 and B6 takes 64, 128 and 256 at any whole group; a head_dim no
    kernel has (96) raises plainly, in B7/B8's checks too."""
    for d in (64, 128, D):
        assert frc._check_shapes(*cpu_operands(d))[-1] == d
    with pytest.raises(ValueError, match="must be one of.*B7 and B8"):
        frc._check_shapes(*cpu_operands(96))
    for d in (64, 128, 256):
        qdc.check_rows(8, 8, 1, d)
        qdc.check_rows(71, 1, 5, d)  # no raise
    with pytest.raises(ValueError, match="must be one of"):
        ffc.check_qkv(*cpu_operands(96))
    with pytest.raises(ValueError, match="must be one of"):
        qdc.check_rows(8, 8, 1, 96)
