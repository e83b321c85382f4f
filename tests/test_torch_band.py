"""Sliding windows and dropout in the port against the JAX package on
identical numpy inputs, in float32 on the CPU.

- the dropout keep mask (``ops/mask.py::dropout_keep_dense``) bit for bit
  against JAX's ``_dropout_keep_dense``: seeds, heads with a head offset,
  batch > 1, segments, positions near and past 2^31 (whose uint32 bits
  wrap), a threshold at p = 0.999;
- the plain block functions (``naive_block_fwd``/``bwd``, the plain
  versions of kernels B1, B2, B3a and B3b) with windows (causal; not
  causal with both sides; on segments and positions; rows the window
  leaves dead) and dropout, against JAX's XLA path and its Pallas kernels
  in interpret mode;
- ``block_meta``'s window skip against JAX's, and what a launch of the
  kernels' BAND instantiations takes (``block_meta.kernel_band``);
- the ring's window skip: the steps whose resident shard lies outside the
  window launch nothing.

The CUDA kernels are held against the same plain versions on the card
(``chip_smoke.py`` phase 18, ``tests/test_torch_cuda.py -k band``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.ops.flash import block_fwd as jax_block_fwd
from ring_flash_attn_tpu.ops.flash import compute_delta as jax_compute_delta
from ring_flash_attn_tpu.ops.mask import MaskArgs as JMask
from ring_flash_attn_tpu.ops.naive import _dropout_keep_dense
from ring_flash_attn_tpu.ops.naive import naive_block_bwd as jax_naive_bwd
from ring_flash_attn_tpu.ops.naive import naive_block_fwd as jax_naive_fwd
from ring_flash_attn_tpu.ops.pallas_bwd import pallas_block_bwd
from ring_flash_attn_tpu.ops.pallas_fwd import block_meta as jax_block_meta
from ring_flash_attn_tpu_torch.ops.block_meta import (
    NO_BOUND, block_meta, has_band, kernel_band, segmented)
from ring_flash_attn_tpu_torch.ops.mask import (
    NEG_INF, MaskArgs, allowed_mask, dropout_keep_dense, dropout_threshold)
from ring_flash_attn_tpu_torch.ops.naive import (
    naive_block_bwd, naive_block_fwd)
from ring_flash_attn_tpu_torch.parallel.ring import _ring_masks

TOL, PALLAS_TOL, BWD_TOL = 1e-5, 1e-4, 1e-4  # tests/test_torch_ops.py's


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol):
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, err


def _masks(kw):
    """(JAX MaskArgs, the port's) of the same numpy fields: integer arrays
    go to JAX as int32 (wrapping as JAX's int32 positions do) and to the
    port as int64."""
    jkw, tkw = {}, {}
    for key, x in kw.items():
        if isinstance(x, np.ndarray):
            jkw[key] = jnp.asarray(x.astype(np.int32))
            tkw[key] = torch.from_numpy(x.astype(np.int64))
        else:
            jkw[key] = tkw[key] = x
    return JMask(**jkw), MaskArgs(**tkw)


# ---- the keep mask ----

_PACK = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3])
# (seed, B, Hkv, G, Sq, Skv, mask fields, p)
KEEP_CASES = {
    "plain": (0, 1, 2, 2, 16, 24, {}, 0.1),
    "offsets_heads_batch": (7, 2, 1, 4, 16, 24, dict(
        offset=5, kv_offset=3, head_offset=6), 0.5),
    "negative_seed_segments": (-3, 2, 2, 1, 16, 16, dict(
        head_offset=2, q_segids=_PACK, kv_segids=_PACK), 0.3),
    "offsets_near_2_31": (123456789, 1, 1, 2, 16, 24, dict(
        offset=2**31 - 8, kv_offset=2**31 - 20), 0.2),
    "offsets_wrap": (5, 2, 1, 1, 16, 24, dict(
        offset=-2**31 + 3, kv_offset=2**31 - 5, head_offset=2**31 - 1), 0.4),
    "positions_past_2_31": (11, 1, 2, 1, 16, 16, dict(
        q_pos=np.arange(16) * 3 + 2**31 - 20,
        kv_pos=np.arange(16)[::-1] + 2**31 - 6), 0.25),
    "p_0999": (9, 1, 1, 1, 16, 24, dict(offset=10, kv_offset=10), 0.999),
}


@pytest.mark.parametrize("name", sorted(KEEP_CASES))
def test_dropout_keep_mask_is_jax_bit_for_bit(name):
    seed, b, hkv, g, sq, skv, kw, p = KEEP_CASES[name]
    jmask, mask = _masks(dict(kw, dropout_p=p, dropout_seed=seed))
    want = np.asarray(_dropout_keep_dense(jmask, b, hkv, g, sq, skv))
    got = dropout_keep_dense(mask, b, hkv, g, sq, skv).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    # the seed as a one-element tensor drops the same pairs
    tensor_seed = mask._replace(dropout_seed=torch.tensor(seed))
    assert np.array_equal(
        dropout_keep_dense(tensor_seed, b, hkv, g, sq, skv).numpy(), want)
    assert dropout_threshold(p) == min(int(p * 2**32), 2**32 - 1)
    if p > 0.99:
        assert want.mean() < 0.01


# ---- the plain block functions ----

_SEG = np.array([0] * 20 + [1] * 24 + [2] * 20)
_POS = np.concatenate([np.arange(20), np.arange(24), np.arange(20)])
# (B, Hq, Hkv, Sq, Skv, mask fields)
BLOCK_CASES = {
    "causal_window": (1, 4, 2, 64, 64, dict(causal=True, window_left=10)),
    "causal_window_offset": (1, 2, 1, 32, 64, dict(
        causal=True, offset=32, window_left=20)),
    "full_window": (1, 4, 2, 32, 64, dict(
        offset=20, kv_offset=3, window_left=9, window_right=5)),
    "window_positions": (1, 2, 2, 64, 64, dict(
        causal=True, q_segids=_SEG, kv_segids=_SEG, q_pos=_POS,
        kv_pos=_POS, window_left=6)),
    "window_dead_rows": (1, 2, 1, 32, 32, dict(
        offset=-20, window_left=3, window_right=3)),
    "dropout": (2, 4, 2, 32, 64, dict(
        causal=True, offset=32, dropout_p=0.2, dropout_seed=5,
        head_offset=3)),
    "dropout_segments": (1, 4, 1, 64, 64, dict(
        q_segids=_SEG, kv_segids=_SEG, dropout_p=0.3, dropout_seed=9)),
    "window_dropout": (1, 2, 2, 64, 64, dict(
        causal=True, window_left=12, dropout_p=0.1, dropout_seed=1)),
}


def _block_case(name, d=16):
    b, hq, hkv, sq, skv, kw = BLOCK_CASES[name]
    q, k, v = (_np((b, hq, sq, d), 0), _np((b, hkv, skv, d), 1),
               _np((b, hkv, skv, d), 2))
    return (q, k, v, _np((b, hq, sq, d), 3)), _masks(kw), d**-0.5


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_naive_block_fwd_with_band_matches_jax(name, backend):
    (q, k, v, _), (jmask, mask), scale = _block_case(name)
    jo, jl = jax_block_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale, jmask, backend=backend)
    to, tl = naive_block_fwd(*map(torch.from_numpy, (q, k, v)), scale, mask)
    tol = TOL if backend == "xla" else PALLAS_TOL
    _close(to, jo, tol)
    _close(tl, jl, tol)
    if name == "window_dead_rows":
        dead = ~allowed_mask(mask, q.shape[2], k.shape[2]).any(1)
        assert int(dead.sum()) == 17
        assert torch.all(tl[..., dead] == NEG_INF)
        assert torch.all(to[..., dead, :] == 0)


@pytest.mark.parametrize("backend", ["xla", "pallas_fused", "pallas_split"])
@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_naive_block_bwd_with_band_matches_jax(name, backend):
    (q, k, v, dout), (jmask, mask), scale = _block_case(name)
    jq, jk, jv, jd = map(jnp.asarray, (q, k, v, dout))
    out, lse = jax_naive_fwd(jq, jk, jv, scale, jmask)
    delta = jax_compute_delta(jd, out)
    jargs = (jd, jq, jk, jv, lse, delta, scale, jmask)
    if backend == "xla":
        want = jax_naive_bwd(*jargs)
    else:
        want = pallas_block_bwd(*jargs, interpret=True, blk_q=32, blk_kv=32,
                                fused=backend == "pallas_fused")
    got = naive_block_bwd(*(torch.from_numpy(np.asarray(x).copy()) for x in
                            (dout, q, k, v, lse, delta)), scale, mask)
    for x, w in zip(got, want):
        _close(x, w, TOL if backend == "xla" else BWD_TOL)
    if name == "window_dead_rows":
        dead = ~allowed_mask(mask, q.shape[2], k.shape[2]).any(1)
        assert torch.all(got[0][..., dead, :] == 0)


# ---- the kernels' tile bounds and launch arguments ----


def test_block_meta_window_skip_matches_jax():
    """Rows 0 to 5 of both tables, causal on positions with a window, at
    the kernels' tiles: the tiles wholly left of the window skipped."""
    pos = np.concatenate([np.arange(300), np.arange(212)])
    seg = np.array([0] * 300 + [1] * 212)
    for blk_q, blk_kv in ((128, 128), (64, 128), (128, 64)):
        jmask, mask = _masks(dict(causal=True, q_segids=seg, kv_segids=seg,
                                  q_pos=pos, kv_pos=pos, window_left=100))
        want = jax_block_meta(jmask, blk_q, blk_kv, blk_kv, 512 // blk_q,
                              512 // blk_kv, xp=np)
        got = block_meta(mask, blk_q, blk_kv, 512, 512)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())
        # the first needed kv tile of the last q tile lies past the start
        assert int(got[0][4, -1]) > 0


def test_kernel_band_arguments():
    """What a BAND launch takes: a window side without a bound is
    NO_BOUND (the right side too under a causal mask), the threshold and
    1 / (1 - p), the seed, head offset and offsets as uint32 bits; a seed
    tensor is read by the kernel from its pointer. Positions reach the
    kernels (the segmented build) under a window or dropout."""
    args, seed = kernel_band(MaskArgs(causal=True, window_left=64,
                                      window_right=9), torch.device("cpu"))
    assert (args.wl, args.wr, args.thr, seed) == (64, NO_BOUND, 0, None)
    assert args.inv_keep == 1.0
    args, seed = kernel_band(MaskArgs(window_right=7, dropout_p=0.25,
                                      dropout_seed=-1, head_offset=3,
                                      offset=2**32 + 5, kv_offset=-2),
                             torch.device("cpu"))
    assert (args.wl, args.wr) == (NO_BOUND, 7)
    assert args.thr == 2**30 and abs(args.inv_keep - 4 / 3) < 1e-6
    assert (args.seed, args.head_offset) == (2**32 - 1, 3)
    assert (args.q_pos0, args.kv_pos0) == (5, 2**32 - 2)
    assert args.seed_ptr is None and seed is None
    args, seed = kernel_band(MaskArgs(dropout_p=0.1,
                                      dropout_seed=torch.tensor(17)),
                             torch.device("cpu"))
    assert seed.dtype == torch.int32 and int(seed) == 17
    assert args.seed_ptr == seed.data_ptr()
    pos = torch.arange(8)
    for kw in (dict(window_left=2), dict(dropout_p=0.1),
               dict(window_right=3)):
        mask = MaskArgs(q_pos=pos, kv_pos=pos, **kw)
        assert has_band(mask) and segmented(mask)
    assert not has_band(MaskArgs(causal=True, window_right=3))
    assert not segmented(MaskArgs(q_pos=pos, kv_pos=pos, softcap=5.0))


# ---- the ring's window skip ----


@pytest.mark.parametrize("causal", [True, False])
def test_ring_window_skip_launches_nothing_outside_the_window(causal):
    """At W=4, shards of 64 keys: a causal window of 40 needs steps 0 and
    1 (steps 2 and 3 hold shards 65 or more positions back); a window of
    (50, 30) not causal needs the shards at most one away on either side.
    A skipped step's mask is None: ``ring_loop_fwd``/``_bwd`` launch no
    block for it (their rotations still run)."""
    extras = dict(window_left=40 if causal else 50,
                  window_right=None if causal else 30)
    step_mask = _ring_masks(causal, 64, extras)
    for rank in range(4):
        live = [s for s in range(4) if step_mask(s, rank, 4) is not None]
        if causal:
            want = [s for s in (0, 1) if s <= rank]
        else:  # the resident shard came from rank (rank - s) % 4
            want = [s for s in range(4)
                    if abs(rank - (rank - s) % 4) <= 1]
        assert live == want, (rank, live)
        m = step_mask(0, rank, 4)
        assert m.window_left == extras["window_left"]
        if causal and rank >= 1:
            # off the diagonal: causal at the shard's offset, the window
            # bounding
            m1 = step_mask(1, rank, 4)
            assert m1.causal and m1.offset == 64 and m1.kv_offset is None
        if not causal:
            assert m.window_right == 30 and m.offset == rank * 64
