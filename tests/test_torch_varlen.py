"""Packed sequences in the port's ops against the JAX package, on the CPU:
the varlen helpers (``ops/varlen.py``), the tile bounds of the block
kernels (``ops/block_meta.py``) and the plain block versions with segment
ids and positions, on identical numpy inputs.

The plain versions (``naive_block_fwd``/``naive_block_bwd``) are what the
kernels B1, B2 and B3a/B3b are held against on the card; here they are held
against JAX's block functions in interpret mode (the Pallas kernels' own
skip logic) and on its XLA path, at ``tests/test_block_skip.py``'s cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.ops import varlen as jvarlen
from ring_flash_attn_tpu.ops.flash import block_bwd as jax_block_bwd
from ring_flash_attn_tpu.ops.flash import block_fwd as jax_block_fwd
from ring_flash_attn_tpu.ops.flash import compute_delta as jax_compute_delta
from ring_flash_attn_tpu.ops.mask import MaskArgs as JMask
from ring_flash_attn_tpu.ops.pallas_fwd import block_meta as jax_block_meta
from ring_flash_attn_tpu_torch.ops import varlen as tvarlen
from ring_flash_attn_tpu_torch.ops.block_meta import (
    block_meta, index_causal, kernel_segments, segmented)
from ring_flash_attn_tpu_torch.ops.flash import (
    block_bwd, block_fwd, compute_delta)
from ring_flash_attn_tpu_torch.ops.mask import (
    MaskArgs, allowed_mask, check_supported)

OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, JAX's tests/test_varlen.py limits

# the reference's packings (benchmark_varlen_kvpacked_func.py:45-50) scaled
# from 8192 to 256 tokens, and edge packings: one sequence, a 1-token
# sequence, T not a multiple of 128
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


def _random_packing(seed, total):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, total), 5, replace=False))
    return [0, *cuts.tolist(), total]


# ---- ops/varlen.py ----


@pytest.mark.parametrize("cu", PACKINGS + [_random_packing(s, 400)
                                           for s in range(3)])
def test_varlen_helpers_match_jax(cu):
    """cu_seqlens_to_segids / _positions, given as a list, a numpy array
    and a tensor, and local_chunk_info: exactly JAX's."""
    t = cu[-1]
    want_seg = np.asarray(jvarlen.cu_seqlens_to_segids(np.asarray(cu), t))
    want_pos = np.asarray(jvarlen.cu_seqlens_to_positions(np.asarray(cu), t))
    for given in (cu, np.asarray(cu, np.int64), torch.tensor(cu)):
        seg = tvarlen.cu_seqlens_to_segids(given, t)
        pos = tvarlen.cu_seqlens_to_positions(given, t)
        assert seg.dtype == pos.dtype == torch.int32
        np.testing.assert_array_equal(seg.numpy(), want_seg)
        np.testing.assert_array_equal(pos.numpy(), want_pos)
    for got, want in zip(tvarlen.local_chunk_info(seg),
                         jvarlen.local_chunk_info(jnp.asarray(want_seg))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_and_zigzag_layouts_match_jax(world):
    """ring_varlen_info, zigzag_varlen_info and the two extract_local
    layouts, every rank: exactly JAX's, on numpy arrays and tensors."""
    cu = np.array([0, 8 * world, 24 * world, 28 * world], np.int32)
    total = int(cu[-1])
    x = np.arange(total * 3).reshape(total, 3)
    for r in range(world):
        local = cu // world
        for got, want in zip(
                tvarlen.ring_varlen_info(local, total // world, r),
                jvarlen.ring_varlen_info(jnp.asarray(local), total // world,
                                         r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        half = cu // (2 * world)
        for got, want in zip(
                tvarlen.zigzag_varlen_info(half, total // world, r, world),
                jvarlen.zigzag_varlen_info(jnp.asarray(half), total // world,
                                           r, world)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for name in ("extract_local_ring_varlen",
                     "extract_local_zigzag_varlen"):
            want = getattr(jvarlen, name)(x, cu, r, world)
            np.testing.assert_array_equal(
                getattr(tvarlen, name)(x, cu, r, world), want)
            np.testing.assert_array_equal(getattr(tvarlen, name)(
                torch.from_numpy(x), cu, r, world).numpy(), want)


# ---- ops/block_meta.py ----


def _edge_pad(x, blk):
    """x padded to a multiple of blk by its last entry: JAX's block_meta
    needs whole tiles, and repeating the last entry leaves a ragged tile's
    bounds those of its valid entries."""
    n = -len(x) % blk
    return np.concatenate([x, np.repeat(x[-1:], n)])


# each port kernel's tiles (q rows, keys): B1; B3a (and B1 at head_dim
# 256); B2 and B3b; B2, B3a and B3b at head_dim 256
TILES = [(128, 128), (128, 64), (64, 128), (64, 64)]


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("case",
                         ["packed", "shuffled", "unequal", "noncausal"])
def test_block_meta_matches_jax(tiles, case):
    """The port's block_meta (torch, on the tensors' device) against JAX's
    block_meta(..., xp=np), exactly, at each kernel's tile sizes, with
    ragged T (Sq = 300 and Skv = 457 are multiples of no tile)."""
    blk_q, blk_kv = tiles
    rng = np.random.default_rng(len(case))
    sq, skv = (300, 300) if case in ("packed", "shuffled") else (300, 457)
    if case == "packed":
        cu = [0, 17, 150, 151, 300]
        qs = ks = np.asarray(tvarlen.cu_seqlens_to_segids(cu, sq))
        qp = kp = np.asarray(tvarlen.cu_seqlens_to_positions(cu, sq))
    else:
        qs = np.sort(rng.integers(0, 6, sq)).astype(np.int32)
        ks = np.sort(rng.integers(0, 6, skv)).astype(np.int32)
        qp = rng.integers(0, 400, sq).astype(np.int32)
        kp = rng.integers(0, 400, skv).astype(np.int32)
        if case == "shuffled":
            rng.shuffle(qs)
    causal = case != "noncausal"
    want = jax_block_meta(
        JMask(causal=causal, q_segids=_edge_pad(qs, blk_q),
              kv_segids=_edge_pad(ks, blk_kv), q_pos=_edge_pad(qp, blk_q),
              kv_pos=_edge_pad(kp, blk_kv)),
        blk_q, blk_kv, blk_kv, -(-sq // blk_q), -(-skv // blk_kv), xp=np)
    got = block_meta(
        MaskArgs(causal=causal, q_segids=torch.from_numpy(qs),
                 kv_segids=torch.from_numpy(ks), q_pos=torch.from_numpy(qp),
                 kv_pos=torch.from_numpy(kp)),
        blk_q, blk_kv, sq, skv)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_segments_checks_and_flags():
    """What the launchers pass: int64 ids narrowed (and refused past int32),
    wrong lengths and types refused, positions dropped where the mask is
    not causal, packed_self only with causal positions, the bounds reused
    for the same tensors and rebuilt after an in-place write."""
    seg = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int64)
    pos = torch.tensor([0, 1, 0, 1, 2], dtype=torch.int64)
    mask = MaskArgs(causal=True, q_segids=seg, kv_segids=seg, q_pos=pos,
                    kv_pos=pos, packed_self=True)
    assert segmented(mask) and not index_causal(mask)
    assert index_causal(MaskArgs(causal=True, q_segids=seg, kv_segids=seg))
    assert not segmented(MaskArgs(q_pos=pos, kv_pos=pos))
    dev = torch.device("cpu")
    args, held = kernel_segments(mask, dev, 5, 5, 128, 64)
    assert args.tri == 1 and args.n_q == 1 and args.n_kv == 1
    assert all(x.dtype == torch.int32 for x in held)
    again, _ = kernel_segments(mask, dev, 5, 5, 128, 64)
    assert again is args  # the same tensors: the bounds are reused
    seg[4] = 2
    fresh, held = kernel_segments(mask, dev, 5, 5, 128, 64)
    assert fresh is not args and int(held[4][1, 0]) == 2  # seg_max
    args, _ = kernel_segments(mask._replace(causal=False), dev, 5, 5, 64,
                              128)
    assert args.q_pos is None and args.tri == 0
    for bad, err in ((mask._replace(q_segids=seg[:4]), ValueError),
                     (mask._replace(q_segids=seg.float()), TypeError),
                     (mask._replace(q_segids=seg + 2**31), ValueError)):
        with pytest.raises(err):
            kernel_segments(bad, dev, 5, 5, 128, 128)


# ---- the plain block versions against JAX's Pallas kernels ----

B, HQ, HKV, S, D = 1, 4, 2, 256, 64
SCALE = D**-0.5


def _skip_cases():
    """tests/test_block_skip.py's CASES without its window cases."""
    cu = [0, 16, 160, 224, 256]
    seg = np.asarray(jvarlen.cu_seqlens_to_segids(np.asarray(cu), S))
    pos = np.asarray(jvarlen.cu_seqlens_to_positions(np.asarray(cu), S))
    shuf = np.random.RandomState(0).permutation(
        np.repeat(np.arange(8), S // 8)).astype(np.int32)
    return {
        "varlen_causal": dict(causal=True, q_segids=seg, kv_segids=seg,
                              q_pos=pos, kv_pos=pos),
        "varlen_noncausal": dict(q_segids=seg, kv_segids=seg),
        "shuffled_segs": dict(q_segids=shuf, kv_segids=shuf),
        "seg_causal_iota": dict(causal=True, q_segids=seg, kv_segids=seg),
    }


SKIP_CASES = _skip_cases()


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_naive_blocks_match_jax_kernels(case, backend):
    """naive_block_fwd / naive_block_bwd with segment ids and positions
    against JAX's block_fwd / block_bwd, its Pallas kernels in interpret
    mode (their tile skip and dispatch) and its XLA path: out, lse and
    every gradient; dead rows give (0, NEG_INF)."""
    kw = SKIP_CASES[case]
    q, k, v, dout = (_np((B, HQ, S, D), 0), _np((B, HKV, S, D), 1),
                     _np((B, HKV, S, D), 2), _np((B, HQ, S, D), 3))
    jmask = JMask(**{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                     for n, x in kw.items()})
    tmask = MaskArgs(**{n: torch.from_numpy(x) if isinstance(x, np.ndarray)
                        else x for n, x in kw.items()})
    jo, jl = jax_block_fwd(*map(jnp.asarray, (q, k, v)), SCALE, jmask,
                           backend=backend)
    to, tl = block_fwd(*map(torch.from_numpy, (q, k, v)), SCALE, tmask)
    assert _err(to, jo) <= OUT_TOL and _err(tl, jl) <= OUT_TOL
    jd = jax_compute_delta(jnp.asarray(dout), jo)
    want = jax_block_bwd(jnp.asarray(dout), *map(jnp.asarray, (q, k, v)), jl,
                         jd, SCALE, jmask, backend=backend)
    got = block_bwd(torch.from_numpy(dout), *map(torch.from_numpy, (q, k, v)),
                    tl, compute_delta(torch.from_numpy(dout), to), SCALE,
                    tmask)
    for g, w in zip(got, want):
        assert _err(g, w) <= GRAD_TOL


def test_dead_rows_and_unseen_keys():
    """A q segment that kv lacks: its rows give out = 0, lse = NEG_INF and
    dq = 0; keys no row sees give dk = dv = 0 (the plain versions, as the
    kernels on the card)."""
    from ring_flash_attn_tpu_torch.ops.mask import NEG_INF

    q, k, v, dout = (torch.from_numpy(_np((1, 2, 12, 8), s))
                     for s in range(4))
    q_seg = torch.tensor([0] * 4 + [7] * 4 + [1] * 4)
    kv_seg = torch.tensor([0] * 6 + [1] * 3 + [2] * 3)
    mask = MaskArgs(q_segids=q_seg, kv_segids=kv_seg)
    out, lse = block_fwd(q, k, v, 0.3, mask)
    dead = q_seg == 7
    assert torch.all(out[:, :, dead] == 0)
    assert torch.all(lse[:, :, dead] == NEG_INF)
    dq, dk, dv = block_bwd(dout, q, k, v, lse, compute_delta(dout, out), 0.3,
                           mask)
    assert torch.all(dq[:, :, dead] == 0)
    unseen = ~allowed_mask(mask, 12, 12).any(0)
    assert unseen.sum() == 3
    assert torch.all(dk[:, :, unseen] == 0)
    assert torch.all(dv[:, :, unseen] == 0)
    assert torch.all(dk[:, :, ~unseen].abs().sum(-1) > 0)


def test_positions_override_the_offset():
    """Explicit positions override offset/kv_offset, as in JAX: the same
    mask with any offset gives the same result; shuffled positions hold
    no index order (no bound by index may apply)."""
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.permutation(24).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, 2, 24).astype(np.int32))
    q, k, v = (torch.from_numpy(_np((1, 2, 24, 8), s)) for s in range(3))
    mask = MaskArgs(causal=True, q_segids=seg, kv_segids=seg, q_pos=pos,
                    kv_pos=pos)
    ref = block_fwd(q, k, v, 0.3, mask)
    got = block_fwd(q, k, v, 0.3, mask._replace(offset=100, kv_offset=3))
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    allowed = allowed_mask(mask, 24, 24)
    want = (seg[:, None] == seg[None, :]) & (pos[:, None] >= pos[None, :])
    assert torch.equal(allowed, want)
    assert bool((allowed & (torch.arange(24)[:, None]
                            < torch.arange(24)[None, :])).any())
    # softcap and ALiBi pass the check with positions (the block kernels
    # take them since the softcap/ALiBi slice); a window, which raised
    # before its slice, passes it and bounds on the positions as JAX's does
    for field in ({"softcap": 5.0}, {"alibi_slopes": np.ones(2)}):
        check_supported(mask._replace(**field))
    windowed = mask._replace(window_left=3)
    check_supported(windowed)
    jmask = JMask(causal=True, q_segids=jnp.asarray(seg.numpy()),
                  kv_segids=jnp.asarray(seg.numpy()),
                  q_pos=jnp.asarray(pos.numpy()),
                  kv_pos=jnp.asarray(pos.numpy()), window_left=3)
    jo, jl = jax_block_fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                           0.3, jmask, backend="xla")
    got = block_fwd(q, k, v, 0.3, windowed)
    assert float((got[0] - torch.from_numpy(np.asarray(jo))).abs().max()) \
        <= 1e-5
    assert float((got[1] - torch.from_numpy(np.asarray(jl))).abs().max()) \
        <= 1e-5
    assert torch.equal(allowed_mask(windowed, 24, 24),
                       want & (pos[:, None] - pos[None, :] <= 3))
