"""Softcap and ALiBi on the block kernels' path against the JAX package,
on the CPU, on identical numpy inputs.

- ``ops/mask.py::kernel_positions`` (explicit positions reach the kernels
  under a causal mask on them or under ALiBi) and how the launchers pick
  an instantiation (``segmented``, ``has_xform``, ``index_causal``);
- the tile bounds that the segmented XFORM instantiations take when ALiBi
  brings positions without a causal mask (``kernel_segments``): exactly
  JAX's ``block_meta`` for the same mask, with no skip on positions;
- the transform's launch arguments (``kernel_xform``), the slopes made
  once a tensor;
- the plain block versions, which the kernels B1, B2 and B3a/B3b are held
  against on the card, with softcap and ALiBi on segments, explicit
  positions and offsets, against JAX's block functions in interpret mode
  (its Pallas kernels) and on its XLA path.
"""

import ctypes

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
from ring_flash_attn_tpu_torch.ops.block_meta import (
    INT32_MIN, LOG2E, has_xform, index_causal, kernel_segments,
    kernel_xform, segmented, tile_steps)
from ring_flash_attn_tpu_torch.ops.flash import (
    block_bwd, block_fwd, compute_delta)
from ring_flash_attn_tpu_torch.ops.mask import (
    MaskArgs, kernel_positions, slopes_on)

OUT_TOL, GRAD_TOL = 2e-5, 1e-4  # f32, JAX's tests/test_varlen.py limits
B, HQ, HKV, S, D = 1, 4, 2, 256, 64
SCALE = D**-0.5
SLOPES = np.array([2.0 ** (-8.0 * (i + 1) / HQ) for i in range(HQ)],
                  np.float32)
CU = [0, 16, 160, 224, 256]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _seg_pos(cu, t):
    return (np.asarray(jvarlen.cu_seqlens_to_segids(np.asarray(cu), t)),
            np.asarray(jvarlen.cu_seqlens_to_positions(np.asarray(cu), t)))


def test_kernel_positions_and_the_instantiation_picked():
    """Positions reach the kernels with a causal mask on them or with
    ALiBi, and only then make a mask segmented; softcap or ALiBi pick the
    XFORM instantiations; a mask on explicit positions is never causal by
    index."""
    pos = torch.arange(8, dtype=torch.int32)
    seg = torch.zeros(8, dtype=torch.int32)
    p = dict(q_pos=pos, kv_pos=pos)
    # mask: (kernel_positions, segmented, has_xform, index_causal)
    table = [
        (MaskArgs(), (False, False, False, False)),
        (MaskArgs(causal=True), (False, False, False, True)),
        (MaskArgs(**p), (False, False, False, False)),
        (MaskArgs(causal=True, **p), (True, True, False, False)),
        (MaskArgs(alibi_slopes=SLOPES, **p), (True, True, True, False)),
        (MaskArgs(softcap=5.0, **p), (False, False, True, False)),
        (MaskArgs(softcap=0.0, **p), (False, False, False, False)),
        (MaskArgs(alibi_slopes=SLOPES, offset=3), (False, False, True,
                                                    False)),
        (MaskArgs(causal=True, softcap=5.0, q_segids=seg, kv_segids=seg),
         (False, True, True, True)),
        (MaskArgs(causal=True, alibi_slopes=SLOPES, q_segids=seg,
                  kv_segids=seg, **p), (True, True, True, False)),
    ]
    for mask, want in table:
        got = (kernel_positions(mask), segmented(mask), has_xform(mask),
               index_causal(mask))
        assert got == want, mask


# each port kernel's tiles (q rows, keys): B1; B3a; B2 and B3b
TILES = [(128, 128), (128, 64), (64, 128)]


def _edge_pad(x, blk):
    """x padded to a multiple of blk by its last entry (JAX's block_meta
    takes whole tiles; the last entry repeated keeps a ragged tile's
    bounds those of its valid entries)."""
    return np.concatenate([x, np.repeat(x[-1:], -len(x) % blk)])


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("case", ["alibi positions", "alibi segments",
                                  "alibi causal packed"])
def test_alibi_tile_bounds_match_jax(tiles, case):
    """What the launchers hand a segmented XFORM launch (``kernel_segments``)
    where ALiBi brings explicit positions: the tile bounds are exactly
    JAX's block_meta of the same mask (no tile skipped on positions
    without a causal mask), the positions reach the kernel, and the
    kernel's causal-on-positions flag and index bound (tri) are set only
    with a causal mask."""
    blk_q, blk_kv = tiles
    sq, skv = 300, 457
    rng = np.random.default_rng(len(case))
    seg_q = np.sort(rng.integers(0, 5, sq)).astype(np.int32)
    seg_k = np.sort(rng.integers(0, 5, skv)).astype(np.int32)
    qp = rng.integers(0, 500, sq).astype(np.int32)
    kp = rng.integers(0, 500, skv).astype(np.int32)
    causal = packed = False
    kw = dict(q_pos=qp, kv_pos=kp)
    if case == "alibi segments":
        kw.update(q_segids=seg_q, kv_segids=seg_k)
    elif case == "alibi causal packed":
        sq = skv = 300
        seg, pos = _seg_pos([0, 17, 150, 151, 300], sq)
        kw = dict(q_segids=seg, kv_segids=seg, q_pos=pos, kv_pos=pos)
        causal = packed = True
    pads = {"q_segids": blk_q, "q_pos": blk_q, "kv_segids": blk_kv,
            "kv_pos": blk_kv}
    want = jax_block_meta(
        JMask(causal=causal, alibi_slopes=jnp.asarray(SLOPES),
              **{n: _edge_pad(x, pads[n]) for n, x in kw.items()}),
        blk_q, blk_kv, blk_kv, -(-sq // blk_q), -(-skv // blk_kv), xp=np)
    mask = MaskArgs(causal=causal, alibi_slopes=SLOPES, packed_self=packed,
                    **{n: torch.from_numpy(x) for n, x in kw.items()})
    args, held = kernel_segments(mask, torch.device("cpu"), sq, skv, blk_q,
                                 blk_kv)
    for got, w in zip(held[4:6], want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert args.q_pos is not None and args.kv_pos is not None
    assert args.pos_causal == int(causal) and args.tri == int(packed)
    # each tile's step, for the unmasked tiles' ALiBi
    for got, x, blk in ((held[6], kw["q_pos"], blk_q),
                        (held[7], kw["kv_pos"], blk_kv)):
        np.testing.assert_array_equal(got.numpy(), _steps(x, blk))
    assert args.q_step == held[6].data_ptr()
    # without ALiBi and causal, the same positions do not reach the kernel
    if not causal:
        plain, _ = kernel_segments(mask._replace(alibi_slopes=None),
                                   torch.device("cpu"), sq, skv, blk_q,
                                   blk_kv)
        assert plain.q_pos is None and plain.pos_causal == 0


def _steps(x, blk):
    """tile_steps by a loop: the step of each tile whose entries run
    first + step i, else INT32_MIN."""
    out = []
    for t in range(0, len(x), blk):
        d = np.diff(np.asarray(x[t:t + blk], np.int64))
        out.append(0 if not len(d) else d[0] if (d == d[0]).all()
                   else INT32_MIN)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("blk", [1, 64, 128])
def test_tile_steps(blk):
    """Each tile's step: consecutive, strided (stripe's 4 i + 1), a tile
    broken by one entry, a ragged last tile of one entry, shuffled."""
    rng = np.random.default_rng(blk)
    broken = np.arange(300)
    broken[150] = 7
    for x in (np.arange(300) + 5, np.arange(257) * 4 + 1, broken,
              np.arange(129), rng.permutation(300)):
        got = tile_steps(torch.from_numpy(x.astype(np.int64)), blk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _steps(x, blk))


def test_kernel_xform_arguments():
    """The transform's launch arguments: the slopes times log2(e), the cap
    times log2(e), the relative offset of positions by index, |distance|
    without a causal mask; a slope count other than Hq is refused."""
    mask = MaskArgs(causal=True, offset=40, kv_offset=8, softcap=30.0,
                    alibi_slopes=SLOPES)
    args, slopes = kernel_xform(mask, HQ, torch.device("cpu"))
    np.testing.assert_allclose(slopes.numpy(), SLOPES * LOG2E, rtol=1e-7)
    assert args.slopes == slopes.data_ptr()
    assert args.cap2 == pytest.approx(30.0 * LOG2E, rel=1e-7)
    assert (args.pos_off, args.alibi_abs) == (32, 0)
    args, slopes = kernel_xform(MaskArgs(softcap=50.0), HQ,
                                torch.device("cpu"))
    assert slopes is None and not args.slopes and args.alibi_abs == 1
    pos = torch.arange(4)
    args, _ = kernel_xform(MaskArgs(alibi_slopes=SLOPES, q_pos=pos,
                                    kv_pos=pos, offset=7), HQ,
                           torch.device("cpu"))
    assert args.pos_off == 0  # explicit positions override the offsets
    assert ctypes.sizeof(args) == 24
    with pytest.raises(ValueError, match="one slope per q head"):
        kernel_xform(MaskArgs(alibi_slopes=SLOPES[:2]), HQ,
                     torch.device("cpu"))


def test_kernel_slopes_made_once_a_tensor():
    """A slopes tensor (``mask.slopes_on``, as the schedules pass it to
    every step's launch) is scaled by log2(e) once: the same tensor gives
    the same operand until it is written in place; numpy slopes are
    converted at each launch."""
    dev = torch.device("cpu")
    sl = slopes_on(SLOPES, dev)
    assert sl.dtype == torch.float32 and slopes_on(None, dev) is None
    sl = sl.clone()  # as_tensor shares SLOPES' memory; written below
    mask = MaskArgs(alibi_slopes=sl)
    _, first = kernel_xform(mask, HQ, dev)
    _, again = kernel_xform(mask, HQ, dev)
    assert again is first
    sl.mul_(2.0)
    _, after = kernel_xform(mask, HQ, dev)
    assert after is not first
    np.testing.assert_allclose(after.numpy(), 2 * SLOPES * LOG2E, rtol=1e-7)
    _, a = kernel_xform(MaskArgs(alibi_slopes=SLOPES), HQ, dev)
    _, b = kernel_xform(MaskArgs(alibi_slopes=SLOPES), HQ, dev)
    assert a is not b and torch.equal(a, b)
    with pytest.raises(ValueError, match="one slope per q head"):
        kernel_xform(mask, HQ + 1, dev)


def _xform_cases():
    seg, pos = _seg_pos(CU, S)
    shuf = np.random.RandomState(0).permutation(S).astype(np.int32)
    return {
        # ring varlen's and zigzag varlen's off-diagonal steps: segments,
        # ALiBi on positions without a causal mask
        "segments alibi positions full": dict(
            q_segids=seg, kv_segids=seg, q_pos=pos, kv_pos=pos + 3,
            alibi_slopes=SLOPES, softcap=20.0),
        # flash_attn_varlen_func's diagonal: causal positions, packed_self
        "packed causal softcap alibi": dict(
            causal=True, q_segids=seg, kv_segids=seg, q_pos=pos, kv_pos=pos,
            packed_self=True, softcap=20.0, alibi_slopes=SLOPES),
        # zigzag's steps: non-monotone positions, causal on them
        "shuffled positions causal alibi": dict(
            causal=True, q_pos=shuf, kv_pos=shuf, alibi_slopes=SLOPES),
        # llama3's and the ring's steps: offsets, causal or not
        "offsets full alibi": dict(offset=256, kv_offset=64,
                                   alibi_slopes=SLOPES),
        "offsets causal softcap alibi": dict(
            causal=True, offset=100, softcap=7.0, alibi_slopes=SLOPES),
        "segments index causal softcap": dict(
            causal=True, offset=0, q_segids=seg, kv_segids=seg,
            softcap=5.0),
    }


XFORM_CASES = _xform_cases()


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("case", sorted(XFORM_CASES))
def test_plain_blocks_with_xform_match_jax_kernels(case, backend):
    """naive_block_fwd / naive_block_bwd (the kernels' plain versions)
    with softcap and ALiBi against JAX's block_fwd / block_bwd, its Pallas
    kernels in interpret mode and its XLA path: out, lse and every
    gradient."""
    kw = XFORM_CASES[case]
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
