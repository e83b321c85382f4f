"""Zigzag ring attention schedule (compute-balanced causal ring).

The port of ``ring_flash_attn_tpu/parallel/zigzag.py``. Token layout: the
global sequence splits into 2W chunks and rank r holds chunks [r, 2W-1-r]
(``layouts.extract_local_zigzag``). Each step then does equal work on every
rank:

  step 0:          full local q vs full local kv, plain causal: on the
                   concatenated [chunk r, chunk 2W-1-r] layout this equals
                   the true positional causal mask
  1 <= step <= r:  full q vs the FIRST half of the received kv (all earlier
                   positions), no mask
  step > r:        the SECOND half of q vs the full received kv, no mask,
                   merged into the second half of the accumulator

Causal only. Backward mirrors the three cases with half-buffer
accumulations, using the same co-rotating fp32 dk/dv accumulator as
``ring.py``, and the same posted rotation.

Ported: softcap, which is mask-free and rides every step, and ALiBi, which
needs the layout's global positions: local token i of rank r sits at
r·C + i (first chunk) or (2W-1-r)·C + (i - C) (second chunk), C = L/2, so
with ALiBi, dropout or a causal ``window_left`` every step passes explicit
q_pos/kv_pos (of the resident shard's source rank), causal on them on the
diagonal and, with a window, off it too (the causal half holds trivially
there, the window bounds); the dropout hash of global positions drops the
same pairs as the single-device call, bit for bit. On the card they go to
the block kernels' XFORM and BAND instantiations (B1; B2, or B3a/B3b).

The step loops take the masks from a hook, ``step_masks(step, rank, w)``
-> (diagonal, earlier, later), so that zigzag varlen (``zigzag_varlen.py``)
runs on them with its own. A rank's work is ``zigzag_rank_fwd`` /
``zigzag_rank_bwd``, which take the resident kv from ``kv_at(step)`` and
hand dk, dv to ``add_dkv``; ``zigzag_loop_fwd`` / ``_bwd`` give them the
ring, and a caller holding every rank's shards in one process may give
them its own.

The half slices are views. The block kernels take them as they are where
their TMA maps read them (``_kernel_layout``, which ``block_fwd`` applies
and the backward calls), as they do every half this schedule makes; the
fp32 row vectors lse and delta must be contiguous for the kernels and are
copied then, and only then.
"""

import torch

from ..config import use_kernel
from ..ops.flash import _kernel_layout, block_bwd, block_fwd, compute_delta
from ..ops.mask import MaskArgs, slopes_on
from ..ops.merge import merge_partials
from .mesh import RingBuffer, ring_rank, ring_size


def zigzag_positions(rank, w, half, device=None):
    """(2 half,) int32 global positions of rank ``rank``'s local tokens
    (chunks [rank, 2W-1-rank] of C = half tokens each)."""
    i = torch.arange(2 * half, dtype=torch.int32, device=device)
    return torch.where(i < half, rank * half + i,
                       (2 * w - 1 - rank) * half + (i - half)).to(
                           torch.int32)


def _batch_masks(half, extras, device):
    """The zigzag schedule's ``step_masks(step, rank, w)``: (diagonal,
    earlier, later) masks; with ALiBi, dropout or a window on the layout's
    global positions, made once a step and reused by the backward (the
    kernels' tile bounds are cached by tensor)."""
    window = extras.get("window_left") is not None
    if (extras.get("alibi_slopes") is None and not extras.get("dropout_p")
            and not window):
        diag, plain = MaskArgs(causal=True, **extras), MaskArgs(**extras)
        return lambda step, rank, w: (diag, plain, plain)
    made = {}

    def step_masks(step, rank, w):
        if (step, rank, w) not in made:
            qpos = zigzag_positions(rank, w, half, device)
            kvpos = zigzag_positions((rank - step) % w, w, half, device)
            made[step, rank, w] = (
                MaskArgs(causal=True, q_pos=qpos, kv_pos=qpos, **extras),
                MaskArgs(causal=window, q_pos=qpos, kv_pos=kvpos[:half],
                         **extras),
                MaskArgs(causal=window, q_pos=qpos[half:], kv_pos=kvpos,
                         **extras))
        return made[step, rank, w]

    return step_masks


def zigzag_rank_fwd(q, kv_at, rank, w, scale, backend, step_masks):
    """One rank's zigzag forward (module docstring): ``kv_at(step)`` gives
    the (k, v) resident at ``step``, the shards of rank (rank - step) % w,
    and ``step_masks`` the masks. Returns the merged (out fp32, lse)."""
    half = q.shape[2] // 2
    out = lse = None
    for step in range(w):
        kk, vv = kv_at(step)
        diag, earlier, later = step_masks(step, rank, w)
        if step == 0:
            b_out, b_lse = block_fwd(q, kk, vv, scale, diag, backend)
            out, lse = merge_partials(None, None, b_out, b_lse)
        elif step <= rank:
            # kv of an earlier rank: its first half lies before every local
            # token, its second half after
            b_out, b_lse = block_fwd(q, kk[:, :, :half], vv[:, :, :half],
                                     scale, earlier, backend)
            out, lse = merge_partials(out, lse, b_out, b_lse)
        else:
            # kv of a later rank: only the second half of q (chunk 2W-1-r,
            # after every received position) attends, to all of it
            b_out, b_lse = block_fwd(q[:, :, half:], kk, vv, scale, later,
                                     backend)
            m_out, m_lse = merge_partials(out[:, :, half:], lse[:, :, half:],
                                          b_out, b_lse)
            out[:, :, half:] = m_out
            lse[:, :, half:] = m_lse
    return out, lse


def zigzag_rank_bwd(q, out, lse, dout, kv_at, add_dkv, rank, w, scale,
                    backend, step_masks, deterministic=False):
    """The dual of ``zigzag_rank_fwd``: returns this rank's dq (fp32) and
    hands each step's fp32 dk, dv of the resident kv to ``add_dkv(step,
    dk, dv, rows)``, ``rows`` the kv rows they cover. ``deterministic``
    asks ``block_bwd`` for the bitwise reproducible split kernels."""
    half = q.shape[2] // 2
    kernel = use_kernel(q, backend)
    fused = False if deterministic else None
    delta = compute_delta(dout, out)

    def view(x, rows=False):
        # a half slice in the layout the kernels take (see module docstring)
        if not kernel:
            return x
        return x.contiguous() if rows else _kernel_layout(x)

    if w > 1:
        dout1, q1 = view(dout[:, :, half:]), view(q[:, :, half:])
        lse1 = view(lse[:, :, half:], rows=True)
        delta1 = view(delta[:, :, half:], rows=True)
    dq = None
    for step in range(w):
        kk, vv = kv_at(step)
        diag, earlier, later = step_masks(step, rank, w)
        if step == 0:
            dq, b_dk, b_dv = block_bwd(dout, q, kk, vv, lse, delta, scale,
                                       diag, backend, fused=fused)
            add_dkv(step, b_dk, b_dv, slice(None))
        elif step <= rank:
            b_dq, b_dk, b_dv = block_bwd(
                dout, q, view(kk[:, :, :half]), view(vv[:, :, :half]), lse,
                delta, scale, earlier, backend, fused=fused)
            dq += b_dq
            add_dkv(step, b_dk, b_dv, slice(None, half))
        else:
            b_dq, b_dk, b_dv = block_bwd(dout1, q1, kk, vv, lse1, delta1,
                                         scale, later, backend, fused=fused)
            dq[:, :, half:] += b_dq
            add_dkv(step, b_dk, b_dv, slice(None))
    return dq


def _ring_kv(k, v, group):
    """``kv_at(step)`` of the ring: k and v travel as one stacked array,
    the rotation posted before each step's kernels and awaited before the
    next step's."""
    w = ring_size(group)
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)

    def kv_at(step):
        if step:
            kv.wait()
        if step < w - 1:
            kv.start()
        return kv.value[0], kv.value[1]

    return kv_at


def zigzag_loop_fwd(q, k, v, scale, group, backend, step_masks):
    """The zigzag forward over ``group``: ``zigzag_rank_fwd`` with the
    ring's kv. Returns the merged (out fp32, lse)."""
    return zigzag_rank_fwd(q, _ring_kv(k, v, group), ring_rank(group),
                           ring_size(group), scale, backend, step_masks)


def zigzag_loop_bwd(q, k, v, out, lse, dout, scale, group, backend,
                    step_masks, deterministic=False):
    """The zigzag backward over ``group``: ``zigzag_rank_bwd`` with the
    ring's kv and the co-rotating fp32 dk/dv accumulator. Returns (dq, dk,
    dv) fp32 of this rank's shards."""
    dkv = None

    def add_dkv(step, b_dk, b_dv, rows):
        nonlocal dkv
        if step == 0:
            dkv = RingBuffer(torch.stack([b_dk, b_dv]), group)
        else:
            dkv.value[0, :, :, rows] += b_dk
            dkv.value[1, :, :, rows] += b_dv
        # dkv rotates after every step: W rotations bring it home
        dkv.rotate()

    dq = zigzag_rank_bwd(q, out, lse, dout, _ring_kv(k, v, group), add_dkv,
                         ring_rank(group), ring_size(group), scale, backend,
                         step_masks, deterministic)
    return dq, dkv.value[0], dkv.value[1]


class ZigzagLoopAttention(torch.autograd.Function):
    """``zigzag_loop_fwd`` and ``zigzag_loop_bwd`` as one differentiable
    function: apply(q, k, v, scale, group, backend, step_masks,
    deterministic) -> (out in q.dtype, lse), lse with no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group, backend, step_masks,
                deterministic):
        out, lse = zigzag_loop_fwd(q, k, v, scale, group, backend,
                                   step_masks)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (scale, group, backend, step_masks, deterministic)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        scale, group, backend, step_masks, deterministic = ctx.args
        if use_kernel(q, backend):
            dout = _kernel_layout(dout)
        dq, dk, dv = zigzag_loop_bwd(q, k, v, out, lse, dout, scale, group,
                                     backend, step_masks, deterministic)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def zigzag_loop(q, k, v, scale, group, backend, step_masks, deterministic):
    """The zigzag step loops on ``step_masks``, differentiable where q, k
    or v asks for a gradient: (out in q.dtype, lse)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return ZigzagLoopAttention.apply(q, k, v, scale, group, backend,
                                         step_masks, deterministic)
    out, lse = zigzag_loop_fwd(q, k, v, scale, group, backend, step_masks)
    return out.to(q.dtype), lse


def zigzag_ring_attention(q, k, v, *, scale, group=None, backend=None,
                          softcap=None, alibi_slopes=None, dropout_p=None,
                          dropout_seed=None, window_left=None,
                          head_offset=None, deterministic=False):
    """Differentiable zigzag ring attention on per-process (B, H, S, D)
    tensors laid out per ``extract_local_zigzag`` over ``group`` (None: the
    default group, or one process when none is initialised). Causal only.
    Returns (out in q.dtype, lse fp32 (B, H, S)); lse carries no gradient.
    ``head_offset`` is the global id of q head 0 for the dropout hash (USP
    passes it). ``deterministic=True`` runs the backward's steps on the
    bitwise reproducible split kernels B3a/B3b on the card."""
    if q.shape[2] % 2:
        raise ValueError(f"the local length {q.shape[2]} must be even: a "
                         f"rank holds two chunks")
    extras = dict(softcap=softcap,
                  alibi_slopes=slopes_on(alibi_slopes, q.device),
                  window_left=window_left)
    if dropout_p:
        extras.update(dropout_p=dropout_p, dropout_seed=dropout_seed,
                      head_offset=head_offset)
    step_masks = _batch_masks(q.shape[2] // 2, extras, q.device)
    return zigzag_loop(q, k, v, scale, group, backend, step_masks,
                       deterministic)
