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

Ported: softcap, which is mask-free and rides every step (in the plain
versions only: on CUDA tensors the block kernels raise
``NotImplementedError`` for it). ``alibi_slopes``, ``dropout_p`` and
``window_left`` need explicit q/kv positions, which are not ported yet, and
raise.

The half slices are views. The block kernels take them as they are where
their TMA maps read them (``_kernel_layout``, which ``block_fwd`` applies
and the backward calls), as they do every half this schedule makes; the
fp32 row vectors lse and delta must be contiguous for the kernels and are
copied then, and only then.
"""

import torch

from ..config import use_kernel
from ..ops.flash import _kernel_layout, block_bwd, block_fwd, compute_delta
from ..ops.mask import MaskArgs
from ..ops.merge import merge_partials
from .mesh import RingBuffer, ring_rank, ring_size
from .ring import check_ring_options


def _zigzag_fwd(q, k, v, scale, group, backend, extras):
    w = ring_size(group)
    rank = ring_rank(group)
    half = q.shape[2] // 2
    plain = MaskArgs(**extras)
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)
    out = lse = None
    for step in range(w):
        # post the rotation before this step's kernels
        if step < w - 1:
            kv.start()
        kk, vv = kv.value[0], kv.value[1]
        if step == 0:
            b_out, b_lse = block_fwd(q, kk, vv, scale,
                                     MaskArgs(causal=True, **extras), backend)
            out, lse = merge_partials(None, None, b_out, b_lse)
        elif step <= rank:
            # kv of an earlier rank: its first half lies before every local
            # token, its second half after
            b_out, b_lse = block_fwd(q, kk[:, :, :half], vv[:, :, :half],
                                     scale, plain, backend)
            out, lse = merge_partials(out, lse, b_out, b_lse)
        else:
            # kv of a later rank: only the second half of q (chunk 2W-1-r,
            # after every received position) attends, to all of it
            b_out, b_lse = block_fwd(q[:, :, half:], kk, vv, scale, plain,
                                     backend)
            m_out, m_lse = merge_partials(out[:, :, half:], lse[:, :, half:],
                                          b_out, b_lse)
            out[:, :, half:] = m_out
            lse[:, :, half:] = m_lse
        kv.wait()
    return out, lse


def _zigzag_bwd(q, k, v, out, lse, dout, scale, group, backend, extras,
                deterministic=False):
    """(dq, dk, dv) fp32 of this rank's shards. ``deterministic`` asks
    ``block_bwd`` for the bitwise reproducible split kernels."""
    w = ring_size(group)
    rank = ring_rank(group)
    half = q.shape[2] // 2
    kernel = use_kernel(q, backend)
    plain = MaskArgs(**extras)
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
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)
    dq = dkv = None
    for step in range(w):
        if step < w - 1:
            kv.start()
        kk, vv = kv.value[0], kv.value[1]
        if step == 0:
            dq, b_dk, b_dv = block_bwd(
                dout, q, kk, vv, lse, delta, scale,
                MaskArgs(causal=True, **extras), backend, fused=fused)
            dkv = RingBuffer(torch.stack([b_dk, b_dv]), group)
        elif step <= rank:
            b_dq, b_dk, b_dv = block_bwd(
                dout, q, view(kk[:, :, :half]), view(vv[:, :, :half]), lse,
                delta, scale, plain, backend, fused=fused)
            dq += b_dq
            dkv.value[0, :, :, :half] += b_dk
            dkv.value[1, :, :, :half] += b_dv
        else:
            b_dq, b_dk, b_dv = block_bwd(dout1, q1, kk, vv, lse1, delta1,
                                         scale, plain, backend, fused=fused)
            dq[:, :, half:] += b_dq
            dkv.value[0] += b_dk
            dkv.value[1] += b_dv
        # dkv rotates after every step: W rotations bring it home
        dkv.rotate()
        kv.wait()
    return dq, dkv.value[0], dkv.value[1]


class _ZigzagRingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, group, backend, extras, deterministic):
        out, lse = _zigzag_fwd(q, k, v, scale, group, backend, extras)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (scale, group, backend, extras, deterministic)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        scale, group, backend, extras, deterministic = ctx.args
        if use_kernel(q, backend):
            dout = _kernel_layout(dout)
        dq, dk, dv = _zigzag_bwd(q, k, v, out, lse, dout, scale, group,
                                 backend, extras, deterministic)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def zigzag_ring_attention(q, k, v, *, scale, group=None, backend=None,
                          softcap=None, alibi_slopes=None, dropout_p=None,
                          dropout_seed=None, window_left=None,
                          deterministic=False):
    """Differentiable zigzag ring attention on per-process (B, H, S, D)
    tensors laid out per ``extract_local_zigzag`` over ``group`` (None: the
    default group, or one process when none is initialised). Causal only.
    Returns (out in q.dtype, lse fp32 (B, H, S)); lse carries no gradient.
    ``deterministic=True`` runs the backward's steps on the bitwise
    reproducible split kernels B3a/B3b on the card."""
    check_ring_options("zigzag_ring_attention",
                       alibi_slopes=alibi_slopes is not None,
                       dropout_p=dropout_p,
                       window_left=window_left is not None)
    if q.shape[2] % 2:
        raise ValueError(f"the local length {q.shape[2]} must be even: a "
                         f"rank holds two chunks")
    extras = dict(softcap=softcap)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _ZigzagRingAttention.apply(q, k, v, scale, group, backend,
                                          extras, deterministic)
    out, lse = _zigzag_fwd(q, k, v, scale, group, backend, extras)
    return out.to(q.dtype), lse
