"""Basic ring attention schedule over a process group.

The port of ``ring_flash_attn_tpu/parallel/ring.py``: a W-step ring where
KV rotates to the next rank each step while the resident block is computed
(``block_fwd``: kernel B1 on the card) and merged into the running
(out, lse) with ``merge_partials``. Causal work-skipping: rank r computes at
steps 0..r only, with the diagonal (step 0) as the only causal block; the
rank is a host int here, so the skip is a Python ``if``, and the rotation
still runs on skipped steps.

Backward runs the dual ring: KV rotates forward while the fp32 dk/dv
accumulator co-rotates with it, so each KV shard's gradient accumulates in
flight and arrives home after a full circle (W rotations).

The rotation of step t + 1's KV is posted before step t's kernels are
launched and waited for after (``mesh.RingBuffer``, two buffers that take
turns): what XLA's scheduler gives the JAX code for free is explicit here.

Ported: causal or not, softcap and ALiBi (ALiBi needs global coordinates,
so those steps carry ``offset = rank * L`` and ``kv_offset = src * L``).
softcap and ALiBi run in the plain versions only: on CUDA tensors the block
kernels raise ``NotImplementedError`` for them (``backend="plain"`` runs
them on the card). ``dropout_p``, ``window_left`` and ``window_right`` are
not ported yet and raise.

Functions are per-process, on tensors sharded contiguously along S over
``group`` (None: the default group, or one process when none is
initialised). Internal layout (B, H, S, D).
"""

import torch

from ..config import use_kernel
from ..ops.flash import _kernel_layout, block_bwd, block_fwd, compute_delta
from ..ops.mask import MaskArgs
from ..ops.merge import merge_partials
from .mesh import RingBuffer, ring_rank, ring_size


def _step_mask(step, rank, w, l_kv, causal, extras):
    """MaskArgs for ring step ``step``. ALiBi forces global coordinates;
    otherwise the offsets stay None and only the diagonal step is masked."""
    kw = dict(extras)
    if kw.get("alibi_slopes") is not None:
        kw.update(offset=rank * l_kv,
                  kv_offset=((rank - step) % w) * l_kv)
    return MaskArgs(causal=causal and step == 0, **kw)


def _ring_fwd(q, k, v, scale, causal, group, backend, extras):
    w = ring_size(group)
    rank = ring_rank(group)
    l_kv = k.shape[2]
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)
    out = lse = None
    for step in range(w):
        # post the rotation before computing on the resident block: the
        # message travels while this step's kernels run
        if step < w - 1:
            kv.start()
        if not causal or step <= rank:
            # causal: the kv resident at step s came from rank r - s, and a
            # rank attends only to earlier shards
            mask = _step_mask(step, rank, w, l_kv, causal, extras)
            b_out, b_lse = block_fwd(q, kv.value[0], kv.value[1], scale,
                                     mask, backend)
            out, lse = merge_partials(out, lse, b_out, b_lse)
        kv.wait()
    return out, lse


def _ring_bwd(q, k, v, out, lse, dout, scale, causal, group, backend,
              extras, deterministic=False):
    """(dq, dk, dv) fp32 of this rank's shards. ``deterministic`` asks
    ``block_bwd`` for the bitwise reproducible split kernels."""
    w = ring_size(group)
    rank = ring_rank(group)
    l_kv = k.shape[2]
    delta = compute_delta(dout, out)
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)
    dq = None
    # the dk/dv accumulator co-rotates with kv: after W rotations it is
    # home with every rank's contribution for that kv shard on board
    dkv = None
    for step in range(w):
        if step < w - 1:
            kv.start()
        if not causal or step <= rank:
            mask = _step_mask(step, rank, w, l_kv, causal, extras)
            b_dq, b_dk, b_dv = block_bwd(
                dout, q, kv.value[0], kv.value[1], lse, delta, scale, mask,
                backend, fused=False if deterministic else None)
            b_dkv = torch.stack([b_dk, b_dv])
            dq = b_dq if dq is None else dq.add_(b_dq)
            if dkv is None:  # step 0, which every rank computes
                dkv = RingBuffer(b_dkv, group)
            else:
                dkv.value.add_(b_dkv)
        # dkv rotates after every step, W in all, computed on or not
        dkv.rotate()
        kv.wait()
    return dq, dkv.value[0], dkv.value[1]


def check_ring_options(name, **unported):
    """Raise NotImplementedError for an option the ring schedules lack."""
    for option, value in unported.items():
        if value:
            raise NotImplementedError(
                f"{name}({option}=...) is not ported yet (see ROADMAP.md)")


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, group, backend, extras,
                deterministic):
        out, lse = _ring_fwd(q, k, v, scale, causal, group, backend, extras)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (scale, causal, group, backend, extras, deterministic)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, group, backend, extras, deterministic = ctx.args
        if use_kernel(q, backend):
            dout = _kernel_layout(dout)
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, dout, scale, causal,
                               group, backend, extras, deterministic)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def ring_attention(q, k, v, *, scale, causal, group=None, backend=None,
                   softcap=None, alibi_slopes=None, dropout_p=None,
                   dropout_seed=None, window_left=None, window_right=None,
                   deterministic=False):
    """Differentiable basic ring attention on per-process (B, H, S, D)
    tensors, q/k/v sharded contiguously along S over ``group``. Returns
    (out in q.dtype, lse fp32 (B, H, S)); lse carries no gradient.
    ``deterministic=True`` runs the backward's steps on the bitwise
    reproducible split kernels B3a/B3b on the card (``block_bwd``'s
    ``fused=False``)."""
    check_ring_options("ring_attention", dropout_p=dropout_p,
                       window_left=window_left is not None,
                       window_right=window_right is not None)
    extras = dict(softcap=softcap, alibi_slopes=alibi_slopes)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RingAttention.apply(q, k, v, scale, causal, group, backend,
                                    extras, deterministic)
    out, lse = _ring_fwd(q, k, v, scale, causal, group, backend, extras)
    return out.to(q.dtype), lse
