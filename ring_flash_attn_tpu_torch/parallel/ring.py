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
The step loops (``ring_loop_fwd``, ``ring_loop_bwd``, ``RingLoopAttention``)
take the schedule as a function that gives each step's mask, and the stripe
schedule (``stripe.py``) runs on them too.

Ported: causal or not, softcap and ALiBi, sliding windows (causal
``window_left``; not causal, ``window_left`` and ``window_right``) and
dropout. ALiBi and dropout need global coordinates, so those steps carry
``offset = rank * L`` and ``kv_offset = src * L``; the dropout hash of
absolute coordinates then drops the same pairs as the single-device call,
bit for bit. On the card they go to the block kernels' XFORM and BAND
instantiations (``backend="plain"`` runs the plain versions there).

The window is the JAX package's global band on absolute positions: a step
sees the true distance of its rows to the resident shard. That is where
this port (and the JAX package) departs from the reference, zhuzilin's
ring_flash_attn, which hands ``window_size`` to each step's flash call as
it is, a window local to the shard. A causal window needs the position
comparison on every step it computes; a step whose resident shard lies
wholly outside the window launches nothing (``_window_skip``, and for
non-causal windows ``_window_need`` on the rank), while its rotation, and
in the backward the fp32 dk/dv accumulator's, still runs.

Functions are per-process, on tensors sharded contiguously along S over
``group`` (None: the default group, or one process when none is
initialised). Internal layout (B, H, S, D).
"""

import torch

from ..config import use_kernel
from ..ops.flash import _kernel_layout, block_bwd, block_fwd, compute_delta
from ..ops.mask import MaskArgs, slopes_on
from ..ops.merge import merge_partials
from .mesh import RingBuffer, ring_rank, ring_size


def _step_mask(step, rank, w, l_kv, causal, extras):
    """MaskArgs for ring step ``step``. Position-dependent extras (ALiBi,
    dropout, a window) force global coordinates; otherwise the offsets
    stay None and only the diagonal step is masked.

    A causal window needs the position comparison on every step (the
    resident shard may lie partly outside it), so those steps are causal
    at the step's offset: the causal half holds trivially off the
    diagonal, and the window bounds. A non-causal window takes both
    absolute offsets, the true signed distance of the resident shard."""
    kw = dict(extras)
    wl = kw.pop("window_left", None)
    wr = kw.pop("window_right", None)
    need_abs = kw.get("alibi_slopes") is not None or bool(kw.get("dropout_p"))
    if need_abs or (not causal and (wl is not None or wr is not None)):
        kw.update(offset=rank * l_kv, kv_offset=((rank - step) % w) * l_kv)
    if wl is not None or wr is not None:
        if causal:
            if not need_abs and step > 0:
                kw.update(offset=(rank - (rank - step) % w) * l_kv)
            return MaskArgs(causal=True, window_left=wl, **kw)
        return MaskArgs(causal=False, window_left=wl, window_right=wr, **kw)
    return MaskArgs(causal=causal and step == 0, **kw)


def _window_skip(step, l_kv, causal, extras):
    """True when ring step ``step``'s resident shard lies wholly outside a
    causal window: its nearest pair is (step - 1) L + 1 apart."""
    wl = extras.get("window_left")
    return (causal and wl is not None and step > 0
            and step * l_kv - (l_kv - 1) > wl)


def _window_need(step, rank, w, l_kv, extras):
    """False when the resident shard at ring step ``step`` lies wholly
    outside a non-causal (left, right) window: its signed offset is
    (rank - src) L, src = (rank - step) mod W, which the rank decides."""
    wl = extras.get("window_left")
    wr = extras.get("window_right")
    if step == 0:
        return True
    rel = (rank - (rank - step) % w) * l_kv
    return ((wl is None or rel - (l_kv - 1) <= wl)
            and (wr is None or rel + (l_kv - 1) >= -wr))


def _ring_masks(causal, l_kv, extras):
    """The basic ring's ``step_mask(step, rank, w)`` for ``ring_loop_fwd``
    and ``ring_loop_bwd``: None where the step launches nothing: a causal
    rank's later shards (the kv resident at step s came from rank r - s,
    and a rank attends only to earlier shards), and shards outside a
    window."""
    def step_mask(step, rank, w):
        if causal and step > rank:
            return None
        if _window_skip(step, l_kv, causal, extras):
            return None
        if not causal and not _window_need(step, rank, w, l_kv, extras):
            return None
        return _step_mask(step, rank, w, l_kv, causal, extras)

    return step_mask


def ring_loop_fwd(q, k, v, scale, group, backend, step_mask):
    """The forward step loop that the ring and stripe schedules share: at
    step s the kv of rank (r - s) % W is resident, and ``step_mask(s, r,
    W)`` gives its block's MaskArgs, or None to skip the block. Step 0 must
    compute. Returns the merged (out fp32, lse)."""
    w = ring_size(group)
    rank = ring_rank(group)
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)
    out = lse = None
    for step in range(w):
        # post the rotation before computing on the resident block: the
        # message travels while this step's kernels run
        if step < w - 1:
            kv.start()
        mask = step_mask(step, rank, w)
        if mask is not None:
            b_out, b_lse = block_fwd(q, kv.value[0], kv.value[1], scale,
                                     mask, backend)
            out, lse = merge_partials(out, lse, b_out, b_lse)
        kv.wait()
    return out, lse


def ring_loop_bwd(q, k, v, out, lse, dout, scale, group, backend, step_mask,
                  deterministic=False):
    """The dual of ``ring_loop_fwd``: (dq, dk, dv) fp32 of this rank's
    shards. ``deterministic`` asks ``block_bwd`` for the bitwise
    reproducible split kernels."""
    w = ring_size(group)
    rank = ring_rank(group)
    delta = compute_delta(dout, out)
    kv = RingBuffer(torch.stack([k, v]) if w > 1 else (k, v), group)
    dq = None
    # the dk/dv accumulator co-rotates with kv: after W rotations it is
    # home with every rank's contribution for that kv shard on board
    dkv = None
    for step in range(w):
        if step < w - 1:
            kv.start()
        mask = step_mask(step, rank, w)
        if mask is not None:
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


class RingLoopAttention(torch.autograd.Function):
    """``ring_loop_fwd`` and ``ring_loop_bwd`` as one differentiable
    function: apply(q, k, v, scale, group, backend, step_mask,
    deterministic) -> (out in q.dtype, lse), lse with no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group, backend, step_mask,
                deterministic):
        out, lse = ring_loop_fwd(q, k, v, scale, group, backend, step_mask)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (scale, group, backend, step_mask, deterministic)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        scale, group, backend, step_mask, deterministic = ctx.args
        if use_kernel(q, backend):
            dout = _kernel_layout(dout)
        dq, dk, dv = ring_loop_bwd(q, k, v, out, lse, dout, scale, group,
                                   backend, step_mask, deterministic)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q, k, v, *, scale, causal, group=None, backend=None,
                   softcap=None, alibi_slopes=None, dropout_p=None,
                   dropout_seed=None, window_left=None, window_right=None,
                   head_offset=None, deterministic=False):
    """Differentiable basic ring attention on per-process (B, H, S, D)
    tensors, q/k/v sharded contiguously along S over ``group``. Returns
    (out in q.dtype, lse fp32 (B, H, S)); lse carries no gradient.
    ``window_left``/``window_right`` are the global band on absolute
    positions (module docstring); ``head_offset`` is the global id of q
    head 0 for the dropout hash (USP passes it). ``deterministic=True``
    runs the backward's steps on the bitwise reproducible split kernels
    B3a/B3b on the card (``block_bwd``'s ``fused=False``)."""
    extras = dict(softcap=softcap,
                  alibi_slopes=slopes_on(alibi_slopes, q.device),
                  window_left=window_left,
                  window_right=None if causal else window_right)
    if dropout_p:
        extras.update(dropout_p=dropout_p, dropout_seed=dropout_seed,
                      head_offset=head_offset)
    step_mask = _ring_masks(causal, k.shape[2], extras)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return RingLoopAttention.apply(q, k, v, scale, group, backend,
                                       step_mask, deterministic)
    out, lse = ring_loop_fwd(q, k, v, scale, group, backend, step_mask)
    return out.to(q.dtype), lse
