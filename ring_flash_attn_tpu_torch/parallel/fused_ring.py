"""Fused ring attention: the softmax state carried from ring step to step.

The port of ``ring_flash_attn_tpu/parallel/fused_ring.py``. The schedule-
level ring (``parallel/ring.py``) writes an (out, lse) partial per step and
merges it; here the online-softmax state (m, l, acc) stays in fp32, base 2,
for all W steps and is normalised exactly once, and the backward adds dq,
dk and dv in place into fp32 accumulators, dk/dv travelling with their KV
shard.

The TPU kernels run the whole ring inside one call, moving KV between chips
with remote copies under a credit/ack handshake and keeping shard, receive
slots and accumulators in tens of MB of VMEM. A Hopper block has 227 KB of
shared memory and no remote-copy engine, so here THE KERNEL IS THE RING
STEP (B7 ``csrc/fused_ring_fwd.cu``, B8 ``csrc/fused_ring_bwd.cu``) and the
hop between steps is a posted ``torch.distributed`` rotation
(``mesh.RingBuffer``): ``_fused_ring_forward`` and
``_fused_ring_backward`` are the TPU kernels' W-step loops in Python. The
credit protocol, the slots and the ack buffers have no counterpart.

``fwd_step`` and ``bwd_step`` are the kernel boundary: CUDA tensors go to
B7/B8, CPU tensors (or ``backend="plain"``) to the plain versions below,
which round where the JAX wrappers and kernels round (q * scale * log2 e
and v * scale to the input dtype before the step; p and ds to the input
dtype as operands of the products).

Supports causal or not, softcap and ALiBi (distances on GLOBAL positions
rank * L + row). Segments, windows and dropout stay schedule-level in the
JAX package and are not arguments here. Layout (B, H, L, D), sharded
contiguously along the sequence over ``group``.
"""

import math

import torch

from ..config import use_kernel
from ..ops.flash import _kernel_layout, compute_delta
from ..ops.flash_bwd_cuda import bwd_delta
from ..ops.mask import NEG_INF
from .fused_ring_cuda import fused_ring_bwd_cuda, fused_ring_fwd_cuda
from .mesh import RingBuffer, ring_rank, ring_size
from .ring import _ring_bwd

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)

# The JAX package's budget for the fused backward's per-(batch, kv head)
# working set (fused_ring.py:52): the TPU's VMEM, not a Hopper limit. Kept
# so that the same shapes pick the same backward in both packages.
_VMEM_BUDGET = 80 * 1024 * 1024


def _bwd_vmem_bytes(l_local, d, group, itemsize):
    return (6 * l_local * d * itemsize + 4 * l_local * d * 4
            + 2 * l_local * d * 4 + group * l_local * d * 4)


def fused_ring_bwd_supported(l_local, d, group, itemsize):
    """True where ``bwd_mode="auto"`` takes the fused backward (B8): the
    JAX package's selector, expression and limit unchanged."""
    return _bwd_vmem_bytes(l_local, d, group, itemsize) < _VMEM_BUDGET


# ---------------------------------------------------------------------------
# plain versions of B7 and B8


def _logits2(qs, k, *, diagonal, q_row0=0, q_pos0=0, kv_pos0=0, cap2=0.0,
             slopes2=None, alibi_abs=False):
    """Base-2 logits (B, Hkv, G, Sq, Skv) of pre-scaled q through softcap
    and ALiBi, the allowed (Sq, Skv) mask of a diagonal step (else None),
    and the softcap's tanh (else None)."""
    b, hq, sq, d = qs.shape
    hkv, skv = k.shape[1], k.shape[2]
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     qs.float().reshape(b, hkv, hq // hkv, sq, d), k.float())
    tt = None
    if cap2:
        tt = torch.tanh(s / cap2)
        s = cap2 * tt
    rows = torch.arange(sq, device=qs.device) + q_row0
    cols = torch.arange(skv, device=qs.device)
    if slopes2 is not None:
        dist = ((rows + q_pos0)[:, None] - (cols + kv_pos0)[None, :]).float()
        if alibi_abs:
            dist = dist.abs()
        s = s - slopes2.reshape(hkv, hq // hkv, 1, 1) * dist
    allowed = rows[:, None] >= cols[None, :] if diagonal else None
    return s, allowed, tt


def _plain_fwd_step(qs, k, v, m, l, acc, *, diagonal, first, last, **kw):
    """B7's plain version: the base-2 online-softmax update of (m, l, acc)
    in place, and the finish when ``last``."""
    b, hq, sq, d = qs.shape
    hkv = k.shape[1]
    grouped = (b, hkv, hq // hkv, sq)
    s, allowed, _ = _logits2(qs, k, diagonal=diagonal, **kw)
    if allowed is not None:
        s.masked_fill_(~allowed, NEG_INF)
    if first:
        m.fill_(NEG_INF)
        l.zero_()
        acc.zero_()
    m_prev = m.reshape(grouped)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp2(m_prev - m_new)
    p = s.sub_(m_new[..., None]).exp2_()  # in place: s is not used again
    if allowed is not None:
        p.masked_fill_(~allowed, 0.0)
    l.copy_((l.reshape(grouped) * alpha + p.sum(dim=-1)).reshape(l.shape))
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    acc.copy_((acc.reshape(*grouped, d) * alpha[..., None] + pv).reshape(
        acc.shape))
    m.copy_(m_new.reshape(m.shape))
    if not last:
        return None
    dead = (l == 0) | (m <= NEG_INF / 2)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).masked_fill(dead[..., None], 0.0)
    lse = ((m + torch.log2(l_safe)) * LN2).masked_fill(dead, NEG_INF)
    return out.to(qs.dtype), lse


def _plain_bwd_step(qs, k, vs, dout, lse2, delta, dq, dk, dv, *, diagonal,
                    accumulate, **kw):
    """B8's plain version: dq += ds k, and dk, dv (+)= ds^T qs, p^T dout."""
    b, hq, sq, d = qs.shape
    hkv = k.shape[1]
    grouped = (b, hkv, hq // hkv, sq)
    s, allowed, tt = _logits2(qs, k, diagonal=diagonal, **kw)
    p = s.sub_(lse2.reshape(*grouped, 1)).exp2_()  # in place
    if allowed is not None:
        p.masked_fill_(~allowed, 0.0)
    doutf = dout.float().reshape(*grouped, d)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", doutf, vs.float())
    ds = dp.sub_(delta.reshape(*grouped, 1)).mul_(p)
    if tt is not None:
        ds.mul_(tt.mul_(tt).neg_().add_(1.0))
    ds = ds.to(k.dtype).float()
    dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()).reshape(dq.shape)
    dk_s = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                        qs.float().reshape(*grouped, d))
    dv_s = torch.einsum("bhgqk,bhgqd->bhkd", p.to(k.dtype).float(), doutf)
    if accumulate:
        dk += dk_s
        dv += dv_s
    else:
        dk.copy_(dk_s)
        dv.copy_(dv_s)


# ---------------------------------------------------------------------------
# the kernel boundary


def new_state(qs):
    """Uninitialised (m, l, acc) for q (B, Hq, L, D): the rank's first
    computing step fills it."""
    m = torch.empty(qs.shape[:3], dtype=torch.float32, device=qs.device)
    acc = torch.empty(qs.shape, dtype=torch.float32, device=qs.device)
    return m, torch.empty_like(m), acc


def fwd_step(qs, k, v, state, *, backend=None, **kw):
    """One forward ring step on the resident (k, v); ``state`` = (m, l,
    acc) is updated in place. Returns (out, lse) from the step given
    ``last=True``, else None. Keywords as ``fused_ring_fwd_cuda``; on the
    card qs, k and v go to B7 in a layout its TMA maps read
    (``_kernel_layout``)."""
    if use_kernel(qs, backend):
        qs, k, v = map(_kernel_layout, (qs, k, v))
        return fused_ring_fwd_cuda(qs, k, v, *state, **kw)
    return _plain_fwd_step(qs, k, v, *state, **kw)


def bwd_step(qs, k, vs, dout, lse2, delta, dq, dk, dv, *, backend=None, **kw):
    """One backward ring step: adds into dq and, per ``accumulate``, adds
    into or writes dk, dv. Keywords as ``fused_ring_bwd_cuda``."""
    step = fused_ring_bwd_cuda if use_kernel(qs, backend) else _plain_bwd_step
    step(qs, k, vs, dout, lse2, delta, dq, dk, dv, **kw)


def _transforms(q, causal, softcap, alibi_slopes):
    """The steps' static keywords: base-2 softcap and slopes."""
    slopes2 = None
    if alibi_slopes is not None:
        slopes2 = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                  device=q.device) * LOG2E
    return dict(cap2=float(softcap) * LOG2E if softcap else 0.0,
                slopes2=slopes2, alibi_abs=not causal)


def _prescale(x, factor):
    return (x.float() * factor).to(x.dtype)


# ---------------------------------------------------------------------------
# the W-step loops


def _fused_ring_forward(q, k, v, *, scale, causal, group=None, backend=None,
                        softcap=None, alibi_slopes=None):
    """Non-differentiable fused-ring forward: (out in q.dtype, lse fp32)."""
    world, rank = ring_size(group), ring_rank(group)
    l_local = k.shape[2]
    kw = _transforms(q, causal, softcap, alibi_slopes)
    qs = _prescale(q, scale * LOG2E)
    state = new_state(qs)
    # two kv buffers: the resident one is sent while the other receives
    kv = RingBuffer(torch.stack([k, v]) if world > 1 else (k, v), group)
    last_step = rank if causal else world - 1  # the last one it computes
    result = None
    for step in range(world):
        if step < world - 1:
            kv.start()
        if not causal or step <= rank:
            # the resident kv came from rank - step: earlier positions
            src = (rank - step) % world
            result = fwd_step(
                qs, kv.value[0], kv.value[1], state, backend=backend,
                diagonal=causal and step == 0, first=step == 0,
                last=step == last_step, q_pos0=rank * l_local,
                kv_pos0=src * l_local, **kw)
        kv.wait()
    return result


def _fused_ring_backward(q, k, v, dout, out, lse, *, scale, causal,
                         group=None, backend=None, softcap=None,
                         alibi_slopes=None):
    """The dual-ring backward: kv rotates while the fp32 dk/dv accumulators
    co-rotate and arrive home after W hops. Returns (dq, dk, dv) fp32."""
    world, rank = ring_size(group), ring_rank(group)
    l_local = k.shape[2]
    kw = _transforms(q, causal, softcap, alibi_slopes)
    qs = _prescale(q, scale * LOG2E)
    vs = _prescale(v, scale)
    lse2 = (lse.float() * LOG2E).clamp(min=NEG_INF / 2)
    if use_kernel(q, backend):
        dout = _kernel_layout(dout)
        delta = bwd_delta(dout, out) * scale
    else:
        delta = compute_delta(dout, out) * scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    # two buffers each for kv and for the travelling (2, B, Hkv, L, D)
    # accumulator: one is resident (and sent) while the other receives
    dkv = RingBuffer(torch.empty((2,) + tuple(k.shape), dtype=torch.float32,
                                 device=q.device), group)
    kv = RingBuffer(torch.stack([k, vs]) if world > 1 else (k, vs), group)
    for step in range(world):
        if step < world - 1:
            kv.start()
        if not causal or step <= rank:
            src = (rank - step) % world
            bwd_step(qs, kv.value[0], kv.value[1], dout, lse2, delta, dq,
                     dkv.value[0], dkv.value[1], backend=backend,
                     diagonal=causal and step == 0, accumulate=step > 0,
                     q_pos0=rank * l_local, kv_pos0=src * l_local, **kw)
        # the accumulator moves on after its step, computed on or not
        dkv.rotate()
        kv.wait()
    # dk was accumulated against q * scale * log2 e: rescale once, at home
    return dq, dkv.value[0] * (LN2 / scale), dkv.value[1]


class _FusedRingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, group, backend, bwd_mode,
                bwd_backend, extras):
        out, lse = _fused_ring_forward(q, k, v, scale=scale, causal=causal,
                                       group=group, backend=backend, **extras)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (scale, causal, group, backend, bwd_mode, bwd_backend,
                    extras)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, group, backend, mode, bwd_backend, extras = ctx.args
        if mode == "auto":
            fused = fused_ring_bwd_supported(
                k.shape[2], k.shape[3], q.shape[1] // k.shape[1],
                k.element_size())
            mode = "fused" if fused else "schedule"
        if mode == "fused":
            dq, dk, dv = _fused_ring_backward(
                q, k, v, dout, out, lse, scale=scale, causal=causal,
                group=group, backend=backend, **extras)
        else:
            if use_kernel(q, bwd_backend):
                dout = _kernel_layout(dout)
            dq, dk, dv = _ring_bwd(q, k, v, out, lse, dout, scale, causal,
                                   group, bwd_backend, extras)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def fused_ring_attention(q, k, v, *, scale, causal, group=None,
                         bwd_backend=None, bwd_mode="auto", softcap=None,
                         alibi_slopes=None, backend=None):
    """Differentiable fused-ring attention on per-process (B, Hq, L, D)
    tensors sharded contiguously over ``group`` (None: the default group,
    or one process when none is initialised). Returns (out in q.dtype, lse
    fp32 (B, Hq, L)); lse carries no gradient.

    Backward (``bwd_mode``): "fused" is the dual ring of B8 steps;
    "schedule" the schedule-level dual ring (``ring._ring_bwd``: kernels
    B2/B3, which lack softcap and ALiBi on the card), run with
    ``bwd_backend`` (default: ``backend``); "auto" takes the fused one
    where ``fused_ring_bwd_supported`` holds. ``backend="plain"`` runs the
    plain versions of the steps on whatever device the tensors are on."""
    if bwd_mode not in ("auto", "fused", "schedule"):
        raise ValueError(f"bwd_mode must be auto, fused or schedule, got "
                         f"{bwd_mode!r}")
    extras = dict(softcap=softcap, alibi_slopes=alibi_slopes)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FusedRingAttention.apply(
            q, k, v, scale, causal, group, backend, bwd_mode,
            backend if bwd_backend is None else bwd_backend, extras)
    return _fused_ring_forward(q, k, v, scale=scale, causal=causal,
                               group=group, backend=backend, **extras)
