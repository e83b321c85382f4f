"""Ring attention over packed variable-length sequences.

The port of ``ring_flash_attn_tpu/parallel/ring_varlen.py``: the W-step
ring of ``ring.py`` over packed tokens, on the ring's shared step loops
(``ring_loop_fwd``, ``ring_loop_bwd``, ``RingLoopAttention``) with a varlen
``step_mask``. Layout (``ops/varlen.py::ring_varlen_info``): every
sequence splits into W contiguous parts and rank r packs part r of each
sequence, so every rank holds the same local cu_seqlens and the same
segment ids. Masks are segment ids and within-sequence positions:

  step 0:         the diagonal, q against its own packing: causal on
                  positions with ``packed_self``, or segments only;
  steps 1..rank:  the resident kv (from rank j < r) lies wholly earlier in
                  every sequence: segments only (with a causal window,
                  causal on positions, which bounds by the window alone);
  steps > rank:   skipped when causal, segments only otherwise.

No metadata travels with kv: the segment ids are the same on every rank,
and where a step needs the resident kv's positions (ALiBi, dropout, a
window) they are derived, ``src * lens + local`` with src = (rank - step) mod W
(``ops/varlen.py::local_chunk_info``), so the ring rotates one array as
the batch ring does. On the card every block goes to the kernels' segmented
instantiations (B1; B2, or B3a/B3b with ``deterministic``).

Ported: causal or not, ``deterministic``, softcap and ALiBi (on the card
in the kernels' XFORM instantiations; with ALiBi on explicit positions a
tile whose positions step arithmetically, as a packing's do, keeps the
unmasked body and takes the distance from its first position and step,
and only the other tiles take the masked body), a causal ``window_left``
and dropout (their BAND instantiations; the dropout hash of the
sequences' positions and segments drops the same pairs as
``flash_attn_varlen_func``, bit for bit). Per-process, internal layout
(B, H, T_local, D), B = 1 for packed tokens.
"""

import torch

from ..ops.mask import MaskArgs, slopes_on
from ..ops.varlen import local_chunk_info
from .ring import RingLoopAttention, ring_loop_fwd


def _kpos_fn(segids, need):
    """(step, rank, w) -> the resident kv's positions, derived, or None."""
    if not need:
        return lambda step, rank, w: None
    local, lens = local_chunk_info(segids)

    def kpos(step, rank, w):
        return ((rank - step) % w) * lens + local

    return kpos


def varlen_step_masks(segids, positions, causal, extras):
    """The ring-varlen ``step_mask(step, rank, w)`` for ``ring_loop_fwd``
    and ``ring_loop_bwd``."""
    win = extras.get("window_left") is not None
    need_pos = (extras.get("alibi_slopes") is not None
                or bool(extras.get("dropout_p")) or win)
    kpos_at = _kpos_fn(segids, need_pos)
    q_pos = positions if need_pos else None

    def step_mask(step, rank, w):
        if step == 0:
            pos = positions if (causal or need_pos) else None
            return MaskArgs(causal=causal, q_segids=segids, kv_segids=segids,
                            q_pos=pos, kv_pos=pos, packed_self=True,
                            **extras)
        if causal and step > rank:
            return None
        # a causal window keeps the position comparison off the diagonal:
        # q_pos >= kv_pos holds there, the window's bound does not
        return MaskArgs(causal=causal and win, q_segids=segids,
                        kv_segids=segids, q_pos=q_pos,
                        kv_pos=kpos_at(step, rank, w), **extras)

    return step_mask


def ring_attention_varlen(q, k, v, segids, positions, *, scale, causal,
                          group=None, backend=None, softcap=None,
                          alibi_slopes=None, dropout_p=None,
                          dropout_seed=None, window_left=None,
                          deterministic=False):
    """Differentiable varlen ring attention on per-process packed (B, H,
    T_local, D) tensors; segids and positions (T_local,) int32 from
    ``ops/varlen.py::ring_varlen_info``, on q's device. Returns (out in
    q.dtype, lse fp32 (B, H, T_local)); lse carries no gradient.
    ``deterministic=True`` runs the backward's steps on the bitwise
    reproducible split kernels B3a/B3b on the card."""
    extras = dict(softcap=softcap,
                  alibi_slopes=slopes_on(alibi_slopes, q.device),
                  window_left=window_left)
    if dropout_p:
        extras.update(dropout_p=dropout_p, dropout_seed=dropout_seed)
    step_mask = varlen_step_masks(segids, positions, causal, extras)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return RingLoopAttention.apply(q, k, v, scale, group, backend,
                                       step_mask, deterministic)
    out, lse = ring_loop_fwd(q, k, v, scale, group, backend, step_mask)
    return out.to(q.dtype), lse
