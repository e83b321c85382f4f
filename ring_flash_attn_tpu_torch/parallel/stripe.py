"""Stripe attention schedule (arXiv:2311.09431) over a process group.

The port of ``ring_flash_attn_tpu/parallel/stripe.py``. Token layout: token
t lives on rank t % W at local index t // W
(``layouts.extract_local_stripe``). At step s the resident kv came from
rank j = (r - s) % W, so global positions satisfy

  q_pos - kv_pos = (r - j) + W * (iq - ik)

  j <= r (step <= rank):  causal iff iq >= ik        (plain local causal)
  j >  r (step >  rank):  causal iff iq >= ik + 1    (shifted diagonal)

The shifted diagonal is the static mask offset -1, which the block kernels
B1 and B2/B3 take as they are, so every step is a full-shape causal block
of equal work on every rank, with no skip: stripe's whole load-balancing
idea. On an "ahead" step local row 0 sees no key and its block gives
(0, NEG_INF), which ``merge_partials`` leaves out; the backward gets the
merged lse, finite because step 0 always sees key 0. Causal only.

The rank is a host int, so JAX's ``lax.cond(step <= rank, ...)`` is a
Python choice of mask. The step loops are the ring's (``ring.ring_loop_fwd``,
``ring_loop_bwd``: the posted KV rotation, and the fp32 dk/dv accumulator
co-rotating W times, the last step included).

Ported: softcap, which rides every step, and ALiBi, dropout and a causal
``window_left`` on the layout's global positions (token i of rank r sits
at i·W + r), passed as explicit q_pos/kv_pos (of the resident shard's
source rank) causal on them, which also stands in for both offset forms;
the dropout hash of global positions drops the same pairs as the
single-device call, bit for bit. Every step computes, with or without a
window: the tiles' classes skip what lies outside the band. On the card
they go to the block kernels' XFORM and BAND instantiations.
"""

import torch

from ..ops.mask import MaskArgs, slopes_on
from .ring import RingLoopAttention, ring_loop_fwd


def stripe_positions(rank, w, l_local, device=None):
    """(l_local,) int32 global positions of rank ``rank``'s strided tokens
    (token i at i·W + rank)."""
    return (torch.arange(l_local, dtype=torch.int32, device=device) * w
            + rank).to(torch.int32)


def _step_masks(extras, l_local=None, device=None):
    """The stripe schedule's ``step_mask(step, rank, w)`` for the ring's
    step loops: every step computes, plain causal where the kv came from a
    rank at or before this one (step <= rank), the shifted diagonal after
    it; with ALiBi causal on the global positions of ``l_local`` tokens a
    rank instead (ALiBi, dropout or a window: what needs global positions),
    made once a step and reused by the backward."""
    if (extras.get("alibi_slopes") is not None or extras.get("dropout_p")
            or extras.get("window_left") is not None):
        made = {}

        def step_mask(step, rank, w):
            if (step, rank, w) not in made:
                made[step, rank, w] = MaskArgs(
                    causal=True, q_pos=stripe_positions(rank, w, l_local,
                                                        device),
                    kv_pos=stripe_positions((rank - step) % w, w, l_local,
                                            device), **extras)
            return made[step, rank, w]

        return step_mask
    behind = MaskArgs(causal=True, **extras)
    ahead = MaskArgs(causal=True, offset=-1, **extras)

    def step_mask(step, rank, w):
        return behind if step <= rank else ahead

    return step_mask


def stripe_attention(q, k, v, *, scale, group=None, backend=None,
                     softcap=None, alibi_slopes=None, dropout_p=None,
                     dropout_seed=None, window_left=None, head_offset=None,
                     deterministic=False):
    """Differentiable stripe attention on per-process (B, H, S, D) tensors
    laid out per ``extract_local_stripe`` over ``group`` (None: the default
    group, or one process when none is initialised). Causal only. Returns
    (out in q.dtype, lse fp32 (B, H, S)); lse carries no gradient.
    ``head_offset`` is the global id of q head 0 for the dropout hash (USP
    passes it). ``deterministic=True`` runs the backward's steps on the
    bitwise reproducible split kernels B3a/B3b on the card."""
    extras = dict(softcap=softcap,
                  alibi_slopes=slopes_on(alibi_slopes, q.device),
                  window_left=window_left)
    if dropout_p:
        extras.update(dropout_p=dropout_p, dropout_seed=dropout_seed,
                      head_offset=head_offset)
    step_mask = _step_masks(extras, q.shape[2], q.device)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return RingLoopAttention.apply(q, k, v, scale, group, backend,
                                       step_mask, deterministic)
    out, lse = ring_loop_fwd(q, k, v, scale, group, backend, step_mask)
    return out.to(q.dtype), lse
