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

Ported: softcap, which rides every step (in the plain versions only: on
CUDA tensors the block kernels raise ``NotImplementedError`` for it, as in
``ring.py``). ``alibi_slopes``, ``dropout_p`` and ``window_left`` need the
layout's explicit global positions (``q_pos``/``kv_pos``), which are not
ported yet (ROADMAP.md queue A item 4), and raise.
"""

import torch

from ..ops.mask import MaskArgs
from .ring import RingLoopAttention, ring_loop_fwd


def _step_masks(extras):
    """The stripe schedule's ``step_mask(step, rank, w)`` for the ring's
    step loops: every step computes, plain causal where the kv came from a
    rank at or before this one (step <= rank), the shifted diagonal after
    it."""
    behind = MaskArgs(causal=True, **extras)
    ahead = MaskArgs(causal=True, offset=-1, **extras)

    def step_mask(step, rank, w):
        return behind if step <= rank else ahead

    return step_mask


def stripe_attention(q, k, v, *, scale, group=None, backend=None,
                     softcap=None, alibi_slopes=None, dropout_p=None,
                     dropout_seed=None, window_left=None,
                     deterministic=False):
    """Differentiable stripe attention on per-process (B, H, S, D) tensors
    laid out per ``extract_local_stripe`` over ``group`` (None: the default
    group, or one process when none is initialised). Causal only. Returns
    (out in q.dtype, lse fp32 (B, H, S)); lse carries no gradient.
    ``deterministic=True`` runs the backward's steps on the bitwise
    reproducible split kernels B3a/B3b on the card."""
    del dropout_seed  # dropout raises below
    for option, value in (("alibi_slopes", alibi_slopes is not None),
                          ("dropout_p", dropout_p),
                          ("window_left", window_left is not None)):
        if value:
            raise NotImplementedError(
                f"stripe_attention({option}=...) needs the stripe layout's "
                f"explicit global positions, which are not ported yet "
                f"(ROADMAP.md queue A item 4)")
    step_mask = _step_masks(dict(softcap=softcap))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return RingLoopAttention.apply(q, k, v, scale, group, backend,
                                       step_mask, deterministic)
    out, lse = ring_loop_fwd(q, k, v, scale, group, backend, step_mask)
    return out.to(q.dtype), lse
