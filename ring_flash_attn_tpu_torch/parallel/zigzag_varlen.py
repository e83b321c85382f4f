"""Zigzag ring attention over packed variable-length sequences.

The port of ``ring_flash_attn_tpu/parallel/zigzag_varlen.py``, on the
zigzag schedule's step loops (``zigzag.zigzag_loop``) with a varlen
``step_masks``. Layout (``ops/varlen.py::zigzag_varlen_info``, the JAX
package's grouped layout): every sequence splits into 2W chunks and rank r
packs chunk r of every sequence, then chunk 2W-1-r of every sequence, so
the first half of the received kv is ``kv[:, :, :T/2]`` and the second
half of the local q is ``q[:, :, T/2:]``, and the three cases of
``zigzag.py`` carry over:

  step 0:          q against its own packing: causal on positions with
                   ``packed_self``;
  1 <= step <= r:  the whole q against the first half of the received kv
                   (earlier chunks of every sequence): segments only;
  step > r:        the second half of q against the whole received kv
                   (every received chunk lies earlier): segments only.

No metadata travels with kv: every rank's segment ids are the same (they
come from the shared per-half cu_seqlens), and where a step needs the
resident kv's positions (ALiBi, dropout, a window) they are derived from its source rank src
= (r - step) mod W, ``src * lens + off`` and ``(2W-1-src) * lens + off``
(``ops/varlen.py::local_chunk_info``), so the ring rotates one array. dk
and dv co-rotate in fp32 as in the zigzag ring. On the card every block
goes to the kernels' segmented instantiations (B1; B2, or B3a/B3b with
``deterministic``), with softcap or ALiBi to their XFORM ones.

Causal only; every sequence's length divisible by 2W. Ported: softcap,
ALiBi, ``deterministic``, ``window_left`` (off the diagonal causal on
positions, which bounds by the window alone) and dropout (the hash of the
sequences' positions and segments, the same pairs as
``flash_attn_varlen_func`` drops). Per-process, internal layout (B, H,
T_local, D), B = 1 for packed tokens.
"""

import torch

from ..ops.mask import MaskArgs, slopes_on
from ..ops.varlen import local_chunk_info
from .zigzag import zigzag_loop


def _kpos_fn(segids, half, need):
    """(src, w) -> the positions of rank src's packing, derived from the
    shared segment ids, or None."""
    if not need:
        return lambda src, w: None
    off, lens = local_chunk_info(segids[:half])

    def kpos(src, w):
        return torch.cat([src * lens + off,
                          (2 * w - 1 - src) * lens + off]).to(torch.int32)

    return kpos


def varlen_step_masks(segids, positions, extras):
    """The zigzag-varlen ``step_masks(step, rank, w)`` -> (diagonal,
    earlier, later) for ``zigzag.zigzag_loop``; each step's masks are made
    once and reused by the backward (the kernels' tile bounds are cached
    by tensor)."""
    half = segids.shape[0] // 2
    win = extras.get("window_left") is not None
    need_pos = (extras.get("alibi_slopes") is not None
                or bool(extras.get("dropout_p")) or win)
    kpos_at = _kpos_fn(segids, half, need_pos)
    seg0, seg1 = segids[:half], segids[half:]
    pos1 = positions[half:] if need_pos else None
    diag = MaskArgs(causal=True, q_segids=segids, kv_segids=segids,
                    q_pos=positions, kv_pos=positions, packed_self=True,
                    **extras)
    made = {}

    def step_masks(step, rank, w):
        if step == 0:
            return diag, None, None
        if (step, rank, w) not in made:
            kpos = kpos_at((rank - step) % w, w)
            made[step, rank, w] = (
                diag,
                MaskArgs(causal=win, q_segids=segids, kv_segids=seg0,
                         q_pos=positions if need_pos else None,
                         kv_pos=None if kpos is None else kpos[:half],
                         **extras),
                MaskArgs(causal=win, q_segids=seg1, kv_segids=segids,
                         q_pos=pos1, kv_pos=kpos, **extras))
        return made[step, rank, w]

    return step_masks


def zigzag_ring_attention_varlen(q, k, v, segids, positions, *, scale,
                                 causal=True, group=None, backend=None,
                                 softcap=None, alibi_slopes=None,
                                 dropout_p=None, dropout_seed=None,
                                 window_left=None, deterministic=False):
    """Differentiable zigzag varlen ring attention on per-process packed
    (B, H, T_local, D) tensors in the grouped layout; segids and positions
    (T_local,) int32 from ``ops/varlen.py::zigzag_varlen_info``, on q's
    device. Causal only: ``causal=False`` raises ValueError. Returns (out
    in q.dtype, lse fp32 (B, H, T_local)); lse carries no gradient.
    ``deterministic=True`` runs the backward's steps on the bitwise
    reproducible split kernels B3a/B3b on the card."""
    if not causal:
        raise ValueError("zigzag varlen is causal-only")
    if q.shape[2] % 2:
        raise ValueError(f"the local length {q.shape[2]} must be even: a "
                         f"rank holds two chunks of every sequence")
    extras = dict(softcap=softcap,
                  alibi_slopes=slopes_on(alibi_slopes, q.device),
                  window_left=window_left)
    if dropout_p:
        extras.update(dropout_p=dropout_p, dropout_seed=dropout_seed)
    step_masks = varlen_step_masks(segids, positions, extras)
    return zigzag_loop(q, k, v, scale, group, backend, step_masks,
                       deterministic)
