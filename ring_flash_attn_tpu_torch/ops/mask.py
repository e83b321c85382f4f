"""Attention-mask specification shared by the kernel and its plain version.

The port of ``ring_flash_attn_tpu/ops/mask.py``. ``MaskArgs`` keeps every
field of the JAX version so that call sites read the same. Ported: the
position model of ``causal``, ``offset`` and ``kv_offset`` (attend iff
``iq + offset >= ik + kv_offset``) everywhere, and ``softcap`` and
``alibi_slopes`` in the plain versions (``ops/naive.py``) and the fused
ring's kernels B7/B8; the block kernels B1, B2 and B3a/B3b raise
``NotImplementedError`` for those two (``check_kernel_supported``). The
other constraints (segment ids, explicit positions, windows, dropout) raise
``NotImplementedError`` everywhere until their slice ports them.
"""

from typing import Any, NamedTuple, Optional

import torch

# Sentinel for masked logits. NOT -inf: fully masked rows then give
# lse = NEG_INF, which a partial merge treats as weight zero without NaNs.
NEG_INF = -1e30


class MaskArgs(NamedTuple):
    causal: bool = False
    offset: Optional[Any] = None  # int: attend iff iq + offset >= ik
    kv_offset: Optional[Any] = None  # int: absolute position of kv index 0
    q_segids: Optional[Any] = None
    kv_segids: Optional[Any] = None
    q_pos: Optional[Any] = None
    kv_pos: Optional[Any] = None
    window_left: Optional[int] = None
    softcap: Optional[float] = None
    alibi_slopes: Optional[Any] = None
    dropout_p: Optional[float] = None
    dropout_seed: Optional[Any] = None
    head_offset: Optional[Any] = None
    packed_self: bool = False
    window_right: Optional[int] = None


_UNPORTED = ("q_segids", "kv_segids", "q_pos", "kv_pos", "window_left",
             "window_right")
_KERNEL_UNPORTED = ("softcap", "alibi_slopes")


def check_supported(mask: MaskArgs):
    """Raise NotImplementedError for a mask feature this slice lacks."""
    for name in _UNPORTED:
        if getattr(mask, name) is not None:
            raise NotImplementedError(
                f"MaskArgs.{name} is not ported yet (see ROADMAP.md)"
            )
    if mask.dropout_p:
        raise NotImplementedError(
            "MaskArgs.dropout_p is not ported yet (see ROADMAP.md)"
        )


def check_kernel_supported(mask: MaskArgs):
    """``check_supported``, and the logit transforms that only the plain
    versions have so far: for the block kernels B1, B2 and B3a/B3b."""
    check_supported(mask)
    for name in _KERNEL_UNPORTED:
        if getattr(mask, name) is not None:
            raise NotImplementedError(
                f"MaskArgs.{name} is not ported to the block kernels yet "
                f"(see ROADMAP.md); backend='plain' has it"
            )


def causal_offset(mask: MaskArgs):
    """The relative diagonal ``offset - kv_offset`` as one number."""
    off = 0 if mask.offset is None else mask.offset
    if mask.kv_offset is not None:
        off = off - mask.kv_offset
    return off


def positions(mask: MaskArgs, sq: int, skv: int, device=None):
    """((Sq,), (Skv,)) int64 absolute positions per the mask's model."""
    check_supported(mask)
    qp = torch.arange(sq, device=device)
    kp = torch.arange(skv, device=device)
    if mask.offset is not None:
        qp = qp + mask.offset
    if mask.kv_offset is not None:
        kp = kp + mask.kv_offset
    return qp, kp


def allowed_mask(mask: MaskArgs, sq: int, skv: int, device=None):
    """Dense bool (Sq, Skv) mask, or None if unconstrained."""
    check_supported(mask)
    if not mask.causal:
        return None
    qp, kp = positions(mask, sq, skv, device)
    return qp[:, None] >= kp[None, :]


def position_diff(mask: MaskArgs, sq: int, skv: int, device=None):
    """(Sq, Skv) int64 q_pos - kv_pos per the mask's position model."""
    qp, kp = positions(mask, sq, skv, device)
    return qp[:, None] - kp[None, :]


def alibi_bias(mask: MaskArgs, hkv: int, group: int, sq: int, skv: int,
               device=None):
    """(Hkv, G, Sq, Skv) f32 ALiBi bias ``-slope * distance``, or None; the
    distance is ``q_pos - kv_pos``, its absolute value when not causal."""
    if mask.alibi_slopes is None:
        return None
    dist = position_diff(mask, sq, skv, device).float()
    if not mask.causal:
        dist = dist.abs()
    slopes = torch.as_tensor(mask.alibi_slopes, dtype=torch.float32,
                             device=device).reshape(hkv, group, 1, 1)
    return -slopes * dist


def mask_logits(scores, mask: MaskArgs):
    """Apply the mask to a (..., Sq, Skv) score tensor with NEG_INF."""
    allowed = allowed_mask(mask, scores.shape[-2], scores.shape[-1],
                           scores.device)
    if allowed is None:
        return scores
    return scores.masked_fill(~allowed, NEG_INF)
