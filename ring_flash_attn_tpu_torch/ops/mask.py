"""Attention-mask specification shared by the kernel and its plain version.

The port of ``ring_flash_attn_tpu/ops/mask.py``. ``MaskArgs`` keeps every
field of the JAX version so that call sites read the same. Ported: the
position model of ``causal``, ``offset`` and ``kv_offset`` (attend iff
``iq + offset >= ik + kv_offset``) and packed sequences, segment ids
``q_segids``/``kv_segids`` (attend only within a segment) and explicit
positions ``q_pos``/``kv_pos`` (which override the offsets: attend iff
``q_pos >= kv_pos`` when causal), and the logit transforms ``softcap``
and ``alibi_slopes``, everywhere: the plain versions (``ops/naive.py``),
the block kernels B1, B2 and B3a/B3b and the fused ring's kernels B7/B8.
Windows and dropout raise ``NotImplementedError`` everywhere until their
slice ports them.

Segment ids and positions are (Sq,)/(Skv,) integer tensors (or arrays),
shared over batch and heads, as in the JAX package. ``packed_self`` keeps
JAX's meaning: q and kv are the same packing and positions rise along it
within each segment, so every allowed pair has ``iq >= ik``; the kernels
use it to bound their causal loops by index.
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

    @property
    def has_segment_mask(self):
        return self.q_segids is not None


_UNPORTED = ("window_left", "window_right")


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
    for a, b in (("q_segids", "kv_segids"), ("q_pos", "kv_pos")):
        if (getattr(mask, a) is None) != (getattr(mask, b) is None):
            raise ValueError(f"MaskArgs.{a} and MaskArgs.{b} go together")


def kernel_positions(mask: MaskArgs):
    """True when the explicit positions reach the block kernels: a causal
    mask on them, or ALiBi, whose distance they give. Without either,
    positions change nothing."""
    return mask.q_pos is not None and (
        bool(mask.causal) or mask.alibi_slopes is not None)


def causal_offset(mask: MaskArgs):
    """The relative diagonal ``offset - kv_offset`` as one number."""
    off = 0 if mask.offset is None else mask.offset
    if mask.kv_offset is not None:
        off = off - mask.kv_offset
    return off


def _ids(x, device):
    return torch.as_tensor(x, device=device).long()


def positions(mask: MaskArgs, sq: int, skv: int, device=None):
    """((Sq,), (Skv,)) int64 absolute positions per the mask's model:
    the explicit ``q_pos``/``kv_pos`` when given, else the index plus the
    offsets."""
    check_supported(mask)
    if mask.q_pos is not None:
        return _ids(mask.q_pos, device), _ids(mask.kv_pos, device)
    qp = torch.arange(sq, device=device)
    kp = torch.arange(skv, device=device)
    if mask.offset is not None:
        qp = qp + mask.offset
    if mask.kv_offset is not None:
        kp = kp + mask.kv_offset
    return qp, kp


def allowed_mask(mask: MaskArgs, sq: int, skv: int, device=None):
    """Dense bool (Sq, Skv) mask, or None if unconstrained: the causal
    comparison of positions AND, with segment ids, segment equality."""
    check_supported(mask)
    allowed = None
    if mask.causal:
        qp, kp = positions(mask, sq, skv, device)
        allowed = qp[:, None] >= kp[None, :]
    if mask.q_segids is not None:
        seg = (_ids(mask.q_segids, device)[:, None]
               == _ids(mask.kv_segids, device)[None, :])
        allowed = seg if allowed is None else allowed & seg
    return allowed


def position_diff(mask: MaskArgs, sq: int, skv: int, device=None):
    """(Sq, Skv) int64 q_pos - kv_pos per the mask's position model."""
    qp, kp = positions(mask, sq, skv, device)
    return qp[:, None] - kp[None, :]


def slopes_on(alibi_slopes, device):
    """The ALiBi slopes as a (Hq,) float32 tensor on ``device`` (None
    stays None): a schedule puts them there once a call, and its steps'
    launches then take the same tensor."""
    if alibi_slopes is None:
        return None
    return torch.as_tensor(alibi_slopes, dtype=torch.float32,
                           device=device).reshape(-1)


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
