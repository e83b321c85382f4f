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
Sliding windows (``window_left``, and ``window_right`` when not causal:
attend iff ``q_pos - kv_pos <= window_left`` and ``kv_pos - q_pos <=
window_right``) and dropout (``dropout_p``, ``dropout_seed``,
``head_offset``) in the plain versions and the block kernels B1, B2 and
B3a/B3b; the fused ring's kernels take neither, as in the JAX package.

The window is the JAX package's global band on absolute positions (the
offsets or the explicit positions), not a window local to a shard: a ring
step's block sees the true distance of its rows to the resident keys.

Dropout keeps element (i, j) iff a stateless hash of (batch, q head +
``head_offset``, absolute q position, absolute kv position, q segment,
seed) clears ``dropout_threshold(p)``: the same bits in every block shape,
in the forward and the backward, on every rank of a schedule and in the
JAX package (``dropout_row_hash``, ``dropout_keep``). torch has no full
uint32 arithmetic, so the hash runs in int64 masked to 32 bits after every
multiply and add.

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

    @property
    def has_window(self):
        return self.window_left is not None or (
            self.window_right is not None and not self.causal)


def check_supported(mask: MaskArgs):
    """Raise ValueError for fields that go together given alone, or a
    dropout_p outside [0, 1)."""
    if mask.dropout_p and not 0.0 < mask.dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got "
                         f"{mask.dropout_p}")
    for a, b in (("q_segids", "kv_segids"), ("q_pos", "kv_pos")):
        if (getattr(mask, a) is None) != (getattr(mask, b) is None):
            raise ValueError(f"MaskArgs.{a} and MaskArgs.{b} go together")


def kernel_positions(mask: MaskArgs):
    """True when the explicit positions reach the block kernels: a causal
    mask on them, ALiBi, whose distance they give, a window or dropout,
    whose band and hash they give. Without any of these, positions change
    nothing."""
    return mask.q_pos is not None and (
        bool(mask.causal) or mask.alibi_slopes is not None
        or mask.has_window or bool(mask.dropout_p))


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


def _and(a, b):
    return b if a is None else a & b


def allowed_mask(mask: MaskArgs, sq: int, skv: int, device=None):
    """Dense bool (Sq, Skv) mask, or None if unconstrained: the causal
    comparison of positions AND the window's band (``window_right`` only
    when not causal) AND, with segment ids, segment equality."""
    check_supported(mask)
    allowed = None
    if mask.causal or mask.has_window:
        qp, kp = positions(mask, sq, skv, device)
        diff = qp[:, None] - kp[None, :]
        if mask.causal:
            allowed = diff >= 0
        if mask.window_left is not None:
            allowed = _and(allowed, diff <= mask.window_left)
        if mask.window_right is not None and not mask.causal:
            allowed = _and(allowed, diff >= -mask.window_right)
    if mask.q_segids is not None:
        seg = (_ids(mask.q_segids, device)[:, None]
               == _ids(mask.kv_segids, device)[None, :])
        allowed = _and(allowed, seg)
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


# The dropout hash's multipliers and 32-bit avalanche: the JAX package's
# constants (ring_flash_attn_tpu/ops/mask.py), the port's own copy.
_H_Q = 0x9E3779B1
_H_K = 0x85EBCA77
_H_HEAD = 0xC2B2AE35
_H_BATCH = 0x27D4EB2F
_H_SEG = 0x165667B1
_M32 = 0xFFFFFFFF


def _u32(x):
    """int64 tensor (or int) x taken modulo 2^32, as uint32 bits."""
    return x & _M32


def _mul32(a, c):
    """(a * c) mod 2^32 for uint32 bits a (int64 tensor or int) and the
    constant c, in halves of 16 bits so that no product passes 2^49."""
    return ((a & 0xFFFF) * c + (((a >> 16) * c) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_row_hash(qp, qseg, head, batch, seed):
    """Per-q-row hash, int64 holding uint32 bits (any broadcast shape): qp
    the absolute q positions, qseg the rows' segment ids or None, head
    (with the head offset), batch and seed ints or int64 tensors."""
    x = _mul32(_u32(qp), _H_Q)
    x = _u32(x + 0xDEADBEEF + _u32(seed) + _mul32(_u32(head), _H_HEAD)
             + _mul32(_u32(batch), _H_BATCH))
    if qseg is not None:
        x = _u32(x + _mul32(_u32(qseg), _H_SEG))
    return _mix32(x)


def dropout_keep(row_hash, kp, threshold):
    """The keep mask: mix32(row_hash ^ kv_pos * _H_K) >= threshold,
    broadcast over row_hash and kp (absolute kv positions)."""
    return _mix32(row_hash ^ _mul32(_u32(kp), _H_K)) >= threshold


def dropout_threshold(dropout_p):
    """The hash's threshold for dropout_p, as the JAX package takes it."""
    return min(int(dropout_p * 2**32), 2**32 - 1)


def as_int(x, name):
    """A Python int from an int or a one-element tensor (None: 0)."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"{name} must be a scalar, got {tuple(x.shape)}")
        return int(x.reshape(()).item())
    return int(x)


def dropout_keep_dense(mask: MaskArgs, b, hkv, g, sq, skv, device=None):
    """(b, hkv, g, sq, skv) bool keep mask, or None without dropout: the
    JAX package's ``_dropout_keep_dense`` bit for bit."""
    if not mask.dropout_p:
        return None
    qp, kp = positions(mask, sq, skv, device)
    seed = mask.dropout_seed
    seed = (seed.to(device).long().reshape(()) if isinstance(
        seed, torch.Tensor) else as_int(seed, "dropout_seed"))
    heads = torch.arange(hkv * g, device=device).reshape(hkv, g)
    heads = heads + as_int(mask.head_offset, "head_offset")
    batches = torch.arange(b, device=device)
    qseg = None if mask.q_segids is None else _ids(mask.q_segids,
                                                   device)[None, None, None]
    rh = dropout_row_hash(qp[None, None, None, :], qseg,
                          heads[None, :, :, None],
                          batches[:, None, None, None], seed)
    return dropout_keep(rh[..., None], kp[None, None, None, None, :],
                        dropout_threshold(mask.dropout_p))
