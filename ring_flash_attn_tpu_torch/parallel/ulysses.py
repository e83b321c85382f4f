"""Ulysses (DeepSpeed) head-parallel sequence parallelism, and USP.

The port of ``ring_flash_attn_tpu/parallel/ulysses.py``. Instead of
rotating KV, Ulysses all-to-alls the activations: sequence-sharded q, k, v
(B, H, S/W, D) become head-sharded full-sequence (B, H/W, S, D), ONE dense
flash-attention call runs (``flash_attention``: kernel B1, and B2 or
B3a/B3b in the backward, on the card), and the output all-to-alls back.
``usp_attention`` (USP, arXiv:2405.07719) composes the all-to-all over one
process group with a ring schedule (ring, zigzag or stripe) over another,
which scales context parallelism past the head count.

GQA: when Hkv is not a multiple of W, the kv heads are repeated up to W
(each one ``W / Hkv`` times in place, ``repeat_interleave``) so that every
process keeps whole kv head groups.

Ported: causal or not; softcap and ALiBi (each process takes the slopes of
its heads), on the card in the block kernels' XFORM instantiations; and
dropout, with ``head_offset = rank * Hq / W`` so that the hash sees the
global ids of the heads a process holds after the all-to-all and drops
the same pairs as the unsharded call (the kernels' BAND instantiations).
Functions are per-process, on tensors sharded contiguously along S over ``group`` (None:
the default group, or one process when none is initialised).
"""

import torch

from ..ops.flash import flash_attention
from ..ops.mask import MaskArgs
from .mesh import all_to_all, ring_rank, ring_size
from .ring import ring_attention
from .stripe import stripe_attention
from .zigzag import zigzag_ring_attention


def _a2a_seq_to_heads(x, group):
    """(B, H, S_local, D) -> (B, H/W, S_global, D)."""
    return all_to_all(x, 1, 2, group)


def _a2a_heads_to_seq(x, group):
    """(B, H/W, S_global, D) -> (B, H, S_local, D)."""
    return all_to_all(x, 2, 1, group)


def _shard_slopes(alibi_slopes, group, hq, w):
    """This process's slice of the global per-head slopes: the q heads it
    holds after the all-to-all."""
    if alibi_slopes is None:
        return None
    n = hq // w
    rank = ring_rank(group)
    return torch.as_tensor(alibi_slopes, dtype=torch.float32)[
        rank * n:(rank + 1) * n]


def _to_heads(q, k, v, group):
    """q, k, v all-to-alled to head sharding, kv heads repeated first where
    Hkv is not a multiple of W."""
    w = ring_size(group)
    hq, hkv = q.shape[1], k.shape[1]
    if hq % w:
        raise ValueError(f"Ulysses needs q heads ({hq}) divisible by the "
                         f"group's size ({w}); compose with a ring group "
                         f"otherwise (usp_attention)")
    if hkv % w:
        if w % hkv:
            raise ValueError(f"kv heads ({hkv}) and the group's size ({w}) "
                             f"divide neither way")
        k = k.repeat_interleave(w // hkv, dim=1)
        v = v.repeat_interleave(w // hkv, dim=1)
    return [_a2a_seq_to_heads(x, group) for x in (q, k, v)]


def _lse_to_seq(lse, group):
    """lse (B, H/W, S_global) -> (B, H, S_local), through the same
    all-to-all with a trailing dim; it carries no gradient."""
    return _a2a_heads_to_seq(lse.detach()[..., None], group)[..., 0]


def _dropout(dropout_p, dropout_seed, group, hq, w):
    """The dropout fields of the head-sharded call (none without dropout):
    the hash sees global head ids from ``rank * Hq / W``."""
    if not dropout_p:
        return {}
    return dict(dropout_p=dropout_p, dropout_seed=dropout_seed,
                head_offset=ring_rank(group) * (hq // w))


def ulysses_attention(q, k, v, *, scale, causal, group=None, backend=None,
                      softcap=None, alibi_slopes=None, dropout_p=None,
                      dropout_seed=None, deterministic=False):
    """Differentiable Ulysses attention on per-process (B, H, S_local, D)
    tensors, sharded contiguously along S over ``group``. Returns (out in
    q.dtype, lse fp32 (B, H, S_local)); lse carries no gradient.
    ``deterministic=True`` runs the dense call's backward on the bitwise
    reproducible split kernels B3a/B3b on the card."""
    w, hq = ring_size(group), q.shape[1]
    qh, kh, vh = _to_heads(q, k, v, group)
    out, lse = flash_attention(
        qh, kh, vh, scale,
        MaskArgs(causal=causal, softcap=softcap,
                 alibi_slopes=_shard_slopes(alibi_slopes, group, hq, w),
                 **_dropout(dropout_p, dropout_seed, group, hq, w)),
        backend, fused=False if deterministic else None)
    return _a2a_heads_to_seq(out, group), _lse_to_seq(lse, group)


def usp_attention(q, k, v, *, scale, causal, ulysses_group=None,
                  ring_group=None, variant="ring", backend=None,
                  softcap=None, alibi_slopes=None, dropout_p=None,
                  dropout_seed=None, deterministic=False):
    """2-D sequence parallelism: the Ulysses all-to-all over
    ``ulysses_group`` composed with the ring schedule ``variant`` ("ring",
    "zigzag" or "stripe"; the last two causal only) over ``ring_group``.

    The sequence is laid out contiguously over (ring rank major, Ulysses
    rank minor), the ring variant's layout taken over the ring group: the
    process of ring rank i and Ulysses rank j holds the j-th of W_u
    contiguous chunks of ring rank i's shard. The all-to-all turns the
    Ulysses sharding into head sharding; the ring variant then runs over
    ``ring_group`` per head group. q, k, v per process (B, H, S_local, D);
    returns as ``ulysses_attention``."""
    if variant not in ("ring", "zigzag", "stripe"):
        raise ValueError(f"variant must be ring, zigzag or stripe, got "
                         f"{variant!r}")
    if variant != "ring" and not causal:
        raise ValueError(f"usp_attention(variant={variant!r}) is "
                         f"causal-only")
    w, hq = ring_size(ulysses_group), q.shape[1]
    qh, kh, vh = _to_heads(q, k, v, ulysses_group)
    kw = dict(scale=scale, group=ring_group, backend=backend, softcap=softcap,
              alibi_slopes=_shard_slopes(alibi_slopes, ulysses_group, hq, w),
              deterministic=deterministic,
              **_dropout(dropout_p, dropout_seed, ulysses_group, hq, w))
    if variant == "ring":
        out, lse = ring_attention(qh, kh, vh, causal=causal, **kw)
    elif variant == "zigzag":
        out, lse = zigzag_ring_attention(qh, kh, vh, **kw)
    else:
        out, lse = stripe_attention(qh, kh, vh, **kw)
    return (_a2a_heads_to_seq(out, ulysses_group),
            _lse_to_seq(lse, ulysses_group))
