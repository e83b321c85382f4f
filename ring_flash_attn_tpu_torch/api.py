"""Public API in flash-attn's (B, S, H, D) layout.

The port of ``ring_flash_attn_tpu/api.py`` with flash-attn's keyword
surface: the single-device ``flash_attn_func`` and the distributed
``ring_flash_attn_func``, ``zigzag_ring_flash_attn_func`` and
``stripe_flash_attn_func``, each with its kv-packed and qkv-packed form;
and for packed sequences (q (T, H, D) with ``cu_seqlens``) the
single-device ``flash_attn_varlen_func``, ``ring_flash_attn_varlen_func``,
``zigzag_ring_flash_attn_varlen_func`` and
``llama3_flash_attn_varlen_func`` (with
``llama3_flash_attn_prepare_cu_seqlens``), each with its packed forms.
``group`` is a ``torch.distributed`` process
group where the JAX package takes a mesh axis name (None: the default
group, or one process when none is initialised); the distributed functions
are per-process, on tensors sharded along S in their schedule's layout
(``parallel/layouts.py``). Internally everything runs (B, H, S, D): the
kernels B1 and B2 (or B3a/B3b) on the card, their plain versions on the
CPU.

Ported: causal or not (zigzag, stripe and zigzag varlen are causal-only),
GQA, any ``softmax_scale``, ``softcap``, ``alibi_slopes``, ``window_size``
and ``dropout_p`` (with ``dropout_seed``) on every entry point, as the JAX
package takes them, which the kernels B1, B2 and B3a/B3b take on the card.
``window_size`` is flash-attn's (left, right), either side -1 for
unbounded: ``flash_attn_*`` and the ring batch functions take a causal
(left, 0) window and a non-causal (left, right) one; zigzag, stripe and
the varlen functions take causal windows only, as the JAX package does.
The window is the JAX package's global band on absolute positions, where
the reference, zhuzilin's ring_flash_attn, hands ``window_size`` to each
ring step's flash call as it is (a window local to the shard). Dropout
drops by a stateless hash of absolute coordinates (``ops/mask.py``), so
that every schedule drops the same pairs as the single-device call and
the JAX package. The varlen entry points turn ``cu_seqlens`` into segment
ids and positions (``ops/varlen.py``) on q's device, which the kernels
take too.

``deterministic=True`` asks every entry point here, the ring, zigzag and
stripe ones included, for the split backward kernels B3a/B3b, which are bitwise
reproducible; the default fused kernel B2 sums dq by reduce-adds whose
order varies from run to run (the JAX package accepts the flag and ignores
it: every path there is deterministic). On the CPU the plain backward is
deterministic either way.
"""

import numpy as np
import torch

from .ops.flash import flash_attention
from .ops.mask import MaskArgs
from .ops.varlen import (as_cu_seqlens, cu_seqlens_to_positions,
                         cu_seqlens_to_segids, ring_varlen_info,
                         zigzag_varlen_info)
from .parallel.llama3 import llama3_attention
from .parallel.mesh import ring_rank, ring_size
from .parallel.ring import ring_attention
from .parallel.ring_varlen import ring_attention_varlen
from .parallel.stripe import stripe_attention
from .parallel.zigzag import zigzag_ring_attention
from .parallel.zigzag_varlen import zigzag_ring_attention_varlen


def _bshd_to_bhsd(x):
    return x.transpose(1, 2)


def _ret(out_bhsd, lse, return_attn_probs):
    out = out_bhsd.transpose(1, 2)
    if return_attn_probs:
        # (out, lse, p) with p always None, as the JAX package returns
        return out, lse, None
    return out


def _scale(softmax_scale, d):
    return softmax_scale if softmax_scale is not None else d**-0.5


def _cap(softcap):
    # flash-attn convention: 0.0 disables capping
    return float(softcap) if softcap else None


def _window(window_size, causal):
    """(window_left, window_right) of flash-attn's window_size, -1 for an
    unbounded side; with causal=True causality already caps the right side
    at 0, so window_size[1] is a no-op there."""
    window_left = window_right = None
    if tuple(window_size) != (-1, -1):
        if window_size[0] >= 0:
            window_left = int(window_size[0])
        if window_size[1] >= 0 and not causal:
            window_right = int(window_size[1])
    return window_left, window_right


def _causal_window(window_size, causal):
    """window_size's left side where only causal sliding windows (left, 0)
    are taken (zigzag, stripe, the varlen functions), as the JAX package
    takes them: anything else raises NotImplementedError."""
    if tuple(window_size) == (-1, -1):
        return None
    if window_size[0] < 0 or window_size[1] not in (0, -1):
        raise NotImplementedError(
            "window_size: only causal sliding windows (left, 0) are taken "
            "here")
    if not causal:
        raise NotImplementedError("sliding window requires causal=True")
    return int(window_size[0])


def flash_attn_func(
    q, k, v,
    dropout_p=0.0, softmax_scale=None, causal=False,
    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
    deterministic=False,
    return_attn_probs=False, dropout_seed=None,
):
    """Single-device flash attention, q (B, Sq, Hq, D), k and v
    (B, Skv, Hkv, D); returns out (B, Sq, Hq, D) in q's dtype, or
    (out, lse (B, Hq, Sq) fp32, None) with return_attn_probs.
    ``window_size`` (left, right) is the causal (left, 0) or non-causal
    (left, right) sliding window; ``dropout_p`` drops by the hash of
    ``dropout_seed`` (an int or a one-element tensor) and the pairs'
    coordinates."""
    window_left, window_right = _window(window_size, causal)
    out, lse = flash_attention(
        _bshd_to_bhsd(q), _bshd_to_bhsd(k), _bshd_to_bhsd(v),
        _scale(softmax_scale, q.shape[-1]),
        MaskArgs(causal=causal, window_left=window_left,
                 window_right=window_right,
                 softcap=_cap(softcap), alibi_slopes=alibi_slopes,
                 dropout_p=dropout_p or None, dropout_seed=dropout_seed),
        fused=False if deterministic else None,
    )
    return _ret(out, lse, return_attn_probs)


def flash_attn_kvpacked_func(q, kv, **kw):
    """kv (B, Skv, 2, Hkv, D)."""
    return flash_attn_func(q, kv[:, :, 0], kv[:, :, 1], **kw)


def flash_attn_qkvpacked_func(qkv, **kw):
    """qkv (B, S, 3, H, D)."""
    return flash_attn_func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], **kw)


def _batch_variant(kind):
    def func(
        q, k, v,
        dropout_p=0.0, softmax_scale=None, causal=False,
        window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
        deterministic=False,
        return_attn_probs=False, group=None, dropout_seed=None,
    ):
        if kind == "ring":
            window_left, window_right = _window(window_size, causal)
        else:
            window_left = _causal_window(window_size, causal)
        scale = _scale(softmax_scale, q.shape[-1])
        qi, ki, vi = map(_bshd_to_bhsd, (q, k, v))
        if kind == "ring":
            out, lse = ring_attention(
                qi, ki, vi, scale=scale, causal=causal, group=group,
                softcap=_cap(softcap), alibi_slopes=alibi_slopes,
                dropout_p=dropout_p or None, dropout_seed=dropout_seed,
                window_left=window_left, window_right=window_right,
                deterministic=deterministic,
            )
        else:
            if not causal:
                raise ValueError(f"{kind} attention is causal-only")
            sched = (zigzag_ring_attention if kind == "zigzag"
                     else stripe_attention)
            out, lse = sched(
                qi, ki, vi, scale=scale, group=group,
                softcap=_cap(softcap), alibi_slopes=alibi_slopes,
                dropout_p=dropout_p or None, dropout_seed=dropout_seed,
                window_left=window_left, deterministic=deterministic,
            )
        return _ret(out, lse, return_attn_probs)

    func.__doc__ = (
        f"{kind} attention over ``group``, per process: q (B, S_local, Hq, "
        f"D), k and v (B, S_local, Hkv, D) in the schedule's layout; "
        f"returns as ``flash_attn_func``. ``window_size`` is the global "
        f"band on absolute positions (the module docstring), "
        f"{'causal (left, 0) or not (left, right)' if kind == 'ring' else 'causal (left, 0) only'}; "
        f"``deterministic=True`` runs every step's backward on the bitwise "
        f"reproducible split kernels B3a/B3b on the card, as "
        f"``flash_attn_func`` does.")
    return func


ring_flash_attn_func = _batch_variant("ring")
zigzag_ring_flash_attn_func = _batch_variant("zigzag")
stripe_flash_attn_func = _batch_variant("stripe")


def _kvpacked(func):
    def wrapper(q, kv, *args, **kw):
        return func(q, kv[:, :, 0], kv[:, :, 1], *args, **kw)

    return wrapper


def _qkvpacked(func):
    def wrapper(qkv, *args, **kw):
        return func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], *args, **kw)

    return wrapper


def _thd_to_bhsd(x):
    """(T, H, D) packed tokens -> a (1, H, T, D) view."""
    return x.transpose(0, 1)[None]


def _varlen_ret(out_bhsd, lse, return_attn_probs):
    out = out_bhsd[0].transpose(0, 1)
    if return_attn_probs:
        return out, lse[0], None
    return out


def flash_attn_varlen_func(
    q, k, v, cu_seqlens, max_seqlen=None,
    dropout_p=0.0, softmax_scale=None, causal=False,
    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
    deterministic=False,
    return_attn_probs=False, dropout_seed=None,
):
    """Single-device flash attention over packed sequences: q (T, Hq, D),
    k and v (T, Hkv, D), cu_seqlens (N+1,) (a list, numpy array or
    tensor); returns out (T, Hq, D) in q's dtype, or (out, lse (Hq, T)
    fp32, None) with return_attn_probs. The packing becomes segment ids
    and within-sequence positions on q's device, with ``packed_self``
    (one packing on both sides), as in the JAX package."""
    del max_seqlen  # the kernels bound their loops from the tiles' metadata
    t = q.shape[0]
    seg = cu_seqlens_to_segids(cu_seqlens, t, q.device)
    pos = (cu_seqlens_to_positions(cu_seqlens, t, q.device)
           if causal or alibi_slopes is not None or dropout_p else None)
    mask = MaskArgs(
        causal=causal, q_segids=seg, kv_segids=seg, q_pos=pos, kv_pos=pos,
        window_left=_causal_window(window_size, causal),
        softcap=_cap(softcap), alibi_slopes=alibi_slopes,
        dropout_p=dropout_p or None, dropout_seed=dropout_seed,
        packed_self=True,
    )
    out, lse = flash_attention(
        _thd_to_bhsd(q), _thd_to_bhsd(k), _thd_to_bhsd(v),
        _scale(softmax_scale, q.shape[-1]), mask,
        fused=False if deterministic else None)
    return _varlen_ret(out, lse, return_attn_probs)


def flash_attn_varlen_kvpacked_func(q, kv, cu_seqlens, max_seqlen=None,
                                    **kw):
    """kv (T, 2, Hkv, D)."""
    return flash_attn_varlen_func(q, kv[:, 0], kv[:, 1], cu_seqlens,
                                  max_seqlen, **kw)


def flash_attn_varlen_qkvpacked_func(qkv, cu_seqlens, max_seqlen=None, **kw):
    """qkv (T, 3, H, D)."""
    return flash_attn_varlen_func(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                  cu_seqlens, max_seqlen, **kw)


def ring_flash_attn_varlen_func(
    q, k, v, cu_seqlens, max_seqlen=None,
    dropout_p=0.0, softmax_scale=None, causal=False,
    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
    deterministic=False,
    return_attn_probs=False, group=None, dropout_seed=None,
):
    """Varlen ring attention over ``group``, per process: q (T_local, Hq,
    D), k and v (T_local, Hkv, D) where rank r holds part r of every
    sequence (``ops/varlen.py::extract_local_ring_varlen``), cu_seqlens the
    LOCAL cu_seqlens (global // W), the same on every rank. Returns as
    ``flash_attn_varlen_func``; ``deterministic=True`` runs every step's
    backward on the bitwise reproducible split kernels B3a/B3b."""
    del max_seqlen
    t = q.shape[0]
    seg, pos = ring_varlen_info(cu_seqlens, t, ring_rank(group), q.device)
    out, lse = ring_attention_varlen(
        _thd_to_bhsd(q), _thd_to_bhsd(k), _thd_to_bhsd(v), seg, pos,
        scale=_scale(softmax_scale, q.shape[-1]), causal=causal, group=group,
        softcap=_cap(softcap), alibi_slopes=alibi_slopes,
        dropout_p=dropout_p or None, dropout_seed=dropout_seed,
        window_left=_causal_window(window_size, causal),
        deterministic=deterministic,
    )
    return _varlen_ret(out, lse, return_attn_probs)


def ring_flash_attn_varlen_kvpacked_func(q, kv, cu_seqlens, max_seqlen=None,
                                         **kw):
    return ring_flash_attn_varlen_func(q, kv[:, 0], kv[:, 1], cu_seqlens,
                                       max_seqlen, **kw)


def ring_flash_attn_varlen_qkvpacked_func(qkv, cu_seqlens, max_seqlen=None,
                                          **kw):
    return ring_flash_attn_varlen_func(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                       cu_seqlens, max_seqlen, **kw)


def zigzag_ring_flash_attn_varlen_func(
    q, k, v, cu_seqlens, max_seqlen=None,
    dropout_p=0.0, softmax_scale=None, causal=True,
    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
    deterministic=False,
    return_attn_probs=False, group=None, dropout_seed=None,
):
    """Zigzag varlen ring attention over ``group``, per process, in the
    JAX package's grouped layout (``parallel/zigzag_varlen.py``): q
    (T_local, Hq, D), k and v (T_local, Hkv, D) where rank r packs chunk r
    of every sequence, then chunk 2W-1-r of every sequence
    (``ops/varlen.py::extract_local_zigzag_varlen``), cu_seqlens the
    LOCAL cu_seqlens (global // W), the same on every rank, every
    sequence's length divisible by 2W. Causal only. Returns as
    ``flash_attn_varlen_func``; ``deterministic=True`` runs every step's
    backward on the bitwise reproducible split kernels B3a/B3b."""
    del max_seqlen
    t = q.shape[0]
    cu_half = as_cu_seqlens(cu_seqlens, q.device) // 2
    seg, pos = zigzag_varlen_info(cu_half, t, ring_rank(group),
                                  ring_size(group))
    out, lse = zigzag_ring_attention_varlen(
        _thd_to_bhsd(q), _thd_to_bhsd(k), _thd_to_bhsd(v), seg, pos,
        scale=_scale(softmax_scale, q.shape[-1]), causal=causal,
        group=group, softcap=_cap(softcap), alibi_slopes=alibi_slopes,
        dropout_p=dropout_p or None, dropout_seed=dropout_seed,
        window_left=_causal_window(window_size, causal),
        deterministic=deterministic,
    )
    return _varlen_ret(out, lse, return_attn_probs)


def zigzag_ring_flash_attn_varlen_kvpacked_func(q, kv, cu_seqlens,
                                                max_seqlen=None, **kw):
    return zigzag_ring_flash_attn_varlen_func(q, kv[:, 0], kv[:, 1],
                                              cu_seqlens, max_seqlen, **kw)


def zigzag_ring_flash_attn_varlen_qkvpacked_func(qkv, cu_seqlens,
                                                 max_seqlen=None, **kw):
    return zigzag_ring_flash_attn_varlen_func(qkv[:, 0], qkv[:, 1],
                                              qkv[:, 2], cu_seqlens,
                                              max_seqlen, **kw)


def llama3_flash_attn_prepare_cu_seqlens(cu_seqlens, causal, rank,
                                         world_size):
    """Host-side sharding metadata with the reference's semantics, exactly
    as the JAX package computes it (numpy): from the GLOBAL cu_seqlens,
    (cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
    local_k_slice) of rank ``rank``, which holds global tokens [rank L,
    (rank + 1) L)."""
    cu = np.asarray(cu_seqlens, np.int64)
    total = int(cu[-1])
    if total % world_size:
        raise ValueError(f"{total} tokens do not split over {world_size} "
                         f"ranks")
    lpr = total // world_size
    left = int(np.searchsorted(cu, rank * lpr))
    right = int(np.searchsorted(cu, (rank + 1) * lpr))
    if cu[left] != rank * lpr:
        left -= 1
    cu_q = cu[left:right + 1].copy()
    cu_q -= rank * lpr
    cu_q[0] = 0
    cu_q[-1] = lpr
    cu_k = cu[left:right + 1].copy()
    if causal:
        slice_right = (rank + 1) * lpr
        cu_k[-1] = slice_right
    else:
        slice_right = int(cu[right])
    slice_left = int(cu[left])
    cu_k -= slice_left
    max_q = int((cu_q[1:] - cu_q[:-1]).max())
    max_k = int((cu_k[1:] - cu_k[:-1]).max())
    return (cu_q.astype(np.int32), cu_k.astype(np.int32), max_q, max_k,
            slice(slice_left, slice_right))


def llama3_flash_attn_varlen_func(
    q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q=None,
    max_seqlen_k=None, heads_k_stride=None, local_k_slice=None,
    dropout_p=0.0, softmax_scale=None, causal=True,
    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
    deterministic=False,
    return_attn_probs=False, group=None, dropout_seed=None,
):
    """llama3 all-gather attention over packed sequences, per process: q,
    k, v (T_local, H, D) the rank's contiguous share of the packed tokens,
    metadata from ``llama3_flash_attn_prepare_cu_seqlens``. The sequences
    become globally consistent segment labels, each the sequence's global
    start token (``local_k_slice.start + cu_seqlens_k[segment]``), masked
    with the causal mask by index at offset rank·L. Returns as
    ``flash_attn_varlen_func``."""
    del max_seqlen_q, max_seqlen_k
    t = q.shape[0]
    if local_k_slice is None:
        slice_left = 0
    elif isinstance(local_k_slice, slice):
        slice_left = local_k_slice.start
    else:
        slice_left = local_k_slice[0]
    seg_local = cu_seqlens_to_segids(cu_seqlens_q, t, q.device).long()
    cu_k = as_cu_seqlens(cu_seqlens_k, q.device)
    q_segids = (slice_left + cu_k[seg_local]).to(torch.int32)
    out, lse = llama3_attention(
        _thd_to_bhsd(q), _thd_to_bhsd(k), _thd_to_bhsd(v), q_segids,
        scale=_scale(softmax_scale, q.shape[-1]), causal=causal,
        heads_k_stride=heads_k_stride, group=group, softcap=_cap(softcap),
        alibi_slopes=alibi_slopes, dropout_p=dropout_p or None,
        dropout_seed=dropout_seed,
        window_left=_causal_window(window_size, causal),
        deterministic=deterministic,
    )
    return _varlen_ret(out, lse, return_attn_probs)


def llama3_flash_attn_varlen_kvpacked_func(q, kv, *args, **kw):
    return llama3_flash_attn_varlen_func(q, kv[:, 0], kv[:, 1], *args, **kw)


def llama3_flash_attn_varlen_qkvpacked_func(qkv, *args, **kw):
    return llama3_flash_attn_varlen_func(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                         *args, **kw)


ring_flash_attn_kvpacked_func = _kvpacked(ring_flash_attn_func)
ring_flash_attn_qkvpacked_func = _qkvpacked(ring_flash_attn_func)
zigzag_ring_flash_attn_kvpacked_func = _kvpacked(zigzag_ring_flash_attn_func)
zigzag_ring_flash_attn_qkvpacked_func = _qkvpacked(zigzag_ring_flash_attn_func)
stripe_flash_attn_kvpacked_func = _kvpacked(stripe_flash_attn_func)
stripe_flash_attn_qkvpacked_func = _qkvpacked(stripe_flash_attn_func)


__all__ = [
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
    "ring_flash_attn_func",
    "ring_flash_attn_kvpacked_func",
    "ring_flash_attn_qkvpacked_func",
    "zigzag_ring_flash_attn_func",
    "zigzag_ring_flash_attn_kvpacked_func",
    "zigzag_ring_flash_attn_qkvpacked_func",
    "stripe_flash_attn_func",
    "stripe_flash_attn_kvpacked_func",
    "stripe_flash_attn_qkvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_varlen_qkvpacked_func",
    "ring_flash_attn_varlen_func",
    "ring_flash_attn_varlen_kvpacked_func",
    "ring_flash_attn_varlen_qkvpacked_func",
    "zigzag_ring_flash_attn_varlen_func",
    "zigzag_ring_flash_attn_varlen_kvpacked_func",
    "zigzag_ring_flash_attn_varlen_qkvpacked_func",
    "llama3_flash_attn_prepare_cu_seqlens",
    "llama3_flash_attn_varlen_func",
    "llama3_flash_attn_varlen_kvpacked_func",
    "llama3_flash_attn_varlen_qkvpacked_func",
]
