"""Public API in flash-attn's (B, S, H, D) layout.

The port of ``ring_flash_attn_tpu/api.py`` with flash-attn's keyword
surface: the single-device ``flash_attn_func`` and the distributed
``ring_flash_attn_func`` and ``zigzag_ring_flash_attn_func``, each with its
kv-packed and qkv-packed form. ``group`` is a ``torch.distributed`` process
group where the JAX package takes a mesh axis name (None: the default
group, or one process when none is initialised); the distributed functions
are per-process, on tensors sharded along S in their schedule's layout
(``parallel/layouts.py``). Internally everything runs (B, H, S, D): the
kernels B1 and B2 (or B3a/B3b) on the card, their plain versions on the
CPU.

Ported so far: causal or not, GQA, any ``softmax_scale``; ``softcap`` and
``alibi_slopes`` (not on zigzag) in the plain versions only, so they run on
CPU tensors and raise ``NotImplementedError`` from the block kernels on
CUDA tensors. A non-default ``window_size`` or ``dropout_p`` raises
``NotImplementedError`` until its slice ports it. The stripe and varlen
entry points are not ported yet (see ROADMAP.md).

``deterministic=True`` asks every entry point here, the ring and zigzag
ones included, for the split backward kernels B3a/B3b, which are bitwise
reproducible; the default fused kernel B2 sums dq by reduce-adds whose
order varies from run to run (the JAX package accepts the flag and ignores
it: every path there is deterministic). On the CPU the plain backward is
deterministic either way.
"""

from .ops.flash import flash_attention
from .ops.mask import MaskArgs
from .parallel.ring import ring_attention
from .parallel.zigzag import zigzag_ring_attention


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


def flash_attn_func(
    q, k, v,
    dropout_p=0.0, softmax_scale=None, causal=False,
    window_size=(-1, -1), softcap=0.0, alibi_slopes=None,
    deterministic=False,
    return_attn_probs=False, dropout_seed=None,
):
    """Single-device flash attention, q (B, Sq, Hq, D), k and v
    (B, Skv, Hkv, D); returns out (B, Sq, Hq, D) in q's dtype, or
    (out, lse (B, Hq, Sq) fp32, None) with return_attn_probs."""
    window_left = window_right = None
    if tuple(window_size) != (-1, -1):
        if window_size[0] >= 0:
            window_left = int(window_size[0])
        # flash-attn convention: with causal=True causality already caps
        # the right side at 0, so window_size[1] is a no-op there
        if window_size[1] >= 0 and not causal:
            window_right = int(window_size[1])
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
        window_left = window_right = None
        if tuple(window_size) != (-1, -1):
            if window_size[0] >= 0:
                window_left = int(window_size[0])
            if window_size[1] >= 0 and not causal:
                window_right = int(window_size[1])
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
                raise ValueError("zigzag ring attention is causal-only")
            if window_right is not None:
                raise NotImplementedError(
                    "window_size: zigzag takes causal sliding windows "
                    "(left, 0) only")
            out, lse = zigzag_ring_attention(
                qi, ki, vi, scale=scale, group=group,
                softcap=_cap(softcap), alibi_slopes=alibi_slopes,
                dropout_p=dropout_p or None, dropout_seed=dropout_seed,
                window_left=window_left, deterministic=deterministic,
            )
        return _ret(out, lse, return_attn_probs)

    func.__doc__ = (
        f"{kind} attention over ``group``, per process: q (B, S_local, Hq, "
        f"D), k and v (B, S_local, Hkv, D) in the schedule's layout; "
        f"returns as ``flash_attn_func``. ``deterministic=True`` runs "
        f"every step's backward on the bitwise reproducible split kernels "
        f"B3a/B3b on the card, as ``flash_attn_func`` does.")
    return func


ring_flash_attn_func = _batch_variant("ring")
zigzag_ring_flash_attn_func = _batch_variant("zigzag")


def _kvpacked(func):
    def wrapper(q, kv, *args, **kw):
        return func(q, kv[:, :, 0], kv[:, :, 1], *args, **kw)

    return wrapper


def _qkvpacked(func):
    def wrapper(qkv, *args, **kw):
        return func(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], *args, **kw)

    return wrapper


ring_flash_attn_kvpacked_func = _kvpacked(ring_flash_attn_func)
ring_flash_attn_qkvpacked_func = _qkvpacked(ring_flash_attn_func)
zigzag_ring_flash_attn_kvpacked_func = _kvpacked(zigzag_ring_flash_attn_func)
zigzag_ring_flash_attn_qkvpacked_func = _qkvpacked(zigzag_ring_flash_attn_func)


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
]
