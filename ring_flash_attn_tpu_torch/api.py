"""Public single-device API in flash-attn's (B, S, H, D) layout.

The port of ``flash_attn_func``, ``flash_attn_kvpacked_func`` and
``flash_attn_qkvpacked_func`` from ``ring_flash_attn_tpu/api.py``, with
flash-attn's keyword surface. Internally everything runs (B, H, S, D)
through ``ops/flash.py::flash_attention``: the kernels B1 and B2 (or
B3a/B3b) on the card, their plain versions on the CPU.

Ported so far: causal or not, GQA, any ``softmax_scale``. A non-default
``window_size``, ``softcap``, ``alibi_slopes`` or ``dropout_p`` builds the
same ``MaskArgs`` as the JAX package and raises ``NotImplementedError``
from ``check_supported`` until its slice ports it. The distributed and
varlen entry points are not ported yet (see ROADMAP.md).

``deterministic=True`` asks for the split backward kernels B3a/B3b, which
are bitwise reproducible; the default fused kernel B2 sums dq with atomics
whose order varies from run to run (the JAX package accepts the flag and
ignores it: every path there is deterministic).
"""

from .ops.flash import flash_attention
from .ops.mask import MaskArgs


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


__all__ = [
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
]
