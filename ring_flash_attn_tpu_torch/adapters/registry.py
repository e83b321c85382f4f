"""Framework-agnostic attention registry.

The port of ``ring_flash_attn_tpu/adapters/registry.py``: a model stack
selects its attention by a config string and calls it with one uniform
signature,

    fn(q, k, v, *, scale=None, causal=True, axis_name=None,
       segment_ids=None, positions=None, softcap=None, alibi_slopes=None,
       dropout_p=None, dropout_seed=None, window_left=None, **impl_kw)
       -> out  (same (B, S, H, D) layout and dtype as q)

- Layout is (B, S, H, D); GQA via fewer K/V heads.
- ``axis_name`` keeps the JAX package's keyword and carries a
  ``torch.distributed`` process group (``None``: the default group, or one
  process when none is initialised). Distributed entries are per-process,
  with the sequence dim sharded in that entry's layout (contiguous for
  ring, fused_ring and llama3, zigzag per ``parallel.layouts``).
- ``segment_ids`` and ``positions`` belong to the packed (varlen) entries,
  which are not ported yet; the batch entries take None only.

Registered: flash, ring, zigzag, llama3 (forward only), fused_ring. The
JAX package's stripe, ulysses, ring_varlen and zigzag_varlen are not
ported yet: asking for one raises a ``KeyError`` that names ROADMAP.md.
``register_attention`` adds custom entries.

``RingAttentionLayer`` wraps an entry as a stateless callable that a model
definition can hold as a submodule.
"""

from ..ops.flash import flash_attention
from ..ops.mask import MaskArgs
from ..parallel.fused_ring import fused_ring_attention
from ..parallel.llama3 import llama3_attention
from ..parallel.ring import ring_attention
from ..parallel.zigzag import zigzag_ring_attention

_REGISTRY = {}
_NOT_PORTED = ("stripe", "ulysses", "ring_varlen", "zigzag_varlen")


def register_attention(name, fn, overwrite=False):
    """Register ``fn`` (uniform signature, see module docstring)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"attention impl {name!r} already registered")
    _REGISTRY[name] = fn
    return fn


def get_attention(name):
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise KeyError(f"attention impl {name!r} is not ported yet (see "
                       f"ROADMAP.md); available: {sorted(_REGISTRY)}")
    raise KeyError(f"unknown attention impl {name!r}; available: "
                   f"{sorted(_REGISTRY)}")


def list_attention():
    return sorted(_REGISTRY)


def _bshd(x):
    return x.transpose(1, 2)


def _norm(q, scale):
    return scale if scale is not None else q.shape[-1] ** -0.5


def _no_varlen(name, segment_ids, positions):
    if segment_ids is not None or positions is not None:
        raise NotImplementedError(
            f"{name}: segment_ids and positions belong to the varlen "
            f"entries, which are not ported yet (see ROADMAP.md)")


def _impl_flash(q, k, v, *, scale=None, causal=True, axis_name=None,
                segment_ids=None, positions=None, softcap=None,
                alibi_slopes=None, dropout_p=None, dropout_seed=None,
                window_left=None, backend=None):
    del axis_name
    mask = MaskArgs(
        causal=causal, q_segids=segment_ids, kv_segids=segment_ids,
        q_pos=positions, kv_pos=positions, softcap=softcap,
        alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, window_left=window_left,
    )
    out, _ = flash_attention(_bshd(q), _bshd(k), _bshd(v), _norm(q, scale),
                             mask, backend)
    return _bshd(out)


def _batch_impl(name, sched, needs_causal_kw):
    def impl(q, k, v, *, scale=None, causal=True, axis_name=None,
             segment_ids=None, positions=None, softcap=None,
             alibi_slopes=None, dropout_p=None, dropout_seed=None,
             window_left=None, **kw):
        _no_varlen(name, segment_ids, positions)
        kwargs = dict(
            scale=_norm(q, scale), group=axis_name, softcap=softcap,
            alibi_slopes=alibi_slopes, dropout_p=dropout_p,
            dropout_seed=dropout_seed, window_left=window_left, **kw,
        )
        if needs_causal_kw:
            kwargs["causal"] = causal
        elif not causal:
            raise ValueError(f"{name} is causal-only")
        out, _ = sched(_bshd(q), _bshd(k), _bshd(v), **kwargs)
        return _bshd(out)

    return impl


def _impl_llama3(q, k, v, *, scale=None, causal=True, axis_name=None,
                 segment_ids=None, positions=None, softcap=None,
                 alibi_slopes=None, dropout_p=None, dropout_seed=None,
                 window_left=None, heads_k_stride=None, backend=None):
    del positions  # llama3 masks with global offsets and segment labels
    out, _ = llama3_attention(
        _bshd(q), _bshd(k), _bshd(v), segment_ids, scale=_norm(q, scale),
        causal=causal, heads_k_stride=heads_k_stride, group=axis_name,
        backend=backend, softcap=softcap, alibi_slopes=alibi_slopes,
        dropout_p=dropout_p, dropout_seed=dropout_seed,
        window_left=window_left,
    )
    return _bshd(out)


def _impl_fused_ring(q, k, v, *, scale=None, causal=True, axis_name=None,
                     segment_ids=None, positions=None, softcap=None,
                     alibi_slopes=None, dropout_p=None, dropout_seed=None,
                     window_left=None, backend=None, **kw):
    # backend= is part of the uniform signature; as in the JAX package it
    # maps to the backend of the fused ring's schedule-level backward
    if backend is not None:
        kw.setdefault("bwd_backend", backend)
    if any(x is not None
           for x in (segment_ids, positions, dropout_p, window_left)):
        raise ValueError("fused_ring supports causal/non-causal (+softcap/"
                         "ALiBi) only")
    out, _ = fused_ring_attention(
        _bshd(q), _bshd(k), _bshd(v), scale=_norm(q, scale), causal=causal,
        group=axis_name, softcap=softcap, alibi_slopes=alibi_slopes, **kw,
    )
    return _bshd(out)


register_attention("flash", _impl_flash)
register_attention("ring", _batch_impl("ring", ring_attention, True))
register_attention("zigzag",
                   _batch_impl("zigzag", zigzag_ring_attention, False))
register_attention("llama3", _impl_llama3)
register_attention("fused_ring", _impl_fused_ring)


class RingAttentionLayer:
    """Stateless attention layer around a registry entry.

        attn = RingAttentionLayer("zigzag", axis_name=group)
        out = attn(q, k, v)                     # (B, S, H, D)

    Per-call kwargs override the constructor's."""

    def __init__(self, impl="zigzag", *, axis_name=None, scale=None,
                 causal=True, **defaults):
        self.impl = impl
        self.defaults = dict(
            axis_name=axis_name, scale=scale, causal=causal, **defaults
        )

    def __call__(self, q, k, v, **overrides):
        kw = dict(self.defaults)
        kw.update(overrides)
        return get_attention(self.impl)(q, k, v, **kw)

    def __repr__(self):
        return f"RingAttentionLayer({self.impl!r}, {self.defaults!r})"
