"""Llama-3 all-gather context parallelism: the forward.

The port of the forward of ``ring_flash_attn_tpu/parallel/llama3.py``. Not
a ring: the global sequence is sharded contiguously over the process
group; each rank all-gathers K and V one chunk of ``heads_k_stride`` kv
heads at a time and runs ONE full-row flash call per chunk (``block_fwd``,
kernel B1 on the card), so no LSE merging is needed. Masking is causal in
global positions: the q offset ``rank * L`` rides in ``MaskArgs.offset``
and the gathered kv starts at global position 0.

Ported: causal or not, ``heads_k_stride``, GQA. Not ported yet, each
raising ``NotImplementedError``: packed sequences (``q_segids``), softcap,
ALiBi, dropout, ``window_left``, and the backward (all-gather again,
gathered-size dk/dv, reduce-scatter home): call it under
``torch.no_grad()`` or on tensors that do not require grad.

Functions are per-process. Internal layout (B, H, S, D).
"""

import torch

from ..ops.flash import block_fwd
from ..ops.mask import MaskArgs
from .mesh import all_gather, ring_rank


def _gather_chunk(kv, i, stride, group):
    """All-gather kv heads [i, i + stride) of the stacked (2, B, Hkv, L, D)
    k and v along the token axis."""
    return all_gather(kv[:, :, i:i + stride], 3, group)


def _llama3_fwd(q, k, v, scale, causal, heads_k_stride, group, backend):
    rank = ring_rank(group)
    l = q.shape[2]
    hkv = k.shape[1]
    g = q.shape[1] // hkv
    mask = MaskArgs(causal=causal, offset=rank * l if causal else None)
    kv = torch.stack([k, v])
    outs, lses = [], []
    for i in range(0, hkv, heads_k_stride):
        gathered = _gather_chunk(kv, i, heads_k_stride, group)
        q_i = q[:, i * g:(i + heads_k_stride) * g]
        o_i, lse_i = block_fwd(q_i, gathered[0], gathered[1], scale, mask,
                               backend, out_dtype=q.dtype)
        outs.append(o_i)
        lses.append(lse_i)
    if len(outs) == 1:
        return outs[0], lses[0]
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def llama3_attention(q, k, v, q_segids=None, *, scale, causal=True,
                     heads_k_stride=None, group=None, backend=None,
                     softcap=None, alibi_slopes=None, dropout_p=None,
                     dropout_seed=None, window_left=None):
    """llama3 all-gather attention on per-process (B, H, S_local, D),
    forward only.

    q/k/v are sharded contiguously along S over ``group`` (None: the
    default group, or one process when none is initialised). Returns (out
    in q.dtype, lse fp32 (B, H, S_local))."""
    unported = {"q_segids": q_segids is not None, "softcap": bool(softcap),
                "alibi_slopes": alibi_slopes is not None,
                "dropout_p": bool(dropout_p),
                "window_left": window_left is not None}
    for name, given in unported.items():
        if given:
            raise NotImplementedError(
                f"llama3_attention({name}=...) is not ported yet (see "
                f"ROADMAP.md)")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "llama3_attention's backward is not ported yet (see ROADMAP.md):"
            " call it under torch.no_grad()")
    hkv = k.shape[1]
    if heads_k_stride is None:
        heads_k_stride = hkv
    if hkv % heads_k_stride:
        raise ValueError(f"heads_k_stride={heads_k_stride} does not divide "
                         f"Hkv={hkv}")
    return _llama3_fwd(q, k, v, scale, causal, heads_k_stride, group,
                       backend)
