"""Llama-3 all-gather context parallelism, forward and backward.

The port of ``ring_flash_attn_tpu/parallel/llama3.py``. Not a ring: the
global sequence is sharded contiguously over the process group; each rank
all-gathers K and V one chunk of ``heads_k_stride`` kv heads at a time and
runs ONE full-row flash call per chunk (``block_fwd``, kernel B1 on the
card), so no LSE merging is needed. Masking is causal in global positions:
the q offset ``rank * L`` rides in ``MaskArgs.offset`` and the gathered kv
starts at global position 0. The backward all-gathers K and V again, chunk
by chunk, runs ``block_bwd`` (B2, or B3a/B3b past the fused kernel's
limit) on the gathered keys with gathered-size fp32 dk/dv, and
reduce-scatters them home along the token axis.

The collectives are posted ahead, as the JAX module's are scheduled: chunk
i + 1's gather is posted before chunk i's kernel (the reference's double
buffer: at most two gathered chunks alive), and each chunk's dk and dv
reduce-scatters are posted after its kernel and waited for after the next
chunk's, or at the end (``mesh.all_gather_start``,
``mesh.reduce_scatter_start``). On NCCL the next gather then runs on the
backend's stream under the current kernel; the values are the blocking
collectives' bit for bit.

Packed sequences: ``q_segids`` are the rank's tokens' globally consistent
segment labels; the kv labels are all-gathered once (``mesh.all_gather``)
and every head chunk's mask, forward and backward, is segments plus the
causal mask by index at offset rank·L (no positions), which the kernels'
segmented instantiations take on the card.

softcap rides every chunk; ALiBi and dropout take the global q offset
rank·L even when the mask is not causal (the gathered kv starts at
position 0), ALiBi with the slopes sliced a head chunk at a time and
dropout with the chunk's first global q head as ``head_offset``
(``_chunk_mask``), so that the hash drops the same pairs as the
single-device call; ``window_left`` bounds every chunk's mask at the same
offset. On the card they go to the kernels' XFORM and BAND
instantiations.

Ported: causal or not, ``heads_k_stride``, GQA, the backward, packed
sequences, softcap, ALiBi, dropout and ``window_left``.

Functions are per-process. Internal layout (B, H, S, D).
"""

import torch

from ..config import use_kernel
from ..ops.flash import _kernel_layout, block_bwd, block_fwd, compute_delta
from ..ops.mask import MaskArgs, slopes_on
from .mesh import (all_gather, all_gather_start, reduce_scatter_start,
                   ring_rank)


def _mask(causal, q, q_segids, group, extras):
    """The rank's mask: causal by index at offset rank·L (the offset also
    where ALiBi or dropout needs it without causal), with packed sequences
    the segments of the rank's rows against the gathered labels of every
    rank's, softcap and ALiBi (the slopes of every q head, as a tensor on
    q's device), dropout and ``window_left``."""
    kv_segids = None if q_segids is None else all_gather(q_segids, 0, group)
    alibi = slopes_on(extras.get("alibi_slopes"), q.device)
    dropout_p = extras.get("dropout_p")
    offset = None
    if causal or alibi is not None or dropout_p:
        offset = ring_rank(group) * q.shape[2]
    return MaskArgs(causal=causal, offset=offset, q_segids=q_segids,
                    kv_segids=kv_segids, softcap=extras.get("softcap"),
                    alibi_slopes=alibi, dropout_p=dropout_p or None,
                    dropout_seed=extras.get("dropout_seed"),
                    window_left=extras.get("window_left"))


def _chunk_mask(mask, first, hs, device):
    """``mask`` for the q heads ``hs`` of a head chunk, ``first`` their
    first global id: its ALiBi slopes sliced to them, and with dropout
    ``first`` as the head offset."""
    if mask.dropout_p:
        mask = mask._replace(head_offset=first)
    if mask.alibi_slopes is None:
        return mask
    return mask._replace(alibi_slopes=slopes_on(mask.alibi_slopes,
                                                 device)[hs])


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _chunks(q, hkv, heads_k_stride):
    """(first kv head, first q head, q heads) of each chunk of
    ``heads_k_stride`` kv heads."""
    g = q.shape[1] // hkv
    return [(i, i * g, slice(i * g, (i + heads_k_stride) * g))
            for i in range(0, hkv, heads_k_stride)]


def _posts(gather, chunks):
    """``post(n)``: chunk n's ``gather``, posted (None past the last)."""
    return lambda n: gather(chunks[n][0]) if n < len(chunks) else None


def _rank_fwd(q, gather, hkv, scale, mask, heads_k_stride, backend):
    """One rank's forward: q (B, Hq, L, D) its shard, ``gather(i)`` the
    ``Posted`` gather of the stacked (2, B, heads_k_stride, S, D) k and v
    of kv heads [i, i + heads_k_stride) over the whole sequence, ``mask``
    with the rank's offset. Chunk i + 1's gather is asked for before
    chunk i's kernel runs. Returns (out, lse)."""
    chunks = _chunks(q, hkv, heads_k_stride)
    post = _posts(gather, chunks)
    outs, lses, nxt = [], [], post(0)
    for n, (i, first, hs) in enumerate(chunks):
        kv = nxt.wait()
        nxt = post(n + 1)
        o_i, lse_i = block_fwd(q[:, hs], kv[0], kv[1], scale,
                               _chunk_mask(mask, first, hs, q.device),
                               backend, out_dtype=q.dtype)
        outs.append(o_i)
        lses.append(lse_i)
    return _cat(outs), _cat(lses)


def _rank_bwd(q, out, lse, dout, gather, hkv, scale, mask, heads_k_stride,
              backend, fused=None):
    """One rank's backward, chunk by chunk (arguments as ``_rank_fwd``'s):
    yields (dq of the chunk's q heads in q.dtype, dk, dv), dk and dv fp32
    over the whole sequence, this rank's share of the sum over ranks.
    ``fused`` goes to ``block_bwd`` (False: the reproducible B3a/B3b)."""
    kernel = use_kernel(q, backend)
    delta = compute_delta(dout, out)
    chunks = _chunks(q, hkv, heads_k_stride)
    post = _posts(gather, chunks)
    nxt = post(0)
    for n, (i, first, hs) in enumerate(chunks):
        kv = nxt.wait()
        nxt = post(n + 1)
        dout_i, q_i = dout[:, hs], q[:, hs]
        if kernel:
            dout_i, q_i = _kernel_layout(dout_i), _kernel_layout(q_i)
        yield block_bwd(dout_i, q_i, kv[0], kv[1], lse[:, hs].contiguous(),
                        delta[:, hs].contiguous(), scale,
                        _chunk_mask(mask, first, hs, q.device), backend,
                        dq_dtype=q.dtype, fused=fused)


def _gather(k, v, heads_k_stride, group):
    """``gather(i)`` for the rank functions: posts the all-gather of kv
    heads [i, i + heads_k_stride) of k and v along the token axis."""
    kv = torch.stack([k, v])
    return lambda i: all_gather_start(kv[:, :, i:i + heads_k_stride], 3,
                                      group)


def _llama3_fwd(q, k, v, q_segids, scale, causal, heads_k_stride, group,
                backend, extras):
    return _rank_fwd(q, _gather(k, v, heads_k_stride, group), k.shape[1],
                     scale, _mask(causal, q, q_segids, group, extras),
                     heads_k_stride, backend)


def _llama3_bwd(q, k, v, q_segids, out, lse, dout, scale, causal,
                heads_k_stride, group, backend, extras, fused=None):
    """(dq, dk, dv) in the inputs' dtypes."""
    dqs, dks, dvs, posted = [], [], [], ()

    def land(posted):
        if posted:
            dks.append(posted[0].wait().to(k.dtype))
            dvs.append(posted[1].wait().to(v.dtype))

    for dq_i, dk_g, dv_g in _rank_bwd(
            q, out, lse, dout, _gather(k, v, heads_k_stride, group),
            k.shape[1], scale, _mask(causal, q, q_segids, group, extras),
            heads_k_stride, backend, fused):
        # the previous chunk's reduce-scatters, waited for once this
        # chunk's kernel is queued; this chunk's gathered-size fp32 dk/dv,
        # summed over the ranks and sharded home, posted
        land(posted)
        posted = (reduce_scatter_start(dk_g, 2, group),
                  reduce_scatter_start(dv_g, 2, group))
        dqs.append(dq_i)
    land(posted)
    return _cat(dqs), _cat(dks), _cat(dvs)


class _Llama3Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_segids, scale, causal, heads_k_stride, group,
                backend, extras, fused):
        out, lse = _llama3_fwd(q, k, v, q_segids, scale, causal,
                               heads_k_stride, group, backend, extras)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.q_segids = q_segids
        ctx.args = (scale, causal, heads_k_stride, group, backend, extras,
                    fused)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _llama3_bwd(q, k, v, ctx.q_segids, out, lse, dout,
                                 *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def llama3_attention(q, k, v, q_segids=None, *, scale, causal=True,
                     heads_k_stride=None, group=None, backend=None,
                     softcap=None, alibi_slopes=None, dropout_p=None,
                     dropout_seed=None, window_left=None,
                     deterministic=False):
    """Differentiable llama3 all-gather attention on per-process (B, H,
    S_local, D).

    q/k/v are sharded contiguously along S over ``group`` (None: the
    default group, or one process when none is initialised); with packed
    sequences ``q_segids`` (S_local,) int32 on q's device holds the rank's
    tokens' globally consistent segment labels. Returns (out in q.dtype,
    lse fp32 (B, H, S_local)); lse carries no gradient.
    ``deterministic=True`` runs the backward on the bitwise reproducible
    split kernels B3a/B3b on the card."""
    hkv = k.shape[1]
    if heads_k_stride is None:
        heads_k_stride = hkv
    if hkv % heads_k_stride:
        raise ValueError(f"heads_k_stride={heads_k_stride} does not divide "
                         f"Hkv={hkv}")
    extras = dict(softcap=softcap, alibi_slopes=alibi_slopes,
                  dropout_p=dropout_p, dropout_seed=dropout_seed,
                  window_left=window_left)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Llama3Attention.apply(q, k, v, q_segids, scale, causal,
                                      heads_k_stride, group, backend, extras,
                                      False if deterministic else None)
    return _llama3_fwd(q, k, v, q_segids, scale, causal, heads_k_stride,
                       group, backend, extras)
