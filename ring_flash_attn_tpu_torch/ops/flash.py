"""Block flash-attention entry points and single-device differentiable API.

The port of ``ring_flash_attn_tpu/ops/flash.py``. ``block_fwd`` and
``block_bwd`` are the kernel boundary: a CUDA tensor goes to the kernels
(B1 ``flash_fwd_cuda``; B2 ``flash_bwd_cuda``, or B3a/B3b
``flash_bwd_split_cuda``), a CPU tensor to their plain versions
(``naive_block_fwd``, ``naive_block_bwd``); ``backend="plain"`` asks for
the plain versions on any device (reference runs on the card).
``flash_attention`` wraps them in a ``torch.autograd.Function``.

Layout is (B, H, S, D).
"""

import torch

from ..config import use_kernel
from .flash_bwd_cuda import flash_bwd_cuda, fused_bwd_supported
from .flash_bwd_split_cuda import flash_bwd_split_cuda
from .flash_fwd_cuda import flash_fwd_cuda, tma_layout_error
from .mask import MaskArgs
from .naive import naive_block_bwd, naive_block_fwd


def block_fwd(q, k, v, scale, mask: MaskArgs, backend=None, out_dtype=None):
    """One attention block: returns (out (B,Hq,Sq,D), lse f32 (B,Hq,Sq)).

    out is fp32 (the mergeable contract) unless out_dtype narrows it. On
    the card q, k and v go to B1 in a layout its TMA maps read
    (``_kernel_layout``: the views every caller passes are kept)."""
    if use_kernel(q, backend):
        q, k, v = map(_kernel_layout, (q, k, v))
        return flash_fwd_cuda(q, k, v, scale, mask,
                              out_dtype=out_dtype or torch.float32)
    out, lse = naive_block_fwd(q, k, v, scale, mask)
    return (out.to(out_dtype) if out_dtype else out), lse


def block_bwd(dout, q, k, v, lse, delta, scale, mask: MaskArgs, backend=None,
              dq_dtype=None, out=None, dkv_dtype=None, fused=None):
    """Block backward: returns (dq, dk, dv), dk/dv summed over the GQA group.

    dq is fp32 (a ring schedule accumulates it across steps) unless
    dq_dtype narrows it; dk/dv likewise with dkv_dtype. ``delta =
    rowsum(dout * out)`` is computed once by the caller, or the caller
    passes delta=None with the forward ``out`` and the kernels' pre-pass
    (or ``compute_delta``) computes it.

    On the card, ``fused=None`` picks the fused kernel B2 while
    ``fused_bwd_supported(Skv, D)`` holds (the JAX package's selector, same
    limit) and the split kernels B3a/B3b past it; ``fused=False`` asks for
    B3a/B3b, which are bitwise reproducible where B2's dq, summed by
    reduce-adds in a varying order, is not.
    """
    if delta is None and out is None:
        raise ValueError("delta=None requires the forward out")
    if use_kernel(q, backend):
        if fused is None:
            fused = fused_bwd_supported(k.shape[2], q.shape[3])
        bwd = flash_bwd_cuda if fused else flash_bwd_split_cuda
        return bwd(dout, q, k, v, lse, delta, scale, mask, out=out,
                   dq_dtype=dq_dtype, dkv_dtype=dkv_dtype)
    if delta is None:
        delta = compute_delta(dout, out)
    dq, dk, dv = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
    if dkv_dtype is not None:
        dk, dv = dk.to(dkv_dtype), dv.to(dkv_dtype)
    return (dq.to(dq_dtype) if dq_dtype else dq), dk, dv


def compute_delta(dout, out):
    """delta_i = sum_d dout[i,d] * out[i,d], fp32, shape (B, H, S)."""
    return (dout.float() * out.float()).sum(dim=-1)


def _kernel_layout(x):
    """x itself if the kernels' TMA maps read its layout
    (``tma_layout_error``), else a contiguous copy. An incoming gradient
    may be an expanded or sliced view."""
    if tma_layout_error(x) is None:
        return x
    return x.clone(memory_format=torch.contiguous_format)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, mask, backend, fused):
        out, lse = block_fwd(q, k, v, scale, mask, backend, out_dtype=q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = (scale, mask, backend, fused)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):  # no gradient path through lse
        q, k, v, out, lse = ctx.saved_tensors
        scale, mask, backend, fused = ctx.args
        if use_kernel(q, backend):
            dout = _kernel_layout(dout)
        # delta=None: the kernels' pre-pass computes it from out; gradients
        # come back in the callers' dtypes
        dq, dk, dv = block_bwd(dout, q, k, v, lse, None, scale, mask,
                               backend, dq_dtype=q.dtype, out=out,
                               dkv_dtype=k.dtype, fused=fused)
        return dq, dk, dv.to(v.dtype), None, None, None, None


def flash_attention(q, k, v, scale, mask: MaskArgs, backend=None,
                    fused=None):
    """Differentiable single-device flash attention: (out in q.dtype, lse
    f32). lse carries no gradient, as in the JAX package. ``fused`` goes
    to ``block_bwd`` (False: the reproducible split kernels)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, mask, backend, fused)
    return block_fwd(q, k, v, scale, mask, backend, out_dtype=q.dtype)
