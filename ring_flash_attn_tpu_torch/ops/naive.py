"""Plain PyTorch block attention, forward and backward, with the flash
(out, lse) contract.

The port of ``naive_block_fwd`` and ``naive_block_bwd`` from
``ring_flash_attn_tpu/ops/naive.py``: the plain versions of kernel B1
(``csrc/flash_fwd.cu``) and of kernels B2, B3a and B3b
(``csrc/flash_bwd.cu``, ``csrc/flash_bwd_split.cu``). They compute the same
quantities as the kernels (fp32 accumulation, natural-log lse, NEG_INF
sentinel masking, segment ids and explicit positions, sliding windows)
with O(Sq*Skv) memory, and beyond them softcap and ALiBi on the scaled
logits (softcap, then ALiBi, then the mask), and dropout: the normalised
probabilities are dropped by the hash of ``ops/mask.py`` (the JAX
package's keep mask bit for bit) and the kept ones scaled by 1 / (1 - p),
on the P V product only; lse stays undropped. A q row with no allowed key gives out = 0 and
lse = NEG_INF, and no gradient; a key no row may see gets dk = dv = 0. The CPU tests hold them against
the JAX package; ``chip_smoke.py`` holds the kernels against them on the
card.

Shapes:
  q:    (B, Hq,  Sq,  D)
  k, v: (B, Hkv, Skv, D)   with Hq % Hkv == 0 (GQA: q head h reads kv
                           head h // (Hq / Hkv))
  out:  (B, Hq,  Sq,  D) fp32
  lse:  (B, Hq,  Sq)     fp32
"""

import torch

from .mask import (NEG_INF, MaskArgs, alibi_bias, check_supported,
                   dropout_keep_dense, mask_logits)


def _logits(qf, kf, scale, mask: MaskArgs):
    """Scaled logits (B, Hkv, G, Sq, Skv) through softcap, then ALiBi, then
    the mask, and the softcap's derivative 1 - tanh^2 (None without it)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    dcap = None
    if mask.softcap:
        t = torch.tanh(s / mask.softcap)
        s = mask.softcap * t
        dcap = 1.0 - t * t
    bias = alibi_bias(mask, qf.shape[1], qf.shape[2], qf.shape[3],
                      kf.shape[2], qf.device)
    if bias is not None:
        s = s + bias
    return mask_logits(s, mask), dcap


def naive_block_fwd(q, k, v, scale, mask: MaskArgs):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    s, _ = _logits(qf, k.float(), scale, mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = dropout_keep_dense(mask, b, hkv, g, sq, skv, q.device)
    if keep is not None:
        # dropout on the normalised probabilities: l stays undropped
        p = p.masked_fill(~keep, 0.0) * (1.0 / (1.0 - mask.dropout_p))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    # rows whose every key is masked ("dead" rows) give out=0 and
    # lse=NEG_INF, the value a partial merge treats as weight zero
    dead = m <= NEG_INF / 2
    out = out.masked_fill(dead, 0.0)
    lse = lse.masked_fill(dead.squeeze(-1), NEG_INF)
    return out.reshape(b, hq, sq, d), lse.reshape(b, hq, sq)


def naive_block_bwd(dout, q, k, v, lse, delta, scale, mask: MaskArgs):
    """Returns (dq, dk, dv) fp32; dk/dv already summed over the GQA group.

    p is recomputed from the (merged) lse: p = exp(s - lse) with s the
    logits as the forward transformed them; dv = p^T dout; ds = p *
    (dout v^T - delta) * scale, times 1 - tanh^2 under softcap (ALiBi is
    additive and leaves ds alone); dq = ds k; dk = ds^T q. With dropout
    dv takes the dropped, scaled p, dout v^T is dropped and scaled the same
    way and ds takes the undropped p. delta = rowsum(dout * out) on the
    dropped out (``ops/flash.py::compute_delta``)."""
    check_supported(mask)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    doutf = dout.float().reshape(b, hkv, g, sq, d)
    # Dead rows carry lse = NEG_INF; clamping to NEG_INF/2 makes
    # p = exp(NEG_INF - NEG_INF/2) underflow to 0 so they contribute no
    # gradient (instead of exp(0) = 1). Live rows are unaffected.
    lsef = lse.float().clamp(min=NEG_INF / 2).reshape(b, hkv, g, sq, 1)
    deltaf = delta.float().reshape(b, hkv, g, sq, 1)
    kf, vf = k.float(), v.float()
    s, dcap = _logits(qf, kf, scale, mask)
    p = torch.exp(s - lsef)
    keep = dropout_keep_dense(mask, b, hkv, g, sq, skv, q.device)
    p_v = p
    if keep is not None:
        inv = 1.0 / (1.0 - mask.dropout_p)
        p_v = p.masked_fill(~keep, 0.0) * inv
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p_v, doutf)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", doutf, vf)
    if keep is not None:
        dp = dp.masked_fill(~keep, 0.0) * inv
    ds = p * (dp - deltaf) * scale
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return dq.reshape(b, hq, sq, d), dk, dv
