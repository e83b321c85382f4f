"""RMSNorm, shared by the dense decoder (``transformer.py``), its MoE MLP
(``moe.py``) and the serving and decoding functions."""

import torch


def rmsnorm(x, w, eps=1e-6):
    """x * rsqrt(mean(x^2) + eps) * w, computed in fp32, in x's dtype."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (n * w).to(x.dtype)
