"""Flagship model: a llama-style decoder (RMSNorm, rotary, GQA attention,
SwiGLU MLP): forward, loss and SGD training step, on one device or with
the sequence sharded over a process group.

The port of ``ring_flash_attn_tpu/models/transformer.py`` for the dense
MLP and the ``ring``, ``zigzag``, ``stripe`` and ``usp`` schedules; llama3
attention in training, tensor parallelism and MoE come with their slices.
Weights keep the JAX orientation (d_in, d_out), used as ``x @ W``, so that
``params_from_jax`` is a copy and not a transpose. Parameters require grad;
the serving functions run under ``torch.no_grad()`` and build no graph.

The sequence group. JAX's ``axis_name=None`` means single-device flash
attention, while ``group=None`` means the default process group everywhere
in this package (``parallel/mesh.py``). So ``sp_group``, ``ulysses_group``
and ``data_group`` spell "none" as ``False``, their default, which keeps
the single-device behaviour; ``None`` is the default group (or one process
when ``torch.distributed`` is not initialised), and anything else a
process group. With a sequence group every process holds (B, S_local)
tokens in the layout of ``cfg.attention`` and the weights are replicated.
``attention="usp"`` also takes a ``ulysses_group`` (JAX's
``ulysses_axis``): the ring runs over ``sp_group``, the all-to-all over
``ulysses_group``, and the sequence is contiguous over (sequence rank
major, Ulysses rank minor). A stripe batch is laid out with
``layouts.all_local_stripe`` and ``layouts.stripe_position_ids``.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..ops.flash import flash_attention
from ..ops.mask import MaskArgs
from ..parallel import layouts
from ..parallel.mesh import all_reduce, psum_exact, ring_size
from ..parallel.ring import ring_attention
from ..parallel.stripe import stripe_attention
from ..parallel.ulysses import usp_attention
from ..parallel.zigzag import zigzag_ring_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    dim: int = 1024
    layers: int = 4
    heads: int = 16
    kv_heads: int = 4
    head_dim: int = 64
    mlp_dim: int = 2816
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # with a sequence group: ring | zigzag | stripe | usp (llama3 raises)
    attention: str = "zigzag"

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One decoder layer's weights (names as in the JAX parameter tree)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd, dt = cfg.dim, cfg.head_dim, cfg.torch_dtype
        f32 = torch.float32
        self.attn_norm = _param((d,), f32, device)
        self.wq = _param((d, cfg.heads * hd), dt, device)
        self.wk = _param((d, cfg.kv_heads * hd), dt, device)
        self.wv = _param((d, cfg.kv_heads * hd), dt, device)
        self.wo = _param((cfg.heads * hd, d), dt, device)
        self.mlp_norm = _param((d,), f32, device)
        self.w_gate = _param((d, cfg.mlp_dim), dt, device)
        self.w_up = _param((d, cfg.mlp_dim), dt, device)
        self.w_down = _param((cfg.mlp_dim, d), dt, device)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.dim), cfg.torch_dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.layers))
        self.final_norm = _param((cfg.dim,), torch.float32, device)
        self.lm_head = _param((cfg.dim, cfg.vocab), cfg.torch_dtype, device)

    @property
    def device(self):
        return self.embed.device

    def forward(self, tokens, positions, backend=None, sp_group=False,
                ulysses_group=False):
        """tokens (B, S) int, positions (S,) int -> logits (B, S, vocab) f32.

        ``backend="plain"`` runs attention's plain versions on the card.
        With ``sp_group`` (see the module docstring) tokens and positions
        are this process's shard and positions are global."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self.embed[tokens]
        for layer in self.layers:
            q, k, v = _proj_qkv(cfg, layer, _rmsnorm(x, layer.attn_norm), b, s)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            out = _attend(cfg, q, k, v, backend, sp_group, ulysses_group)
            x = x + out.transpose(1, 2).reshape(b, s, -1) @ layer.wo
            x = _mlp(x, layer)
        x = _rmsnorm(x, self.final_norm)
        return (x @ self.lm_head).float()


def _attend(cfg, q, k, v, backend, sp_group, ulysses_group):
    """Causal attention by the config's schedule; out (B, Hq, S, hd)."""
    scale = cfg.head_dim**-0.5
    if sp_group is False:
        out, _ = flash_attention(q, k, v, scale, MaskArgs(causal=True),
                                 backend=backend)
    elif cfg.attention == "ring":
        out, _ = ring_attention(q, k, v, scale=scale, causal=True,
                                group=sp_group, backend=backend)
    elif cfg.attention == "zigzag":
        out, _ = zigzag_ring_attention(q, k, v, scale=scale, group=sp_group,
                                       backend=backend)
    elif cfg.attention == "stripe":
        out, _ = stripe_attention(q, k, v, scale=scale, group=sp_group,
                                  backend=backend)
    elif cfg.attention == "usp":
        # the all-to-all over ulysses_group composed with a causal ring
        # over sp_group
        if ulysses_group is False:
            raise ValueError("usp attention needs a ulysses_group")
        out, _ = usp_attention(q, k, v, scale=scale, causal=True,
                               ulysses_group=ulysses_group,
                               ring_group=sp_group, variant="ring",
                               backend=backend)
    elif cfg.attention == "llama3":
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported to the training "
            f"path yet (see ROADMAP.md)")
    else:
        raise ValueError(cfg.attention)
    return out


def loss_fn(model, tokens, labels, positions, backend=None, sp_group=False,
            ulysses_group=False):
    """Mean next-token cross-entropy. labels (B, S) are already shifted and
    laid out like tokens; label -100 is ignored (padding). ``backend=
    "plain"`` runs attention's plain versions on the card (the reference
    that the kernels' gradients are held against). With ``sp_group`` (and
    ``ulysses_group``) the mean is over the whole sequence: the loss sum
    and the count are summed over the groups."""
    logits = model(tokens, positions, backend=backend, sp_group=sp_group,
                   ulysses_group=ulysses_group)
    valid = labels >= 0
    safe = labels.long().masked_fill(~valid, -100)  # every label < 0 ignored
    loss_sum = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               safe.reshape(-1), ignore_index=-100,
                               reduction="sum")
    count = valid.sum()
    for group in (sp_group, ulysses_group):
        if group is not False:
            # a sum whose backward is the identity: a plain all-reduce
            # would scale every weight gradient by the group's size
            loss_sum = psum_exact(loss_sum, group)
            count = all_reduce(count, "sum", group)  # carries no gradient
    return loss_sum / count.clamp(min=1)


def train_step(model, tokens, labels, positions, lr=1e-3, sp_group=False,
               data_group=False, ulysses_group=False):
    """One SGD step: p <- (p.f32 - lr * g.f32).to(p.dtype) on every
    parameter. Returns (model, loss).

    With ``sp_group``, ``ulysses_group`` and/or ``data_group`` (see the
    module docstring; the weights are replicated over all three) the
    gradients are summed over them,
    and the loss is averaged over ``data_group``, as in the JAX
    ``train_step``. Unlike it, which returns new parameters, this one
    updates the model's parameters in place (and returns the same model),
    so that a full-width step holds one copy of the weights."""
    params = list(model.parameters())
    loss = loss_fn(model, tokens, labels, positions, sp_group=sp_group,
                   ulysses_group=ulysses_group)
    grads = torch.autograd.grad(loss, params)
    groups = [g for g in (sp_group, ulysses_group, data_group)
              if g is not False]
    with torch.no_grad():
        for p, g in zip(params, grads):
            for group in groups:
                g = all_reduce(g, "sum", group)
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
        loss = loss.detach()
        if data_group is not False:
            loss = all_reduce(loss, "sum", data_group) / ring_size(data_group)
    return model, loss


def prepare_zigzag_batch(tokens, world):
    """Global (B, S) token batch -> (tokens, labels, positions) in the
    zigzag layout, rank-ordered along the sequence: rank r's shard is the
    r-th of ``world`` equal chunks of each. Labels are shifted by one with
    -100 last; positions (S,) int64 are global."""
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    s_local = tokens.shape[1] // world
    pos = np.concatenate([layouts.zigzag_position_ids(r, world, s_local)
                          for r in range(world)])
    return (layouts.all_local_zigzag(tokens, world, axis=1),
            layouts.all_local_zigzag(labels, world, axis=1),
            torch.as_tensor(pos, dtype=torch.long, device=tokens.device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """A Transformer with random weights drawn from ``generator``.

    Dense weights are normal * fan_in**-0.5, the embedding normal * 0.02,
    norms ones (fp32), as in the JAX init. Draws happen on the generator's
    device (pass a CUDA generator for a full-width model)."""
    device = resolve_device(device)
    model = Transformer(cfg, device)

    def fill(p, std):
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        p.copy_(x.mul_(std))

    with torch.no_grad():
        fill(model.embed, 0.02)
        fill(model.lm_head, cfg.dim**-0.5)
        for layer in model.layers:
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                w = getattr(layer, name)
                fill(w, w.shape[0]**-0.5)
            layer.attn_norm.fill_(1.0)
            layer.mlp_norm.fill_(1.0)
        model.final_norm.fill_(1.0)
    return model


def _to_torch(a):
    a = np.array(a)  # a writable copy: JAX's numpy views are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes, as JAX hands bf16 to numpy
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """A Transformer holding the JAX parameter tree's weights.

    ``np_tree`` is the JAX package's ``init_params`` tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): {"embed", "layers": [{...}],
    "final_norm", "lm_head"}, in the (d_in, d_out) orientation both
    packages use, so every leaf is copied as it is."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    pairs = [(model.embed, np_tree["embed"]),
             (model.final_norm, np_tree["final_norm"]),
             (model.lm_head, np_tree["lm_head"])]
    if len(np_tree["layers"]) != cfg.layers:
        raise ValueError(f"{len(np_tree['layers'])} layers, cfg says "
                         f"{cfg.layers}")
    for layer, src in zip(model.layers, np_tree["layers"]):
        pairs += [(getattr(layer, n), src[n]) for n in (
            "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
            "w_up", "w_down")]
    with torch.no_grad():
        for p, a in pairs:
            t = _to_torch(a)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(t.shape)} != {tuple(p.shape)}")
            p.copy_(t)
    return model


def _rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (n * w).to(x.dtype)


def _proj_qkv(cfg, layer, xn, b, s):
    """q (B, Hq, S, hd), k and v (B, Hkv, S, hd) from the normed input."""
    h, hkv, hd = cfg.heads, cfg.kv_heads, cfg.head_dim
    q = (xn @ layer.wq).reshape(b, s, h, hd).transpose(1, 2)
    k = (xn @ layer.wk).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (xn @ layer.wv).reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def _rope(x, positions, theta):
    """x (B, H, S, D), positions (S,) int: rotate by explicit positions.
    positions may carry leading dims that broadcast against x's (B, H, S),
    e.g. (B, 1, 1) for one decode token per lane."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def _mlp(x, layer):
    xn = _rmsnorm(x, layer.mlp_norm)
    return x + (F.silu(xn @ layer.w_gate) * (xn @ layer.w_up)) @ layer.w_down
