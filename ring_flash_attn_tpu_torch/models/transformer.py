"""Flagship model: a llama-style decoder (RMSNorm, rotary, GQA attention,
SwiGLU or switch-MoE MLP): forward, loss and SGD training step, on one
device or with the sequence, the heads and the experts sharded over
process groups.

The port of ``ring_flash_attn_tpu/models/transformer.py``: the dense and
MoE MLPs (``models/moe.py``), the ``ring``, ``zigzag``, ``stripe``,
``llama3`` and ``usp`` schedules, Megatron tensor parallelism and expert
parallelism. Weights keep the JAX orientation (d_in, d_out), used as
``x @ W``, so that ``params_from_jax`` is a copy and not a transpose.
Parameters require grad; the serving functions run under
``torch.no_grad()`` and build no graph.

The groups. JAX's ``axis_name=None`` means single-device flash attention,
while ``group=None`` means the default process group everywhere in this
package (``parallel/mesh.py``). So ``sp_group``, ``ulysses_group``,
``data_group``, ``tp_group`` and ``ep_group`` spell "none" as ``False``,
their default, which keeps the single-device behaviour; ``None`` is the
default group (or one process when ``torch.distributed`` is not
initialised), and anything else a process group. With a sequence group
every process holds (B, S_local) tokens in the layout of
``cfg.attention``. ``attention="usp"`` also takes a ``ulysses_group``
(JAX's ``ulysses_axis``): the ring runs over ``sp_group``, the all-to-all
over ``ulysses_group``, and the sequence is contiguous over (sequence rank
major, Ulysses rank minor). A stripe batch is laid out with
``layouts.all_local_stripe`` and ``layouts.stripe_position_ids``.

Tensor parallelism (Megatron): ``shard_params`` gives each rank of
``tp_group`` its shards (``param_specs``): wq/wk/wv and w_gate/w_up split
by columns, wo/w_down by rows, one ``psum_exact`` after each; ``_tp_copy``
at each branch's input sums the branch's cotangent over the group on the
way back, so every gradient is whole with no per-leaf fix-up. Attention
runs the schedule over the rank's heads / tp local heads. Expert
parallelism: with ``cfg.moe_experts`` the experts are split over
``ep_group`` (dim 0), the batch is split over it too, and ``train_step``
sums every other gradient over it.
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
from ..parallel.llama3 import llama3_attention
from ..parallel.ring import ring_attention
from ..parallel.stripe import stripe_attention
from ..parallel.ulysses import usp_attention
from ..parallel.zigzag import zigzag_ring_attention
from .moe import MoELayer, draw_moe_layer, moe_mlp
from .norm import rmsnorm


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
    # with a sequence group: ring | zigzag | stripe | llama3 | usp
    attention: str = "zigzag"
    # mixture-of-experts MLP (0: dense): switch routing, experts split over
    # an ep_group (models/moe.py)
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    # weight of the switch load-balancing loss (0 disables)
    moe_aux_weight: float = 0.01

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# the JAX package has neither a reference nor param_specs for the two
# together
_TP_MOE = "tensor parallelism with a MoE MLP is not ported (see ROADMAP.md)"


def _split(n, parts, what):
    if n % parts:
        raise ValueError(f"{what}={n} does not split over {parts} ranks")
    return n // parts


class Block(nn.Module):
    """One decoder layer's weights (names as in the JAX parameter tree):
    the shards of one rank of ``tp`` tensor-parallel ranks and ``ep``
    expert-parallel ranks (whole at 1)."""

    def __init__(self, cfg: ModelConfig, device, tp=1, ep=1):
        super().__init__()
        d, hd, dt = cfg.dim, cfg.head_dim, cfg.torch_dtype
        f32 = torch.float32
        h = _split(cfg.heads, tp, "heads")
        hkv = _split(cfg.kv_heads, tp, "kv_heads")
        self.attn_norm = _param((d,), f32, device)
        self.wq = _param((d, h * hd), dt, device)
        self.wk = _param((d, hkv * hd), dt, device)
        self.wv = _param((d, hkv * hd), dt, device)
        self.wo = _param((h * hd, d), dt, device)
        self.mlp_norm = _param((d,), f32, device)
        if cfg.moe_experts:
            if tp > 1:
                raise NotImplementedError(_TP_MOE)
            self.moe = MoELayer(d, cfg.mlp_dim, cfg.moe_experts, dt, device,
                                _split(cfg.moe_experts, ep, "moe_experts"))
        else:
            mlp = _split(cfg.mlp_dim, tp, "mlp_dim")
            self.w_gate = _param((d, mlp), dt, device)
            self.w_up = _param((d, mlp), dt, device)
            self.w_down = _param((mlp, d), dt, device)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, tp=1, ep=1):
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.dim), cfg.torch_dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device, tp, ep)
                                    for _ in range(cfg.layers))
        self.final_norm = _param((cfg.dim,), torch.float32, device)
        self.lm_head = _param((cfg.dim, cfg.vocab), cfg.torch_dtype, device)

    @property
    def device(self):
        return self.embed.device

    def forward(self, tokens, positions, backend=None, sp_group=False,
                ulysses_group=False, tp_group=False, ep_group=False):
        """tokens (B, S) int, positions (S,) int -> logits (B, S, vocab) f32;
        with ``cfg.moe_experts``, (logits, (counts, probsums)): the router
        statistics (L, E) over the local tokens.

        ``backend="plain"`` runs attention's plain versions on the card.
        With ``sp_group`` (see the module docstring) tokens and positions
        are this process's shard and positions are global; with
        ``tp_group`` the model holds this rank's shards; with
        ``ep_group`` its experts."""
        cfg = self.cfg
        if cfg.moe_experts and tp_group is not False:
            raise NotImplementedError(_TP_MOE)
        b, s = tokens.shape
        x = self.embed[tokens]
        counts, probsums = [], []
        for layer in self.layers:
            x = x + _attn_branch(cfg, x, layer, positions, backend,
                                 sp_group, ulysses_group, tp_group)
            if cfg.moe_experts:
                cap = max(1, int(b * s / cfg.moe_experts
                                 * cfg.moe_capacity_factor))
                x, (c_e, p_e) = moe_mlp(x, layer.moe, layer.mlp_norm, cap,
                                        ep_group, return_aux=True)
                counts.append(c_e)
                probsums.append(p_e)
            else:
                x = _mlp(x, layer, tp_group)
        x = rmsnorm(x, self.final_norm)
        logits = (x @ self.lm_head).float()
        if cfg.moe_experts:
            return logits, (torch.stack(counts), torch.stack(probsums))
        return logits


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, "sum", ctx.group), None


def _tp_copy(x, tp_group):
    """Megatron's "f": the identity forward, the cotangent summed over
    ``tp_group`` backward. At each branch's input, it sums the ranks'
    partial cotangents once, after which every activation's and replicated
    weight's gradient is whole on every rank."""
    if tp_group is False:
        return x
    return _TpCopy.apply(x, tp_group)


def _check_tp_heads(cfg, layer, tp_group):
    """The layer holds one rank's heads of ``tp_group``: heads / tp q and
    kv_heads / tp kv heads, both whole."""
    tp = ring_size(tp_group)
    if cfg.heads % tp or cfg.kv_heads % tp:
        raise ValueError(f"heads {cfg.heads} and kv_heads {cfg.kv_heads} "
                         f"must divide over tp={tp}")
    h, hkv = (w.shape[1] // cfg.head_dim for w in (layer.wq, layer.wk))
    if (h, hkv) != (cfg.heads // tp, cfg.kv_heads // tp):
        raise ValueError(f"the layer holds {h}/{hkv} heads, not the shard "
                         f"of tp={tp} ranks")


def _attn_branch(cfg, x, layer, positions, backend=None, sp_group=False,
                 ulysses_group=False, tp_group=False):
    """The attention branch's output (B, S, D); with ``tp_group`` over
    this rank's heads (its shards of wq/wk/wv by columns, wo by rows), the
    partial products of wo summed over the group. With a shard and no
    group it is the rank's partial product."""
    b, s, _ = x.shape
    if tp_group is not False:
        _check_tp_heads(cfg, layer, tp_group)
    xn = _tp_copy(rmsnorm(x, layer.attn_norm), tp_group)
    q, k, v = _proj_qkv(cfg, layer, xn, b, s)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, backend, sp_group, ulysses_group)
    proj = out.transpose(1, 2).reshape(b, s, -1) @ layer.wo
    if tp_group is not False:
        # the cotangent is not summed again: _tp_copy at the input does it
        proj = psum_exact(proj, tp_group)
    return proj


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
    elif cfg.attention == "llama3":
        out, _ = llama3_attention(q, k, v, scale=scale, causal=True,
                                  group=sp_group, backend=backend)
    elif cfg.attention == "usp":
        # the all-to-all over ulysses_group composed with a causal ring
        # over sp_group
        if ulysses_group is False:
            raise ValueError("usp attention needs a ulysses_group")
        out, _ = usp_attention(q, k, v, scale=scale, causal=True,
                               ulysses_group=ulysses_group,
                               ring_group=sp_group, variant="ring",
                               backend=backend)
    else:
        raise ValueError(cfg.attention)
    return out


def loss_fn(model, tokens, labels, positions, backend=None, sp_group=False,
            ulysses_group=False, tp_group=False, ep_group=False):
    """Mean next-token cross-entropy. labels (B, S) are already shifted and
    laid out like tokens; label -100 is ignored (padding). ``backend=
    "plain"`` runs attention's plain versions on the card (the reference
    that the kernels' gradients are held against). With ``sp_group``,
    ``ulysses_group`` and ``ep_group`` the mean is over all their tokens:
    the loss sum and the count are summed over the groups. A MoE model adds
    ``moe_aux_weight`` times the switch load-balancing loss, from the
    router statistics summed over the same groups."""
    out = model(tokens, positions, backend=backend, sp_group=sp_group,
                ulysses_group=ulysses_group, tp_group=tp_group,
                ep_group=ep_group)
    cfg = model.cfg
    logits, aux = out if cfg.moe_experts else (out, None)
    valid = labels >= 0
    safe = labels.long().masked_fill(~valid, -100)  # every label < 0 ignored
    loss_sum = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               safe.reshape(-1), ignore_index=-100,
                               reduction="sum")
    count = valid.sum()
    groups = [g for g in (sp_group, ulysses_group, ep_group) if g is not False]
    for group in groups:
        # the sum whose backward is the identity, where JAX's plain psum
        # would scale every weight gradient by the group's size
        loss_sum = psum_exact(loss_sum, group)
        count = all_reduce(count, "sum", group)  # carries no gradient
    loss = loss_sum / count.clamp(min=1)
    if cfg.moe_experts and cfg.moe_aux_weight:
        # the global switch loss from the summed statistics: the sharded
        # value is the unsharded one
        counts, probsums = aux
        tokens_all = tokens.numel()
        for group in groups:
            counts = all_reduce(counts, "sum", group)  # no gradient path
            probsums = psum_exact(probsums, group)
            tokens_all *= ring_size(group)
        f_e, p_e = counts / tokens_all, probsums / tokens_all  # (L, E)
        aux_loss = cfg.moe_experts * (f_e * p_e).sum(dim=-1)
        loss = loss + cfg.moe_aux_weight * aux_loss.mean()
    return loss


def train_step(model, tokens, labels, positions, lr=1e-3, sp_group=False,
               data_group=False, ulysses_group=False, tp_group=False,
               ep_group=False):
    """One SGD step: p <- (p.f32 - lr * g.f32).to(p.dtype) on every
    parameter. Returns (model, loss).

    With ``sp_group``, ``ulysses_group`` and/or ``data_group`` (see the
    module docstring; the weights are replicated over all three) the
    gradients are summed over them, and the loss is averaged over
    ``data_group``, as in the JAX ``train_step``. With ``ep_group`` the
    gradients of every parameter but the experts' (split over the group,
    their gradients whole after the all-to-all) are summed over it too.
    Under ``tp_group`` no further sum is needed: ``_tp_copy`` already made
    every gradient whole. Unlike the JAX function, which returns new
    parameters, this one updates the model's parameters in place (and
    returns the same model), so that a full-width step holds one copy of
    the weights."""
    named = list(model.named_parameters())
    loss = loss_fn(model, tokens, labels, positions, sp_group=sp_group,
                   ulysses_group=ulysses_group, tp_group=tp_group,
                   ep_group=ep_group)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    base = [g for g in (sp_group, ulysses_group, data_group)
            if g is not False]
    specs = param_specs(model.cfg)
    with torch.no_grad():
        for (name, p), g in zip(named, grads):
            groups = base
            if ep_group is not False and (specs[name] or ("",))[0] != "ep":
                groups = base + [ep_group]
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
    norms ones (fp32), as in the JAX init; a MoE layer's as
    ``moe.draw_moe_layer`` draws them. Draws happen on the generator's
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
            for name in _DENSE:
                w = getattr(layer, name, None)
                if w is not None:
                    fill(w, w.shape[0]**-0.5)
            if cfg.moe_experts:
                draw_moe_layer(layer.moe, generator)
            layer.attn_norm.fill_(1.0)
            layer.mlp_norm.fill_(1.0)
        model.final_norm.fill_(1.0)
    return model


_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_MOE = ("router", "we_gate", "we_up", "we_down")


def param_specs(cfg: ModelConfig):
    """How each parameter is split, the counterpart of the JAX
    ``param_specs`` (tp) and of the ep specs of its MoE tests: {name: None
    (replicated) or (group, dim)}, group "tp" or "ep", the dim cut into W
    contiguous chunks in rank order (``shard_map``'s tiling). Column
    shards: wq/wk/wv/w_gate/w_up (dim 1); row shards: wo/w_down (dim 0);
    the experts' stacks over ep (dim 0); the rest is replicated."""
    specs = {"embed": None, "final_norm": None, "lm_head": None}
    layer = {"attn_norm": None, "wq": ("tp", 1), "wk": ("tp", 1),
             "wv": ("tp", 1), "wo": ("tp", 0), "mlp_norm": None}
    if cfg.moe_experts:
        layer.update({"moe.router": None, "moe.we_gate": ("ep", 0),
                      "moe.we_up": ("ep", 0), "moe.we_down": ("ep", 0)})
    else:
        layer.update(w_gate=("tp", 1), w_up=("tp", 1), w_down=("tp", 0))
    for i in range(cfg.layers):
        specs.update({f"layers.{i}.{n}": spec for n, spec in layer.items()})
    return specs


def _jax_leaves(np_tree, cfg):
    """{parameter name: numpy leaf} of the JAX package's parameter tree."""
    if len(np_tree["layers"]) != cfg.layers:
        raise ValueError(f"{len(np_tree['layers'])} layers, cfg says "
                         f"{cfg.layers}")
    leaves = {n: np_tree[n] for n in ("embed", "final_norm", "lm_head")}
    for i, src in enumerate(np_tree["layers"]):
        for n, a in src.items():
            if n == "moe":
                leaves.update({f"layers.{i}.moe.{m}": a[m] for m in _MOE})
            else:
                leaves[f"layers.{i}.{n}"] = a
    return leaves


def shard_params(src, cfg: ModelConfig, tp_rank=0, tp=1, ep_rank=0, ep=1,
                 device="cuda"):
    """A Transformer holding the shards of tensor-parallel rank ``tp_rank``
    of ``tp`` and expert-parallel rank ``ep_rank`` of ``ep``
    (``param_specs``), cut from ``src``: a whole Transformer, or the JAX
    package's parameter tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``), whose leaves are copied as they are (both packages use the
    (d_in, d_out) orientation)."""
    device = resolve_device(device)
    model = Transformer(cfg, device, tp, ep)
    if isinstance(src, nn.Module):
        whole = dict(src.named_parameters())
    else:
        whole = {n: _to_torch(a) for n, a in _jax_leaves(src, cfg).items()}
    ranks = {"tp": (tp_rank, tp), "ep": (ep_rank, ep)}
    specs = param_specs(cfg)
    params = dict(model.named_parameters())
    if set(whole) != set(params):
        raise ValueError(f"parameters {sorted(set(whole) ^ set(params))} "
                         f"are on one side only")
    with torch.no_grad():
        for name, p in params.items():
            t = whole[name]
            if specs[name] is not None:
                group, dim = specs[name]
                rank, size = ranks[group]
                t = t.chunk(size, dim)[rank]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
    return model


def _to_torch(a):
    a = np.array(a)  # a writable copy: JAX's numpy views are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes, as JAX hands bf16 to numpy
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """A Transformer holding the JAX parameter tree's weights, whole.

    ``np_tree`` is the JAX package's ``init_params`` tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): {"embed", "layers": [{...,
    "moe": {...} for a MoE layer}], "final_norm", "lm_head"}."""
    return shard_params(np_tree, cfg, device=device)


def _proj_qkv(cfg, layer, xn, b, s):
    """q (B, Hq, S, hd), k and v (B, Hkv, S, hd) from the normed input,
    over the heads the layer holds (a tensor-parallel shard holds
    heads / tp of them)."""
    hd = cfg.head_dim
    h, hkv = layer.wq.shape[1] // hd, layer.wk.shape[1] // hd
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


def _mlp(x, layer, tp_group=False):
    """x + the SwiGLU branch (``_mlp_branch``)."""
    return x + _mlp_branch(x, layer, tp_group)


def _mlp_branch(x, layer, tp_group=False):
    """The SwiGLU branch's output; with ``tp_group`` over this rank's
    shards (w_gate/w_up by columns, w_down by rows), summed over the
    group. With a shard and no group it is the rank's partial product."""
    xn = _tp_copy(rmsnorm(x, layer.mlp_norm), tp_group)
    y = (F.silu(xn @ layer.w_gate) * (xn @ layer.w_up)) @ layer.w_down
    if tp_group is not False:
        y = psum_exact(y, tp_group)
    return y
