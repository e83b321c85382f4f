"""Pipeline parallelism (GPipe schedule) for the flagship model.

The port of ``ring_flash_attn_tpu/models/pipeline.py``. The layers are cut
into ``pp`` stages, one a rank of ``pp_group`` (``stack_layers``: the
stage's slice of layers, with the replicated embedding, final norm and
lm_head); microbatches flow stage -> stage + 1 on the skewed GPipe
schedule (tick t: stage s works on microbatch t - s, so the pipeline fills
and drains in M + P - 1 ticks). The hop is a rotation of the pp ring
(``mesh.ring_rotate``, rank i to i + 1) whose backward is the reverse
rotation (``_Hop``), so autograd runs the reverse pipeline.

Every rank must run every tick's backward hop, in the same order, or the
ring waits forever. So each stage's graph has the same chain of hops: a
stage's input is ``torch.where(stage == 0, microbatch, held)`` on every
stage (the held activation stays in stage 0's graph, as in the JAX
``jnp.where``), and a stage that is not the last one keeps its last tick's
output in its loss with a zero weight. Ticks in the pipeline's bubbles
(t - s outside [0, M)) pass their input on without running the layers:
every rank of a stage has the same bubbles, so the sequence group's
collectives inside the layers stay in step.

Composes with the sequence axis: each stage's layers are the flagship's
attention branch (``cfg.attention``'s schedule over ``sp_group``) and MLP.
The embedding runs on stage 0, the final norm, lm_head and loss on the
last stage; ``train_step_pp`` sums their gradients over pp (the layers'
stay stage-local). ``pp_group=False`` is one stage (pp = 1) with no
process group.
"""

import dataclasses

import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..parallel.mesh import (all_reduce, psum_exact, ring_rank, ring_rotate,
                             ring_size)
from .norm import rmsnorm
from .transformer import (ModelConfig, Transformer, _attn_branch, _mlp,
                          param_specs, whole_params)


_DENSE_ONLY = ("the pipeline's stages run dense MLPs only, as the JAX "
               "package's do: its pipeline_specs place no experts")


def _stage(pp_group):
    """(pp, this rank's stage)."""
    if pp_group is False:
        return 1, 0
    return ring_size(pp_group), ring_rank(pp_group)


def _stage_name(name, first):
    """A stage model's parameter name -> the whole model's (its layer i is
    the whole model's layer first + i)."""
    if not name.startswith("layers."):
        return name
    _, i, rest = name.split(".", 2)
    return f"layers.{first + int(i)}.{rest}"


def stack_layers(src, cfg: ModelConfig, pp_rank=0, pp=1, device="cuda"):
    """The model of stage ``pp_rank`` of ``pp`` (JAX's ``stack_layers``
    with its pp shard): a Transformer of cfg.layers / pp layers, the whole
    model's layers [pp_rank * L / pp, (pp_rank + 1) * L / pp), and the
    replicated embed, final_norm and lm_head, cut from ``src`` (a whole
    Transformer, or the JAX package's parameter tree with numpy leaves)."""
    if cfg.moe_experts:
        raise NotImplementedError(_DENSE_ONLY)
    if cfg.layers % pp:
        raise ValueError(f"layers={cfg.layers} do not split into {pp} stages")
    per = cfg.layers // pp
    stage = Transformer(dataclasses.replace(cfg, layers=per),
                        resolve_device(device))
    whole = whole_params(src, cfg)
    with torch.no_grad():
        for name, p in stage.named_parameters():
            p.copy_(whole[_stage_name(name, pp_rank * per)])
    return stage


def pipeline_specs(cfg: ModelConfig, pp):
    """Where each of the whole model's parameters lives (JAX's
    ``pipeline_specs``): {name: the stage that holds it, or None for the
    replicated embed, final_norm and lm_head}."""
    if cfg.layers % pp:
        raise ValueError(f"layers={cfg.layers} do not split into {pp} stages")
    per = cfg.layers // pp
    return {n: (int(n.split(".")[1]) // per if n.startswith("layers.")
                else None) for n in param_specs(cfg)}


class _Hop(torch.autograd.Function):
    """Stage i's activation to stage i + 1 (the wrap to stage 0 is
    overwritten there); the backward sends the cotangent back, i + 1 to
    i."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_rotate(x, group)

    @staticmethod
    def backward(ctx, grad):
        return ring_rotate(grad.contiguous(), ctx.group, reverse=True), None


def _stage_layers(model, x, positions, sp_group):
    """The stage's layers, dense (``_pipeline`` refuses MoE models)."""
    cfg = model.cfg
    for layer in model.layers:
        x = x + _attn_branch(cfg, x, layer, positions, sp_group=sp_group)
        x = _mlp(x, layer)
    return x


def _pipeline(model, tokens, positions, pp_group, microbatches, sp_group):
    """(the last tick's stage output, the last stage's banked outputs (M,
    B_mb, S, D) or None elsewhere)."""
    if model.cfg.moe_experts:
        raise NotImplementedError(_DENSE_ONLY)
    pp, stage = _stage(pp_group)
    m = microbatches
    if tokens.shape[0] % m:
        raise ValueError(f"batch {tokens.shape[0]} does not split into {m} "
                         "microbatches")
    bmb, s = tokens.shape[0] // m, tokens.shape[1]
    xs = model.embed[tokens.reshape(m, bmb, s)]  # (M, B_mb, S, D)
    first = torch.tensor(stage == 0, device=xs.device)
    hold = xs.new_zeros((bmb, s, model.cfg.dim))
    outs = [None] * m
    ticks = m + pp - 1
    for t in range(ticks):
        # stage 0 takes microbatch t; the others what the hop brought
        x = torch.where(first, xs[min(t, m - 1)], hold)
        y = (_stage_layers(model, x, positions, sp_group)
             if 0 <= t - stage < m else x)
        if stage == pp - 1 and t >= pp - 1:
            outs[t - (pp - 1)] = y
        if t < ticks - 1 and pp > 1:
            hold = _Hop.apply(y, pp_group)
    return y, (torch.stack(outs) if stage == pp - 1 else None)


def forward_pp(model, tokens, positions, pp_group, microbatches,
               sp_group=False):
    """Pipelined forward of this rank's stage (``stack_layers``). tokens
    (M * B_mb, S_local), positions (S_local,) as ``Transformer.forward``
    takes them. Returns the logits (M * B_mb, S_local, vocab) f32 on the
    last stage and None on the others."""
    _, outs = _pipeline(model, tokens, positions, pp_group, microbatches,
                        sp_group)
    return None if outs is None else _logits(model, outs, tokens.shape)


def _logits(model, outs, shape):
    x = rmsnorm(outs.reshape(*shape, -1), model.final_norm)
    return (x @ model.lm_head).float()


def loss_fn_pp(model, tokens, labels, positions, pp_group, microbatches,
               sp_group=False):
    """Mean next-token cross-entropy of the pipelined forward (labels as
    ``transformer.loss_fn`` takes them). The last stage computes it; the
    sum (``psum_exact``) and the count over pp and ``sp_group`` give every
    stage the same scalar. A stage that is not the last adds its last
    tick's output times zero, so that its backward runs every hop."""
    y, outs = _pipeline(model, tokens, positions, pp_group, microbatches,
                        sp_group)
    if outs is None:
        loss_sum = (y * 0.0).sum().float()
        count = torch.zeros((), dtype=torch.long, device=y.device)
    else:
        logits = _logits(model, outs, tokens.shape)
        valid = labels >= 0
        loss_sum = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            labels.long().masked_fill(~valid, -100).reshape(-1),
            ignore_index=-100, reduction="sum")
        count = valid.sum()
    for group in (pp_group, sp_group):
        if group is not False:
            loss_sum = psum_exact(loss_sum, group)
            count = all_reduce(count, "sum", group)
    return loss_sum / count.clamp(min=1)


def train_step_pp(model, tokens, labels, positions, pp_group, microbatches,
                  lr=1e-3, sp_group=False, data_group=False):
    """One SGD step of this rank's stage: p <- (p.f32 - lr * g.f32).to(
    p.dtype), in place. Returns (model, loss).

    The stage's layers' gradients stay stage-local; the embed, final_norm
    and lm_head (used on one stage each) get their gradients summed over
    pp so that every stage applies the same update. Every gradient is
    summed over ``sp_group`` and over ``data_group`` (dp x pp x sp: the
    data replicas of a stage hold the same weights and their own batch),
    and the loss is averaged over ``data_group``, as the JAX
    ``train_step_pp`` does with ``axis_name`` and ``data_axis``."""
    named = list(model.named_parameters())
    loss = loss_fn_pp(model, tokens, labels, positions, pp_group,
                      microbatches, sp_group)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    base = [g for g in (sp_group, data_group) if g is not False]
    with torch.no_grad():
        for (name, p), g in zip(named, grads):
            g = torch.zeros_like(p) if g is None else g
            groups = list(base)
            if pp_group is not False and not name.startswith("layers."):
                groups.append(pp_group)
            for group in groups:
                g = all_reduce(g, "sum", group)
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
        loss = loss.detach()
        if data_group is not False:
            loss = all_reduce(loss, "sum", data_group) / ring_size(data_group)
    return model, loss
