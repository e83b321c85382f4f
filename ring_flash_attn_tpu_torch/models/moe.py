"""Mixture-of-experts MLP with expert parallelism over a process group.

The port of ``ring_flash_attn_tpu/models/moe.py``: top-1 (switch) routing,
experts sharded over an ``ep_group`` and tokens exchanged with
``mesh.all_to_all`` (whose backward is the inverse all-to-all).

The token/batch dimension is sharded over the same group (dp == ep). Per
process: route the local tokens to all E experts, all-to-all so that each
process holds its E / ep local experts' queues from every source process,
run the local expert FFNs in fp32 (batched over the experts), all-to-all
back, combine with the router's gate. The capacity C is per (expert,
source process); tokens past it are dropped (their MLP contribution is
zero, the residual passes through).

Dispatch and combine are index operations where the JAX package multiplies
by (T, E, C) one-hot tensors: a gather of each kept token into its (expert,
slot) row of an (E, C, D) buffer whose empty slots are zero, and a gather
of each token's row of the experts' output times its gate (zero for a
dropped token). Each one-hot row holds a single 1, so both compute the
same function, at T·D work instead of T·E·C·D, and without a host
synchronisation.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_to_all, ring_size
from .norm import rmsnorm


class MoELayer(nn.Module):
    """A switch MoE block's weights (names as in the JAX tree): the router
    (D, E) in fp32, and ``e_local`` experts' ``we_gate``, ``we_up`` (E_l, D,
    MLP) and ``we_down`` (E_l, MLP, D) in the model dtype. Uninitialised;
    ``init_moe_layer`` draws them."""

    def __init__(self, dim, mlp_dim, experts, dtype, device, e_local=None):
        super().__init__()
        e_local = experts if e_local is None else e_local

        def param(shape, dt):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = param((dim, experts), torch.float32)
        self.we_gate = param((e_local, dim, mlp_dim), dtype)
        self.we_up = param((e_local, dim, mlp_dim), dtype)
        self.we_down = param((e_local, mlp_dim, dim), dtype)


def draw_moe_layer(layer, generator):
    """Fill ``layer`` with normal * fan_in**-0.5 draws (fan_in = dim -2)
    from ``generator``. The router is drawn in the experts' dtype and kept
    in fp32, as the JAX init rounds it."""
    dtype = layer.we_gate.dtype
    with torch.no_grad():
        for p in (layer.router, layer.we_gate, layer.we_up, layer.we_down):
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            p.copy_(x.mul_(p.shape[-2] ** -0.5).to(dtype))


def init_moe_layer(dim, mlp_dim, experts, dtype, generator, device="cuda"):
    """A MoELayer of ``experts`` experts with random weights."""
    layer = MoELayer(dim, mlp_dim, experts, dtype, device)
    draw_moe_layer(layer, generator)
    return layer


def route(xn, router):
    """Switch routing of the normed tokens xn (T, D): (probs (T, E) fp32,
    expert (T,)), each token's expert the most probable one."""
    probs = torch.softmax(xn.float() @ router, dim=-1)
    return probs, probs.argmax(dim=-1)  # ties: the first, as jnp.argmax


def _ffn(layer, xi):
    """The local experts' SwiGLU FFNs in fp32 on xi (E_l, N, D): one
    batched product a weight over the stacks cast to fp32 (the JAX package
    scans the experts, casting each one's weights; the values are the
    same). Indexing the stacks expert by expert instead would make
    autograd zero-fill and add a whole stack's gradient once an expert."""
    wg, wu, wd = (w.float() for w in (layer.we_gate, layer.we_up,
                                      layer.we_down))
    return (F.silu(xi.bmm(wg)) * xi.bmm(wu)).bmm(wd)


def moe_mlp(x, layer, norm_w, capacity, ep_group=False, return_aux=False):
    """Switch MoE block: x (B, S, D) -> x + MoE(RMSNorm(x)).

    ``layer``: a MoELayer (its experts sharded over ``ep_group`` when one
    is given; ``False`` means none). ``capacity``: the queue length per
    (expert, source process). ``return_aux=True`` also returns the raw
    statistics of the switch load-balancing loss over the local tokens,
    (count_e, probsum_e); the trainer sums them over the processes."""
    b, s, d = x.shape
    t = b * s
    xn = rmsnorm(x, norm_w).reshape(t, d).float()
    e = layer.router.shape[1]
    e_local = layer.we_gate.shape[0]
    ep = 1 if ep_group is False else ring_size(ep_group)
    if e_local * ep != e:
        raise ValueError(f"{e_local} local experts x {ep} processes != {e} "
                         f"experts")
    probs, expert = route(xn, layer.router)
    gate = probs.gather(1, expert[:, None])[:, 0]
    # a token's slot is its place in its expert's queue, in token order; it
    # is kept when the slot is under the capacity
    onehot = expert[:, None] == torch.arange(e, device=x.device)
    slot = (onehot.cumsum(0) - 1).gather(1, expert[:, None])[:, 0]
    # each token's row of the (E * C, D) buffer; a dropped token's is the
    # extra zero row E * C
    rows = torch.where(slot < capacity, expert * capacity + slot,
                       e * capacity)
    # dispatch: row r holds the token routed there, or the zero row t
    src = torch.full((e * capacity + 1,), t, dtype=torch.long,
                     device=x.device)
    src.scatter_(0, rows, torch.arange(t, device=x.device))
    padded = torch.cat([xn, xn.new_zeros(1, d)])
    expert_in = padded[src[:-1]].view(e, capacity, d)
    if ep_group is not False:
        # (E, C, D) -> this process's experts' queues from every source
        # process: (E_local, ep * C, D)
        expert_in = all_to_all(expert_in, 0, 1, ep_group)
    expert_out = _ffn(layer, expert_in)
    if ep_group is not False:
        expert_out = all_to_all(expert_out, 1, 0, ep_group)  # (E, C, D)
    # combine: each token takes gate * its row's output (zero if dropped)
    flat = torch.cat([expert_out.reshape(e * capacity, d),
                      expert_out.new_zeros(1, d)])
    y = gate[:, None] * flat[rows]
    out = x + y.reshape(b, s, d).to(x.dtype)
    if not return_aux:
        return out
    count = onehot.sum(0).float()  # no gradient path
    return out, (count, probs.sum(dim=0))
