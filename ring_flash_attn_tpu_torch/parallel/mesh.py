"""Process-group helpers: the ring and the collectives of the port.

The port of ``ring_flash_attn_tpu/parallel/mesh.py``. JAX's named mesh
axis becomes a ``torch.distributed`` process group, one process per
device, and the functions are per-process as the JAX ones are per-shard.
``group=None`` means the default group when ``torch.distributed`` is
initialised; when it is not, the world is one process: size 1, rank 0, and
every collective is the identity. That is how a single card runs the
sequence-parallel paths.

The ring is a batched isend/irecv pair to rank +- 1
(``batch_isend_irecv``), as in the reference's ``RingComm``.
"""

import torch
import torch.distributed as dist


def _initialised():
    return dist.is_available() and dist.is_initialized()


def ring_size(group=None):
    return dist.get_world_size(group) if _initialised() else 1


def ring_rank(group=None):
    return dist.get_rank(group) if _initialised() else 0


def _global_rank(group, rank):
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_rotate(x, group=None, reverse=False):
    """Rotate x one step around the ring: rank i's value moves to rank
    i + 1 (``reverse=True``: to i - 1). Returns the received tensor."""
    n = ring_size(group)
    if n == 1:
        return x
    rank = ring_rank(group)
    step = -1 if reverse else 1
    dst = _global_rank(group, (rank + step) % n)
    src = _global_rank(group, (rank - step) % n)
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def all_reduce(x, op="sum", group=None):
    """A new tensor holding the reduction of x over the group ("sum" or
    "max"); x itself at world size 1."""
    if ring_size(group) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def all_gather(x, dim, group=None):
    """The ranks' x concatenated along ``dim`` in rank order (JAX's tiled
    all_gather); x itself at world size 1."""
    n = ring_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _PsumExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_exact(x, group=None):
    """Sum over the group whose backward is the identity.

    The summed value is consumed as a replicated quantity, so its true
    per-process cotangent is the replicated output cotangent, not another
    sum over the group (megatron's "g" operator)."""
    return _PsumExact.apply(x, group)
