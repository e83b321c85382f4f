"""Process-group helpers: the ring and the collectives of the port.

The port of ``ring_flash_attn_tpu/parallel/mesh.py``. JAX's named mesh
axis becomes a ``torch.distributed`` process group, one process per
device, and the functions are per-process as the JAX ones are per-shard.
``group=None`` means the default group when ``torch.distributed`` is
initialised; when it is not, the world is one process: size 1, rank 0, and
every collective is the identity. That is how a single card runs the
sequence-parallel paths.

The ring is a batched isend/irecv pair to rank +- 1
(``batch_isend_irecv``), as in the reference's ``RingComm``: blocking
(``ring_rotate``) or posted and waited for later (``ring_rotate_start``),
so that the next step's KV travels while this step's kernel runs. The step
loops of ring, zigzag and fused ring all move their tensors through
``RingBuffer``: two buffers that take turns at sending and receiving.
Ulysses moves its activations with ``all_to_all`` instead. llama3 posts
its head chunks' gathers and reduce-scatters the same way
(``all_gather_start``, ``reduce_scatter_start``), as XLA schedules the JAX
module's ``all_gather`` and ``psum_scatter`` asynchronously.
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


class Posted:
    """A posted collective (a ring rotation, a gather, a reduce-scatter):
    ``wait()`` returns its result.

    Between the post and ``wait`` the tensors sent must not be written and
    the buffers received into must not be touched; kernels launched in
    between run while the collective does (the reference's
    ``commit()``/``wait()``). On NCCL the collective runs on the backend's
    own stream, ordered after the work already on the current stream, and
    ``wait`` orders the current stream after it; on gloo ``wait`` blocks
    the host. ``finish`` makes the result out of what was received (a
    gather's concatenation) at the first ``wait``; ``held`` are the
    tensors sent, kept alive until then."""

    def __init__(self, received, requests=(), finish=None, held=()):
        self._received = received
        self._requests = requests
        self._finish = finish
        self._held = held

    def wait(self):
        for req in self._requests:
            req.wait()
        self._requests = self._held = ()
        if self._finish is not None:
            self._received, self._finish = self._finish(self._received), None
        return self._received


def ring_rotate_start(x, group=None, reverse=False, out=None):
    """Post the rotation of x one step around the ring (rank i's value
    moves to rank i + 1; ``reverse=True``: to i - 1) and return its
    ``Posted``. ``out``, when given, is the contiguous buffer the
    message lands in (so that a loop can alternate between two buffers).
    At world size 1 nothing is posted and ``wait()`` returns x."""
    n = ring_size(group)
    if n == 1:
        return Posted(x)
    rank = ring_rank(group)
    step = -1 if reverse else 1
    dst = _global_rank(group, (rank + step) % n)
    src = _global_rank(group, (rank - step) % n)
    x = x.contiguous()
    recv = torch.empty_like(x) if out is None else out
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    return Posted(recv, dist.batch_isend_irecv(ops))


def ring_rotate(x, group=None, reverse=False):
    """Rotate x one step around the ring: rank i's value moves to rank
    i + 1 (``reverse=True``: to i - 1). Returns the received tensor."""
    return ring_rotate_start(x, group, reverse).wait()


class RingBuffer:
    """A tensor that travels the ring through two buffers, the way every
    step loop of the port moves its KV and its dk/dv accumulator.

    ``value`` is the resident tensor. ``start()`` posts its rotation into
    the spare buffer (allocated at the first call); ``wait()`` makes what
    arrived the resident value and the buffer it left the spare, which the
    next ``start()`` receives into. Between the two, ``value`` may be read
    (by this step's kernels) and not written. At world size 1 nothing is
    posted and nothing is allocated, and ``value`` may be any object."""

    def __init__(self, value, group=None):
        self._group = group
        self._moves = ring_size(group) > 1
        self.value = value.contiguous() if self._moves else value
        self._spare = self._posted = None

    def start(self):
        if self._moves:
            if self._spare is None:
                self._spare = torch.empty_like(self.value)
            self._posted = ring_rotate_start(self.value, self._group,
                                             out=self._spare)

    def wait(self):
        if self._posted is not None:
            self.value, self._spare = self._posted.wait(), self.value
            self._posted = None

    def rotate(self):
        self.start()
        self.wait()


def all_reduce(x, op="sum", group=None):
    """A new tensor holding the reduction of x over the group ("sum" or
    "max"); x itself at world size 1."""
    if ring_size(group) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def all_gather_start(x, dim, group=None):
    """Post ``all_gather(x, dim, group)`` and return its ``Posted``; at
    world size 1 nothing is posted and ``wait()`` returns x."""
    n = ring_size(group)
    if n == 1:
        return Posted(x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    req = dist.all_gather(parts, x, group=group, async_op=True)
    return Posted(parts, (req,), lambda p: torch.cat(p, dim=dim), (x,))


def all_gather(x, dim, group=None):
    """The ranks' x concatenated along ``dim`` in rank order (JAX's tiled
    all_gather); x itself at world size 1."""
    return all_gather_start(x, dim, group).wait()


def reduce_scatter_start(x, dim, group=None):
    """Post ``reduce_scatter(x, dim, group)`` and return its ``Posted``; at
    world size 1 nothing is posted and ``wait()`` returns x."""
    n = ring_size(group)
    if n == 1:
        return Posted(x)
    dim %= x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into "
                         f"{n} equal chunks")
    parts = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    req = dist.reduce_scatter(out, parts, group=group, async_op=True)
    return Posted(out, (req,), held=parts)


def reduce_scatter(x, dim, group=None):
    """JAX's tiled ``psum_scatter``: x summed over the group, of which rank
    r keeps the r-th of W equal chunks along ``dim``; x itself at world
    size 1."""
    return reduce_scatter_start(x, dim, group).wait()


def _all_to_all(x, split_dim, concat_dim, group):
    n = ring_size(group)
    split_dim %= x.ndim
    concat_dim %= x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal chunks")
    # chunk j (to rank j) on dim 0 of a contiguous tensor, as
    # all_to_all_single splits and fills it
    send = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[i] came from rank i: rank order along concat_dim
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim, group = ctx.args
        # the inverse all-to-all sends every chunk's gradient home
        return _all_to_all(grad, concat_dim, split_dim, group), None, None, \
            None


def all_to_all(x, split_dim, concat_dim, group=None):
    """JAX's tiled ``all_to_all``: x splits into W equal chunks along
    ``split_dim``, chunk j goes to rank j, and the chunks received are
    concatenated along ``concat_dim`` in rank order. Differentiable (the
    backward is the inverse all-to-all); x itself at world size 1."""
    if ring_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


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
