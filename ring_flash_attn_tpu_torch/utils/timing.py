"""Per-call timing of a feedback chain on the card or the CPU.

The port of ``ring_flash_attn_tpu/utils/timing.py``. ``timed`` keeps its
contract: ``step`` is called in a chain, each call fed the previous call's
result, twice, ``n0`` and ``n0 + n`` calls long, and the per-call time is
the slope between the two chains, ``(t2 - t1) / n``, so that what a chain
pays once (the warm-up of the first call, the barrier at its end) cancels
out.

PyTorch queues work on the card and returns before it is done, so a host
clock around the chain would time the queueing. On a CUDA tensor the
chains are timed with CUDA events recorded on the current stream around
them, and ``fetch_barrier`` is ``torch.cuda.synchronize()`` on the
tensor's device; on a CPU tensor the chains run on ``time.perf_counter``
and the barrier has nothing to wait for. Feeding each result back keeps
every call's work on the chain's path, so no call can be skipped or
overlap with the next beyond what the stream allows.
"""

import contextlib
import time

import torch

__all__ = ["timed", "fetch_barrier"]


def _first_tensor(x):
    """The first tensor of ``x``: a tensor, or a (nested) list, tuple or
    dict of them."""
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def fetch_barrier(x):
    """Wait until the work feeding ``x`` is done: on a CUDA tensor
    ``torch.cuda.synchronize()`` on its device (every stream's work), on
    a CPU tensor nothing (its work is done when it returns). ``x`` is a
    tensor or a nested list, tuple or dict holding one. Returns ``x``."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"fetch_barrier needs a tensor, got {type(x)}")
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return x


def _chain(step, x0, m, cuda):
    x = x0
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(m):
            x = step(x)
        fetch_barrier(x)
        return time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(m):
        x = step(x)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 1e3


def timed(step, x0, n=20, n0=3):
    """Per-call seconds of ``step`` by the two-point feedback-chain slope.

    ``step`` returns something shaped like its input, which is fed back
    each call; ``x0`` is never written. On a CUDA ``x0`` the chains run
    between CUDA events on the current stream of ``x0``'s device (each
    chain's end synchronises), on a CPU ``x0`` on the host clock. One call
    runs first as the warm-up. Returns at least 1e-9."""
    t = _first_tensor(x0)
    if t is None:
        raise TypeError(f"timed needs a tensor input, got {type(x0)}")
    cuda = t.is_cuda
    with torch.cuda.device(t.device) if cuda else contextlib.nullcontext():
        fetch_barrier(step(x0))
        t1 = _chain(step, x0, n0, cuda)
        t2 = _chain(step, x0, n0 + n, cuda)
    return max((t2 - t1) / n, 1e-9)

