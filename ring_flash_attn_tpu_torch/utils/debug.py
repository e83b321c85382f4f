"""Observability helpers: rank-prefixed tensor statistics and a profiler
trace.

The port of ``ring_flash_attn_tpu/utils/debug.py`` (the reference's
``test/utils.py`` log and its benchmarks' ``torch.profiler``
integration). ``trace`` writes the Chrome trace that
``utils.trace_timing`` reads.
"""

import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

__all__ = ["log_tensor", "trace"]


def log_tensor(msg, a, b=None, process=None):
    """Print the max and mean of ``a`` (or of |a - b| in fp32), prefixed
    by the process's rank in the default group (0 without one), or by
    ``process``: the reference's rank-ordered diff logging."""
    x = a if b is None else (a.float() - b.float()).abs()
    if process is None:
        process = dist.get_rank() if dist.is_initialized() else 0
    print(f"[{process}] {msg}: max {float(x.max()):.3e} "
          f"mean {float(x.float().mean()):.3e}")


@contextlib.contextmanager
def trace(path=None):
    """A ``torch.profiler`` context over the CPU and, where there is a
    card, CUDA activity; on exit it writes a Chrome trace
    ``trace_<pid>_<ns>.json`` into the directory ``path`` (made if need
    be; by default ``rfa_trace`` in the temporary directory), which
    ``utils.trace_timing.parse_device_time`` reads. Yields ``path``."""
    from torch.profiler import ProfilerActivity, profile

    path = path or os.path.join(tempfile.gettempdir(), "rfa_trace")
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        path, f"trace_{os.getpid()}_{time.time_ns()}.json"))
