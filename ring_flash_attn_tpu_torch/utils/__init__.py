"""Utilities of the port: timing on the card, device time from profiler
traces, checkpoints, joining processes and observability.

The port of ``ring_flash_attn_tpu/utils/``; the package exports the same
names as the JAX one (``timing`` and ``trace_timing`` are imported as
modules, as there).
"""

from .debug import log_tensor, trace
from .multihost import initialize_multihost, make_cp_mesh
from .checkpoint import abstract_like, restore_checkpoint, save_checkpoint

__all__ = [
    "log_tensor",
    "trace",
    "initialize_multihost",
    "make_cp_mesh",
    "save_checkpoint",
    "restore_checkpoint",
    "abstract_like",
]
