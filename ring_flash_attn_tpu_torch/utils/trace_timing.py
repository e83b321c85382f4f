"""Device time from ``torch.profiler`` traces.

The port of ``ring_flash_attn_tpu/utils/trace_timing.py``: the same four
functions with the same meaning, reading the Chrome-trace JSON that
``torch.profiler``'s ``export_chrome_trace`` writes (a file, or a directory
searched for ``*.json`` files) instead of XLA's xplane protobufs, with
``json`` alone.

Device events are the trace's ``"ph": "X"`` events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``, on every stream and device,
with ``ts`` and ``dur`` in microseconds; host events (``cpu_op``,
``cuda_runtime``, ``python_function``, ...) and the device-side user
annotations (``gpu_user_annotation``, which span kernels already counted)
are ignored. Copies and fills (``gpu_memcpy``, ``gpu_memset``) are summed
apart from the kernels, as the JAX parser sums ``copy-start`` /
``copy-done`` apart: a program's own copies are reported, never dropped,
but they are not its compute. ``parse_device_busy`` merges every device
event into a union of intervals per device, so that kernels and copies
that overlap on several streams count once.

``trace_device_time`` and ``trace_device_busy`` run a feedback chain
under the profiler on the card, after a warm-up call and a warm-up cycle
of the profiler (tracing starts late and misses the first kernels after
it is switched on); a chain on a CPU tensor has no device to time and
raises. ``parse_device_events`` and ``trace_device_events``, which the
JAX module has not, give a trace's device events by name with their
counts, largest first: the breakdown of one call of a function.
"""

import glob
import json
import os
import shutil
import tempfile
from collections import defaultdict


__all__ = [
    "parse_device_time",
    "trace_device_time",
    "parse_device_busy",
    "trace_device_busy",
    "parse_device_events",
    "trace_device_events",
]

KERNEL_CATS = ("kernel",)
COPY_CATS = ("gpu_memcpy", "gpu_memset")


def _trace_files(path):
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                 recursive=True))
        if not files:
            raise RuntimeError(f"no Chrome trace (*.json) under {path}")
        return files
    if not os.path.exists(path):
        raise RuntimeError(f"no Chrome trace at {path}")
    return [path]


def _device_events(path):
    """(category, name, device, start us, end us) of every device event of
    the trace(s) at ``path``."""
    for file in _trace_files(path):
        with open(file) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        for ev in events:
            cat = ev.get("cat")
            if ev.get("ph") != "X" or cat not in KERNEL_CATS + COPY_CATS:
                continue
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            device = (ev.get("args") or {}).get("device", ev.get("pid"))
            yield cat, ev.get("name", "?"), device, ts, ts + dur


def parse_device_time(path):
    """Sum the device events' durations in the trace(s) at ``path``.

    Returns (compute_seconds, copy_seconds, {event name: seconds}): kernels
    in the first, copies and fills (``gpu_memcpy``, ``gpu_memset``) in the
    second, every device event by name in the dict. Host events are
    ignored. Raises RuntimeError where there is no trace."""
    compute_us = copy_us = 0.0
    by_name = defaultdict(float)
    for cat, name, _, start, end in _device_events(path):
        if cat in COPY_CATS:
            copy_us += end - start
        else:
            compute_us += end - start
        by_name[name] += end - start
    return (compute_us * 1e-6, copy_us * 1e-6,
            {k: v * 1e-6 for k, v in by_name.items()})


def parse_device_busy(path):
    """The device's busy seconds in the trace(s) at ``path``: the union of
    every device event's interval (kernels, copies and fills, on every
    stream), summed over the devices. ``parse_device_time`` sums the
    events, which counts twice the time that two streams overlap; this is
    the time the device had work."""
    per_device = defaultdict(list)
    for _, _, device, start, end in _device_events(path):
        per_device[device].append((start, end))
    busy_us = 0.0
    for intervals in per_device.values():
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
    return busy_us * 1e-6


def parse_device_events(path):
    """[(seconds, event name, count)] of the device events (kernels,
    copies and fills) in the trace(s) at ``path``, summed by name, the
    largest first. Host events are ignored. Raises RuntimeError where
    there is no trace."""
    table = defaultdict(lambda: [0.0, 0])
    for _, name, _, start, end in _device_events(path):
        table[name][0] += end - start
        table[name][1] += 1
    return sorted(((us * 1e-6, name, n) for name, (us, n) in table.items()),
                  reverse=True)


def _profiled(cycle):
    """Run ``cycle()`` twice under the profiler, a warm-up cycle and the
    recorded one, and write the recorded cycle's Chrome trace into a new
    temporary directory; returns the directory. ``cycle`` ends with its
    work done on the device."""
    from torch.profiler import ProfilerActivity, profile, schedule

    logdir = tempfile.mkdtemp(prefix="devtrace_")

    def export(prof):
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=export) as prof:
            for _ in range(2):
                cycle()
                prof.step()
    except BaseException:
        shutil.rmtree(logdir, ignore_errors=True)
        raise
    return logdir


def _traced(fn, feedback, n_iters):
    """Run the feedback chain ``x = fn(x)`` ``n_iters`` times under the
    profiler (after a warm-up call and a warm-up cycle of as many calls)
    and write its Chrome trace into a new temporary directory; returns the
    directory."""
    from .timing import _first_tensor, fetch_barrier

    t = _first_tensor(feedback)
    if t is None or not t.is_cuda:
        raise ValueError("device timing needs a CUDA tensor to feed the "
                         "chain: a CPU run has no device time")
    x = fn(feedback)
    fetch_barrier(x)

    def cycle():
        nonlocal x
        for _ in range(n_iters):
            x = fn(x)
        fetch_barrier(x)

    return _profiled(cycle)


def trace_device_time(fn, feedback, n_iters=8):
    """Per-iteration device compute seconds of ``fn`` (feedback-chained).

    ``fn`` returns a value shaped like ``feedback``, fed back each
    iteration; the traced chain continues from the warm-up call's output,
    so ``fn`` may consume its argument. Returns (per_iter_compute_s,
    {event name: per_iter_s})."""
    logdir = _traced(fn, feedback, n_iters)
    try:
        dev_s, _copy_s, by_name = parse_device_time(logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return dev_s / n_iters, {k: v / n_iters for k, v in by_name.items()}


def trace_device_busy(fn, feedback, n_iters=8):
    """Per-iteration device busy seconds of ``fn`` (the union of its
    device events' intervals, ``parse_device_busy``), with the same
    feedback-chain protocol as ``trace_device_time``. Returns
    (per_iter_busy_s, {event name: per_iter_s})."""
    logdir = _traced(fn, feedback, n_iters)
    try:
        busy = parse_device_busy(logdir)
        _, _, by_name = parse_device_time(logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return busy / n_iters, {k: v / n_iters for k, v in by_name.items()}


def trace_device_events(fn):
    """``parse_device_events`` of one call ``fn()`` on the card: the call
    runs under the profiler twice, a warm-up cycle and the recorded one,
    each followed by ``torch.cuda.synchronize()``. [(seconds, event name,
    count)], the largest first."""
    import torch

    if not torch.cuda.is_available():
        raise ValueError("device timing needs a card: a CPU run has no "
                         "device time")

    def cycle():
        fn()
        torch.cuda.synchronize()

    logdir = _profiled(cycle)
    try:
        return parse_device_events(logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
