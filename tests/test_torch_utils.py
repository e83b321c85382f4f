"""The port's utils (ring_flash_attn_tpu_torch/utils/) against the JAX
package's (ring_flash_attn_tpu/utils/) and its tests: the trace parsers on
synthetic Chrome traces (the four cases of tests/test_trace_timing.py),
``timed`` and ``fetch_barrier`` on the CPU, checkpoint and resume against
an uninterrupted run and against JAX's training run on the same weights
and batches (tests/test_checkpoint.py), ``log_tensor``'s line, and
``make_cp_mesh``'s layout against JAX's ``make_cp_mesh``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import init_params as jax_init
from ring_flash_attn_tpu.models import train_step as jax_train_step
from ring_flash_attn_tpu.utils.multihost import (
    make_cp_mesh as jax_make_cp_mesh)
from ring_flash_attn_tpu_torch.models import (ModelConfig, params_from_jax,
                                              shard_params, train_step)
from ring_flash_attn_tpu_torch.utils import (abstract_like,
                                             initialize_multihost, log_tensor,
                                             make_cp_mesh, restore_checkpoint,
                                             save_checkpoint, trace)
from ring_flash_attn_tpu_torch.utils import multihost
from ring_flash_attn_tpu_torch.utils.timing import fetch_barrier, timed
from ring_flash_attn_tpu_torch.utils.trace_timing import (
    parse_device_busy, parse_device_events, parse_device_time,
    trace_device_events, trace_device_time)

US = 1e-6  # event times below are in microseconds, as torch writes them


def _write_trace(path, events, name="trace.json"):
    """A Chrome trace as ``export_chrome_trace`` writes it: events (cat,
    name, ts, dur, stream) as complete ("X") events, plus a flow event
    that must be skipped."""
    trace = {"schemaVersion": 1, "traceEvents": [
        {"ph": "X", "cat": cat, "name": op, "pid": 0, "tid": stream,
         "ts": ts, "dur": dur, "args": {"device": 0, "stream": stream}}
        for cat, op, ts, dur, stream in events] + [
        {"ph": "s", "cat": "ac2g", "name": "launch", "id": 1, "pid": 0,
         "tid": 7, "ts": 0}]}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "w") as f:
        json.dump(trace, f)
    return path


def test_sum_vs_union_overlap(tmp_path):
    """The sum counts overlapping events twice, the union once: a kernel
    [0, 100), a copy on another stream [50, 150), a kernel [200, 250)."""
    d = _write_trace(str(tmp_path), [
        ("kernel", "gemm", 0, 100, 7),
        ("gpu_memcpy", "Memcpy HtoD", 50, 100, 13),
        ("kernel", "flash_fwd_kernel", 200, 50, 7)])
    comp, cop, by_name = parse_device_time(d)
    assert comp == pytest.approx(150 * US)
    assert cop == pytest.approx(100 * US)
    assert by_name["Memcpy HtoD"] == pytest.approx(100 * US)
    assert parse_device_busy(d) == pytest.approx(200 * US)  # [0,150) u ...


def test_copy_split_and_host_events_ignored(tmp_path):
    """Copies and fills are summed apart from the kernels; host events and
    the device-side user annotations are not device work."""
    d = _write_trace(str(tmp_path), [
        ("gpu_memcpy", "Memcpy DtoD", 0, 40, 7),
        ("gpu_memset", "Memset", 40, 10, 7),
        ("kernel", "bwd_kv_kernel", 60, 40, 7),
        ("cpu_op", "aten::mm", 0, 1000, 1),
        ("cuda_runtime", "cudaLaunchKernel", 0, 999, 1),
        ("gpu_user_annotation", "ProfilerStep#1", 0, 1000, 7)])
    comp, cop, by_name = parse_device_time(d)
    assert comp == pytest.approx(40 * US)
    assert cop == pytest.approx(50 * US)
    assert set(by_name) == {"Memcpy DtoD", "Memset", "bwd_kv_kernel"}
    assert parse_device_busy(d) == pytest.approx(90 * US)


def test_streams_and_files_merge(tmp_path):
    """Two streams' overlapping kernels merge into one interval; the
    events of every trace file under a directory count."""
    d = str(tmp_path)
    _write_trace(os.path.join(d, "a"), [("kernel", "k1", 0, 2000, 7)])
    _write_trace(os.path.join(d, "b"), [("kernel", "k2", 1000, 2000, 20)])
    assert parse_device_busy(d) == pytest.approx(3000 * US)
    comp, _, _ = parse_device_time(d)
    assert comp == pytest.approx(4000 * US)
    # one file on its own
    assert parse_device_busy(os.path.join(d, "a", "trace.json")) == \
        pytest.approx(2000 * US)


def test_no_trace_raises(tmp_path):
    with pytest.raises(RuntimeError):
        parse_device_time(str(tmp_path))
    with pytest.raises(RuntimeError):
        parse_device_busy(str(tmp_path))
    with pytest.raises(RuntimeError):
        parse_device_busy(str(tmp_path / "missing.json"))


def test_device_events_by_name_with_counts(tmp_path):
    """``parse_device_events``: every device event (kernels, copies, fills)
    summed by name with its count, the largest first; host events and
    annotations are not counted."""
    d = _write_trace(str(tmp_path), [
        ("kernel", "gemm", 0, 100, 7),
        ("kernel", "gemm", 150, 30, 7),
        ("gpu_memset", "Memset", 100, 10, 13),
        ("kernel", "flash_fwd_kernel", 200, 50, 20),
        ("cpu_op", "aten::mm", 0, 1000, 1),
        ("gpu_user_annotation", "ProfilerStep#1", 0, 1000, 7)])
    table = parse_device_events(d)
    assert [(name, n) for _, name, n in table] == [
        ("gemm", 2), ("flash_fwd_kernel", 1), ("Memset", 1)]
    assert [t for t, _, _ in table] == pytest.approx(
        [130 * US, 50 * US, 10 * US])
    # the same events as parse_device_time's sum
    assert sum(t for t, _, _ in table) == pytest.approx(
        sum(parse_device_time(d)[:2]))
    with pytest.raises(RuntimeError):
        parse_device_events(str(tmp_path / "missing"))


def test_device_timing_refuses_the_cpu():
    """A run on the CPU has no device time: the tracing functions raise
    rather than return a host time under a device name."""
    with pytest.raises(ValueError):
        trace_device_time(lambda x: x + 1, torch.zeros(4))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            trace_device_events(lambda: torch.zeros(4) + 1)


def test_trace_writes_a_parsable_trace(tmp_path):
    """``debug.trace`` exports a Chrome trace the parsers read; on the CPU
    it holds no device event."""
    with trace(str(tmp_path)) as path:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert path == str(tmp_path)
    assert any(f.endswith(".json") for f in os.listdir(path))
    comp, cop, _ = parse_device_time(path)
    if not torch.cuda.is_available():
        assert comp == cop == 0.0


def test_timed_and_fetch_barrier_on_cpu():
    """``timed`` gives the per-call slope of a feedback chain on the host
    clock, never writing x0; ``fetch_barrier`` returns its argument and
    takes nested containers."""
    x0 = torch.ones(128, 128)
    calls = []

    def step(x):
        calls.append(1)
        return (x @ x) / 128.0

    t = timed(step, x0, n=5, n0=2)
    assert 1e-9 <= t < 1.0
    assert len(calls) == 1 + 2 + 7  # warm-up, then chains of n0, n0 + n
    assert torch.equal(x0, torch.ones(128, 128))
    nested = {"a": [x0]}
    assert fetch_barrier(nested) is nested
    with pytest.raises(TypeError):
        fetch_barrier([1, 2])


CKPT = dict(vocab=64, dim=32, layers=1, heads=2, kv_heads=1, head_dim=16,
            mlp_dim=64, attention="zigzag", dtype="float32")


def _batch(i, s=32):
    """tests/test_checkpoint.py's batch of step i."""
    tokens = jax.random.randint(jax.random.PRNGKey(100 + i), (1, s + 1), 0,
                                CKPT["vocab"], jnp.int32)
    return tuple(np.asarray(x) for x in (tokens[:, :-1], tokens[:, 1:],
                                         jnp.arange(s, dtype=jnp.int32)))


def _port_run(model, steps, start=0):
    losses = []
    for i in range(start, start + steps):
        t, l, pos = (torch.from_numpy(np.array(x)).long() for x in _batch(i))
        _, loss = train_step(model, t, l, pos, lr=1e-2)
        losses.append(float(loss))
    return losses


def test_checkpoint_resume_matches_jax(tmp_path):
    """2 steps, save, restore into a fresh model, 2 more: the four losses
    equal the uninterrupted run's bit for bit and JAX's run of
    tests/test_checkpoint.py on the same weights and batches to 1e-5; the
    restored tensors equal the saved ones, the step and metadata
    survive."""
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**CKPT))
    jax_losses, p = [], jparams
    for i in range(4):
        p, loss = jax_train_step(p, JaxConfig(**CKPT), *map(jnp.asarray,
                                                            _batch(i)),
                                 lr=1e-2)
        jax_losses.append(float(loss))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = ModelConfig(**CKPT)
    full = _port_run(params_from_jax(np_params, cfg, device="cpu"), 4)

    model = params_from_jax(np_params, cfg, device="cpu")
    first = _port_run(model, 2)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, model.state_dict(), step=2,
                    metadata={"note": "mid", "seed": 42})
    like = abstract_like(model)
    assert all(t.device.type == "meta" for t in like.values())
    state, step, meta = restore_checkpoint(path, like=like, device="cpu")
    assert step == 2 and meta == {"note": "mid", "seed": 42}
    for name, t in model.state_dict().items():
        assert torch.equal(state[name], t), name
    fresh = params_from_jax(np_params, cfg, device="cpu")  # other weights
    _port_run(fresh, 1)
    fresh.load_state_dict(state)
    second = _port_run(fresh, 2, start=2)
    assert first + second == full  # bit for bit
    np.testing.assert_allclose(full, jax_losses, rtol=0, atol=1e-5)


def test_checkpoint_like_overwrite_and_nesting(tmp_path):
    """A restore against the wrong shapes, dtypes or keys raises; a save
    overwrites; nested dicts and lists keep their structure."""
    path = str(tmp_path / "ckpt")
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "opt": {"m": [torch.zeros(3), torch.ones(2, dtype=torch.int64)]}}
    save_checkpoint(path, state, step=1)
    got, step, meta = restore_checkpoint(path, like=abstract_like(state),
                                         device="cpu")
    assert step == 1 and meta == {}
    assert torch.equal(got["opt"]["m"][1], state["opt"]["m"][1])
    assert isinstance(got["opt"]["m"], list)
    for bad in ({"w": torch.zeros(3, 2), "opt": state["opt"]},
                {"w": state["w"].double(), "opt": state["opt"]},
                {"w": state["w"]}):
        with pytest.raises(ValueError):
            restore_checkpoint(path, like=abstract_like(bad), device="cpu")
    save_checkpoint(path, {"w": state["w"] * 2}, step=5, metadata={"a": 1})
    got, step, meta = restore_checkpoint(path, device="cpu")
    assert step == 5 and meta == {"a": 1} and set(got) == {"w"}
    assert torch.equal(got["w"], state["w"] * 2)
    with pytest.raises(TypeError):
        save_checkpoint(path, {"w": 1.0}, step=0)


def test_checkpoint_tp_restore_is_the_shard(tmp_path):
    """A tensor-parallel rank restores the whole parameters and cuts its
    shard with ``shard_params``: rank 1 of 2 equals the shard of the
    whole model."""
    cfg = ModelConfig(**dict(CKPT, heads=4, kv_heads=2))
    np_params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3),
                                                  JaxConfig(**dict(
                                                      CKPT, heads=4,
                                                      kv_heads=2))))
    whole = params_from_jax(np_params, cfg, device="cpu")
    save_checkpoint(str(tmp_path), whole.state_dict(), step=9)
    state, step, _ = restore_checkpoint(str(tmp_path), device="cpu")
    got = shard_params(state, cfg, tp_rank=1, tp=2, device="cpu")
    ref = shard_params(whole, cfg, tp_rank=1, tp=2, device="cpu")
    assert step == 9
    for (n, a), (_, b) in zip(got.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(a, b), n
    assert got.layers[0].wq.shape[1] == cfg.heads * cfg.head_dim // 2


def test_log_tensor_line(capsys):
    """JAX's line: rank-prefixed max and mean of a, or of |a - b|."""
    a = torch.tensor([1.0, 2.0, 3.0])
    log_tensor("out", a)
    log_tensor("diff", a, torch.tensor([1.0, 1.0, 1.0]), process=3)
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["[0] out: max 3.000e+00 mean 2.000e+00",
                     "[3] diff: max 2.000e+00 mean 1.000e+00"]


@pytest.mark.parametrize("dp,sp", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_make_cp_mesh_layout_matches_jax(devices8, monkeypatch, dp, sp):
    """Each rank of 8 gets as its sp group the ranks of its row of JAX's
    ``make_cp_mesh(dp, sp)`` (devices.reshape(dp, sp), sp fastest) and as
    its dp group those of its column; every rank creates every group in
    the same order."""
    mesh = jax_make_cp_mesh(dp, sp)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    ids = ids - ids.min()
    for rank in range(8):
        made = []
        monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 8)
        monkeypatch.setattr(multihost.dist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(multihost.dist, "new_group",
                            lambda ranks: made.append(tuple(ranks)) or
                            tuple(ranks))
        dp_group, sp_group = make_cp_mesh(dp, sp)
        row, col = np.argwhere(ids == rank)[0]
        assert sp_group == tuple(ids[row].tolist())
        assert dp_group == tuple(ids[:, col].tolist())
        assert (rank // sp, rank % sp) == (row, col)
        assert len(made) == dp + sp
    monkeypatch.undo()
    with pytest.raises(ValueError):
        make_cp_mesh(dp=3, sp=1)  # one process here


def test_initialize_multihost_joins_or_does_nothing(monkeypatch):
    """No environment and one process: nothing to join. A group of one
    over tcp on the CPU joins with gloo, a second call is a no-op, and
    make_cp_mesh then cuts groups of it; an incomplete request raises
    (no failure is swallowed)."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    assert initialize_multihost(device="cpu") is False
    assert make_cp_mesh() == (None, None)
    with pytest.raises(ValueError):
        initialize_multihost(world_size=2, device="cpu")  # no init_method
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        assert initialize_multihost(init_method=f"tcp://localhost:{port}",
                                    world_size=1, rank=0, device="cpu")
        assert dist.get_backend() == "gloo"
        assert initialize_multihost(device="cpu") is False
        dp_group, sp_group = make_cp_mesh()
        x = torch.ones(3)
        dist.all_reduce(x, group=sp_group)
        assert torch.equal(x, torch.ones(3))
        assert dist.get_world_size(dp_group) == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
