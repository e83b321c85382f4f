"""Worker side of the port's distributed CPU tests: torch.distributed over
gloo, one spawned process per rank. It imports torch, numpy and the port
only (no JAX), so that a spawned worker starts quickly.

``run_ranks(task, world, payload)`` starts ``world`` processes, each of
which joins a gloo group on a free localhost port, runs ``TASKS[task]``
with (rank, world, payload) and sends back a dict of numpy arrays. Every
wait has a time limit and a worker past it is killed, so a hang fails the
test in seconds.
"""

import contextlib
import importlib
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ring_flash_attn_tpu_torch import api
from ring_flash_attn_tpu_torch.models import (
    ModelConfig, decode_step, generate, params_from_jax, prefill, train_step)
from ring_flash_attn_tpu_torch.ops.quant import (
    as_bytes, make_cache, quantized_kv_from_jax)
from ring_flash_attn_tpu_torch.parallel import (
    fused_ring_attention, layouts, llama3_attention, merge_across_axis,
    psum_exact, ring_attention, ring_rank, ring_rotate, ring_rotate_start,
    ring_size, sharded_cache_update, sharded_quant_decode,
    zigzag_ring_attention)
from ring_flash_attn_tpu_torch.parallel.mesh import (
    RingBuffer, all_gather, all_reduce)

START_TIMEOUT = 120  # seconds for all ranks to import torch and report
JOIN_TIMEOUT = 20


def _np(x):
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        x = as_bytes(x)
    return x.detach().cpu().numpy().copy()  # caches change in place later


def _shard(a, rank, world, axis):
    n = a.shape[axis] // world
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


def task_collectives(rank, world, p):
    """ring_rotate both ways, all_gather, all_reduce, psum_exact with its
    identity backward, merge_across_axis."""
    x = torch.from_numpy(p["x"][rank])
    out = {
        "size": np.array(ring_size()), "rank": np.array(ring_rank()),
        "rotate": _np(ring_rotate(x)),
        "rotate_rev": _np(ring_rotate(x, reverse=True)),
        "rotate_view": _np(ring_rotate(x.t()).t()),  # non-contiguous input
        "gather": _np(all_gather(x, 1)),
        "sum": _np(all_reduce(x, "sum")), "max": _np(all_reduce(x, "max")),
    }
    # two rotations posted before either is waited for, into given buffers
    buf = torch.empty_like(x)
    first = ring_rotate_start(x, out=buf)
    second = ring_rotate_start(x * 2.0, reverse=True)
    out["posted"], out["posted_rev"] = _np(first.wait()), _np(second.wait())
    assert first.wait() is (buf if world > 1 else x)  # W=1: nothing posted
    # the step loops' two-buffer circle: every rank adds to what it holds
    # and passes it on; after W hops each value is home with all W additions
    travelling = RingBuffer(x.clone())
    buffers = set()
    for step in range(world):
        travelling.start()
        held = travelling.value.clone()  # read while the message travels
        travelling.wait()
        if step == 0:
            out["buffer_hop"] = _np(travelling.value)
        assert world == 1 or not torch.equal(held, travelling.value)
        travelling.value.add_(rank + 1.0)
        buffers.add(travelling.value.data_ptr())
    out["buffer_home"] = _np(travelling.value)
    assert len(buffers) == min(world, 2)
    leaf = x.clone().requires_grad_()
    y = psum_exact(leaf * (rank + 1.0))
    (y * torch.from_numpy(p["ct"])).sum().backward()
    out["psum"], out["psum_grad"] = _np(y), _np(leaf.grad)
    assert torch.equal(x, torch.from_numpy(p["x"][rank]))  # inputs untouched
    mo, ml = merge_across_axis(torch.from_numpy(p["m_out"][rank]),
                               torch.from_numpy(p["m_lse"][rank]))
    out["merge_out"], out["merge_lse"] = _np(mo), _np(ml)
    return out


def _cache_shard(p, rank, world):
    return quantized_kv_from_jax(
        *(_shard(p[n], rank, world, 2)
          for n in ("k_q", "k_scale", "v_q", "v_scale")),
        qdtype=p["qdtype"], device="cpu")


def task_decode(rank, world, p):
    """sharded_quant_decode at several global lengths, then
    sharded_cache_update at several global positions."""
    cache = _cache_shard(p, rank, world)
    q = torch.from_numpy(p["q"])
    out = {}
    for n in p["lengths"]:
        o, l = sharded_quant_decode(q, cache, n, p["scale"],
                                    softcap=p["softcap"])
        out[f"out{n}"], out[f"lse{n}"] = _np(o), _np(l)
    for i, (index, k_new, v_new) in enumerate(p["updates"]):
        same = sharded_cache_update(cache, torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), index)
        assert same is cache
        for name, x in zip(cache._fields, cache):
            out[f"upd{i}_{name}"] = _np(x)
    return out


def task_llama3(rank, world, p):
    q, k, v = (torch.from_numpy(_shard(p[n], rank, world, 2))
               for n in ("q", "k", "v"))
    out = {}
    for name, kw in p["variants"].items():
        o, lse = llama3_attention(q, k, v, scale=p["scale"], **kw)
        out[f"out_{name}"], out[f"lse_{name}"] = _np(o), _np(lse)
    return out


def task_generate(rank, world, p):
    """prefill logits, every decode step's logits with the given tokens fed
    in (so that both packages see the same inputs at every step), and the
    free-running generate."""
    cfg = ModelConfig(**p["cfg"])
    model = params_from_jax(p["params"], cfg, device="cpu")
    prompt = torch.from_numpy(_shard(p["prompt"], rank, world, 1))
    steps = p["steps"]
    s_total = p["prompt"].shape[1]
    logits, caches = prefill(model, prompt)
    out = {"prefill": _np(logits)}
    tails = [make_cache(prompt.shape[0], cfg.kv_heads, steps, cfg.head_dim,
                        device="cpu") for _ in model.layers]
    fed = torch.from_numpy(p["feed"])  # (B, steps)
    step_logits = []
    for step in range(steps):
        lg, tails = decode_step(model, fed[:, step], s_total + step, step,
                                caches, tails)
        step_logits.append(_np(lg))
    out["steps"] = np.stack(step_logits, axis=1)
    out["tokens"] = _np(generate(model, prompt, steps))
    return out


def _local(a, rank, world, layout, axis):
    """Rank's shard of the global numpy array in the schedule's layout."""
    extract = (layouts.extract_local_zigzag if layout == "zigzag"
               else layouts.extract_local_contiguous)
    return extract(torch.from_numpy(a), rank, world, axis).contiguous()


_SCHEDULES = {"ring": (ring_attention, "contiguous"),
              "zigzag": (zigzag_ring_attention, "zigzag"),
              "fused_ring": (fused_ring_attention, "contiguous")}


def task_schedules(rank, world, p):
    """Each variant's (out, lse) and gradients on this rank's shards of the
    global (B, H, S, D) inputs."""
    out = {}
    for name, (kind, dtype, kw) in p["variants"].items():
        fn, layout = _SCHEDULES[kind]
        q, k, v, dout = (
            _local(p[n], rank, world, layout, 2).to(getattr(torch, dtype))
            for n in ("q", "k", "v", "dout"))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        o, lse = fn(*leaves, scale=p["scale"], **kw)
        assert o.dtype == q.dtype and not lse.requires_grad
        grads = torch.autograd.grad(o, leaves, dout)
        for key, x in zip(("out", "lse", "dq", "dk", "dv"),
                          (o, lse, *grads)):
            out[f"{name}/{key}"] = _np(x.float())
    return out


@contextlib.contextmanager
def _fused_seen(kind):
    """The list of the ``fused`` argument of every ``block_bwd`` call the
    ring ("ring") or zigzag ("zigzag_ring") schedule makes in the block."""
    module = importlib.import_module(
        "ring_flash_attn_tpu_torch.parallel."
        + ("ring" if kind == "ring" else "zigzag"))
    real, seen = module.block_bwd, []

    def recorder(*args, fused=None, **kw):
        seen.append(fused)
        return real(*args, fused=fused, **kw)

    module.block_bwd = recorder
    try:
        yield seen
    finally:
        module.block_bwd = real


def task_api(rank, world, p):
    """The distributed api functions and their packed forms on (B, S, H,
    D); ``ring_func`` also with gradients and with return_attn_probs, and
    with ``deterministic=True`` (as the kv-packed form), recording what
    each backward step asks ``block_bwd`` for."""
    out = {}
    for kind, layout in (("ring", "contiguous"), ("zigzag_ring", "zigzag")):
        q, k, v, dout = (_local(p[n], rank, world, layout, 1)
                         for n in ("q", "k", "v", "dout"))
        kw = dict(causal=True, softmax_scale=p["scale"])
        func = getattr(api, f"{kind}_flash_attn_func")
        kvfunc = getattr(api, f"{kind}_flash_attn_kvpacked_func")
        fused = {}
        with _fused_seen(kind) as fused["default"]:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o = func(*leaves, **kw)
            grads = torch.autograd.grad(o, leaves, dout)
        with _fused_seen(kind) as fused["deterministic"]:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            det = torch.autograd.grad(
                func(*leaves, deterministic=True, **kw), leaves, dout)
        with _fused_seen(kind) as fused["kvpacked deterministic"]:
            leaves = [q.clone().requires_grad_(),
                      torch.stack([k, v], dim=2).requires_grad_()]
            torch.autograd.grad(kvfunc(*leaves, deterministic=True, **kw),
                                leaves, dout)
        # on the CPU both take the plain backward: the same bits
        assert all(torch.equal(a, b) for a, b in zip(grads, det))
        out[f"{kind}/fused"] = fused
        out[f"{kind}/func"] = _np(o)
        for key, g in zip(("dq", "dk", "dv"), grads):
            out[f"{kind}/{key}"] = _np(g)
        o2, lse, probs = func(q, k, v, return_attn_probs=True, **kw)
        assert probs is None and torch.equal(o2, o.detach())
        out[f"{kind}/lse"] = _np(lse)
        kv = torch.stack([k, v], dim=2)
        out[f"{kind}/kvpacked"] = _np(kvfunc(q, kv, **kw))
        if k.shape[2] == q.shape[2]:
            qkv = torch.stack([q, k, v], dim=2)
            out[f"{kind}/qkvpacked"] = _np(getattr(
                api, f"{kind}_flash_attn_qkvpacked_func")(qkv, **kw))
    return out


def task_train(rank, world, p):
    """One ``train_step`` over the sequence group for each attention kind;
    with ``dp`` > 1 the ranks form a (dp, sp) grid, sp innermost, with a
    process group per row (the sequence) and per column (the data)."""
    dp = p["dp"]
    sp = world // dp
    sp_group, data_group = None, False
    if dp > 1:
        rows = [dist.new_group([d * sp + s for s in range(sp)])
                for d in range(dp)]
        cols = [dist.new_group([d * sp + s for d in range(dp)])
                for s in range(sp)]
        sp_group, data_group = rows[rank // sp], cols[rank % sp]
    out = {}
    for kind, (tokens, labels, pos) in p["batches"].items():
        cfg = ModelConfig(attention=kind, **p["cfg"])
        model = params_from_jax(p["params"], cfg, device="cpu")
        toks, labs = (torch.from_numpy(
            _shard(_shard(a, rank // sp, dp, 0), rank % sp, sp, 1)).long()
            for a in (tokens, labels))
        positions = torch.from_numpy(_shard(pos, rank % sp, sp, 0))
        _, loss = train_step(model, toks, labs, positions, lr=p["lr"],
                             sp_group=sp_group, data_group=data_group)
        out[f"{kind}/loss"] = _np(loss)
        for name, param in model.named_parameters():
            out[f"{kind}/{name}"] = _np(param.float())
    return out


TASKS = {"collectives": task_collectives, "decode": task_decode,
         "llama3": task_llama3, "generate": task_generate,
         "schedules": task_schedules, "api": task_api, "train": task_train}


def _worker(rank, world, port, task, payload, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            out = TASKS[task](rank, world, payload)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except Exception:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(task, world, payload):
    """[result dict of rank 0, ..., of rank world-1]; raises on a worker's
    error or when the ranks do not all report in time."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, task, payload, results),
                         daemon=True) for r in range(world)]
    for pr in procs:
        pr.start()
    got, errors = {}, []
    try:
        for _ in range(world):  # drain the queue before joining
            try:
                rank, out, err = results.get(timeout=START_TIMEOUT)
            except queue.Empty:
                errors.append(f"only ranks {sorted(got)} of {world} reported "
                              f"within {START_TIMEOUT} s")
                break
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            got[rank] = out
    finally:
        for pr in procs:
            pr.join(timeout=0 if errors else JOIN_TIMEOUT)
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=JOIN_TIMEOUT)
                if not errors:
                    errors.append(f"worker {pr.pid} did not exit in "
                                  f"{JOIN_TIMEOUT} s and was killed")
    if errors:
        raise RuntimeError(f"{task} over {world} gloo ranks failed:\n"
                           + "\n".join(errors))
    return [got[r] for r in range(world)]


def task_all(rank, world, payloads):
    """Every task of ``payloads`` ({task: payload}) in one set of
    processes; result keys are "task/key"."""
    return {f"{task}/{key}": value for task, payload in payloads.items()
            for key, value in TASKS[task](rank, world, payload).items()}


TASKS["all"] = task_all
