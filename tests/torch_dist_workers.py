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

from ring_flash_attn_tpu_torch import RingAttentionLayer, api
from ring_flash_attn_tpu_torch.models import (
    ModelConfig, MoELayer, ServingEngine, decode_step, forward_pp, generate,
    moe_mlp, params_from_jax, prefill, shard_params, stack_layers,
    train_step, train_step_pp)
from ring_flash_attn_tpu_torch.models.serve import _decode_body
from ring_flash_attn_tpu_torch.ops.paged import PagedKVCache
from ring_flash_attn_tpu_torch.ops.quant import (
    as_bytes, make_cache, quantized_kv_from_jax)
from ring_flash_attn_tpu_torch.parallel import (
    fused_ring_attention, layouts, llama3_attention, merge_across_axis,
    psum_exact, ring_attention, ring_rank, ring_rotate, ring_rotate_start,
    ring_size, sharded_cache_update, sharded_quant_decode, stripe_attention,
    ulysses_attention, usp_attention, zigzag_ring_attention)
from ring_flash_attn_tpu_torch.parallel.mesh import (
    Posted, RingBuffer, all_gather, all_gather_start, all_reduce, all_to_all,
    reduce_scatter, reduce_scatter_start)

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
    """Each variant's (out, lse) on this rank's contiguous shards; with
    ``p["dout"]`` also the gradients of q, k and v."""
    q, k, v = (torch.from_numpy(_shard(p[n], rank, world, 2))
               for n in ("q", "k", "v"))
    out = {}
    for name, kw in p["variants"].items():
        if "dout" not in p:
            o, lse = llama3_attention(q, k, v, scale=p["scale"], **kw)
            out[f"out_{name}"], out[f"lse_{name}"] = _np(o), _np(lse)
            continue
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = llama3_attention(*leaves, scale=p["scale"], **kw)
        assert o.dtype == q.dtype and not lse.requires_grad
        dout = torch.from_numpy(_shard(p["dout"], rank, world, 2))
        grads = torch.autograd.grad(o, leaves, dout)
        for key, x in zip(("out", "lse", "dq", "dk", "dv"),
                          (o, lse, *grads)):
            out[f"{key}_{name}"] = _np(x)
    return out


def _l3_blocking(q, k, v, segids, dout, scale, kw):
    """llama3's forward and backward through the module's rank functions
    over the blocking collectives (``all_gather`` a chunk at a time when
    the kernel asks for it, ``reduce_scatter`` right after each chunk's
    kernel): (out, lse, dq, dk, dv)."""
    from ring_flash_attn_tpu_torch.parallel import llama3 as l3

    hkv = k.shape[1]
    stride = kw.get("heads_k_stride") or hkv
    extras = {n: kw.get(n) for n in ("softcap", "alibi_slopes", "dropout_p",
                                     "dropout_seed", "window_left")}
    kv = torch.stack([k, v])

    def gather(i):  # gathered at the call, nothing left posted
        return Posted(all_gather(kv[:, :, i:i + stride], 3))

    mask = l3._mask(kw.get("causal", True), q, segids, None, extras)
    out, lse = l3._rank_fwd(q, gather, hkv, scale, mask, stride, None)
    dqs, dks, dvs = [], [], []
    for dq_i, dk_g, dv_g in l3._rank_bwd(q, out, lse, dout, gather, hkv,
                                         scale, mask, stride, None):
        dqs.append(dq_i)
        dks.append(reduce_scatter(dk_g, 2).to(k.dtype))
        dvs.append(reduce_scatter(dv_g, 2).to(v.dtype))
    return (out, lse) + tuple(torch.cat(x, dim=1)
                              for x in (dqs, dks, dvs))


def _l3_recorded(run):
    """run() with llama3's posted collectives and block kernels wrapped:
    (the events in order, the most gathered chunks alive at once). A
    gather's chunk is alive from its post until the tensor its wait
    returned is freed."""
    import weakref

    from ring_flash_attn_tpu_torch.parallel import llama3 as l3
    from ring_flash_attn_tpu_torch.parallel.mesh import Posted

    events, alive, most = [], [0], [0]
    names = ("all_gather_start", "reduce_scatter_start", "block_fwd",
             "block_bwd")
    real = {n: getattr(l3, n) for n in names}

    def release():
        alive[0] -= 1

    class Logged(Posted):
        def __init__(self, inner, tag, gathered):
            self._inner, self._tag, self._gathered = inner, tag, gathered

        def wait(self):
            events.append(f"wait {self._tag}")
            x = self._inner.wait()
            if self._gathered:
                weakref.finalize(x, release)
            return x

    def gather(*a, **kw):
        tag = f"g{sum(e.startswith('post g') for e in events)}"
        events.append(f"post {tag}")
        alive[0] += 1
        most[0] = max(most[0], alive[0])
        return Logged(real["all_gather_start"](*a, **kw), tag, True)

    def scatter(*a, **kw):
        events.append("post rs")
        return Logged(real["reduce_scatter_start"](*a, **kw), "rs", False)

    def kernel(name):
        def fn(*a, **kw):
            events.append(name)
            return real[f"block_{name}"](*a, **kw)
        return fn

    patched = {"all_gather_start": gather, "reduce_scatter_start": scatter,
               "block_fwd": kernel("fwd"), "block_bwd": kernel("bwd")}
    try:
        for n, fn in patched.items():
            setattr(l3, n, fn)
        run()
    finally:
        for n, fn in real.items():
            setattr(l3, n, fn)
    return events, most[0]


def task_llama3_posted(rank, world, p):
    """For each variant, llama3_attention's out, lse and gradients (its
    collectives posted ahead) and the blocking path's
    (``_l3_blocking``), keys "posted/..." and "blocking/..."; the order
    of the posted collectives and the kernels in ``p["order"]``'s
    variant ("events", "most_alive"); the posted gather and reduce-scatter
    of this rank's ``p["x"][rank]`` beside the blocking ones."""
    q, k, v, dout = (torch.from_numpy(_shard(p[n], rank, world, 2))
                     for n in ("q", "k", "v", "dout"))
    segids = torch.from_numpy(_shard(p["segids"], rank, world, 0))
    out = {}

    def posted(kw):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        kw = dict(kw)
        ids = segids if kw.pop("packed", False) else None
        o, lse = llama3_attention(*leaves, ids, scale=p["scale"], **kw)
        return (o.detach(), lse) + torch.autograd.grad(o, leaves, dout)

    for name, kw in p["variants"].items():
        ids = segids if kw.get("packed") else None
        ref = _l3_blocking(q, k, v, ids, dout, p["scale"],
                           {n: x for n, x in kw.items() if n != "packed"})
        for key, a, b in zip(("out", "lse", "dq", "dk", "dv"), posted(kw),
                             ref):
            out[f"posted/{key}_{name}"], out[f"blocking/{key}_{name}"] = (
                _np(a), _np(b))
    events, most = _l3_recorded(lambda: posted(p["variants"][p["order"]]))
    out["events"], out["most_alive"] = np.array(events), np.array(most)
    x = torch.from_numpy(p["x"][rank])
    for dim in (0, 1, -1):
        out[f"gather{dim}"] = _np(all_gather_start(x, dim).wait())
        out[f"gather{dim}_blocking"] = _np(all_gather(x, dim))
        out[f"scatter{dim}"] = _np(reduce_scatter_start(x, dim).wait())
        out[f"scatter{dim}_blocking"] = _np(reduce_scatter(x, dim))
    return out


def task_reduce_scatter(rank, world, p):
    """reduce_scatter of this rank's ``p["x"][rank]`` along each of
    ``p["dims"]``."""
    x = torch.from_numpy(p["x"][rank])
    return {f"dim{d}": _np(reduce_scatter(x, d)) for d in p["dims"]}


def _moe_layer(p, e_local, rank):
    """A MoELayer holding rank's experts of the numpy layer ``p``."""
    layer = MoELayer(p["d"], p["mlp"], p["e"], torch.float32, "cpu", e_local)
    with torch.no_grad():
        for name, param in layer.named_parameters():
            a = torch.from_numpy(p[name])
            param.copy_(a if name == "router"
                        else a.chunk(p["e"] // e_local)[rank])
    return layer


def task_moe_ep(rank, world, p):
    """moe_mlp over an ep group of all ranks: each rank holds its batch
    rows and its experts; out, the aux statistics and the gradients of x
    and of the layer's (local) parameters."""
    layer = _moe_layer(p, p["e"] // world, rank)
    x = torch.from_numpy(_shard(p["x"], rank, world, 0)).requires_grad_()
    y, (count, probsum) = moe_mlp(x, layer, torch.from_numpy(p["norm"]),
                                  p["cap"], ep_group=None, return_aux=True)
    dout = torch.from_numpy(_shard(p["dout"], rank, world, 0))
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(y, [x, *layer.parameters()], dout)
    out = {"out": _np(y), "count": _np(count), "probsum": _np(probsum),
           "dx": _np(grads[0])}
    out.update({f"d{n}": _np(g) for n, g in zip(names, grads[1:])})
    return out


def _zz_local(a, sp_rank, sp):
    """sp rank's chunk of a (B, S) array laid out (zigzag) along S."""
    return torch.from_numpy(_shard(a, sp_rank, sp, 1)).long()


def task_grid(rank, world, p):
    """The 2 x 4 grid of (tp or ep) x sp, sp minor, as JAX's
    ``Mesh(devices.reshape(2, 4), ("tp", "sp"))`` numbers it: sp groups
    {0..3} and {4..7}, tp/ep groups {0,4}, {1,5}, {2,6}, {3,7}. With
    ``p["tp"]``: the tensor-parallel forward's logits and one
    ``train_step`` over (tp, sp) on rank's shards; with ``p["moe"]``: one
    MoE ``train_step`` over (ep, sp), the batch split over ep. Returns the
    losses and the updated (local) parameters."""
    sp = 4
    outer_group, sp_group = _grid_groups(rank, world, sp)
    outer_rank, sp_rank = rank // sp, rank % sp
    out = {}
    if "tp" in p:
        t = p["tp"]
        cfg = ModelConfig(**t["cfg"])
        toks, labs = (_zz_local(a, sp_rank, sp)
                      for a in (t["tokens"], t["labels"]))
        pos = torch.from_numpy(_shard(t["pos"], sp_rank, sp, 0))
        model = shard_params(t["params"], cfg, tp_rank=outer_rank,
                             tp=world // sp, device="cpu")
        with torch.no_grad():
            out["tp/logits"] = _np(model(toks, pos, sp_group=sp_group,
                                         tp_group=outer_group))
        _, loss = train_step(model, toks, labs, pos, lr=t["lr"],
                             sp_group=sp_group, tp_group=outer_group)
        out["tp/loss"] = _np(loss)
        out.update({f"tp/{n}": _np(x) for n, x in model.named_parameters()})
    if "moe" in p:
        m = p["moe"]
        cfg = ModelConfig(**m["cfg"])
        toks, labs = (_zz_local(_shard(a, outer_rank, world // sp, 0),
                                sp_rank, sp)
                      for a in (m["tokens"], m["labels"]))
        pos = torch.from_numpy(_shard(m["pos"], sp_rank, sp, 0))
        model = shard_params(m["params"], cfg, ep_rank=outer_rank,
                             ep=world // sp, device="cpu")
        _, loss = train_step(model, toks, labs, pos, lr=m["lr"],
                             sp_group=sp_group, ep_group=outer_group)
        out["moe/loss"] = _np(loss)
        out.update({f"moe/{n}": _np(x) for n, x in model.named_parameters()})
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
    extract = {"zigzag": layouts.extract_local_zigzag,
               "stripe": layouts.extract_local_stripe}.get(
        layout, layouts.extract_local_contiguous)
    return extract(torch.from_numpy(a), rank, world, axis).contiguous()


_SCHEDULES = {"ring": (ring_attention, "contiguous"),
              "zigzag": (zigzag_ring_attention, "zigzag"),
              "fused_ring": (fused_ring_attention, "contiguous")}


@contextlib.contextmanager
def _block_calls(kind):
    """The steps at which the ring ("ring") or zigzag ("zigzag") step
    loops call ``block_fwd`` and ``block_bwd`` in the block: {"fwd": [...],
    "bwd": [...]}, a step counted by its call's place in the loop."""
    module = importlib.import_module(
        "ring_flash_attn_tpu_torch.parallel." + kind)
    real = module.block_fwd, module.block_bwd
    calls = {"fwd": 0, "bwd": 0}

    def counted(what, fn):
        def call(*args, **kw):
            calls[what] += 1
            return fn(*args, **kw)

        return call

    module.block_fwd = counted("fwd", real[0])
    module.block_bwd = counted("bwd", real[1])
    try:
        yield calls
    finally:
        module.block_fwd, module.block_bwd = real


def task_schedules(rank, world, p):
    """Each variant's (out, lse) and gradients on this rank's shards of the
    global (B, H, S, D) inputs, and for the ring and zigzag schedules the
    number of blocks their forward and backward launched
    ("<name>/blocks": fwd, bwd)."""
    out = {}
    for name, (kind, dtype, kw) in p["variants"].items():
        fn, layout = _SCHEDULES[kind]
        q, k, v, dout = (
            _local(p[n], rank, world, layout, 2).to(getattr(torch, dtype))
            for n in ("q", "k", "v", "dout"))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        counter = (_block_calls(kind) if kind in ("ring", "zigzag")
                   else contextlib.nullcontext({"fwd": -1, "bwd": -1}))
        with counter as calls:
            o, lse = fn(*leaves, scale=p["scale"], **kw)
            assert o.dtype == q.dtype and not lse.requires_grad
            grads = torch.autograd.grad(o, leaves, dout)
        out[f"{name}/blocks"] = np.array([calls["fwd"], calls["bwd"]])
        for key, x in zip(("out", "lse", "dq", "dk", "dv"),
                          (o, lse, *grads)):
            out[f"{name}/{key}"] = _np(x.float())
    return out


# the module whose step loop runs an api kind's block_bwd calls
_BWD_MODULE = {"ring": "ring", "zigzag_ring": "zigzag", "stripe": "ring"}


@contextlib.contextmanager
def _fused_seen(kind):
    """The list of the ``fused`` argument of every ``block_bwd`` call the
    ring ("ring"), zigzag ("zigzag_ring") or stripe ("stripe") schedule
    makes in the block."""
    module = importlib.import_module(
        "ring_flash_attn_tpu_torch.parallel." + _BWD_MODULE[kind])
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
    each backward step asks ``block_bwd`` for. ``p["kinds"]`` (default:
    ring and zigzag) lists the (kind, layout) pairs."""
    out = {}
    kinds = p.get("kinds", (("ring", "contiguous"), ("zigzag_ring", "zigzag")))
    for kind, layout in kinds:
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


def _grid_groups(rank, world, inner):
    """(outer group, inner group) of ``rank`` on a (world / inner, inner)
    grid of processes, inner minor: the inner groups are runs of
    ``inner`` consecutive ranks, an outer group takes every inner-th rank.
    Every process creates every group, in the same order, as
    ``dist.new_group`` requires."""
    outer = world // inner
    rows = [dist.new_group([o * inner + i for i in range(inner)])
            for o in range(outer)]
    cols = [dist.new_group([o * inner + i for o in range(outer)])
            for i in range(inner)]
    return cols[rank % inner], rows[rank // inner]


def task_train(rank, world, p):
    """One ``train_step`` over the sequence group for each attention kind;
    with ``dp`` > 1 the ranks form a (dp, sp) grid, sp innermost, with a
    process group per row (the sequence) and per column (the data). The
    "usp" kind runs on a (world / ``wu``, ``wu``) grid instead: the ring
    over the columns, the Ulysses all-to-all over the rows (runs of
    consecutive ranks), the tokens contiguous over the ranks."""
    dp = p["dp"]
    sp = world // dp
    sp_group, data_group = None, False
    if dp > 1:
        data_group, sp_group = _grid_groups(rank, world, sp)
    if "usp" in p["batches"]:
        usp_groups = _grid_groups(rank, world, p["wu"])
    out = {}
    for kind, (tokens, labels, pos) in p["batches"].items():
        cfg = ModelConfig(attention=kind, **p["cfg"])
        model = params_from_jax(p["params"], cfg, device="cpu")
        toks, labs = (torch.from_numpy(
            _shard(_shard(a, rank // sp, dp, 0), rank % sp, sp, 1)).long()
            for a in (tokens, labels))
        positions = torch.from_numpy(_shard(pos, rank % sp, sp, 0))
        groups = dict(sp_group=sp_group, data_group=data_group)
        if kind == "usp":
            groups = dict(zip(("sp_group", "ulysses_group"), usp_groups))
        _, loss = train_step(model, toks, labs, positions, lr=p["lr"],
                             **groups)
        out[f"{kind}/loss"] = _np(loss)
        for name, param in model.named_parameters():
            out[f"{kind}/{name}"] = _np(param.float())
    return out


def _cp_local(a, rank, world, case):
    """Rank's shard of a context-parallel case's global (B, H, S, D) array:
    in the schedule's layout over ``world`` ranks, or for USP in the ring
    variant's layout over the ring group, then contiguous over the ranks
    (ring major, Ulysses minor)."""
    layout = case["layout"]
    if "wu" in case:
        x = torch.from_numpy(a)
        wr = world // case["wu"]
        if layout == "zigzag":
            x = layouts.all_local_zigzag(x, wr, axis=2)
        elif layout == "stripe":
            x = layouts.all_local_stripe(x, wr, axis=2)
        return layouts.extract_local_contiguous(x, rank, world,
                                                axis=2).contiguous()
    return _local(a, rank, world, layout, 2)


def _registry_fn(name):
    """A registry entry as a (B, H, S, D) function returning (out, None)."""
    def fn(q, k, v, scale, causal, group):
        layer = RingAttentionLayer(name, axis_name=group, scale=scale,
                                   causal=causal)
        out = layer(*(x.transpose(1, 2) for x in (q, k, v)))
        return out.transpose(1, 2), None

    return fn


def task_cp(rank, world, p):
    """The context-parallel cases of ``p["cases"]``: each one's (out, lse)
    and gradients on this rank's shard (kinds "stripe", "ulysses", "usp"
    with the ring variant ``case["variant"]`` on a (world / wu, wu) grid,
    and "registry stripe" / "registry ulysses" through
    ``RingAttentionLayer``); and ``all_to_all`` with its gradient on
    ``p["a2a"]``'s per-rank inputs for each (split, concat) pair."""
    grids = {wu: _grid_groups(rank, world, wu) for wu in sorted(
        {c["wu"] for c in p["cases"].values() if "wu" in c})}
    out = {}
    for name, c in p["cases"].items():
        kind, kw = c["kind"], dict(c["kw"])
        q, k, v, dout = (_cp_local(c[n], rank, world, c)
                         for n in ("q", "k", "v", "dout"))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        if kind == "stripe":
            o, lse = stripe_attention(*leaves, scale=p["scale"], **kw)
        elif kind == "ulysses":
            o, lse = ulysses_attention(*leaves, scale=p["scale"], **kw)
        elif kind == "usp":
            ring_group, ulysses_group = grids[c["wu"]]
            o, lse = usp_attention(*leaves, scale=p["scale"],
                                   ulysses_group=ulysses_group,
                                   ring_group=ring_group, **kw)
        else:
            o, lse = _registry_fn(kind.split()[1])(
                *leaves, p["scale"], kw["causal"], None)
        assert o.dtype == q.dtype and (lse is None or not lse.requires_grad)
        grads = torch.autograd.grad(o, leaves, dout)
        for key, x in zip(("out", "lse", "dq", "dk", "dv"),
                          (o, lse, *grads)):
            if x is not None:
                out[f"{name}/{key}"] = _np(x.float())
    for split, concat in p["a2a"]["pairs"]:  # none at W=8
        x = torch.from_numpy(p["a2a"]["x"][rank]).requires_grad_()
        y = all_to_all(x, split, concat)
        ct = torch.from_numpy(p["a2a"]["ct"][rank]).reshape(y.shape)
        (grad,) = torch.autograd.grad(y, x, ct)
        out[f"a2a/{split},{concat}"] = _np(y)
        out[f"a2a/{split},{concat}/grad"] = _np(grad)
    return out


def task_ulysses_heads(rank, world, p):
    """The messages of the ValueErrors that Ulysses raises for q heads not
    divisible by the group's size (3 at W=4) and for kv heads that neither
    divide nor are divided by it (3 kv heads of 12 q heads at W=4)."""
    out = {}
    for key, (hq, hkv) in (("hq", (3, 3)), ("hkv", (12, 3))):
        q, kv = torch.zeros(1, hq, 8, 16), torch.zeros(1, hkv, 8, 16)
        try:
            ulysses_attention(q, kv, kv, scale=1.0, causal=True)
        except ValueError as e:
            out[key] = str(e)
    return out


def _varlen_call(kind, kw, rank, world, p):
    """(entry point's out, lse or None, leaves, this rank's dout) of one
    varlen variant on this rank's tokens."""
    from ring_flash_attn_tpu_torch.ops.varlen import (
        extract_local_ring_varlen, ring_varlen_info)

    cu = p["cu"]
    # the qkv-packed form takes as many kv heads as q heads
    names = (("q", "k_qkv", "v_qkv", "dout") if kind == "ring_qkvpacked"
             else ("q", "k", "v", "dout"))
    if kind == "llama3":
        n = p["q"].shape[0] // world
        local = [torch.from_numpy(p[x][rank * n:(rank + 1) * n])
                 for x in names]
    else:
        local = [torch.from_numpy(extract_local_ring_varlen(p[x], cu, rank,
                                                            world))
                 for x in names]
    leaves = [x.clone().requires_grad_() for x in local[:3]]
    causal = kw["causal"]
    if kind == "ring":
        out, lse, _ = api.ring_flash_attn_varlen_func(
            *leaves, np.asarray(cu) // world, return_attn_probs=True, **kw)
    elif kind == "ring_kvpacked":
        out, lse, _ = api.ring_flash_attn_varlen_kvpacked_func(
            leaves[0], torch.stack(leaves[1:], 1),
            torch.as_tensor(np.asarray(cu) // world),
            return_attn_probs=True, **kw)
    elif kind == "ring_qkvpacked":
        out, lse, _ = api.ring_flash_attn_varlen_qkvpacked_func(
            torch.stack(leaves, 1), list(np.asarray(cu) // world),
            return_attn_probs=True, **kw)
    elif kind == "registry":
        seg, pos = ring_varlen_info(np.asarray(cu) // world,
                                    leaves[0].shape[0], rank)
        out = RingAttentionLayer("ring_varlen")(
            *(x[None] for x in leaves), segment_ids=seg, positions=pos,
            **kw)[0]
        lse = None
    else:  # llama3
        cu_q, cu_k, mq, mk, sl = api.llama3_flash_attn_prepare_cu_seqlens(
            cu, causal, rank, world)
        out, lse, _ = api.llama3_flash_attn_varlen_func(
            *leaves, cu_q, cu_k, mq, mk, local_k_slice=sl,
            return_attn_probs=True, **kw)
    return out, lse, leaves, local[3]


def task_varlen(rank, world, p):
    """Each varlen variant's out, lse and the gradients of q, k and v on
    this rank's tokens (ring layout: part r of every sequence; llama3: the
    rank's contiguous share); records the ``fused`` argument of every
    block_bwd call under "fused_<name>"."""
    from ring_flash_attn_tpu_torch.ops import flash
    from ring_flash_attn_tpu_torch.parallel import llama3 as l3, ring

    out = {}
    for name, (kind, kw) in p["variants"].items():
        seen, real = [], flash.block_bwd

        def recorder(*args, fused=None, **k):
            seen.append(fused)
            return real(*args, fused=fused, **k)

        ring.block_bwd = l3.block_bwd = recorder
        try:
            o, lse, leaves, dout = _varlen_call(kind, kw, rank, world, p)
            grads = torch.autograd.grad(o, leaves, dout)
        finally:
            ring.block_bwd = l3.block_bwd = real
        out[f"out_{name}"] = _np(o)
        if lse is not None:
            out[f"lse_{name}"] = _np(lse)
        for key, g in zip(("dq", "dk", "dv"), grads):
            out[f"{key}_{name}"] = _np(g)
        out[f"fused_{name}"] = np.array([-1 if f is None else int(f)
                                         for f in seen])
    return out


def _zigzag_varlen_call(kind, kw, rank, world, p):
    """(out, lse or None, leaves, this rank's dout) of one zigzag-varlen
    variant on this rank's tokens in the grouped layout."""
    from ring_flash_attn_tpu_torch.ops.varlen import (
        extract_local_zigzag_varlen, zigzag_varlen_info)

    cu = np.asarray(p["packings"][kw.pop("packing")])
    names = (("q", "k_qkv", "v_qkv", "dout") if kind == "qkvpacked"
             else ("q", "k", "v", "dout"))
    local = [torch.from_numpy(extract_local_zigzag_varlen(p[x], cu, rank,
                                                          world))
             for x in names]
    leaves = [x.clone().requires_grad_() for x in local[:3]]
    cu_local = cu // world
    if kind == "func":
        out, lse, _ = api.zigzag_ring_flash_attn_varlen_func(
            *leaves, list(cu_local), return_attn_probs=True, **kw)
    elif kind == "kvpacked":
        out, lse, _ = api.zigzag_ring_flash_attn_varlen_kvpacked_func(
            leaves[0], torch.stack(leaves[1:], 1),
            torch.as_tensor(cu_local), return_attn_probs=True, **kw)
    elif kind == "qkvpacked":
        out, lse, _ = api.zigzag_ring_flash_attn_varlen_qkvpacked_func(
            torch.stack(leaves, 1), cu_local, return_attn_probs=True, **kw)
    else:  # the registry's entry, on the layout's segment ids and positions
        seg, pos = zigzag_varlen_info(cu_local // 2, leaves[0].shape[0],
                                      rank, world)
        out = RingAttentionLayer("zigzag_varlen")(
            *(x[None] for x in leaves), segment_ids=seg, positions=pos,
            **kw)[0]
        lse = None
    return out, lse, leaves, local[3]


def task_zigzag_varlen(rank, world, p):
    """Each zigzag-varlen variant's out, lse and the gradients of q, k and
    v on this rank's tokens (chunk r, then chunk 2W-1-r, of every
    sequence); records the ``fused`` argument of every block_bwd call of
    the step loops under "fused_<name>"."""
    from ring_flash_attn_tpu_torch.parallel import zigzag

    out = {}
    for name, (kind, kw) in p["variants"].items():
        seen, real = [], zigzag.block_bwd

        def recorder(*args, fused=None, **k):
            seen.append(fused)
            return real(*args, fused=fused, **k)

        zigzag.block_bwd = recorder
        try:
            o, lse, leaves, dout = _zigzag_varlen_call(kind, dict(kw), rank,
                                                       world, p)
            grads = torch.autograd.grad(o, leaves, dout)
        finally:
            zigzag.block_bwd = real
        out[f"out_{name}"] = _np(o)
        if lse is not None:
            out[f"lse_{name}"] = _np(lse)
        for key, g in zip(("dq", "dk", "dv"), grads):
            out[f"{key}_{name}"] = _np(g)
        out[f"fused_{name}"] = np.array([-1 if f is None else int(f)
                                         for f in seen])
    return out


def task_serve_tp(rank, world, p):
    """Tensor-parallel serving over a tp group of all ranks:
    ``_decode_body(tp_group=)`` on rank's shards of the weights and of the
    caches' kv heads, fed ``p["decode"]["feed"]`` step by step (its logits
    and final caches); with ``p["engines"]`` ({name: (engine keywords,
    requests)}) the ``ServingEngine(mesh=)`` outputs of each."""
    group = dist.group.WORLD
    cfg = ModelConfig(**p["cfg"])
    d = p["decode"]
    model = shard_params(p["params"], cfg, tp_rank=rank, tp=world,
                         device="cpu")
    caches = [PagedKVCache(torch.from_numpy(_shard(k, rank, world, 1)),
                           torch.from_numpy(_shard(v, rank, world, 1)),
                           torch.from_numpy(bt), torch.from_numpy(lens))
              for k, v, bt, lens in d["caches"]]
    live = torch.from_numpy(d["live"])
    out = {}
    for step, toks in enumerate(d["feed"]):
        logits, caches = _decode_body(model, torch.from_numpy(toks).long(),
                                      live, caches, tp_group=group)
        out[f"decode/logits{step}"] = _np(logits)
    for i, c in enumerate(caches):
        out[f"decode/k{i}"], out[f"decode/v{i}"] = _np(c.k_pages), _np(
            c.v_pages)
        out[f"decode/lens{i}"] = _np(c.seq_lens)
    whole = params_from_jax(p["params"], cfg, device="cpu")
    for name, (kw, requests) in p.get("engines", {}).items():
        eng = ServingEngine(whole, mesh=group, device="cpu", **kw)
        for rid, prompt, n, prefix_of in requests:
            eng.submit(rid, prompt, n, prefix_of=prefix_of)
        for rid, toks in eng.run(max_steps=120).items():
            out[f"engine/{name}/{rid}"] = np.asarray(toks)
    return out


def _hf_model(case):
    """A torch transformers causal LM of ``case["family"]`` from its config
    dict and numpy state dict, float32, in eval mode."""
    import os

    os.environ.setdefault("USE_TF", "0")  # transformers' import, faster
    import transformers

    family = case["family"]
    cfg = getattr(transformers, f"{family}Config").from_dict(case["config"])
    model = getattr(transformers, f"{family}ForCausalLM")(cfg).float()
    model.load_state_dict({n: torch.from_numpy(a)
                           for n, a in case["state"].items()})
    return model.eval()


def task_hf(rank, world, p):
    """The HF adapter over a group of all ranks, each on its contiguous
    shard of the tokens: with ``p["models"]`` ({name: case}) the patched
    model's logits on the shard with its global position_ids; with
    ``p["forward"]`` ({name: (q, k, v, dout, keywords)}) the out of
    ``ring_attention_forward`` and the gradients of q, k and v; a keyword
    "cu_seqlens" is given to ``update_ring_flash_attn_params`` first, and
    "global_segids": True passes ``current_ring_params()``'s labels."""
    from ring_flash_attn_tpu_torch import adapters

    out = {}
    if "models" in p:
        adapters.substitute_hf_flash_attn()
    for name, case in p.get("models", {}).items():
        model = _hf_model(case)
        toks = torch.from_numpy(_shard(case["tokens"], rank, world, 1))
        pos = torch.from_numpy(_shard(case["pos"], rank, world, 1))
        with torch.no_grad():
            logits = model(toks.long(), position_ids=pos.long(),
                           use_cache=False).logits
        out[f"{name}/logits"] = _np(logits)
    for name, (q, k, v, dout, kw) in p.get("forward", {}).items():
        kw = dict(kw)
        if "cu_seqlens" in kw:
            adapters.update_ring_flash_attn_params(kw.pop("cu_seqlens"))
        if kw.pop("global_segids", False):
            kw["global_segids"] = adapters.current_ring_params()[
                "global_segids"]
        if "position_ids" in kw:
            kw["position_ids"] = torch.from_numpy(
                _shard(kw["position_ids"], rank, world, 1))
        leaves = [torch.from_numpy(_shard(a, rank, world, 1)).requires_grad_()
                  for a in (q, k, v)]
        o = adapters.ring_attention_forward(*leaves, causal=True, **kw)
        grads = torch.autograd.grad(
            o, leaves, torch.from_numpy(_shard(dout, rank, world, 1)))
        for key, x in zip(("out", "dq", "dk", "dv"), (o, *grads)):
            out[f"{name}/{key}"] = _np(x)
    return out


def task_pipeline(rank, world, p):
    """The GPipe pipeline on a (pp, sp) grid of ``p["sp"]`` sequence ranks,
    sp minor, as JAX's ``Mesh(devices.reshape(pp, sp), ("pp", "sp"))``
    numbers it (sp 1: no sequence group): rank's stage of the layers
    (``stack_layers``) and its sequence chunk of the zigzag batch;
    ``forward_pp``'s logits (on the last stage), then one
    ``train_step_pp``'s loss and the stage's updated parameters. With
    ``p["dp"]`` > 1 (and sp 1) the ranks form a (dp, pp) grid, pp minor,
    as ``Mesh(devices.reshape(dp, pp), ("dp", "pp"))`` numbers it: a pp
    group per row, a data group per column, and data replica r takes rows
    [r B / dp, (r + 1) B / dp) of the batch."""
    sp, dp = p["sp"], p.get("dp", 1)
    data_group, rows = False, slice(None)
    if dp > 1:
        pp = world // dp
        data_group, pp_group = _grid_groups(rank, world, pp)
        sp_group, stage, sp_rank = False, rank % pp, 0
        per = len(p["tokens"]) // dp
        rows = slice(rank // pp * per, (rank // pp + 1) * per)
    elif sp == 1:
        pp_group, sp_group = dist.group.WORLD, False
        stage, sp_rank = rank, 0
    else:
        pp_group, sp_group = _grid_groups(rank, world, sp)
        stage, sp_rank = rank // sp, rank % sp
    cfg = ModelConfig(**p["cfg"])
    model = stack_layers(p["params"], cfg, pp_rank=stage,
                         pp=world // sp // dp, device="cpu")
    toks, labs = (_zz_local(a[rows], sp_rank, sp)
                  for a in (p["tokens"], p["labels"]))
    pos = torch.from_numpy(_shard(p["pos"], sp_rank, sp, 0))
    out = {}
    with torch.no_grad():
        logits = forward_pp(model, toks, pos, pp_group, p["m"],
                            sp_group=sp_group)
    if logits is not None:
        out["logits"] = _np(logits)
    _, loss = train_step_pp(model, toks, labs, pos, pp_group, p["m"],
                            lr=p["lr"], sp_group=sp_group,
                            data_group=data_group)
    out["loss"] = _np(loss)
    out.update({n: _np(x) for n, x in model.named_parameters()})
    return out


TASKS = {"collectives": task_collectives, "decode": task_decode,
         "llama3": task_llama3, "llama3_posted": task_llama3_posted,
         "generate": task_generate,
         "schedules": task_schedules, "api": task_api, "train": task_train,
         "cp": task_cp, "ulysses_heads": task_ulysses_heads,
         "reduce_scatter": task_reduce_scatter, "moe_ep": task_moe_ep,
         "grid": task_grid, "varlen": task_varlen,
         "zigzag_varlen": task_zigzag_varlen, "serve_tp": task_serve_tp,
         "hf": task_hf, "pipeline": task_pipeline}


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
