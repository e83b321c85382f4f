"""Entry points of the port: the flagship forward and a multi-process dry
run of the training step on every mesh the JAX package's entry points
check.

The port of ``__graft_entry__.py`` (the JAX package's entry points),
inside the package:

- ``entry(device="cuda")`` returns ``(fn, (model, tokens, positions))``:
  the flagship model (vocab 2048, dim 512, 2 layers, 8 q and 2 kv heads
  of 64, mlp 1408, zigzag attention, bf16) from ``init_params`` with a
  ``torch.Generator`` seeded 0, or from the JAX package's parameter tree
  (``params=``, numpy leaves), zero tokens (1, 1024) and positions
  ``arange(1024)``; ``fn`` is ``Transformer.forward`` with no group, so on
  the card it runs kernel B1.
- ``dryrun_multichip(n, device="cuda", inputs=None)`` runs JAX's seven
  configurations in JAX's order, each one step on tiny shapes over the
  same mesh, in ``n`` processes of ``torch.distributed`` that it spawns
  itself: (1) dp x sp, zigzag ring context parallelism with replicated
  weights; from n >= 8 on also (2) dp x hp x sp, USP (Ulysses over hp, the
  ring over sp); (3) dp x tp x sp, Megatron tensor parallelism with the
  zigzag ring; (4) pp x sp, the GPipe pipeline; (5) ep x sp, switch MoE
  with expert parallelism; (6) llama3's varlen forward and backward over
  sp = n; (7) a tensor-parallel paged decode step over tp = 2. It prints
  one line a configuration in JAX's format and returns ``{name: loss}``
  (1 to 5), the llama3 gradients of q, k and v (6) and the decode logits
  (7). On the CPU the processes join a gloo group; with
  ``device="cuda"`` each takes a card of its own and NCCL, and there the
  configurations take the kernels' operands: bf16 and head_dim 64 (JAX's
  are float32 of head_dim 16, which only the plain versions take).
  ``inputs`` gives the JAX package's parameter trees and inputs (numpy,
  JAX's float32 shapes: on the CPU), so that a test can hold the losses
  against JAX's; without it every
  input is drawn from ``torch.Generator``\\ s seeded as JAX's keys are
  numbered (0 for the parameters, 1 to 9 for the rest).

Meshes are JAX's: ``Mesh(devices.reshape(...), axes)`` numbers the
processes row-major, the last axis fastest, and an axis's group holds the
ranks that differ along it alone (``utils.make_cp_mesh`` for the 2-D
meshes, ``dist.new_group`` for the 3-D ones).
"""

import dataclasses
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .config import resolve_device
from .models import (ModelConfig, Transformer, init_params, params_from_jax,
                     prepare_zigzag_batch, shard_params, stack_layers,
                     train_step, train_step_pp)
from .utils.multihost import initialize_multihost, make_cp_mesh

__all__ = ["entry", "dryrun_multichip", "FLAGSHIP", "DRYRUN"]

# the JAX package's flagship configuration (__graft_entry__.py:12-15)
FLAGSHIP = ModelConfig(vocab=2048, dim=512, layers=2, heads=8, kv_heads=2,
                       head_dim=64, mlp_dim=1408, attention="zigzag")
# the dry run's tiny model (__graft_entry__.py:66-69), float32
DRYRUN = ModelConfig(vocab=128, dim=64, layers=2, heads=4, kv_heads=2,
                     head_dim=16, mlp_dim=128, attention="zigzag",
                     dtype="float32")
# the decode step's model (__graft_entry__.py:323-326), head_dim 16 float32
DECODE = dict(vocab=61, dim=32, layers=2, heads=4, kv_heads=2, mlp_dim=64)
LR = 1e-2
START_TIMEOUT = 120  # seconds for every process to start and report
JOIN_TIMEOUT = 20


def entry(device="cuda", params=None):
    """(fn, (model, tokens, positions)): the flagship forward on one
    device, ``fn(model, tokens, positions)`` the logits (1, 1024, 2048)
    f32. ``params``: the JAX package's ``init_params`` tree with numpy
    leaves, else weights drawn from a ``torch.Generator`` seeded 0."""
    device = resolve_device(device)
    if params is None:
        model = init_params(FLAGSHIP, torch.Generator().manual_seed(0),
                            device=device)
    else:
        model = params_from_jax(params, FLAGSHIP, device=device)
    tokens = torch.zeros((1, 1024), dtype=torch.long, device=device)
    positions = torch.arange(1024, device=device)
    return Transformer.forward, (model, tokens, positions)


# ---------------------------------------------------------------------------
# the dry run


def _cfg(device, **kw):
    """The dry run's model config with ``kw``; on the card in the kernels'
    operands (bf16, head_dim 64)."""
    cfg = dataclasses.replace(DRYRUN, **kw)
    if torch.device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  head_dim=max(64, cfg.head_dim))
    return cfg


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tokens(inputs, name, shape, vocab, seed):
    """The configuration's global token batch: JAX's (``inputs``) or
    drawn from a generator seeded ``seed``."""
    if inputs is not None:
        return torch.as_tensor(np.asarray(inputs[name]["tokens"])).long()
    return torch.randint(0, vocab, shape, generator=_gen(seed))


def _params(inputs, name, cfg):
    """The JAX parameter tree of ``inputs``, or a whole model drawn from a
    generator seeded 0, on the CPU (each rank cuts its part)."""
    if inputs is not None:
        return inputs[name]["params"]
    return init_params(cfg, _gen(0), device="cpu")


def _axis_group(shape, axis, rank):
    """This rank's group along mesh axis ``axis`` of a row-major mesh of
    ``shape``: the ranks that differ from it along that axis alone. Every
    process creates every group of the axis, in one order."""
    coords = np.arange(int(np.prod(shape))).reshape(shape)
    lines = np.moveaxis(coords, axis, -1).reshape(-1, shape[axis])
    mine = None
    for line in lines:
        group = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = group
    return mine


def _chunk(x, index, parts, dim):
    return x.chunk(parts, dim)[index].contiguous()


def _finite(name, loss):
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun {name}: loss {loss} is not finite")
    return loss


def _zigzag_step(model, tokens, row, sp_rank, sp, dev, **groups):
    """One train_step on rank's zigzag chunk of batch row ``row``."""
    toks, labs, pos = prepare_zigzag_batch(tokens, sp)
    toks, labs = (_chunk(x[row:row + 1], sp_rank, sp, 1).to(dev)
                  for x in (toks, labs))
    pos = _chunk(pos, sp_rank, sp, 0).to(dev)
    _, loss = train_step(model, toks, labs, pos, lr=LR, **groups)
    return loss


def _launch_counts():
    """{kernel: launches} of this process's kernel wrappers (the dry run's
    processes report theirs)."""
    from .ops.flash_bwd_cuda import flash_bwd_cuda
    from .ops.flash_bwd_split_cuda import flash_bwd_dkv_cuda, flash_bwd_dq_cuda
    from .ops.flash_fwd_cuda import flash_fwd_cuda
    from .ops.paged_decode_cuda import paged_decode_cuda

    return {"B1 flash_fwd": flash_fwd_cuda.launches,
            "B2 flash_bwd": flash_bwd_cuda.launches,
            "B3a flash_bwd_dq": flash_bwd_dq_cuda.launches,
            "B3b flash_bwd_dkv": flash_bwd_dkv_cuda.launches,
            "B5 paged_decode": paged_decode_cuda.launches}


def _dryrun_rank(rank, world, device, inputs):
    """Every configuration of the dry run on this process; returns
    {name: value} (rank 0's holds every value) and this process's kernel
    launch counts."""
    from .api import llama3_flash_attn_prepare_cu_seqlens
    from .models.serve import _decode_body
    from .ops.paged import PagedKVCache, paged_init, paged_prefill
    from .parallel import llama3_attention
    from .parallel.mesh import all_gather

    dev = resolve_device(device)
    out = {}

    # (1) dp x sp: zigzag ring over sp, the data over dp
    sp = world if world < 4 else world // 2
    dp = world // sp
    cfg = _cfg(device)
    dp_group, sp_group = make_cp_mesh(dp, sp)
    model = shard_params(_params(inputs, "zigzag", cfg), cfg, device=dev)
    tokens = _tokens(inputs, "zigzag", (dp, 8 * sp), cfg.vocab, 1)
    out["zigzag"] = _finite("zigzag", _zigzag_step(
        model, tokens, rank // sp, rank % sp, sp, dev, sp_group=sp_group,
        data_group=dp_group))
    if world < 8:
        return out, _launch_counts()

    # (2) dp x hp x sp: USP, the sequence contiguous over (sp major, hp
    # minor), the labels shifted, positions global
    dp3, hp3, sp3 = world // 4, 2, 2
    shape = (dp3, hp3, sp3)
    groups = {k: _axis_group(shape, a, rank)
              for k, a in (("data_group", 0), ("ulysses_group", 1),
                           ("sp_group", 2))}
    d_i, h_i, s_i = np.unravel_index(rank, shape)
    cfg = _cfg(device, attention="usp")
    model = shard_params(_params(inputs, "usp", cfg), cfg, device=dev)
    s_global = 16 * hp3 * sp3
    tokens = _tokens(inputs, "usp", (dp3, s_global), cfg.vocab, 2)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    c, n = s_i * hp3 + h_i, hp3 * sp3
    toks, labs = (_chunk(x[d_i:d_i + 1], c, n, 1).to(dev)
                  for x in (tokens, labels))
    pos = _chunk(torch.arange(s_global), c, n, 0).to(dev)
    _, loss = train_step(model, toks, labs, pos, lr=LR, **groups)
    out["usp"] = _finite("usp", loss)

    # (3) dp x tp x sp: Megatron TP over tp, the zigzag ring over sp
    dp4, tp4, sp4 = world // 4, 2, 2
    shape = (dp4, tp4, sp4)
    groups = {k: _axis_group(shape, a, rank)
              for k, a in (("data_group", 0), ("tp_group", 1),
                           ("sp_group", 2))}
    d_i, t_i, s_i = np.unravel_index(rank, shape)
    cfg = _cfg(device)
    model = shard_params(_params(inputs, "tp", cfg), cfg, tp_rank=int(t_i),
                         tp=tp4, device=dev)
    tokens = _tokens(inputs, "tp", (dp4, 8 * sp4), cfg.vocab, 3)
    out["tp"] = _finite("tp", _zigzag_step(model, tokens, int(d_i), int(s_i),
                                           sp4, dev, **groups))

    # (4) pp x sp: GPipe stages of the zigzag ring's layers, 2 microbatches
    pp5, sp5, m5 = 2, world // 2, 2
    pp_group, sp_group = make_cp_mesh(pp5, sp5)
    cfg = _cfg(device, layers=4)
    model = stack_layers(_params(inputs, "gpipe", cfg), cfg,
                         pp_rank=rank // sp5, pp=pp5, device=dev)
    tokens = _tokens(inputs, "gpipe", (2 * m5, 8 * sp5), cfg.vocab, 4)
    toks, labs, pos = prepare_zigzag_batch(tokens, sp5)
    toks, labs = (_chunk(x, rank % sp5, sp5, 1).to(dev) for x in (toks, labs))
    pos = _chunk(pos, rank % sp5, sp5, 0).to(dev)
    _, loss = train_step_pp(model, toks, labs, pos, pp_group, m5, lr=LR,
                            sp_group=sp_group)
    out["gpipe"] = _finite("gpipe", loss)

    # (5) ep x sp: switch MoE, the experts and the batch over ep
    ep6, sp6 = 2, world // 2
    ep_group, sp_group = make_cp_mesh(ep6, sp6)
    cfg = _cfg(device, moe_experts=4, moe_capacity_factor=4.0)
    model = shard_params(_params(inputs, "moe", cfg), cfg,
                         ep_rank=rank // sp6, ep=ep6, device=dev)
    tokens = _tokens(inputs, "moe", (ep6, 8 * sp6), cfg.vocab, 5)
    out["moe"] = _finite("moe", _zigzag_step(
        model, tokens, rank // sp6, rank % sp6, sp6, dev, sp_group=sp_group,
        ep_group=ep_group))

    # (6) llama3 varlen over sp = world: sum(out^2)'s gradients
    l7 = 8
    s7 = l7 * world
    hq7, hkv7, d7 = 4, 2, _cfg(device).head_dim
    dtype = _cfg(device).torch_dtype
    if inputs is not None:
        q7, k7, v7 = (torch.as_tensor(np.asarray(inputs["llama3"][n]))
                      for n in ("q", "k", "v"))
    else:
        q7, k7, v7 = (torch.randn(shape, generator=_gen(seed)) for shape, seed
                      in (((1, hq7, s7, d7), 6), ((1, hkv7, s7, d7), 7),
                          ((1, hkv7, s7, d7), 8)))
    cu7 = np.asarray([0, 10, s7], np.int32)
    cu_q, cu_k, _, _, k_slice = llama3_flash_attn_prepare_cu_seqlens(
        cu7, True, rank, world)
    seg_local = np.searchsorted(cu_q, np.arange(l7), side="right") - 1
    seg = torch.as_tensor(k_slice.start + cu_k[seg_local], dtype=torch.int32,
                          device=dev)
    leaves = [_chunk(x, rank, world, 2).to(dev, dtype).requires_grad_()
              for x in (q7, k7, v7)]
    o, _ = llama3_attention(*leaves, seg, scale=d7 ** -0.5, causal=True,
                            heads_k_stride=1)
    grads = torch.autograd.grad((o.float() ** 2).sum(), leaves)
    for name, g in zip(("dq", "dk", "dv"), grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"dryrun llama3: {name} is not finite")
        out[f"llama3/{name}"] = all_gather(g.detach().float(), 2).cpu().numpy()

    # (7) a tensor-parallel paged decode step over tp = 2 (ranks 0 and 1):
    # sharded weights, the caches' kv heads split (on the card at B5's
    # head_dim, 128)
    tp8 = 2
    group = dist.new_group(list(range(tp8)))
    if rank < tp8:
        cfg = _cfg(device, **DECODE)
        if dev.type == "cuda":
            cfg = dataclasses.replace(cfg, head_dim=128)
        b8, ps, pps = 2, 8, 4
        caches = []
        if inputs is not None:
            caches = [PagedKVCache(*(torch.as_tensor(np.asarray(x))
                                     for x in c))
                      for c in inputs["decode"]["caches"]]
        else:
            tables = torch.arange(b8 * pps, dtype=torch.int32).reshape(b8,
                                                                        pps)
            for li in range(cfg.layers):
                c = paged_init(cfg.kv_heads, b8 * pps, ps, cfg.head_dim,
                               tables, dtype=cfg.torch_dtype, device="cpu")
                kk = torch.randn((b8, cfg.kv_heads, ps, cfg.head_dim),
                                 generator=_gen(9 + li)).to(cfg.torch_dtype)
                caches.append(paged_prefill(c, kk, kk, torch.tensor(
                    [ps - 2, 3], dtype=torch.int32)))
        h = cfg.kv_heads // tp8
        caches = [PagedKVCache(
            c.k_pages[:, rank * h:(rank + 1) * h].to(dev, cfg.torch_dtype),
            c.v_pages[:, rank * h:(rank + 1) * h].to(dev, cfg.torch_dtype),
            c.block_tables.to(dev), c.seq_lens.to(dev)) for c in caches]
        model = shard_params(_params(inputs, "decode", cfg), cfg,
                             tp_rank=rank, tp=tp8, device=dev)
        with torch.no_grad():
            logits, _ = _decode_body(
                model, torch.tensor([5, 9], device=dev),
                torch.tensor([True, True], device=dev), caches,
                tp_group=group)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("dryrun decode: logits are not finite")
        out["decode"] = logits.float().cpu().numpy()
    return out, _launch_counts()


def _worker(rank, world, port, device, inputs, results):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize_multihost(init_method=f"tcp://localhost:{port}",
                             world_size=world, rank=rank, device=device)
        try:
            out = _dryrun_rank(rank, world, device, inputs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except Exception:  # reported to the parent, which raises
        results.put((rank, None, traceback.format_exc()))


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, device, inputs):
    """[(values, launch counts) of rank 0, ..., of rank world - 1] of
    ``world`` spawned processes; raises on a process's error or when the
    processes do not all report in time (the stragglers are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, device, inputs, results),
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
                    errors.append(f"process {pr.pid} did not exit in "
                                  f"{JOIN_TIMEOUT} s and was killed")
    if errors:
        raise RuntimeError(f"dryrun_multichip({world}) failed:\n"
                           + "\n".join(errors))
    return [got[r] for r in range(world)]


def dryrun_multichip(n_devices, device="cuda", inputs=None,
                     return_launches=False):
    """One training step of each of JAX's dry-run configurations over
    ``n_devices`` processes (see the module docstring); prints one line a
    configuration and returns {name: value}. On the card (the default) it
    needs a card for each process and raises without them; ``device="cpu"``
    runs gloo processes. With ``return_launches`` also {kernel: launches} of
    every process summed."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(device)
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip({n_devices}, 'cuda') needs "
                             f"{n_devices} cards, the host has "
                             f"{torch.cuda.device_count()}")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    ranks = _spawn(n_devices, device, inputs)
    values = ranks[0][0]
    n = n_devices
    sp = n if n < 4 else n // 2
    lines = [("zigzag", f"mesh dp={n // sp} sp={sp}"),
             ("usp", f"mesh dp={n // 4} hp=2 sp=2 (USP)"),
             ("tp", f"mesh dp={n // 4} tp=2 sp=2 (megatron TP)"),
             ("gpipe", f"mesh pp=2 sp={n // 2} (GPipe)"),
             ("moe", f"mesh ep=2 sp={n // 2} (switch MoE)")]
    for name, mesh in lines:
        if name in values:
            print(f"dryrun_multichip({n}): {mesh} "
                  f"loss={values[name]:.4f} OK")
    if "llama3/dq" in values:
        print(f"dryrun_multichip({n}): mesh sp={n} "
              f"(llama3 varlen fwd+bwd) OK")
        print(f"dryrun_multichip({n}): mesh tp=2 (GSPMD paged decode) OK")
    if not return_launches:
        return values
    launches = {}
    for _, counts in ranks:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return values, launches
