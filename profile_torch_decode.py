#!/usr/bin/env python3
"""The decode kernels (B5 on bf16 pages, B6 on quantized pages, B4 on a
contiguous quantized cache) on one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_decode.py [--root DIR] [--rounds N] [--only TEXT]

``--root`` imports ``ring_flash_attn_tpu_torch`` from another checkout (for
example the parent commit unpacked beside this one), so that two trees are
timed by the same code in one machine session: run parent, change, change,
parent. ``--only TEXT`` (repeatable) times only the step-3 readings whose
name holds TEXT, skips step 2 and skips step 4 unless a TEXT is "row
groups".

1. Builds the kernels and prints ptxas's registers, spills and shared memory
   of every instantiation of the decode kernels.
2. Prints a sha256 digest of B4's (out, lse) on ``chip_smoke.py`` phase 7's
   inputs, of B6's on phase 8's (the same seeds and the same order of
   draws) and of B5's on the serving table's shape with and without
   new_counts: two trees whose digests agree give the same bits.
3. Times, ``rounds`` times in turns: B5 at the serving table's shape (q
   (8,32,1,128) bf16, lens 0 to 4096, pages of 256), at the engine's 4
   lanes, with R = 16 (Tq = 4, new_counts) and on 4 x 8192 tokens in pages
   of 256; B6 on the same 4 x 8192 tokens in int8; B4 at B=1, S=32768 int8
   (the prompt cache of ``generate``'s decode step) and on its 32-token
   tail cache at length 32 (the other half of B4's launches there).
   Each reading is ``chip_smoke.kernel_ms``'s: ``ms`` between CUDA events
   around the call and ``dev``, the profiler's device time of what the call
   launches, the L2 flushed before each call by writing 256 MB; B4 and B6
   once more with the L2 flushed by reading them (ReadFlush), which leaves
   no dirty line whose write-back lands in the kernel's time; beside each,
   the least time the card could take (bytes). Then the same at head dims
   64 and 256 (``WIDE_ROWS``): B5 on the decode sub-table's ragged lanes
   (0, 1, 3000 and 8192 tokens in pages of 256) at Llama-3.2-1B's 32/8
   heads of 64 and Gemma-7B's 16/16 of 256, on the same tokens in four
   equal lanes and on the engine's 4 lanes; B4 on the sub-table's cache
   (B=2, S=8192, length 8000) at both, over ``generate``'s prompt cache at
   64 (B=1, S=32768) and on the 32-token tail cache at both; B6 at
   Gemma-2B's 8/1 heads of 256. A digest of their outputs is printed
   before they are timed. Then the row-tile loop (``RG_CASES``, "RG" in
   their names; ``--only RG`` times them alone): B5 at StarCoder's 48/1
   heads of 128 on the engine's 4 lanes and at its k = 4 verify (192
   rows), B5 at the Llama-3-8B k = 8 verify (32 rows), B4 over
   ``generate``'s StarCoder prompt cache and its 32-token tail, and
   ``chip_smoke.DECODE_CASES``' StarCoder (B4, B5), StarCoder Tq=5 (B5)
   and Falcon-7B Tq=5 (B6) cases, with a digest of their outputs.

4. Where the tree has row groups (past the rows one block serves): traces
   B6 at Falcon-7B's 355 rows and B5 at StarCoder's 240 rows
   (``chip_smoke.DECODE_CASES``, lanes of 0, 1, 3000 and 8192 tokens) at
   the launcher's grid (``paged_plan_grid``; splits a group,
   ``paged_num_splits``, in a tree before the device's work plan) and at
   others forced on the launcher (FORCED_SPLITS splits in such a tree; a
   block a group, no split, in a tree with the device's plan, whose grid
   must hold a block a group): each held against the plain version, with the launch as
   torch.profiler records it (grid, threads, registers, shared memory,
   its estimate of occupancy), the blocks an SM can hold by those, the
   chunks a pipeline walks on the longest lane, and the kernel's time.

Correctness is ``chip_smoke.py``'s (phases 3, 7, 8) and
``tests/test_torch_cuda.py``'s. Prints the card's name and power limit
first.
"""

import collections
import hashlib
import importlib
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    DECODE_CASES, DECODE_LENS, H100_BYTES_PER_S, _b5_bound_ms,
    _decode_bound_ms, decode_case_inputs, kernel_ms, log, profile_loop)

LOOP = ("B5 paged_decode", "B6 paged_quant_decode", "B4 quant_decode")
PIECES = ("decode_kernel",)
# step 4: (kernel, its launcher's module, a DECODE_CASES case) and the
# splits forced beside the plan's
ROW_GROUP_CASES = (("B6", "paged_quant_decode_cuda",
                    "Falcon-7B Tq=5 (355 rows)"),
                   ("B5", "paged_decode_cuda", "StarCoder Tq=5 (240 rows)"))
FORCED_SPLITS = (1, 2, 4, 8, 16, 32)
LAUNCH_ARGS = ("grid", "block", "registers per thread", "shared memory",
               "blocks per SM", "warps per SM", "est. achieved occupancy %")


def _digest(torch, pairs):
    """sha256 of the bytes of every (out, lse) in pairs, in order."""
    h = hashlib.sha256()
    torch.cuda.synchronize()
    for out, lse in pairs:
        h.update(out.cpu().numpy().tobytes())
        h.update(lse.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(torch):
    """B4 on phase 7's inputs and B6 on phase 8's (chip_smoke.py): the
    same generators, seeds and order of draws."""
    from ring_flash_attn_tpu_torch.ops import paged as P
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import quantize_kv
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    dev = torch.device("cuda")
    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5

    gen = torch.Generator(device=dev).manual_seed(7)

    def cache_of(b, s, qdtype):
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev)
        return quantize_kv(k, v, qdtype)

    def q_of(b, tq=1, dtype=torch.bfloat16):
        return torch.randn((b, hq, tq, d), generator=gen,
                           device=dev).to(dtype)

    big = cache_of(1, 32768, "int8")
    q1 = q_of(1)
    len_t = torch.tensor([20000], dtype=torch.int32, device=dev)
    cases = [
        (q1, big, 32768, None), (q1, big, 30001, None), (q1, big, 0, None),
        (q1, big, len_t, None), (q1, big, 32768, 12.0),
        (q1, cache_of(1, 32768, "fp8_e4m3"), 32768, None),
        (q1, cache_of(1, 32768, "fp8_e5m2"), 30001, None),
        (q_of(2, dtype=torch.float32), cache_of(2, 4096, "int8"), 4000, None),
        (q_of(1, tq=2), cache_of(1, 1280, "int8"), 1280, None),
        (q1, cache_of(1, 32, "int8"), 7, None),
    ]
    b4 = _digest(torch, [quant_decode_cuda(
        q, c.k_q, c.k_scale, c.v_q, c.v_scale, n, scale, softcap=cap)
        for q, c, n, cap in cases])
    del big, cases

    gen = torch.Generator(device=dev).manual_seed(8)
    lens = [0, 1, 255, 256, 257, 1000, 4095, 4096]
    b, ps, pps = len(lens), 256, 16
    perm = np.random.default_rng(8).permutation(b * pps).astype(np.int32)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    k, v = rnd(b, hkv, pps * ps, d), rnd(b, hkv, pps * ps, d)
    q1, q2 = rnd(b, hq, 1, d).to(torch.bfloat16), rnd(b, hq, 2, d)
    outs = []
    for qdtype in ("int8", "fp8_e4m3", "fp8_e5m2"):
        c = P.paged_quant_init(b, hkv, b * pps, ps, pps, d, qdtype=qdtype,
                               block_tables=perm.reshape(b, pps))
        c = P.paged_quant_prefill(c, k, v, lens)
        for q, cap in ((q1, None), (q2, 30.0)):
            outs.append(paged_quant_decode_cuda(
                q, c.k_pages, c.k_scales, c.v_pages, c.v_scales,
                c.block_tables, c.seq_lens, scale, softcap=cap))
    b6 = _digest(torch, outs)
    del outs, c, k, v

    # B5 at the serving table's shape, bf16 q, then Tq = 4 with new_counts
    gen = torch.Generator(device=dev).manual_seed(2)
    tables = torch.as_tensor(perm.reshape(b, pps), device=dev)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    kp = rnd(b * pps, hkv, ps, d).to(torch.bfloat16)
    vp = rnd(b * pps, hkv, ps, d).to(torch.bfloat16)
    counts = torch.tensor([3, 1, 4, 4, 2, 4, 4, 4], dtype=torch.int32,
                          device=dev)
    b5 = _digest(torch, [
        paged_decode_cuda(rnd(b, hq, 1, d).to(torch.bfloat16), kp, vp,
                          tables, seq, scale),
        paged_decode_cuda(rnd(b, hq, 4, d).to(torch.bfloat16), kp, vp,
                          tables, seq, scale, new_counts=counts)])
    log(f"  digests of (out, lse): B4 on phase 7's inputs {b4}, B6 on "
        f"phase 8's inputs {b6}, B5 at the table's shape {b5}")
    return b4, b6, b5


class ReadFlush:
    """A flush for kernel_ms that leaves the L2 clean: its zero_() reads
    256 MB. The usual flush, a 256 MB tensor whose zero_() writes them,
    leaves dirty lines in the L2 whose write-back lands in the next
    kernel's time, which weighs on the decode kernels (tens of
    microseconds) alone."""

    def __init__(self, torch):
        self.buf = torch.empty(64 * 2**20, dtype=torch.float32,
                               device="cuda")

    def zero_(self):
        self.buf.sum()


def _launch_args(torch, fn):
    """The decode kernel's launch in fn() as torch.profiler's Chrome trace
    records it: {LAUNCH_ARGS key: value} of its first such event."""
    from ring_flash_attn_tpu_torch.utils.trace_timing import (
        _profiled, _trace_files)

    def cycle():
        fn()
        torch.cuda.synchronize()

    logdir = _profiled(cycle)
    try:
        for file in _trace_files(logdir):
            with open(file) as f:
                trace = json.load(f)
            for ev in trace["traceEvents"]:
                if (ev.get("cat") == "kernel"
                        and "decode_kernel" in ev.get("name", "")):
                    args = ev.get("args") or {}
                    return {k: args[k] for k in LAUNCH_ARGS if k in args}
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return {}


def _lane_chunks(tokens, page):
    """The 64-token chunks of a lane of ``tokens`` tokens in pages of
    ``page`` (a chunk never spans a page: csrc/quant_decode.cuh::
    paged_src)."""
    if tokens <= 0:
        return 0
    full = (tokens - 1) // page
    return full * -(-page // 64) + -(-(tokens - full * page) // 64)


def row_group_trace(torch, flush):
    """Step 4: each ROW_GROUP_CASES case at the plan's splits and at
    FORCED_SPLITS (the launcher's grid function replaced for the call),
    held against its plain version and timed."""
    from chip_smoke import (
        DECODE_CASES, DECODE_LENS, DECODE_S, decode_case_inputs, max_err)
    from ring_flash_attn_tpu_torch.ops import quant_decode_cuda as Q

    # the launcher's blocks (a tree before the device's work plan: its
    # splits a group)
    grid = ("paged_plan_grid" if hasattr(Q, "paged_plan_grid")
            else "paged_num_splits")
    for kernel, module, name in ROW_GROUP_CASES:
        mod = importlib.import_module("ring_flash_attn_tpu_torch.ops."
                                      + module)
        case = next(c for c in DECODE_CASES if c[0] == name)
        _, d, hq, hkv, tq, _, _, page = case
        nrg, rows = Q.row_groups(hq // hkv * tq, d)
        b = len(DECODE_LENS)
        # a tree whose row-tile loop runs in clusters takes whole clusters
        cs = getattr(Q, "TILE_CLUSTER", 1)
        kw = {"tiles": True} if cs > 1 else {}
        plan = getattr(Q, grid)(b, hkv, DECODE_S // page, page, nrg, **kw)
        chunks = [(Q.tile_chunks(n, page) if kw else _lane_chunks(n, page))
                  for n in DECODE_LENS]
        run, plain, tol, (bound, by), what = decode_case_inputs(
            torch, case, kernel)
        log(f"  row groups: {kernel} {name} (D={d}, {what}): {nrg} row "
            f"groups of {rows} rows a kv head, {b * hkv * nrg} groups; the "
            f"lanes' chunks {chunks}; the launcher's {grid} {plan}; bound "
            f"{bound:.5f} ms ({by})")
        real = getattr(mod, grid)
        # a tree with the device's plan takes a block a group at least
        forced = (FORCED_SPLITS if grid == "paged_num_splits"
                  else (b * hkv * nrg * cs,))
        try:
            for n in sorted({plan, *forced}):
                setattr(mod, grid, lambda *_, n=n: n)
                got, ref = run(), plain()
                err = max(max_err(x, y) for x, y in zip(got, ref))
                if not err <= tol:
                    raise AssertionError(f"{kernel} {name} at {n} splits: "
                                         f"error {err:.3e} (tol {tol})")
                args = _launch_args(torch, run)
                threads = args.get("block", [0])[0]
                regs = args.get("registers per thread", 0)
                smem = args.get("shared memory", 0)
                # an SM's 65536 registers and 228 KB of shared memory (1 KB
                # of it reserved a block) over the block's; a pipeline is
                # five warps (quant_decode.cuh::nthreads)
                live = (min(65536 // (regs * threads),
                            228 * 1024 // (smem + 1024))
                        if regs and threads else None)
                pipes = threads // 160 if threads else 1
                t = kernel_ms(torch, run, 20, flush)
                log(f"    {n} split(s){' (plan)' if n == plan else ''}: "
                    f"dev {t['device_ms']:.4f} ms, ms {t['ms']:.4f} "
                    f"({t['device_ms'] / bound:.1f}x the bound); error "
                    f"{err:.2e}; launch {args}; blocks an SM can hold "
                    f"{live}; chunks a pipeline walks on the longest lane "
                    f"{-(-max(chunks) // (n * pipes))}")
        finally:
            setattr(mod, grid, real)


# step 3 at head dims 64 and 256: (name, DECODE_CASES case, head dim, Hq,
# Hkv) of the decode sub-table's cases (PERF.md) and the models they come
# from; the engine's 4 lanes (phase 4's traffic after 16 tokens, as the
# head_dim 128 reading) and the sub-table's tokens in four equal lanes
WIDE_CASES = {"D64": 0, "D256": 6}  # Llama-3.2-1B, Gemma-7B
ENGINE_LENS = [3016, 1216, 2616, 316]
EQUAL_LENS = [2798, 2798, 2798, 2799]  # sum(DECODE_LENS) in four lanes


def _b5_lanes(torch, gen, hq, hkv, d, lens, pps, page=256):
    """B5's inputs on lanes of ``lens`` tokens, ``pps`` pages of ``page`` a
    lane in shuffled pages: (q bf16, k_pages, v_pages, tables, seq_lens)."""
    dev = torch.device("cuda")
    b = len(lens)
    tables = torch.as_tensor(np.random.default_rng(d).permutation(
        b * pps).astype(np.int32).reshape(b, pps), device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    return (rnd(b, hq, 1, d), rnd(b * pps, hkv, page, d),
            rnd(b * pps, hkv, page, d), tables,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def wide_rows(torch):
    """Step 3's readings at head dims 64 and 256: {name: (call, bound
    ms)}, the bound from ``chip_smoke._decode_bound_ms``."""
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import quantize_kv
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for fam, i in WIDE_CASES.items():
        case = DECODE_CASES[i]
        name, d, hq, hkv, _, _, cap, page = case
        scale = d ** -0.5
        run, _, _, (bound, _), _ = decode_case_inputs(torch, case, "B5", i)
        rows[f"B5 {fam} {name} lanes {DECODE_LENS}"] = (run, bound)
        for what, lens, pps in (("equal lanes", EQUAL_LENS, 32),
                                ("engine 4 lanes", ENGINE_LENS, 16)):
            q, kp, vp, tables, seq = _b5_lanes(torch, gen, hq, hkv, d, lens,
                                               pps, page)
            rows[f"B5 {fam} {what} {lens}"] = (
                lambda q=q, kp=kp, vp=vp, t=tables, s=seq, sc=scale, c=cap:
                paged_decode_cuda(q, kp, vp, t, s, sc, softcap=c),
                _decode_bound_ms(q, sum(lens), hkv, 2, False,
                                 tables.numel())[0])
        run, _, _, (bound, _), what = decode_case_inputs(torch, case, "B4", i)
        rows[f"B4 {fam} {name} {what}"] = (run, bound)
        shapes = [(1, 32, 32)] if d == 256 else [(1, 32768, 32768),
                                                 (1, 32, 32)]
        for b, s, n in shapes:
            c = quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                        device=dev),
                            torch.randn((b, hkv, s, d), generator=gen,
                                        device=dev), "int8")
            q = torch.randn((b, hq, 1, d), generator=gen,
                            device=dev).to(torch.bfloat16)
            label = "tail" if s == 32 else "prompt cache"
            rows[f"B4 {fam} {label} B={b} S={s} int8"] = (
                lambda q=q, c=c, n=n, sc=scale: quant_decode_cuda(
                    q, c.k_q, c.k_scale, c.v_q, c.v_scale, n, sc),
                _decode_bound_ms(q, b * n, hkv, 1, True)[0])
    i = 7  # Gemma-2B (8 rows) at 256
    run, _, _, (bound, _), what = decode_case_inputs(
        torch, DECODE_CASES[i], "B6", i)
    rows[f"B6 D256 {DECODE_CASES[i][0]} {what}"] = (run, bound)
    return rows


# the row-tile loop's readings (RG: past MAX_ROWS rows a kv head) at the
# shapes that give its launches: StarCoder's 48/1 heads of 128 on the
# engine's 4 lanes and its k = 4 verify (4 x 48 = 192 rows, phase 24),
# the default Llama-3-8B widths' k = 8 verify (4 x 8 = 32 rows, phase
# 19), generate's StarCoder prompt cache (8192 tokens) and its 32-token
# tail, and chip_smoke.DECODE_CASES' 48, 240 and 355 rows
RG_CASES = ("StarCoder (48 rows)", "StarCoder Tq=5 (240 rows)",
            "Falcon-7B Tq=5 (355 rows)")


def rg_rows(torch):
    """{name: (call, bound ms)} of the RG readings, the bound from
    ``chip_smoke._decode_bound_ms``."""
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import quantize_kv
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = {}
    for name, hq, hkv, tq in (("StarCoder engine 4 lanes (48 rows)", 48, 1,
                               1),
                              ("StarCoder k=4 verify (192 rows)", 48, 1, 4),
                              ("Llama-3-8B k=8 verify (32 rows)", 32, 8, 8)):
        d = 128
        q, kp, vp, tables, seq = _b5_lanes(torch, gen, hq, hkv, d,
                                           ENGINE_LENS, 16)
        q = torch.randn((len(ENGINE_LENS), hq, tq, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        counts = None if tq == 1 else torch.full(
            (len(ENGINE_LENS),), tq, dtype=torch.int32, device=dev)
        rows[f"RG B5 {name} lanes {ENGINE_LENS}"] = (
            lambda q=q, kp=kp, vp=vp, t=tables, s=seq, c=counts:
            paged_decode_cuda(q, kp, vp, t, s, d ** -0.5, new_counts=c),
            _decode_bound_ms(q, sum(ENGINE_LENS), hkv, 2, False,
                             tables.numel())[0])
    for s in (8192, 32):
        c = quantize_kv(torch.randn((1, 1, s, 128), generator=gen,
                                    device=dev),
                        torch.randn((1, 1, s, 128), generator=gen,
                                    device=dev), "int8")
        q = torch.randn((1, 48, 1, 128), generator=gen,
                        device=dev).to(torch.bfloat16)
        label = "tail S=32" if s == 32 else "prompt cache S=8192"
        rows[f"RG B4 StarCoder generate {label} int8 (48 rows)"] = (
            lambda q=q, c=c, s=s: quant_decode_cuda(
                q, c.k_q, c.k_scale, c.v_q, c.v_scale, s, 128 ** -0.5),
            _decode_bound_ms(q, s, 1, 1, True)[0])
    for kernel, name in (("B4", RG_CASES[0]), ("B5", RG_CASES[0]),
                         ("B5", RG_CASES[1]), ("B6", RG_CASES[2])):
        i = next(j for j, c in enumerate(DECODE_CASES) if c[0] == name)
        run, _, _, (bound, _), what = decode_case_inputs(
            torch, DECODE_CASES[i], kernel, i)
        rows[f"RG {kernel} {name} {what}"] = (run, bound)
        if DECODE_CASES[i][6]:  # the same without the softcap
            case = DECODE_CASES[i][:6] + (None,) + DECODE_CASES[i][7:]
            run, _, _, (bound, _), what = decode_case_inputs(
                torch, case, kernel, i)
            rows[f"RG {kernel} {name} {what}, no softcap"] = (run, bound)
    return rows


def timings(torch, args):
    from ring_flash_attn_tpu_torch.ops import paged as P
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import quantize_kv
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    if not args.only:  # head_dim 128's digests
        digests(torch)
    rounds = args.rounds
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # the serving table's shape (chip_smoke.py phase 3)
    lens = [0, 1, 255, 256, 257, 1000, 4095, 4096]
    b, ps, pps = len(lens), 256, 16
    tables = torch.as_tensor(np.random.default_rng(2).permutation(
        b * pps).astype(np.int32).reshape(b, pps), device=dev)
    kp = rnd(b * pps, hkv, ps, d).to(torch.bfloat16)
    vp = rnd(b * pps, hkv, ps, d).to(torch.bfloat16)
    seq = torch.tensor(lens, dtype=torch.int32, device=dev)
    eng = torch.tensor([3016, 1216, 2616, 316], dtype=torch.int32,
                       device=dev)
    counts = torch.tensor([3, 1, 4, 4, 2, 4, 4, 4], dtype=torch.int32,
                          device=dev)
    q8 = rnd(b, hq, 1, d).to(torch.bfloat16)
    q4 = rnd(4, hq, 1, d).to(torch.bfloat16)
    q16 = rnd(b, hq, 4, d).to(torch.bfloat16)

    # 4 lanes of 8192 tokens (phase 8's timed shape), bf16 and int8 pages
    b3, ctx = 4, 8192
    k, v = rnd(b3, hkv, ctx, d), rnd(b3, hkv, ctx, d)
    n = b3 * ctx // ps
    tbl = np.random.default_rng(ps).permutation(n).astype(np.int32).reshape(
        b3, -1)
    full = [ctx] * b3
    bf = P.paged_prefill(P.paged_init(hkv, n, ps, d, tbl), k, v, full)
    qc = P.paged_quant_prefill(
        P.paged_quant_init(b3, hkv, n, ps, n // b3, d, block_tables=tbl),
        k, v, full)
    qq = rnd(b3, hq, 1, d).to(torch.bfloat16)
    del k, v
    # B4 at B=1, S=32768 int8 (phase 7's timed shape)
    big = quantize_kv(rnd(1, hkv, 32768, d), rnd(1, hkv, 32768, d), "int8")
    q1 = rnd(1, hq, 1, d).to(torch.bfloat16)
    tail = quantize_kv(rnd(1, hkv, 32, d), rnd(1, hkv, 32, d), "int8")

    def b4_bound(tokens):
        return ((2 * tokens * hkv * d + 8 * tokens * hkv)
                / H100_BYTES_PER_S * 1e3)

    fns = {
        "B5 table shape": (lambda: paged_decode_cuda(
            q8, kp, vp, tables, seq, scale), _b5_bound_ms(
            q8, sum(lens), hkv, tables)),
        "B5 engine 4 lanes": (lambda: paged_decode_cuda(
            q4, kp, vp, tables[:4], eng, scale), _b5_bound_ms(
            q4, int(eng.sum()), hkv, tables[:4])),
        "B5 R=16 (Tq=4, new_counts)": (lambda: paged_decode_cuda(
            q16, kp, vp, tables, seq, scale, new_counts=counts),
            _b5_bound_ms(q16, sum(lens), hkv, tables)),
        "B5 4 x 8192 bf16": (lambda: paged_decode_cuda(
            qq, bf.k_pages, bf.v_pages, bf.block_tables, bf.seq_lens, scale),
            _b5_bound_ms(qq, b3 * ctx, hkv, bf.block_tables)),
        "B6 4 x 8192 int8": (lambda: paged_quant_decode_cuda(
            qq, qc.k_pages, qc.k_scales, qc.v_pages, qc.v_scales,
            qc.block_tables, qc.seq_lens, scale),
            (2 * qc.k_pages.numel() + 8 * qc.k_scales.numel())
            / H100_BYTES_PER_S * 1e3),
        "B4 S=32768 int8": (lambda: quant_decode_cuda(
            q1, big.k_q, big.k_scale, big.v_q, big.v_scale, 32768, scale),
            b4_bound(32768)),
        "B4 tail S=32 int8": (lambda: quant_decode_cuda(
            q1, tail.k_q, tail.k_scale, tail.v_q, tail.v_scale, 32, scale),
            b4_bound(32)),
    }
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    clean = ReadFlush(torch)
    for name in ("B4 S=32768 int8", "B6 4 x 8192 int8"):
        if name in fns:
            fns[name + ", L2 flushed by reading"] = fns[name]
    wide = wide_rows(torch)
    log("  digest of (out, lse) at head dims 64 and 256: " + _digest(
        torch, [fn() for fn, _ in wide.values()]))
    fns.update(wide)
    rg = rg_rows(torch)
    log("  digest of (out, lse) of the RG readings: " + _digest(
        torch, [fn() for fn, _ in rg.values()]))
    fns.update(rg)
    if args.only:
        fns = {k: f for k, f in fns.items() if any(t in k for t in args.only)}
    times = collections.defaultdict(list)
    for _ in range(rounds):
        for name, (fn, _) in fns.items():
            times[name].append(kernel_ms(
                torch, fn, 20, clean if "by reading" in name else flush))
    for name, ts in times.items():
        bound = fns[name][1]
        best = min(t["device_ms"] for t in ts)
        log(f"  {name}: ms " + ", ".join(f"{t['ms']:.4f}" for t in ts)
            + "; dev " + ", ".join(f"{t['device_ms']:.4f}" for t in ts)
            + f"; bound {bound:.5f} ms, dev {best / bound:.1f}x it")
    from ring_flash_attn_tpu_torch.ops import quant_decode_cuda as Q

    # the tree serves past one block's rows
    if hasattr(Q, "row_groups") and (
            not args.only or any("row groups" in t for t in args.only)):
        row_group_trace(torch, flush)
    return times


def _arguments(ap):
    ap.add_argument("--only", action="append", default=[], metavar="TEXT",
                    help="time only the step-3 readings whose name holds "
                    "TEXT (step 4 only for 'row groups')")


if __name__ == "__main__":
    sys.exit(profile_loop("profile_torch_decode.py", LOOP, PIECES, timings,
                          _arguments))
