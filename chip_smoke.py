#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ring_flash_attn_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Environment (torch, CUDA, nvcc, triton, the card's name and power limit)
   and the build of every ``csrc/*.cu`` with nvcc for sm_90a.
2. Kernel B1 (flash forward) against its plain version in bf16, at the
   serving and training paths' shapes among others, then timed at the
   causal S=8192 shape beside its flop bound and
   ``F.scaled_dot_product_attention`` (timed only, never used by the port).
3. Kernel B5 (paged decode) against its plain version: 8 lanes of ragged
   lengths over shuffled block tables, plain, with softcap, and with
   new_counts; timed beside its byte bound.
4. The ServingEngine at Llama-3-8B widths with 4 layers and seeded random
   weights: the first prefill and first decode-step logits of the kernels
   against the plain versions on the card, then 6 requests (two queue, one
   is admitted with prefix_of=, one is forked) served with the kernels,
   with the launch count of each kernel on that run, and the same traffic
   served by the plain versions for token agreement.
5. Kernels B2 (fused flash backward) and B3a/B3b (split backward) against
   their plain version in bf16, in the single-call mode (delta=None, bf16
   gradients) and the ring mode (delta given, fp32 gradients), at the
   training path's shapes among others (S=8192 whole; the last 512 q rows
   of S=36864); B3 bitwise reproducible; ``flash_attention`` picking B3
   past the fused limit (Skv = 36864, D = 128); timed at the causal S=8192
   shape beside their flop bounds, the plain version and the backward of
   ``F.scaled_dot_product_attention`` (timed only, never used by the port).
6. Training at the same widths (4 layers, seeded random weights): loss and
   every parameter's gradient of the kernels against the plain versions at
   S=2048, then the main path: 3 ``train_step``s at S=8192 and one at
   S=36864 (past the fused limit), with each kernel's launch count over
   that run; then one S=8192 step under ``torch.profiler``.

Prints the card's name and power limit, then one JSON line with every
kernel's numbers, then ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero, printing no result, without CUDA or without the package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
B1_OUT_TOL, B1_LSE_TOL = 2e-2, 1e-3  # bf16 P in P@V, bf16 out
B5_TOL = 2e-3  # fp32 math on both sides; only the summation order differs
LOGITS_REL_TOL = 5e-2  # |kernel - plain| / max|plain| after 4 bf16 layers
# |kernel - plain| / max|plain| of dq, dk, dv: p and ds enter bf16 tensor-core
# products, and B2's dq sums through atomics in run-dependent order
BWD_REL_TOL = 2e-2
LOSS_TOL = 1e-2  # |loss kernels - loss plain|, 4 bf16 layers
GRAD_REL_TOL = 5e-2  # ||g kernels - g plain|| / ||g plain|| per parameter
FULL_WIDTH = dict(vocab=32000, dim=4096, layers=4, heads=32, kv_heads=8,
                  head_dim=128, mlp_dim=14336, dtype="bfloat16")


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters, flush):
    """Mean device time of fn() in ms, CUDA events around each call, with
    the 50 MB L2 flushed before each so every call reads from HBM."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_env(torch):
    from ring_flash_attn_tpu_torch.ops import _build

    log("== phase 1: environment and build")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc {nvcc}: {ver}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError as e:
        log(f"triton not importable: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"card: {smi}  ({torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in sorted(paths.items()):
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    return smi


def phase_b1(torch, flush):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_fwd

    log("== phase 2: kernel B1 (flash forward) vs its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, hq, hkv, sq, skv, d=128):
        def rnd(*s):
            return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
        return rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)

    cases = [
        ("causal 4096", (1, 32, 8, 4096, 4096), MaskArgs(causal=True),
         torch.bfloat16),
        ("prefix Sq=1024 Skv=3072 offset=2048", (1, 32, 8, 1024, 3072),
         MaskArgs(causal=True, offset=2048), torch.bfloat16),
        ("non-causal 1000x1500", (2, 8, 2, 1000, 1500), MaskArgs(),
         torch.bfloat16),
        # the engine's own shapes: request 0's prefill and request 2's
        # suffix over its 2048-token cached prefix
        ("engine prefill 3072", (1, 32, 8, 3072, 3072),
         MaskArgs(causal=True), torch.bfloat16),
        ("engine prefix Sq=768 Skv=2816 offset=2048", (1, 32, 8, 768, 2816),
         MaskArgs(causal=True, offset=2048), torch.bfloat16),
        ("ragged, dead rows: offset=-5, f32 out", (1, 4, 2, 100, 70),
         MaskArgs(causal=True, offset=-5), torch.float32),
        # the training path's long step, its last 512 q rows over all
        # 36864 keys (the plain version's fp32 scores of the full
        # sequence would not fit)
        ("training Sq=512 Skv=36864 offset=36352", (1, 32, 8, 512, 36864),
         MaskArgs(causal=True, offset=36352), torch.bfloat16),
        # the training path's S=8192 step (bench.py's shape), timed below
        ("training causal 8192", (1, 32, 8, 8192, 8192),
         MaskArgs(causal=True), torch.bfloat16),
    ]
    worst = 0.0
    for name, shape, mask, odt in cases:
        q, k, v = inputs(*shape)
        scale = q.shape[-1] ** -0.5
        out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=odt)
        ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
        torch.cuda.synchronize()
        eo, el = max_err(out, ref_out), max_err(lse, ref_lse)
        log(f"  {name}: max|out| err {eo:.3e} (tol {B1_OUT_TOL}), "
            f"max|lse| err {el:.3e} (tol {B1_LSE_TOL})")
        if not (eo <= B1_OUT_TOL and el <= B1_LSE_TOL):
            raise AssertionError(f"B1 disagrees with its plain version: {name}")
        worst = max(worst, eo)
        del out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()

    # timing at the causal S=8192 shape of bench.py (the last case's inputs)
    s, hq, hkv, d = 8192, 32, 8, 128
    mask = MaskArgs(causal=True)
    ms = cuda_ms(torch, lambda: flash_fwd_cuda(q, k, v, scale, mask,
                                               out_dtype=torch.bfloat16),
                 10, flush)
    plain_ms = cuda_ms(torch, lambda: naive_block_fwd(q, k, v, scale, mask),
                       2, flush)
    torch.cuda.empty_cache()
    k_rep = k.repeat_interleave(hq // hkv, dim=1)
    v_rep = v.repeat_interleave(hq // hkv, dim=1)
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), 10, flush)
    del k_rep, v_rep
    pairs = s * (s + 1) // 2  # allowed (q, kv) pairs of the causal mask
    flops = 4 * hq * d * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * hq * s
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    log(f"  S=8192 causal bf16: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"sdpa {lib_ms:.3f} ms, bound {bound_ms:.3f} ms (operations)")
    return {
        "name": "B1 flash_fwd", "route": "cuda",
        "source": "ring_flash_attn_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ring_flash_attn_tpu/ops/pallas_fwd.py:161",
        "shape": "q (1,32,8192,128) kv (1,8,8192,128) bf16 causal",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations", "library_ms": lib_ms,
    }


def phase_b5(torch, flush):
    from ring_flash_attn_tpu_torch.ops.paged import (
        PagedKVCache, _plain_paged_decode)
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    log("== phase 3: kernel B5 (paged decode) vs its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    lens = [0, 1, 255, 256, 257, 1000, 4095, 4096]
    b, hq, hkv, d, ps, pps = len(lens), 32, 8, 128, 256, 16
    num_pages = b * pps
    perm = np.random.default_rng(2).permutation(num_pages).astype(np.int32)
    tables = torch.as_tensor(perm.reshape(b, pps), device=dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    k_pages = torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device=dev).to(torch.bfloat16)
    v_pages = torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device=dev).to(torch.bfloat16)
    cache = PagedKVCache(k_pages, v_pages, tables, seq_lens)
    scale = d ** -0.5

    def q_of(tq, dtype):
        return torch.randn((b, hq, tq, d), generator=gen,
                           device=dev).to(dtype)

    counts = torch.tensor([3, 1, 4, 4, 2, 4, 4, 4], dtype=torch.int32,
                          device=dev)
    cases = [
        ("plain, bf16 q", q_of(1, torch.bfloat16), None, None),
        ("softcap=30, f32 q", q_of(1, torch.float32), 30.0, None),
        ("new_counts, Tq=4", q_of(4, torch.bfloat16), None, counts),
    ]
    # the engine's decode shape: 4 lanes at the smoke traffic's lengths
    eng_lens = torch.tensor([3016, 1216, 2616, 316], dtype=torch.int32,
                            device=dev)
    eng_cache = PagedKVCache(k_pages, v_pages, tables[:4], eng_lens)
    q4 = torch.randn((4, hq, 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    worst = 0.0
    for name, q, cap, cnt in cases:
        out, lse = paged_decode_cuda(q, k_pages, v_pages, tables, seq_lens,
                                     scale, softcap=cap, new_counts=cnt)
        ref_out, ref_lse = _plain_paged_decode(q, cache, scale, cap, cnt)
        torch.cuda.synchronize()
        eo, el = max_err(out, ref_out), max_err(lse, ref_lse)
        log(f"  {name}: max|out| err {eo:.3e}, max|lse| err {el:.3e} "
            f"(tol {B5_TOL})")
        if not (eo <= B5_TOL and el <= B5_TOL):
            raise AssertionError(f"B5 disagrees with its plain version: {name}")
        worst = max(worst, eo, el)
    out, lse = paged_decode_cuda(q4, k_pages, v_pages, tables[:4], eng_lens,
                                 scale)
    ref_out, ref_lse = _plain_paged_decode(q4, eng_cache, scale)
    torch.cuda.synchronize()
    eo, el = max_err(out, ref_out), max_err(lse, ref_lse)
    log(f"  engine shape, 4 lanes: max|out| err {eo:.3e}, max|lse| err "
        f"{el:.3e} (tol {B5_TOL})")
    if not (eo <= B5_TOL and el <= B5_TOL):
        raise AssertionError("B5 disagrees with its plain version at the "
                             "engine's shape")
    worst = max(worst, eo, el)

    q = cases[0][1]
    ms = cuda_ms(torch, lambda: paged_decode_cuda(
        q, k_pages, v_pages, tables, seq_lens, scale), 20, flush)
    plain_ms = cuda_ms(torch, lambda: _plain_paged_decode(
        q, cache, scale), 5, flush)
    tokens = sum(lens)
    kv_bytes = 2 * tokens * hkv * d * 2  # K and V of every live token
    io_bytes = 2 * q.numel() + 4 * (q.numel() + b * hq) + 4 * tables.numel()
    flops = 4 * tokens * hq * d
    bound_ms = max((kv_bytes + io_bytes) / H100_BYTES_PER_S,
                   flops / H100_BF16_FLOPS) * 1e3
    log(f"  lens {lens}: kernel {ms:.4f} ms "
        f"({kv_bytes / ms / 1e6:.1f} GB/s of KV), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms (bytes)")
    return {
        "name": "B5 paged_decode", "route": "cuda",
        "source": "ring_flash_attn_tpu_torch/csrc/paged_decode.cu",
        "replaces": "ring_flash_attn_tpu/ops/paged.py:257",
        "shape": f"q (8,32,1,128) bf16, pages (128,8,256,128) bf16, "
                 f"lens {lens}",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }


def _traffic(vocab):
    rng = np.random.default_rng(0)

    def toks(n):
        return rng.integers(0, vocab, size=n).astype(np.int32)

    p0 = toks(3000)
    prompts = {0: p0, 1: toks(1200),
               2: np.concatenate([p0[:2100], toks(500)]),  # prefix of 0
               3: toks(300), 4: toks(2000), 5: toks(800)}
    return prompts


def _serve(torch, model, prompts, backend, new_tokens):
    """Serve the traffic; fork request 4 as soon as it decodes. Returns
    (outputs, [(step seconds, prompt tokens prefilled, decoded or not)])."""
    from ring_flash_attn_tpu_torch.models import ServingEngine

    eng = ServingEngine(model, num_pages=64, page_size=256, pages_per_seq=16,
                        max_batch=4, backend=backend, device="cuda")
    for rid, p in prompts.items():
        eng.submit(rid, p, new_tokens, prefix_of=0 if rid == 2 else None)
    steps, forked = [], False
    while not eng.sched.idle:
        admitted = list(eng.sched.waiting)
        n_pref, n_dec = eng.stats["prefills"], eng.stats["decode_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        done = eng.stats["prefills"] - n_pref
        pref_tokens = sum(r.prompt_len - r.shared_len
                          for r in admitted[:done])
        steps.append((dt, pref_tokens, eng.stats["decode_steps"] > n_dec))
        if not forked and 4 in eng._pending:
            eng.fork(4, 6)
            forked = True
        if len(steps) > 200:
            raise RuntimeError("serving loop did not converge")
    if not forked:
        raise AssertionError("request 4 was never forked")
    if eng.sched._requests[2].shared_len != 2048:
        raise AssertionError("request 2 was not admitted with its prefix")
    return eng.outputs, steps


def phase_engine(torch):
    from ring_flash_attn_tpu_torch.models import ModelConfig, init_params
    from ring_flash_attn_tpu_torch.models.serve import (
        _decode_body, _prefill_fn, ServingEngine)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.paged import PagedKVCache
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.serving import gather_block_tables

    log("== phase 4: ServingEngine at Llama-3-8B widths, 4 layers")
    dev = torch.device("cuda")
    # benchmark/benchmark_serving.py's full-width configuration
    cfg = ModelConfig(**FULL_WIDTH)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  init_params: {n_params / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _traffic(cfg.vocab)
    new_tokens = 16

    # first prefill logits: kernels vs plain versions
    p0 = prompts[0]
    padded = torch.as_tensor(np.pad(p0, (0, -len(p0) % 256))[None],
                             device=dev).long()
    lk, _, _ = _prefill_fn(model, padded, len(p0) - 1)
    lp, _, _ = _prefill_fn(model, padded, len(p0) - 1, backend="plain")
    err = max_err(lk, lp) / float(lp.abs().max())
    log(f"  first prefill logits: max|kernel - plain| / max|plain| = "
        f"{err:.3e} (tol {LOGITS_REL_TOL}), finite "
        f"{bool(torch.isfinite(lk).all())}, argmax equal "
        f"{int(lk.argmax()) == int(lp.argmax())}")
    if not (err <= LOGITS_REL_TOL and torch.isfinite(lk).all()):
        raise AssertionError("prefill logits disagree")

    # first decode step: both versions from the same kernel-prefilled pages
    eng = ServingEngine(model, num_pages=64, page_size=256, pages_per_seq=16,
                        max_batch=4, device="cuda")
    for rid in range(4):
        eng.submit(rid, prompts[rid], new_tokens,
                   prefix_of=0 if rid == 2 else None)
    eng.step()
    lanes = [r for r in eng.sched.lanes if r is not None]
    tables, lens = gather_block_tables(eng.alloc, [r.seq for r in lanes], 16)
    live = np.zeros(4, bool)
    toks = np.zeros(4, np.int64)
    bt = np.zeros((4, 16), np.int32)
    ln = np.zeros(4, np.int32)
    for i, r in enumerate(lanes):
        live[r.lane], toks[r.lane] = True, eng._pending[r.req_id]
        bt[r.lane], ln[r.lane] = tables[i], lens[i] - 1
    logits = {}
    for backend in (None, "plain"):
        caches = [PagedKVCache(c.k_pages.clone(), c.v_pages.clone(),
                               torch.as_tensor(bt, device=dev),
                               torch.as_tensor(ln, device=dev))
                  for c in eng.caches]
        logits[backend], _ = _decode_body(
            model, torch.as_tensor(toks, device=dev),
            torch.as_tensor(live, device=dev), caches, backend=backend)
    del eng, caches
    lk, lp = logits[None], logits["plain"]
    err = max_err(lk, lp) / float(lp.abs().max())
    log(f"  first decode-step logits (4 lanes): max|kernel - plain| / "
        f"max|plain| = {err:.3e} (tol {LOGITS_REL_TOL}), argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}")
    if not (err <= LOGITS_REL_TOL and torch.isfinite(lk).all()):
        raise AssertionError("decode logits disagree")

    # the main path: count launches over this run only
    flash_fwd_cuda.launches = 0
    paged_decode_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out_k, steps = _serve(torch, model, prompts, None, new_tokens)
    launches = {"B1 flash_fwd": flash_fwd_cuda.launches,
                "B5 paged_decode": paged_decode_cuda.launches}
    log(f"  served {len(out_k)} requests in {len(steps)} steps; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rid, toks in sorted(out_k.items()):
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab
                                              for t in toks):
            raise AssertionError(f"request {rid} produced {toks}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    pre = [(dt, n) for dt, n, _ in steps if n]
    dec = [dt for dt, n, decoded in steps if decoded and not n]
    pre_tps = sum(n for _, n in pre) / sum(dt for dt, _ in pre)
    dec_sps = len(dec) / sum(dec)
    log(f"  prefill {pre_tps:.0f} tokens/s over {len(pre)} steps with "
        f"admissions (their decodes included); {dec_sps:.1f} decode "
        f"steps/s over {len(dec)} decode-only steps")

    out_p, _ = _serve(torch, model, prompts, "plain", new_tokens)
    agree = {rid: int(np.sum(np.array(out_k[rid]) == np.array(out_p[rid])))
             for rid in out_k}
    total = sum(agree.values())
    log(f"  token agreement kernels vs plain: {total}/"
        f"{new_tokens * len(out_k)} {agree}")
    return launches


def _rel_err(a, ref):
    return max_err(a, ref) / max(float(ref.abs().max()), 1e-30)


def phase_bwd(torch, flush):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash import (
        compute_delta, flash_attention)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    log("== phase 5: kernels B2, B3a, B3b (flash backward) vs their plain "
        "version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16

    def inputs(b, hq, hkv, sq, skv, mask, d=128):
        """bf16 q, k, v, dout, and B1's bf16 out and fp32 lse."""
        def rnd(*s):
            return torch.randn(s, generator=gen, device=dev).to(bf16)
        q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
        dout = rnd(b, hq, sq, d)
        out, lse = flash_fwd_cuda(q, k, v, d**-0.5, mask, out_dtype=bf16)
        return q, k, v, dout, out, lse

    kernels = {"B2": flash_bwd_cuda, "B3": flash_bwd_split_cuda}
    worst = {name: [0.0, 0.0] for name in kernels}  # (abs, rel)

    def check(name, q, k, v, dout, out, lse, mask, names):
        """The kernels ``names`` in both modes against naive_block_bwd on
        the same inputs."""
        scale = q.shape[-1] ** -0.5
        delta = compute_delta(dout, out)
        ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
        modes = [("delta=None, bf16 grads", None,
                  dict(out=out, dq_dtype=bf16, dkv_dtype=bf16), bf16),
                 ("delta given, fp32 grads", delta, {}, torch.float32)]
        for kname in names:
            for mode, d_arg, kw, dtype in modes:
                got = kernels[kname](dout, q, k, v, lse, d_arg, scale, mask,
                                     **kw)
                torch.cuda.synchronize()
                rel = [_rel_err(x, r) for x, r in zip(got, ref)]
                ab = [max_err(x, r) for x, r in zip(got, ref)]
                log(f"  {name}, {kname}, {mode}: rel err dq {rel[0]:.2e} "
                    f"dk {rel[1]:.2e} dv {rel[2]:.2e} (tol {BWD_REL_TOL}); "
                    f"abs max {max(ab):.2e}")
                if not (max(rel) <= BWD_REL_TOL
                        and all(x.dtype == dtype for x in got)):
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version: {name}, {mode}")
                worst[kname][0] = max(worst[kname][0], max(ab))
                worst[kname][1] = max(worst[kname][1], max(rel))
                if mask.offset is not None and mask.offset < 0:
                    if not torch.all(got[0][:, :, :-mask.offset] == 0):
                        raise AssertionError(f"{kname}: dead rows got a "
                                             f"gradient")
                del got

    cases = [
        ("causal 4096", (1, 32, 8, 4096, 4096), MaskArgs(causal=True)),
        ("prefix Sq=1024 Skv=3072 offset=2048", (1, 32, 8, 1024, 3072),
         MaskArgs(causal=True, offset=2048)),
        ("non-causal 1000x1500", (2, 8, 2, 1000, 1500), MaskArgs()),
        ("ragged, dead rows: offset=-5, Sq=100 Skv=70", (1, 4, 2, 100, 70),
         MaskArgs(causal=True, offset=-5)),
    ]
    for name, shape, mask in cases:
        check(name, *inputs(*shape, mask), mask, ("B2", "B3"))

    # B3 is bitwise reproducible; B2's atomic dq need not be
    mask = MaskArgs(causal=True)
    q, k, v, dout, out, lse = inputs(1, 32, 8, 4096, 4096, mask)
    scale = 128 ** -0.5
    runs = {n: [fn(dout, q, k, v, lse, None, scale, mask, out=out)
                for _ in range(2)] for n, fn in kernels.items()}
    same = {n: [torch.equal(a, b) for a, b in zip(*r)]
            for n, r in runs.items()}
    log(f"  two runs bitwise equal (dq, dk, dv): B3 {same['B3']}, B2 "
        f"{same['B2']}")
    if not all(same["B3"]):
        raise AssertionError("B3a/B3b are not bitwise reproducible")
    del runs, q, k, v, dout, out, lse

    # the training path's S=36864 step, past the fused limit: its last 512
    # q rows over all 36864 keys at the full 32/8 heads (the plain
    # version's fp32 scores of the full sequence would not fit), first the
    # split kernels in both modes, then flash_attention picking them
    mask = MaskArgs(causal=True, offset=36352)
    q, k, v, dout, out, lse = inputs(1, 32, 8, 512, 36864, mask)
    check("training Sq=512 Skv=36864 offset=36352", q, k, v, dout, out, lse,
          mask, ("B3",))
    del out, lse
    torch.cuda.empty_cache()
    leaves = [x.requires_grad_() for x in (q, k, v)]
    before = (flash_bwd_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    grads = {}
    for backend in (None, "plain"):
        o, _ = flash_attention(*leaves, scale, mask, backend=backend)
        grads[backend] = torch.autograd.grad(o, leaves, dout)
        del o
    after = (flash_bwd_cuda.launches, flash_bwd_dq_cuda.launches,
             flash_bwd_dkv_cuda.launches)
    rel = [_rel_err(a, b) for a, b in zip(grads[None], grads["plain"])]
    log(f"  flash_attention q (1,32,512,128) kv (1,8,36864,128) offset "
        f"36352: launches B2 +{after[0] - before[0]}, B3a "
        f"+{after[1] - before[1]}, B3b +{after[2] - before[2]}; rel err vs "
        f"plain dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e}")
    if (after[0] != before[0] or after[1] != before[1] + 1
            or after[2] != before[2] + 1 or max(rel) > BWD_REL_TOL):
        raise AssertionError("flash_attention did not run B3a/B3b at "
                             "Skv=36864")
    del q, k, v, dout, leaves, grads
    torch.cuda.empty_cache()

    # the training path's S=8192 step (bench.py's shape): checked against
    # the plain version, then timed
    s, hq, hkv, d = 8192, 32, 8, 128
    mask = MaskArgs(causal=True)
    q, k, v, dout, out, lse = inputs(1, hq, hkv, s, s, mask)
    check("training causal 8192", q, k, v, dout, out, lse, mask,
          ("B2", "B3"))
    torch.cuda.empty_cache()
    scale = d ** -0.5
    delta = compute_delta(dout, out)
    single = dict(out=out, dq_dtype=bf16, dkv_dtype=bf16)
    b2_ms = cuda_ms(torch, lambda: flash_bwd_cuda(
        dout, q, k, v, lse, None, scale, mask, **single), 10, flush)
    split_ms = cuda_ms(torch, lambda: flash_bwd_split_cuda(
        dout, q, k, v, lse, None, scale, mask, **single), 10, flush)
    b3a_ms = cuda_ms(torch, lambda: flash_bwd_dq_cuda(
        dout, q, k, v, lse, delta, scale, mask, dq_dtype=bf16), 10, flush)
    b3b_ms = cuda_ms(torch, lambda: flash_bwd_dkv_cuda(
        dout, q, k, v, lse, delta, scale, mask, dkv_dtype=bf16), 10, flush)
    plain_ms = cuda_ms(torch, lambda: naive_block_bwd(
        dout, q, k, v, lse, delta, scale, mask), 1, flush)
    torch.cuda.empty_cache()
    qr = q.detach().requires_grad_()
    kr = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    vr = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        o, (qr, kr, vr), dout, retain_graph=True), 10, flush)
    del o, qr, kr, vr

    pairs = s * (s + 1) // 2  # allowed (q, kv) pairs of the causal mask
    per_product = 2 * hq * d * pairs
    n_q, n_kv = q.numel(), k.numel()
    row_bytes = 4 * hq * s  # one fp32 (B, Hq, S) vector
    bounds = {
        # q, k, v, dout, out, lse in; dq, dk, dv (bf16) out
        "B2": (5 * per_product,
               2 * (3 * n_q + 2 * n_kv) + row_bytes + 2 * (n_q + 2 * n_kv)),
        # q, k, v, dout, lse, delta in; dq out
        "B3a": (3 * per_product, 2 * (2 * n_q + 2 * n_kv) + 2 * row_bytes
                + 2 * n_q),
        # q, k, v, dout, lse, delta in; dk, dv out
        "B3b": (4 * per_product, 2 * (2 * n_q + 2 * n_kv) + 2 * row_bytes
                + 4 * n_kv),
    }
    bound_ms = {n: max(f / H100_BF16_FLOPS, b / H100_BYTES_PER_S) * 1e3
                for n, (f, b) in bounds.items()}
    log(f"  S=8192 causal bf16, single-call mode: B2 {b2_ms:.3f} ms "
        f"({bounds['B2'][0] / b2_ms / 1e9:.1f} TFLOP/s of its 5 products, "
        f"bound {bound_ms['B2']:.3f} ms); B3a+B3b with delta pre-pass "
        f"{split_ms:.3f} ms; B3a {b3a_ms:.3f} ms (bound "
        f"{bound_ms['B3a']:.3f}); B3b {b3b_ms:.3f} ms (bound "
        f"{bound_ms['B3b']:.3f}); plain {plain_ms:.3f} ms; "
        f"SDPA backward {lib_ms:.3f} ms (operations bound all)")
    shape = "q (1,32,8192,128) kv (1,8,8192,128) bf16 causal"
    common = {"route": "cuda", "shape": shape, "plain_ms": plain_ms,
              "bound_by": "operations",
              "library_ms": lib_ms,
              "library": "F.scaled_dot_product_attention backward, kv "
                         "repeated to 32 heads"}
    return [
        dict(common, name="B2 flash_bwd",
             source="ring_flash_attn_tpu_torch/csrc/flash_bwd.cu",
             replaces="ring_flash_attn_tpu/ops/pallas_bwd_fused.py:59",
             max_abs_err=worst["B2"][0], max_rel_err=worst["B2"][1],
             ms=b2_ms, bound_ms=bound_ms["B2"]),
        dict(common, name="B3a flash_bwd_dq",
             source="ring_flash_attn_tpu_torch/csrc/flash_bwd_split.cu",
             replaces="ring_flash_attn_tpu/ops/pallas_bwd.py:56",
             max_abs_err=worst["B3"][0], max_rel_err=worst["B3"][1],
             ms=b3a_ms, bound_ms=bound_ms["B3a"], pair_ms=split_ms),
        dict(common, name="B3b flash_bwd_dkv",
             source="ring_flash_attn_tpu_torch/csrc/flash_bwd_split.cu",
             replaces="ring_flash_attn_tpu/ops/pallas_bwd.py:256",
             max_abs_err=worst["B3"][0], max_rel_err=worst["B3"][1],
             ms=b3b_ms, bound_ms=bound_ms["B3b"], pair_ms=split_ms),
    ]


def _train_batch(torch, vocab, s, seed):
    """Seeded tokens (1, S), labels shifted by one with -100 last, and
    positions arange(S), on the card."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(1, s))
    tokens = torch.as_tensor(toks, device="cuda").long()
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    return tokens, labels, torch.arange(s, device="cuda")


def _timed_step(torch, model, batch):
    from ring_flash_attn_tpu_torch.models import train_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = train_step(model, *batch)
    loss = float(loss)
    torch.cuda.synchronize()
    return loss, time.perf_counter() - t0


def phase_train(torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, loss_fn, train_step)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda

    log("== phase 6: training at Llama-3-8B widths, 4 layers")
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    params = list(model.named_parameters())

    # loss and gradients: kernels vs plain versions at S=2048
    batch = _train_batch(torch, cfg.vocab, 2048, 1)
    res = {}
    for backend in (None, "plain"):
        loss = loss_fn(model, *batch, backend=backend)
        grads = torch.autograd.grad(loss, [p for _, p in params])
        res[backend] = (float(loss.detach()), grads)
        del loss, grads
    (lk, gk), (lp, gp) = res[None], res["plain"]
    errs = sorted(((float((a.float() - b.float()).norm() / b.float().norm()),
                    name) for (name, _), a, b in zip(params, gk, gp)),
                  reverse=True)
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    log(f"  S=2048 loss: kernels {lk:.6f}, plain {lp:.6f} (|diff| "
        f"{abs(lk - lp):.2e}, tol {LOSS_TOL}); gradient ||k - p|| / ||p||, "
        f"worst 3 of {len(errs)}: "
        + ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])
        + f" (tol {GRAD_REL_TOL}); finite {finite}")
    if not (abs(lk - lp) <= LOSS_TOL and errs[0][0] <= GRAD_REL_TOL
            and finite):
        raise AssertionError("training gradients disagree with the plain "
                             "versions")
    del res, gk, gp
    torch.cuda.empty_cache()

    # the main path: counts from 0 over these steps only
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    batch = _train_batch(torch, cfg.vocab, 8192, 2)
    steps = [_timed_step(torch, model, batch) for _ in range(3)]
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, dt) in enumerate(steps):
        log(f"  S=8192 step {i}: loss {loss:.6f}, {dt:.3f} s, "
            f"{8192 / dt:.0f} tokens/s")
    log(f"  S=8192 peak memory {peak8:.2f} GiB")
    if not all(np.isfinite(loss) for loss, _ in steps):
        raise AssertionError(f"non-finite loss: {steps}")

    torch.cuda.reset_peak_memory_stats()
    long_batch = _train_batch(torch, cfg.vocab, 36864, 3)
    loss36, dt36 = _timed_step(torch, model, long_batch)
    peak36 = torch.cuda.max_memory_allocated() / 2**30
    log(f"  S=36864 step ({cfg.layers} layers): loss {loss36:.6f}, "
        f"{dt36:.3f} s,"
        f" {36864 / dt36:.0f} tokens/s, peak memory {peak36:.2f} GiB")
    if not np.isfinite(loss36):
        raise AssertionError(f"non-finite loss at S=36864: {loss36}")
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches over the 4 steps: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the training path: "
                             f"{launches}")

    # where the time goes in one S=8192 step
    torch.cuda.empty_cache()
    wall = min(dt for _, dt in steps[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(model, *batch)
        torch.cuda.synchronize()
    dev = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    log(f"  profiled S=8192 step: device busy {busy_us / 1e3:.3f} ms of the "
        f"unprofiled {wall * 1e3:.3f} ms step "
        f"({100 * busy_us / 1e3 / wall / 1e3:.1f}% busy)")
    groups = {"port kernels": ("rfa_bwd::", "bwd_dq_kernel",
                              "flash_fwd_kernel", "paged_decode"),
              "cuBLAS GEMMs": ("nvjet", "gemm", "cutlass", "sm90_xmma")}
    split = {g: 0.0 for g in (*groups, "other (elementwise, copies, "
                                       "reductions)")}
    for t, key, _ in dev:
        g = next((g for g, pre in groups.items()
                  if any(p in key for p in pre)), None)
        split[g or "other (elementwise, copies, reductions)"] += t
    log("  by kind: " + "; ".join(f"{g} {t / 1e3:.3f} ms "
                                  f"({100 * t / busy_us:.1f}%)"
                                  for g, t in split.items()))
    log("  top 10 kernels by device time:")
    for t, key, count in dev[:10]:
        log(f"    {100 * t / busy_us:5.1f}%  {t / 1e3:9.3f} ms  x{count:<4d} "
            f"{key[:80]}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import ring_flash_attn_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    smi = run("env+build", phase_env, torch)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = [run("B1", phase_b1, torch, flush),
               run("B5", phase_b5, torch, flush)]
    del flush
    torch.cuda.empty_cache()
    serving = run("serving", phase_engine, torch)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels += run("B2/B3", phase_bwd, torch, flush)
    del flush
    torch.cuda.empty_cache()
    training = run("training", phase_train, torch)
    for k in kernels:
        # each kernel's count on the run of its own path: serving for B1
        # and B5, training for B2/B3a/B3b (B1 runs on both)
        k["launches"] = serving.get(k["name"], training.get(k["name"]))
        paths = {p: c[k["name"]] for p, c in (("serving", serving),
                                              ("training", training))
                 if k["name"] in c}
        k["launches_by_path"] = paths
    log(f"phase seconds {seconds}; phases took "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
