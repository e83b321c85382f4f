#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's ServingEngine.

Runs the engine on one NVIDIA H100 at the widths of ``chip_smoke.py``
(``--model``: phase 4's Llama-3-8B widths cut to 4 layers, head_dim 128,
by default; or one of phase 24's models, e.g. Llama-3.2-1B at head_dim
64), seeded random bf16 weights, 64 pages of 256 tokens, 4 lanes: one
step that prefills four prompts (3000, 1200, 2600 of which 2048
prefix-cached, 300 tokens), then ``--steps`` decode steps over those four
lanes. Each window runs on engines of its own: once timed on the host
clock, then under ``torch.profiler`` through
``utils.trace_timing.trace_device_events`` (the device time by kernel)
and ``trace_device_busy`` (the union of the device's events); it prints
the wall time per step, the device compute per step summed over every
kernel, the device's busy share of the unprofiled wall time, and the top
kernels by device time.

``--verify`` times ``chip_smoke.py`` phase 19's verify forwards instead:
on phase 4's pool after one step over phase 19's four repetitive prompts,
one plain decode step (``_decode_body``) and one speculative verify
(``_spec_verify_body``) at k = 4 and 8 (16 and 32 rows a kv head), each
as the wall ms (median of 5) and device ms of the forward and the device
ms of its B5 launches, ``--rounds`` times. ``--root DIR`` imports the
package from another checkout (the parent unpacked beside this one), so
that one call runs parent, change, change, parent.

    python3 profile_torch_serving.py [--steps 8] [--model Llama-3.2-1B]
    python3 profile_torch_serving.py --verify [--root DIR] [--rounds 2]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def _summary(name, events, busy_s, wall_s, n_steps, top=12):
    """The window's device time by kernel (``events``: [(s, name,
    count)], the largest first) and its busy seconds against the wall
    time of the same work run without the profiler."""
    dev_s = sum(t for t, _, _ in events)
    print(f"== {name}: {n_steps} step(s), wall {wall_s / n_steps * 1e3:.3f}"
          f" ms/step, device compute {dev_s / n_steps * 1e3:.3f} ms/step, "
          f"busy {busy_s / n_steps * 1e3:.3f} ms/step "
          f"({100 * busy_s / wall_s:.1f}% of wall; idle "
          f"{100 * (1 - busy_s / wall_s):.1f}%)")
    for t, key, count in events[:top]:
        print(f"  {100 * t / dev_s:5.1f}%  {t / n_steps * 1e3:8.3f} ms/step"
              f"  x{count / n_steps:5.1f}/step  {key[:90]}")


def verify_times(rounds):
    """Phase 19's verify forwards (chip_smoke.py, (b)): the same model,
    prompts and drafts. Prints, each round, wall ms / device ms / B5's
    device ms of a plain decode step and of a verify at k = 4 and 8."""
    from chip_smoke import (
        FULL_WIDTH, _caches, _device_profile, _prefilled_lanes, _step_times)
    from ring_flash_attn_tpu_torch.models import ModelConfig, init_params
    from ring_flash_attn_tpu_torch.models.serve import (
        _decode_body, _spec_verify_body)

    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(19)
    rep = {rid: np.tile(rng.integers(0, cfg.vocab, size=u),
                        -(-n // u))[:n].astype(np.int32)
           for rid, (u, n) in enumerate(((50, 1000), (17, 600), (120, 1500),
                                         (33, 800)))}
    pages, toks, live, tables, lens = _prefilled_lanes(torch, model, rep)
    fns = {"decode": lambda: _decode_body(
        model, toks, live, _caches(torch, pages, tables, lens))}
    for k in (4, 8):
        cand = torch.cat([toks[:, None], torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(4, k - 1)), device="cuda")],
            dim=1)
        n_valid = torch.where(live, k, 0).to(torch.int32)
        fns[f"verify k={k}"] = (
            lambda cand=cand, n_valid=n_valid: _spec_verify_body(
                model, cand, n_valid, _caches(torch, pages, tables, lens)))
    with torch.no_grad():
        for i in range(rounds):
            for name, fn in fns.items():
                wall, dev = _step_times(torch, fn)
                b5 = [(t, n) for t, key, n in _device_profile(torch, fn)
                      if "paged_decode_kernel" in key]
                print(f"round {i} {name}: wall {wall:.3f} ms, device "
                      f"{dev:.3f} ms, B5 {sum(t for t, _ in b5) / 1e3:.4f} "
                      f"ms in {sum(n for _, n in b5)} launches", flush=True)


def main():
    sys.path.insert(0, ROOT)
    from chip_smoke import DECODE_MODELS, FULL_WIDTH

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--model", default="Llama-3-8B",
                    choices=["Llama-3-8B"] + sorted(DECODE_MODELS))
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the package from there, ahead of this tree
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, ServingEngine, init_params)
    from ring_flash_attn_tpu_torch.ops import _build
    from ring_flash_attn_tpu_torch.utils.trace_timing import (
        trace_device_busy, trace_device_events)

    print(torch.cuda.get_device_name(0), torch.__version__, f"tree {root}",
          flush=True)
    _build.build_all()
    if args.verify:
        verify_times(args.rounds)
        return 0
    widths = (FULL_WIDTH if args.model == "Llama-3-8B"
              else DECODE_MODELS[args.model]["cfg"])
    cfg = ModelConfig(**widths)
    print(f"{args.model}: {widths}", flush=True)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, cfg.vocab, 3000).astype(np.int32)
    prompts = [p0, rng.integers(0, cfg.vocab, 1200),
               np.concatenate([p0[:2100], rng.integers(0, cfg.vocab, 500)]),
               rng.integers(0, cfg.vocab, 300)]

    def engine(new_tokens):
        eng = ServingEngine(model, num_pages=64, page_size=256,
                            pages_per_seq=16, max_batch=4)
        for rid, p in enumerate(prompts):
            eng.submit(rid, p, new_tokens, prefix_of=0 if rid == 2 else None)
        return eng

    def timed(eng, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def profiled(step):
        """The window ``step()`` under the profiler: (device events of one
        call, busy seconds of one call). The trace functions call it
        after warm-up calls: five calls in all."""
        flag = torch.zeros(1, device="cuda")
        events = trace_device_events(step)
        busy, _ = trace_device_busy(lambda x: (step(), x)[1], flag, 1)
        return events, busy

    # the prefill window: each call prefills four prompts on a fresh engine
    warm = engine(4)  # builds, cuBLAS handles, allocator pools
    timed(warm, 3)
    del warm
    eng_t = engine(6 * args.steps + 4)
    wall = timed(eng_t, 1)
    fresh = [engine(2) for _ in range(5)]
    events, busy = profiled(lambda: fresh.pop().step())
    del fresh
    reqs = [eng_t.sched._requests[i] for i in range(len(prompts))]
    real = sum(r.prompt_len - r.shared_len for r in reqs)
    padded = sum(-(-(r.prompt_len - r.shared_len) // 256) * 256 for r in reqs)
    _summary(f"prefill step (4 prompts: {real} new tokens, {padded} with "
             f"page padding; {real / wall:.0f} tokens/s)", events, busy,
             wall, 1)
    # the decode window: args.steps decode steps over the four lanes
    eng_p = engine(6 * args.steps + 4)
    timed(eng_p, 1)  # its prefill
    for eng in (eng_t, eng_p):
        timed(eng, 1)  # the first decode step, outside the windows
    wall = timed(eng_t, args.steps)
    events, busy = profiled(lambda: timed(eng_p, args.steps))
    _summary("decode steps (4 lanes, 300 to 3000 tokens of context)", events,
             busy, wall, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
