"""Continuous-batching serving demo: the port's full stack end to end.

The port of ``examples/serve_continuous_batching.py``: builds the flagship
llama-style model at a small config with seeded random weights, submits a
stream of variable-length requests against a deliberately tight page pool
and serves them with ``models.serve.ServingEngine``:

  C++ page allocator -> DecodeScheduler lanes -> paged KV caches (one page
  pool per layer) -> prefill (kernel B1; chunked with --prefill-chunk) and
  decode (kernel B5; speculative with --speculate) -> tokens.

Requests keep arriving mid-flight (submitted between steps) to show that
admission never drains the running lanes. Runs on the card by default
(bf16, the kernels); ``--device cpu`` runs float32 on the kernels' plain
versions.

    python -m ring_flash_attn_tpu_torch.examples.serve_continuous_batching \\
        [--requests 8] [--seed 0] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ring_flash_attn_tpu_torch.models import (ModelConfig,  # noqa: E402
                                              SamplingParams, ServingEngine,
                                              init_params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speculate", type=int, default=4,
                    help="speculative decoding draft window (1 = off)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked-prefill chunk (0 = dense one-shot)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for odd request ids")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # B5 takes head_dim 128: the card's config has it, at a small width
    dtype = "bfloat16" if args.device == "cuda" else "float32"
    cfg = ModelConfig(vocab=256, dim=256, layers=2, heads=4, kv_heads=2,
                      head_dim=128, mlp_dim=512, dtype=dtype)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    model = init_params(cfg, gen, device=args.device)

    # page pool sized so only ~2 requests fit at once: the rest queue and
    # are admitted as lanes retire (continuous batching, no draining)
    eng = ServingEngine(
        model, num_pages=24, page_size=16, pages_per_seq=8, max_batch=4,
        reserve=1, device=args.device,
        speculate_k=args.speculate if args.speculate > 1 else None,
        prefill_chunk=args.prefill_chunk or None,
    )

    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(8, 90, size=args.requests)
    arrivals = {int(i): rng.integers(0, 6) for i in range(args.requests)}

    t0 = time.time()
    steps = 0
    submitted = set()
    generated = 0
    while len(submitted) < args.requests or not eng.sched.idle:
        # stream submissions in while the engine is busy
        for rid in range(args.requests):
            if rid not in submitted and arrivals[rid] <= steps:
                prompt = rng.integers(0, cfg.vocab, size=int(lengths[rid]))
                sp = (SamplingParams(temperature=args.temperature,
                                     top_k=40, seed=rid)
                      if args.temperature > 0 and rid % 2 else None)
                eng.submit(rid, prompt, args.max_new, sampling=sp)
                submitted.add(rid)
                print(f"step {steps:3d}: submitted request {rid} "
                      f"(prompt {lengths[rid]} tokens)")
        finished = eng.step()
        steps += 1
        for r in finished:
            toks = eng.outputs[r.req_id]
            generated += len(toks)
            print(f"step {steps:3d}: finished request {r.req_id}: {toks}")
        if steps >= 500:
            raise RuntimeError("did not converge")
    dt = time.time() - t0
    st = eng.stats
    print(f"\nserved {args.requests} requests / {generated} tokens in "
          f"{steps} steps ({dt:.1f}s wall incl. the kernels' build) on "
          f"{args.device}")
    print(f"engine stats: {st['decode_steps']} decode steps, "
          f"{st['prefills']} prefills ({st['prefill_chunks']} chunks), "
          f"{st['tokens']} tokens"
          + (f"; speculation acceptance {eng.spec_acceptance_rate:.0%} "
             f"({st['spec_accepted']}/{st['spec_proposed']} drafts)"
             if st["spec_proposed"] else ""))
    return eng


if __name__ == "__main__":
    main()
