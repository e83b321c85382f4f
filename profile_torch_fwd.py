#!/usr/bin/env python3
"""The forward tile loop (kernels B1 and B7) on one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_fwd.py [--root DIR] [--rounds N]
        [--head-dim {128,256,both}] [--only TEXT]

``--root`` imports ``ring_flash_attn_tpu_torch`` from another checkout (for
example the parent commit unpacked beside this one), so that two trees are
timed by the same code in one machine session: run parent, change, change,
parent. ``--head-dim`` picks the shapes of step 2 (default both); ``--only
TEXT`` (repeatable) keeps the kernels whose name holds TEXT, beside their
SDPA yardsticks.

1. Builds the kernels and prints ptxas's registers, spills and shared memory
   of every instantiation of ``csrc/flash_fwd.cuh``'s loop (B1 in
   ``flash_fwd``, B7 with and without softcap/ALiBi in ``fused_ring_fwd``),
   any wgmma serialisation notes, and the count of ``HGMMA`` instructions in
   their SASS (``cuobjdump -sass``).
2. Times, ``rounds`` times in turns, at q (1,32,8192,128), kv (1,8,8192,128)
   bf16: B1 causal and not (bf16 out, as ``flash_attention`` asks), B7 one
   off-diagonal ring step (state read and written) and one diagonal first
   step, and ``F.scaled_dot_product_attention``'s forward, causal and not
   (timed only, never used by the port), each between CUDA events and as
   the profiler's device time (``chip_smoke.kernel_ms``: the events'
   reading holds whatever host time a launch takes past the L2 flush's);
   then B1's segmented
   instantiation (packed sequences, ``csrc/segments.cuh``) causal on the
   reference's five-sequence packing of 8192 tokens beside SDPA's forward
   with the same dense boolean mask, where the tree has it (a parent
   without packed sequences times the rest); B7 one off-diagonal step
   with softcap 50 (the XFORM build at 128). At head_dim 256: B7 on
   Gemma-2-9B's heads, q (1,16,8192,256), kv (1,8,8192,256), one
   off-diagonal and one diagonal step without the cap and with softcap
   50; B1 at the same heads causal without the cap and with softcap 50
   (the XFORM build, Gemma 2's global layers) and not causal (the loop
   B7's off-diagonal step runs, without the state); B1 at Gemma-7B's, q and kv
   (1,16,8192,256), causal and not; beside SDPA's forward at each shape,
   not causal and causal. Each time is the mean of 10 calls
   between CUDA events, the L2 flushed before each, and the host's time to
   issue one call (20 calls enqueued back to back: the launcher's checks,
   its tensor maps and the launch). Prints TFLOP/s of the loop's 2
   products, the ratio to SDPA's forward and to the operations bound at
   989 TFLOP/s.

The loop's correctness is ``chip_smoke.py``'s (phases 2, 4, 6, 9 to 12) and
``tests/test_torch_cuda.py``'s. Prints the card's name and power limit
first.
"""

import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    GEMMA2_ATTN, GEMMA_ATTN, H100_BF16_FLOPS, VARLEN_PACKINGS, has_segments,
    kernel_ms, log, profile_loop, varlen_mask, varlen_pairs)

LOOP = ("B1 flash_fwd", "B7 fused_ring_fwd")


def host_us(torch, fn, n):
    """The host's time to issue one call of fn(), in us: n calls enqueued
    back to back on an idle card (the launch queue does not fill), then
    synchronised outside the clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def timings(torch, args):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    s = 8192
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    pairs = {"causal": s * (s + 1) // 2, "full": s * s}
    causal, full = MaskArgs(causal=True), MaskArgs()
    cap = GEMMA2_ATTN["softcap"]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def sdpa(q, k, v, **kw):
        g = q.shape[1] // k.shape[1]
        kr = k.repeat_interleave(g, dim=1)
        vr = v.repeat_interleave(g, dim=1)
        return lambda: F.scaled_dot_product_attention(q, kr, vr, **kw)

    def b7_steps(prefix, q, k, v, caps, diagonals=(False, True)):
        """B7's off-diagonal (state read and written) and diagonal first
        steps, {label: softcap} each, on a state the diagonal step made."""
        d = q.shape[-1]
        qs = fr._prescale(q, d ** -0.5 * fr.LOG2E)
        out = {}
        for label, c in caps.items():
            tk = fr._transforms(q, True, c, None)
            st = fr.new_state(qs)
            fr.fwd_step(qs, k, v, st, diagonal=True, first=True, last=False,
                        **tk)
            for diag in diagonals:
                name = (f"{prefix}{label}"
                        f"{'diagonal' if diag else 'off-diagonal'}")
                out[name] = (lambda diag=diag, tk=tk, st=st: fr.fwd_step(
                    qs, k, v, st, diagonal=diag, first=diag, last=False,
                    **tk))
        return out

    groups, flops, lib = [], {}, {}
    if args.head_dim in ("128", "both"):
        hq, hkv, d = 32, 8, 128
        scale = d ** -0.5
        q, k, v = rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d)
        fns = {
            "B1 causal": lambda: flash_fwd_cuda(q, k, v, scale, causal,
                                                out_dtype=bf16),
            "B1 non-causal": lambda: flash_fwd_cuda(q, k, v, scale, full,
                                                    out_dtype=bf16),
            **b7_steps("B7 ", q, k, v, {"": None}),
            "SDPA fwd causal": sdpa(q, k, v, is_causal=True),
            "SDPA fwd non-causal": sdpa(q, k, v),
        }
        for name, mask in (("B1 causal", "causal"),
                           ("B1 non-causal", "full"),
                           ("B7 off-diagonal", "full"),
                           ("B7 diagonal", "causal")):
            flops[name] = 2 * 2 * hq * d * pairs[mask]
            lib[name] = ("SDPA fwd causal" if mask == "causal"
                         else "SDPA fwd non-causal")
        groups.append(fns)
        # the segmented instantiation, in rounds of its own after the
        # others, so that the mask-free kernels are timed in the same
        # sequence in a tree with it and in one without
        vfns = {}
        if has_segments():
            cu = VARLEN_PACKINGS[3]
            vmask, dense = varlen_mask(torch, cu, True, dev)
            vfns["B1 varlen causal"] = lambda: flash_fwd_cuda(
                q, k, v, scale, vmask, out_dtype=bf16)
            vfns["SDPA fwd varlen mask"] = sdpa(q, k, v, attn_mask=dense)
            flops["B1 varlen causal"] = 2 * 2 * hq * d * varlen_pairs(cu,
                                                                      True)
            lib["B1 varlen causal"] = "SDPA fwd varlen mask"
        # B7's XFORM build at 128 (softcap 50), in rounds of its own
        xfns = b7_steps("B7 ", q, k, v, {"softcap ": cap}, (False,))
        flops["B7 softcap off-diagonal"] = 2 * 2 * hq * d * pairs["full"]
        lib["B7 softcap off-diagonal"] = "SDPA fwd non-causal"
        groups += [vfns, xfns]
    if args.head_dim in ("256", "both"):
        # Gemma-2-9B's 16/8 heads: B7 with and without the softcap, B1
        # causal with and without it; Gemma-7B's 16/16: B1 causal and not
        hq, hkv, d = GEMMA2_ATTN["heads"], GEMMA2_ATTN["kv_heads"], 256
        scale = d ** -0.5
        q, k, v = rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d)
        wfns = b7_steps("B7 256 ", q, k, v,
                          {"no cap ": None, "softcap ": cap})
        for name in list(wfns):
            diag = name.endswith(" diagonal")
            flops[name] = 2 * 2 * hq * d * pairs["causal" if diag
                                                 else "full"]
            lib[name] = ("SDPA fwd 256 causal" if diag
                         else "SDPA fwd 256 non-causal")
        wfns["B1 256 Gemma-2 causal"] = lambda: flash_fwd_cuda(
            q, k, v, scale, causal, out_dtype=bf16)
        wfns["B1 256 Gemma-2 softcap causal"] = lambda: flash_fwd_cuda(
            q, k, v, scale, causal._replace(softcap=cap), out_dtype=bf16)
        wfns["B1 256 Gemma-2 non-causal"] = lambda: flash_fwd_cuda(
            q, k, v, scale, full, out_dtype=bf16)
        for name in ("B1 256 Gemma-2 causal",
                     "B1 256 Gemma-2 softcap causal",
                     "B1 256 Gemma-2 non-causal"):
            mask = "full" if name.endswith("non-causal") else "causal"
            flops[name] = 2 * 2 * hq * d * pairs[mask]
            lib[name] = ("SDPA fwd 256 non-causal" if mask == "full"
                         else "SDPA fwd 256 causal")
        wfns["SDPA fwd 256 non-causal"] = sdpa(q, k, v)
        wfns["SDPA fwd 256 causal"] = sdpa(q, k, v, is_causal=True)
        g7 = GEMMA_ATTN["Gemma-7B"][0]
        q7, k7, v7 = (rnd(1, g7, s, d) for _ in range(3))
        for label, mask in (("causal", causal), ("non-causal", full)):
            name = f"B1 256 Gemma-7B {label}"
            wfns[name] = (lambda mask=mask: flash_fwd_cuda(
                q7, k7, v7, scale, mask, out_dtype=bf16))
            flops[name] = 2 * 2 * g7 * d * pairs[
                "causal" if label == "causal" else "full"]
            lib[name] = f"SDPA fwd 256 Gemma-7B {label}"
        wfns["SDPA fwd 256 Gemma-7B causal"] = sdpa(q7, k7, v7,
                                                    is_causal=True)
        wfns["SDPA fwd 256 Gemma-7B non-causal"] = sdpa(q7, k7, v7)
        groups.append(wfns)
    if args.only:
        keep = {n for n in flops if any(t in n for t in args.only)}
        keep |= {lib[n] for n in keep}
        groups = [{n: fn for n, fn in g.items() if n in keep}
                  for g in groups]
    times = collections.defaultdict(list)
    device = collections.defaultdict(list)
    host = collections.defaultdict(list)
    for group in groups:
        for _ in range(args.rounds):
            for name, fn in group.items():
                r = kernel_ms(torch, fn, 10, flush)
                times[name].append(r["ms"])
                device[name].append(r["device_ms"])
                host[name].append(host_us(torch, fn, 20))
    for name, ts in times.items():
        line = (f"  {name}: " + ", ".join(f"{t:.3f}" for t in ts) + " ms; "
                f"device " + ", ".join(f"{t:.3f}" for t in device[name])
                + " ms; host " + ", ".join(f"{t:.1f}" for t in host[name])
                + " us a call")
        if name in flops:
            best = min(ts)
            bound = flops[name] / H100_BF16_FLOPS * 1e3
            line += (f"; {flops[name] / best / 1e9:.1f} TFLOP/s, "
                     f"{best / min(times[lib[name]]):.2f}x {lib[name]}, "
                     f"{best / bound:.2f}x its operations bound "
                     f"({bound:.3f} ms)")
        log(line)
    return {name: min(ts) for name, ts in times.items()}


def add_arguments(ap):
    ap.add_argument("--head-dim", choices=("128", "256", "both"),
                    default="both", help="the shapes of the timings")
    ap.add_argument("--only", action="append", default=[], metavar="TEXT",
                    help="time only the kernels whose name holds TEXT "
                    "(repeatable), beside their SDPA yardsticks")


if __name__ == "__main__":
    sys.exit(profile_loop("profile_torch_fwd.py", LOOP, "flash_fwd_kernel",
                          timings, add_arguments))
