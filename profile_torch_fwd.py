#!/usr/bin/env python3
"""The forward tile loop (kernels B1 and B7) on one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_fwd.py [--root DIR] [--rounds N]

``--root`` imports ``ring_flash_attn_tpu_torch`` from another checkout (for
example the parent commit unpacked beside this one), so that two trees are
timed by the same code in one machine session: run parent, change, change,
parent.

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
   without packed sequences times the rest); then B7 at head_dim 256 on
   Gemma-2-9B's heads, q (1,16,8192,256), kv (1,8,8192,256), one
   off-diagonal and one diagonal step without the cap and with softcap
   50, beside SDPA's forward at 256, not causal and causal. Each time is the mean of 10 calls
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
    GEMMA2_ATTN, H100_BF16_FLOPS, VARLEN_PACKINGS, has_segments, kernel_ms,
    log, profile_loop, varlen_mask, varlen_pairs)

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

    rounds = args.rounds
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    s, hq, hkv, d = 8192, 32, 8, 128
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v = rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d)
    qs = fr._prescale(q, scale * fr.LOG2E)
    state = fr.new_state(qs)
    fr.fwd_step(qs, k, v, state, diagonal=True, first=True, last=False)
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    causal, full = MaskArgs(causal=True), MaskArgs()

    fns = {
        "B1 causal": lambda: flash_fwd_cuda(q, k, v, scale, causal,
                                            out_dtype=bf16),
        "B1 non-causal": lambda: flash_fwd_cuda(q, k, v, scale, full,
                                                out_dtype=bf16),
        "B7 off-diagonal": lambda: fr.fwd_step(
            qs, k, v, state, diagonal=False, first=False, last=False),
        "B7 diagonal": lambda: fr.fwd_step(
            qs, k, v, state, diagonal=True, first=True, last=False),
        "SDPA fwd causal": lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True),
        "SDPA fwd non-causal": lambda: F.scaled_dot_product_attention(
            q, kr, vr),
    }
    pairs = {"causal": s * (s + 1) // 2, "full": s * s}
    flops = {"B1 causal": 2 * 2 * hq * d * pairs["causal"],
             "B1 non-causal": 2 * 2 * hq * d * pairs["full"],
             "B7 off-diagonal": 2 * 2 * hq * d * pairs["full"],
             "B7 diagonal": 2 * 2 * hq * d * pairs["causal"]}
    lib = {"B1 causal": "SDPA fwd causal",
           "B1 non-causal": "SDPA fwd non-causal",
           "B7 off-diagonal": "SDPA fwd non-causal",
           "B7 diagonal": "SDPA fwd causal"}
    # the segmented instantiation, in rounds of its own after the others,
    # so that the mask-free kernels are timed in the same sequence in a
    # tree with it and in one without
    vfns = {}
    if has_segments():
        cu = VARLEN_PACKINGS[3]
        vmask, dense = varlen_mask(torch, cu, True, dev)
        vfns["B1 varlen causal"] = lambda: flash_fwd_cuda(
            q, k, v, scale, vmask, out_dtype=bf16)
        vfns["SDPA fwd varlen mask"] = lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=dense)
        flops["B1 varlen causal"] = 2 * 2 * hq * d * varlen_pairs(cu, True)
        lib["B1 varlen causal"] = "SDPA fwd varlen mask"
    # B7 at head_dim 256 (Gemma-2-9B's 16/8 heads), with and without the
    # softcap, in rounds of their own after the head_dim 128 kernels
    hq2, hkv2, cap, d2 = (GEMMA2_ATTN["heads"], GEMMA2_ATTN["kv_heads"],
                          GEMMA2_ATTN["softcap"], 256)
    q2, k2, v2 = rnd(1, hq2, s, d2), rnd(1, hkv2, s, d2), rnd(1, hkv2, s, d2)
    qs2 = fr._prescale(q2, d2 ** -0.5 * fr.LOG2E)
    wfns = {}
    for label, c in (("no cap", None), ("softcap", cap)):
        tk = fr._transforms(q2, True, c, None)
        st = fr.new_state(qs2)
        fr.fwd_step(qs2, k2, v2, st, diagonal=True, first=True, last=False,
                    **tk)
        for diag in (False, True):
            name = f"B7 256 {label} {'diagonal' if diag else 'off-diagonal'}"
            wfns[name] = (lambda diag=diag, tk=tk, st=st: fr.fwd_step(
                qs2, k2, v2, st, diagonal=diag, first=diag, last=False,
                **tk))
            flops[name] = 2 * 2 * hq2 * d2 * pairs[
                "causal" if diag else "full"]
            lib[name] = f"SDPA fwd 256 {'causal' if diag else 'non-causal'}"
    kr2 = k2.repeat_interleave(hq2 // hkv2, dim=1)
    vr2 = v2.repeat_interleave(hq2 // hkv2, dim=1)
    wfns["SDPA fwd 256 non-causal"] = lambda: F.scaled_dot_product_attention(
        q2, kr2, vr2)
    wfns["SDPA fwd 256 causal"] = lambda: F.scaled_dot_product_attention(
        q2, kr2, vr2, is_causal=True)
    times = collections.defaultdict(list)
    device = collections.defaultdict(list)
    host = collections.defaultdict(list)
    for group in (fns, vfns, wfns):
        for _ in range(rounds):
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


if __name__ == "__main__":
    sys.exit(profile_loop("profile_torch_fwd.py", LOOP, "flash_fwd_kernel",
                          timings))
