#!/usr/bin/env python3
"""The backward loops (kernels B2, B3b, B8: kv-major; B3a: q-major dq) on
one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_bwd.py [--root DIR] [--rounds N]
        [--head-dim {128,256,both,long}] [--only TEXT]

``--root`` imports ``ring_flash_attn_tpu_torch`` from another checkout (for
example the parent commit unpacked beside this one), so that two trees are
timed by the same code in one machine session: run parent, change, change,
parent. ``--head-dim`` picks the shapes of step 2 (default both);
``--only TEXT`` keeps the head_dim 256 kernels whose name holds TEXT.

1. Builds the kernels and prints ptxas's registers, spills and shared memory
   of every instantiation of ``csrc/flash_bwd.cuh``'s loop (B2 in
   ``flash_bwd``, B3b in ``flash_bwd_split``, B8 in ``fused_ring_bwd``) and
   of B3a's loop (``bwd_dq_kernel`` in ``flash_bwd_split``), head_dim 256
   included, any wgmma serialisation notes, and the count of ``HGMMA``
   instructions in their SASS (``cuobjdump -sass``).
2. Times, ``rounds`` times in turns, each time the mean of 10 calls between
   CUDA events, the L2 flushed before each, and the profiler's device time
   of the same calls (``chip_smoke.kernel_ms``); prints TFLOP/s of each
   kernel's 5 (B2, B8), 4 (B3b), 3 (B3a) or 7 (the pair) products, the
   ratio to the backward of ``F.scaled_dot_product_attention`` at the same
   shape (timed only, never used by the port; kv repeated over the group)
   and to the operations bound.

   head_dim 128, q (1,32,8192,128), kv (1,8,8192,128) bf16: B2 causal
   (single-call mode: delta pre-pass, bf16 gradients), B3a and B3b causal
   (delta given, bf16), the pair B3a + B3b with the delta pre-pass
   (single-call mode, bf16), B8 one off-diagonal and one diagonal ring
   step, SDPA's backward causal and not. Where the tree has packed
   sequences, also the segmented instantiations of B2, B3a and B3b
   (``csrc/segments.cuh``) causal on the reference's five-sequence packing
   of 8192 tokens, beside SDPA's backward with the same dense boolean
   mask; a parent without them times the rest.

   head_dim 256: Gemma-7B's attention, q and kv (1,16,8192,256) causal,
   B2, B3a and B3b; Gemma-2-9B's, q (1,16,8192,256), kv (1,8,8192,256),
   B2, B3a and B3b causal without the cap, with softcap 50 (the XFORM
   build) and with softcap 50 and the window (4096, 0) (the BAND ALL
   build, the sliding layers), and the segmented builds of B2, B3a and
   B3b without the cap and with softcap 50 on the five-sequence packing;
   B8's
   off-diagonal and diagonal ring step of 8192 rows over 8192 keys with
   softcap 50 and without. SDPA's backward causal, with the dense band
   mask, with the packing's dense mask, and not causal (beside B8).

   ``--head-dim long``: B3a past its segment class table, on llama3's
   rank 7 of W = 8 at Gemma-2-9B's widths (chip_smoke.py phase 25 (f)):
   q (1,16,65536,256) at offset 458,752, kv (1,8,524288,256), on
   ``gemma2_rank7_packing`` with softcap 50 (the XFORM SEG build) and
   without (the SEG build), and on one causal document with softcap 50
   (the XFORM build without segments), each beside its masked-flop
   bound; 2 calls a reading. No SDPA: its dense mask at 524,288 keys
   does not fit.

The loop's correctness is ``chip_smoke.py``'s (phases 5, 10 to 12, 16 to
18, 23, 25) and ``tests/test_torch_cuda.py``'s. Prints the card's name and
power limit first.
"""

import collections
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    GEMMA2_ATTN, H100_BF16_FLOPS, VARLEN_PACKINGS, band_pairs,
    causal_pairs_in, gemma2_rank7_packing, has_segments, kernel_ms, log,
    profile_loop, varlen_mask, varlen_pairs)

LOOP = ("B2 flash_bwd", "B3b flash_bwd_dkv", "B8 fused_ring_bwd")
PIECES = ("bwd_kv_kernel", "bwd_dq_kernel")


def timings(torch, args):
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    best = {}
    if args.head_dim in ("128", "both"):
        best.update(timings_128(torch, args.rounds, flush))
    if args.head_dim in ("256", "both"):
        best.update(timings_256(torch, args.rounds, flush, args.only))
    if args.head_dim == "long":
        best.update(timings_long(torch, args.rounds, flush))
    return best


def timings_long(torch, rounds, flush):
    """B3a over the 524,288 keys of llama3's rank 7 of W = 8 at
    Gemma-2-9B's widths, ``rounds`` times in turns (module docstring)."""
    import numpy as np

    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(251)
    hq, hkv, d, cap = (GEMMA2_ATTN[x] for x in (
        "heads", "kv_heads", "head_dim", "softcap"))
    ll, offset = 65536, 7 * 65536
    skv, scale = offset + ll, d ** -0.5
    lens = gemma2_rank7_packing()
    seg = torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                          dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, dout = rnd(1, hq, ll, d), rnd(1, hq, ll, d)
    k, v = rnd(1, hkv, skv, d), rnd(1, hkv, skv, d)
    packed = MaskArgs(causal=True, offset=offset, q_segids=seg[offset:],
                      kv_segids=seg)
    cases = {
        "B3a rank 7 softcap": (packed._replace(softcap=cap), lens),
        "B3a rank 7": (packed, lens),
        "B3a rank 7 one document, softcap": (
            MaskArgs(causal=True, offset=offset, softcap=cap), [skv])}
    fns, bound = {}, {}
    for name, (mask, docs) in cases.items():
        out, lse = flash_fwd_cuda(q, k, v, scale, mask,
                                  out_dtype=torch.bfloat16)
        delta = compute_delta(dout, out)
        fns[name] = (lambda mask=mask, lse=lse, delta=delta:
                     flash_bwd_dq_cuda(dout, q, k, v, lse, delta, scale,
                                       mask, dq_dtype=torch.bfloat16))
        bound[name] = (3 * 2 * hq * d * causal_pairs_in(docs, offset, ll)
                       / H100_BF16_FLOPS * 1e3)
        del out
    times = collections.defaultdict(list)
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(kernel_ms(torch, fn, 2, flush))
    for name, ts in times.items():
        best = min(t["ms"] for t in ts)
        log(f"  {name}: " + ", ".join(f"{t['ms']:.2f}" for t in ts)
            + " ms; device " + ", ".join(f"{t['device_ms']:.2f}" for t in ts)
            + f" ms; bound {bound[name]:.2f} ms, {best / bound[name]:.2f}x")
    return {name: min(t["ms"] for t in ts) for name, ts in times.items()}


def run_rounds(torch, groups, rounds, flush, flops, lib):
    """Each group of {name: fn} ``rounds`` times in turns, then one line a
    name: its times, device times and, for a kernel in ``flops``, TFLOP/s,
    the ratio to its library call ``lib[name]`` and to its operations
    bound. Returns {name: best ms}."""
    times = collections.defaultdict(list)
    device = collections.defaultdict(list)
    for group in groups:
        for _ in range(rounds):
            for name, fn in group.items():
                r = kernel_ms(torch, fn, 10, flush)
                times[name].append(r["ms"])
                device[name].append(r["device_ms"])
    for name, ts in times.items():
        line = (f"  {name}: " + ", ".join(f"{t:.3f}" for t in ts)
                + " ms; device " + ", ".join(f"{t:.3f}" for t in device[name])
                + " ms")
        if name in flops:
            best = min(ts)
            line += (f"; {flops[name] / best / 1e9:.1f} TFLOP/s, "
                     f"{best / min(times[lib[name]]):.2f}x {lib[name]}, "
                     f"bound {flops[name] / H100_BF16_FLOPS * 1e3:.3f} ms, "
                     f"{best / (flops[name] / H100_BF16_FLOPS * 1e3):.2f}x "
                     f"its operations bound")
        log(line)
    return {name: min(ts) for name, ts in times.items()}


def add_arguments(ap):
    ap.add_argument("--head-dim", choices=("128", "256", "both", "long"),
                    default="both", help="the shapes of the timings (long: "
                    "B3a past its class table at 524,288 keys)")
    ap.add_argument("--only", action="append", default=[], metavar="TEXT",
                    help="at head_dim 256, time only the kernels whose name "
                    "holds TEXT (repeatable), beside their SDPA yardstick")


def timings_128(torch, rounds, flush):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import (
        bwd_delta, flash_bwd_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    s, hq, hkv, d = 8192, 32, 8, 128
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v, dout = rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d), \
        rnd(1, hq, s, d)
    mask = MaskArgs(causal=True)
    out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
    delta = compute_delta(dout, out)
    # the ring's operands: q * scale * log2 e, v * scale, base-2 lse
    qs, vsc = fr._prescale(q, scale * fr.LOG2E), fr._prescale(v, scale)
    state = fr.new_state(qs)
    fr.fwd_step(qs, k, v, state, diagonal=True, first=True, last=False)
    rout, rlse = fr.fwd_step(qs, k, v, state, diagonal=False, first=False,
                             last=True)
    lse2 = (rlse * fr.LOG2E).contiguous()
    rdelta = bwd_delta(dout, rout) * scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dkv = torch.zeros((2, 1, hkv, s, d), dtype=torch.float32, device=dev)
    qr = q.detach().requires_grad_()
    kr = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    vr = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    o_c = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    o_n = F.scaled_dot_product_attention(qr, kr, vr)

    fns = {
        "B2": lambda: flash_bwd_cuda(dout, q, k, v, lse, None, scale, mask,
                                     out=out, dq_dtype=bf16, dkv_dtype=bf16),
        "B3a": lambda: flash_bwd_dq_cuda(dout, q, k, v, lse, delta, scale,
                                         mask, dq_dtype=bf16),
        "B3b": lambda: flash_bwd_dkv_cuda(dout, q, k, v, lse, delta, scale,
                                          mask, dkv_dtype=bf16),
        "B3a+B3b": lambda: flash_bwd_split_cuda(
            dout, q, k, v, lse, None, scale, mask, out=out, dq_dtype=bf16,
            dkv_dtype=bf16),
        "B8 off-diagonal": lambda: fr.bwd_step(
            qs, k, vsc, dout, lse2, rdelta, dq, dkv[0], dkv[1],
            diagonal=False, accumulate=True),
        "B8 diagonal": lambda: fr.bwd_step(
            qs, k, vsc, dout, lse2, rdelta, dq, dkv[0], dkv[1],
            diagonal=True, accumulate=False),
        "SDPA bwd causal": lambda: torch.autograd.grad(
            o_c, (qr, kr, vr), dout, retain_graph=True),
        "SDPA bwd non-causal": lambda: torch.autograd.grad(
            o_n, (qr, kr, vr), dout, retain_graph=True),
    }
    pairs = {"causal": s * (s + 1) // 2, "full": s * s}
    flops = {"B2": 5 * 2 * hq * d * pairs["causal"],
             "B3a": 3 * 2 * hq * d * pairs["causal"],
             "B3b": 4 * 2 * hq * d * pairs["causal"],
             "B3a+B3b": 7 * 2 * hq * d * pairs["causal"],
             "B8 off-diagonal": 5 * 2 * hq * d * pairs["full"],
             "B8 diagonal": 5 * 2 * hq * d * pairs["causal"]}
    lib = {"B2": "SDPA bwd causal", "B3a": "SDPA bwd causal",
           "B3b": "SDPA bwd causal", "B3a+B3b": "SDPA bwd causal",
           "B8 off-diagonal": "SDPA bwd non-causal",
           "B8 diagonal": "SDPA bwd causal"}
    # the segmented instantiations on the five-sequence packing, in rounds
    # of their own after the others, so that the mask-free kernels are
    # timed in the same sequence in a tree with them and in one without
    vfns = {}
    if has_segments():
        cu = VARLEN_PACKINGS[3]
        vm, dense = varlen_mask(torch, cu, True, dev)
        vout, vlse = flash_fwd_cuda(q, k, v, scale, vm, out_dtype=bf16)
        vdelta = compute_delta(dout, vout)
        o_m = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=dense)
        vfns.update({
            "B2 varlen": lambda: flash_bwd_cuda(
                dout, q, k, v, vlse, None, scale, vm, out=vout,
                dq_dtype=bf16, dkv_dtype=bf16),
            "B3a varlen": lambda: flash_bwd_dq_cuda(
                dout, q, k, v, vlse, vdelta, scale, vm, dq_dtype=bf16),
            "B3b varlen": lambda: flash_bwd_dkv_cuda(
                dout, q, k, v, vlse, vdelta, scale, vm, dkv_dtype=bf16),
            "SDPA bwd varlen mask": lambda: torch.autograd.grad(
                o_m, (qr, kr, vr), dout, retain_graph=True),
        })
        vp = varlen_pairs(cu, True)
        for name, n in (("B2 varlen", 5), ("B3a varlen", 3),
                        ("B3b varlen", 4)):
            flops[name] = n * 2 * hq * d * vp
            lib[name] = "SDPA bwd varlen mask"
    return run_rounds(torch, (fns, vfns), rounds, flush, flops, lib)


def timings_256(torch, rounds, flush, only=()):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import (
        bwd_delta, flash_bwd_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    s, d = 8192, 256
    scale = d ** -0.5
    hq, hkv, cap, wl = (GEMMA2_ATTN[x] for x in (
        "heads", "kv_heads", "softcap", "sliding_window"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def sdpa_bwd(q, k, v, dout, **kw):
        qr = q.detach().requires_grad_()
        g = q.shape[1] // k.shape[1]
        kr = k.repeat_interleave(g, dim=1).requires_grad_()
        vr = v.repeat_interleave(g, dim=1).requires_grad_()
        o = F.scaled_dot_product_attention(qr, kr, vr, **kw)
        return lambda: torch.autograd.grad(o, (qr, kr, vr), dout,
                                           retain_graph=True)

    def kv_major(name, q, k, v, dout, mask, split_dq=False):
        out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
        delta = compute_delta(dout, out)
        fns = {f"B2 {name}": lambda: flash_bwd_cuda(
                   dout, q, k, v, lse, None, scale, mask, out=out,
                   dq_dtype=bf16, dkv_dtype=bf16),
               f"B3b {name}": lambda: flash_bwd_dkv_cuda(
                   dout, q, k, v, lse, delta, scale, mask, dkv_dtype=bf16)}
        if split_dq:
            fns[f"B3a {name}"] = lambda: flash_bwd_dq_cuda(
                dout, q, k, v, lse, delta, scale, mask, dq_dtype=bf16)
        return fns

    causal_pairs = s * (s + 1) // 2
    fns, flops, lib = {}, {}, {}
    # Gemma-7B: 16 q and 16 kv heads, causal
    q, k, v, dout = (rnd(1, 16, s, d) for _ in range(4))
    fns.update(kv_major("Gemma-7B", q, k, v, dout, MaskArgs(causal=True),
                        split_dq=True))
    fns["SDPA bwd Gemma-7B causal"] = sdpa_bwd(q, k, v, dout,
                                               is_causal=True)
    for kern, n in (("B2", 5), ("B3b", 4), ("B3a", 3)):
        flops[f"{kern} Gemma-7B"] = n * 2 * 16 * d * causal_pairs
        lib[f"{kern} Gemma-7B"] = "SDPA bwd Gemma-7B causal"
    # Gemma-2-9B: 16 q heads over 8 kv heads; without the cap, the global
    # layers' softcap 50 (XFORM), the sliding layers' window and softcap
    # (BAND, the ALL build)
    q2, dout2 = rnd(1, hq, s, d), rnd(1, hq, s, d)
    k2, v2 = rnd(1, hkv, s, d), rnd(1, hkv, s, d)
    glob = MaskArgs(causal=True, softcap=cap)
    layers = {"Gemma-2 no cap": MaskArgs(causal=True),
              "Gemma-2 softcap": glob,
              "Gemma-2 window+softcap": glob._replace(window_left=wl)}
    for name, mask in layers.items():
        fns.update(kv_major(name, q2, k2, v2, dout2, mask, split_dq=True))
    fns["SDPA bwd Gemma-2 causal"] = sdpa_bwd(q2, k2, v2, dout2,
                                              is_causal=True)
    i = torch.arange(s, device=dev)
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] <= wl)
    fns["SDPA bwd Gemma-2 band mask"] = sdpa_bwd(q2, k2, v2, dout2,
                                                 attn_mask=band)
    for name in layers:
        pairs = band_pairs(s, wl) if "window" in name else causal_pairs
        sdpa = ("SDPA bwd Gemma-2 band mask" if "window" in name
                else "SDPA bwd Gemma-2 causal")
        for kern, n in (("B2", 5), ("B3b", 4), ("B3a", 3)):
            flops[f"{kern} {name}"] = n * 2 * hq * d * pairs
            lib[f"{kern} {name}"] = sdpa
    # the segmented builds (SEG, SEG with XFORM) on the reference's
    # five-sequence packing of 8192 tokens, without the cap and with it
    cu = VARLEN_PACKINGS[3]
    vm, dense = varlen_mask(torch, cu, True, dev)
    packed = {"Gemma-2 varlen": vm,
              "Gemma-2 varlen softcap": vm._replace(softcap=cap)}
    for name, mask in packed.items():
        fns.update(kv_major(name, q2, k2, v2, dout2, mask, split_dq=True))
    fns["SDPA bwd Gemma-2 varlen mask"] = sdpa_bwd(q2, k2, v2, dout2,
                                                   attn_mask=dense)
    for name in packed:
        for kern, n in (("B2", 5), ("B3b", 4), ("B3a", 3)):
            flops[f"{kern} {name}"] = n * 2 * hq * d * varlen_pairs(cu, True)
            lib[f"{kern} {name}"] = "SDPA bwd Gemma-2 varlen mask"
    # B8: one ring step of 8192 rows over 8192 keys at Gemma-2-9B's heads,
    # off-diagonal (added in place) and diagonal, with softcap 50 and not
    qs, vsc = fr._prescale(q2, scale * fr.LOG2E), fr._prescale(v2, scale)
    dq = torch.zeros(q2.shape, dtype=torch.float32, device=dev)
    dkv = torch.zeros((2, 1, hkv, s, d), dtype=torch.float32, device=dev)
    for label, c in (("softcap", cap), ("no cap", None)):
        tk = fr._transforms(q2, True, c, None)
        state = fr.new_state(qs)
        fr.fwd_step(qs, k2, v2, state, diagonal=True, first=True, last=False,
                    **tk)
        rout, rlse = fr.fwd_step(qs, k2, v2, state, diagonal=False,
                                 first=False, last=True, **tk)
        lse2 = (rlse * fr.LOG2E).contiguous()
        rdelta = bwd_delta(dout2, rout) * scale
        for diag in (False, True):
            name = f"B8 {label} {'diagonal' if diag else 'off-diagonal'}"
            fns[name] = (lambda diag=diag, tk=tk, lse2=lse2, rdelta=rdelta:
                         fr.bwd_step(qs, k2, vsc, dout2, lse2, rdelta, dq,
                                     dkv[0], dkv[1], diagonal=diag,
                                     accumulate=not diag, **tk))
            flops[name] = 5 * 2 * hq * d * (causal_pairs if diag else s * s)
            lib[name] = ("SDPA bwd Gemma-2 causal" if diag
                         else "SDPA bwd Gemma-2 not causal")
    fns["SDPA bwd Gemma-2 not causal"] = sdpa_bwd(q2, k2, v2, dout2)
    if only:
        keep = {n for n in flops if any(t in n for t in only)}
        keep |= {lib[n] for n in keep}
        fns = {n: fn for n, fn in fns.items() if n in keep}
    return run_rounds(torch, (fns,), rounds, flush, flops, lib)


if __name__ == "__main__":
    sys.exit(profile_loop("profile_torch_bwd.py", LOOP, PIECES, timings,
                          add_arguments))
