#!/usr/bin/env python3
"""The backward loops (kernels B2, B3b, B8: kv-major; B3a: q-major dq) on
one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_bwd.py [--root DIR] [--rounds N]

``--root`` imports ``ring_flash_attn_tpu_torch`` from another checkout (for
example the parent commit unpacked beside this one), so that two trees are
timed by the same code in one machine session: run parent, change, change,
parent.

1. Builds the kernels and prints ptxas's registers, spills and shared memory
   of the three instantiations of ``csrc/flash_bwd.cuh``'s loop (B2 in
   ``flash_bwd``, B3b in ``flash_bwd_split``, B8 in ``fused_ring_bwd``) and
   of B3a's loop (``bwd_dq_kernel`` in ``flash_bwd_split``), any wgmma
   serialisation notes, and the count of ``HGMMA`` instructions in their
   SASS (``cuobjdump -sass``).
2. Times, ``rounds`` times in turns, at q (1,32,8192,128), kv (1,8,8192,128)
   bf16: B2 causal (single-call mode: delta pre-pass, bf16 gradients), B3a
   and B3b causal (delta given, bf16), the pair B3a + B3b with the delta
   pre-pass (single-call mode, bf16), B8 one off-diagonal and one diagonal
   ring step, and the backward of ``F.scaled_dot_product_attention`` (timed
   only, never used by the port). Each time is the mean of 10 calls between
   CUDA events, the L2 flushed before each. Prints TFLOP/s of each kernel's
   5 (B2, B8), 4 (B3b), 3 (B3a) or 7 (the pair) products and the ratio to
   SDPA's backward.

The loop's correctness is ``chip_smoke.py``'s (phases 5, 10 to 12) and
``tests/test_torch_cuda.py``'s. Prints the card's name and power limit
first.
"""

import collections
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    H100_BF16_FLOPS, cuda_ms, log, profile_loop)

LOOP = ("B2 flash_bwd", "B3b flash_bwd_dkv", "B8 fused_ring_bwd")
PIECES = ("bwd_kv_kernel", "bwd_dq_kernel")


def timings(torch, rounds):
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
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

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
    times = collections.defaultdict(list)
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(torch, fn, 10, flush))
    lib = {"B2": "SDPA bwd causal", "B3a": "SDPA bwd causal",
           "B3b": "SDPA bwd causal", "B3a+B3b": "SDPA bwd causal",
           "B8 off-diagonal": "SDPA bwd non-causal",
           "B8 diagonal": "SDPA bwd causal"}
    for name, ts in times.items():
        line = f"  {name}: " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
        if name in flops:
            best = min(ts)
            line += (f"; {flops[name] / best / 1e9:.1f} TFLOP/s, "
                     f"{best / min(times[lib[name]]):.2f}x {lib[name]}, "
                     f"{best / (flops[name] / H100_BF16_FLOPS * 1e3):.2f}x "
                     f"its operations bound")
        log(line)
    return {name: min(ts) for name, ts in times.items()}


if __name__ == "__main__":
    sys.exit(profile_loop("profile_torch_bwd.py", LOOP, PIECES, timings))
