#!/usr/bin/env python3
"""The decode kernels (B5 on bf16 pages, B6 on quantized pages, B4 on a
contiguous quantized cache) on one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_decode.py [--root DIR] [--rounds N]

``--root`` imports ``ring_flash_attn_tpu_torch`` from another checkout (for
example the parent commit unpacked beside this one), so that two trees are
timed by the same code in one machine session: run parent, change, change,
parent.

1. Builds the kernels and prints ptxas's registers, spills and shared memory
   of the decode kernels and of the merge kernel they share.
2. Prints a sha256 digest of B4's (out, lse) on ``chip_smoke.py`` phase 7's
   inputs and of B6's on phase 8's (the same seeds and the same order of
   draws): two trees whose digests agree give the same bits.
3. Times, ``rounds`` times in turns: B5 at the serving table's shape (q
   (8,32,1,128) bf16, lens 0 to 4096, pages of 256), at the engine's 4
   lanes, with R = 16 (Tq = 4, new_counts) and on 4 x 8192 tokens in pages
   of 256; B6 on the same 4 x 8192 tokens in int8; B4 at B=1, S=32768 int8.
   Each reading is ``chip_smoke.kernel_ms``'s: ``ms`` between CUDA events
   around the call and ``dev``, the profiler's device time of what the call
   launches, the L2 flushed before each call; beside each, the least time
   the card could take (bytes).

Correctness is ``chip_smoke.py``'s (phases 3, 7, 8) and
``tests/test_torch_cuda.py``'s. Prints the card's name and power limit
first.
"""

import collections
import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    H100_BYTES_PER_S, _b5_bound_ms, kernel_ms, log, profile_loop)

LOOP = ("B5 paged_decode", "B6 paged_quant_decode", "B4 quant_decode")
PIECES = ("decode_kernel", "merge_splits_kernel")


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
    log(f"  digests of (out, lse): B4 on phase 7's inputs {b4}, B6 on "
        f"phase 8's inputs {b6}")
    return b4, b6


def timings(torch, rounds):
    from ring_flash_attn_tpu_torch.ops import paged as P
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import quantize_kv
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    digests(torch)
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
            (2 * big.k_q.numel() + 8 * big.k_scale.numel())
            / H100_BYTES_PER_S * 1e3),
    }
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    times = collections.defaultdict(list)
    for _ in range(rounds):
        for name, (fn, _) in fns.items():
            times[name].append(kernel_ms(torch, fn, 20, flush))
    for name, ts in times.items():
        bound = fns[name][1]
        best = min(t["device_ms"] for t in ts)
        log(f"  {name}: ms " + ", ".join(f"{t['ms']:.4f}" for t in ts)
            + "; dev " + ", ".join(f"{t['device_ms']:.4f}" for t in ts)
            + f"; bound {bound:.4f} ms, dev {best / bound:.1f}x it")
    return times


if __name__ == "__main__":
    sys.exit(profile_loop("profile_torch_decode.py", LOOP, PIECES, timings))
