#!/usr/bin/env python3
"""Where a fused-ring forward step's time goes, on one NVIDIA H100.

Run from the root of a checkout:

    python3 profile_torch_ring.py

Times, side by side in one process and in turns (two rounds), at the fused
ring's headline step shape (q (1,32,8192,128), kv (1,8,8192,128), bf16):

- kernel B1 (``flash_fwd_cuda``) causal and not causal, and kernel B7
  (``fwd_step``) on the same work: a diagonal step, an off-diagonal step
  that reads and writes the state, and both with ``first`` and ``last`` set,
  where B7 touches no state and does exactly B1's work;
- ``merge_partials`` alone on one step's partial: what the schedule-level
  ring pays per step on top of B1 and the fused ring does not.

Then counts the SASS instructions of B1's and B7's head_dim-128 kernels by
opcode (``cuobjdump -sass`` on the built libraries), to tell a difference in
the compiled loop from a difference in how it is scheduled.

Each time is the mean of 10 calls between CUDA events, the L2 flushed before
each (``chip_smoke.cuda_ms``). Prints the card's name and power limit first.
"""

import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def sass_counts(path):
    """{kernel name: (instructions, Counter of opcodes)} of a library's
    head_dim-128 flash forward kernels."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    result = {}
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name = func.split("\n")[0]
        if "flash_fwd_kernelILi128" not in name:
            continue
        ops = collections.Counter()
        for line in func.split("\n"):
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(@!?U?P\d\s+)?([A-Z0-9_.]+)",
                         line)
            if m:
                ops[m.group(2).split(".")[0]] += 1
        result[name] = (sum(ops.values()), ops)
    return result


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_ring: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ring_flash_attn_tpu_torch.ops import _build
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.merge import merge_partials
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v = rnd(1, 32, 8192, 128), rnd(1, 8, 8192, 128), rnd(1, 8, 8192, 128)
    scale = 128 ** -0.5
    qs = fr._prescale(q, scale * fr.LOG2E)
    state = fr.new_state(qs)
    fr.fwd_step(qs, k, v, state, diagonal=True, first=True, last=False)
    part = flash_fwd_cuda(q, k, v, scale, MaskArgs(causal=True))
    causal, full = MaskArgs(causal=True), MaskArgs()

    def b7(**flags):
        return lambda: fr.fwd_step(qs, k, v, state, **flags)

    runs = {
        "B1 causal, bf16 out": lambda: flash_fwd_cuda(
            q, k, v, scale, causal, out_dtype=bf16),
        "B1 causal, fp32 out": lambda: flash_fwd_cuda(q, k, v, scale, causal),
        "B7 diagonal, first": b7(diagonal=True, first=True, last=False),
        "B7 diagonal, first and last (B1's work)": b7(
            diagonal=True, first=True, last=True),
        "B1 not causal, fp32 out": lambda: flash_fwd_cuda(q, k, v, scale,
                                                          full),
        "B7 off-diagonal, state read and written": b7(
            diagonal=False, first=False, last=False),
        "B7 off-diagonal, first and last (B1's work)": b7(
            diagonal=False, first=True, last=True),
        "merge_partials of one step's partial": lambda: merge_partials(
            *part, *part),
    }
    for rnd_no in range(2):
        for name, fn in runs.items():
            ms = chip_smoke.cuda_ms(torch, fn, 10, flush)
            print(f"round {rnd_no}: {name}: {ms:.4f} ms", flush=True)

    paths = _build.build_all()
    for lib in ("flash_fwd", "fused_ring_fwd"):
        for name, (n, ops) in sass_counts(paths[lib]).items():
            print(f"{lib} {name[:60]}: {n} instructions; "
                  + ", ".join(f"{op} {c}" for op, c in ops.most_common(12)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
