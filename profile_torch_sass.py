#!/usr/bin/env python3
"""The block kernels' SASS in two trees, instruction for instruction.

Run from the root of a checkout on a machine with the CUDA toolkit:

    python3 profile_torch_sass.py --root PARENT

Builds this checkout's kernels and those of the tree at PARENT (for
example the parent commit unpacked beside this one), each in a process of
its own since each imports its own package, disassembles the libraries of
the forward and backward loops (``flash_fwd``, ``flash_bwd``,
``flash_bwd_split``, ``fused_ring_fwd``, ``fused_ring_bwd``) with
``cuobjdump -sass`` and holds every instantiation of ``flash_fwd_kernel``,
``bwd_kv_kernel``, ``bwd_dq_kernel`` and ``bwd_delta_kernel`` in PARENT
against the same instantiation here. An instantiation is known by its
kernel and template arguments; the BAND parameter (windows and dropout,
``csrc/band.cuh``: 0 none, 1 the build of a window alone, 2 the build for
the rest) that the three loops take last, and the XFORM flag (softcap and
ALiBi, ``csrc/xform.cuh``) that ``bwd_kv_kernel`` and ``bwd_dq_kernel``
take before it, are dropped where they have their defaults (off; XFORM
on with RING, the fused ring's B8), so that a tree without them and one
with them name the same instantiation alike. Instructions are compared
as written, operands, constant-bank offsets and immediates included;
only the branch labels are renumbered in their order of first use within
a kernel.

Prints one line an instantiation (identical, or how many instructions
differ and the first that does), then those that are new here; exits 1
if an instantiation of PARENT is missing here or differs.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
LIBS = ("flash_fwd", "flash_bwd", "flash_bwd_split", "fused_ring_fwd",
        "fused_ring_bwd")
KERNELS = ("flash_fwd_kernel", "bwd_kv_kernel", "bwd_dq_kernel",
           "bwd_delta_kernel")


def build(root):
    """{library: path} of the tree at ``root``, built by its own _build."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from ring_flash_attn_tpu_torch.ops import _build; "
            "print(json.dumps(_build.build_all()))")
    out = subprocess.run([sys.executable, "-c", code, root],
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


# the number of template arguments with the BAND parameter, the last
BAND_ARGS = {"flash_fwd_kernel": 5, "bwd_kv_kernel": 6, "bwd_dq_kernel": 4}


def key(name):
    """(kernel, template arguments) of a mangled name, the BAND and XFORM
    flags dropped where they have their defaults; None for another
    kernel."""
    m = re.search(r"(%s)I((?:L[ib]\d+E)+)E" % "|".join(KERNELS), name)
    if not m:
        return None
    kernel = m.group(1)
    args = tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m.group(2)))
    if len(args) == BAND_ARGS.get(kernel):
        if args[-1]:
            return kernel, args + ("band",)
        args = args[:-1]
    if kernel == "bwd_kv_kernel" and len(args) == 5:
        # <D, DQ, RING, SEG, XFORM = RING>
        args = args[:4] if args[4] == args[2] else args + ("new",)
    elif kernel == "bwd_dq_kernel" and len(args) == 3:
        # <D, SEG, XFORM = false>
        args = args[:2] if args[2] == 0 else args + ("new",)
    return kernel, args


def instructions(func):
    """The instructions of one kernel's SASS listing, branch labels
    renumbered in their order of first use."""
    labels = {}

    def label(m):
        return labels.setdefault(m.group(0), f".L{len(labels)}")

    out = []
    for line in func.split("\n"):
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m:
            out.append(re.sub(r"\.L_x_\d+", label, m.group(1)))
    return out


def sass(paths):
    """{(library, kernel, arguments): [instructions]} of a tree."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for lib in LIBS:
        text = subprocess.run([tool, "-sass", paths[lib]],
                              capture_output=True, text=True,
                              check=True).stdout
        for func in re.split(r"\n\s*Function : ", text)[1:]:
            k = key(func.split("\n")[0].strip())
            if k is not None:
                found[(lib,) + k] = instructions(func)
    return found


def main():
    ap = argparse.ArgumentParser(prog="profile_torch_sass.py")
    ap.add_argument("--root", required=True,
                    help="the tree to compare with (e.g. the parent)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi or 'none'}; parent {os.path.abspath(args.root)}, "
          f"change {ROOT}", flush=True)
    parent = sass(build(os.path.abspath(args.root)))
    change = sass(build(ROOT))
    bad = 0
    # the keys mix ints and the flags' names at one place ("band", "new"):
    # sorted by their text
    for k in sorted(parent, key=str):
        name = f"{k[0]} {k[1]}<{', '.join(map(str, k[2]))}>"
        if k not in change:
            print(f"  {name}: MISSING here")
            bad += 1
            continue
        a, b = parent[k], change[k]
        if a == b:
            print(f"  {name}: identical, {len(a)} instructions")
            continue
        bad += 1
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(f"  {name}: DIFFERS in {n} of {len(a)} -> {len(b)} "
              f"instructions; first at {first}: "
              f"{a[first] if first < len(a) else '-'} | "
              f"{b[first] if first < len(b) else '-'}")
    for k in sorted(set(change) - set(parent), key=str):
        print(f"  {k[0]} {k[1]}<{', '.join(map(str, k[2]))}>: new here, "
              f"{len(change[k])} instructions")
    print(f"SASS: {len(parent) - bad} of {len(parent)} instantiations of "
          f"the parent identical here", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
