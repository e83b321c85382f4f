#!/usr/bin/env python3
"""Plant softcap, window and dropout faults in a copy of the port and show
that the card's checks fail each one.

Run from the root of a checkout on a machine with the CUDA toolkit and an
H100:

    python3 check_xform_faults.py [--workdir DIR]

Copies the repository (without what .gitignore lists) into DIR (by default a new
temporary directory), once a fault and once without one, edits the copy's
kernel sources, and runs in each copy what holds the kernels there: for a
softcap fault ``tests/test_torch_cuda.py -k xform`` (the XFORM_EDGE_CASES
of ``chip_smoke.py``) and ``chip_smoke.xform_kernel_checks`` at
Llama-3-8B's attention widths (phase 17 (a) and (b), every check run and
each failure recorded instead of the first one raised); for a window or
dropout fault ``tests/test_torch_cuda.py -k band`` (the BAND_EDGE_CASES
and the keep mask bit for bit, phase 18 (a) and (b)); the copy without a
fault runs both. The faults:

  b1_no_cap     B1's XFORM builds scale the logits to base 2 and skip the
                cap (``csrc/flash_fwd.cuh``)
  bwd_no_dcap   B2's and B3b's XFORM builds (the segmented ones' one-pass
                factor and the others' dcap array, ``csrc/flash_bwd.cuh``)
                and B3a's (``csrc/flash_bwd_split.cu``) take dS without
                the softcap's 1 - tanh^2
  b1_window_off_by_one
                B1's window test on the tiles that cross a band edge
                (``csrc/flash_fwd.cuh``) takes >= for >: the key at the
                window's far edge is dropped
  b2_dv_undropped
                B2's dV (the kv-major loop with dq, ``csrc/flash_bwd.cuh``)
                takes the undropped p
  mix32_short   the kernels' mix32 (``csrc/band.cuh``) without its second
                shift step

Prints, for the copy without a fault and for each fault, the edge cases
that failed and the full-width checks that failed, and exits 1 unless the
copy without a fault passes every check and each fault fails what its
family runs (a softcap fault: some edge case and some full-width check; a
window or dropout fault: some band test). The repository itself is never
edited.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "ring_flash_attn_tpu_torch/csrc"
# fault -> [(source, the line as written, the line with the fault)]
FAULTS = {
    "none": [],
    "b1_window_off_by_one": [
        ("flash_fwd.cuh",
         "(win && rfa_band::outside(band, row - col + ring.q_pos0)))",
         "(win && (row - col + ring.q_pos0 >= band.wl ||\n"
         "                         row - col + ring.q_pos0 < -band.wr)))"),
    ],
    "b2_dv_undropped": [
        ("flash_bwd.cuh", "\n                pe[e] = kept ? p : 0.f;",
         "\n                pe[e] = kept || DQ ? p : 0.f;"),
        ("flash_bwd.cuh", "\n              pe[e] = kept ? p : 0.f;",
         "\n              pe[e] = kept || DQ ? p : 0.f;"),
    ],
    "mix32_short": [
        ("band.cuh", "  x ^= x >> 15;\n", ""),
    ],
    "b1_no_cap": [
        ("flash_fwd.cuh",
         "for (int i = 0; i < 64; ++i) sc[i] = ring.cap2 * "
         "tanh_fast(sc[i] * k2);",
         "for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;"),
    ],
    "bwd_no_dcap": [
        ("flash_bwd.cuh", "int key, float& dc) {\n"
         "          float x = sc[i];\n"
         "          const float t = x * inv_cap2;  // 0 without softcap: dc = "
         "1\n          dc = 1.f - t * t;",
         "int key, float& dc) {\n          float x = sc[i];\n"
         "          const float t = x * inv_cap2;\n"
         "          dc = 1.f; (void)t;"),
        ("flash_bwd.cuh", "sc[i] = ring.cap2 * t;\n"
         "              dcap[i] = 1.f - t * t;",
         "sc[i] = ring.cap2 * t;\n              dcap[i] = 1.f;"),
        ("flash_bwd_split.cu", "dc = 1.f - t * t;", "dc = 1.f; (void)t;"),
    ],
}

# run in a copy: the full-width checks with every failure recorded
CHECKS = r"""
import json, torch
import chip_smoke as cs
from ring_flash_attn_tpu_torch.ops import _build
_build.build_all()
failed = []
varlen_check, grads_check = cs._varlen_check, cs._grads_check
def _varlen(what, *a):
    try:
        return varlen_check(what, *a)
    except AssertionError:
        failed.append(what)
        return (0.0, 0.0, 0.0)
def _grads(what, *a):
    try:
        return grads_check(what, *a)
    except AssertionError:
        failed.append(what)
        return 0.0
cs._varlen_check, cs._grads_check = _varlen, _grads
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(17)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
q, k, v, dout = rnd(1, 32, 8192, 128), rnd(1, 8, 8192, 128), rnd(
    1, 8, 8192, 128), rnd(1, 32, 8192, 128)
cs.xform_kernel_checks(torch, q, k, v, dout, cs.alibi_slopes(torch, 32, dev))
print("FAILED " + json.dumps(failed))
"""


def make_copy(workdir, fault):
    """A copy of the repository in workdir/fault with the fault planted."""
    dst = os.path.join(workdir, fault)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        # what git leaves out (builds, outputs, caches), by its last part
        ignored = [x.strip().rstrip("/").split("/")[-1] for x in f
                   if x.strip() and not x.startswith("#")]
    shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
        ".git", *ignored))
    for src, line, planted in FAULTS[fault]:
        path = os.path.join(dst, CSRC, src)
        with open(path) as f:
            text = f.read()
        if text.count(line) != 1:
            raise SystemExit(f"{fault}: {src} holds {line!r} "
                             f"{text.count(line)} times, not once")
        with open(path, "w") as f:
            f.write(text.replace(line, planted))
    return dst


def family(fault):
    """The checks a fault's copy runs: "xform", "band", or both."""
    if fault == "none":
        return ("xform", "band")
    return ("band",) if fault in BAND_FAULTS else ("xform",)


BAND_FAULTS = ("b1_window_off_by_one", "b2_dv_undropped", "mix32_short")


def run_band(dst):
    """The band tests that failed in one copy: the BAND_EDGE_CASES by
    index, and "keep" for the keep mask bit for bit."""
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-rf",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
         "band"], cwd=dst, env=env, capture_output=True, text=True,
        timeout=900)
    if not re.search(r"\d+ (passed|failed)", res.stdout):
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise SystemExit(f"{dst}: the band tests did not run")
    failed = sorted(set(re.findall(
        r"FAILED \S+test_cuda_band_kernels_match_plain_versions\[(\d+)\]",
        res.stdout)), key=int)
    failed = [int(x) for x in failed]
    if "FAILED tests/test_torch_cuda.py::test_cuda_band_keep" in res.stdout:
        failed.append("keep")
    return failed


def run_copy(dst):
    """(failed edge cases, failed full-width checks) of one copy."""
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    res = subprocess.run([sys.executable, "-c", CHECKS], cwd=dst, env=env,
                         capture_output=True, text=True, timeout=900)
    found = [x for x in res.stdout.splitlines() if x.startswith("FAILED ")]
    if res.returncode or not found:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise SystemExit(f"{dst}: the full-width checks did not run")
    wide = json.loads(found[-1][len("FAILED "):])
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-rf",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
         "xform_kernels_match"], cwd=dst, env=env, capture_output=True,
        text=True, timeout=900)
    edges = sorted(set(re.findall(
        r"FAILED \S+test_cuda_xform_kernels_match_plain_versions\[(\d+)\]",
        res.stdout)), key=int)
    if not re.search(r"\d+ (passed|failed)", res.stdout):
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise SystemExit(f"{dst}: the edge cases did not run")
    return [int(x) for x in edges], wide


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", help="where the copies go (default: a new "
                    "temporary directory, removed at the end)")
    args = ap.parse_args()
    workdir = args.workdir or tempfile.mkdtemp(prefix="xform_faults_")
    ok = True
    try:
        for fault in FAULTS:
            dst = make_copy(workdir, fault)
            clean = True
            if "xform" in family(fault):
                edges, wide = run_copy(dst)
                print(f"{fault}: {len(edges)} softcap/ALiBi edge cases "
                      f"failed {edges}; {len(wide)} full-width checks "
                      f"failed")
                for what in wide:
                    print(f"  {what}")
                clean &= not edges and not wide
                if fault != "none":
                    ok &= bool(edges) and bool(wide)
            if "band" in family(fault):
                band = run_band(dst)
                print(f"{fault}: {len(band)} band tests failed (edge cases "
                      f"by index, keep: the keep mask bit for bit) {band}")
                clean &= not band
                if fault != "none":
                    ok &= bool(band)
            if fault == "none":
                ok &= clean
            sys.stdout.flush()
    finally:
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    print("every fault caught, the copy without one clean" if ok else
          "NOT every fault caught, or the copy without one failed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
