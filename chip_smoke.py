#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ring_flash_attn_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Environment (torch, CUDA, nvcc, triton, the card's name and power limit)
   and the build of every ``csrc/*.cu`` with nvcc for sm_90a.
2. Kernel B1 (flash forward) against its plain version in bf16, at the
   serving and training paths' shapes among others and at the forward
   loop's tile edges (Sq and Skv 1 to 257, head_dim 64 and 128, GQA groups
   1 to 8, fp32 and bf16 out, whole q tiles without a key); the HGMMA
   count of each instantiation of the loop (none may be 0); then timed at
   the causal S=8192 shape beside its flop bound and
   ``F.scaled_dot_product_attention`` (timed only, never used by the port).
3. Kernel B5 (paged decode) against its plain version: 8 lanes of ragged
   lengths over shuffled block tables, plain, with softcap, and with
   new_counts; the engine's 4 lanes; the split plan's edges
   (``b5_edge_cases``: one 32768-token lane, a lane ending on a split
   boundary, lanes of 0 and 1 token, 16-token pages, R = 16 with
   new_counts, softcap with fp32 q); every call twice, bitwise equal;
   timed beside its byte bound at the table's shape, the engine's 4 lanes
   and R = 16. Then at head dims 64 and 256 and past the rows one block
   serves (``DECODE_CASES``: Llama-3.2-1B's 32/8 heads of 64, Falcon-7B's
   71/1, Gemma-7B's 16/16 and Gemma-2B's 8/1 of 256, StarCoder's 48/1 of
   128, Tq 1 to 5 with new_counts, softcap, a dead lane), each case timed
   beside its bound (this holds for phases 7 and 8 too).
4. The ServingEngine at Llama-3-8B widths with 4 layers and seeded random
   weights: the first prefill and first decode-step logits of the kernels
   against the plain versions on the card, then 6 requests (two queue, one
   is admitted with prefix_of=, one is forked) served with the kernels,
   with the launch count of each kernel on that run, and the same traffic
   served by the plain versions for token agreement.
5. Kernels B2 (fused flash backward) and B3a/B3b (split backward) against
   their plain version in bf16, in the single-call mode (delta=None, bf16
   gradients) and the ring mode (delta given, fp32 gradients), at the
   training path's shapes among others (S=8192 whole; the last 512 q rows
   of S=36864) and at the kv-major loop's tile edges (Skv 127 to 257, Sq 63
   to 65, GQA groups 1 and 8, head_dim 64 and 128, dead rows) and the
   q-major dq loop's (``B3A_EDGE_CASES``: Sq 127 to 255, Skv 63 to 127,
   a first q tile with no key); every call twice, B3 and B2's dk/dv
   bitwise reproducible; the HGMMA count of each instantiation of both
   loops (``cuobjdump -sass``, none may be 0) and B3a's ptxas spills (none
   may spill);
   ``flash_attention`` picking B3 past the fused limit (Skv = 36864, D =
   128); timed at the causal S=8192 shape beside their flop bounds (TFLOP/s),
   the plain version and the backward of ``F.scaled_dot_product_attention``
   (timed only, never used by the port).
6. Training at the same widths (4 layers, seeded random weights): loss and
   every parameter's gradient of the kernels against the plain versions at
   S=2048, then the main path: 3 ``train_step``s at S=8192 and one at
   S=36864 (past the fused limit), with each kernel's launch count over
   that run; then one S=8192 step under ``torch.profiler``.
7. Kernel B4 (decode over a contiguous int8/fp8 cache) against its plain
   version: S=32768 at lengths 32768, 30001 and 0, both fp8 types,
   softcap, B=2, Tq=2, S=1280, a 32-token tail cache, ``length`` as a CUDA
   tensor, the decode loop's pipeline edges and 16 rows; bitwise the same
   call after call, also after calls of other shapes; timed at B=1,
   S=32768 int8 beside its byte bound, and on the 32-token tail cache;
   then ``DECODE_CASES`` (phase 3), and a length of 0 in row groups.
8. Kernel B6 (decode over int8/fp8 pages) against its plain version: 8
   lanes of ragged lengths over shuffled block tables, the three types,
   softcap, bitwise the same call after call, the pipeline edges and 16
   rows; then its path through the op-level entry points
   (``paged_quant_prefill``, 8 steps of ``paged_quant_append`` and
   ``paged_quant_decode_attention``) with its launch count; timed at B=4,
   context 8192, pages of 256 and 512, beside its byte bound and B5 in
   bf16 at the same shape; then ``DECODE_CASES`` (phase 3) and the
   op-level path again at Llama-3.2-1B's, Gemma-2B's and StarCoder's
   attention (``B6_WIDE_PATHS``), their launches counted.
9. Long-context inference at the same widths (4 layers, seeded random
   weights, one process): at a 4096-token prompt the whole path of the
   kernels against the plain versions (prefill and first decode-step
   logits), then the main path: ``generate`` on a 32768-token prompt for
   32 steps, with each kernel's launch count over that run; the first
   decode step's logits against the plain versions over the same caches;
   prefill and decode-step times; one decode step under
   ``torch.profiler``.
10. Kernels B7 and B8 (the fused ring's forward and backward steps) against
   their plain versions, step by step with the state carried over: diagonal
   and off-diagonal steps, ALiBi on global positions, softcap, non-causal,
   D 64 and 128, group 1, 4 and 8, ragged lengths at B8's and at the
   forward loop's tile edges (every pair of B7's first and last flags, with
   and without softcap/ALiBi), and the headline shape (8192 tokens a rank
   at 32/8 heads) on its last 512 q rows; B8's dk/dv bitwise reproducible,
   HGMMA in both kernels' SASS; both timed at
   the headline step beside their flop bounds and
   ``F.scaled_dot_product_attention`` (timed only).
11. The W-rank fused ring on one card: one process holds the shards of all
   W ranks (W=4 at S=32768, and W=1) and drives every rank's steps, forward
   and backward, causal and not, against B1 and B2/B3 on the whole sequence
   and the plain versions on the last 512 rows; the same causal forward
   through ``ring_attention``'s step calls (B1 + ``merge_partials``), timed
   beside the fused steps.
12. The ring entry points with no process group (world size 1) at the same
   widths: ``RingAttentionLayer`` with "fused_ring", "ring" and "zigzag"
   on (1, 8192, 32, 128), forward and backward, against the "flash" entry;
   ``train_step`` with ``attention="ring"`` and ``"zigzag"`` over
   ``sp_group=None`` for two steps at S=8192, whose losses equal phase 6's;
   each kernel's launch count over the phase.
13. Stripe and Ulysses: every W=4 rank's stripe steps of a 32768-token
   causal sequence in one process (stripe's masks, offset -1 on the steps
   after the rank; B1 + ``merge_partials``, B2) against B1 and B2 on the
   whole sequence after ``restore_stripe`` and against the plain versions
   on the last 512 rows (out, lse, dq) and the first 512 keys (dk, dv);
   each rank's forward and backward time beside the ring's on the same
   tensors, in turns; then at W=1 ``RingAttentionLayer`` with "stripe" and
   "ulysses" against the "flash" entry, the three
   ``stripe_flash_attn_*`` forms with ``deterministic=True`` (the same
   bits twice), ``train_step`` with ``attention="stripe"`` and ``"usp"``
   for two steps (phase 6's losses), and each kernel's launch count over
   the entry points.
14. MoE and tensor parallelism: a switch-MoE model at Mixtral-8x7B's
   widths (8 experts, top-1 routing, capacity factor 2, aux weight 0.01),
   2 layers, seeded random weights, one process: the loss and every
   gradient of the kernels against the plain versions at S=1024 (the plain
   run routed as the kernels' run, the flipped routes printed), then the
   main path: 3 ``train_step``s at S=4096 (s/step, tokens/s, peak memory,
   the dropped share per layer, B1/B2 launches), one profiled step broken
   down into fp32 expert GEMMs, dispatch/combine, attention kernels and
   the rest; then one Llama-3-8B-width layer's attention and MLP branches
   as tp=2 and tp=4 ranks compute them on their ``shard_params`` shards
   (B1 and B2 at 16/4 and 8/2 heads), the ranks' partials summed in the
   process against the unsharded layer (out and the sharded weights'
   gradients).
15. llama3 training: every W=4 rank of a 32768-token causal sequence in
   one process as ``_llama3_fwd``/``_llama3_bwd`` run it (B1 at 8192 q
   rows against the 32768 gathered keys at offset 8192 r; B2 with
   gathered-size dk/dv, summed over the ranks as the reduce-scatter does)
   against B1 and B2 on the whole sequence and the plain versions on the
   last 512 rows and the first 512 keys; each rank timed beside the ring's
   rank on the same tensors, in turns; the last rank of W=8 (65536 keys at
   offset 57344: B1, then B3a/B3b) against the plain versions on its last
   512 rows; then ``train_step(attention="llama3", sp_group=None)`` for
   two steps at S=8192 (phase 6's losses), with its launch counts.
16. Packed sequences: B1, B2 and B3a/B3b with segment ids and positions
   (their segmented instantiations) against their plain versions at the
   tile edges of ``SEG_EDGE_CASES`` and at q (1,32,8192,128), kv
   (1,8,8192,128) on the reference's four packings, causal on positions,
   segments alone and segments with causal by index at an offset; timed on
   each packing beside the masked-flop bound, the mask-free kernels and
   ``F.scaled_dot_product_attention`` with the dense boolean mask (timed
   only); then the varlen path, whose launches are counted:
   ``flash_attn_varlen_func`` and its qkvpacked form against
   ``backend="plain"``, ring varlen's and llama3 varlen's W=4 ranks
   (32768 packed tokens; the reference's packings scaled x4; llama3 at
   ``heads_k_stride`` 4 and 8) in one process against
   ``flash_attn_varlen_func`` on the whole packing, each rank timed, and
   the entry points at W=1.
17. Softcap and ALiBi: B1, B2 and B3a/B3b in their XFORM instantiations
   against their plain versions at the tile edges of ``XFORM_EDGE_CASES``
   and at q (1,32,8192,128), kv (1,8,8192,128) with softcap 50, with ALiBi
   on the standard slopes of 32 heads and with both, causal, not causal, at
   an offset, and segmented on the reference's four packings (and the
   five-sequence packing without a causal mask), softcap also on q x 4,
   whose logits the cap bends (the edge cases' caps of 2 to 5 do the same
   at their sizes); each instantiation timed
   causal and on the five-sequence packing beside its flop bound, the same
   kernel without the transform and, for ALiBi, SDPA with the bias as a
   dense float mask (timed only); then the xform path, whose launches are
   counted: ``flash_attn_func`` and ``flash_attn_varlen_func`` with both
   transforms against ``backend="plain"``, the ring, zigzag and stripe
   schedules' W=4 ranks of S=32768 with ALiBi and llama3's with softcap and
   ALiBi in one process through the modules' per-rank functions and step
   masks (against the
   kernels on the whole sequence and plain on its last rows), llama3's
   W=8 last rank with ALiBi at 65536 keys (B3a/B3b); then the
   zigzag_varlen path: zigzag varlen's W=4 ranks on 32768 tokens (4 x
   8192 and the reference's packings x 4), forward and backward, without a
   transform and with ALiBi, against ``flash_attn_varlen_func`` on the
   whole packing and plain on each rank's last rows, and the entry point
   at W=1.
18. Windows and dropout: B1, B2 and B3a/B3b in their BAND instantiations
   at the tile edges of ``BAND_EDGE_CASES``, the keep mask bit for bit,
   Mistral-7B-v0.1's attention (window 4096) at S = 32768 and dropout 0.1
   at S = 8192, timed; then the band path through every entry point that
   takes a window or dropout.
19. The ServingEngine's options on phase 4's model and pool: (a)
   ``prefill_chunk=512`` against the dense engine on phase 4's traffic,
   every chunk's B1 (causal at offset p_len over the lane's gathered
   pages) against its plain version and against itself with the keys and
   values past the chunk's last kv tile set to NaN (those tiles must be
   skipped), B1 at ragged chunks of 320, 192 and 64 rows, and the first
   token of a 256-token request behind a 3840-token prompt, dense and
   chunked; (b) ``speculate_k`` 4 (16 rows a kv head) and 8 (32 rows: one
   launch of B5 a layer, two row groups of 16 on its grid) on repetitive
   prompts against the plain greedy engine,
   every verify's B5 against ``_plain_paged_decode``, drafts proposed and
   accepted, tokens a decode step, and one verify forward's wall and
   device time beside a plain decode step's; (c) ``mesh=`` over a gloo
   group of one (the same tokens as without it) and a tp=2 decode step in
   one process, the ranks' partials (``transformer._attn_branch``) summed,
   against the unsharded ``_decode_body`` and the plain versions. Where
   an engine's tokens part from the reference engine's, the reference's
   top-two logit margin there must be under phase 4's 5e-2 (the share of
   the reference's tokens under it is logged), and the logits every token
   of (a) and (b) was sampled from, up to that parting, must lie within
   5e-2 of max|logit| of the reference engine's for the same token. The
   path's launches are those of the engine runs with the options, (a) to
   (c).
20. The HF adapter's ``ring_attention_forward`` at Llama-3-8B attention
   widths on phase 16's packings of 32768 tokens: at W=1 through
   ``position_ids`` and through DATA_PARAMS, forward and backward, against
   ``flash_attn_varlen_func`` on the whole packing and against the plain
   versions (out and dq of the last 512 rows, dk and dv of the first 512
   keys); the W=4 ranks' labels from both paths (equal), each rank
   through llama3's rank functions (out, lse, dq, the summed dk and dv),
   each rank timed on two packings. The path's launches are those of the
   W=1 calls.
21. The GPipe pipeline: ``train_step_pp`` with one stage (no pp group) and
   2 microbatches of 4096 tokens at phase 6's widths against
   ``train_step`` on the same batch (loss, gradients, the updated
   weights) and its loss against ``loss_fn`` on the plain versions, both
   steps timed; the counted step takes a data group (a gloo group of
   one).
22. The utils and the entry points: ``entry()``'s flagship logits against
   ``backend="plain"`` (on its zero tokens and on random ones); ``dryrun_multichip(1, "cuda")`` (a spawned NCCL
   process of one, JAX's first configuration in bf16 at head_dim 64, its
   kernel launches reported back); a checkpoint round trip of the
   flagship model (the restored tensors bit-identical on the card, the
   resumed step's loss equal to the uninterrupted one); ``timed`` on B1
   at q (1,32,8192,128) causal within 10% of the profiler's device time
   of the same chain (``trace_device_time``; ``cuda_ms``, one call at a
   time, read beside);
   ``trace_device_time`` and ``trace_device_busy`` on phase 4's engine's
   decode step, its busy share beside PERF.md's 22 to 25%.
23. Head_dim 256 (Gemma): B1, B2, B3a and B3b in their head_dim 256
   instantiations, mask-free and segmented, against their plain versions
   at the head_dim 128 phases' limits, at the tile edges of
   ``D256_EDGE_CASES`` and at Gemma-7B's (16/16 heads) and Gemma-2B's
   (8/1) attention at S = 8192, causal and on the reference's four
   packings; timed at Gemma-7B's beside the flop bound (equal to the
   head_dim 128 table's), the head_dim 128 kernels at equal flops and
   SDPA at head_dim 256 (timed only); then the gemma path, whose launches
   are counted: ``flash_attn_func`` (and with ``deterministic=True``) and
   ``flash_attn_varlen_func`` on the four packings against the plain
   versions, and phase 20 at Gemma-7B's widths (``ring_attention_forward``
   at W=1 on 32768 tokens, past B2's limit: B3a and B3b; the W=4 ranks).
24. The engine and ``generate`` at the decode loop's new builds
   (``DECODE_MODELS``, published widths, seeded random weights):
   Llama-3.2-1B (head_dim 64, its 16 layers), Gemma-7B (head_dim 256, cut
   to 4 layers) and StarCoder (48/1 heads of 128, cut to 2 layers): the
   engine's first prefill and decode-step logits against the plain
   versions, phase 4's traffic (prefill tokens/s, decode steps/s; for
   StarCoder also a speculative run at k = 4 whose verifies, 192 rows a
   kv head, are held against the plain version), a decode step's busy
   share through ``utils.trace_timing``; then ``generate`` (32768 prompt
   tokens for Llama-3.2-1B, 8192 for the others; 32 steps) with its
   launches, and its first decode step's logits against the plain
   versions over the same caches. The paths' launches of B4 and B5 give
   the kernels line's entries of the new builds (B6's come from phase 8).
25. Gemma 2 at head_dim 256 (Gemma-2-9B's attention, 16/8 heads of 256,
   softcap 50, the window (4096, 0) on its sliding layers): (a) the
   softcap/ALiBi and window/dropout builds of B1, B2, B3a/B3b and B7/B8 at
   256 against their plain versions at the tile edges
   (``D256_XFORM_EDGE_CASES``, ``D256_BAND_EDGE_CASES``, ``D256_RING_CASES``:
   caps of 2 to 5 that bend the logits among them), B1 and B7 on logits
   that grow along the keys (``d256_growth_check``: the forward loop's
   running max, which may lag by 2^8, catching up), on the last 512 of
   8192 rows, global and sliding, with q and q x 4, and B7/B8 on a rank's
   diagonal step and an earlier shard of 8192 keys (softcap 50 and 5) on
   its last 512 rows; (b) timed at S = 8192
   beside the flop bound (causal pairs, or the window's band), the same
   kernel without the softcap, the plain version and SDPA (is_causal, or
   the dense band mask; without softcap); (c) B7 and B8 at 256 for an
   off-diagonal and a diagonal step of 8192 rows, beside SDPA not causal;
   (d) the gemma2 path, whose launches are counted by build:
   ``flash_attn_func`` (and deterministic) and ``flash_attn_varlen_func``,
   global and sliding, against the plain versions' last rows; ring and
   zigzag at W=4 over 32768 tokens, global and sliding, and the fused ring
   (``bwd_mode`` fused: B8; auto, which picks the schedule's B2 at these
   widths) against the kernels on the whole sequence; the adapter's
   ``ring_attention_forward(softcap=50)`` at W=1; (e) a decode step and a
   verify step with ``append=False`` at phase 4's widths: no page written,
   the logits against the plain versions', each timed beside
   ``append=True``.

Every kernel is timed twice at its shape, L2 flushed before each call:
``ms`` between CUDA events around the wrapper's call and ``device_ms``,
the profiler's device time of what the call launches. They part where a
call's launches take less device time than the host needs to issue them
(B4, B6).

Prints the card's name and power limit, then one JSON line with every
kernel's numbers (with ptxas's registers, spills and static shared memory
of its head_dim-128 instantiation), then ``{"ok": true, "device": {...}}``
as the last line.
Exits non-zero, printing no result, without CUDA or without the package.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM
B1_OUT_TOL, B1_LSE_TOL = 2e-2, 1e-3  # bf16 P in P@V, bf16 out
# B5: fp32 on the plain side; the kernel's tensor-core products take q and
# p in two bf16 halves (16 bits) against the exact bf16 cache
B5_TOL = 2e-3
# B4 and B6 take q and p in two fp16 halves (~22 bits, after a power-of-two
# prescale) against cache values that are exact in fp16, so they stay
# within a few ulps of the plain versions' fp32 (the int8 QK product of
# B6 is exact on both sides); the summation order, __expf and tanhf
# differ too (out is O(1e-2) and lse O(10) at S=32768). One 64-token chunk
# dropped of 32768 would move out by about 4e-4 and lse by about 2e-3, far
# past this limit
QUANT_TOL = 1e-5
LOGITS_REL_TOL = 5e-2  # |kernel - plain| / max|plain| after 4 bf16 layers
# |kernel - plain| / max|plain| of dq, dk, dv: p and ds enter bf16 tensor-core
# products, and B2's dq sums through atomics in run-dependent order
BWD_REL_TOL = 2e-2
# the fused ring's backward where every row sees one key: the plain dq and
# dk are exactly 0 and the kernel's are its rounding noise, held to this
# share of max|dv| (the H100 reads 1.9e-7 at head_dim 256, 0 at 128)
ONE_KEY_NOISE_TOL = 1e-5
# lse of the fused ring against kernels that take q as it is: the ring's q
# is pre-scaled by scale * log2(e) and rounded to bf16 before its steps, as
# the JAX wrapper rounds it (2^-9 of each element), which moves a logit of
# a few units, and lse with it, by some 1e-3 (B7 against its plain version,
# which rounds q too, stays within B1_LSE_TOL)
RING_LSE_TOL = 1e-2
# the ring's out, |kernel - ref| / max|ref|: a row of the ring sees 8192 keys
# or more, so |out| is a few 1e-2 and an absolute limit of B1_OUT_TOL would
# pass any value at all. Causal rows near the start of the sequence are O(1)
# and would hide the late rows behind their maximum, so the sequence is cut
# into parts (a rank's shard each) and the worst part counts. One bf16 ulp
# of out is at most 7.8e-3 of its value. B1's out is held to it as well,
# row by row (``rel_err_rows``), beside its absolute B1_OUT_TOL
RING_OUT_REL_TOL = 2e-2
LOSS_TOL = 1e-2  # |loss kernels - loss plain|, 4 bf16 layers
GRAD_REL_TOL = 5e-2  # ||g kernels - g plain|| / ||g plain|| per parameter
FULL_WIDTH = dict(vocab=32000, dim=4096, layers=4, heads=32, kv_heads=8,
                  head_dim=128, mlp_dim=14336, dtype="bfloat16")

# the forward loop's tile edges (128 q rows a block, 128 keys a tile), held
# here (phases 2 and 10) and in tests/test_torch_cuda.py. B1: (B, Hq, Hkv,
# Sq, Skv, D, causal, offset, out dtype): Sq and Skv in {1, 127, 128, 129,
# 255, 257}, both head dims, GQA groups 1 to 8, fp32 and bf16 out, and
# offsets that leave whole q tiles without a key (their blocks load nothing
# and write (0, NEG_INF))
B1_EDGE_CASES = [
    (1, 4, 2, 1, 1, 128, True, 0, "bfloat16"),
    (1, 4, 1, 127, 127, 64, True, 0, "float32"),
    (1, 8, 2, 128, 128, 128, True, 0, "bfloat16"),
    (2, 4, 4, 129, 129, 64, False, None, "float32"),
    (1, 8, 8, 255, 257, 128, True, 2, "bfloat16"),
    (1, 8, 2, 257, 255, 64, True, -2, "float32"),
    (1, 4, 2, 257, 1, 128, False, None, "bfloat16"),
    (1, 4, 2, 1, 257, 64, True, 256, "float32"),
    (1, 4, 2, 257, 129, 128, True, -200, "float32"),
    (1, 4, 2, 300, 128, 64, True, -256, "bfloat16"),
    (1, 8, 1, 129, 255, 128, False, None, "float32"),
    (1, 2, 1, 128, 257, 64, True, 129, "bfloat16"),
]
# B7: (Hq, Hkv, Sq, Skv, D, causal, softcap, ALiBi, steps), the steps of the
# last rank of a ring of ``steps`` (``ring_steps``): one step is first and
# last at once; three give (first, not last), (neither), (last, not first)
B7_EDGE_CASES = [
    (4, 2, 1, 1, 128, True, None, False, 1),
    (8, 2, 127, 129, 64, True, None, False, 3),
    (8, 8, 128, 128, 128, False, None, False, 3),
    (8, 1, 129, 127, 128, True, 20.0, True, 3),
    (4, 2, 255, 257, 64, False, 30.0, True, 1),
    (8, 2, 257, 255, 128, True, None, True, 3),
    (4, 4, 1, 257, 64, True, 25.0, False, 3),
    (8, 2, 257, 1, 128, False, None, False, 3),
    # caps of 2 to 5 that bend the N(0, 1) logits at 64 and 128
    (8, 2, 129, 127, 128, True, 3.0, True, 3),
    (4, 2, 127, 129, 64, False, 2.0, False, 2),
    (4, 1, 200, 200, 128, False, 5.0, False, 3),
]

# the q-major dq loop's tile edges (B3a: 128 q rows a block, 64 keys a
# tile), held here (phase 5) and in tests/test_torch_cuda.py's BWD_CASES:
# (B, Hq, Hkv, Sq, Skv, D, causal, offset) with Sq in {127, 128, 129, 191,
# 255} against Skv in {63, 64, 65, 127}, GQA groups 1 and 8, both head
# dims, and negative offsets whose first q tile sees no key (its block
# loads nothing and writes zeros)
B3A_EDGE_CASES = [
    (1, 8, 1, 127, 63, 128, False, None),
    (1, 8, 8, 128, 64, 64, True, -64),
    (2, 16, 2, 129, 65, 128, True, 0),
    (1, 8, 8, 191, 127, 64, True, 64),
    (1, 8, 1, 255, 63, 128, True, -128),
    (1, 4, 4, 127, 127, 64, True, 0),
    (1, 8, 1, 128, 65, 64, False, None),
    (1, 8, 8, 129, 64, 128, True, -1),
    (1, 16, 2, 191, 63, 64, True, -100),
    (1, 8, 8, 255, 65, 128, False, None),
    (1, 8, 1, 191, 64, 128, True, 10),
    (1, 8, 8, 255, 127, 64, True, -128),
]


# packed sequences (phase 16): the reference's four packings of 8192 tokens
# (benchmark/benchmark_varlen_kvpacked_func.py:45-50)
VARLEN_PACKINGS = [
    [0, 8192],
    [0, 256, 7648, 8192],
    [0, 4096, 8192],
    [0, 3104, 6304, 7904, 8064, 8192],
]
# B1, B2, B3a/B3b with segment ids and positions at their tile edges, held
# here (phase 16) and in tests/test_torch_cuda.py: (B, Hq, Hkv, Sq, Skv, D,
# kind, cu) with kind "pos" (causal on positions, packed_self), "seg"
# (segments only), "idx" (segments and causal by index at offset Skv - Sq,
# llama3's form: q is the last Sq rows of the packing cu over Skv keys),
# "shuffled" (shuffled segment ids and non-monotone positions, causal on
# positions without packed_self: no bound by index may apply) and "absent"
# (a q segment kv lacks: dead rows; kv rows no q row sees)
SEG_EDGE_CASES = [
    (1, 4, 2, 1, 1, 128, "pos", [0, 1]),
    (1, 4, 2, 127, 127, 128, "pos", [0, 1, 60, 127]),
    (1, 8, 1, 129, 129, 64, "pos", [0, 128, 129]),
    (1, 4, 4, 257, 257, 128, "seg", [0, 100, 101, 257]),
    (2, 4, 2, 257, 257, 64, "shuffled", [0, 257]),
    (1, 8, 8, 129, 129, 128, "shuffled", [0, 129]),
    (1, 4, 2, 200, 300, 128, "absent", [0, 70, 300]),
    (1, 8, 2, 129, 257, 128, "idx", [0, 50, 200, 257]),
    (1, 8, 1, 127, 255, 64, "idx", [0, 128, 255]),
    (1, 16, 2, 300, 300, 64, "pos", [0, 3, 131, 132, 300]),
]


# B1, B2, B3a/B3b with softcap and/or ALiBi (their XFORM instantiations)
# at the tile edges, held here (phase 17) and in tests/test_torch_cuda.py:
# (B, Hq, Hkv, Sq, Skv, D, kind, cu, softcap, ALiBi) with kind "causal"
# (causal by index at offset Skv - Sq), "full" (no mask; ALiBi on
# |distance| at the offsets Sq and 3), "posfull" (segments and explicit
# positions without a causal mask: ALiBi on their |distance|, the varlen
# rings' off-diagonal steps), "strided" (causal on positions 4 i + 1 and
# 4 j + 2, stripe's form: tiles whose positions step by 4) or a kind of
# SEG_EDGE_CASES ("shuffled": no tile has a step); ALiBi on the standard
# slopes of Hq heads (``alibi_slopes``). The caps of 2 to 5 bend the
# inputs' N(0, 1) logits, so that a build without the cap, or without its
# 1 - tanh^2 in the backward, fails them (at caps of 20 to 50 such a build
# moves dS by 0.5% or less); one of them for every build: with and
# without SEG, both head dims, unmasked and masked bodies
XFORM_EDGE_CASES = [
    (1, 4, 1, 1, 1, 128, "causal", None, 50.0, True),
    (1, 8, 2, 127, 129, 64, "causal", None, 50.0, False),
    (1, 8, 2, 129, 257, 128, "causal", None, None, True),
    (2, 4, 4, 128, 255, 64, "full", None, 30.0, True),
    (1, 8, 2, 257, 129, 128, "full", None, None, True),
    (1, 4, 2, 127, 127, 128, "pos", [0, 1, 60, 127], 50.0, True),
    (1, 8, 2, 129, 129, 64, "posfull", [0, 128, 129], None, True),
    (1, 4, 1, 257, 257, 128, "seg", [0, 100, 101, 257], 20.0, True),
    (2, 4, 2, 257, 257, 64, "shuffled", [0, 257], 50.0, True),
    (1, 4, 2, 200, 300, 128, "absent", [0, 70, 300], None, True),
    (1, 8, 2, 129, 257, 128, "idx", [0, 50, 200, 257], 50.0, True),
    (1, 16, 4, 300, 300, 128, "posfull", [0, 3, 131, 132, 300], 30.0, True),
    (1, 8, 2, 257, 255, 128, "strided", None, None, True),
    (1, 4, 1, 129, 300, 64, "strided", None, 50.0, True),
    (1, 8, 2, 129, 257, 128, "causal", None, 4.0, False),
    (2, 4, 4, 128, 255, 64, "full", None, 2.0, True),
    (1, 4, 2, 127, 127, 128, "pos", [0, 1, 60, 127], 3.0, False),
    (1, 8, 2, 129, 129, 64, "posfull", [0, 128, 129], 4.0, True),
    (2, 4, 2, 257, 257, 64, "shuffled", [0, 257], 2.0, False),
    (1, 8, 2, 129, 257, 128, "idx", [0, 50, 200, 257], 3.0, True),
    (1, 8, 2, 257, 255, 128, "strided", None, 5.0, True),
]


# B1, B2, B3a/B3b with a window and/or dropout (their BAND instantiations)
# at the tile edges, held here (phase 18) and in tests/test_torch_cuda.py:
# (B, Hq, Hkv, Sq, Skv, D, kind, cu, window_left, window_right, dropout_p,
# softcap, ALiBi) with the kinds of XFORM_EDGE_CASES: causal windows whose
# left side wl in {0, 63, 64, 127, 128, 4095} sits on and beside the tiles'
# edges (64 and 128 keys or rows), non-causal (wl, wr) windows at offsets
# Sq and 3 (so that whole tiles fall outside the band on either side),
# windows with softcap and ALiBi, dropout with and without segments (and
# with explicit positions: shuffled, strided), windows on explicit
# positions, a window on segments by index with dead rows, window and
# dropout together; both head dims, with and without SEG. Dropout cases
# take the seed 1000 + case and head offset 5
BAND_EDGE_CASES = [
    (1, 4, 2, 257, 257, 128, "causal", None, 0, None, None, None, False),
    (1, 8, 2, 255, 300, 64, "causal", None, 63, None, None, None, False),
    (1, 4, 1, 257, 257, 128, "causal", None, 64, None, None, None, False),
    (2, 4, 2, 300, 300, 64, "causal", None, 127, None, None, None, False),
    (1, 8, 8, 129, 257, 128, "causal", None, 128, None, None, None, False),
    (1, 4, 2, 300, 300, 128, "causal", None, 4095, None, None, None, False),
    (1, 4, 2, 257, 255, 128, "full", None, 63, 64, None, None, False),
    (1, 8, 2, 129, 300, 64, "full", None, 0, 127, None, None, False),
    (1, 4, 2, 255, 257, 128, "full", None, None, 128, None, None, False),
    (1, 8, 2, 257, 257, 128, "causal", None, 100, None, None, 4.0, True),
    (1, 4, 2, 257, 255, 64, "full", None, 70, 30, None, 3.0, True),
    (2, 4, 2, 257, 257, 128, "causal", None, None, None, 0.1, None, False),
    (1, 8, 2, 129, 300, 64, "full", None, None, None, 0.3, None, False),
    (1, 4, 2, 257, 257, 128, "pos", [0, 100, 101, 257], None, None, 0.2,
     None, False),
    (2, 4, 2, 257, 257, 64, "shuffled", [0, 257], None, None, 0.1, None,
     True),
    (1, 8, 2, 257, 255, 128, "strided", None, None, None, 0.1, None, False),
    (1, 8, 2, 129, 257, 128, "idx", [0, 50, 200, 257], 64, None, 0.1, None,
     False),
    (1, 4, 2, 300, 300, 128, "pos", [0, 3, 131, 132, 300], 64, None, None,
     None, False),
    (1, 4, 2, 200, 300, 64, "absent", [0, 70, 300], 63, None, None, None,
     False),
    (1, 4, 1, 257, 257, 128, "posfull", [0, 128, 129, 257], 40, 40, 0.1,
     None, True),
    (1, 8, 2, 129, 129, 64, "seg", [0, 128, 129], 10, 5, 0.2, 2.0, False),
    (1, 4, 2, 257, 257, 128, "causal", None, 64, None, 0.1, None, False),
    (1, 4, 2, 257, 257, 64, "shuffled", [0, 257], 90, None, 0.15, 3.0,
     False),
    (1, 4, 2, 257, 255, 128, "full", None, None, 0, None, None, False),
    (1, 8, 2, 255, 300, 64, "full", None, 4095, 63, None, None, False),
    (2, 4, 4, 129, 257, 128, "full", None, 127, 4095, None, None, False),
]


def band_case_mask(torch, case, dev, seed=0):
    """The MaskArgs of a ``BAND_EDGE_CASES`` case on ``dev``."""
    b, hq, hkv, sq, skv, d, kind, cu, wl, wr, p, softcap, alibi = case
    mask = xform_case_mask(torch, (b, hq, hkv, sq, skv, d, kind, cu, softcap,
                                   alibi), dev, seed)
    if p:
        mask = mask._replace(dropout_p=p, dropout_seed=1000 + seed,
                             head_offset=5)
    return mask._replace(window_left=wl, window_right=wr)


def band_case_check(torch, case, table=None):
    """B1, B2 and B3a/B3b (both calling modes) with ``table[case]``
    (BAND_EDGE_CASES by default) against their plain versions: out and lse (B1_OUT_TOL, by rows
    RING_OUT_REL_TOL, B1_LSE_TOL), dq, dk, dv (BWD_REL_TOL), dead rows (0,
    NEG_INF, dq = 0) and unseen keys (dk = dv = 0), B3 bitwise the same
    twice, every launch a BAND launch. Raises past the limits; returns the
    worst errors {kernel: [abs, rel(, lse)]}."""
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import NEG_INF, allowed_mask
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)

    table = BAND_EDGE_CASES if table is None else table
    b, hq, hkv, sq, skv, d = table[case][:6]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(case)
    mask = band_case_mask(torch, table[case], dev, seed=case)
    scale = d**-0.5
    counters = (flash_fwd_cuda, flash_bwd_cuda, flash_bwd_dq_cuda,
                flash_bwd_dkv_cuda)
    before = [f.band_launches for f in counters]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, dout = (rnd(b, hq, sq, d), rnd(b, hkv, skv, d),
                     rnd(b, hkv, skv, d), rnd(b, hq, sq, d))
    out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=torch.bfloat16)
    got_out, got_lse = flash_fwd_cuda(q, k, v, scale, mask)
    ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
    worst = {"B1": [max_err(got_out, ref_out), rel_err_rows(got_out, ref_out),
                    max_err(got_lse, ref_lse)]}
    what = f"band edge case {case} {table[case]}"
    if (worst["B1"][0] > B1_OUT_TOL or worst["B1"][1] > RING_OUT_REL_TOL
            or worst["B1"][2] > B1_LSE_TOL):
        raise AssertionError(f"{what}: B1 {worst['B1']}")
    allowed = allowed_mask(mask, sq, skv, dev)
    if allowed is None:
        allowed = torch.ones(sq, skv, dtype=torch.bool, device=dev)
    dead_rows, dead_keys = ~allowed.any(1), ~allowed.any(0)
    if not (torch.all(got_lse[:, :, dead_rows] == NEG_INF)
            and torch.all(got_out[:, :, dead_rows] == 0)):
        raise AssertionError(f"{what}: B1's dead rows are not (0, NEG_INF)")
    delta = compute_delta(dout, out)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
    # where every row sees one key the softmax has no gradient: dq and dk
    # are rounding noise on both sides, held on dv's scale
    one_key = bool((allowed.sum(1) <= 1).all())
    floor = float(ref[2].abs().max()) if one_key else 0.0
    for name, bwd in (("B2", flash_bwd_cuda), ("B3", flash_bwd_split_cuda)):
        got = bwd(dout, q, k, v, lse, delta, scale, mask)
        rel = [max_err(x, r) / max(float(r.abs().max()), floor, 1e-6)
               for x, r in zip(got, ref)]
        if name == "B2":
            worst["B2"] = [max(max_err(x, r) for x, r in zip(got, ref)),
                           max(rel)]
        else:
            worst["B3a"] = [max_err(got[0], ref[0]), rel[0]]
            worst["B3b"] = [max(max_err(got[1], ref[1]),
                                max_err(got[2], ref[2])), max(rel[1:])]
        if max(rel) > BWD_REL_TOL:
            raise AssertionError(f"{what}: {name} dq, dk, dv {rel}")
        if not (torch.all(got[0][:, :, dead_rows] == 0)
                and torch.all(got[1][:, :, dead_keys] == 0)
                and torch.all(got[2][:, :, dead_keys] == 0)):
            raise AssertionError(f"{what}: {name} dead rows or unseen keys")
        again = bwd(dout, q, k, v, lse, delta, scale, mask)
        same = [torch.equal(x, y) for x, y in zip(got, again)]
        if same[1:] != [True, True] or not (same[0] or name == "B2"):
            raise AssertionError(f"{what}: {name} not reproducible {same}")
    ran = [f.band_launches - n for f, n in zip(counters, before)]
    if ran != [2, 2, 2, 2]:
        raise AssertionError(f"{what}: BAND launches {ran}, not 2 each")
    return worst


# the keep mask's cases (phase 18 (b)): (B, H, q offset, kv offset, head
# offset, form) at Sq = Skv = D = 128 with q = 0: by index at offsets up
# to and past 2^31 (kv positions that cross 2^31, and offsets past 2^32
# that wrap), batch 2, segments, explicit positions that step by 3 (an
# unmasked tile's first position and step) or are shuffled (the masked
# body's), near 2^31
BAND_KEEP_CASES = [
    (1, 4, 0, 0, 0, "index"),
    (2, 4, 5, 2**31 - 64, 3, "index"),
    (1, 2, 2**31 + 100, 2**32 + 2**31 - 50, 7, "index"),
    (2, 8, 17, 300, 11, "segments"),
    (1, 4, 2**31 - 1000, 2**31 - 700, 2, "strided"),
    (2, 2, 0, 0, 9, "shuffled"),
]


def band_keep_mask(torch, case, dev):
    """The MaskArgs of a BAND_KEEP_CASES case (dropout 0.3, not causal)."""
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs

    b, h, qo, ko, ho, form = case
    n = 128
    mask = MaskArgs(dropout_p=0.3, dropout_seed=12345 + ho, head_offset=ho)
    if form == "index":
        return mask._replace(offset=qo, kv_offset=ko)
    if form == "segments":
        rng = np.random.default_rng(ho)
        seg = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int32,
                              device=dev)
        return mask._replace(offset=qo, kv_offset=ko, q_segids=seg,
                             kv_segids=seg)
    i = torch.arange(n, dtype=torch.int32, device=dev)
    if form == "strided":
        return mask._replace(q_pos=i + qo, kv_pos=i * 3 + ko)
    perm = torch.as_tensor(np.random.default_rng(ho).permutation(n),
                           dtype=torch.int32, device=dev)
    return mask._replace(q_pos=perm * 2, kv_pos=i * 5 + 7)


def band_keep_checks(torch):
    """Phase 18 (b): the kernels' dropout keep mask bit for bit against the
    plain one (``ops/mask.py::dropout_keep_dense``, the JAX package's). With
    q = 0 every allowed p is the same, so B1 with v the 128 x 128 identity
    gives out = 0 exactly at the dropped (or masked) pairs, and B2 and B3b
    with dout the identity give that pattern transposed in dv (one q head a
    kv head). Returns [(what, agrees)]."""
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import (allowed_mask,
                                                    dropout_keep_dense)

    dev = torch.device("cuda")
    n = 128
    eye = torch.eye(n, dtype=torch.bfloat16, device=dev)
    results = []
    for case in BAND_KEEP_CASES:
        b, h = case[:2]
        mask = band_keep_mask(torch, case, dev)
        q = torch.zeros(b, h, n, n, dtype=torch.bfloat16, device=dev)
        k = torch.randn(b, h, n, n, device=dev).to(torch.bfloat16)
        v = eye.expand(b, h, n, n).contiguous()
        want = dropout_keep_dense(mask, b, h, 1, n, n, dev).reshape(
            b, h, n, n)
        allowed = allowed_mask(mask, n, n, dev)
        if allowed is not None:
            want = want & allowed
        out, lse = flash_fwd_cuda(q, k, v, 1.0, mask)
        results.append((f"B1 {case}", bool(torch.equal(out != 0, want))))
        delta = torch.zeros_like(lse)
        for name, fn in (("B2", flash_bwd_cuda), ("B3b", flash_bwd_dkv_cuda)):
            _, dv = fn(v, q, k, v, lse, delta, 1.0, mask)[-2:]
            results.append((f"{name} {case}", bool(torch.equal(
                dv.transpose(-1, -2) != 0, want))))
    return results


def alibi_slopes(torch, hq, dev):
    """The standard ALiBi slopes of ``hq`` heads, 2^(-8 (h + 1) / hq),
    float32 on ``dev``."""
    return torch.tensor([2.0 ** (-8.0 * (h + 1) / hq) for h in range(hq)],
                        dtype=torch.float32, device=dev)


def xform_case_mask(torch, case, dev, seed=0):
    """The MaskArgs of an ``XFORM_EDGE_CASES`` case on ``dev``."""
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs

    _, hq, _, sq, skv, _, kind, cu, softcap, alibi = case
    if kind == "causal":
        mask = MaskArgs(causal=True, offset=skv - sq)
    elif kind == "full":
        mask = MaskArgs(offset=sq, kv_offset=3)
    elif kind == "posfull":
        mask = seg_case_mask(torch, "pos", sq, skv, cu, dev)._replace(
            causal=False, packed_self=False)
    elif kind == "strided":
        mask = MaskArgs(causal=True, q_pos=torch.arange(
            sq, dtype=torch.int32, device=dev) * 4 + 1, kv_pos=torch.arange(
                skv, dtype=torch.int32, device=dev) * 4 + 2)
    else:
        mask = seg_case_mask(torch, kind, sq, skv, cu, dev, seed)
    return mask._replace(softcap=softcap, alibi_slopes=alibi_slopes(
        torch, hq, dev) if alibi else None)


def xform_case_check(torch, case, seed=0):
    """B1, B2 and B3a/B3b with the softcap and/or ALiBi of an
    ``XFORM_EDGE_CASES``-form case against their plain versions: out and
    lse (B1_OUT_TOL, by rows RING_OUT_REL_TOL, B1_LSE_TOL), dq, dk, dv
    (BWD_REL_TOL of max|plain|), dead rows (0, NEG_INF, dq = 0) and unseen
    keys (dk = dv = 0), B3 bitwise the same twice, every launch an XFORM
    launch. Raises past the limits; returns the worst errors {kernel:
    [abs, rel(, lse)]}."""
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import NEG_INF, allowed_mask
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)

    b, hq, hkv, sq, skv, d = case[:6]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = xform_case_mask(torch, case, dev, seed=seed)
    scale = d**-0.5
    what = f"xform edge case {case}"
    counters = (flash_fwd_cuda, flash_bwd_cuda, flash_bwd_dq_cuda,
                flash_bwd_dkv_cuda)
    before = [f.xform_launches for f in counters]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, dout = (rnd(b, hq, sq, d), rnd(b, hkv, skv, d),
                     rnd(b, hkv, skv, d), rnd(b, hq, sq, d))
    out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=torch.bfloat16)
    got_out, got_lse = flash_fwd_cuda(q, k, v, scale, mask)
    ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
    worst = {"B1": [max_err(got_out, ref_out), rel_err_rows(got_out, ref_out),
                    max_err(got_lse, ref_lse)]}
    if (worst["B1"][0] > B1_OUT_TOL or worst["B1"][1] > RING_OUT_REL_TOL
            or worst["B1"][2] > B1_LSE_TOL):
        raise AssertionError(f"{what}: B1 {worst['B1']}")
    allowed = allowed_mask(mask, sq, skv, dev)
    if allowed is None:
        allowed = torch.ones(sq, skv, dtype=torch.bool, device=dev)
    dead_rows, dead_keys = ~allowed.any(1), ~allowed.any(0)
    if not (torch.all(got_lse[:, :, dead_rows] == NEG_INF)
            and torch.all(got_out[:, :, dead_rows] == 0)):
        raise AssertionError(f"{what}: B1's dead rows are not (0, NEG_INF)")
    delta = compute_delta(dout, out)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
    # where every row sees one key the softmax has no gradient: dq and dk
    # are rounding noise on both sides, held on dv's scale
    one_key = bool((allowed.sum(1) <= 1).all())
    floor = float(ref[2].abs().max()) if one_key else 0.0
    for name, bwd in (("B2", flash_bwd_cuda), ("B3", flash_bwd_split_cuda)):
        got = bwd(dout, q, k, v, lse, delta, scale, mask)
        rel = [max_err(x, r) / max(float(r.abs().max()), floor, 1e-6)
               for x, r in zip(got, ref)]
        if name == "B2":
            worst["B2"] = [max(max_err(x, r) for x, r in zip(got, ref)),
                           max(rel)]
        else:
            worst["B3a"] = [max_err(got[0], ref[0]), rel[0]]
            worst["B3b"] = [max(max_err(got[1], ref[1]),
                                max_err(got[2], ref[2])), max(rel[1:])]
        if max(rel) > BWD_REL_TOL:
            raise AssertionError(f"{what}: {name} dq, dk, dv {rel}")
        if not (torch.all(got[0][:, :, dead_rows] == 0)
                and torch.all(got[1][:, :, dead_keys] == 0)
                and torch.all(got[2][:, :, dead_keys] == 0)):
            raise AssertionError(f"{what}: {name} dead rows or unseen keys")
        again = bwd(dout, q, k, v, lse, delta, scale, mask)
        same = [torch.equal(x, y) for x, y in zip(got, again)]
        if same[1:] != [True, True] or not (same[0] or name == "B2"):
            raise AssertionError(f"{what}: {name} not reproducible {same}")
    ran = [f.xform_launches - n for f, n in zip(counters, before)]
    if ran != [2, 2, 2, 2]:
        raise AssertionError(f"{what}: XFORM launches {ran}, not 2 each")
    return worst


def varlen_pairs(cu, causal):
    """The (q, key) pairs a packing computes, as the reference's varlen
    benchmark counts them (benchmark_varlen_kvpacked_func.py:73-75): the
    sum of each sequence's square, halved when causal."""
    lens = np.diff(np.asarray(cu, np.float64))
    return float(np.sum(lens ** 2)) * (0.5 if causal else 1.0)


def varlen_mask(torch, cu, causal, dev):
    """The MaskArgs ``flash_attn_varlen_func`` builds for the packing
    ``cu``, and the dense (T, T) bool mask of the same function (for
    ``F.scaled_dot_product_attention``, timed only)."""
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs, allowed_mask
    from ring_flash_attn_tpu_torch.ops.varlen import (
        cu_seqlens_to_positions, cu_seqlens_to_segids)

    t = int(cu[-1])
    seg = cu_seqlens_to_segids(cu, t, dev)
    pos = cu_seqlens_to_positions(cu, t, dev) if causal else None
    mask = MaskArgs(causal=causal, q_segids=seg, kv_segids=seg, q_pos=pos,
                    kv_pos=pos, packed_self=True)
    return mask, allowed_mask(mask, t, t, dev)

def has_segments():
    """True when the imported port has packed sequences (a parent tree
    timed with ``--root`` may not)."""
    import importlib.util

    return importlib.util.find_spec(
        "ring_flash_attn_tpu_torch.ops.block_meta") is not None

def seg_case_mask(torch, kind, sq, skv, cu, dev, seed=0):
    """The MaskArgs of a ``SEG_EDGE_CASES`` kind on ``dev``."""
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.varlen import (
        cu_seqlens_to_positions, cu_seqlens_to_segids)

    seg = cu_seqlens_to_segids(cu, skv, dev)
    pos = cu_seqlens_to_positions(cu, skv, dev)
    if kind == "pos":
        return MaskArgs(causal=True, q_segids=seg, kv_segids=seg, q_pos=pos,
                        kv_pos=pos, packed_self=True)
    if kind == "seg":
        return MaskArgs(q_segids=seg, kv_segids=seg)
    if kind == "idx":
        return MaskArgs(causal=True, offset=skv - sq, q_segids=seg[skv - sq:],
                        kv_segids=seg)
    rng = np.random.default_rng(seed)
    if kind == "shuffled":
        segs = torch.as_tensor(rng.integers(0, 3, skv), dtype=torch.int32,
                               device=dev)
        perm = torch.as_tensor(rng.permutation(skv), dtype=torch.int32,
                               device=dev)
        return MaskArgs(causal=True, q_segids=segs, kv_segids=segs,
                        q_pos=perm, kv_pos=perm)
    if kind == "absent":
        q_seg = cu_seqlens_to_segids([0, sq // 3, sq], sq, dev)
        q_seg[q_seg == 1] = 7  # a segment kv does not hold
        return MaskArgs(q_segids=q_seg, kv_segids=seg)
    raise ValueError(kind)

def ring_steps(n, skv, causal):
    """The fused-ring steps of the last rank of a ring of ``n``, shards of
    ``skv`` keys: the diagonal (if causal) first, then the earlier
    shards."""
    rank = n - 1
    return [dict(diagonal=causal and i == 0, q_pos0=rank * skv,
                 kv_pos0=(rank - i) * skv) for i in range(n)]


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters, flush):
    """Mean device time of fn() in ms, CUDA events around each call, with
    the 50 MB L2 flushed before each so every call reads from HBM. Not
    ``utils.timing.timed``: a chain cannot flush the L2 between its calls
    without timing the flush, so each call is timed alone here."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def _device_profile(torch, fn):
    """fn() under torch.profiler (``utils.trace_timing.trace_device_events``:
    a warm-up cycle, whose records are dropped, then the recorded call):
    [(device us, event name, count)], largest first."""
    from ring_flash_attn_tpu_torch.utils.trace_timing import (
        trace_device_events)

    return [(t * 1e6, key, n) for t, key, n in trace_device_events(fn)]


def _short(key):
    """A kernel's bare name out of its C++ signature."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


def kernel_ms(torch, fn, iters, flush):
    """The two readings of a kernel's wrapper fn(), L2 flushed before each
    call: ``ms`` between CUDA events around the call (cuda_ms: it holds
    the launcher's host work wherever the device would otherwise wait for
    it) and ``device_ms``, torch.profiler's device time of everything the
    call launches (every kernel but the flush's own, whatever its name:
    pre-passes, merges, casts and zeroing included)."""
    def loop():
        for _ in range(iters):
            flush.zero_()
            fn()

    def flushes():
        # the flushes alone, as many: a profile of one flush came back
        # empty every time late in a run (phase 16 on the H100)
        for _ in range(iters):
            flush.zero_()

    for _ in range(3):  # again if the profiler lost records of the loop
        per_flush = {key: n for _, key, n in _device_profile(torch, flushes)}
        prof = _device_profile(torch, loop)
        seen = {key: n for _, key, n in prof}
        if per_flush and all(seen.get(key) == n
                             for key, n in per_flush.items()):
            break
    else:
        # the profiler has come back empty three times over (seen once on
        # the H100 machine, for B7, in a run that passed the next time):
        # the device time goes unmeasured (NaN here, null in the JSON
        # line), the events' time still stands
        log(f"    torch.profiler lost kernels of the timed loop three times "
            f"(flush {per_flush}, loop {seen}): device time not measured")
        return {"ms": cuda_ms(torch, fn, iters, flush),
                "device_ms": float("nan")}
    parts = [(t / iters, key) for t, key, _ in prof if key not in per_flush]
    device = sum(t for t, _ in parts) / 1e3
    log("    device time of a call: " + ", ".join(
        f"{_short(key)} {t:.1f} us" for t, key in parts))
    return {"ms": cuda_ms(torch, fn, iters, flush), "device_ms": device}


def _json_safe(x):
    """x with every NaN (a reading not measured) as None."""
    if isinstance(x, float) and x != x:
        return None
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    return x


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err_rows(a, ref):
    """The worst over rows (every index but the last) of max|a - ref| /
    max|ref| within the row: a row of many keys, whose |out| is 1e-2, is
    judged on its own scale; a row whose ref is all zero (no key) must be
    zero."""
    err = (a.float() - ref.float()).abs().amax(-1)
    return float((err / ref.float().abs().amax(-1).clamp_min(1e-30)).max())


# each kernel's instantiation at the timed shape (head_dim 128): its library
# (csrc/<lib>.cu) and a piece of its mangled name; the largest over the
# instantiations that match where a kernel has several (B7). The decode
# kernels' last two template arguments are the head dim and RG (row
# groups, csrc/quant_decode.cuh). The last two
# template arguments of the block kernels are XFORM (softcap and ALiBi,
# phase 17) and BAND (0; windows and dropout, phase 18: 1 the build of a
# window alone, 2 the build for dropout, softcap and ALiBi with or without
# one, csrc/band.cuh); the BAND entries name the window builds, the
# kernel line adds the others' facts
INSTANTIATIONS = {
    "B1 flash_fwd": ("flash_fwd", "flash_fwd_kernelILi128ELb0ELb0ELb0ELi0EE"),
    "B5 paged_decode": ("paged_decode", "paged_decode_kernelILi4ELi128ELb0EE"),
    "B2 flash_bwd": ("flash_bwd", "bwd_kv_kernelILi128ELb1ELb0ELb0ELb0ELi0EE"),
    "B3a flash_bwd_dq": ("flash_bwd_split", "bwd_dq_kernelILi128ELb0ELb0ELi0EE"),
    "B3b flash_bwd_dkv": ("flash_bwd_split",
                          "bwd_kv_kernelILi128ELb0ELb0ELb0ELb0ELi0EE"),
    "B4 quant_decode": ("quant_decode",
                        "quant_decode_kernelILi0ELi4ELi128ELb0EE"),
    "B6 paged_quant_decode": ("paged_quant_decode",
                              "paged_quant_decode_kernelILi0ELi4ELi128ELb0EE"),
    "B7 fused_ring_fwd": ("fused_ring_fwd", "flash_fwd_kernelILi128ELb1E"),
    "B8 fused_ring_bwd": ("fused_ring_bwd", "bwd_kv_kernelILi128ELb1ELb1E"),
    # the softcap/ALiBi instantiations (phase 17), without segments
    "B1 flash_fwd XFORM": ("flash_fwd", "flash_fwd_kernelILi128ELb0ELb1ELb0ELi0EE"),
    "B2 flash_bwd XFORM": ("flash_bwd",
                           "bwd_kv_kernelILi128ELb1ELb0ELb0ELb1ELi0EE"),
    "B3a flash_bwd_dq XFORM": ("flash_bwd_split",
                               "bwd_dq_kernelILi128ELb0ELb1ELi0EE"),
    "B3b flash_bwd_dkv XFORM": ("flash_bwd_split",
                                "bwd_kv_kernelILi128ELb0ELb0ELb0ELb1ELi0EE"),
    # the window/dropout instantiations (phase 18), without segments
    "B1 flash_fwd BAND": ("flash_fwd",
                          "flash_fwd_kernelILi128ELb0ELb1ELb0ELi1EE"),
    "B2 flash_bwd BAND": ("flash_bwd",
                          "bwd_kv_kernelILi128ELb1ELb0ELb0ELb1ELi1EE"),
    "B3a flash_bwd_dq BAND": ("flash_bwd_split",
                              "bwd_dq_kernelILi128ELb0ELb1ELi1EE"),
    "B3b flash_bwd_dkv BAND": ("flash_bwd_split",
                               "bwd_kv_kernelILi128ELb0ELb0ELb0ELb1ELi1EE"),
}
# the segmented instantiations (packed sequences, csrc/segments.cuh) of the
# four block kernels, head_dim 128
SEG_INSTANTIATIONS = {
    "B1 flash_fwd": ("flash_fwd", "flash_fwd_kernelILi128ELb0ELb0ELb1ELi0EE"),
    "B2 flash_bwd": ("flash_bwd", "bwd_kv_kernelILi128ELb1ELb0ELb1ELb0ELi0EE"),
    "B3a flash_bwd_dq": ("flash_bwd_split", "bwd_dq_kernelILi128ELb1ELb0ELi0EE"),
    "B3b flash_bwd_dkv": ("flash_bwd_split",
                          "bwd_kv_kernelILi128ELb0ELb0ELb1ELb0ELi0EE"),
    "B1 flash_fwd XFORM": ("flash_fwd", "flash_fwd_kernelILi128ELb0ELb1ELb1ELi0EE"),
    "B2 flash_bwd XFORM": ("flash_bwd",
                           "bwd_kv_kernelILi128ELb1ELb0ELb1ELb1ELi0EE"),
    "B3a flash_bwd_dq XFORM": ("flash_bwd_split",
                               "bwd_dq_kernelILi128ELb1ELb1ELi0EE"),
    "B3b flash_bwd_dkv XFORM": ("flash_bwd_split",
                                "bwd_kv_kernelILi128ELb0ELb0ELb1ELb1ELi0EE"),
    "B1 flash_fwd BAND": ("flash_fwd",
                          "flash_fwd_kernelILi128ELb0ELb1ELb1ELi1EE"),
    "B2 flash_bwd BAND": ("flash_bwd",
                          "bwd_kv_kernelILi128ELb1ELb0ELb1ELb1ELi1EE"),
    "B3a flash_bwd_dq BAND": ("flash_bwd_split",
                              "bwd_dq_kernelILi128ELb1ELb1ELi1EE"),
    "B3b flash_bwd_dkv BAND": ("flash_bwd_split",
                               "bwd_kv_kernelILi128ELb0ELb0ELb1ELb1ELi1EE"),
}


def ptxas_facts(log_path):
    """{mangled kernel name: {"registers", "spill_bytes",
    "smem_static_bytes"}} from the nvcc log (``-Xptxas -v``) that
    ``_build`` keeps beside a library. A kernel launched with more threads
    than it keeps registers for (``setmaxnreg``) reports its launch count;
    dynamic shared memory is not in the log."""
    import re

    facts, cur = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = facts.setdefault(m.group(1), {
                    "registers": 0, "spill_bytes": 0, "smem_static_bytes": 0})
                continue
            if cur is None:
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem_static_bytes"] = int(m.group(1)) if m else 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                cur["spill_bytes"] = int(m.group(1))
    return facts


def kernel_ptxas(paths, name, table=None):
    """ptxas's facts of a kernel entry's instantiation (INSTANTIATIONS, or
    ``table``)."""
    lib, piece = (table or INSTANTIATIONS)[name]
    found = [f for k, f in ptxas_facts(paths[lib][:-3] + ".log").items()
             if piece in k]
    if not found:
        raise AssertionError(f"no ptxas record of {piece} in {lib}'s log")
    return {key: max(f[key] for f in found) for key in found[0]}


def hgmma_counts(path, piece):
    """{mangled name: HGMMA instructions} of a library's kernels whose name
    holds ``piece``, from ``cuobjdump -sass``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    return {func.split("\n")[0].strip(): len(re.findall(r"\bHGMMA\.", func))
            for func in re.split(r"\n\s*Function : ", out)[1:]
            if piece in func.split("\n")[0]}


# the template parameters of the three tile loops' kernels, in order (a
# tree without the last flags has no such builds)
LOOP_FLAGS = {"flash_fwd_kernel": ("D", "ring", "xform", "seg", "band"),
              "bwd_kv_kernel": ("D", "dq", "ring", "seg", "xform", "band"),
              "bwd_dq_kernel": ("D", "seg", "xform", "band")}


def loop_flags(piece, name):
    """{parameter: value} of a tile loop's instantiation (``piece``: its
    kernel, a LOOP_FLAGS key) from a mangled name, or None."""
    import re

    m = re.search(piece + r"I((?:L[ib]\d+E)+)E", name)
    if not m:
        return None
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(1))]
    return dict(zip(LOOP_FLAGS[piece], args))


def check_hgmma(what, lib, piece):
    """Log and check the HGMMA count of each instantiation of a tile loop
    (kernels whose mangled name holds ``piece``: ``flash_fwd_kernel``, the
    forward loop, ``bwd_kv_kernel``, the kv-major backward loop, or
    ``bwd_dq_kernel``, the q-major dq loop) in csrc/<lib>.cu: the loop runs
    on wgmma. Returns {label: count}."""
    from ring_flash_attn_tpu_torch.ops import _build

    def label(name):  # head_dim, the softcap/ALiBi build (XFORM: B7's and
        # B8's are their ring builds), the window/dropout build and the
        # segmented build, from the template flags
        flags = loop_flags(piece, name)
        return f"D={flags['D']}" + (" XFORM" if flags.get("xform") else "") \
            + (f" BAND={flags['band']}" if flags.get("band") else "") \
            + (" SEG" if flags.get("seg") else "")

    counts = {label(n): c for n, c in sorted(
        hgmma_counts(_build.build_all()[lib], piece).items())}
    log(f"  {what}: HGMMA in the SASS of {piece} " + ", ".join(
        f"{n} {c}" for n, c in counts.items()))
    if not counts or min(counts.values()) == 0:
        raise AssertionError(f"{what}: an instantiation of the loop has no "
                             f"HGMMA: {counts}")
    return counts


def profile_loop(tool, loop, piece, timings, add_arguments=lambda ap: None):
    """The command line of profile_torch_fwd.py, profile_torch_bwd.py and
    profile_torch_decode.py: ``[--root DIR] [--rounds N]``, and whatever
    ``add_arguments(parser)`` adds. Imports the package from ``--root`` (a
    tree with ``utils/``: ``kernel_ms`` reads the profiler through its
    ``utils.trace_timing``), builds it, logs the card, then ptxas's facts,
    its wgmma/setmaxnreg notes and the HGMMA count of every kernel whose
    name holds ``piece`` (a string or a tuple of them) in the libraries of
    ``loop`` (INSTANTIATIONS names), then runs ``timings(torch, args)``.
    Returns the exit code."""
    pieces = (piece,) if isinstance(piece, str) else tuple(piece)
    import argparse

    ap = argparse.ArgumentParser(prog=tool)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rounds", type=int, default=2)
    add_arguments(ap)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print(f"{tool}: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # ahead of this checkout
    from ring_flash_attn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; tree {root}")
    paths = _build.build_all()
    for name in loop:
        lib = INSTANTIATIONS[name][0]
        facts = ptxas_facts(paths[lib][:-3] + ".log")
        for fn, f in sorted(facts.items()):
            for p in pieces:
                if p in fn:  # the name from the piece on: its template
                    log(f"  ptxas {name} {fn[fn.index(p):][:72]}: {f}")
        with open(paths[lib][:-3] + ".log") as f:
            for line in f:
                if "wgmma" in line or "setmaxnreg" in line:
                    log(f"  ptxas {name} note: {line.strip()[:200]}")
        for p in pieces:
            for fn, n in sorted(hgmma_counts(paths[lib], p).items()):
                log(f"  SASS {name} {fn[:64]}: {n} HGMMA")
    timings(torch, args)
    return 0


def phase_env(torch):
    from ring_flash_attn_tpu_torch.ops import _build

    log("== phase 1: environment and build")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc {nvcc}: {ver}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError as e:
        log(f"triton not importable: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"card: {smi}  ({torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in sorted(paths.items()):
        with open(path[:-3] + ".log") as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "wgmma",
                                           "setmaxnreg")):
                    log(f"  ptxas {name}: {line.strip()}")
    return smi


def phase_b1(torch, flush):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_fwd

    log("== phase 2: kernel B1 (flash forward) vs its plain version")
    check_hgmma("B1", "flash_fwd", "flash_fwd_kernel")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, hq, hkv, sq, skv, d=128):
        def rnd(*s):
            return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
        return rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)

    edges = [
        (f"edge B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
         f"causal={causal} offset={off} {odt} out",
         (b, hq, hkv, sq, skv, d), MaskArgs(causal=causal, offset=off),
         getattr(torch, odt))
        for b, hq, hkv, sq, skv, d, causal, off, odt in B1_EDGE_CASES]
    cases = [
        ("causal 4096", (1, 32, 8, 4096, 4096), MaskArgs(causal=True),
         torch.bfloat16),
        ("prefix Sq=1024 Skv=3072 offset=2048", (1, 32, 8, 1024, 3072),
         MaskArgs(causal=True, offset=2048), torch.bfloat16),
        ("non-causal 1000x1500", (2, 8, 2, 1000, 1500), MaskArgs(),
         torch.bfloat16),
        # the engine's own shapes: request 0's prefill and request 2's
        # suffix over its 2048-token cached prefix
        ("engine prefill 3072", (1, 32, 8, 3072, 3072),
         MaskArgs(causal=True), torch.bfloat16),
        ("engine prefix Sq=768 Skv=2816 offset=2048", (1, 32, 8, 768, 2816),
         MaskArgs(causal=True, offset=2048), torch.bfloat16),
        ("ragged, dead rows: offset=-5, f32 out", (1, 4, 2, 100, 70),
         MaskArgs(causal=True, offset=-5), torch.float32),
        *edges,  # B1_EDGE_CASES, the loop's tile edges
        # the training path's long step, its last 512 q rows over all
        # 36864 keys (the plain version's fp32 scores of the full
        # sequence would not fit)
        ("training Sq=512 Skv=36864 offset=36352", (1, 32, 8, 512, 36864),
         MaskArgs(causal=True, offset=36352), torch.bfloat16),
        # the generate path's prefill of a 32768-token prompt, its last 512
        # q rows over all 32768 keys (as above, the whole would not fit)
        ("generate Sq=512 Skv=32768 offset=32256", (1, 32, 8, 512, 32768),
         MaskArgs(causal=True, offset=32256), torch.bfloat16),
        # the training path's S=8192 step (bench.py's shape), timed below
        ("training causal 8192", (1, 32, 8, 8192, 8192),
         MaskArgs(causal=True), torch.bfloat16),
    ]
    worst = [0.0, 0.0]
    for name, shape, mask, odt in cases:
        q, k, v = inputs(*shape)
        scale = q.shape[-1] ** -0.5
        out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=odt)
        ref_out, ref_lse = naive_block_fwd(q, k, v, scale, mask)
        torch.cuda.synchronize()
        eo, el = max_err(out, ref_out), max_err(lse, ref_lse)
        ro = rel_err_rows(out, ref_out)
        log(f"  {name}: max|out| err {eo:.3e} (tol {B1_OUT_TOL}), of its "
            f"row's max|plain| {ro:.3e} (tol {RING_OUT_REL_TOL}), max|lse| "
            f"err {el:.3e} (tol {B1_LSE_TOL})")
        if not (eo <= B1_OUT_TOL and ro <= RING_OUT_REL_TOL
                and el <= B1_LSE_TOL):
            raise AssertionError(f"B1 disagrees with its plain version: {name}")
        worst = [max(worst[0], eo), max(worst[1], ro)]
        del out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()

    # timing at the causal S=8192 shape of bench.py (the last case's inputs)
    s, hq, hkv, d = 8192, 32, 8, 128
    mask = MaskArgs(causal=True)
    t = kernel_ms(torch, lambda: flash_fwd_cuda(
        q, k, v, scale, mask, out_dtype=torch.bfloat16), 10, flush)
    ms = t["ms"]
    plain_ms = cuda_ms(torch, lambda: naive_block_fwd(q, k, v, scale, mask),
                       2, flush)
    torch.cuda.empty_cache()
    k_rep = k.repeat_interleave(hq // hkv, dim=1)
    v_rep = v.repeat_interleave(hq // hkv, dim=1)
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), 10, flush)
    del k_rep, v_rep
    pairs = s * (s + 1) // 2  # allowed (q, kv) pairs of the causal mask
    flops = 4 * hq * d * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * hq * s
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    log(f"  S=8192 causal bf16: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s; {t['device_ms']:.3f} ms of device "
        f"time), plain {plain_ms:.3f} ms, "
        f"sdpa {lib_ms:.3f} ms, bound {bound_ms:.3f} ms (operations)")
    return {
        "name": "B1 flash_fwd", "route": "cuda",
        "source": "ring_flash_attn_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ring_flash_attn_tpu/ops/pallas_fwd.py:161",
        "shape": "q (1,32,8192,128) kv (1,8,8192,128) bf16 causal",
        "max_abs_err": worst[0], "max_rel_err": worst[1], **t,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations",
        "library_ms": lib_ms,
    }


def b5_edge_cases():
    """The split plan's edges for B5 (phase 3 and tests/test_torch_cuda.py):
    dicts of lens, page_size, npages (the table's width), hq, hkv, tq,
    counts (new_counts or None), cap (softcap) and qdtype. Lane lengths
    that end on a split boundary come from ``paged_num_splits``, so they
    follow the plan."""
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        CHUNK, paged_num_splits)

    # 4 lanes, 32 pages of 256: lane 0 ends on the last token of its
    # 3 * nsplit-th chunk (one chunk for each pipeline of each split);
    # lanes of 0 and 1 token among long ones
    split = paged_num_splits(4, 8, 32, 256)
    return [
        # B = 1, one lane of 32768 tokens: the most splits
        dict(lens=[32768], page_size=256, npages=128, hq=32, hkv=8, tq=1,
             counts=None, cap=None, qdtype="bfloat16"),
        dict(lens=[3 * split * CHUNK, 0, 1, 8000], page_size=256, npages=32,
             hq=32, hkv=8, tq=1, counts=None, cap=None, qdtype="bfloat16"),
        # 16-token pages (a chunk per page, shorter than 64), 8 rows
        dict(lens=[4096, 1000, 17], page_size=16, npages=256, hq=32, hkv=8,
             tq=2, counts=[2, 1, 2], cap=None, qdtype="bfloat16"),
        # R = 16: Tq = 4 speculative rows with new_counts
        dict(lens=[3000, 17, 2, 4096], page_size=256, npages=16, hq=32,
             hkv=8, tq=4, counts=[4, 3, 1, 4], cap=None, qdtype="bfloat16"),
        # softcap with fp32 q, pages of 128
        dict(lens=[5000, 300, 8192], page_size=128, npages=64, hq=32,
             hkv=8, tq=1, counts=None, cap=30.0, qdtype="float32"),
    ]


def b5_case_inputs(torch, case, gen, seed):
    """q, k_pages, v_pages, block_tables (shuffled), seq_lens, new_counts
    of a ``b5_edge_cases`` case, on the card."""
    dev = torch.device("cuda")
    b, d = len(case["lens"]), 128
    num_pages = b * case["npages"]
    perm = np.random.default_rng(seed).permutation(num_pages).astype(
        np.int32)
    tables = torch.as_tensor(perm.reshape(b, case["npages"]), device=dev)
    shape = (num_pages, case["hkv"], case["page_size"], d)
    k_pages = torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    v_pages = torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn((b, case["hq"], case["tq"], d), generator=gen,
                    device=dev).to(getattr(torch, case["qdtype"]))
    lens = torch.tensor(case["lens"], dtype=torch.int32, device=dev)
    counts = (None if case["counts"] is None else
              torch.tensor(case["counts"], dtype=torch.int32, device=dev))
    return q, k_pages, v_pages, tables, lens, counts


def _b5_bound_ms(q, tokens, hkv, tables):
    """B5's least time: the live K/V once, q, out, lse and the table
    (bytes), or its fp32 FMAs on the CUDA cores (QK and PV, 2 flops each
    per row, token and head-dim column), whichever is larger."""
    b, hq, tq, d = q.shape
    kv_bytes = 2 * tokens * hkv * d * 2
    io_bytes = (q.element_size() * q.numel() + 4 * (q.numel() + b * hq * tq)
                + 4 * tables.numel())
    flops = 4 * tokens * hq * tq * d
    return max((kv_bytes + io_bytes) / H100_BYTES_PER_S,
               flops / H100_FP32_FLOPS) * 1e3


def phase_b5(torch, flush):
    from ring_flash_attn_tpu_torch.ops.paged import (
        PagedKVCache, _plain_paged_decode)
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        paged_num_splits)

    log("== phase 3: kernel B5 (paged decode) vs its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    lens = [0, 1, 255, 256, 257, 1000, 4095, 4096]
    b, hq, hkv, d, ps, pps = len(lens), 32, 8, 128, 256, 16
    num_pages = b * pps
    perm = np.random.default_rng(2).permutation(num_pages).astype(np.int32)
    tables = torch.as_tensor(perm.reshape(b, pps), device=dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    k_pages = torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device=dev).to(torch.bfloat16)
    v_pages = torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device=dev).to(torch.bfloat16)
    cache = PagedKVCache(k_pages, v_pages, tables, seq_lens)
    scale = d ** -0.5

    def q_of(tq, dtype):
        return torch.randn((b, hq, tq, d), generator=gen,
                           device=dev).to(dtype)

    def check(name, q, kp, vp, tbl, sl, cap, cnt):
        """The kernel twice against the plain version: within B5_TOL and
        the same bits both times."""
        got, again = (paged_decode_cuda(q, kp, vp, tbl, sl, scale,
                                        softcap=cap, new_counts=cnt)
                      for _ in range(2))
        ref_out, ref_lse = _plain_paged_decode(
            q, PagedKVCache(kp, vp, tbl, sl), scale, cap, cnt)
        torch.cuda.synchronize()
        eo, el = max_err(got[0], ref_out), max_err(got[1], ref_lse)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        nsplit = paged_num_splits(q.shape[0], kp.shape[1], tbl.shape[1],
                                  kp.shape[2])
        log(f"  {name}: max|out| err {eo:.3e}, max|lse| err {el:.3e} "
            f"(tol {B5_TOL}); {nsplit} splits a lane; two runs bitwise "
            f"equal {same}")
        if not (eo <= B5_TOL and el <= B5_TOL):
            raise AssertionError(f"B5 disagrees with its plain version: {name}")
        if not same:
            raise AssertionError(f"B5 is not bitwise reproducible: {name}")
        dead = sl == 0
        if not (bool((got[0][dead] == 0).all())
                and bool((got[1][dead] == -1e30).all())):
            raise AssertionError(f"B5: a dead lane must give out=0, "
                                 f"lse=NEG_INF: {name}")
        return max(eo, el)

    counts = torch.tensor([3, 1, 4, 4, 2, 4, 4, 4], dtype=torch.int32,
                          device=dev)
    cases = [
        ("plain, bf16 q", q_of(1, torch.bfloat16), None, None),
        ("softcap=30, f32 q", q_of(1, torch.float32), 30.0, None),
        ("new_counts, Tq=4", q_of(4, torch.bfloat16), None, counts),
    ]
    # the engine's decode shape: 4 lanes at the smoke traffic's lengths
    eng_lens = torch.tensor([3016, 1216, 2616, 316], dtype=torch.int32,
                            device=dev)
    q4 = torch.randn((4, hq, 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    worst = 0.0
    for name, q, cap, cnt in cases:
        worst = max(worst, check(name, q, k_pages, v_pages, tables, seq_lens,
                                 cap, cnt))
    worst = max(worst, check("engine shape, 4 lanes", q4, k_pages, v_pages,
                             tables[:4], eng_lens, None, None))
    # the split plan's edges
    for i, case in enumerate(b5_edge_cases()):
        inp = b5_case_inputs(torch, case, gen, 20 + i)
        name = (f"edge lens {case['lens']} page {case['page_size']} x "
                f"{case['npages']}, Tq={case['tq']} counts {case['counts']}"
                f" softcap {case['cap']} {case['qdtype']} q")
        worst = max(worst, check(name, *inp[:5], case["cap"], inp[5]))
        del inp

    # timed at the table's shape (the kernel's JSON numbers), then beside
    # it at the engine's 4 lanes and with R = 16 (Tq = 4, new_counts)
    q = cases[0][1]
    t = kernel_ms(torch, lambda: paged_decode_cuda(
        q, k_pages, v_pages, tables, seq_lens, scale), 20, flush)
    ms = t["ms"]
    plain_ms = cuda_ms(torch, lambda: _plain_paged_decode(
        q, cache, scale), 5, flush)
    tokens = sum(lens)
    kv_bytes = 2 * tokens * hkv * d * 2  # K and V of every live token
    bound_ms = _b5_bound_ms(q, tokens, hkv, tables)
    log(f"  lens {lens}: kernel {ms:.4f} ms "
        f"({kv_bytes / ms / 1e6:.1f} GB/s of KV; {t['device_ms']:.4f} ms of "
        f"device time, {t['device_ms'] / bound_ms:.1f}x its bound), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes); "
        f"{paged_num_splits(b, hkv, pps, ps)} splits a lane")
    others = {
        "engine 4 lanes": (q4, tables[:4], eng_lens, None,
                           int(eng_lens.sum())),
        "R=16 (Tq=4, new_counts)": (cases[2][1], tables, seq_lens, counts,
                                    tokens),
    }
    extra = {}
    for name, (qx, tbl, sl, cnt, toks) in others.items():
        tx = kernel_ms(torch, lambda: paged_decode_cuda(
            qx, k_pages, v_pages, tbl, sl, scale, new_counts=cnt), 20, flush)
        bx = _b5_bound_ms(qx, toks, hkv, tbl)
        extra[name] = dict(tx, bound_ms=bx, splits=paged_num_splits(
            qx.shape[0], hkv, tbl.shape[1], ps))
        log(f"  {name}: kernel {tx['ms']:.4f} ms, {tx['device_ms']:.4f} ms "
            f"of device time ({tx['device_ms'] / bx:.1f}x its bound "
            f"{bx:.4f} ms), {extra[name]['splits']} splits a lane")
    return {
        "name": "B5 paged_decode", "route": "cuda",
        "source": "ring_flash_attn_tpu_torch/csrc/paged_decode.cu",
        "replaces": "ring_flash_attn_tpu/ops/paged.py:257",
        "shape": f"q (8,32,1,128) bf16, pages (128,8,256,128) bf16, "
                 f"lens {lens}",
        "max_abs_err": worst, **t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "other_shapes": extra,
    }, decode_wide(torch, "B5", flush)


def _traffic(vocab):
    rng = np.random.default_rng(0)

    def toks(n):
        return rng.integers(0, vocab, size=n).astype(np.int32)

    p0 = toks(3000)
    prompts = {0: p0, 1: toks(1200),
               2: np.concatenate([p0[:2100], toks(500)]),  # prefix of 0
               3: toks(300), 4: toks(2000), 5: toks(800)}
    return prompts


def _serve(torch, model, prompts, backend, new_tokens):
    """Serve the traffic; fork request 4 as soon as it decodes. Returns
    (outputs, [(step seconds, prompt tokens prefilled, decoded or not)])."""
    from ring_flash_attn_tpu_torch.models import ServingEngine

    eng = ServingEngine(model, num_pages=64, page_size=256, pages_per_seq=16,
                        max_batch=4, backend=backend, device="cuda")
    for rid, p in prompts.items():
        eng.submit(rid, p, new_tokens, prefix_of=0 if rid == 2 else None)
    steps, forked = [], False
    while not eng.sched.idle:
        admitted = list(eng.sched.waiting)
        n_pref, n_dec = eng.stats["prefills"], eng.stats["decode_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        done = eng.stats["prefills"] - n_pref
        pref_tokens = sum(r.prompt_len - r.shared_len
                          for r in admitted[:done])
        steps.append((dt, pref_tokens, eng.stats["decode_steps"] > n_dec))
        if not forked and 4 in eng._pending:
            eng.fork(4, 6)
            forked = True
        if len(steps) > 200:
            raise RuntimeError("serving loop did not converge")
    if not forked:
        raise AssertionError("request 4 was never forked")
    if eng.sched._requests[2].shared_len != 2048:
        raise AssertionError("request 2 was not admitted with its prefix")
    return eng.outputs, steps


def _engine_logit_checks(torch, model, prompts, new_tokens):
    """The engine's first prefill logits (prompt 0) and its first decode
    step's logits over four lanes (prompts 0 to 3, the kernels' prefilled
    pages) on the kernels against the plain versions, within
    LOGITS_REL_TOL of max|plain|. Returns (prefill error, decode error)."""
    from ring_flash_attn_tpu_torch.models.serve import (
        _decode_body, _prefill_fn, ServingEngine)
    from ring_flash_attn_tpu_torch.ops.paged import PagedKVCache
    from ring_flash_attn_tpu_torch.serving import gather_block_tables

    dev = torch.device("cuda")
    # first prefill logits: kernels vs plain versions
    p0 = prompts[0]
    padded = torch.as_tensor(np.pad(p0, (0, -len(p0) % 256))[None],
                             device=dev).long()
    lk, _, _ = _prefill_fn(model, padded, len(p0) - 1)
    lp, _, _ = _prefill_fn(model, padded, len(p0) - 1, backend="plain")
    pre_err = max_err(lk, lp) / float(lp.abs().max())
    log(f"  first prefill logits: max|kernel - plain| / max|plain| = "
        f"{pre_err:.3e} (tol {LOGITS_REL_TOL}), finite "
        f"{bool(torch.isfinite(lk).all())}, argmax equal "
        f"{int(lk.argmax()) == int(lp.argmax())}")
    if not (pre_err <= LOGITS_REL_TOL and torch.isfinite(lk).all()):
        raise AssertionError("prefill logits disagree")

    # first decode step: both versions from the same kernel-prefilled pages
    eng = ServingEngine(model, num_pages=64, page_size=256, pages_per_seq=16,
                        max_batch=4, device="cuda")
    for rid in range(4):
        eng.submit(rid, prompts[rid], new_tokens,
                   prefix_of=0 if rid == 2 else None)
    eng.step()
    lanes = [r for r in eng.sched.lanes if r is not None]
    tables, lens = gather_block_tables(eng.alloc, [r.seq for r in lanes], 16)
    live = np.zeros(4, bool)
    toks = np.zeros(4, np.int64)
    bt = np.zeros((4, 16), np.int32)
    ln = np.zeros(4, np.int32)
    for i, r in enumerate(lanes):
        live[r.lane], toks[r.lane] = True, eng._pending[r.req_id]
        bt[r.lane], ln[r.lane] = tables[i], lens[i] - 1
    logits = {}
    for backend in (None, "plain"):
        caches = [PagedKVCache(c.k_pages.clone(), c.v_pages.clone(),
                               torch.as_tensor(bt, device=dev),
                               torch.as_tensor(ln, device=dev))
                  for c in eng.caches]
        logits[backend], _ = _decode_body(
            model, torch.as_tensor(toks, device=dev),
            torch.as_tensor(live, device=dev), caches, backend=backend)
    del eng, caches
    lk, lp = logits[None], logits["plain"]
    err = max_err(lk, lp) / float(lp.abs().max())
    log(f"  first decode-step logits (4 lanes): max|kernel - plain| / "
        f"max|plain| = {err:.3e} (tol {LOGITS_REL_TOL}), argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}")
    if not (err <= LOGITS_REL_TOL and torch.isfinite(lk).all()):
        raise AssertionError("decode logits disagree")
    return pre_err, err


def phase_engine(torch):
    from ring_flash_attn_tpu_torch.models import ModelConfig, init_params
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    log("== phase 4: ServingEngine at Llama-3-8B widths, 4 layers")
    dev = torch.device("cuda")
    # benchmark/benchmark_serving.py's full-width configuration
    cfg = ModelConfig(**FULL_WIDTH)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  init_params: {n_params / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _traffic(cfg.vocab)
    new_tokens = 16

    _engine_logit_checks(torch, model, prompts, new_tokens)

    # the main path: count launches over this run only
    flash_fwd_cuda.launches = 0
    paged_decode_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out_k, steps = _serve(torch, model, prompts, None, new_tokens)
    launches = {"B1 flash_fwd": flash_fwd_cuda.launches,
                "B5 paged_decode": paged_decode_cuda.launches}
    log(f"  served {len(out_k)} requests in {len(steps)} steps; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rid, toks in sorted(out_k.items()):
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab
                                              for t in toks):
            raise AssertionError(f"request {rid} produced {toks}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    pre = [(dt, n) for dt, n, _ in steps if n]
    dec = [dt for dt, n, decoded in steps if decoded and not n]
    pre_tps = sum(n for _, n in pre) / sum(dt for dt, _ in pre)
    dec_sps = len(dec) / sum(dec)
    log(f"  prefill {pre_tps:.0f} tokens/s over {len(pre)} steps with "
        f"admissions (their decodes included); {dec_sps:.1f} decode "
        f"steps/s over {len(dec)} decode-only steps")

    out_p, _ = _serve(torch, model, prompts, "plain", new_tokens)
    agree = {rid: int(np.sum(np.array(out_k[rid]) == np.array(out_p[rid])))
             for rid in out_k}
    total = sum(agree.values())
    log(f"  token agreement kernels vs plain: {total}/"
        f"{new_tokens * len(out_k)} {agree}")
    return launches


def _rel_err(a, ref):
    return max_err(a, ref) / max(float(ref.abs().max()), 1e-30)


def _rel_err_parts(a, ref, parts, dim=2):
    """The worst ``_rel_err`` over ``parts`` equal slices along ``dim``
    (the sequence), each relative to its own max|ref|."""
    return max(_rel_err(x, r) for x, r in zip(a.chunk(parts, dim=dim),
                                              ref.chunk(parts, dim=dim)))


def phase_bwd(torch, flush):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash import (
        compute_delta, flash_attention)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_bwd

    log("== phase 5: kernels B2, B3a, B3b (flash backward) vs their plain "
        "version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16

    def inputs(b, hq, hkv, sq, skv, mask, d=128):
        """bf16 q, k, v, dout, and B1's bf16 out and fp32 lse."""
        def rnd(*s):
            return torch.randn(s, generator=gen, device=dev).to(bf16)
        q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
        dout = rnd(b, hq, sq, d)
        out, lse = flash_fwd_cuda(q, k, v, d**-0.5, mask, out_dtype=bf16)
        return q, k, v, dout, out, lse

    kernels = {"B2": flash_bwd_cuda, "B3": flash_bwd_split_cuda}
    worst = {name: [0.0, 0.0] for name in kernels}  # (abs, rel)

    def check(name, q, k, v, dout, out, lse, mask, names):
        """The kernels ``names`` in both modes against naive_block_bwd on
        the same inputs, each twice: all of B3 and B2's dk, dv must give
        the same bits (B2's dq sums through atomics)."""
        scale = q.shape[-1] ** -0.5
        delta = compute_delta(dout, out)
        ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
        modes = [("delta=None, bf16 grads", None,
                  dict(out=out, dq_dtype=bf16, dkv_dtype=bf16), bf16),
                 ("delta given, fp32 grads", delta, {}, torch.float32)]
        for kname in names:
            for mode, d_arg, kw, dtype in modes:
                got, again = (kernels[kname](dout, q, k, v, lse, d_arg,
                                             scale, mask, **kw)
                              for _ in range(2))
                torch.cuda.synchronize()
                rel = [_rel_err(x, r) for x, r in zip(got, ref)]
                ab = [max_err(x, r) for x, r in zip(got, ref)]
                same = [torch.equal(x, y) for x, y in zip(got, again)]
                del again
                log(f"  {name}, {kname}, {mode}: rel err dq {rel[0]:.2e} "
                    f"dk {rel[1]:.2e} dv {rel[2]:.2e} (tol {BWD_REL_TOL}); "
                    f"abs max {max(ab):.2e}; two runs bitwise equal {same}")
                if not (max(rel) <= BWD_REL_TOL
                        and all(x.dtype == dtype for x in got)):
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version: {name}, {mode}")
                if not all(same[1:]) or (kname == "B3" and not same[0]):
                    raise AssertionError(f"{kname} is not bitwise "
                                         f"reproducible: {name}, {mode}")
                worst[kname][0] = max(worst[kname][0], max(ab))
                worst[kname][1] = max(worst[kname][1], max(rel))
                if mask.offset is not None and mask.offset < 0:
                    if not torch.all(got[0][:, :, :-mask.offset] == 0):
                        raise AssertionError(f"{kname}: dead rows got a "
                                             f"gradient")
                del got

    check_hgmma("B2", "flash_bwd", "bwd_kv_kernel")
    b3a_hgmma = check_hgmma("B3a", "flash_bwd_split", "bwd_dq_kernel")
    from ring_flash_attn_tpu_torch.ops import _build
    log_path = _build.build_all()["flash_bwd_split"][:-3] + ".log"
    b3a_ptxas = {n: f for n, f in ptxas_facts(log_path).items()
                 if "bwd_dq_kernel" in n}
    log(f"  B3a ptxas: {b3a_ptxas}")
    if not b3a_ptxas or any(f["spill_bytes"] for f in b3a_ptxas.values()):
        raise AssertionError(f"B3a: a build spills or is missing: "
                             f"{b3a_ptxas}")
    check_hgmma("B3b", "flash_bwd_split", "bwd_kv_kernel")
    causal = MaskArgs(causal=True)
    cases = [
        ("causal 4096", (1, 32, 8, 4096, 4096), causal, 128),
        ("prefix Sq=1024 Skv=3072 offset=2048", (1, 32, 8, 1024, 3072),
         MaskArgs(causal=True, offset=2048), 128),
        ("non-causal 1000x1500", (2, 8, 2, 1000, 1500), MaskArgs(), 128),
        ("ragged, dead rows: offset=-5, Sq=100 Skv=70", (1, 4, 2, 100, 70),
         MaskArgs(causal=True, offset=-5), 128),
        # the kv-major loop's tile edges: 128 keys a block, 64 q rows a step
        ("edge Sq=63 Skv=127 group 8", (1, 32, 4, 63, 127),
         MaskArgs(causal=True, offset=64), 128),
        ("edge Sq=64 Skv=128 group 1 D=64 non-causal", (1, 8, 8, 64, 128),
         MaskArgs(), 64),
        ("edge Sq=65 Skv=129 group 4 B=2", (2, 4, 1, 65, 129),
         MaskArgs(causal=True, offset=64), 128),
        ("edge Sq=64 Skv=255 group 8 D=64", (1, 32, 4, 64, 255),
         MaskArgs(causal=True, offset=191), 64),
        ("edge Sq=65 Skv=257 group 1, dead rows: offset=-20",
         (1, 8, 8, 65, 257), MaskArgs(causal=True, offset=-20), 128),
        ("edge Sq=129 Skv=257 group 8 D=64 non-causal", (1, 8, 1, 129, 257),
         MaskArgs(), 64),
    ]
    # the q-major dq loop's tile edges (B3A_EDGE_CASES)
    for b, hq, hkv, sq, skv, d, causal_, off in B3A_EDGE_CASES:
        cases.append((f"B3a edge Sq={sq} Skv={skv} group {hq // hkv} D={d}"
                      f" causal={causal_} offset={off}",
                      (b, hq, hkv, sq, skv), MaskArgs(causal=causal_,
                                                      offset=off), d))
    for name, shape, mask, d in cases:
        check(name, *inputs(*shape, mask, d=d), mask, ("B2", "B3"))

    # B3 is bitwise reproducible; B2's atomic dq need not be
    mask = MaskArgs(causal=True)
    q, k, v, dout, out, lse = inputs(1, 32, 8, 4096, 4096, mask)
    scale = 128 ** -0.5
    runs = {n: [fn(dout, q, k, v, lse, None, scale, mask, out=out)
                for _ in range(2)] for n, fn in kernels.items()}
    same = {n: [torch.equal(a, b) for a, b in zip(*r)]
            for n, r in runs.items()}
    log(f"  two runs bitwise equal (dq, dk, dv): B3 {same['B3']}, B2 "
        f"{same['B2']}")
    if not all(same["B3"]):
        raise AssertionError("B3a/B3b are not bitwise reproducible")
    del runs, q, k, v, dout, out, lse

    # the training path's S=36864 step, past the fused limit: its last 512
    # q rows over all 36864 keys at the full 32/8 heads (the plain
    # version's fp32 scores of the full sequence would not fit), first the
    # split kernels in both modes, then flash_attention picking them
    mask = MaskArgs(causal=True, offset=36352)
    q, k, v, dout, out, lse = inputs(1, 32, 8, 512, 36864, mask)
    check("training Sq=512 Skv=36864 offset=36352", q, k, v, dout, out, lse,
          mask, ("B3",))
    del out, lse
    torch.cuda.empty_cache()
    leaves = [x.requires_grad_() for x in (q, k, v)]
    before = (flash_bwd_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    grads = {}
    for backend in (None, "plain"):
        o, _ = flash_attention(*leaves, scale, mask, backend=backend)
        grads[backend] = torch.autograd.grad(o, leaves, dout)
        del o
    after = (flash_bwd_cuda.launches, flash_bwd_dq_cuda.launches,
             flash_bwd_dkv_cuda.launches)
    rel = [_rel_err(a, b) for a, b in zip(grads[None], grads["plain"])]
    log(f"  flash_attention q (1,32,512,128) kv (1,8,36864,128) offset "
        f"36352: launches B2 +{after[0] - before[0]}, B3a "
        f"+{after[1] - before[1]}, B3b +{after[2] - before[2]}; rel err vs "
        f"plain dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e}")
    if (after[0] != before[0] or after[1] != before[1] + 1
            or after[2] != before[2] + 1 or max(rel) > BWD_REL_TOL):
        raise AssertionError("flash_attention did not run B3a/B3b at "
                             "Skv=36864")
    del q, k, v, dout, leaves, grads
    torch.cuda.empty_cache()

    # the training path's S=8192 step (bench.py's shape): checked against
    # the plain version, then timed
    s, hq, hkv, d = 8192, 32, 8, 128
    mask = MaskArgs(causal=True)
    q, k, v, dout, out, lse = inputs(1, hq, hkv, s, s, mask)
    check("training causal 8192", q, k, v, dout, out, lse, mask,
          ("B2", "B3"))
    torch.cuda.empty_cache()
    scale = d ** -0.5
    delta = compute_delta(dout, out)
    single = dict(out=out, dq_dtype=bf16, dkv_dtype=bf16)
    b2 = kernel_ms(torch, lambda: flash_bwd_cuda(
        dout, q, k, v, lse, None, scale, mask, **single), 10, flush)
    split_ms = cuda_ms(torch, lambda: flash_bwd_split_cuda(
        dout, q, k, v, lse, None, scale, mask, **single), 10, flush)
    b3a = kernel_ms(torch, lambda: flash_bwd_dq_cuda(
        dout, q, k, v, lse, delta, scale, mask, dq_dtype=bf16), 10, flush)
    b3b = kernel_ms(torch, lambda: flash_bwd_dkv_cuda(
        dout, q, k, v, lse, delta, scale, mask, dkv_dtype=bf16), 10, flush)
    b2_ms, b3a_ms, b3b_ms = b2["ms"], b3a["ms"], b3b["ms"]
    plain_ms = cuda_ms(torch, lambda: naive_block_bwd(
        dout, q, k, v, lse, delta, scale, mask), 1, flush)
    torch.cuda.empty_cache()
    qr = q.detach().requires_grad_()
    kr = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    vr = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        o, (qr, kr, vr), dout, retain_graph=True), 10, flush)
    del o, qr, kr, vr

    pairs = s * (s + 1) // 2  # allowed (q, kv) pairs of the causal mask
    per_product = 2 * hq * d * pairs
    n_q, n_kv = q.numel(), k.numel()
    row_bytes = 4 * hq * s  # one fp32 (B, Hq, S) vector
    bounds = {
        # q, k, v, dout, out, lse in; dq, dk, dv (bf16) out
        "B2": (5 * per_product,
               2 * (3 * n_q + 2 * n_kv) + row_bytes + 2 * (n_q + 2 * n_kv)),
        # q, k, v, dout, lse, delta in; dq out
        "B3a": (3 * per_product, 2 * (2 * n_q + 2 * n_kv) + 2 * row_bytes
                + 2 * n_q),
        # q, k, v, dout, lse, delta in; dk, dv out
        "B3b": (4 * per_product, 2 * (2 * n_q + 2 * n_kv) + 2 * row_bytes
                + 4 * n_kv),
    }
    bound_ms = {n: max(f / H100_BF16_FLOPS, b / H100_BYTES_PER_S) * 1e3
                for n, (f, b) in bounds.items()}
    tflops = {n: bounds[n][0] / t / 1e9
              for n, t in (("B2", b2_ms), ("B3a", b3a_ms), ("B3b", b3b_ms))}
    log(f"  S=8192 causal bf16, single-call mode: B2 {b2_ms:.3f} ms "
        f"({tflops['B2']:.1f} TFLOP/s of its 5 products, "
        f"{b2_ms / lib_ms:.2f}x SDPA's backward, bound "
        f"{bound_ms['B2']:.3f} ms); B3a+B3b with delta pre-pass "
        f"{split_ms:.3f} ms ({split_ms / lib_ms:.2f}x SDPA's backward); B3a "
        f"{b3a_ms:.3f} ms ({tflops['B3a']:.1f} TFLOP/s of 3 products, bound "
        f"{bound_ms['B3a']:.3f}); B3b {b3b_ms:.3f} ms ({tflops['B3b']:.1f} "
        f"TFLOP/s of 4 products, bound {bound_ms['B3b']:.3f}); plain "
        f"{plain_ms:.3f} ms; SDPA backward {lib_ms:.3f} ms (operations bound "
        f"all); device time B2 {b2['device_ms']:.3f}, B3a "
        f"{b3a['device_ms']:.3f}, B3b {b3b['device_ms']:.3f} ms")
    shape = "q (1,32,8192,128) kv (1,8,8192,128) bf16 causal"
    common = {"route": "cuda", "shape": shape, "plain_ms": plain_ms,
              "bound_by": "operations",
              "library_ms": lib_ms,
              "library": "F.scaled_dot_product_attention backward, kv "
                         "repeated to 32 heads"}
    return [
        dict(common, name="B2 flash_bwd",
             source="ring_flash_attn_tpu_torch/csrc/flash_bwd.cu",
             replaces="ring_flash_attn_tpu/ops/pallas_bwd_fused.py:59",
             max_abs_err=worst["B2"][0], max_rel_err=worst["B2"][1],
             **b2, bound_ms=bound_ms["B2"], tflops=tflops["B2"]),
        dict(common, name="B3a flash_bwd_dq",
             source="ring_flash_attn_tpu_torch/csrc/flash_bwd_split.cu",
             replaces="ring_flash_attn_tpu/ops/pallas_bwd.py:56",
             max_abs_err=worst["B3"][0], max_rel_err=worst["B3"][1],
             **b3a, bound_ms=bound_ms["B3a"], pair_ms=split_ms,
             tflops=tflops["B3a"], hgmma=b3a_hgmma),
        dict(common, name="B3b flash_bwd_dkv",
             source="ring_flash_attn_tpu_torch/csrc/flash_bwd_split.cu",
             replaces="ring_flash_attn_tpu/ops/pallas_bwd.py:256",
             max_abs_err=worst["B3"][0], max_rel_err=worst["B3"][1],
             **b3b, bound_ms=bound_ms["B3b"], pair_ms=split_ms,
             tflops=tflops["B3b"]),
    ]


def _train_batch(torch, vocab, s, seed):
    """Seeded tokens (1, S), labels shifted by one with -100 last, and
    positions arange(S), on the card."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(1, s))
    tokens = torch.as_tensor(toks, device="cuda").long()
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    return tokens, labels, torch.arange(s, device="cuda")


def _timed_step(torch, model, batch):
    from ring_flash_attn_tpu_torch.models import train_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = train_step(model, *batch)
    loss = float(loss)
    torch.cuda.synchronize()
    return loss, time.perf_counter() - t0


def phase_train(torch):
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, loss_fn, train_step)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda

    log("== phase 6: training at Llama-3-8B widths, 4 layers")
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    params = list(model.named_parameters())

    # loss and gradients: kernels vs plain versions at S=2048
    batch = _train_batch(torch, cfg.vocab, 2048, 1)
    res = {}
    for backend in (None, "plain"):
        loss = loss_fn(model, *batch, backend=backend)
        grads = torch.autograd.grad(loss, [p for _, p in params])
        res[backend] = (float(loss.detach()), grads)
        del loss, grads
    (lk, gk), (lp, gp) = res[None], res["plain"]
    errs = sorted(((float((a.float() - b.float()).norm() / b.float().norm()),
                    name) for (name, _), a, b in zip(params, gk, gp)),
                  reverse=True)
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    log(f"  S=2048 loss: kernels {lk:.6f}, plain {lp:.6f} (|diff| "
        f"{abs(lk - lp):.2e}, tol {LOSS_TOL}); gradient ||k - p|| / ||p||, "
        f"worst 3 of {len(errs)}: "
        + ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])
        + f" (tol {GRAD_REL_TOL}); finite {finite}")
    if not (abs(lk - lp) <= LOSS_TOL and errs[0][0] <= GRAD_REL_TOL
            and finite):
        raise AssertionError("training gradients disagree with the plain "
                             "versions")
    del res, gk, gp
    torch.cuda.empty_cache()

    # the main path: counts from 0 over these steps only
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    batch = _train_batch(torch, cfg.vocab, 8192, 2)
    steps = [_timed_step(torch, model, batch) for _ in range(3)]
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, dt) in enumerate(steps):
        log(f"  S=8192 step {i}: loss {loss:.6f}, {dt:.3f} s, "
            f"{8192 / dt:.0f} tokens/s")
    log(f"  S=8192 peak memory {peak8:.2f} GiB")
    if not all(np.isfinite(loss) for loss, _ in steps):
        raise AssertionError(f"non-finite loss: {steps}")

    torch.cuda.reset_peak_memory_stats()
    long_batch = _train_batch(torch, cfg.vocab, 36864, 3)
    loss36, dt36 = _timed_step(torch, model, long_batch)
    peak36 = torch.cuda.max_memory_allocated() / 2**30
    log(f"  S=36864 step ({cfg.layers} layers): loss {loss36:.6f}, "
        f"{dt36:.3f} s,"
        f" {36864 / dt36:.0f} tokens/s, peak memory {peak36:.2f} GiB")
    if not np.isfinite(loss36):
        raise AssertionError(f"non-finite loss at S=36864: {loss36}")
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches over the 4 steps: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the training path: "
                             f"{launches}")

    # where the time goes in one S=8192 step
    torch.cuda.empty_cache()
    wall = min(dt for _, dt in steps[1:])
    dev = _device_profile(torch, lambda: train_step(model, *batch))
    busy_us = sum(t for t, _, _ in dev)
    log(f"  profiled S=8192 step: device busy {busy_us / 1e3:.3f} ms of the "
        f"unprofiled {wall * 1e3:.3f} ms step "
        f"({100 * busy_us / 1e3 / wall / 1e3:.1f}% busy)")
    groups = {"port kernels": ("rfa_bwd::", "bwd_dq_kernel",
                              "flash_fwd_kernel", "paged_decode"),
              "cuBLAS GEMMs": ("nvjet", "gemm", "cutlass", "sm90_xmma")}
    split = {g: 0.0 for g in (*groups, "other (elementwise, copies, "
                                       "reductions)")}
    for t, key, _ in dev:
        g = next((g for g, pre in groups.items()
                  if any(p in key for p in pre)), None)
        split[g or "other (elementwise, copies, reductions)"] += t
    log("  by kind: " + "; ".join(f"{g} {t / 1e3:.3f} ms "
                                  f"({100 * t / busy_us:.1f}%)"
                                  for g, t in split.items()))
    log("  top 10 kernels by device time:")
    for t, key, count in dev[:10]:
        log(f"    {100 * t / busy_us:5.1f}%  {t / 1e3:9.3f} ms  x{count:<4d} "
            f"{key[:80]}")
    return launches, [loss for loss, _ in steps]


def _check_pair(what, name, got, ref, tol):
    eo, el = max_err(got[0], ref[0]), max_err(got[1], ref[1])
    log(f"  {name}: max|out| err {eo:.3e}, max|lse| err {el:.3e} "
        f"(tol {tol})")
    if not (eo <= tol and el <= tol):
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"{name}")
    return max(eo, el)


def phase_b4(torch, flush):
    from ring_flash_attn_tpu_torch.ops.quant import (
        _plain_quant_decode, quantize_kv)
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    log("== phase 7: kernel B4 (quantized contiguous decode) vs its plain "
        "version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5

    def cache_of(b, s, qdtype):
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev)
        return quantize_kv(k, v, qdtype)

    def q_of(b, tq=1, dtype=torch.bfloat16):
        return torch.randn((b, hq, tq, d), generator=gen,
                           device=dev).to(dtype)

    def run(q, c, length, cap=None):
        return quant_decode_cuda(q, c.k_q, c.k_scale, c.v_q, c.v_scale,
                                 length, scale, softcap=cap)

    big = cache_of(1, 32768, "int8")
    q1 = q_of(1)
    len_t = torch.tensor([20000], dtype=torch.int32, device=dev)
    # (name, q, cache, length, softcap)
    cases = [
        ("int8 S=32768 length 32768", q1, big, 32768, None),
        ("int8 S=32768 length 30001", q1, big, 30001, None),
        ("int8 S=32768 length 0", q1, big, 0, None),
        ("int8 S=32768 length 20000 as a CUDA tensor", q1, big, len_t, None),
        ("int8 S=32768 softcap 12", q1, big, 32768, 12.0),
        ("fp8_e4m3 S=32768", q1, cache_of(1, 32768, "fp8_e4m3"), 32768, None),
        ("fp8_e5m2 S=32768 length 30001", q1, cache_of(1, 32768, "fp8_e5m2"),
         30001, None),
        ("int8 B=2 S=4096 f32 q", q_of(2, dtype=torch.float32),
         cache_of(2, 4096, "int8"), 4000, None),
        ("int8 Tq=2 (8 rows) S=1280", q_of(1, tq=2), cache_of(1, 1280, "int8"),
         1280, None),
        ("int8 tail cache S=32 length 7", q1, cache_of(1, 32, "int8"), 7,
         None),
    ]
    # the pipelines' edges (quant_decode.cuh: 64-token chunks dealt out in
    # turn to 3 pipelines a block, 3 stages a ring): one split over
    # C * NP * NST - 1, C * NP * NST, C * NP * NST + 1 tokens (the last
    # wraps pipeline 0's ring); S = 1; 14 of 16 splits with no chunk;
    # R = 16 (Tq = 4) in int8 and fp8
    edge = cache_of(1, 640, "fp8_e4m3")
    cases += [
        (f"fp8_e4m3 S=640 length {n} (one split)", q1, edge, n, None)
        for n in (575, 576, 577)]
    cases += [
        ("int8 S=1", q1, cache_of(1, 1, "int8"), 1, None),
        ("int8 S=32768 length 100 (14 empty splits)", q1, big, 100, None),
        ("int8 Tq=4 (16 rows) S=32768 length 32000", q_of(1, tq=4), big,
         32000, 30.0),
        ("fp8_e5m2 Tq=4 (16 rows) S=3000", q_of(1, tq=4),
         cache_of(1, 3000, "fp8_e5m2"), 2999, None),
    ]
    worst = 0.0
    for name, q, c, length, cap in cases:
        got = run(q, c, length, cap)
        ref = _plain_quant_decode(q, c, length, scale, cap)
        torch.cuda.synchronize()
        worst = max(worst, _check_pair("B4", name, got, ref, QUANT_TOL))
        if name.endswith("length 0") and not (
                bool((got[0] == 0).all()) and bool((got[1] == -1e30).all())):
            raise AssertionError("B4: length 0 must give out=0, lse=NEG_INF")
    # the same bits call after call, also after calls of other shapes on
    # the same workspace (its group counters are back at zero each time)
    again = run(q1, big, 32768)
    for q, c, length, cap in ((q1, big, 32768, None),
                              (cases[-1][1], cases[-1][2], 2999, None),
                              (q1, edge, 577, None)):
        if not torch.equal(again[0], run(q1, big, 32768)[0]):
            raise AssertionError("B4 is not bitwise reproducible")
        run(q, c, length, cap)
    del edge

    # the launch takes less device time than the host needs to issue it,
    # so ms (CUDA events around the call) holds the launcher's host work
    # and device_ms is what the card spends
    t = kernel_ms(torch, lambda: run(q1, big, 32768), 20, flush)
    ms, dev_ms = t["ms"], t["device_ms"]
    # the other half of generate's B4 launches: its 32-token tail cache
    tail_c = next(c for name, _, c, _, _ in cases
                  if name.startswith("int8 tail cache"))
    tail = kernel_ms(torch, lambda: run(q1, tail_c, 32), 20, flush)
    plain_ms = cuda_ms(torch, lambda: _plain_quant_decode(
        q1, big, 32768, scale), 5, flush)
    cache_bytes = 2 * big.k_q.numel() + 2 * 4 * big.k_scale.numel()
    io_bytes = 2 * q1.numel() + 4 * (q1.numel() + hq)
    flops = 4 * 32768 * hq * d
    bound_ms = max((cache_bytes + io_bytes) / H100_BYTES_PER_S,
                   flops / H100_BF16_FLOPS) * 1e3
    log(f"  B=1 S=32768 int8: kernel {ms:.4f} ms between CUDA events around "
        f"the call ({ms / bound_ms:.1f}x its bound), {dev_ms:.4f} ms of "
        f"device time ({dev_ms / bound_ms:.1f}x; "
        f"{cache_bytes / dev_ms / 1e6:.1f} GB/s of cache), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes: "
        f"{cache_bytes / 1e6:.1f} MB of cache and scales); the 32-token "
        f"tail cache: {tail['ms']:.4f} ms, {tail['device_ms']:.4f} ms of "
        f"device time")
    return {
        "name": "B4 quant_decode", "route": "cuda",
        "source": "ring_flash_attn_tpu_torch/csrc/quant_decode.cu",
        "replaces": "ring_flash_attn_tpu/ops/quant_decode_pallas.py:28",
        "shape": "q (1,32,1,128) bf16, cache (1,8,32768,128) int8, "
                 "length 32768",
        "max_abs_err": worst, **t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "tail_s32": tail,
    }, decode_wide(torch, "B4", flush)


def _quant_paged_path(torch, rnd, hq, hkv, d, tables, num_pages,
                      what="B6"):
    """B6's path through the op-level entry points (phase 8): 4 lanes of
    ``tables`` (4, 16) in pages of 256 over a pool of ``num_pages``,
    ``paged_quant_prefill`` of 2048, 1000, 0 and 513 tokens, then 8 steps
    of ``paged_quant_append`` (lane 2 masked) and
    ``paged_quant_decode_attention`` at Hq / Hkv heads of d; a second
    cache, filled the same way, goes to the plain version. Returns (the
    worst error, the kernel's launches over the 8 steps)."""
    from ring_flash_attn_tpu_torch.ops import paged as P
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)

    b2, ctx, ps, pps = 4, 2048, 256, tables.shape[1]
    scale = d ** -0.5
    k, v = rnd(b2, hkv, ctx, d), rnd(b2, hkv, ctx, d)
    start = [2048, 1000, 0, 513]
    mask = torch.tensor([True, True, False, True], device="cuda")
    caches = [P.paged_quant_prefill(
        P.paged_quant_init(b2, hkv, num_pages, ps, pps, d,
                           block_tables=tables), k, v, start)
        for _ in range(2)]
    saved = paged_quant_decode_cuda.launches
    paged_quant_decode_cuda.launches = 0
    step_worst = 0.0
    for step in range(8):
        k_new, v_new = rnd(b2, hkv, 1, d), rnd(b2, hkv, 1, d)
        caches = [P.paged_quant_append(c, k_new, v_new, mask=mask)
                  for c in caches]
        q = rnd(b2, hq, 1, d).to(torch.bfloat16)
        got = P.paged_quant_decode_attention(q, caches[0], scale)
        ref = P.paged_quant_decode_attention(q, caches[1], scale,
                                             backend="plain")
        torch.cuda.synchronize()
        eo, el = max_err(got[0], ref[0]), max_err(got[1], ref[1])
        step_worst = max(step_worst, eo, el)
        if not (eo <= QUANT_TOL and el <= QUANT_TOL):
            raise AssertionError(f"{what} disagrees with its plain version "
                                 f"at append step {step}: {eo:.3e} {el:.3e}")
    path_launches = paged_quant_decode_cuda.launches
    paged_quant_decode_cuda.launches = saved
    end = caches[0].seq_lens.tolist()
    same = all(torch.equal(x, y)
               for x, y in zip(caches[0][:4], caches[1][:4]))
    log(f"  {what}: prefill {start} + 8 x (append, decode) at {hq}/{hkv} "
        f"heads of {d}: worst err {step_worst:.3e} (tol {QUANT_TOL}); lens "
        f"now {end}; the two caches bitwise equal {same}; launches "
        f"{path_launches}")
    if end != [2056, 1008, 0, 521] or not same or path_launches != 8:
        raise AssertionError(f"{what}: the quantized paged path went wrong")
    return step_worst, path_launches


def phase_b6(torch, flush):
    from ring_flash_attn_tpu_torch.ops import paged as P
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)

    log("== phase 8: kernel B6 (quantized paged decode) vs its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    lens = [0, 1, 255, 256, 257, 1000, 4095, 4096]
    b, hq, hkv, d, ps, pps = len(lens), 32, 8, 128, 256, 16
    scale = d ** -0.5
    perm = np.random.default_rng(8).permutation(b * pps).astype(np.int32)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def kernel(q, c, cap=None):
        return paged_quant_decode_cuda(
            q, c.k_pages, c.k_scales, c.v_pages, c.v_scales, c.block_tables,
            c.seq_lens, scale, softcap=cap)

    k, v = rnd(b, hkv, pps * ps, d), rnd(b, hkv, pps * ps, d)
    q1, q2 = rnd(b, hq, 1, d).to(torch.bfloat16), rnd(b, hq, 2, d)
    worst = 0.0
    for qdtype in ("int8", "fp8_e4m3", "fp8_e5m2"):
        c = P.paged_quant_init(b, hkv, b * pps, ps, pps, d, qdtype=qdtype,
                               block_tables=perm.reshape(b, pps))
        c = P.paged_quant_prefill(c, k, v, lens)
        for name, q, cap in ((f"{qdtype}, bf16 q", q1, None),
                             (f"{qdtype}, softcap 30, Tq=2 f32 q", q2, 30.0)):
            got = kernel(q, c, cap)
            ref = P._plain_quant_paged_decode(q, c, scale, cap)
            torch.cuda.synchronize()
            worst = max(worst, _check_pair("B6", name, got, ref, QUANT_TOL))
            if not (bool((got[0][0] == 0).all())
                    and bool((got[1][0] == -1e30).all())):
                raise AssertionError("B6: a dead lane must give out=0, "
                                     "lse=NEG_INF")
    # the same bits call after call, also after a call of another shape
    again = kernel(q1, c)
    for other in (q2, q1[:, :8].contiguous(), q1):
        if not all(torch.equal(x, y) for x, y in zip(again, kernel(q1, c))):
            raise AssertionError("B6 is not bitwise reproducible")
        kernel(other, c)
    # the pipelines' edges: pages of one chunk, 10 a lane (one split),
    # lanes of C * NP * NST - 1, C * NP * NST and C * NP * NST + 1 tokens
    # (the last wraps pipeline 0's ring) and of 1 token; R = 16 (Tq = 4)
    elens = [0, 575, 576, 577, 1]
    ke = rnd(len(elens), hkv, 640, d)
    q16 = rnd(len(elens), hq, 4, d).to(torch.bfloat16)
    for qdtype in ("int8", "fp8_e5m2"):
        ce = P.paged_quant_prefill(P.paged_quant_init(
            len(elens), hkv, 10 * len(elens), 64, 10, d, qdtype=qdtype,
            block_tables=np.random.default_rng(9).permutation(
                10 * len(elens)).astype(np.int32).reshape(-1, 10)),
            ke, ke.flip(-1), elens)
        for name, q in ((f"{qdtype}, pages of 64, lens {elens}",
                         q16[:, :, :1].contiguous()),
                        (f"{qdtype}, pages of 64, Tq=4 (16 rows)", q16)):
            got = kernel(q, ce)
            ref = P._plain_quant_paged_decode(q, ce, scale, None)
            torch.cuda.synchronize()
            worst = max(worst, _check_pair("B6", name, got, ref, QUANT_TOL))
    del c, k, v, ke, ce

    # its path through the op-level entry points: prefill, then 8 steps of
    # append + decode; a second cache, filled the same way, goes to the
    # plain version. Launches are counted over the kernel's calls only.
    step_worst, path_launches = _quant_paged_path(
        torch, rnd, hq, hkv, d, perm[:4 * pps].reshape(4, pps), b * pps)
    worst = max(worst, step_worst)

    # timing: 4 lanes of 8192 tokens, pages of 256 and 512, int8; B5 on the
    # same tokens in bf16 pages of 256
    b3, ctx = 4, 8192
    k, v = rnd(b3, hkv, ctx, d), rnd(b3, hkv, ctx, d)
    q = rnd(b3, hq, 1, d).to(torch.bfloat16)
    full = [ctx] * b3
    times = {}  # page size -> the kernel's two readings
    for page in (256, 512):
        n = b3 * ctx // page
        tbl = np.random.default_rng(page).permutation(n).astype(
            np.int32).reshape(b3, -1)
        c = P.paged_quant_prefill(
            P.paged_quant_init(b3, hkv, n, page, n // b3, d,
                               block_tables=tbl), k, v, full)
        times[page] = kernel_ms(torch, lambda: kernel(q, c), 20, flush)
        if page == 256:
            plain_ms = cuda_ms(torch, lambda: P._plain_quant_paged_decode(
                q, c, scale), 5, flush)
            cache_bytes = 2 * c.k_pages.numel() + 2 * 4 * c.k_scales.numel()
            bf = P.paged_prefill(P.paged_init(hkv, n, page, d, tbl), k, v,
                                 full)
            b5 = kernel_ms(torch, lambda: paged_decode_cuda(
                q, bf.k_pages, bf.v_pages, bf.block_tables, bf.seq_lens,
                scale), 10, flush)
            del bf
    io_bytes = 2 * q.numel() + 4 * (q.numel() + b3 * hq) + 4 * tbl.size
    flops = 4 * b3 * ctx * hq * d
    bound_ms = max((cache_bytes + io_bytes) / H100_BYTES_PER_S,
                   flops / H100_BF16_FLOPS) * 1e3
    t, t512 = times[256], times[512]
    log(f"  B=4 ctx 8192 int8, page 256: kernel {t['ms']:.4f} ms between "
        f"CUDA events around the call ({t['ms'] / bound_ms:.1f}x its bound), "
        f"{t['device_ms']:.4f} ms of device time "
        f"({t['device_ms'] / bound_ms:.1f}x; "
        f"{cache_bytes / t['device_ms'] / 1e6:.1f} GB/s of pages); page 512: "
        f"{t512['ms']:.4f} and {t512['device_ms']:.4f} ms; plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes: "
        f"{cache_bytes / 1e6:.1f} MB of pages and scales); B5 on the same "
        f"tokens in bf16 pages of 256: {b5['ms']:.4f} and "
        f"{b5['device_ms']:.4f} ms ({b5['ms'] / t['ms']:.1f}x and "
        f"{b5['device_ms'] / t['device_ms']:.1f}x B6's)")
    return {
        "name": "B6 paged_quant_decode", "route": "cuda",
        "source": "ring_flash_attn_tpu_torch/csrc/paged_quant_decode.cu",
        "replaces": "ring_flash_attn_tpu/ops/paged.py:615",
        "shape": "q (4,32,1,128) bf16, pages (128,8,256,128) int8, lens "
                 "8192 x 4",
        "max_abs_err": worst, **t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "page_512": t512, "b5_bf16": b5,
    }, {"B6 paged_quant_decode": path_launches}, _b6_wide(torch, rnd, flush)


def _b6_wide(torch, rnd, flush):
    """Phase 8 at the decode loop's new builds: B6 on every DECODE_CASES
    case, then its op-level path at each family's attention
    (B6_WIDE_PATHS). Returns ({family: readings}, {family: the path's
    launches})."""
    wide = decode_wide(torch, "B6", flush)
    launches = {}
    tables = np.random.default_rng(80).permutation(64).astype(
        np.int32).reshape(4, 16)
    for fam, (hq, hkv, d) in B6_WIDE_PATHS.items():
        err, launches[fam] = _quant_paged_path(torch, rnd, hq, hkv, d, tables,
                                               64, what=f"B6 {fam}")
        wide[fam][0]["path_max_abs_err"] = err
    return wide, launches


# ---------------------------------------------------------------------------
# the decode loop (B4, B5, B6) at head dims 64 and 256 and past the rows one
# block serves (csrc/quant_decode.cuh::max_rows: 16, 8 at 256), held in
# phases 3, 7 and 8 and in tests/test_torch_cuda.py: the attention of the
# models phase 24 serves (Llama-3.2-1B 32/8 heads of 64, Gemma-7B 16/16 and
# Gemma-2B 8/1 of 256, StarCoder 48/1 of 128) and Falcon-7B's odd group
# (71/1 of 64). (name, head dim, Hq, Hkv, Tq, B4/B6 cache type, softcap,
# the paged kernels' page size): Tq > 1 is a speculative verify (B5 with
# new_counts); every D's instantiations at 4, 8 and 16 rows and in row
# groups (RG) are met, each of the three cache types at each head dim,
# and pages shorter than a 64-token chunk (16, as the serving example's)
# beside 64, 128 and 256
DECODE_CASES = [
    ("Llama-3.2-1B", 64, 32, 8, 1, "int8", None, 256),
    ("Llama-3.2-1B Tq=2", 64, 32, 8, 2, "fp8_e4m3", 20.0, 16),
    ("Llama-3.2-1B Tq=4", 64, 32, 8, 4, "fp8_e5m2", None, 256),
    ("Llama-3.2-1B Tq=5 (20 rows)", 64, 32, 8, 5, "int8", None, 256),
    ("Falcon-7B (71 rows)", 64, 71, 1, 1, "fp8_e4m3", None, 64),
    ("Falcon-7B Tq=5 (355 rows)", 64, 71, 1, 5, "int8", 20.0, 256),
    ("Gemma-7B", 256, 16, 16, 1, "int8", 30.0, 256),
    ("Gemma-2B (8 rows)", 256, 8, 1, 1, "fp8_e5m2", None, 256),
    ("Gemma-2B Tq=5 (40 rows)", 256, 8, 1, 5, "int8", None, 16),
    ("G=48 at 256", 256, 48, 1, 1, "fp8_e4m3", None, 256),
    ("StarCoder (48 rows)", 128, 48, 1, 1, "int8", None, 256),
    ("StarCoder Tq=5 (240 rows)", 128, 48, 1, 5, "fp8_e5m2", 30.0, 128),
]
# B6's op-level path (phase 8) at each family's attention, (Hq, Hkv, D):
# Llama-3.2-1B's, Gemma-2B's and StarCoder's
B6_WIDE_PATHS = {"D64": (32, 8, 64), "D256": (8, 1, 256),
                 "G>16": (48, 1, 128)}
# the paged kernels' lanes (a dead lane, one token, a ragged and a long
# one) in shuffled pages; B4's cache of DECODE_S positions
# at length DECODE_S - 192 (a CUDA tensor in every other case)
DECODE_LENS = [0, 1, 3000, 8192]
DECODE_S = 8192


def _decode_bound_ms(q, tokens, hkv, value_bytes, scales, table_ints=0,
                     qk_int8=False):
    """The least time of a decode over ``tokens`` live tokens a kv head:
    the cache's K and V (and fp32 scales) once, q, out, lse and the table
    (bytes), or the operations of QK and PV, 2 * tokens * rows * D each a
    kv head, at the peak of their type, whichever is larger: PV at the bf16
    tensor-core peak, QK there too or, with ``qk_int8`` (B6 on int8 pages:
    an exact s8 product), at the int8 peak. Returns (ms, "bytes" or
    "operations")."""
    b, hq, tq, d = q.shape
    nbytes = (2 * tokens * hkv * d * value_bytes + 2 * 4 * tokens * hkv * scales
              + q.element_size() * q.numel() + 4 * (q.numel() + b * hq * tq)
              + 4 * table_ints)
    ops = 2 * tokens * hq * tq * d  # QK's, and PV's
    by_bytes = nbytes / H100_BYTES_PER_S
    by_ops = ops / (H100_INT8_OPS if qk_int8 else H100_BF16_FLOPS) + (
        ops / H100_BF16_FLOPS)
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def decode_case_inputs(torch, case, kernel, seed=0):
    """The inputs of a DECODE_CASES case for ``kernel`` ("B4", "B5" or
    "B6") on the card: (the kernel's call, the plain version's call, its
    tolerance, (the bound ms, what bounds it), a description)."""
    from ring_flash_attn_tpu_torch.ops import paged as P
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.paged_quant_decode_cuda import (
        paged_quant_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import (
        _plain_quant_decode, quantize_kv)
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    name, d, hq, hkv, tq, qdtype, cap, page = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1000 + seed)
    scale = d ** -0.5
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if kernel == "B4":
        b, length = 2, DECODE_S - 192
        c = quantize_kv(rnd(b, hkv, DECODE_S, d), rnd(b, hkv, DECODE_S, d),
                        qdtype)
        q = rnd(b, hq, tq, d).to(bf16 if seed % 2 else torch.float32)
        arg = (torch.tensor([length], dtype=torch.int32, device=dev)
               if seed % 2 else length)
        return (lambda: quant_decode_cuda(
                    q, c.k_q, c.k_scale, c.v_q, c.v_scale, arg, scale,
                    softcap=cap),
                lambda: _plain_quant_decode(q, c, arg, scale, cap),
                QUANT_TOL,
                _decode_bound_ms(q, b * length, hkv, 1, True),
                f"B=2 S={DECODE_S} length {length} {qdtype}")
    b, pps = len(DECODE_LENS), DECODE_S // page
    perm = np.random.default_rng(seed).permutation(b * pps).astype(np.int32)
    tables = perm.reshape(b, pps)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    q = rnd(b, hq, tq, d).to(bf16)
    tokens = sum(DECODE_LENS)
    what = f"lanes {DECODE_LENS} in pages of {page}"
    if kernel == "B5":
        shape = (b * pps, hkv, page, d)
        cache = P.PagedKVCache(rnd(*shape).to(bf16), rnd(*shape).to(bf16),
                               torch.as_tensor(tables, device=dev), lens)
        counts = None if tq == 1 else torch.tensor(
            [0, 1, tq, tq], dtype=torch.int32, device=dev)
        return (lambda: paged_decode_cuda(
                    q, cache.k_pages, cache.v_pages, cache.block_tables,
                    cache.seq_lens, scale, softcap=cap, new_counts=counts),
                lambda: P._plain_paged_decode(q, cache, scale, cap, counts),
                B5_TOL,
                _decode_bound_ms(q, tokens, hkv, 2, False, tables.size),
                what + ("" if counts is None else
                        f", new_counts {counts.tolist()}"))
    c = P.paged_quant_prefill(
        P.paged_quant_init(b, hkv, b * pps, page, pps, d,
                           qdtype=qdtype, block_tables=tables, device=dev),
        rnd(b, hkv, DECODE_S, d), rnd(b, hkv, DECODE_S, d), DECODE_LENS)
    return (lambda: paged_quant_decode_cuda(
                q, c.k_pages, c.k_scales, c.v_pages, c.v_scales,
                c.block_tables, c.seq_lens, scale, softcap=cap),
            lambda: P._plain_quant_paged_decode(q, c, scale, cap),
            QUANT_TOL,
            _decode_bound_ms(q, tokens, hkv, 1, True, tables.size,
                             qk_int8=qdtype == "int8"),
            f"{what}, {qdtype}")


def decode_case_check(torch, case, kernel, seed=0):
    """A DECODE_CASES case through ``kernel``: twice, the same bits, within
    the kernel's tolerance of its plain version, and a dead lane (B5, B6)
    or a length of 0 (B4, a third call) at out = 0, lse = NEG_INF. Returns
    (the worst error, the kernel's call, the plain version's call, (the
    bound ms, what bounds it), a description)."""
    run, plain, tol, bound, what = decode_case_inputs(torch, case, kernel,
                                                      seed)
    got, again = run(), run()
    ref = plain()
    torch.cuda.synchronize()
    eo, el = max_err(got[0], ref[0]), max_err(got[1], ref[1])
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    label = f"{kernel} {case[0]} (D={case[1]}, {case[2]}/{case[3]} heads, " \
        f"Tq={case[4]}, softcap {case[6]}; {what})"
    if not (eo <= tol and el <= tol):
        raise AssertionError(f"{label}: out {eo:.3e}, lse {el:.3e} against "
                             f"the plain version (tol {tol})")
    if not same:
        raise AssertionError(f"{label}: two calls differ")
    if kernel != "B4" and not (bool((got[0][0] == 0).all())
                               and bool((got[1][0] == -1e30).all())):
        raise AssertionError(f"{label}: the dead lane is not (0, NEG_INF)")
    log(f"  {label}: max|out| err {eo:.3e}, max|lse| err {el:.3e} (tol "
        f"{tol}); two calls bitwise equal")
    return max(eo, el), run, plain, bound, what


def decode_wide(torch, kernel, flush):
    """Phases 3, 7 and 8: ``kernel`` on every DECODE_CASES case against its
    plain version, each timed beside its bound; B4 also at length 0 in row
    groups. Returns {family: [its readings]}, the first case of each
    family with the plain version's time."""
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    log(f"  {kernel} at head dims 64 and 256 and past one block's rows:")
    out = {}
    for i, case in enumerate(DECODE_CASES):
        err, run, plain, (bound, by), what = decode_case_check(
            torch, case, kernel, seed=i)
        t = kernel_ms(torch, run, 10, flush)
        # its family in the kernels line: "D64", "D256", or "G>16" (the
        # cases at 128 all pass the 16 rows a block serves: row groups)
        fam = "G>16" if case[1] == 128 else f"D{case[1]}"
        entry = {"case": case[0], "d": case[1], "heads": case[2:4],
                 "tq": case[4], "shape": what, "max_abs_err": err, **t,
                 "bound_ms": bound, "bound_by": by}
        if fam not in out:
            entry["plain_ms"] = cuda_ms(torch, plain, 3, flush)
        log(f"    {case[0]}: {t['ms']:.4f} ms, device {t['device_ms']:.4f} "
            f"ms, bound {bound:.4f} ms ({by}); "
            f"{t['device_ms'] / bound:.1f}x")
        out.setdefault(fam, []).append(entry)
        del run, plain
    if kernel == "B4":  # length 0 in row groups: every row dead
        _, d, hq, hkv, tq, _, _, _ = DECODE_CASES[5]
        dev = torch.device("cuda")
        z = torch.zeros((1, hkv, 64, d), dtype=torch.int8, device=dev)
        s = torch.ones((1, hkv, 64), device=dev)
        o, l = quant_decode_cuda(torch.ones((1, hq, tq, d), device=dev),
                                 z, s, z, s, 0, 0.125)
        if not (bool((o == 0).all()) and bool((l == -1e30).all())):
            raise AssertionError("B4 at length 0 in row groups: not "
                                 "(0, NEG_INF)")
    torch.cuda.empty_cache()
    return out


def phase_generate(torch):
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, decode_step, generate, init_params, prefill)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.quant import make_cache
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    log("== phase 9: long-context inference at Llama-3-8B widths, 4 layers, "
        "one process")
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    steps = 32

    def prompt_of(n, seed):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(1, n))
        return torch.as_tensor(toks, device="cuda")

    def tails_of():
        return [make_cache(1, cfg.kv_heads, steps, cfg.head_dim)
                for _ in model.layers]

    def rel(a, ref):
        return max_err(a, ref) / float(ref.abs().max())

    # the whole path at a 4096-token prompt: kernels vs plain versions
    short = prompt_of(4096, 9)
    res = {}
    for backend in (None, "plain"):
        lp, caches = prefill(model, short, backend=backend)
        last = lp[:, -1].clone()
        del lp
        ld, _ = decode_step(model, last.argmax(-1), 4096, 0, caches,
                            tails_of(), backend=backend)
        toks = generate(model, short, 8, backend=backend)
        res[backend] = (last, ld, toks)
        del caches
    e_pre, e_dec = (rel(res[None][i], res["plain"][i]) for i in (0, 1))
    agree = int((res[None][2] == res["plain"][2]).sum())
    log(f"  4096-token prompt, kernels vs plain: last prefill logits "
        f"{e_pre:.3e}, first decode-step logits {e_dec:.3e} of max|plain| "
        f"(tol {LOGITS_REL_TOL}); generated tokens equal {agree}/8")
    if not (e_pre <= LOGITS_REL_TOL and e_dec <= LOGITS_REL_TOL):
        raise AssertionError("generate's logits disagree with the plain "
                             "versions")
    del res
    torch.cuda.empty_cache()

    # the main path: counts from 0 over this run only
    prompt = prompt_of(32768, 10)
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B4 quant_decode": quant_decode_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, prompt, steps, max_new=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  generate: 32768-token prompt, {steps} steps in {wall:.3f} s; "
        f"launches {launches}; peak memory {peak:.2f} GiB; tokens "
        f"{toks[0, :8].tolist()}...")
    if (tuple(toks.shape) != (1, steps) or toks.dtype != torch.int32
            or not bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        raise AssertionError(f"generate returned {toks}")
    want = {"B1 flash_fwd": cfg.layers,
            "B4 quant_decode": cfg.layers * steps * 2}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    # the same run in its two parts, timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(model, prompt)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    token = logits[:, -1].argmax(-1)
    if not bool(torch.isfinite(logits[:, -1]).all()):
        raise AssertionError("non-finite prefill logits")
    del logits
    tails = tails_of()
    first, _ = decode_step(model, token, 32768, 0, caches, tails)
    plain_first, _ = decode_step(model, token, 32768, 0, caches, tails_of(),
                                 backend="plain")
    e_first = rel(first, plain_first)
    mine = [token]
    token = first.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, steps):
        mine.append(token)
        lg, _ = decode_step(model, token, 32768 + step, step, caches, tails)
        token = lg.argmax(-1)
    torch.cuda.synchronize()
    dec_s = (time.perf_counter() - t0) / (steps - 1)
    same = bool((torch.stack(mine, 1) == toks).all())
    log(f"  prefill {pre_s:.3f} s ({32768 / pre_s:.0f} tokens/s); decode "
        f"{dec_s * 1e3:.3f} ms per step ({1 / dec_s:.1f} steps/s) over "
        f"{steps - 1} steps; first decode-step logits kernels vs plain over "
        f"the same caches {e_first:.3e} of max|plain| (tol "
        f"{LOGITS_REL_TOL}); the steps driven by hand give generate's "
        f"tokens: {same}")
    if not (e_first <= LOGITS_REL_TOL and bool(torch.isfinite(lg).all())):
        raise AssertionError("the 32768-token decode step disagrees with "
                             "the plain versions")
    if not same:
        raise AssertionError("generate and its parts gave different tokens")

    # where the time goes in one decode step
    dev = _device_profile(torch, lambda: decode_step(
        model, token, 32768 + steps - 1, steps - 1, caches, tails))
    busy_us = sum(t for t, _, _ in dev)
    log(f"  profiled decode step: device busy {busy_us / 1e3:.3f} ms of the "
        f"unprofiled {dec_s * 1e3:.3f} ms step "
        f"({100 * busy_us / 1e3 / dec_s / 1e3:.1f}% busy)")
    log("  top 8 kernels by device time:")
    for t, key, count in dev[:8]:
        log(f"    {100 * t / busy_us:5.1f}%  {t / 1e3:9.3f} ms  x{count:<4d} "
            f"{key[:80]}")
    return launches



# ---------------------------------------------------------------------------
# the ring on one device: every rank's shards in one process


def ring_forward_one_device(q, k, v, world, scale, causal, backend=None,
                            softcap=None, alibi_slopes=None):
    """The fused ring's forward for all ``world`` ranks in one process:
    q, k, v are the global (B, H, S, D) tensors, rank r's shard the r-th of
    ``world`` chunks along S. Every rank drives the step functions that
    ``_fused_ring_forward`` drives, on the shard of ``(rank - step) %
    world``. Returns the global (out, lse)."""
    import torch

    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    kw = fr._transforms(q, causal, softcap, alibi_slopes)
    l_local = q.shape[2] // world
    ks, vs = k.chunk(world, dim=2), v.chunk(world, dim=2)
    outs, lses = [], []
    for rank, q_r in enumerate(q.chunk(world, dim=2)):
        qs = fr._prescale(q_r, scale * fr.LOG2E)
        state = fr.new_state(qs)
        last_step = rank if causal else world - 1
        for step in range(last_step + 1):
            src = (rank - step) % world
            res = fr.fwd_step(
                qs, ks[src], vs[src], state, backend=backend,
                diagonal=causal and step == 0, first=step == 0,
                last=step == last_step, q_pos0=rank * l_local,
                kv_pos0=src * l_local, **kw)
        outs.append(res[0])
        lses.append(res[1])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def ring_backward_one_device(q, k, v, dout, out, lse, world, scale, causal,
                             backend=None, softcap=None, alibi_slopes=None):
    """The fused ring's backward for all ranks in one process, step by step
    as ``_fused_ring_backward`` runs it: at step t rank r holds the kv shard
    and the fp32 dk/dv accumulator of rank ``(r - t) % world``, which was
    handed on from rank r - 1 after step t - 1. Returns the global (dq, dk,
    dv) in fp32."""
    import torch

    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import bwd_delta
    from ring_flash_attn_tpu_torch.ops.mask import NEG_INF
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    kw = fr._transforms(q, causal, softcap, alibi_slopes)
    l_local = q.shape[2] // world
    kernel = q.is_cuda and backend is None
    delta_fn = bwd_delta if kernel else compute_delta

    def shards(x):
        return x.chunk(world, dim=2)

    qs = [fr._prescale(x, scale * fr.LOG2E) for x in shards(q)]
    ks, vss = shards(k), [fr._prescale(x, scale) for x in shards(v)]
    douts = [x.contiguous() for x in shards(dout)]
    lse2 = [(x.float() * fr.LOG2E).clamp(min=NEG_INF / 2).contiguous()
            for x in shards(lse)]
    delta = [delta_fn(d, o.contiguous()) * scale
             for d, o in zip(douts, shards(out))]
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in qs]
    dkv = [torch.empty((2,) + tuple(x.shape), dtype=torch.float32,
                       device=q.device) for x in ks]
    for step in range(world):
        for rank in range(world):
            if causal and step > rank:
                continue  # the accumulator passes through untouched
            src = (rank - step) % world
            fr.bwd_step(qs[rank], ks[src], vss[src], douts[rank], lse2[rank],
                        delta[rank], dq[rank], dkv[src][0], dkv[src][1],
                        backend=backend, diagonal=causal and step == 0,
                        accumulate=step > 0, q_pos0=rank * l_local,
                        kv_pos0=src * l_local, **kw)
    # after W hops accumulator `src` is back on rank `src`
    dk = torch.cat([a[0] for a in dkv], dim=2) * (fr.LN2 / scale)
    return torch.cat(dq, dim=2), dk, torch.cat([a[1] for a in dkv], dim=2)


def _finish(torch, m, l, acc):
    """(out fp32, lse) of a ring state, as the last step would give it: a
    row that has seen no key yet (l = 0) gives (0, NEG_INF)."""
    live = l > 0
    safe = torch.where(live, l, torch.ones_like(l))
    out = (acc / safe[..., None]) * live[..., None]
    lse = torch.where(live, (m + torch.log2(safe)) * float(np.log(2.0)),
                      torch.full_like(m, -1e30))
    return out, lse


def fused_ring_case(torch, rnd, worst, name, b, hq, hkv, sq, skv, d, steps,
                    causal=True, cap=None, alibi=False, q_row0=0,
                    q_slice=None):
    """B7 and B8 against their plain versions over a rank's steps (dicts
    of diagonal, q_pos0, kv_pos0), each on its own kv shard from ``rnd``
    (bf16 on the card): forward state after every step and (out, lse)
    after the last, then the backward steps into shared accumulators.
    With ``q_slice`` the kernels see all sq rows in the forward and the
    plain versions (and both backwards) the last q_slice rows. Raises
    past the limits; keeps the worst errors in ``worst`` {"B7": [abs,
    rel], "B8": [abs, rel]}."""
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import bwd_delta
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    dev = torch.device("cuda")
    scale = d ** -0.5
    slopes = (torch.tensor([2.0 ** (-8.0 * (i + 1) / hq)
                            for i in range(hq)], device=dev)
              if alibi else None)
    q = rnd(b, hq, sq, d)
    kw = fr._transforms(q, causal, cap, slopes)
    qs = fr._prescale(q, scale * fr.LOG2E)
    kvs = [(rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)) for _ in steps]
    rows = slice(sq - q_slice, sq) if q_slice else slice(None)
    row0 = q_row0 + (sq - q_slice if q_slice else 0)
    qs_p = qs[:, :, rows].contiguous()
    st_k, st_p = fr.new_state(qs), fr.new_state(qs_p)
    for i, (step, (k, v)) in enumerate(zip(steps, kvs)):
        flags = dict(first=i == 0, last=i == len(steps) - 1, **step, **kw)
        got = fr.fwd_step(qs, k, v, st_k, q_row0=q_row0, **flags)
        ref = fr.fwd_step(qs_p, k, v, st_p, backend="plain", q_row0=row0,
                          **flags)
        torch.cuda.synchronize()
        if got is None:
            got = _finish(torch, *st_k)
            ref = _finish(torch, *st_p)
        eo = max_err(got[0][:, :, rows], ref[0])
        ro = _rel_err(got[0][:, :, rows], ref[0])
        el = max_err(got[1][:, :, rows], ref[1])
        log(f"  {name}, forward step {i}: out err {eo:.3e}, of "
            f"max|plain| {ro:.3e} (tol {RING_OUT_REL_TOL}), max|lse| err "
            f"{el:.3e} (tol {B1_LSE_TOL})")
        if not (ro <= RING_OUT_REL_TOL and el <= B1_LSE_TOL):
            raise AssertionError(f"B7 disagrees with its plain version: "
                                 f"{name}, step {i}")
        worst["B7"] = [max(worst["B7"][0], eo), max(worst["B7"][1], ro)]
    out, lse = got
    # backward on the rows the plain version sees
    out_p, lse_p = out[:, :, rows].contiguous(), lse[:, :, rows]
    dout = rnd(b, hq, qs_p.shape[2], d)
    lse2 = (lse_p * fr.LOG2E).clamp(min=-0.5e30).contiguous()
    delta = bwd_delta(dout, out_p) * scale
    res = {}
    for tag, backend in (("kernel", None), ("again", None),
                         ("plain", "plain")):
        dq = torch.zeros(qs_p.shape, dtype=torch.float32, device=dev)
        dkv = torch.empty((2, b, hkv, skv, d), dtype=torch.float32,
                          device=dev)
        for i, (step, (k, v)) in enumerate(zip(steps, kvs)):
            fr.bwd_step(qs_p, k, fr._prescale(v, scale), dout, lse2,
                        delta, dq, dkv[0], dkv[1], backend=backend,
                        accumulate=i > 0, q_row0=row0, **step, **kw)
        res[tag] = (dq, dkv[0], dkv[1])
    torch.cuda.synchronize()
    rel = [_rel_err(x, r) for x, r in zip(res["kernel"], res["plain"])]
    if skv == 1 and len(steps) == 1:
        # every row sees one key: the softmax has no gradient. Where the
        # plain dq or dk is exactly 0, the kernel's is rounding noise, held
        # to ONE_KEY_NOISE_TOL of max|dv|; elsewhere to max|plain| itself
        dv_max = max(float(res["plain"][2].abs().max()), 1e-30)
        for i in (0, 1):
            plain_g = res["plain"][i]
            if float(plain_g.abs().max()) == 0.0:
                noise = max_err(res["kernel"][i], plain_g) / dv_max
                log(f"  {name}: one key a row, plain {'dq' if i == 0 else 'dk'}"
                    f" is 0; the kernel's {noise:.2e} of max|dv| (tol "
                    f"{ONE_KEY_NOISE_TOL})")
                if noise > ONE_KEY_NOISE_TOL:
                    raise AssertionError(f"B8's one-key noise is too large: "
                                         f"{name}")
                rel[i] = noise
    ab = max(max_err(x, r) for x, r in zip(res["kernel"], res["plain"]))
    same = [torch.equal(x, y)
            for x, y in zip(res["kernel"], res["again"])]
    log(f"  {name}, backward: rel err dq {rel[0]:.2e} dk {rel[1]:.2e} "
        f"dv {rel[2]:.2e} (tol {BWD_REL_TOL}); two runs bitwise equal "
        f"(dq, dk, dv) {same}")
    if max(rel) > BWD_REL_TOL:
        raise AssertionError(f"B8 disagrees with its plain version: "
                             f"{name}")
    if not (same[1] and same[2]):
        raise AssertionError(f"B8's dk/dv are not bitwise reproducible: "
                             f"{name}")
    worst["B8"] = [max(worst["B8"][0], ab), max(worst["B8"][1], max(rel))]


def phase_fused_ring(torch, flush):
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import bwd_delta
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    log("== phase 10: kernels B7, B8 (fused ring steps) vs their plain "
        "versions")
    check_hgmma("B7", "fused_ring_fwd", "flash_fwd_kernel")
    check_hgmma("B8", "fused_ring_bwd", "bwd_kv_kernel")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    worst = {"B7": [0.0, 0.0], "B8": [0.0, 0.0]}

    def run_case(*args, **kw):
        fused_ring_case(torch, rnd, worst, *args, **kw)

    diag = dict(diagonal=True, q_pos0=0, kv_pos0=0)

    def off(q_pos0, kv_pos0):
        return dict(diagonal=False, q_pos0=q_pos0, kv_pos0=kv_pos0)

    run_case("one diagonal step (W=1), ragged L=300", 1, 8, 2, 300, 300, 128,
             [diag])
    run_case("rank 2 of 3, L=320: diagonal then two earlier shards", 2, 8, 2,
             320, 320, 128,
             [dict(diag, q_pos0=640, kv_pos0=640), off(640, 320),
              off(640, 0)])
    run_case("the same with ALiBi on global positions", 1, 8, 2, 320, 320,
             128, [dict(diag, q_pos0=640, kv_pos0=640), off(640, 320),
                   off(640, 0)], alibi=True)
    run_case("softcap 20, ragged L=200", 1, 4, 4, 200, 200, 128,
             [diag, off(200, 0)], cap=20.0)
    run_case("non-causal, softcap and |ALiBi|, later shard first", 1, 8, 2,
             256, 256, 128, [off(256, 512), off(256, 256), off(256, 0)],
             causal=False, cap=25.0, alibi=True)
    run_case("D=64, group 1, non-causal", 2, 4, 4, 192, 192, 64,
             [off(0, 0), off(0, 192)], causal=False)
    run_case("D=64, group 4, q_row0=64, Sq=100 Skv=230", 1, 8, 2, 100, 230,
             64, [dict(diag, q_pos0=0, kv_pos0=0), off(460, 0)], alibi=True,
             q_row0=64)
    run_case("dead rows: q_row0=-5, then an earlier shard", 1, 8, 2, 100, 70,
             128, [diag, off(0, 0)], q_row0=-5)
    # the loop's tile edges: 128 keys a block, 64 q rows a step
    run_case("edge L=129, group 8, ALiBi", 1, 32, 4, 129, 129, 128,
             [dict(diag, q_pos0=129, kv_pos0=129), off(129, 0)], alibi=True)
    run_case("edge L=257, group 1, D=64, softcap 30", 1, 8, 8, 257, 257, 64,
             [dict(diag, q_pos0=257, kv_pos0=257), off(257, 0)], cap=30.0)
    run_case("edge L=127, group 8, D=64, non-causal", 1, 8, 1, 127, 127, 64,
             [off(127, 0), off(127, 127)], causal=False)
    run_case("edge Sq=65 Skv=255, group 4, softcap and ALiBi, q_row0=190", 1,
             8, 2, 65, 255, 128,
             [dict(diag, q_pos0=255, kv_pos0=255), off(255, 0)], cap=20.0,
             alibi=True, q_row0=190)
    # the forward loop's tile edges (B7_EDGE_CASES): every pair of the
    # first and last flags, with and without softcap/ALiBi (XFORM)
    for hq, hkv, sq, skv, d, causal, cap, alibi, n in B7_EDGE_CASES:
        run_case(f"fwd edge Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
                 f"causal={causal} softcap={cap} ALiBi={alibi}, {n} steps",
                 1, hq, hkv, sq, skv, d, ring_steps(n, skv, causal),
                 causal=causal, cap=cap, alibi=alibi)
    # the headline shape: a diagonal and an earlier shard, plain on the last
    # 512 q rows (its fp32 scores of all 8192 would take tens of GB)
    ll, hq, hkv, d = 8192, 32, 8, 128
    run_case("headline q (1,32,8192,128) kv (1,8,8192,128), last 512 rows",
             1, hq, hkv, ll, ll, d,
             [dict(diag, q_pos0=ll, kv_pos0=ll), off(ll, 0)], q_slice=512)
    torch.cuda.empty_cache()

    # timing at the headline shape: an off-diagonal step that reads and
    # writes the state, and the diagonal step that starts it
    scale = d ** -0.5
    q, k, v, dout = (rnd(1, hq, ll, d), rnd(1, hkv, ll, d), rnd(1, hkv, ll, d),
                     rnd(1, hq, ll, d))
    qs, vsc = fr._prescale(q, scale * fr.LOG2E), fr._prescale(v, scale)
    state = fr.new_state(qs)
    fr.fwd_step(qs, k, v, state, diagonal=True, first=True, last=False)
    out, lse = fr.fwd_step(qs, k, v, state, diagonal=False, first=False,
                           last=True)
    lse2 = (lse * fr.LOG2E).contiguous()
    delta = bwd_delta(dout, out) * scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dkv = torch.zeros((2, 1, hkv, ll, d), dtype=torch.float32, device=dev)

    def fwd(diagonal, backend=None):
        return fr.fwd_step(qs, k, v, state, backend=backend,
                           diagonal=diagonal, first=diagonal, last=False)

    def bwd(diagonal, backend=None):
        return fr.bwd_step(qs, k, vsc, dout, lse2, delta, dq, dkv[0], dkv[1],
                           backend=backend, diagonal=diagonal,
                           accumulate=not diagonal)

    t7 = kernel_ms(torch, lambda: fwd(False), 10, flush)
    t7d = kernel_ms(torch, lambda: fwd(True), 10, flush)
    t8 = kernel_ms(torch, lambda: bwd(False), 5, flush)
    t8d = kernel_ms(torch, lambda: bwd(True), 5, flush)
    plain7 = cuda_ms(torch, lambda: fwd(False, "plain"), 1, flush)
    torch.cuda.empty_cache()
    plain8 = cuda_ms(torch, lambda: bwd(False, "plain"), 1, flush)
    torch.cuda.empty_cache()
    qr = q.detach().requires_grad_()
    kr = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    vr = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    lib7 = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kr.detach(), vr.detach()), 10, flush)
    o = F.scaled_dot_product_attention(qr, kr, vr)
    lib8 = cuda_ms(torch, lambda: torch.autograd.grad(
        o, (qr, kr, vr), dout, retain_graph=True), 5, flush)
    del o, qr, kr, vr

    n_q, n_kv, rows = q.numel(), k.numel(), hq * ll
    per_product = 2 * hq * d * ll * ll
    # q, k, v and the state (m, l, acc fp32) in; the state out
    b7 = (2 * per_product, 2 * (n_q + 2 * n_kv) + 2 * 4 * (n_q + 2 * rows))
    # q, k, v, dout, lse2, delta and the fp32 dq, dk, dv in; dq, dk, dv out
    b8 = (5 * per_product, 2 * (2 * n_q + 2 * n_kv) + 2 * 4 * rows
          + 2 * 4 * (n_q + 2 * n_kv))
    bound7, bound8 = (max(f / H100_BF16_FLOPS, nb / H100_BYTES_PER_S) * 1e3
                      for f, nb in (b7, b8))
    log(f"  headline step, bf16: B7 off-diagonal {t7['ms']:.3f} ms "
        f"({b7[0] / t7['ms'] / 1e9:.1f} TFLOP/s; device "
        f"{t7['device_ms']:.3f}), diagonal {t7d['ms']:.3f} ms (device "
        f"{t7d['device_ms']:.3f}), plain {plain7:.3f} ms, SDPA forward "
        f"{lib7:.3f} ms, bound {bound7:.3f} ms; B8 off-diagonal "
        f"{t8['ms']:.3f} ms ({b8[0] / t8['ms'] / 1e9:.1f} TFLOP/s, "
        f"{t8['ms'] / lib8:.2f}x SDPA's backward; device "
        f"{t8['device_ms']:.3f}), diagonal {t8d['ms']:.3f} ms (device "
        f"{t8d['device_ms']:.3f}), plain {plain8:.3f} ms, SDPA backward "
        f"{lib8:.3f} ms, bound {bound8:.3f} ms (operations bound both; a "
        f"diagonal step is half the operations)")
    shape = ("one off-diagonal ring step, q (1,32,8192,128) kv "
             "(1,8,8192,128) bf16, state read and written")
    common = {"route": "cuda", "shape": shape, "bound_by": "operations"}
    return [
        dict(common, name="B7 fused_ring_fwd",
             source="ring_flash_attn_tpu_torch/csrc/fused_ring_fwd.cu",
             replaces="ring_flash_attn_tpu/parallel/fused_ring.py:74",
             max_abs_err=worst["B7"][0], max_rel_err=worst["B7"][1], **t7,
             diagonal=t7d, plain_ms=plain7,
             bound_ms=bound7, library_ms=lib7,
             library="F.scaled_dot_product_attention, not causal, kv "
                     "repeated to 32 heads"),
        dict(common, name="B8 fused_ring_bwd",
             source="ring_flash_attn_tpu_torch/csrc/fused_ring_bwd.cu",
             replaces="ring_flash_attn_tpu/parallel/fused_ring.py:474",
             max_abs_err=worst["B8"][0], max_rel_err=worst["B8"][1], **t8,
             diagonal=t8d, plain_ms=plain8, bound_ms=bound8,
             library_ms=lib8, tflops=b8[0] / t8["ms"] / 1e9,
             library="F.scaled_dot_product_attention backward, not causal, "
                     "kv repeated to 32 heads"),
    ]


def _rank_fwd(qs, ks, vs, rank, scale, step_mask):
    """Rank ``rank``'s forward of a ring-loop schedule (``ring.ring_loop_fwd``
    without the hop): at step t the kv shard of rank (rank - t) % W under
    ``step_mask(t, rank, W)`` (None: skipped), merged. (out bf16, lse)."""
    from ring_flash_attn_tpu_torch.ops.flash import block_fwd
    from ring_flash_attn_tpu_torch.ops.merge import merge_partials

    world = len(qs)
    out = lse = None
    for step in range(world):
        src = (rank - step) % world
        mask = step_mask(step, rank, world)
        if mask is not None:
            b_out, b_lse = block_fwd(qs[rank], ks[src], vs[src], scale, mask)
            out, lse = merge_partials(out, lse, b_out, b_lse)
    return out.to(qs[rank].dtype), lse


def _rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, rank, scale, step_mask):
    """Rank ``rank``'s backward of a ring-loop schedule
    (``ring.ring_loop_bwd`` without the hop): returns its dq (fp32) and
    adds its dk, dv of kv shard src into ``dkvs[src]``, the accumulator
    that visits it on the ring."""
    from ring_flash_attn_tpu_torch.ops.flash import block_bwd, compute_delta

    world = len(qs)
    delta = compute_delta(douts[rank], outs[rank])
    dq = None
    for step in range(world):
        src = (rank - step) % world
        mask = step_mask(step, rank, world)
        if mask is not None:
            b_dq, b_dk, b_dv = block_bwd(douts[rank], qs[rank], ks[src],
                                         vs[src], lses[rank], delta, scale,
                                         mask)
            dq = b_dq if dq is None else dq.add_(b_dq)
            dkvs[src][0].add_(b_dk)
            dkvs[src][1].add_(b_dv)
    return dq


def _events_ms(torch, fn, reps):
    """ms a call of fn(), back to back without flushing the L2:
    ``utils.timing.timed``'s slope between chains of 1 and 1 + ``reps``
    calls, between CUDA events."""
    from ring_flash_attn_tpu_torch.utils.timing import timed

    def step(x):
        fn()
        return x

    return timed(step, torch.empty(1, device="cuda"), n=reps, n0=1) * 1e3


def phase_ring_one_device(torch):
    from ring_flash_attn_tpu_torch.ops.flash import (
        block_bwd, block_fwd, compute_delta)
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.parallel.ring import _ring_masks

    log("== phase 11: the W-rank fused ring on one card vs the "
        "whole-sequence kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    hq, hkv, d, ll, tail = 32, 8, 128, 8192, 512
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    for world in (4, 1):
        s = world * ll
        q, k, v, dout = (rnd(1, hq, s, d), rnd(1, hkv, s, d),
                         rnd(1, hkv, s, d), rnd(1, hq, s, d))
        for causal in (True, False):
            name = f"W={world} S={s} {'causal' if causal else 'non-causal'}"
            mask = MaskArgs(causal=causal)
            out, lse = ring_forward_one_device(q, k, v, world, scale, causal)
            if causal:
                out_causal = out
            ref_out, ref_lse = block_fwd(q, k, v, scale, mask, out_dtype=bf16)
            # the plain version on the last rows of the last rank
            row_mask = MaskArgs(causal=causal, offset=s - tail)
            p_out, p_lse = naive_block_fwd(q[:, :, -tail:], k, v, scale,
                                           row_mask)
            torch.cuda.synchronize()
            eo, el = max_err(out, ref_out), max_err(lse, ref_lse)
            po = max_err(out[:, :, -tail:], p_out)
            pl = max_err(lse[:, :, -tail:], p_lse)
            # out relative to max|ref|, a quarter of the sequence at a time
            ro = _rel_err_parts(out, ref_out, 4)
            rp = _rel_err(out[:, :, -tail:], p_out)
            log(f"  {name} forward: vs B1 on the whole sequence out err "
                f"{eo:.3e}, of max|B1| by quarters {ro:.3e}, max|lse| err "
                f"{el:.3e}; vs plain on the last {tail} rows out err "
                f"{po:.3e}, of max|plain| {rp:.3e}, lse {pl:.3e} (tol "
                f"{RING_OUT_REL_TOL} relative, lse {RING_LSE_TOL})")
            if not (max(ro, rp) <= RING_OUT_REL_TOL
                    and max(el, pl) <= RING_LSE_TOL):
                raise AssertionError(f"the fused ring's forward is wrong: "
                                     f"{name}")
            got = ring_backward_one_device(q, k, v, dout, out, lse, world,
                                           scale, causal)
            ref = block_bwd(dout, q, k, v, lse, None, scale, mask, out=out)
            delta = compute_delta(dout, out)
            p_dq = naive_block_bwd(dout[:, :, -tail:], q[:, :, -tail:], k, v,
                                   lse[:, :, -tail:], delta[:, :, -tail:],
                                   scale, row_mask)[0]
            # dk, dv of the first keys (every rank's q rows reach them, so
            # their accumulator is added to at every hop) from the plain
            # version over all q rows
            keys = slice(0, tail)
            _, p_dk, p_dv = naive_block_bwd(
                dout, q, k[:, :, keys], v[:, :, keys], lse, delta, scale,
                mask)
            torch.cuda.synchronize()
            rel = [_rel_err(x, r) for x, r in zip(got, ref)]
            prel = [_rel_err(got[0][:, :, -tail:], p_dq),
                    _rel_err(got[1][:, :, keys], p_dk),
                    _rel_err(got[2][:, :, keys], p_dv)]
            log(f"  {name} backward: vs B2/B3 on the whole sequence rel err "
                f"dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e}; vs plain: "
                f"dq of the last {tail} rows {prel[0]:.2e}, dk and dv of "
                f"the first {tail} keys over all q rows {prel[1]:.2e} "
                f"{prel[2]:.2e} (tol {BWD_REL_TOL})")
            if max(*rel, *prel) > BWD_REL_TOL:
                raise AssertionError(f"the fused ring's backward is wrong: "
                                     f"{name}")
            del p_dk, p_dv
            del got, ref, ref_out, p_out, p_dq
        if world == 4:
            # what carrying the state saves: the same causal ring through
            # ring_attention's step calls, B1 and merge_partials
            def schedule_ring():
                qr, kr, vr = (x.chunk(world, dim=2) for x in (q, k, v))
                step_mask = _ring_masks(True, ll, {})
                return [_rank_fwd(qr, kr, vr, rank, scale, step_mask)[0]
                        for rank in range(world)]

            def fused_ring():
                return ring_forward_one_device(q, k, v, world, scale, True)

            times = {name: _events_ms(torch, fn, 3) for name, fn in (
                ("fused", fused_ring), ("schedule", schedule_ring),
                ("fused again", fused_ring),
                ("schedule again", schedule_ring))}
            eo = _rel_err_parts(out_causal,
                                torch.cat(schedule_ring(), dim=2), world)
            log(f"  W=4 causal forward of all 4 ranks (10 computing steps): "
                f"fused steps (B7) {times['fused']:.3f} and "
                f"{times['fused again']:.3f} ms; B1 + merge_partials "
                f"{times['schedule']:.3f} and {times['schedule again']:.3f} "
                f"ms; out differs by {eo:.3e} of a rank's max|out| (tol "
                f"{RING_OUT_REL_TOL})")
            if eo > RING_OUT_REL_TOL:
                raise AssertionError("the schedule-level and fused rings "
                                     "disagree")
            compare = dict(times)
        del q, k, v, dout, out_causal
        torch.cuda.empty_cache()
    return compare


def _entries_vs_flash(torch, gen, plan):
    """Registry entries through ``RingAttentionLayer`` on (1, 8192, 32,
    128) bf16, forward and backward, against the "flash" entry (B1 and B2,
    held against plain in phases 2 and 5). ``plan``: ((causal, impls),
    ...)."""
    from ring_flash_attn_tpu_torch import RingAttentionLayer

    s, hq, hkv, d = 8192, 32, 8, 128
    dev = torch.device("cuda")

    def rnd(h):
        return torch.randn((1, s, h, d), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()

    q, k, v = rnd(hq), rnd(hkv), rnd(hkv)
    dout = rnd(hq).detach()

    def run(impl, causal):
        out = RingAttentionLayer(impl, causal=causal)(q, k, v)
        return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))

    for causal, impls in plan:
        ref = run("flash", causal)
        for impl in impls:
            got = run(impl, causal)
            torch.cuda.synchronize()
            eo = _rel_err_parts(got[0], ref[0], 4, dim=1)
            rel = [_rel_err(x, r) for x, r in zip(got[1:], ref[1:])]
            log(f"  RingAttentionLayer({impl!r}, causal={causal}) on "
                f"(1,{s},{hq},{d}): |out - flash| of max|flash| by quarters "
                f"{eo:.3e} (tol {RING_OUT_REL_TOL}); gradients rel err dq "
                f"{rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e} (tol "
                f"{BWD_REL_TOL})")
            if not (eo <= RING_OUT_REL_TOL and max(rel) <= BWD_REL_TOL
                    and got[0].shape == q.shape
                    and got[0].dtype == torch.bfloat16):
                raise AssertionError(f"registry entry {impl!r} is wrong")
            del got
        del ref
    del q, k, v, dout
    torch.cuda.empty_cache()


def _train_two_steps(torch, attention, batch, flash_losses, **groups):
    """Two ``train_step``s at FULL_WIDTH over process groups of one
    process (``groups``): their losses must equal the single-device flash
    path's on the same batch (phase 6)."""
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, train_step)

    cfg = ModelConfig(**FULL_WIDTH, attention=attention)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    losses = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = train_step(model, *batch, **groups)
        losses.append(float(loss))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    diffs = [abs(a - b) for a, b in zip(losses, flash_losses)]
    named = ", ".join(f"{g}=None" for g in groups)
    log(f"  train_step(attention={attention!r}, {named}) S=8192: "
        f"losses {losses}, flash path {flash_losses[:2]} (max |diff| "
        f"{max(diffs):.2e}, tol {LOSS_TOL}); second step {dt:.3f} s")
    if not (max(diffs) <= LOSS_TOL and all(np.isfinite(losses))):
        raise AssertionError(f"train_step over the {attention} schedule "
                             f"left the flash path's losses")
    del model
    torch.cuda.empty_cache()


def phase_ring_entry_points(torch, flash_losses):
    from ring_flash_attn_tpu_torch.models import prepare_zigzag_batch
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.parallel.fused_ring_cuda import (
        fused_ring_bwd_cuda, fused_ring_fwd_cuda)

    log("== phase 12: the ring entry points at W=1 (no process group) at "
        "Llama-3-8B widths")
    gen = torch.Generator(device="cuda").manual_seed(12)
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B7 fused_ring_fwd": fused_ring_fwd_cuda,
                "B8 fused_ring_bwd": fused_ring_bwd_cuda}
    for fn in counters.values():
        fn.launches = 0

    _entries_vs_flash(torch, gen, ((True, ("fused_ring", "ring", "zigzag")),
                                   (False, ("fused_ring",))))
    # train_step over a sequence group of one process: the same losses as
    # the single-device flash path took on the same batch (phase 6)
    batch = _train_batch(torch, FULL_WIDTH["vocab"], 8192, 2)
    _train_two_steps(torch, "ring", batch, flash_losses, sp_group=None)
    _train_two_steps(torch, "zigzag", prepare_zigzag_batch(batch[0], 1),
                     flash_losses, sp_group=None)

    launches = {name: fn.launches for name, fn in counters.items()}
    layers = FULL_WIDTH["layers"]
    # flash x 2, ring, zigzag through B1/B2 and fused_ring x 2 through
    # B7/B8 (one step each at W=1); 2 schedules x 2 steps x layers
    want = {"B1 flash_fwd": 4 + 4 * layers, "B2 flash_bwd": 4 + 4 * layers,
            "B7 fused_ring_fwd": 2, "B8 fused_ring_bwd": 2}
    log(f"  launches over this phase: {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches


def phase_stripe_ulysses(torch, flash_losses):
    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.ops.flash import block_bwd, block_fwd
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.parallel import layouts, ring, stripe

    log("== phase 13: stripe and Ulysses: the W=4 stripe schedule on one "
        "card vs the whole-sequence kernels, and the entry points at W=1")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    bf16 = torch.bfloat16
    world, hq, hkv, d, ll, tail = 4, 32, 8, 128, 8192, 512
    s = world * ll
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v, dout = (rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d),
                     rnd(1, hq, s, d))
    # (a) every rank's stripe steps in one process, as _stripe_fwd and
    # _stripe_bwd run them: the masks of stripe._step_masks (offset -1 on
    # the steps after the rank), B1 + merge_partials, B2
    schedules = {"stripe": (layouts.extract_local_stripe,
                            layouts.restore_stripe,
                            stripe._step_masks(dict(softcap=None))),
                 "ring": (layouts.extract_local_contiguous, None,
                          ring._ring_masks(True, ll, {}))}

    def shards(name):
        extract = schedules[name][0]
        return [[extract(x, r, world, axis=2).contiguous()
                 for r in range(world)] for x in (q, k, v, dout)]

    qs, ks, vs, douts = shards("stripe")
    step_mask = schedules["stripe"][2]
    res = [_rank_fwd(qs, ks, vs, r, scale, step_mask) for r in range(world)]
    outs, lses = [o for o, _ in res], [x for _, x in res]

    def restore(parts):
        return layouts.restore_stripe(torch.cat(parts, dim=2), world, axis=2)

    out, lse = restore(outs), restore(lses)
    mask = MaskArgs(causal=True)
    ref_out, ref_lse = block_fwd(q, k, v, scale, mask, out_dtype=bf16)
    row_mask = MaskArgs(causal=True, offset=s - tail)
    p_out, p_lse = naive_block_fwd(q[:, :, -tail:], k, v, scale, row_mask)
    torch.cuda.synchronize()
    ro, el = _rel_err_parts(out, ref_out, 4), max_err(lse, ref_lse)
    rp = _rel_err(out[:, :, -tail:], p_out)
    pl = max_err(lse[:, :, -tail:], p_lse)
    log(f"  stripe W={world} S={s} causal forward: vs B1 on the whole "
        f"sequence |out| err of max|B1| by quarters {ro:.3e}, max|lse| err "
        f"{el:.3e}; vs plain on the last {tail} rows |out| err of "
        f"max|plain| {rp:.3e}, lse {pl:.3e} (tol {RING_OUT_REL_TOL} "
        f"relative, lse {RING_LSE_TOL})")
    if not (max(ro, rp) <= RING_OUT_REL_TOL
            and max(el, pl) <= RING_LSE_TOL):
        raise AssertionError("the stripe schedule's forward is wrong")
    del ref_out, ref_lse, p_out, p_lse
    dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                        device=dev) for x in ks]
    dqs = [_rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                     step_mask) for r in range(world)]
    got = (restore(dqs), restore([a[0] for a in dkvs]),
           restore([a[1] for a in dkvs]))
    ref = block_bwd(dout, q, k, v, lse, None, scale, mask, out=out)
    delta = (dout.float() * out.float()).sum(-1)
    p_dq = naive_block_bwd(dout[:, :, -tail:], q[:, :, -tail:], k, v,
                           lse[:, :, -tail:], delta[:, :, -tail:], scale,
                           row_mask)[0]
    keys = slice(0, tail)
    _, p_dk, p_dv = naive_block_bwd(dout, q, k[:, :, keys], v[:, :, keys],
                                    lse, delta, scale, mask)
    torch.cuda.synchronize()
    rel = [_rel_err(x, r) for x, r in zip(got, ref)]
    prel = [_rel_err(got[0][:, :, -tail:], p_dq),
            _rel_err(got[1][:, :, keys], p_dk),
            _rel_err(got[2][:, :, keys], p_dv)]
    log(f"  stripe W={world} S={s} causal backward: vs B2 on the whole "
        f"sequence rel err dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e}; "
        f"vs plain: dq of the last {tail} rows {prel[0]:.2e}, dk and dv of "
        f"the first {tail} keys over all q rows {prel[1]:.2e} {prel[2]:.2e} "
        f"(tol {BWD_REL_TOL})")
    if max(*rel, *prel) > BWD_REL_TOL:
        raise AssertionError("the stripe schedule's backward is wrong")
    del got, ref, delta, p_dq, p_dk, p_dv, dqs, out, lse
    torch.cuda.empty_cache()

    # each rank's time between CUDA events (10 forward, 5 backward calls),
    # stripe and ring on the same tensors in turns (stripe, ring, ring,
    # stripe): on W cards the slowest rank is the critical path
    times = {}
    for turn, name in enumerate(("stripe", "ring", "ring", "stripe")):
        qs, ks, vs, douts = shards(name)
        step_mask = schedules[name][2]
        res = [_rank_fwd(qs, ks, vs, r, scale, step_mask)
               for r in range(world)]
        outs, lses = [o for o, _ in res], [x for _, x in res]
        dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                            device=dev) for x in ks]
        fwd = [_events_ms(torch, lambda r=r: _rank_fwd(
            qs, ks, vs, r, scale, step_mask), 10) for r in range(world)]
        bwd = [_events_ms(torch, lambda r=r: _rank_bwd(
            qs, ks, vs, douts, outs, lses, dkvs, r, scale, step_mask), 5)
            for r in range(world)]
        times.setdefault(name, []).append({"fwd_ms": fwd, "bwd_ms": bwd})
        log(f"  {name} W={world} S={s} causal, per rank (ranks 0 to "
            f"{world - 1}): forward "
            + " ".join(f"{t:.3f}" for t in fwd) + " ms, backward "
            + " ".join(f"{t:.3f}" for t in bwd) + f" ms; largest {max(fwd):.3f}"
            f" and {max(bwd):.3f} ms")
        del qs, ks, vs, douts, res, outs, lses, dkvs
        torch.cuda.empty_cache()
    worst = {name: [(max(t["fwd_ms"]), max(t["bwd_ms"])) for t in turns]
             for name, turns in times.items()}
    log(f"  largest rank (forward, backward) ms: stripe {worst['stripe']}, "
        f"ring {worst['ring']}")
    del q, k, v, dout
    torch.cuda.empty_cache()

    # (b) the entry points at W=1, each kernel's launches counted from 0
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}
    for fn in counters.values():
        fn.launches = 0
    _entries_vs_flash(torch, gen, ((True, ("stripe", "ulysses")),
                                   (False, ("ulysses",))))
    # stripe_flash_attn_* with deterministic=True: the split kernels, the
    # same bits call after call
    ql, hl = 8192, (hq, hkv, hkv)
    qb, kb, vb = (rnd(1, ql, h, d) for h in hl)
    qkv = rnd(1, ql, 3, hq, d)
    forms = {"func": (api.stripe_flash_attn_func, (qb, kb, vb)),
             "kvpacked_func": (api.stripe_flash_attn_kvpacked_func,
                               (qb, torch.stack([kb, vb], dim=2))),
             "qkvpacked_func": (api.stripe_flash_attn_qkvpacked_func,
                                (qkv,))}
    for form, (func, args) in forms.items():
        g_out = torch.randn(qb.shape, generator=gen, device=dev).to(bf16)
        if form == "qkvpacked_func":
            ref = api.flash_attn_func(*qkv.unbind(2), causal=True)
        else:
            ref = api.flash_attn_func(qb, kb, vb, causal=True)
        grads = []
        for _ in range(2):
            leaves = [x.clone().requires_grad_() for x in args]
            o = func(*leaves, causal=True, deterministic=True)
            grads.append(torch.autograd.grad(o, leaves, g_out))
        torch.cuda.synchronize()
        eo = _rel_err_parts(o.detach(), ref, 4, dim=1)
        same = all(torch.equal(a, b) for a, b in zip(*grads))
        log(f"  stripe_flash_attn_{form}(deterministic=True) on "
            f"{tuple(args[0].shape)}: |out - flash| of max|flash| by "
            f"quarters {eo:.3e} (tol {RING_OUT_REL_TOL}); gradients of two "
            f"calls bitwise equal: {same}")
        if not (eo <= RING_OUT_REL_TOL and same):
            raise AssertionError(f"stripe_flash_attn_{form} is wrong or not "
                                 f"reproducible")
        del grads, ref, o
    del qb, kb, vb, qkv
    torch.cuda.empty_cache()
    batch = _train_batch(torch, FULL_WIDTH["vocab"], 8192, 2)
    stripe_batch = (layouts.all_local_stripe(batch[0], 1),
                    layouts.all_local_stripe(batch[1], 1),
                    torch.as_tensor(layouts.stripe_position_ids(0, 1, 8192),
                                    device=dev).long())
    _train_two_steps(torch, "stripe", stripe_batch, flash_losses,
                     sp_group=None)
    _train_two_steps(torch, "usp", batch, flash_losses, sp_group=None,
                     ulysses_group=None)

    launches = {name: fn.launches for name, fn in counters.items()}
    layers = FULL_WIDTH["layers"]
    # entries: flash x 2, stripe, ulysses x 2 (B1 and B2 each); the three
    # deterministic forms: the flash reference and 2 calls (B1, B3a, B3b)
    # each; train_step: 2 schedules x 2 steps x layers (B1 and B2)
    want = {"B1 flash_fwd": 5 + 9 + 4 * layers, "B2 flash_bwd": 5 + 4 * layers,
            "B3a flash_bwd_dq": 6, "B3b flash_bwd_dkv": 6}
    log(f"  launches over the entry points: {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches, times


# Mixtral-8x7B's published widths (vocab 32000, dim 4096, 32/8 heads of
# 128, mlp 14336, 8 experts, rope_theta 1e6), with the JAX package's switch
# (top-1) routing where Mixtral routes top-2; cut to 2 layers
MIXTRAL = dict(vocab=32000, dim=4096, layers=2, heads=32, kv_heads=8,
               head_dim=128, mlp_dim=14336, rope_theta=1e6, dtype="bfloat16",
               moe_experts=8, moe_capacity_factor=2.0, moe_aux_weight=0.01)
# TP simulated in one process: |sum of the ranks' partials - unsharded| /
# |unsharded| (L2), bf16 partial products summed in fp32
TP_REL_TOL = 1e-2


@contextlib.contextmanager
def moe_routes(force=None):
    """Record every ``moe_mlp`` call's expert choice ((T,) each, in call
    order) in ``seen["experts"]``. With ``force`` (such a list), route the
    calls by it instead and keep in ``seen["flips"]`` the number of tokens
    whose own choice differed, a (1,) tensor a call: a kernel run and its
    plain reference then compute the same function even where a token near
    an argmax tie would flip."""
    from ring_flash_attn_tpu_torch.models import moe

    real, seen = moe.route, {"experts": [], "flips": []}

    def recorder(xn, router):
        probs, expert = real(xn, router)
        if force is not None:
            forced = force[len(seen["experts"])]
            seen["flips"].append((forced != expert).sum().reshape(1))
            expert = forced
        seen["experts"].append(expert)
        return probs, expert

    moe.route = recorder
    try:
        yield seen
    finally:
        moe.route = real


def _grad_errs(names, got, ref):
    """[(||got - ref|| / ||ref||, name)], worst first."""
    return sorted(((float((a.float() - b.float()).norm()
                          / b.float().norm().clamp_min(1e-30)), n)
                   for n, a, b in zip(names, got, ref)), reverse=True)


_TP_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _tp_layer(torch, gen):
    """One Llama-3-8B-width layer, its input x, dout and positions at
    S=4096."""
    from ring_flash_attn_tpu_torch.models import ModelConfig, init_params

    cfg = ModelConfig(**dict(FULL_WIDTH, layers=1))
    full = init_params(cfg, gen)
    s = 4096
    x = (torch.randn((1, s, cfg.dim), generator=gen, device="cuda")
         .to(torch.bfloat16).requires_grad_())
    dout = torch.randn((1, s, cfg.dim), generator=gen, device="cuda")
    return cfg, full, x, dout, torch.arange(s, device="cuda")


def _tp_branches(torch, layer_args, tp, backend=None):
    """The layer's attention and MLP branches as tp ranks compute them:
    every rank's branch on its ``shard_params`` shard in this process with
    no group, the partials summed here (what the group's psum does); tp=1
    is the unsharded layer. Returns (out, dx, {weight: [each rank's
    gradient]})."""
    from ring_flash_attn_tpu_torch.models import shard_params
    from ring_flash_attn_tpu_torch.models.transformer import (
        _attn_branch, _mlp_branch)

    cfg, full, x, dout, pos = layer_args
    layers = [(full if tp == 1 else shard_params(
        full, cfg, tp_rank=r, tp=tp)).layers[0] for r in range(tp)]
    a = sum(_attn_branch(cfg, x, ly, pos, backend).float() for ly in layers)
    h = (x.float() + a).to(torch.bfloat16)
    out = h.float() + sum(_mlp_branch(h, ly).float() for ly in layers)
    leaves = [getattr(ly, n) for n in _TP_WEIGHTS for ly in layers]
    grads = torch.autograd.grad(out, [x, *leaves], dout)
    shards = {n: list(grads[1 + i * tp:1 + (i + 1) * tp])
              for i, n in enumerate(_TP_WEIGHTS)}
    return out.detach(), grads[0], shards


def phase_moe_tp(torch):
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, loss_fn, train_step)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda

    log("== phase 14: MoE training at Mixtral-8x7B widths (2 layers, top-1) "
        "and tensor parallelism simulated in one process")
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda}
    cfg = ModelConfig(**MIXTRAL)
    e = cfg.moe_experts
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(14))
    named = list(model.named_parameters())
    names, params = [n for n, _ in named], [p for _, p in named]
    log(f"  {sum(p.numel() for p in params) / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (a) kernels against plain at S=1024, the plain run routed as the
    # kernels' run was
    batch = _train_batch(torch, cfg.vocab, 1024, 14)
    with moe_routes() as routes_k:
        loss = loss_fn(model, *batch)
        gk = torch.autograd.grad(loss, params)
        lk = float(loss.detach())
    with moe_routes(force=routes_k["experts"]) as routes_p:
        loss = loss_fn(model, *batch, backend="plain")
        gp = torch.autograd.grad(loss, params)
        lp = float(loss.detach())
    flips = [int(f) for f in torch.cat(routes_p["flips"])]
    errs = _grad_errs(names, gk, gp)
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    log(f"  S=1024 loss: kernels {lk:.6f}, plain {lp:.6f} (|diff| "
        f"{abs(lk - lp):.2e}, tol {LOSS_TOL}); routes the plain run would "
        f"have chosen differently, per layer: {flips} of 1024; gradient "
        f"||k - p|| / ||p||, worst 3 of {len(errs)}: "
        + ", ".join(f"{n} {x:.2e}" for x, n in errs[:3])
        + f" (tol {GRAD_REL_TOL}); finite {finite}")
    if not (abs(lk - lp) <= LOSS_TOL and errs[0][0] <= GRAD_REL_TOL
            and finite):
        raise AssertionError("MoE training gradients disagree with the "
                             "plain versions")
    del gk, gp, loss, routes_k, routes_p
    torch.cuda.empty_cache()

    # (b) the main path: 3 steps at S=4096, counts from 0
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    s = 4096
    cap = max(1, int(s / e * cfg.moe_capacity_factor))
    batch = _train_batch(torch, cfg.vocab, s, 15)
    with moe_routes() as routes:
        steps = [_timed_step(torch, model, batch) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: fn.launches for name, fn in counters.items()}
    drops = [float((torch.bincount(x, minlength=e) - cap).clamp(min=0).sum())
             / s for x in routes["experts"]]
    for i, (loss, dt) in enumerate(steps):
        log(f"  S={s} step {i}: loss {loss:.6f}, {dt:.3f} s, {s / dt:.0f} "
            f"tokens/s; dropped share per layer "
            + ", ".join(f"{x:.4f}" for x in drops[i * cfg.layers:
                                                   (i + 1) * cfg.layers])
            + f" (capacity {cap} a expert)")
    log(f"  S={s} peak memory {peak:.2f} GiB; launches over the 3 steps: "
        f"{launches}")
    want = {name: 3 * cfg.layers for name in counters}
    if not all(np.isfinite(loss) for loss, _ in steps) or launches != want:
        raise AssertionError(f"MoE steps: losses {steps}, launches "
                             f"{launches}, expected {want}")

    # (c) where the time of one step goes
    torch.cuda.empty_cache()
    wall = min(dt for _, dt in steps[1:])
    dev = _device_profile(torch, lambda: train_step(model, *batch))
    busy_us = sum(t for t, _, _ in dev)
    groups = {
        "fp32 expert GEMMs": ("sgemm", "f32f32", "simt", "nvjet_sss"),
        "bf16 GEMMs": ("nvjet", "gemm", "cutlass", "xmma"),
        "attention kernels (B1, B2)": ("rfa_bwd::", "flash_fwd_kernel"),
        "dispatch/combine and embedding (index, gather, scatter)": (
            "index", "gather", "scatter"),
    }
    other = "other (elementwise, casts, reductions)"
    split = {g: 0.0 for g in (*groups, other)}
    for t, key, _ in dev:
        g = next((g for g, pre in groups.items()
                  if any(p in key for p in pre)), other)
        split[g] += t
    log(f"  profiled S={s} step: device busy {busy_us / 1e3:.3f} ms of the "
        f"unprofiled {wall * 1e3:.3f} ms step "
        f"({100 * busy_us / 1e3 / wall / 1e3:.1f}% busy)")
    log("  by kind: " + "; ".join(f"{g} {t / 1e3:.3f} ms "
                                  f"({100 * t / busy_us:.1f}%)"
                                  for g, t in split.items()))
    log("  top 10 kernels by device time:")
    for t, key, count in dev[:10]:
        log(f"    {100 * t / busy_us:5.1f}%  {t / 1e3:9.3f} ms  x{count:<4d} "
            f"{key[:90]}")
    del model, params, named, batch, routes
    torch.cuda.empty_cache()

    # (d) tensor parallelism simulated in one process: the unsharded layer
    # on the kernels, then each tp on the plain versions and on the
    # kernels, counts from 0 for the kernels' TP runs only
    from ring_flash_attn_tpu_torch.models import param_specs

    layer_args = _tp_layer(torch,
                           torch.Generator(device="cuda").manual_seed(16))
    cfg = layer_args[0]
    dims = {n: param_specs(cfg)[f"layers.0.{n}"][1] for n in _TP_WEIGHTS}
    ref_out, ref_dx, ref_w = _tp_branches(torch, layer_args, 1)
    ref_w = {n: g[0] for n, g in ref_w.items()}
    plain = {tp: _tp_branches(torch, layer_args, tp, "plain")
             for tp in (2, 4)}
    for fn in counters.values():
        fn.launches = 0
    got = {tp: _tp_branches(torch, layer_args, tp) for tp in (2, 4)}
    tp_counts = {name: fn.launches for name, fn in counters.items()}
    for tp in (2, 4):
        out, dx, shards = got[tp]
        whole = {n: torch.cat(g, dim=dims[n]) for n, g in shards.items()}
        errs = _grad_errs(["out", "dx", *whole],
                          [out, dx, *whole.values()],
                          [ref_out, ref_dx, *(ref_w[n] for n in whole)])
        p_out, p_dx, p_shards = plain[tp]
        perrs = _grad_errs(
            ["out", "dx", *(f"{n}[{r}]" for n in shards for r in range(tp))],
            [out, dx, *(g for n in shards for g in shards[n])],
            [p_out, p_dx, *(g for n in shards for g in p_shards[n])])
        log(f"  TP={tp} in one process (Llama-3-8B widths, S=4096, "
            f"{32 // tp}/{8 // tp} heads a rank): sum of the ranks' branches "
            f"vs the unsharded layer, ||err|| / ||ref||: "
            + ", ".join(f"{n} {x:.2e}" for x, n in errs)
            + f" (tol {TP_REL_TOL}); vs the same ranks on the plain "
            f"versions, out, dx and each rank's weight gradients, worst 3 of "
            f"{len(perrs)}: " + ", ".join(f"{n} {x:.2e}" for x, n in perrs[:3])
            + f" (tol {GRAD_REL_TOL})")
        if errs[0][0] > TP_REL_TOL:
            raise AssertionError(f"TP={tp}: the ranks' partials disagree "
                                 f"with the unsharded layer")
        if perrs[0][0] > GRAD_REL_TOL:
            raise AssertionError(f"TP={tp}: the kernels disagree with the "
                                 f"plain versions at {32 // tp}/{8 // tp} "
                                 f"heads")
    log(f"  launches over the TP runs on the kernels: {tp_counts}")
    if tp_counts != {name: 6 for name in counters}:  # 2 + 4 ranks
        raise AssertionError(f"TP launches {tp_counts}")
    del layer_args, ref_w, plain, got
    torch.cuda.empty_cache()
    return launches, tp_counts


def phase_llama3(torch, flash_losses):
    from ring_flash_attn_tpu_torch.ops.flash import (
        block_bwd, block_fwd, compute_delta)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.parallel import llama3, ring

    log("== phase 15: llama3 training: the W=4 ranks on one card vs the "
        "whole-sequence kernels, W=8's last rank, train_step")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    bf16 = torch.bfloat16
    world, hq, hkv, d, ll, tail = 4, 32, 8, 128, 8192, 512
    s = world * ll
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v, dout = (rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d),
                     rnd(1, hq, s, d))
    qs, ks, vs, douts = ([c.contiguous() for c in x.chunk(world, dim=2)]
                         for x in (q, k, v, dout))

    # (a) each rank through the module's own rank functions (those that
    # _llama3_fwd / _llama3_bwd run), the gathered k and v handed in
    # (heads_k_stride = Hkv: one chunk): B1 at offset r * L, then the delta
    # and B2 with gathered-size fp32 dk/dv, summed over the ranks here where
    # the group's reduce-scatter sums them
    kv = torch.stack([k, v])

    def l3_fwd(qq, kv_all, offset):
        return llama3._rank_fwd(qq, lambda i: kv_all[:, :, i:i + hkv], hkv,
                                scale, MaskArgs(causal=True, offset=offset),
                                hkv, None)

    def l3_bwd(qq, o, lse_q, dd, kv_all, offset):
        (dq, dk, dv), = llama3._rank_bwd(
            qq, o, lse_q, dd, lambda i: kv_all[:, :, i:i + hkv], hkv, scale,
            MaskArgs(causal=True, offset=offset), hkv, None)
        return dq, dk, dv

    def l3_rank_bwd(r, outs, lses, dkv):
        dq, dk, dv = l3_bwd(qs[r], outs[r], lses[r], douts[r], kv, r * ll)
        dkv[0].add_(dk)
        dkv[1].add_(dv)
        return dq

    res = [l3_fwd(qs[r], kv, r * ll) for r in range(world)]
    outs, lses = [o for o, _ in res], [x for _, x in res]
    out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
    mask = MaskArgs(causal=True)
    ref_out, ref_lse = block_fwd(q, k, v, scale, mask, out_dtype=bf16)
    row_mask = MaskArgs(causal=True, offset=s - tail)
    p_out, p_lse = naive_block_fwd(q[:, :, -tail:], k, v, scale, row_mask)
    torch.cuda.synchronize()
    ro, el = _rel_err_parts(out, ref_out, world), max_err(lse, ref_lse)
    rp = _rel_err(out[:, :, -tail:], p_out)
    pl = max_err(lse[:, :, -tail:], p_lse)
    log(f"  llama3 W={world} S={s} causal forward: vs B1 on the whole "
        f"sequence |out| err of max|B1| by quarters {ro:.3e}, max|lse| err "
        f"{el:.3e}; vs plain on the last {tail} rows |out| err of "
        f"max|plain| {rp:.3e}, lse {pl:.3e} (tol {RING_OUT_REL_TOL} "
        f"relative, lse {RING_LSE_TOL})")
    if not (max(ro, rp) <= RING_OUT_REL_TOL
            and max(el, pl) <= RING_LSE_TOL):
        raise AssertionError("llama3's forward is wrong")
    del ref_out, ref_lse, p_out, p_lse
    dkv = torch.zeros((2, 1, hkv, s, d), dtype=torch.float32, device=dev)
    dqs = [l3_rank_bwd(r, outs, lses, dkv) for r in range(world)]
    got = (torch.cat(dqs, dim=2), dkv[0], dkv[1])
    ref = block_bwd(dout, q, k, v, lse, None, scale, mask, out=out)
    delta = compute_delta(dout, out)
    p_dq = naive_block_bwd(dout[:, :, -tail:], q[:, :, -tail:], k, v,
                           lse[:, :, -tail:], delta[:, :, -tail:], scale,
                           row_mask)[0]
    keys = slice(0, tail)
    _, p_dk, p_dv = naive_block_bwd(dout, q, k[:, :, keys], v[:, :, keys],
                                    lse, delta, scale, mask)
    torch.cuda.synchronize()
    rel = [_rel_err(x, r) for x, r in zip(got, ref)]
    prel = [_rel_err(got[0][:, :, -tail:], p_dq),
            _rel_err(got[1][:, :, keys], p_dk),
            _rel_err(got[2][:, :, keys], p_dv)]
    log(f"  llama3 W={world} S={s} causal backward: vs B2 on the whole "
        f"sequence rel err dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e}; "
        f"vs plain: dq of the last {tail} rows {prel[0]:.2e}, dk and dv of "
        f"the first {tail} keys over all q rows {prel[1]:.2e} {prel[2]:.2e} "
        f"(tol {BWD_REL_TOL})")
    if max(*rel, *prel) > BWD_REL_TOL:
        raise AssertionError("llama3's backward is wrong")
    del got, ref, delta, p_dq, p_dk, p_dv, dqs, out, lse, res
    torch.cuda.empty_cache()

    # (b) each rank's time beside the ring's on the same tensors, in turns
    # (llama3, ring, ring, llama3; 10 forward and 5 backward calls a rank)
    ring_mask = ring._ring_masks(True, ll, {})
    res = [_rank_fwd(qs, ks, vs, r, scale, ring_mask) for r in range(world)]
    ring_outs, ring_lses = [o for o, _ in res], [x for _, x in res]
    times = {}
    for name in ("llama3", "ring", "ring", "llama3"):
        dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                            device=dev) for x in ks]
        if name == "llama3":
            fwd = [_events_ms(torch, lambda r=r: l3_fwd(qs[r], kv, r * ll),
                              10)
                   for r in range(world)]
            bwd = [_events_ms(torch, lambda r=r: l3_rank_bwd(
                r, outs, lses, dkv), 5) for r in range(world)]
        else:
            fwd = [_events_ms(torch, lambda r=r: _rank_fwd(
                qs, ks, vs, r, scale, ring_mask), 10) for r in range(world)]
            bwd = [_events_ms(torch, lambda r=r: _rank_bwd(
                qs, ks, vs, douts, ring_outs, ring_lses, dkvs, r, scale,
                ring_mask), 5) for r in range(world)]
        times.setdefault(name, []).append({"fwd_ms": fwd, "bwd_ms": bwd})
        log(f"  {name} W={world} S={s} causal, per rank (ranks 0 to "
            f"{world - 1}): forward " + " ".join(f"{t:.3f}" for t in fwd)
            + " ms, backward " + " ".join(f"{t:.3f}" for t in bwd) + " ms")
        del dkvs
    ratio = [[l3["fwd_ms"][r] / rg["fwd_ms"][r] for r in range(world)]
             for l3, rg in zip(times["llama3"], times["ring"])]
    log("  llama3 over ring, forward, per rank, turn by turn: "
        + "; ".join(" ".join(f"{x:.2f}" for x in t) for t in ratio))
    del q, k, v, kv, dout, qs, ks, vs, douts, outs, lses, dkv, res
    del ring_outs, ring_lses
    torch.cuda.empty_cache()

    # (c) the last rank of W=8: 65536 gathered keys at offset 57344, past
    # the fused kernel's limit, so B3a/B3b
    s8, rank = 8 * ll, 7
    q7, dout7 = rnd(1, hq, ll, d), rnd(1, hq, ll, d)
    k8, v8 = rnd(1, hkv, s8, d), rnd(1, hkv, s8, d)
    offset = rank * ll
    mask7 = MaskArgs(causal=True, offset=offset)
    split = flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches
    kv8 = torch.stack([k8, v8])
    out7, lse7 = l3_fwd(q7, kv8, offset)
    delta7 = compute_delta(dout7, out7)
    dq7, dk7, dv7 = l3_bwd(q7, out7, lse7, dout7, kv8, offset)
    ran_split = (flash_bwd_dq_cuda.launches - split[0],
                 flash_bwd_dkv_cuda.launches - split[1])
    rows = MaskArgs(causal=True, offset=offset + ll - tail)
    p_out, p_lse = naive_block_fwd(q7[:, :, -tail:], k8, v8, scale, rows)
    p_dq = naive_block_bwd(dout7[:, :, -tail:], q7[:, :, -tail:], k8, v8,
                           lse7[:, :, -tail:], delta7[:, :, -tail:], scale,
                           rows)[0]
    _, p_dk, p_dv = naive_block_bwd(dout7, q7, k8[:, :, keys], v8[:, :, keys],
                                    lse7, delta7, scale, mask7)
    torch.cuda.synchronize()
    errs = [_rel_err(out7[:, :, -tail:], p_out),
            max_err(lse7[:, :, -tail:], p_lse),
            _rel_err(dq7[:, :, -tail:], p_dq), _rel_err(dk7[:, :, keys], p_dk),
            _rel_err(dv7[:, :, keys], p_dv)]
    t_fwd = _events_ms(torch, lambda: l3_fwd(q7, kv8, offset), 3)
    t_bwd = _events_ms(torch, lambda: block_bwd(
        dout7, q7, k8, v8, lse7, delta7, scale, mask7), 2)
    log(f"  llama3 W=8 rank 7 (q {tuple(q7.shape)}, {s8} keys, offset "
        f"{offset}): B3a/B3b launched {ran_split}; vs plain on the last "
        f"{tail} rows: |out| err of max|plain| {errs[0]:.3e}, lse "
        f"{errs[1]:.3e}, dq {errs[2]:.2e}; dk, dv of the first {tail} keys "
        f"{errs[3]:.2e} {errs[4]:.2e} (tol {RING_OUT_REL_TOL}, lse "
        f"{RING_LSE_TOL}, gradients {BWD_REL_TOL}); forward {t_fwd:.3f} ms, "
        f"backward {t_bwd:.3f} ms")
    if not (ran_split == (1, 1) and errs[0] <= RING_OUT_REL_TOL
            and errs[1] <= RING_LSE_TOL and max(errs[2:]) <= BWD_REL_TOL):
        raise AssertionError("llama3's last rank of W=8 is wrong")
    del q7, dout7, k8, v8, kv8, out7, lse7, delta7, dq7, dk7, dv7
    del p_out, p_lse, p_dq, p_dk, p_dv
    torch.cuda.empty_cache()

    # (d) the main path: train_step(attention="llama3") over a sequence
    # group of one process, counts from 0
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda}
    for fn in counters.values():
        fn.launches = 0
    batch = _train_batch(torch, FULL_WIDTH["vocab"], 8192, 2)
    _train_two_steps(torch, "llama3", batch, flash_losses, sp_group=None)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 2 * FULL_WIDTH["layers"] for name in counters}
    log(f"  launches over train_step(attention='llama3'): {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches, {"w4_per_rank_llama3_vs_ring_ms": times,
                      "w8_rank7_ms": {"fwd_ms": t_fwd, "bwd_ms": t_bwd}}


def _varlen_check(what, got, ref, tol_out, tol_lse):
    """Hold (out, lse) against the reference: out by rows and absolutely,
    lse absolutely; raise past the limits. Returns (abs, rows, lse)."""
    errs = (max_err(got[0], ref[0]), rel_err_rows(got[0], ref[0]),
            max_err(got[1], ref[1]))
    log(f"    {what}: |out| err {errs[0]:.3e}, of max|ref| by rows "
        f"{errs[1]:.3e}, |lse| err {errs[2]:.3e}")
    if errs[0] > tol_out or errs[1] > RING_OUT_REL_TOL or errs[2] > tol_lse:
        raise AssertionError(f"{what}: out/lse past the limits")
    return errs


def _grads_check(what, got, ref):
    """Hold (dq, dk, dv) to BWD_REL_TOL of max|ref|; returns the worst."""
    rel = [_rel_err(x.float(), r.float()) for x, r in zip(got, ref)]
    log(f"    {what}: rel err dq {rel[0]:.2e} dk {rel[1]:.2e} dv "
        f"{rel[2]:.2e} (tol {BWD_REL_TOL})")
    if max(rel) > BWD_REL_TOL:
        raise AssertionError(f"{what}: gradients past the limit")
    return max(rel)


@contextlib.contextmanager
def _uncounted(counters):
    """Launches inside are not counted: a timing loop or a reference run
    beside the path whose launches are read (the XFORM and BAND launches
    of the block kernels' launchers too)."""
    saved = {name: (fn.launches, getattr(fn, "xform_launches", None),
                    getattr(fn, "band_launches", None))
             for name, fn in counters.items()}
    try:
        yield
    finally:
        for name, fn in counters.items():
            fn.launches, xform, band = saved[name]
            if xform is not None:
                fn.xform_launches = xform
            if band is not None:
                fn.band_launches = band


@contextlib.contextmanager
def _path_run(counters, totals, kinds=("launches",)):
    """One run of a path through its entry points: the counts set to 0
    just before it and added to ``totals`` just after (launches under
    ``_uncounted`` inside it left out); the counts outside it stay as they
    were. ``kinds``: the counters read, ``launches`` under the kernel's
    name, a build's (``xform_launches``, ``band_launches``, where the
    launcher keeps one) under "<name> <kind>"."""
    saved = {(name, a): getattr(fn, a) for name, fn in counters.items()
             for a in kinds if hasattr(fn, a)}
    for name, a in saved:
        setattr(counters[name], a, 0)
    try:
        yield
    finally:
        for (name, a), x in saved.items():
            key = name if a == "launches" else f"{name} {a}"
            totals[key] = totals.get(key, 0) + getattr(counters[name], a)
            setattr(counters[name], a, x)


def phase_varlen(torch, flush):
    """Phase 16: packed sequences. Returns ({kernel: its varlen readings},
    the launches of the varlen path, the ring and llama3 times)."""
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.ops.flash import (
        compute_delta, flash_attention)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.ops.varlen import (
        cu_seqlens_to_segids, extract_local_ring_varlen, ring_varlen_info)
    from ring_flash_attn_tpu_torch.parallel import llama3, ring_varlen

    log("== phase 16: packed sequences: B1, B2, B3a/B3b with segment ids "
        "and positions, the varlen, ring-varlen and llama3-varlen entry "
        "points")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    bf16 = torch.bfloat16
    hq, hkv, d, t = 32, 8, 128, 8192
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    # (a) the kernels against their plain versions: the tile edges, then the
    # full width on each packing in three forms
    for case in SEG_EDGE_CASES:
        b, cq, ckv, sq, skv, cd, kind, cu = case
        mask = seg_case_mask(torch, kind, sq, skv, cu, dev)
        q, k, v, dout = (rnd(b, cq, sq, cd), rnd(b, ckv, skv, cd),
                         rnd(b, ckv, skv, cd), rnd(b, cq, sq, cd))
        out, lse = flash_fwd_cuda(q, k, v, cd ** -0.5, mask, out_dtype=bf16)
        _varlen_check(f"edge {case[:7]} B1", (out, lse),
                      naive_block_fwd(q, k, v, cd ** -0.5, mask),
                      B1_OUT_TOL, B1_LSE_TOL)
        delta = compute_delta(dout, out)
        ref = naive_block_bwd(dout, q, k, v, lse, delta, cd ** -0.5, mask)
        for bwd in (flash_bwd_cuda, flash_bwd_split_cuda):
            got = bwd(dout, q, k, v, lse, delta, cd ** -0.5, mask)
            if sq == skv == 1:  # one key a row: dq, dk vanish; dv holds
                rel = _rel_err(got[2], ref[2])
                if rel > BWD_REL_TOL:
                    raise AssertionError(f"edge {case}: dv {rel}")
                continue
            _grads_check(f"edge {case[:7]} {bwd.__name__}", got, ref)

    q, k, v, dout = (rnd(1, hq, t, d), rnd(1, hkv, t, d), rnd(1, hkv, t, d),
                     rnd(1, hq, t, d))
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    worst = {"B1": [0.0, 0.0, 0.0], "B2": 0.0, "B3": 0.0}
    timed = {}
    for cu in VARLEN_PACKINGS:
        seg = cu_seqlens_to_segids(cu, t, dev)
        half = t // 2
        forms = {
            "causal": varlen_mask(torch, cu, True, dev)[0],
            "segments": varlen_mask(torch, cu, False, dev)[0],
            # llama3's form: the last half of the rows over every key,
            # causal by index at offset T/2, segments
            "index": MaskArgs(causal=True, offset=half,
                              q_segids=seg[half:], kv_segids=seg),
        }
        for form, mask in forms.items():
            rows = slice(half, None) if form == "index" else slice(None)
            qq, dd = q[:, :, rows], dout[:, :, rows]
            out, lse = flash_fwd_cuda(qq, k, v, scale, mask, out_dtype=bf16)
            errs = _varlen_check(f"{cu} {form} B1", (out, lse),
                                 naive_block_fwd(qq, k, v, scale, mask),
                                 B1_OUT_TOL, B1_LSE_TOL)
            worst["B1"] = [max(a, b_) for a, b_ in zip(worst["B1"], errs)]
            delta = compute_delta(dd, out)
            ref = naive_block_bwd(dd, qq, k, v, lse, delta, scale, mask)
            for name, bwd in (("B2", flash_bwd_cuda),
                              ("B3", flash_bwd_split_cuda)):
                got = bwd(dd, qq, k, v, lse, delta, scale, mask)
                worst[name] = max(worst[name], _grads_check(
                    f"{cu} {form} {name}", got, ref))
            del ref, got
            torch.cuda.empty_cache()
        # the times, causal on positions (flash_attn_varlen_func's mask),
        # beside the masked-flop bound and SDPA with the dense mask
        mask, dense = varlen_mask(torch, cu, True, dev)
        out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
        delta = compute_delta(dout, out)
        fns = {
            "B1": lambda: flash_fwd_cuda(q, k, v, scale, mask,
                                         out_dtype=bf16),
            "B2": lambda: flash_bwd_cuda(dout, q, k, v, lse, None, scale,
                                         mask, out=out, dq_dtype=bf16,
                                         dkv_dtype=bf16),
            "B3a": lambda: flash_bwd_dq_cuda(dout, q, k, v, lse, delta,
                                             scale, mask, dq_dtype=bf16),
            "B3b": lambda: flash_bwd_dkv_cuda(dout, q, k, v, lse, delta,
                                              scale, mask, dkv_dtype=bf16),
        }
        pairs = varlen_pairs(cu, True)
        products = {"B1": 2, "B2": 5, "B3a": 3, "B3b": 4}
        qr = q.detach().requires_grad_()
        krr, vrr = kr.detach().requires_grad_(), vr.detach().requires_grad_()
        o_m = F.scaled_dot_product_attention(qr, krr, vrr, attn_mask=dense)
        lib = {"fwd": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, kr, vr, attn_mask=dense), 5, flush),
               "bwd": cuda_ms(torch, lambda: torch.autograd.grad(
                   o_m, (qr, krr, vrr), dout, retain_graph=True), 5, flush)}
        del o_m, qr, krr, vrr
        for name, fn in fns.items():
            r = kernel_ms(torch, fn, 10, flush)
            bound = products[name] * 2 * hq * d * pairs / H100_BF16_FLOPS
            timed.setdefault(name, []).append(dict(
                cu_seqlens=cu, ms=r["ms"], device_ms=r["device_ms"],
                bound_ms=bound * 1e3,
                library_ms=lib["fwd" if name == "B1" else "bwd"]))
            log(f"  {cu} causal {name}: {r['ms']:.3f} ms, device "
                f"{r['device_ms']:.3f} ms, bound {bound * 1e3:.3f} ms "
                f"({r['ms'] / (bound * 1e3):.2f}x), SDPA with the dense "
                f"mask {timed[name][-1]['library_ms']:.3f} ms")
        del dense, out, lse, delta
        torch.cuda.empty_cache()
    # the mask-free kernels at the same shape, for the [0, 8192] packing
    causal = MaskArgs(causal=True)
    out, lse = flash_fwd_cuda(q, k, v, scale, causal, out_dtype=bf16)
    delta = compute_delta(dout, out)
    free = {
        "B1": kernel_ms(torch, lambda: flash_fwd_cuda(
            q, k, v, scale, causal, out_dtype=bf16), 10, flush)["ms"],
        "B2": kernel_ms(torch, lambda: flash_bwd_cuda(
            dout, q, k, v, lse, None, scale, causal, out=out, dq_dtype=bf16,
            dkv_dtype=bf16), 10, flush)["ms"],
        "B3a": kernel_ms(torch, lambda: flash_bwd_dq_cuda(
            dout, q, k, v, lse, delta, scale, causal, dq_dtype=bf16), 10,
            flush)["ms"],
        "B3b": kernel_ms(torch, lambda: flash_bwd_dkv_cuda(
            dout, q, k, v, lse, delta, scale, causal, dkv_dtype=bf16), 10,
            flush)["ms"],
    }
    log("  mask-free causal at the same shape: " + ", ".join(
        f"{n} {m:.3f} ms" for n, m in free.items()))
    del out, lse, delta, kr, vr
    torch.cuda.empty_cache()

    # the varlen path from here on: its launches are counted, the timing
    # loops' and the reference runs' are not
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}
    for fn in counters.values():
        fn.launches = 0

    # (b) flash_attn_varlen_func and its qkvpacked form at T=8192, forward
    # and backward, against backend="plain" on the card
    # (the plain side: flash_attention(backend="plain") under the mask the
    # entry point builds, on the same (1, H, T, D) views)
    qt, kt, vt, dt = (x[0].transpose(0, 1) for x in (q, k, v, dout))

    def plain_varlen(leaves, cu, g):
        views = [x.transpose(0, 1)[None] for x in leaves]
        o, lse_p = flash_attention(*views, scale,
                                   varlen_mask(torch, cu, True, dev)[0],
                                   backend="plain")
        o = o[0].transpose(0, 1)
        return (o.detach(), lse_p[0], *torch.autograd.grad(o, leaves, g))

    for cu in VARLEN_PACKINGS:
        cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
        ref = plain_varlen(
            [x.detach().clone().requires_grad_() for x in (qt, kt, vt)], cu,
            dt)
        # the default backward (B2) and the reproducible one (B3a/B3b)
        for det in (False, True):
            leaves = [x.detach().clone().requires_grad_()
                      for x in (qt, kt, vt)]
            o, lse_v, _ = api.flash_attn_varlen_func(
                *leaves, cu_t, causal=True, return_attn_probs=True,
                deterministic=det)
            got = (o.detach(), lse_v, *torch.autograd.grad(o, leaves, dt))
            _varlen_check(f"flash_attn_varlen_func {cu}", got[:2],
                          ref[:2], B1_OUT_TOL, B1_LSE_TOL)
            _grads_check(f"flash_attn_varlen_func {cu} backward, "
                         f"deterministic={det}", got[2:], ref[2:])
        del got, ref, leaves
        torch.cuda.empty_cache()
    qkv = torch.stack([qt[:, :hkv], kt, vt], dim=1)
    cu = VARLEN_PACKINGS[3]
    leaf = qkv.detach().clone().requires_grad_()
    o = api.flash_attn_varlen_qkvpacked_func(
        leaf, torch.tensor(cu, dtype=torch.int32, device=dev), causal=True)
    got = (o.detach(), torch.autograd.grad(o, leaf, dt[:, :hkv])[0])
    leaf = qkv.detach().clone().requires_grad_()
    ref = plain_varlen(list(leaf.unbind(1)), cu, dt[:, :hkv])
    ref = (ref[0], torch.stack(ref[2:], dim=1))
    errs = (_rel_err(got[0].float(), ref[0].float()),
            _rel_err(got[1].float(), ref[1].float()))
    log(f"    flash_attn_varlen_qkvpacked_func {VARLEN_PACKINGS[3]}: out "
        f"{errs[0]:.2e}, dqkv {errs[1]:.2e} of max|plain|")
    if max(errs) > BWD_REL_TOL:
        raise AssertionError("flash_attn_varlen_qkvpacked_func is wrong")
    del qkv, got, ref, leaf, q, k, v, dout, qt, kt, vt, dt
    torch.cuda.empty_cache()

    # (c) ring varlen at W=4 on one card: 32768 packed tokens, every rank's
    # shards in one process through the module's step masks, against
    # flash_attn_varlen_func on the whole packing
    world, total = 4, 4 * t
    packings = [[0, 8192, 16384, 24576, 32768]] + [
        [4 * x for x in cu] for cu in VARLEN_PACKINGS[1:]]
    q, k, v, dout = (rnd(total, hq, d), rnd(total, hkv, d),
                     rnd(total, hkv, d), rnd(total, hq, d))
    times = {"ring_varlen": {}, "llama3_varlen": {}}
    for cu in packings:
        cu_local = [x // world for x in cu]
        loc = [[extract_local_ring_varlen(x, cu, r, world).transpose(
            0, 1)[None].contiguous() for r in range(world)]
            for x in (q, k, v, dout)]
        qs, ks, vs, douts = loc
        for causal in (True, False):
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            with _uncounted(counters):
                ref_o, ref_lse, _ = api.flash_attn_varlen_func(
                    *leaves, torch.tensor(cu, device=dev), causal=causal,
                    return_attn_probs=True)
                ref_g = torch.autograd.grad(ref_o, leaves, dout)
            masks = [ring_varlen.varlen_step_masks(
                *ring_varlen_info(cu_local, t, r, dev), causal, {})
                for r in range(world)]
            res = [_rank_fwd(qs, ks, vs, r, scale, masks[r])
                   for r in range(world)]
            outs, lses = [o for o, _ in res], [x for _, x in res]
            dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                                device=dev) for x in ks]
            dqs = [_rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                             masks[r]) for r in range(world)]
            for r in range(world):
                want = [extract_local_ring_varlen(x, cu, r, world).transpose(
                    0, 1)[None] for x in (ref_o, ref_g[0], ref_g[1],
                                          ref_g[2])]
                want_lse = extract_local_ring_varlen(ref_lse, cu, r, world,
                                                     axis=1)[None]
                ro = _rel_err(outs[r].float(), want[0].float())
                el = max_err(lses[r], want_lse)
                rel = [_rel_err(x, w.float()) for x, w in zip(
                    (dqs[r], dkvs[r][0], dkvs[r][1]), want[1:])]
                if (ro > RING_OUT_REL_TOL or el > RING_LSE_TOL
                        or max(rel) > BWD_REL_TOL):
                    raise AssertionError(
                        f"ring varlen {cu} causal={causal} rank {r}: out "
                        f"{ro:.2e} lse {el:.2e} grads {rel}")
            log(f"    ring varlen W={world} {cu} causal={causal}: every "
                f"rank's out, lse, dq, dk, dv within the limits of "
                f"flash_attn_varlen_func on the whole packing")
            key = f"{cu} causal={causal}"
            with _uncounted(counters):
                times["ring_varlen"][key] = {
                    "fwd_ms": [_events_ms(torch, lambda r=r: _rank_fwd(
                        qs, ks, vs, r, scale, masks[r]), 5)
                        for r in range(world)],
                    "bwd_ms": [_events_ms(torch, lambda r=r: _rank_bwd(
                        qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                        masks[r]), 3) for r in range(world)]}
            log(f"    ring varlen {key} per rank: forward " + " ".join(
                f"{x:.3f}" for x in times["ring_varlen"][key]["fwd_ms"])
                + " ms, backward " + " ".join(
                f"{x:.3f}" for x in times["ring_varlen"][key]["bwd_ms"])
                + " ms")
            del res, outs, lses, dkvs, dqs, ref_o, ref_g, leaves
            torch.cuda.empty_cache()

        # (d) llama3 varlen at W=4, the rank's contiguous share of the same
        # packing, from llama3_flash_attn_prepare_cu_seqlens, through the
        # module's rank functions (the kv all-gathered, handed in)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        with _uncounted(counters):
            ref_o, ref_lse, _ = api.flash_attn_varlen_func(
                *leaves, torch.tensor(cu, device=dev), causal=True,
                return_attn_probs=True)
            ref_g = torch.autograd.grad(ref_o, leaves, dout)
        kv_all = torch.stack([k.transpose(0, 1)[None],
                              v.transpose(0, 1)[None]]).contiguous()
        # each rank's globally consistent labels, as the entry point builds
        # them from llama3_flash_attn_prepare_cu_seqlens (the group's
        # all-gather concatenates them)
        labels = []
        for r in range(world):
            cu_q, cu_k, _, _, sl = api.llama3_flash_attn_prepare_cu_seqlens(
                cu, True, r, world)
            seg_local = cu_seqlens_to_segids(cu_q, t, dev).long()
            labels.append((sl.start + torch.as_tensor(cu_k, device=dev)[
                seg_local]).to(torch.int32))
        for stride in (4, 8):
            key = f"{cu} stride={stride}"
            fwd_ms, bwd_ms = [], []
            dkv = torch.zeros((2, 1, hkv, total, d), dtype=torch.float32,
                              device=dev)
            for r in range(world):
                mask = MaskArgs(causal=True, offset=r * t,
                                q_segids=labels[r],
                                kv_segids=torch.cat(labels))
                rows = slice(r * t, (r + 1) * t)
                qr_ = q[rows].transpose(0, 1)[None]
                dr_ = dout[rows].transpose(0, 1)[None]

                def fwd(qr_=qr_, mask=mask, stride=stride):
                    return llama3._rank_fwd(
                        qr_, lambda i: kv_all[:, :, i:i + stride], hkv,
                        scale, mask, stride, None)

                o, lse_r = fwd()
                dq_parts = list(llama3._rank_bwd(
                    qr_, o, lse_r, dr_, lambda i: kv_all[:, :, i:i + stride],
                    hkv, scale, mask, stride, None))
                dq = torch.cat([p[0] for p in dq_parts], dim=1)
                for j, (_, dk_g, dv_g) in enumerate(dq_parts):
                    dkv[0][:, j * stride:(j + 1) * stride].add_(dk_g)
                    dkv[1][:, j * stride:(j + 1) * stride].add_(dv_g)
                ro = _rel_err(o.float(), ref_o[rows].transpose(
                    0, 1)[None].float())
                el = max_err(lse_r, ref_lse[:, rows][None])
                rq = _rel_err(dq.float(), ref_g[0][rows].transpose(
                    0, 1)[None].float())
                if (ro > RING_OUT_REL_TOL or el > RING_LSE_TOL
                        or rq > BWD_REL_TOL):
                    raise AssertionError(f"llama3 varlen {key} rank {r}: "
                                         f"out {ro} lse {el} dq {rq}")
                with _uncounted(counters):
                    fwd_ms.append(_events_ms(torch, fwd, 5))
                    bwd_ms.append(_events_ms(torch, lambda: list(
                        llama3._rank_bwd(
                            qr_, o, lse_r, dr_,
                            lambda i: kv_all[:, :, i:i + stride], hkv,
                            scale, mask, stride, None)), 3))
            rel = [_rel_err(dkv[i], ref_g[1 + i].transpose(0, 1)[None].float())
                   for i in (0, 1)]
            if max(rel) > BWD_REL_TOL:
                raise AssertionError(f"llama3 varlen {key}: dk, dv {rel}")
            times["llama3_varlen"][key] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
            log(f"    llama3 varlen W={world} {key}: every rank's out, lse, "
                f"dq and the summed dk, dv within the limits; per rank "
                f"forward " + " ".join(f"{x:.3f}" for x in fwd_ms)
                + " ms, backward " + " ".join(f"{x:.3f}" for x in bwd_ms)
                + " ms")
            del dkv
        del ref_o, ref_g, leaves, kv_all, loc, qs, ks, vs, douts
        torch.cuda.empty_cache()

    # the entry points themselves at W=1 on the 32768-token packing
    for cu in packings[:1]:
        cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
        with _uncounted(counters):
            want = api.flash_attn_varlen_func(q, k, v, cu_t, causal=True)
        got = api.ring_flash_attn_varlen_func(q, k, v, cu_t, causal=True)
        pre = api.llama3_flash_attn_prepare_cu_seqlens(cu, True, 0, 1)
        got3 = api.llama3_flash_attn_varlen_func(
            q, k, v, pre[0], pre[1], heads_k_stride=4, local_k_slice=pre[4],
            causal=True)
        errs = (_rel_err(got.float(), want.float()),
                _rel_err(got3.float(), want.float()))
        log(f"    W=1 entry points on {cu}: ring varlen {errs[0]:.2e}, "
            f"llama3 varlen {errs[1]:.2e} of max|flash_attn_varlen_func|")
        if max(errs) > RING_OUT_REL_TOL:
            raise AssertionError("a varlen entry point at W=1 is wrong")
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches on the varlen path: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the varlen path never ran: "
                             f"{launches}")
    readings = {name: dict(
        varlen_causal=timed[key], varlen_mask_free_ms=free[key],
        varlen_worst=(worst["B1"] if key == "B1" else
                      worst["B2"] if key == "B2" else worst["B3"]))
        for name, key in (("B1 flash_fwd", "B1"), ("B2 flash_bwd", "B2"),
                          ("B3a flash_bwd_dq", "B3a"),
                          ("B3b flash_bwd_dkv", "B3b"))}
    return readings, launches, times


def _zigzag_rank_fwd(qs, ks, vs, rank, scale, step_masks):
    """Rank ``rank``'s forward through ``zigzag.zigzag_rank_fwd``, the kv
    shard of rank (rank - t) % W handed in at step t. (out bf16, lse)."""
    from ring_flash_attn_tpu_torch.parallel.zigzag import zigzag_rank_fwd

    world = len(qs)
    out, lse = zigzag_rank_fwd(
        qs[rank], lambda t: (ks[(rank - t) % world], vs[(rank - t) % world]),
        rank, world, scale, None, step_masks)
    return out.to(qs[rank].dtype), lse


def _zigzag_rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, rank, scale,
                     step_masks):
    """Rank ``rank``'s backward through ``zigzag.zigzag_rank_bwd``: returns
    its dq (fp32) and adds its dk, dv of kv shard src into ``dkvs[src]``,
    the accumulator that visits it on the ring."""
    from ring_flash_attn_tpu_torch.parallel.zigzag import zigzag_rank_bwd

    world = len(qs)

    def add_dkv(t, b_dk, b_dv, rows):
        acc = dkvs[(rank - t) % world]
        acc[0][:, :, rows].add_(b_dk)
        acc[1][:, :, rows].add_(b_dv)

    return zigzag_rank_bwd(
        qs[rank], outs[rank], lses[rank], douts[rank],
        lambda t: (ks[(rank - t) % world], vs[(rank - t) % world]), add_dkv,
        rank, world, scale, None, step_masks)


# phase 17's transforms: softcap (Gemma 2's 50.0) and ALiBi on the standard
# slopes, alone and together
XFORMS = {"softcap": (50.0, False), "alibi": (None, True),
          "both": (50.0, True)}
XFORM_KERNELS = ("B1 flash_fwd", "B2 flash_bwd", "B3a flash_bwd_dq",
                 "B3b flash_bwd_dkv")


def _alibi_bias(torch, mask, hq, sq, skv, dev):
    """The dense (1, Hq, Sq, Skv) bf16 float mask of ``mask``: ALiBi's bias
    where allowed, -inf elsewhere, for F.scaled_dot_product_attention
    (timed only)."""
    from ring_flash_attn_tpu_torch.ops.mask import alibi_bias, allowed_mask

    bias = alibi_bias(mask, hq, 1, sq, skv, dev).reshape(1, hq, sq, skv)
    allowed = allowed_mask(mask, sq, skv, dev)
    if allowed is not None:
        bias = bias.masked_fill(~allowed, float("-inf"))
    return bias.to(torch.bfloat16)


def xform_kernel_checks(torch, q, k, v, dout, slopes):
    """Phase 17 (a) and (b): B1, B2 and B3a/B3b with softcap and/or ALiBi
    against their plain versions at ``XFORM_EDGE_CASES`` and at the full
    width of q (1, Hq, T, D), k, v (1, Hkv, T, D) bf16 on the card, with
    ``slopes`` the (Hq,) ALiBi slopes. Raises past the limits; returns the
    worst errors {kernel: [abs, rel(, lse)]}."""
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.ops.varlen import (
        cu_seqlens_to_positions, cu_seqlens_to_segids)

    dev = q.device
    gen = torch.Generator(device=dev).manual_seed(1717)
    bf16 = torch.bfloat16
    t, d = q.shape[2], q.shape[3]
    scale = d ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def with_xf(mask, kind):
        cap, alibi = XFORMS[kind]
        return mask._replace(softcap=cap,
                             alibi_slopes=slopes if alibi else None)

    # (a) the tile edges
    for case in XFORM_EDGE_CASES:
        b, cq, ckv, sq, skv, cd = case[:6]
        mask = xform_case_mask(torch, case, dev)
        eq, ek, ev, edo = (rnd(b, cq, sq, cd), rnd(b, ckv, skv, cd),
                           rnd(b, ckv, skv, cd), rnd(b, cq, sq, cd))
        out, lse = flash_fwd_cuda(eq, ek, ev, cd ** -0.5, mask,
                                  out_dtype=bf16)
        _varlen_check(f"edge {case} B1", (out, lse),
                      naive_block_fwd(eq, ek, ev, cd ** -0.5, mask),
                      B1_OUT_TOL, B1_LSE_TOL)
        delta = compute_delta(edo, out)
        ref = naive_block_bwd(edo, eq, ek, ev, lse, delta, cd ** -0.5, mask)
        for bwd in (flash_bwd_cuda, flash_bwd_split_cuda):
            got = bwd(edo, eq, ek, ev, lse, delta, cd ** -0.5, mask)
            if sq == skv == 1:  # one key a row: dq, dk vanish; dv holds
                if _rel_err(got[2], ref[2]) > BWD_REL_TOL:
                    raise AssertionError(f"edge {case}: dv")
                continue
            _grads_check(f"edge {case} {bwd.__name__}", got, ref)

    # (b) the full width (Llama-3-8B's attention widths) against the plain
    # versions: each transform causal, not causal, at an offset (the last
    # half of the rows over every key) and segmented on the reference's four
    # packings, causal on positions, and on the five-sequence packing
    # without a causal mask (ALiBi on |distance| of the positions)
    half = t // 2
    five = VARLEN_PACKINGS[3]
    seg5 = cu_seqlens_to_segids(five, t, dev)
    pos5 = cu_seqlens_to_positions(five, t, dev)
    forms = {"causal": (MaskArgs(causal=True), slice(None)),
             "not causal": (MaskArgs(), slice(None)),
             "offset": (MaskArgs(causal=True, offset=half),
                        slice(half, None))}
    for cu in VARLEN_PACKINGS:
        forms[f"packed {cu}"] = (varlen_mask(torch, cu, True, dev)[0],
                                 slice(None))
    forms[f"packed {five} not causal"] = (
        MaskArgs(q_segids=seg5, kv_segids=seg5, q_pos=pos5, kv_pos=pos5),
        slice(None))
    # the worst (absolute, relative) error of each kernel; B1's relative
    # error by rows, with lse's absolute one beside it
    worst = {"B1": [0.0, 0.0, 0.0], "B2": [0.0, 0.0], "B3a": [0.0, 0.0],
             "B3b": [0.0, 0.0]}

    def note(name, got, ref):
        abs_, rel = (max(max_err(x, r) for x, r in zip(got, ref)),
                     max(_rel_err(x.float(), r.float())
                         for x, r in zip(got, ref)))
        worst[name] = [max(worst[name][0], abs_), max(worst[name][1], rel)]

    # softcap where it bends the logits: q times 4 (exact in bf16) gives
    # logits of about N(0, 16), the largest of a row some 0.3 of the cap
    # 50, so that a kernel without the cap, or without its 1 - tanh^2 in
    # the backward, moves lse and the gradients past the limits
    # (check_xform_faults.py); at q's own N(0, 1) logits the cap moves dS
    # by some 0.1%, which the limits cannot see
    hot = q * 4
    runs = [(kind, kind, q) for kind in XFORMS] + [
        (f"{kind}, q x 4", kind, hot) for kind in XFORMS if XFORMS[kind][0]]
    for form, (base, rows) in forms.items():
        for label, kind, q_in in runs:
            mask = with_xf(base, kind)
            qq, dd = q_in[:, :, rows], dout[:, :, rows]
            out, lse = flash_fwd_cuda(qq, k, v, scale, mask, out_dtype=bf16)
            errs = _varlen_check(f"{form} {label} B1", (out, lse),
                                 naive_block_fwd(qq, k, v, scale, mask),
                                 B1_OUT_TOL, B1_LSE_TOL)
            worst["B1"] = [max(a, b_) for a, b_ in zip(worst["B1"], errs)]
            delta = compute_delta(dd, out)
            ref = naive_block_bwd(dd, qq, k, v, lse, delta, scale, mask)
            for name, bwd in (("B2", flash_bwd_cuda),
                              ("B3", flash_bwd_split_cuda)):
                got = bwd(dd, qq, k, v, lse, delta, scale, mask)
                _grads_check(f"{form} {label} {name}", got, ref)
                if name == "B2":
                    note("B2", got, ref)
                else:
                    note("B3a", got[:1], ref[:1])
                    note("B3b", got[1:], ref[1:])
            del ref, got, out, lse, delta
            torch.cuda.empty_cache()

    return worst


def phase_xform(torch, flush):
    """Phase 17: softcap and ALiBi in B1, B2, B3a/B3b, and zigzag varlen.
    Returns (the XFORM instantiations' kernel entries, {path: {kernel:
    launches}} of the xform and zigzag_varlen paths, times)."""
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.ops.flash import (
        block_bwd, block_fwd, compute_delta, flash_attention)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.ops.varlen import (
        cu_seqlens_to_positions, cu_seqlens_to_segids,
        extract_local_zigzag_varlen, zigzag_varlen_info)
    from ring_flash_attn_tpu_torch.parallel import (
        layouts, llama3, ring, stripe, zigzag, zigzag_varlen)

    log("== phase 17: softcap and ALiBi in B1, B2, B3a/B3b (XFORM), the "
        "entry points with them, and zigzag varlen")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    hq, hkv, d, t = 32, 8, 128, 8192
    scale = d ** -0.5
    slopes = alibi_slopes(torch, hq, dev)
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def with_xf(mask, kind, sl=slopes):
        cap, alibi = XFORMS[kind]
        return mask._replace(softcap=cap, alibi_slopes=sl if alibi else None)

    q, k, v, dout = (rnd(1, hq, t, d), rnd(1, hkv, t, d), rnd(1, hkv, t, d),
                     rnd(1, hq, t, d))
    worst = xform_kernel_checks(torch, q, k, v, dout, slopes)
    five = VARLEN_PACKINGS[3]

    # (c) the times: each instantiation causal and on the five-sequence
    # packing (causal on positions), each transform and none (the same
    # kernel without the transform), beside the flop bound of its products
    # and, for ALiBi, SDPA with the bias as a dense float mask (timed only;
    # no single PyTorch call computes softcap)
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    products = {"B1": 2, "B2": 5, "B3a": 3, "B3b": 4}
    timed = {}
    for form, base in (("causal", MaskArgs(causal=True)),
                       (f"packed {five}", varlen_mask(torch, five, True,
                                                      dev)[0])):
        pairs = (t * (t + 1) // 2 if form == "causal"
                 else varlen_pairs(five, True))
        for kind in ("none",) + tuple(XFORMS):
            mask = base if kind == "none" else with_xf(base, kind)
            out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
            delta = compute_delta(dout, out)
            fns = {
                "B1": lambda: flash_fwd_cuda(q, k, v, scale, mask,
                                             out_dtype=bf16),
                "B2": lambda: flash_bwd_cuda(dout, q, k, v, lse, None, scale,
                                             mask, out=out, dq_dtype=bf16,
                                             dkv_dtype=bf16),
                "B3a": lambda: flash_bwd_dq_cuda(dout, q, k, v, lse, delta,
                                                 scale, mask, dq_dtype=bf16),
                "B3b": lambda: flash_bwd_dkv_cuda(dout, q, k, v, lse, delta,
                                                  scale, mask,
                                                  dkv_dtype=bf16),
            }
            lib = {"fwd": None, "bwd": None}
            if kind == "alibi":
                dense = _alibi_bias(torch, mask, hq, t, t, dev)
                qr = q.detach().requires_grad_()
                krr = kr.detach().requires_grad_()
                vrr = vr.detach().requires_grad_()
                o_m = F.scaled_dot_product_attention(qr, krr, vrr,
                                                     attn_mask=dense)
                lib = {"fwd": cuda_ms(
                           torch, lambda: F.scaled_dot_product_attention(
                               q, kr, vr, attn_mask=dense), 5, flush),
                       "bwd": cuda_ms(torch, lambda: torch.autograd.grad(
                           o_m, (qr, krr, vrr), dout, retain_graph=True), 5,
                           flush)}
                del o_m, qr, krr, vrr, dense
                torch.cuda.empty_cache()
            for name, fn in fns.items():
                r = kernel_ms(torch, fn, 10, flush)
                bound = products[name] * 2 * hq * d * pairs / H100_BF16_FLOPS
                entry = dict(ms=r["ms"], device_ms=r["device_ms"],
                             bound_ms=bound * 1e3,
                             library_ms=lib["fwd" if name == "B1" else "bwd"])
                timed.setdefault(name, {}).setdefault(form, {})[kind] = entry
                libtxt = ("none (no PyTorch call computes softcap)"
                          if XFORMS.get(kind, (None,))[0] else
                          f"{entry['library_ms']:.3f} ms"
                          if entry["library_ms"] else "-")
                log(f"  {form} {kind} {name}: {r['ms']:.3f} ms, device "
                    f"{r['device_ms']:.3f} ms, bound {bound * 1e3:.3f} ms "
                    f"({r['ms'] / (bound * 1e3):.2f}x), SDPA with the ALiBi "
                    f"bias as a dense float mask {libtxt}")
            del out, lse, delta
            torch.cuda.empty_cache()
    # the plain versions' times, causal with both transforms
    mask = with_xf(MaskArgs(causal=True), "both")
    out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
    delta = compute_delta(dout, out)
    plain = {"fwd": cuda_ms(torch, lambda: naive_block_fwd(
        q, k, v, scale, mask), 2, flush),
        "bwd": cuda_ms(torch, lambda: naive_block_bwd(
            dout, q, k, v, lse, delta, scale, mask), 2, flush)}
    log(f"  plain versions, causal, softcap and ALiBi: forward "
        f"{plain['fwd']:.3f} ms, backward {plain['bwd']:.3f} ms")
    del out, lse, delta, kr, vr
    torch.cuda.empty_cache()

    # the xform path from here on: its launches are counted, the reference
    # runs' are not
    def zero():
        for fn in counters.values():
            fn.launches = fn.xform_launches = 0

    def read():
        return ({n: fn.launches for n, fn in counters.items()},
                {n + " XFORM": fn.xform_launches
                 for n, fn in counters.items()})

    def uncounted():
        return _uncounted(counters)

    zero()
    # (d1) flash_attn_func, causal, softcap and ALiBi, forward and backward
    # (B2, and B3a/B3b with deterministic) against backend="plain"
    qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
    mask = with_xf(MaskArgs(causal=True), "both")
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_p, lse_p = flash_attention(*leaves, scale, mask, backend="plain")
    ref = (o_p.detach(), lse_p, *torch.autograd.grad(o_p, leaves, dout))
    del o_p, lse_p, leaves
    for det in (False, True):
        leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
        o, lse_f, _ = api.flash_attn_func(
            *leaves, causal=True, softcap=50.0, alibi_slopes=slopes,
            return_attn_probs=True, deterministic=det)
        got = (o.detach().transpose(1, 2), lse_f,
               *(g.transpose(1, 2) for g in torch.autograd.grad(
                   o, leaves, dt)))
        _varlen_check(f"flash_attn_func softcap ALiBi deterministic={det}",
                      got[:2], ref[:2], B1_OUT_TOL, B1_LSE_TOL)
        _grads_check(f"flash_attn_func softcap ALiBi backward, "
                     f"deterministic={det}", got[2:], ref[2:])
    del got, ref, leaves, o
    torch.cuda.empty_cache()
    # (d2) flash_attn_varlen_func on the five-sequence packing, softcap and
    # ALiBi on the within-sequence positions
    vmask = with_xf(varlen_mask(torch, five, True, dev)[0], "both")
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_p, lse_p = flash_attention(*leaves, scale, vmask, backend="plain")
    ref = (o_p.detach()[0].transpose(0, 1), lse_p[0],
           *(g[0].transpose(0, 1)
             for g in torch.autograd.grad(o_p, leaves, dout)))
    del o_p, lse_p
    leaves = [x.detach()[0].transpose(0, 1).clone().requires_grad_()
              for x in (q, k, v)]
    o, lse_v, _ = api.flash_attn_varlen_func(
        *leaves, torch.tensor(five, dtype=torch.int32, device=dev),
        causal=True, softcap=50.0, alibi_slopes=slopes,
        return_attn_probs=True)
    got = (o.detach(), lse_v, *torch.autograd.grad(
        o, leaves, dout[0].transpose(0, 1)))
    _varlen_check(f"flash_attn_varlen_func {five} softcap ALiBi", got[:2],
                  ref[:2], B1_OUT_TOL, B1_LSE_TOL)
    _grads_check(f"flash_attn_varlen_func {five} softcap ALiBi backward",
                 got[2:], ref[2:])
    del got, ref, leaves, o, q, k, v, dout, qt, kt, vt, dt
    torch.cuda.empty_cache()

    # (d3) ring, zigzag and stripe at W=4 on one card with ALiBi: every
    # rank's steps through the modules' own step masks (the kv of each
    # source rank handed in), against B1/B2 with ALiBi on the whole
    # sequence and the plain versions on its last 512 rows (out, lse, dq)
    # and first 512 keys (dk, dv); then llama3 at W=4 with softcap and
    # ALiBi (heads_k_stride 4: the slopes sliced a chunk at a time)
    world, tail = 4, 512
    s = world * t
    q, k, v, dout = (rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d),
                     rnd(1, hq, s, d))
    keys = slice(0, tail)

    def whole(kind):
        """The references on the whole sequence with transform ``kind``:
        (mask, out, lse, (dq, dk, dv), plain on the tails)."""
        mask = with_xf(MaskArgs(causal=True), kind)
        with uncounted():
            out, lse = block_fwd(q, k, v, scale, mask, out_dtype=bf16)
            grads = block_bwd(dout, q, k, v, lse, None, scale, mask, out=out)
        row_mask = mask._replace(offset=s - tail)
        delta = compute_delta(dout, out)
        p_out, p_lse = naive_block_fwd(q[:, :, -tail:], k, v, scale,
                                       row_mask)
        p_dq = naive_block_bwd(dout[:, :, -tail:], q[:, :, -tail:], k, v,
                               lse[:, :, -tail:], delta[:, :, -tail:], scale,
                               row_mask)[0]
        _, p_dk, p_dv = naive_block_bwd(dout, q, k[:, :, keys], v[:, :, keys],
                                        lse, delta, scale, mask)
        return mask, out, lse, grads, (p_out, p_lse, p_dq, p_dk, p_dv)

    def hold(what, got, ref):
        """Hold a schedule's (out, lse, dq, dk, dv) in global order."""
        _, out, lse, grads, p = ref
        errs = [_rel_err_parts(got[0], out, world), max_err(got[1], lse),
                _rel_err(got[0][:, :, -tail:], p[0]),
                max_err(got[1][:, :, -tail:], p[1])]
        rel = [_rel_err(x, r) for x, r in zip(got[2:], grads)] + [
            _rel_err(got[2][:, :, -tail:], p[2]),
            _rel_err(got[3][:, :, keys], p[3]),
            _rel_err(got[4][:, :, keys], p[4])]
        log(f"    {what}: out of max|ref| by quarters {errs[0]:.3e}, lse "
            f"{errs[1]:.3e}; plain tail out {errs[2]:.3e} lse {errs[3]:.3e}; "
            f"gradients vs the whole sequence and plain "
            + " ".join(f"{x:.2e}" for x in rel))
        if (max(errs[0], errs[2]) > RING_OUT_REL_TOL
                or max(errs[1], errs[3]) > RING_LSE_TOL
                or max(rel) > BWD_REL_TOL):
            raise AssertionError(f"{what} is wrong")

    layouts_of = {
        "ring": (lambda x: [c.contiguous() for c in x.chunk(world, dim=2)],
                 lambda parts: torch.cat(parts, dim=2)),
        "zigzag": (lambda x: [layouts.extract_local_zigzag(
            x, r, world, axis=2).contiguous() for r in range(world)],
            lambda parts: layouts.restore_zigzag(
                torch.cat(parts, dim=2), world, axis=2)),
        "stripe": (lambda x: [layouts.extract_local_stripe(
            x, r, world, axis=2).contiguous() for r in range(world)],
            lambda parts: layouts.restore_stripe(
                torch.cat(parts, dim=2), world, axis=2)),
    }
    times = {}
    ref = whole("alibi")
    extras = dict(alibi_slopes=slopes)
    for sched, (split, join) in layouts_of.items():
        qs, ks, vs, douts = (split(x) for x in (q, k, v, dout))
        ll = qs[0].shape[2]
        if sched == "zigzag":
            step_masks = zigzag._batch_masks(ll // 2, extras, dev)
            rank_fwd, rank_bwd = _zigzag_rank_fwd, _zigzag_rank_bwd
        else:
            step_masks = (ring._ring_masks(True, ll, extras)
                          if sched == "ring"
                          else stripe._step_masks(extras, ll, dev))
            rank_fwd, rank_bwd = _rank_fwd, _rank_bwd

        def fwd(r):
            return rank_fwd(qs, ks, vs, r, scale, step_masks)

        def bwd(r, outs, lses, dkvs):
            return rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                            step_masks)
        res = [fwd(r) for r in range(world)]
        outs, lses = [o for o, _ in res], [x for _, x in res]
        dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                            device=dev) for x in ks]
        dqs = [bwd(r, outs, lses, dkvs) for r in range(world)]
        got = (join(outs), join(lses), join(dqs), join([x[0] for x in dkvs]),
               join([x[1] for x in dkvs]))
        hold(f"{sched} W={world} S={s} causal ALiBi", got, ref)
        with uncounted():
            times[f"{sched} alibi"] = {
                "fwd_ms": [_events_ms(torch, lambda r=r: fwd(r), 3)
                           for r in range(world)],
                "bwd_ms": [_events_ms(torch, lambda r=r: bwd(
                    r, outs, lses, dkvs), 2) for r in range(world)]}
        log(f"    {sched} ALiBi per rank: forward " + " ".join(
            f"{x:.3f}" for x in times[f"{sched} alibi"]["fwd_ms"])
            + " ms, backward " + " ".join(
            f"{x:.3f}" for x in times[f"{sched} alibi"]["bwd_ms"]) + " ms")
        del res, outs, lses, dkvs, dqs, got, qs, ks, vs, douts
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()

    # llama3 at W=4 with softcap and ALiBi, through the module's rank
    # functions (the gathered kv handed in) at heads_k_stride 4
    ref = whole("both")
    l3_mask = ref[0]
    stride = 4
    kv = torch.stack([k, v])
    qs, douts = ([c.contiguous() for c in x.chunk(world, dim=2)]
                 for x in (q, dout))

    def l3_fwd(qq, kv_all, m):
        return llama3._rank_fwd(qq, lambda i: kv_all[:, :, i:i + stride],
                                hkv, scale, m, stride, None)

    def l3_bwd(qq, o, lse_q, dd, kv_all, m):
        parts = list(llama3._rank_bwd(
            qq, o, lse_q, dd, lambda i: kv_all[:, :, i:i + stride], hkv,
            scale, m, stride, None))
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1),
                torch.cat([p[2] for p in parts], dim=1))

    outs, lses, dqs = [], [], []
    dkv = torch.zeros((2, 1, hkv, s, d), dtype=torch.float32, device=dev)
    for r in range(world):
        m = l3_mask._replace(offset=r * t)
        o, lse_r = l3_fwd(qs[r], kv, m)
        dq_r, dk_r, dv_r = l3_bwd(qs[r], o, lse_r, douts[r], kv, m)
        outs.append(o)
        lses.append(lse_r)
        dqs.append(dq_r)
        dkv[0].add_(dk_r)
        dkv[1].add_(dv_r)
    got = (torch.cat(outs, dim=2), torch.cat(lses, dim=2),
           torch.cat(dqs, dim=2), dkv[0], dkv[1])
    hold(f"llama3 W={world} S={s} causal softcap ALiBi, heads_k_stride "
         f"{stride}", got, ref)
    with uncounted():
        times["llama3 softcap alibi"] = {
            "fwd_ms": [_events_ms(torch, lambda r=r: l3_fwd(
                qs[r], kv, l3_mask._replace(offset=r * t)), 3)
                for r in range(world)]}
    del ref, got, outs, lses, dqs, dkv, kv, qs, douts, q, k, v, dout
    torch.cuda.empty_cache()

    # llama3's last rank of W=8 with ALiBi: 65536 gathered keys at offset
    # 57344 (B1, then B3a/B3b past the fused kernel's limit); ALiBi's bias
    # reaches some 8e4 there, against the plain versions on the last rows
    s8, rank = 8 * t, 7
    q7, dout7 = rnd(1, hq, t, d), rnd(1, hq, t, d)
    k8, v8 = rnd(1, hkv, s8, d), rnd(1, hkv, s8, d)
    offset = rank * t
    mask7 = MaskArgs(causal=True, offset=offset, alibi_slopes=slopes)
    kv8 = torch.stack([k8, v8])
    split = flash_bwd_dq_cuda.xform_launches, flash_bwd_dkv_cuda.xform_launches
    out7, lse7 = l3_fwd(q7, kv8, mask7)
    dq7, dk7, dv7 = l3_bwd(q7, out7, lse7, dout7, kv8, mask7)
    ran_split = (flash_bwd_dq_cuda.xform_launches - split[0],
                 flash_bwd_dkv_cuda.xform_launches - split[1])
    delta7 = compute_delta(dout7, out7)
    rows = mask7._replace(offset=offset + t - tail)
    p_out, p_lse = naive_block_fwd(q7[:, :, -tail:], k8, v8, scale, rows)
    p_dq = naive_block_bwd(dout7[:, :, -tail:], q7[:, :, -tail:], k8, v8,
                           lse7[:, :, -tail:], delta7[:, :, -tail:], scale,
                           rows)[0]
    _, p_dk, p_dv = naive_block_bwd(dout7, q7, k8[:, :, keys], v8[:, :, keys],
                                    lse7, delta7, scale, mask7)
    errs = [_rel_err(out7[:, :, -tail:], p_out),
            max_err(lse7[:, :, -tail:], p_lse),
            _rel_err(dq7[:, :, -tail:], p_dq), _rel_err(dk7[:, :, keys], p_dk),
            _rel_err(dv7[:, :, keys], p_dv)]
    finite = all(bool(torch.isfinite(x).all())
                 for x in (out7, lse7, dq7, dk7, dv7))
    log(f"  llama3 W=8 rank 7 with ALiBi ({s8} keys, offset {offset}): "
        f"B3a/B3b XFORM launched {ran_split}; vs plain on the last {tail} "
        f"rows: out {errs[0]:.3e}, lse {errs[1]:.3e}, dq {errs[2]:.2e}; dk, "
        f"dv of the first {tail} keys {errs[3]:.2e} {errs[4]:.2e}; finite "
        f"{finite}")
    if not (finite and ran_split == (hkv // stride,) * 2
            and errs[0] <= RING_OUT_REL_TOL and errs[1] <= RING_LSE_TOL
            and max(errs[2:]) <= BWD_REL_TOL):
        raise AssertionError("llama3's last rank of W=8 with ALiBi is wrong")
    del q7, dout7, k8, v8, kv8, out7, lse7, delta7, dq7, dk7, dv7
    del p_out, p_lse, p_dq, p_dk, p_dv
    torch.cuda.empty_cache()
    xform_path = read()
    log(f"  launches on the xform path: {xform_path}")
    if min(xform_path[0].values()) == 0 or min(xform_path[1].values()) == 0:
        raise AssertionError(f"a kernel of the xform path never ran: "
                             f"{xform_path}")

    # (e) zigzag varlen at W=4 on 32768 packed tokens: 4 x 8192 and the
    # reference's packings x 4 (every length divisible by 2W), without a
    # transform and with ALiBi: every rank's steps through the module's
    # step masks, forward and backward, against flash_attn_varlen_func on
    # the whole packing (the ranks' results put back in global order) and
    # the plain versions on each rank's last 512 local rows against every
    # key
    zero()
    packings = [[0, 8192, 16384, 24576, 32768]] + [
        [4 * x for x in cu] for cu in VARLEN_PACKINGS]
    q, k, v, dout = (rnd(s, hq, d), rnd(s, hkv, d), rnd(s, hkv, d),
                     rnd(s, hq, d))
    zz_times = {}
    for cu in packings:
        cu_local = [x // world for x in cu]
        seg_all = cu_seqlens_to_segids(cu, s, dev)
        pos_all = cu_seqlens_to_positions(cu, s, dev)
        index = [extract_local_zigzag_varlen(
            torch.arange(s, device=dev), cu, r, world) for r in range(world)]
        loc = [[x[idx].transpose(0, 1)[None].contiguous() for idx in index]
               for x in (q, k, v, dout)]
        qs, ks, vs, douts = loc
        for kind in ("none", "alibi"):
            extras = dict(alibi_slopes=slopes if kind == "alibi" else None)
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            with uncounted():
                ref_o, ref_lse, _ = api.flash_attn_varlen_func(
                    *leaves, torch.tensor(cu, device=dev), causal=True,
                    return_attn_probs=True, **extras)
                ref_g = torch.autograd.grad(ref_o, leaves, dout)
            masks = [zigzag_varlen.varlen_step_masks(
                *zigzag_varlen_info([x // 2 for x in cu_local], s // world,
                                    r, world, dev), extras)
                for r in range(world)]
            res = [_zigzag_rank_fwd(qs, ks, vs, r, scale, masks[r])
                   for r in range(world)]
            outs, lses = [o for o, _ in res], [x for _, x in res]
            dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                                device=dev) for x in ks]
            dqs = [_zigzag_rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, r,
                                    scale, masks[r]) for r in range(world)]
            worst_r = [0.0] * 6
            for r in range(world):
                idx = index[r]
                want = [x[idx].transpose(0, 1)[None] for x in (
                    ref_o, ref_g[0], ref_g[1], ref_g[2])]
                ro = _rel_err(outs[r].float(), want[0].float())
                el = max_err(lses[r], ref_lse[:, idx][None])
                rel = [_rel_err(x, w.float()) for x, w in zip(
                    (dqs[r], dkvs[r][0], dkvs[r][1]), want[1:])]
                # the plain versions: the rank's last local rows against
                # every key of the packing
                rows = idx[-tail:]
                pmask = MaskArgs(causal=True, q_segids=seg_all[rows],
                                 kv_segids=seg_all, q_pos=pos_all[rows],
                                 kv_pos=pos_all, **extras)
                qr_ = q[rows].transpose(0, 1)[None]
                dr_ = dout[rows].transpose(0, 1)[None]
                kk_, vv_ = (x.transpose(0, 1)[None] for x in (k, v))
                p_out, p_lse = naive_block_fwd(qr_, kk_, vv_, scale, pmask)
                p_dq = naive_block_bwd(
                    dr_, qr_, kk_, vv_, lses[r][:, :, -tail:],
                    compute_delta(douts[r][:, :, -tail:],
                                  outs[r][:, :, -tail:]),
                    scale, pmask)[0]
                po = _rel_err(outs[r][:, :, -tail:].float(), p_out)
                pl = max_err(lses[r][:, :, -tail:], p_lse)
                pq = _rel_err(dqs[r][:, :, -tail:], p_dq)
                worst_r = [max(a, b_) for a, b_ in zip(
                    worst_r, (max(ro, po), max(el, pl), max(rel[0], pq),
                              rel[1], rel[2], 0.0))]
                if (max(ro, po) > RING_OUT_REL_TOL
                        or max(el, pl) > RING_LSE_TOL
                        or max(*rel, pq) > BWD_REL_TOL):
                    raise AssertionError(
                        f"zigzag varlen {cu} {kind} rank {r}: out {ro:.2e} "
                        f"/{po:.2e} lse {el:.2e}/{pl:.2e} grads {rel} "
                        f"plain dq {pq:.2e}")
                if not bool(torch.isfinite(outs[r]).all()):
                    raise AssertionError(f"zigzag varlen {cu}: non-finite")
            log(f"    zigzag varlen W={world} {cu} {kind}: every rank within "
                f"the limits of flash_attn_varlen_func on the whole packing "
                f"and of the plain versions on its last {tail} rows (worst "
                f"out {worst_r[0]:.2e}, lse {worst_r[1]:.2e}, dq "
                f"{worst_r[2]:.2e}, dk {worst_r[3]:.2e}, dv {worst_r[4]:.2e})")
            key = f"{cu} {kind}"
            with uncounted():
                zz_times[key] = {
                    "fwd_ms": [_events_ms(torch, lambda r=r: _zigzag_rank_fwd(
                        qs, ks, vs, r, scale, masks[r]), 3)
                        for r in range(world)],
                    "bwd_ms": [_events_ms(torch, lambda r=r: _zigzag_rank_bwd(
                        qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                        masks[r]), 2) for r in range(world)]}
            log(f"    zigzag varlen {key} per rank: forward " + " ".join(
                f"{x:.3f}" for x in zz_times[key]["fwd_ms"])
                + " ms, backward " + " ".join(
                f"{x:.3f}" for x in zz_times[key]["bwd_ms"]) + " ms")
            del res, outs, lses, dkvs, dqs, ref_o, ref_lse, ref_g, leaves
            torch.cuda.empty_cache()
        del loc, qs, ks, vs, douts
    # the entry point itself at W=1 on the first packing, with ALiBi,
    # forward and backward with deterministic (B3a/B3b)
    cu = packings[0]
    cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
    idx = extract_local_zigzag_varlen(torch.arange(s, device=dev), cu, 0, 1)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    with uncounted():
        want = api.flash_attn_varlen_func(*leaves, cu_t, causal=True,
                                          alibi_slopes=slopes)
        want = [x[idx] for x in (want.detach(), *torch.autograd.grad(
            want, leaves, dout))]
    leaves = [x[idx].detach().clone().requires_grad_() for x in (q, k, v)]
    got = api.zigzag_ring_flash_attn_varlen_func(
        *leaves, cu_t, causal=True, alibi_slopes=slopes, deterministic=True)
    got = (got.detach(), *torch.autograd.grad(got, leaves, dout[idx]))
    errs = [_rel_err(x.float(), w.float()) for x, w in zip(got, want)]
    log(f"    zigzag_ring_flash_attn_varlen_func W=1 on {cu} with ALiBi, "
        f"deterministic: out, dq, dk, dv " + " ".join(
            f"{x:.2e}" for x in errs) + " of max|flash_attn_varlen_func|")
    if errs[0] > RING_OUT_REL_TOL or max(errs[1:]) > BWD_REL_TOL:
        raise AssertionError("zigzag varlen's entry point at W=1 is wrong")
    del leaves
    zz_path = read()
    log(f"  launches on the zigzag_varlen path: {zz_path}")
    if min(zz_path[0].values()) == 0 or min(zz_path[1].values()) == 0:
        raise AssertionError(f"a kernel of the zigzag_varlen path never "
                             f"ran: {zz_path}")
    del q, k, v, dout, got, want
    torch.cuda.empty_cache()

    # the XFORM instantiations' entries: the headline reading is causal
    # with ALiBi (SDPA with the bias computes the same function), with the
    # softcap and both-transform readings, the packing's and the same
    # kernel without a transform beside it
    sources = {"B1": "flash_fwd.cuh", "B2": "flash_bwd.cuh",
               "B3a": "flash_bwd_split.cu", "B3b": "flash_bwd.cuh"}
    replaces = {"B1": "ring_flash_attn_tpu/ops/pallas_fwd.py:161",
                "B2": "ring_flash_attn_tpu/ops/pallas_bwd_fused.py:59",
                "B3a": "ring_flash_attn_tpu/ops/pallas_bwd.py:56",
                "B3b": "ring_flash_attn_tpu/ops/pallas_bwd.py:256"}
    entries = []
    for base in XFORM_KERNELS:
        short = base.split()[0]
        name = base + " XFORM"
        tk = timed[short]
        head = tk["causal"]["alibi"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "ring_flash_attn_tpu_torch/csrc/" + sources[short],
            "replaces": replaces[short],
            "shape": "q (1,32,8192,128) kv (1,8,8192,128) bf16 causal, "
                     "ALiBi on the standard slopes of 32 heads",
            "launches": xform_path[1][name],
            "launches_by_path": {"xform": xform_path[1][name],
                                 "zigzag_varlen": zz_path[1][name]},
            "max_abs_err": worst[short][0], "max_rel_err": worst[short][1],
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": plain["fwd" if short == "B1" else "bwd"],
            "bound_ms": head["bound_ms"], "bound_by": "operations",
            "library_ms": head["library_ms"],
            "library": "F.scaled_dot_product_attention with the ALiBi bias "
                       "as a dense float mask, kv repeated to 32 heads",
            "softcap_library_ms": "none",
            "by_transform": tk,
        })
        if short == "B1":
            entries[-1]["max_lse_err"] = worst["B1"][2]
    return (entries, {"xform": xform_path[0], "zigzag_varlen": zz_path[0]},
            {"w4_per_rank_xform_ms": times,
             "w4_per_rank_zigzag_varlen_ms": zz_times})


# Mistral-7B-v0.1's attention, from its published config.json: hidden_size
# 4096 over num_attention_heads 32 (head_dim 128), num_key_value_heads 8,
# sliding_window 4096: the widths of the window/dropout slice's path
MISTRAL_ATTN = dict(heads=32, kv_heads=8, head_dim=128, sliding_window=4096)
# the attention dropout of the GPT-2 (attn_pdrop) and BERT
# (attention_probs_dropout_prob) configs
ATTN_PDROP = 0.1


def band_pairs(s, wl):
    """The (q, key) pairs of one head that a causal window of ``wl`` keeps
    over ``s`` tokens: row i sees min(i, wl) + 1 keys."""
    w = min(wl, s - 1)
    return w * (w + 1) // 2 + (s - w) * (w + 1)


def _tail_check(torch, what, q, k, v, dout, mask, scale, tail, counters):
    """B1, B2 and B3a/B3b on the last ``tail`` rows of q (B, Hq, S, D) over
    every key against the plain versions, bf16 on the card, their launches
    left out of ``counters``; raises past the limits. Returns (the worst
    errors {kernel: [abs, rel(, lse)]}, the plain (out, lse, dq))."""
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)

    bf16 = torch.bfloat16
    n = q.shape[2]
    m = mask._replace(offset=k.shape[2] - tail)
    qt, dt = (x[:, :, -tail:].contiguous() for x in (q, dout))
    with _uncounted(counters):
        out, lse = flash_fwd_cuda(qt, k, v, scale, m, out_dtype=bf16)
        o32, l32 = flash_fwd_cuda(qt, k, v, scale, m)
    ro, rl = naive_block_fwd(qt, k, v, scale, m)
    w = {"B1": [max_err(o32, ro), rel_err_rows(o32, ro),
                max_err(l32, rl)]}
    delta = compute_delta(dt, out)
    ref = naive_block_bwd(dt, qt, k, v, lse, delta, scale, m)
    for name, bwd in (("B2", flash_bwd_cuda),
                      ("B3", flash_bwd_split_cuda)):
        with _uncounted(counters):
            got = bwd(dt, qt, k, v, lse, delta, scale, m)
        rel = [_rel_err(x, r) for x, r in zip(got, ref)]
        if name == "B2":
            w["B2"] = [max(max_err(x, r) for x, r in zip(got, ref)),
                       max(rel)]
        else:
            w["B3a"] = [max_err(got[0], ref[0]), rel[0]]
            w["B3b"] = [max(max_err(got[1], ref[1]),
                            max_err(got[2], ref[2])), max(rel[1:])]
        del got
    log(f"    {what}, last {tail} rows of {n} over {k.shape[2]} keys: "
        f"B1 out {w['B1'][0]:.3e} (by rows {w['B1'][1]:.3e}) lse "
        f"{w['B1'][2]:.3e}; rel dq, dk, dv: B2 {w['B2'][1]:.2e}, B3a "
        f"{w['B3a'][1]:.2e}, B3b {w['B3b'][1]:.2e}")
    if (w["B1"][0] > B1_OUT_TOL or w["B1"][1] > RING_OUT_REL_TOL
            or w["B1"][2] > B1_LSE_TOL
            or max(w[x][1] for x in ("B2", "B3a", "B3b")) > BWD_REL_TOL):
        raise AssertionError(f"{what}: past the limits {w}")
    plain = (ro, rl, ref[0])
    del out, lse, o32, l32, delta, ref
    torch.cuda.empty_cache()
    return w, plain


def phase_band(torch, flush):
    """Phase 18: windows and dropout in B1, B2, B3a/B3b (their BAND
    instantiations) and on every entry point that takes them. Returns (the
    BAND instantiations' kernel entries, {"band": {kernel: launches}},
    times)."""
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.ops.flash import (
        block_bwd, block_fwd, compute_delta, flash_attention)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.ops.varlen import (
        extract_local_ring_varlen, extract_local_zigzag_varlen,
        ring_varlen_info, zigzag_varlen_info)
    from ring_flash_attn_tpu_torch.parallel import (
        layouts, llama3, ring, ring_varlen, stripe, zigzag, zigzag_varlen)

    log("== phase 18: windows and dropout in B1, B2, B3a/B3b (BAND) and "
        "the entry points with them")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    bf16 = torch.bfloat16
    hq, hkv, d = (MISTRAL_ATTN[x] for x in ("heads", "kv_heads", "head_dim"))
    wl = MISTRAL_ATTN["sliding_window"]
    s, sd, tail, world = 32768, 8192, 512, 4
    scale = d ** -0.5
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def uncounted():
        return _uncounted(counters)

    # (a) the tile edges, then the full width's last 512 rows over every
    # key (causal window at offset S - 512) and dropout's at S = 8192
    worst = {"B1": [0.0, 0.0, 0.0], "B2": [0.0, 0.0], "B3a": [0.0, 0.0],
             "B3b": [0.0, 0.0]}

    def keep_worst(w):
        for key, errs in w.items():
            worst[key] = [max(a, b) for a, b in zip(worst[key], errs)]

    with uncounted():
        for case in range(len(BAND_EDGE_CASES)):
            keep_worst(band_case_check(torch, case))
    log(f"  (a) {len(BAND_EDGE_CASES)} tile-edge cases (both calling modes, "
        f"D 64 and 128, with and without segments) within the limits; "
        f"worst {worst}")

    def tail_check(what, q, k, v, dout, mask):
        w, plain = _tail_check(torch, what, q, k, v, dout, mask, scale, tail,
                               counters)
        keep_worst(w)
        return plain

    q, k, v, dout = (rnd(1, hq, s, d), rnd(1, hkv, s, d), rnd(1, hkv, s, d),
                     rnd(1, hq, s, d))
    win = MaskArgs(causal=True, window_left=wl)
    plain_win = tail_check(f"window ({wl}, 0) S={s}", q, k, v, dout, win)
    qd, kd, vd, dd = (x[:, :, :sd].contiguous() for x in (q, k, v, dout))
    drop = MaskArgs(causal=True, dropout_p=ATTN_PDROP, dropout_seed=1234)
    plain_drop = tail_check(f"dropout {ATTN_PDROP} S={sd}", qd, kd, vd, dd,
                            drop)
    tail_check(f"window ({wl}, 0) and dropout S={sd}", qd, kd, vd, dd,
               drop._replace(window_left=wl))

    # (b) the keep mask bit for bit: B1 with v the identity, B2 and B3b
    # with dout the identity
    with uncounted():
        keep = band_keep_checks(torch)
    bad = [what for what, ok in keep if not ok]
    log(f"  (b) keep mask bit for bit against the plain one: "
        f"{len(keep) - len(bad)} of {len(keep)} checks agree")
    if bad:
        raise AssertionError(f"the kernels' keep mask differs: {bad}")

    # (c) the times: each kernel windowed at the full width beside its band
    # bound and the causal mask-free kernel at the same shape; with dropout
    # at S = 8192 beside the same kernel without it; SDPA with the dense
    # band mask and with dropout (its own random bits: the same work, not
    # the same mask)
    products = {"B1": 2, "B2": 5, "B3a": 3, "B3b": 4}

    def time_set(q, k, v, dout, mask, pairs):
        out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
        delta = compute_delta(dout, out)
        fns = {
            "B1": lambda: flash_fwd_cuda(q, k, v, scale, mask,
                                         out_dtype=bf16),
            "B2": lambda: flash_bwd_cuda(dout, q, k, v, lse, None, scale,
                                         mask, out=out, dq_dtype=bf16,
                                         dkv_dtype=bf16),
            "B3a": lambda: flash_bwd_dq_cuda(dout, q, k, v, lse, delta,
                                             scale, mask, dq_dtype=bf16),
            "B3b": lambda: flash_bwd_dkv_cuda(dout, q, k, v, lse, delta,
                                              scale, mask, dkv_dtype=bf16),
        }
        res = {}
        for name, fn in fns.items():
            r = kernel_ms(torch, fn, 5, flush)
            bound = products[name] * 2 * hq * d * pairs / H100_BF16_FLOPS
            res[name] = dict(ms=r["ms"], device_ms=r["device_ms"],
                             bound_ms=bound * 1e3)
        del out, lse, delta
        torch.cuda.empty_cache()
        return res

    timed = {}
    with uncounted():
        timed["window"] = time_set(q, k, v, dout, win, band_pairs(s, wl))
        timed["causal"] = time_set(q, k, v, dout, MaskArgs(causal=True),
                                   s * (s + 1) // 2)
        timed["dropout"] = time_set(qd, kd, vd, dd, drop, sd * (sd + 1) // 2)
        timed["causal 8192"] = time_set(qd, kd, vd, dd, MaskArgs(causal=True),
                                        sd * (sd + 1) // 2)
    for name in products:
        w_, c_, dr, c8 = (timed[x][name] for x in (
            "window", "causal", "dropout", "causal 8192"))
        log(f"  {name}: window ({wl}, 0) S={s} {w_['ms']:.3f} ms (device "
            f"{w_['device_ms']:.3f}), band bound {w_['bound_ms']:.3f} ms "
            f"({w_['ms'] / w_['bound_ms']:.2f}x), causal without the window "
            f"{c_['ms']:.3f} ms ({w_['ms'] / c_['ms']:.2f} of it); dropout "
            f"{ATTN_PDROP} S={sd} {dr['ms']:.3f} ms against "
            f"{c8['ms']:.3f} without ({dr['ms'] / c8['ms']:.2f}x), bound "
            f"{dr['bound_ms']:.3f} ms")
    # SDPA with the dense band mask, kv repeated to 32 heads, at the
    # largest S of 32768, 16384, 8192 that it runs at; and SDPA causal with
    # dropout at S = 8192
    library = {"band_S": None, "band_fwd": None, "band_bwd": None}
    for n in (s, s // 2, s // 4):
        try:
            qn, kn, vn = (x[:, :, :n].repeat_interleave(hq // x.shape[1],
                                                        dim=1)
                          for x in (q, k, v))
            i = torch.arange(n, dtype=torch.int32, device=dev)
            band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 <= wl)
            lf = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qn, kn, vn, attn_mask=band), 3, flush)
            leaves = [x.detach().requires_grad_() for x in (qn, kn, vn)]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=band)
            dn = dout[:, :, :n]
            lb = cuda_ms(torch, lambda: torch.autograd.grad(
                o, leaves, dn, retain_graph=True), 3, flush)
            library = {"band_S": n, "band_fwd": lf, "band_bwd": lb}
            del o, leaves
            break
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            log(f"  SDPA with the dense band mask at S={n}: "
                f"{str(e).splitlines()[0][:120]}")
        finally:
            qn = kn = vn = band = i = None
            torch.cuda.empty_cache()
    qr, kr, vr = (x.repeat_interleave(hq // x.shape[1], dim=1)
                  for x in (qd, kd, vd))
    library["dropout_fwd"] = cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True, dropout_p=ATTN_PDROP), 3, flush)
    leaves = [x.detach().requires_grad_() for x in (qr, kr, vr)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       dropout_p=ATTN_PDROP)
    library["dropout_bwd"] = cuda_ms(torch, lambda: torch.autograd.grad(
        o, leaves, dd, retain_graph=True), 3, flush)
    del o, leaves, qr, kr, vr
    torch.cuda.empty_cache()
    log(f"  SDPA with the dense band mask at S={library['band_S']}: forward "
        f"{library['band_fwd']} ms, backward {library['band_bwd']} ms; SDPA "
        f"causal with dropout {ATTN_PDROP} at S={sd}: forward "
        f"{library['dropout_fwd']:.3f} ms, backward "
        f"{library['dropout_bwd']:.3f} ms")
    # the plain versions' times, window (4096, 0) at S = 8192
    wm = win
    out, lse = flash_fwd_cuda(qd, kd, vd, scale, wm, out_dtype=bf16)
    delta = compute_delta(dd, out)
    plain_ms = {"fwd": cuda_ms(torch, lambda: naive_block_fwd(
        qd, kd, vd, scale, wm), 2, flush),
        "bwd": cuda_ms(torch, lambda: naive_block_bwd(
            dd, qd, kd, vd, lse, delta, scale, wm), 2, flush)}
    log(f"  plain versions, window ({wl}, 0) at S={sd}: forward "
        f"{plain_ms['fwd']:.3f} ms, backward {plain_ms['bwd']:.3f} ms")
    del out, lse, delta
    torch.cuda.empty_cache()

    # (d) the band path: the entry points and the schedules' ranks, their
    # launches counted, the references' not
    for fn in counters.values():
        fn.launches = fn.band_launches = 0

    def hold(what, got, ref, parts=world):
        """(out, lse, dq, dk, dv) against the whole-sequence kernel's."""
        errs = [_rel_err_parts(got[0], ref[0], parts), max_err(got[1],
                                                              ref[1])]
        rel = [_rel_err(x, r) for x, r in zip(got[2:], ref[2:])]
        log(f"    {what}: out of max|ref| by parts {errs[0]:.3e}, lse "
            f"{errs[1]:.3e}, rel dq dk dv " + " ".join(
                f"{x:.2e}" for x in rel))
        if (errs[0] > RING_OUT_REL_TOL or errs[1] > RING_LSE_TOL
                or max(rel) > BWD_REL_TOL):
            raise AssertionError(f"{what} is wrong")

    # (d1) flash_attn_func with the window at the full width, forward and
    # backward (B2, and B3a/B3b with deterministic), and with dropout at S
    # = 8192: the last rows against the plain versions of (a)
    for det in (False, True):
        for (x, dx, kw, plain, n) in (
                ((q, k, v), dout, dict(window_size=(wl, 0)), plain_win, s),
                ((qd, kd, vd), dd, dict(dropout_p=ATTN_PDROP,
                                        dropout_seed=1234), plain_drop, sd)):
            leaves = [y.transpose(1, 2).detach().clone().requires_grad_()
                      for y in x]
            o, lse_a, _ = api.flash_attn_func(
                *leaves, causal=True, return_attn_probs=True,
                deterministic=det, **kw)
            g = torch.autograd.grad(o, leaves, dx.transpose(1, 2))
            got = (o.detach().transpose(1, 2)[:, :, -tail:],
                   lse_a[:, :, -tail:], g[0].transpose(1, 2)[:, :, -tail:])
            errs = (max_err(got[0], plain[0]), rel_err_rows(got[0], plain[0]),
                    max_err(got[1], plain[1]), _rel_err(got[2], plain[2]))
            log(f"    flash_attn_func {kw} S={n} deterministic={det}: last "
                f"{tail} rows against the plain versions: out {errs[0]:.3e} "
                f"(rows {errs[1]:.3e}), lse {errs[2]:.3e}, dq {errs[3]:.2e}")
            if (errs[0] > B1_OUT_TOL or errs[1] > RING_OUT_REL_TOL
                    or errs[2] > B1_LSE_TOL or errs[3] > BWD_REL_TOL
                    or not all(bool(torch.isfinite(y).all()) for y in g)):
                raise AssertionError(f"flash_attn_func {kw} is wrong")
            del leaves, o, lse_a, g, got
    torch.cuda.empty_cache()

    # (d2) ring, zigzag and stripe at W=4 on one card, window (4096, 0):
    # every rank's steps through the modules' own step masks (the kv of
    # each source rank handed in), against B1/B2 with the window on the
    # whole sequence; the ring's steps 2 and 3 launch nothing
    with uncounted():
        ref_o, ref_l = block_fwd(q, k, v, scale, win, out_dtype=bf16)
        ref_g = block_bwd(dout, q, k, v, ref_l, None, scale, win, out=ref_o)
    ref = (ref_o, ref_l, *ref_g)
    extras = dict(window_left=wl)
    layouts_of = {
        "ring": (lambda x: [c.contiguous() for c in x.chunk(world, dim=2)],
                 lambda parts: torch.cat(parts, dim=2)),
        "zigzag": (lambda x: [layouts.extract_local_zigzag(
            x, r, world, axis=2).contiguous() for r in range(world)],
            lambda parts: layouts.restore_zigzag(
                torch.cat(parts, dim=2), world, axis=2)),
        "stripe": (lambda x: [layouts.extract_local_stripe(
            x, r, world, axis=2).contiguous() for r in range(world)],
            lambda parts: layouts.restore_stripe(
                torch.cat(parts, dim=2), world, axis=2)),
    }
    ring_blocks = []
    for sched, (split, join) in layouts_of.items():
        qs, ks, vs, douts = (split(x) for x in (q, k, v, dout))
        ll = qs[0].shape[2]
        if sched == "zigzag":
            step_masks = zigzag._batch_masks(ll // 2, extras, dev)
            rank_fwd, rank_bwd = _zigzag_rank_fwd, _zigzag_rank_bwd
        else:
            step_masks = (ring._ring_masks(True, ll, extras)
                          if sched == "ring"
                          else stripe._step_masks(extras, ll, dev))
            rank_fwd, rank_bwd = _rank_fwd, _rank_bwd
        res = []
        for r in range(world):
            before = (flash_fwd_cuda.launches, flash_bwd_cuda.launches)
            res.append(rank_fwd(qs, ks, vs, r, scale, step_masks))
            if sched == "ring":
                ring_blocks.append([flash_fwd_cuda.launches - before[0]])
        outs, lses = [o for o, _ in res], [x for _, x in res]
        dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                            device=dev) for x in ks]
        dqs = []
        for r in range(world):
            before = flash_bwd_cuda.launches
            dqs.append(rank_bwd(qs, ks, vs, douts, outs, lses, dkvs, r,
                                scale, step_masks))
            if sched == "ring":
                ring_blocks[r].append(flash_bwd_cuda.launches - before)
        got = (join(outs), join(lses), join(dqs), join([x[0] for x in dkvs]),
               join([x[1] for x in dkvs]))
        hold(f"{sched} W={world} S={s} window ({wl}, 0)", got, ref)
        del res, outs, lses, dkvs, dqs, got, qs, ks, vs, douts
        torch.cuda.empty_cache()
    want_blocks = [[min(r, 1) + 1] * 2 for r in range(world)]
    log(f"    ring's blocks launched per rank (forward, backward): "
        f"{ring_blocks}; steps 2 and 3 lie past the window")
    if ring_blocks != want_blocks:
        raise AssertionError(f"the ring launched {ring_blocks}, not "
                             f"{want_blocks}")

    # (d3) llama3 at W=4 (heads_k_stride 4) and its last rank of W=8 at
    # 65536 keys (B3a/B3b past the fused kernel's limit) with the window
    stride, t = 4, s // world
    kv = torch.stack([k, v])
    qs, douts = ([c.contiguous() for c in x.chunk(world, dim=2)]
                 for x in (q, dout))

    def l3_fwd(qq, kv_all, m):
        return llama3._rank_fwd(qq, lambda i: kv_all[:, :, i:i + stride],
                                hkv, scale, m, stride, None)

    def l3_bwd(qq, o, lse_q, dd_, kv_all, m):
        parts = list(llama3._rank_bwd(
            qq, o, lse_q, dd_, lambda i: kv_all[:, :, i:i + stride], hkv,
            scale, m, stride, None))
        return [torch.cat([p[i] for p in parts], dim=1) for i in range(3)]

    outs, lses, dqs = [], [], []
    dkv = torch.zeros((2, 1, hkv, s, d), dtype=torch.float32, device=dev)
    for r in range(world):
        m = win._replace(offset=r * t)
        o, lse_r = l3_fwd(qs[r], kv, m)
        dq_r, dk_r, dv_r = l3_bwd(qs[r], o, lse_r, douts[r], kv, m)
        outs.append(o)
        lses.append(lse_r)
        dqs.append(dq_r)
        dkv[0].add_(dk_r)
        dkv[1].add_(dv_r)
    hold(f"llama3 W={world} S={s} window ({wl}, 0), heads_k_stride {stride}",
         (torch.cat(outs, dim=2), torch.cat(lses, dim=2),
          torch.cat(dqs, dim=2), dkv[0], dkv[1]), ref)
    del outs, lses, dqs, dkv, kv, qs, douts, ref, ref_o, ref_l, ref_g
    torch.cuda.empty_cache()
    s8 = 8 * sd
    q7, d7 = rnd(1, hq, sd, d), rnd(1, hq, sd, d)
    k8, v8 = rnd(1, hkv, s8, d), rnd(1, hkv, s8, d)
    m7 = win._replace(offset=7 * sd)
    split = flash_bwd_dq_cuda.band_launches, flash_bwd_dkv_cuda.band_launches
    o7, l7 = l3_fwd(q7, torch.stack([k8, v8]), m7)
    g7 = l3_bwd(q7, o7, l7, d7, torch.stack([k8, v8]), m7)
    ran_split = (flash_bwd_dq_cuda.band_launches - split[0],
                 flash_bwd_dkv_cuda.band_launches - split[1])
    with uncounted():
        r7o, r7l = block_fwd(q7, k8, v8, scale, m7, out_dtype=bf16)
        r7g = block_bwd(d7, q7, k8, v8, r7l, None, scale, m7, out=r7o,
                        fused=False)
    hold(f"llama3 W=8 rank 7 ({s8} keys) window ({wl}, 0), B3a/B3b "
         f"launched {ran_split}", (o7, l7, *g7), (r7o, r7l, *r7g), parts=1)
    if ran_split != (hkv // stride,) * 2:
        raise AssertionError(f"llama3's last rank ran B3a/B3b {ran_split}")
    del q7, d7, k8, v8, o7, l7, g7, r7o, r7l, r7g
    torch.cuda.empty_cache()

    # (d4) ring varlen and zigzag varlen at W=4 on the four packings x 4
    # with the window on the sequences' positions, every rank through the
    # modules' step masks, against flash_attn_varlen_func on the whole
    # packing (the ranks' results put back in global order)
    qv, kv_, vv, dv_ = (x[0].transpose(0, 1).contiguous()
                        for x in (q, k, v, dout))
    for cu in ([4 * x for x in c] for c in VARLEN_PACKINGS):
        cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
        leaves = [x.detach().clone().requires_grad_() for x in (qv, kv_, vv)]
        with uncounted():
            r_o, r_l, _ = api.flash_attn_varlen_func(
                *leaves, cu_t, causal=True, window_size=(wl, 0),
                return_attn_probs=True)
            r_g = torch.autograd.grad(r_o, leaves, dv_)
        for sched in ("ring_varlen", "zigzag_varlen"):
            if sched == "ring_varlen":
                index = [extract_local_ring_varlen(
                    torch.arange(s, device=dev), cu, r, world)
                    for r in range(world)]
                masks = [ring_varlen.varlen_step_masks(
                    *ring_varlen_info([x // world for x in cu], s // world,
                                      r, dev), True, extras)
                    for r in range(world)]
                fwd_, bwd_ = _rank_fwd, _rank_bwd
            else:
                index = [extract_local_zigzag_varlen(
                    torch.arange(s, device=dev), cu, r, world)
                    for r in range(world)]
                masks = [zigzag_varlen.varlen_step_masks(
                    *zigzag_varlen_info([x // (2 * world) for x in cu],
                                        s // world, r, world, dev), extras)
                    for r in range(world)]
                fwd_, bwd_ = _zigzag_rank_fwd, _zigzag_rank_bwd
            qs, ks, vs, douts = ([x[idx].transpose(0, 1)[None].contiguous()
                                  for idx in index]
                                 for x in (qv, kv_, vv, dv_))
            res = [fwd_(qs, ks, vs, r, scale, masks[r]) for r in range(world)]
            outs, lses = [o for o, _ in res], [x for _, x in res]
            dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                                device=dev) for x in ks]
            dqs = [bwd_(qs, ks, vs, douts, outs, lses, dkvs, r, scale,
                        masks[r]) for r in range(world)]
            perm = torch.cat(index)

            def back(parts):
                x = torch.cat([p[0].transpose(0, 1) for p in parts])
                y = torch.empty_like(x)
                y[perm] = x
                return y

            got = (back(outs), back([l_[..., None]
                                     for l_ in lses])[:, :, 0].t()[None],
                   back(dqs), back([x[0] for x in dkvs]),
                   back([x[1] for x in dkvs]))
            hold(f"{sched} W={world} {cu} window ({wl}, 0)", got,
                 (r_o.detach(), r_l[None], *r_g), parts=1)
            del res, outs, lses, dkvs, dqs, got, qs, ks, vs, douts
        del leaves, r_o, r_l, r_g
        torch.cuda.empty_cache()
    # (d5) Ulysses (4 head groups) and USP (2 head groups x a ring of 2)
    # with dropout at S = 32768, each process's heads with its global head
    # offset, against flash_attention with dropout on every head
    del qv, kv_, vv, dv_, qd, kd, vd, dd
    torch.cuda.empty_cache()
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    with uncounted():
        r_o, r_l = flash_attention(*leaves, scale, drop)
        r_g = torch.autograd.grad(r_o, leaves, dout)
    ref = (r_o.detach(), r_l, *r_g)
    gq, gk = hq // world, hkv // world
    outs, lses, dqs, dks, dvs = [], [], [], [], []
    for u in range(world):
        hs, ks_ = slice(u * gq, (u + 1) * gq), slice(u * gk, (u + 1) * gk)
        lv = [x[:, h].detach().clone().requires_grad_()
              for x, h in ((q, hs), (k, ks_), (v, ks_))]
        o, lse_u = flash_attention(*lv, scale,
                                   drop._replace(head_offset=u * gq))
        g = torch.autograd.grad(o, lv, dout[:, hs])
        outs.append(o.detach())
        lses.append(lse_u)
        dqs.append(g[0])
        dks.append(g[1])
        dvs.append(g[2])
    hold(f"Ulysses W={world} S={s} dropout {ATTN_PDROP}",
         tuple(torch.cat(x, dim=1) for x in (outs, lses, dqs, dks, dvs)),
         ref, parts=1)
    wu, wr = 2, 2
    gq, gk, ll = hq // wu, hkv // wu, s // wr
    outs, lses, dqs, dks, dvs = [], [], [], [], []
    for u in range(wu):
        hs, ks_ = slice(u * gq, (u + 1) * gq), slice(u * gk, (u + 1) * gk)
        qs, ks, vs, douts = ([c.contiguous() for c in x[:, h].chunk(wr, 2)]
                             for x, h in ((q, hs), (k, ks_), (v, ks_),
                                          (dout, hs)))
        step_mask = ring._ring_masks(True, ll, dict(
            dropout_p=ATTN_PDROP, dropout_seed=1234, head_offset=u * gq))
        res = [_rank_fwd(qs, ks, vs, r, scale, step_mask) for r in range(wr)]
        o_u, l_u = [o for o, _ in res], [x for _, x in res]
        dkvs = [torch.zeros((2,) + tuple(x.shape), dtype=torch.float32,
                            device=dev) for x in ks]
        dq_u = [_rank_bwd(qs, ks, vs, douts, o_u, l_u, dkvs, r, scale,
                          step_mask) for r in range(wr)]
        outs.append(torch.cat(o_u, dim=2))
        lses.append(torch.cat(l_u, dim=2))
        dqs.append(torch.cat(dq_u, dim=2))
        dks.append(torch.cat([x[0] for x in dkvs], dim=2))
        dvs.append(torch.cat([x[1] for x in dkvs], dim=2))
    hold(f"USP {wu} x {wr} (ring) S={s} dropout {ATTN_PDROP}",
         tuple(torch.cat(x, dim=1) for x in (outs, lses, dqs, dks, dvs)),
         ref, parts=wr)
    del leaves, ref, r_o, r_l, r_g, outs, lses, dqs, dks, dvs, qs, ks, vs
    del douts, res, dkvs, q, k, v, dout
    torch.cuda.empty_cache()

    band_path = ({n: fn.launches for n, fn in counters.items()},
                 {n + " BAND": fn.band_launches
                  for n, fn in counters.items()})
    log(f"  launches on the band path: {band_path}")
    if min(band_path[1].values()) == 0:
        raise AssertionError(f"a BAND kernel of the path never ran: "
                             f"{band_path}")

    sources = {"B1": "flash_fwd.cuh", "B2": "flash_bwd.cuh",
               "B3a": "flash_bwd_split.cu", "B3b": "flash_bwd.cuh"}
    replaces = {"B1": "ring_flash_attn_tpu/ops/pallas_fwd.py:161",
                "B2": "ring_flash_attn_tpu/ops/pallas_bwd_fused.py:59",
                "B3a": "ring_flash_attn_tpu/ops/pallas_bwd.py:56",
                "B3b": "ring_flash_attn_tpu/ops/pallas_bwd.py:256"}
    entries = []
    for base in XFORM_KERNELS:
        short = base.split()[0]
        name = base + " BAND"
        w_ = timed["window"][short]
        lib = library["band_fwd" if short == "B1" else "band_bwd"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "ring_flash_attn_tpu_torch/csrc/" + sources[short],
            "replaces": replaces[short],
            "shape": f"q (1,32,{s},128) kv (1,8,{s},128) bf16 causal, "
                     f"window ({wl}, 0): Mistral-7B-v0.1's attention",
            "launches": band_path[1][name],
            "max_abs_err": worst[short][0], "max_rel_err": worst[short][1],
            "ms": w_["ms"], "device_ms": w_["device_ms"],
            "plain_ms": plain_ms["fwd" if short == "B1" else "bwd"],
            "plain_shape": f"window ({wl}, 0) at S={sd}",
            "bound_ms": w_["bound_ms"], "bound_by": "operations",
            "library_ms": lib if library["band_S"] == s else None,
            "library": "F.scaled_dot_product_attention with the dense band "
                       "mask, kv repeated to 32 heads",
            "library_band_S": library["band_S"],
            "library_band_ms": lib,
            "causal_without_window_ms": timed["causal"][short]["ms"],
            "dropout": {"S": sd, "p": ATTN_PDROP,
                        "ms": timed["dropout"][short]["ms"],
                        "without_ms": timed["causal 8192"][short]["ms"],
                        "bound_ms": timed["dropout"][short]["bound_ms"],
                        "sdpa_dropout_ms": library[
                            "dropout_fwd" if short == "B1"
                            else "dropout_bwd"]},
        })
        if short == "B1":
            entries[-1]["max_lse_err"] = worst["B1"][2]
    return entries, {"band": band_path[0]}, {"band_times": timed,
                                             "band_library": library}


# ---------------------------------------------------------------------------
# Phases 19 to 21: the serving engine's options, the HF adapter's attention
# override and the GPipe pipeline, at full width
# ---------------------------------------------------------------------------

# phase 4's page pool: 64 pages of 256 tokens, 16 a lane, 4 lanes
SERVE_POOL = dict(num_pages=64, page_size=256, pages_per_seq=16, max_batch=4)


def _engine_run(torch, model, prompts, new_tokens, prefix_of=None, **kw):
    """Serve ``prompts`` ({rid: tokens}) on phase 4's pool with the
    engine's options ``kw``. Returns (outputs, {rid: the top-two logit
    margin over max|logit| of each token sampled for it}, [each step's
    wall s], the engine's stats with "lane_steps": the decode steps summed
    over the lanes, and "logits": {rid: [the logits each token was
    sampled from]}). Sample j of a request is its token j, with or
    without speculation (a verify samples its accepted rows in order);
    the margins line up with a request's tokens in an engine without
    speculation."""
    from ring_flash_attn_tpu_torch.models import ServingEngine

    eng = ServingEngine(model, device="cuda", **SERVE_POOL, **kw)
    for rid, p in prompts.items():
        eng.submit(rid, p, new_tokens, prefix_of=(prefix_of or {}).get(rid))
    margins, sampled = {}, {}
    sample = eng._sample

    def recording(req_id, logits):
        sampled.setdefault(req_id, []).append(np.asarray(logits, np.float32))
        top = np.partition(logits, -2)[-2:]
        margins.setdefault(req_id, []).append(
            float((top[1] - top[0]) / max(float(np.abs(logits).max()),
                                          1e-30)))
        return sample(req_id, logits)

    eng._sample = recording
    steps, lane_steps = [], 0
    while not eng.sched.idle:
        lane_steps += len(eng._pending)  # the lanes this step decodes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        if len(steps) > 400:
            raise RuntimeError("serving loop did not converge")
    return eng.outputs, margins, steps, dict(eng.stats,
                                             lane_steps=lane_steps,
                                             logits=sampled)


def _logits_agree(what, ref, ref_logits, got, got_logits):
    """Hold an engine's sampled logits against a reference engine's on the
    same requests: token j's logits against the reference's token j's, for
    every j up to and including the first token where the two engines'
    tokens part (their contexts are the same until there), within
    LOGITS_REL_TOL of max|reference| (phase 4's limit); raise past it.
    Returns (the worst error, the tokens held)."""
    worst, held = 0.0, 0
    for rid, want in ref.items():
        have = got[rid]
        part = next((i for i, (a, b) in enumerate(zip(want, have))
                     if a != b), min(len(want), len(have)) - 1)
        for j in range(min(part + 1, len(ref_logits[rid]),
                           len(got_logits[rid]))):
            a, b = got_logits[rid][j], ref_logits[rid][j]
            worst = max(worst, float(np.abs(a - b).max()
                                     / max(float(np.abs(b).max()), 1e-30)))
            held += 1
    log(f"    {what}: the logits of {held} sampled tokens (each request up "
        f"to its first parting) within {worst:.2e} of max|reference| (tol "
        f"{LOGITS_REL_TOL})")
    if worst > LOGITS_REL_TOL or held == 0:
        raise AssertionError(f"{what}: logits {worst} past the limit, or "
                             f"none held ({held})")
    return worst, held


def _parted(what, ref, margins, got):
    """Hold an engine's tokens against a reference engine's: where a
    request's tokens first part, the reference's top-two margin there must
    be under LOGITS_REL_TOL (phase 4's limit on |kernel - plain| /
    max|plain|: a near tie that the kernels' rounding may flip), else
    raise. Returns {rid: (index, margin)} of the requests that part."""
    parted = {}
    for rid, want in ref.items():
        have = got[rid]
        if len(have) != len(want):
            raise AssertionError(f"{what}: request {rid} has {len(have)} "
                                 f"tokens, the reference {len(want)}")
        i = next((i for i, (a, b) in enumerate(zip(want, have)) if a != b),
                 None)
        if i is not None:
            m = margins[rid]
            j = i - (len(want) - len(m))
            parted[rid] = (i, m[j] if 0 <= j < len(m) else float("inf"))
    same = sum(len(t) for t in got.values()) - sum(
        len(got[r]) - i for r, (i, _) in parted.items())
    # how often a parting could be excused at all: the reference's tokens
    # whose top-two margin is under the limit
    ties = [x < LOGITS_REL_TOL for m in margins.values() for x in m]
    log(f"    {what}: {same} of {sum(len(t) for t in got.values())} tokens "
        f"as the reference's before any parting; parted (request: index, "
        f"the reference's top-two margin there) {parted}; {sum(ties)} of "
        f"the reference's {len(ties)} sampled tokens have a margin under "
        f"{LOGITS_REL_TOL} (a parting there is excused)")
    bad = {r: x for r, x in parted.items() if not x[1] < LOGITS_REL_TOL}
    if bad:
        raise AssertionError(f"{what}: tokens part from the reference where "
                             f"its top two logits are apart: {bad}")
    return parted


@contextlib.contextmanager
def _checked_chunks(torch, counters, seen):
    """The serving module's flash_attention (each chunk of a chunked
    prefill: B1 causal at offset p_len over the lane's gathered pages)
    also held against its plain version, and against itself with the keys
    and values past the chunk's last kv tile set to NaN: those tiles lie
    past p_len + C and must be skipped, not computed."""
    from ring_flash_attn_tpu_torch.models import serve
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import KV_TILE
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_fwd

    real = serve.flash_attention

    def checked(q, k, v, scale, mask, backend=None):
        out, lse = real(q, k, v, scale, mask, backend=backend)
        with _uncounted(counters):
            ref_o, ref_l = naive_block_fwd(q, k, v, scale, mask)
            end = -(-((mask.offset or 0) + q.shape[2]) // KV_TILE) * KV_TILE
            skipped = None
            if end < k.shape[2] and q.is_cuda:  # the kernel's tiles
                kn, vn = k.clone(), v.clone()
                kn[:, :, end:] = float("nan")
                vn[:, :, end:] = float("nan")
                po, pl = real(q, kn, vn, scale, mask, backend=backend)
                skipped = bool(torch.equal(po, out) and torch.equal(pl, lse))
        errs = (max_err(out, ref_o), rel_err_rows(out, ref_o),
                max_err(lse, ref_l))
        seen.append((q.shape[2], k.shape[2], mask.offset, errs, skipped))
        if (errs[0] > B1_OUT_TOL or errs[1] > RING_OUT_REL_TOL
                or errs[2] > B1_LSE_TOL or skipped is False):
            raise AssertionError(
                f"chunk B1 (q {tuple(q.shape)}, {k.shape[2]} keys, offset "
                f"{mask.offset}): errors {errs}, NaN tiles skipped {skipped}")
        return out, lse

    serve.flash_attention = checked
    try:
        yield
    finally:
        serve.flash_attention = real


@contextlib.contextmanager
def _checked_verify(torch, seen):
    """paged_decode_attention's calls with new_counts (the speculative
    verify: B5, one launch whose grid takes row groups past the rows one
    block serves) also held against ``_plain_paged_decode``. Records
    (Tq, (|out| error, |lse| error)) of each call in ``seen``."""
    from ring_flash_attn_tpu_torch.ops import paged

    real = paged.paged_decode_attention

    def checked(q, cache, scale, softcap=None, backend=None,
                new_counts=None):
        out, lse = real(q, cache, scale, softcap=softcap, backend=backend,
                        new_counts=new_counts)
        if new_counts is not None:
            ref_o, ref_l = paged._plain_paged_decode(q, cache, scale,
                                                     softcap, new_counts)
            errs = (max_err(out, ref_o), max_err(lse, ref_l))
            seen.append((q.shape[2], errs))
            if max(errs) > B5_TOL:
                raise AssertionError(f"verify B5 at {q.shape[2]} rows: "
                                     f"errors {errs} (tol {B5_TOL})")
        return out, lse

    paged.paged_decode_attention = checked
    try:
        yield
    finally:
        paged.paged_decode_attention = real


def _first_tokens(torch, model, vocab, **kw):
    """A 3840-token prompt and a 256-token one behind it, submitted
    together: (the short one's first token s, the long one's s, prompt
    tokens/s until both have their first token). The second of two runs
    (the first warms cuBLAS and the allocator)."""
    from ring_flash_attn_tpu_torch.models import ServingEngine

    rng = np.random.default_rng(191)
    long_p, short_p = (rng.integers(0, vocab, size=n).astype(np.int32)
                       for n in (3840, 256))
    for _ in range(2):
        eng = ServingEngine(model, device="cuda", **SERVE_POOL, **kw)
        eng.submit(0, long_p, 2)
        eng.submit(1, short_p, 2)
        first = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while len(first) < 2:
            eng.step()
            torch.cuda.synchronize()
            for rid in (0, 1):
                if rid not in first and eng.outputs[rid]:
                    first[rid] = time.perf_counter() - t0
    return first[1], first[0], (3840 + 256) / max(first.values())


def _prefilled_lanes(torch, model, prompts):
    """Phase 4's pool after one step over four prompts: (the pages, the
    lanes' pending tokens (4,), live (4,), block tables (4, 16), rewound
    lengths (4,)), as a decode step would see them."""
    from ring_flash_attn_tpu_torch.models import ServingEngine
    from ring_flash_attn_tpu_torch.serving import gather_block_tables

    eng = ServingEngine(model, device="cuda", **SERVE_POOL)
    for rid, p in prompts.items():
        eng.submit(rid, p, 8)
    eng.step()
    lanes = [r for r in eng.sched.lanes if r is not None]
    tables, lens = gather_block_tables(eng.alloc, [r.seq for r in lanes], 16)
    toks, live = np.zeros(4, np.int64), np.zeros(4, bool)
    bt, ln = np.zeros((4, 16), np.int32), np.zeros(4, np.int32)
    for i, r in enumerate(lanes):
        live[r.lane], toks[r.lane] = True, eng._pending[r.req_id]
        bt[r.lane], ln[r.lane] = tables[i], lens[i] - 1
    dev = torch.device("cuda")
    return ([(c.k_pages, c.v_pages) for c in eng.caches],
            torch.as_tensor(toks, device=dev),
            torch.as_tensor(live, device=dev), torch.as_tensor(bt, device=dev),
            torch.as_tensor(ln, device=dev))


def _caches(torch, pages, tables, lens, heads=None):
    """PagedKVCaches over copies of ``pages`` (kv heads ``heads``)."""
    from ring_flash_attn_tpu_torch.ops.paged import PagedKVCache

    hs = slice(None) if heads is None else heads
    return [PagedKVCache(k[:, hs].clone(), v[:, hs].clone(), tables, lens)
            for k, v in pages]


def _tp_decode(torch, model, shards, tokens, live, pages, tables, lens,
               backend=None):
    with torch.no_grad():
        return _tp_decode_body(torch, model, shards, tokens, live, pages,
                               tables, lens, backend)


def _tp_decode_body(torch, model, shards, tokens, live, pages, tables, lens,
                    backend):
    """One decode step as the ranks of a tensor-parallel group compute
    it, in one process: rank r's attention (its kv heads' pages, its rows
    of wo; ``transformer._attn_branch`` with no group) and MLP partials,
    summed here (what the group's psum does). Returns the logits (B,
    vocab)."""
    from ring_flash_attn_tpu_torch.models.serve import _head
    from ring_flash_attn_tpu_torch.models.transformer import (
        _attn_branch, _mlp_branch)
    from ring_flash_attn_tpu_torch.ops import paged

    cfg = model.cfg
    tp = len(shards)
    h = cfg.kv_heads // tp
    caches = [_caches(torch, pages, tables, lens, slice(r * h, (r + 1) * h))
              for r in range(tp)]
    scale = cfg.head_dim**-0.5
    positions = lens[:, None, None]
    x = model.embed[tokens][:, None]
    for i in range(cfg.layers):
        parts = []
        for r in range(tp):
            def attend(q, k, v, r=r):
                caches[r][i] = paged.paged_append(caches[r][i], k, v,
                                                  mask=live)
                return paged.paged_decode_attention(
                    q, caches[r][i], scale, backend=backend)[0]
            parts.append(_attn_branch(cfg, x, shards[r].layers[i],
                                      positions, attend=attend).float())
        x = (x.float() + sum(parts)).to(x.dtype)
        x = (x.float() + sum(_mlp_branch(x, s.layers[i]).float()
                             for s in shards)).to(x.dtype)
    return _head(model, x)[:, 0]


def _step_times(torch, fn):
    """(median wall ms of fn() over 5 synchronised calls after a warm-up,
    its device ms under torch.profiler)."""
    fn()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    dev = _device_profile(torch, fn)
    return float(np.median(walls)), sum(t for t, _, _ in dev) / 1e3


def phase_serving_options(torch):
    """Phase 19. Returns (the launches of the serving_options path, its
    readings)."""
    import torch.distributed as dist

    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, shard_params)
    from ring_flash_attn_tpu_torch.models.serve import (
        _decode_body, _spec_verify_body)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)

    log("== phase 19: the ServingEngine's options at Llama-3-8B widths, "
        "4 layers: chunked prefill, speculative decoding, mesh=")
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    # the path's launches: the engine runs with the options, each counted
    # from 0 (_path_run); the references, the direct kernel checks, the
    # timings and the tp=2 simulation lie outside them
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B5 paged_decode": paged_decode_cuda}
    launches = {}
    readings = {}

    # (a) prefill_chunk=512 against the dense engine on phase 4's traffic
    # (the prefix-cached request included; phase 4 forks)
    prompts = _traffic(cfg.vocab)
    dense, dense_m, _, dense_st = _engine_run(torch, model, prompts, 16,
                                              prefix_of={2: 0})
    chunks = []
    with _path_run(counters, launches), _checked_chunks(torch, counters,
                                                        chunks):
        out, _, _, stats = _engine_run(torch, model, prompts, 16,
                                       prefix_of={2: 0}, prefill_chunk=512)
    worst = [max(c[3][i] for c in chunks) for i in range(3)]
    log(f"  (a) prefill_chunk=512: {stats['prefill_chunks']} chunks; each "
        f"chunk's B1 against its plain version: worst |out| {worst[0]:.2e} "
        f"(tol {B1_OUT_TOL}), by rows {worst[1]:.2e} (tol "
        f"{RING_OUT_REL_TOL}), |lse| {worst[2]:.2e} (tol {B1_LSE_TOL}); "
        f"the tiles past p_len + C with NaN keys and values: "
        f"{sum(c[4] is True for c in chunks)} of "
        f"{sum(c[4] is not None for c in chunks)} chunks the same bits")
    readings["chunked_parted"] = _parted("chunked vs dense", dense, dense_m,
                                         out)
    readings["chunked_logits_rel_err"] = _logits_agree(
        "chunked vs dense", dense, dense_st["logits"], out,
        stats["logits"])[0]
    # B1 at ragged chunks (C not a multiple of its 128-row q tile) over a
    # lane's 4096 gathered keys, at page-aligned offsets
    ragged = []
    gen = torch.Generator(device="cuda").manual_seed(19)
    with _checked_chunks(torch, counters, ragged):
        from ring_flash_attn_tpu_torch.models import serve
        from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
        for c, p_len in ((320, 1280), (192, 3840), (64, 0)):
            q = torch.randn((1, 32, c, 128), generator=gen,
                            device="cuda").to(torch.bfloat16)
            kv = torch.randn((2, 1, 8, 4096, 128), generator=gen,
                             device="cuda").to(torch.bfloat16)
            serve.flash_attention(q, kv[0], kv[1], 128**-0.5,
                                  MaskArgs(causal=True, offset=p_len))
    log("    B1 at ragged chunks (C, keys, offset, (|out|, rows, |lse|), "
        "NaN tiles skipped): " + "; ".join(
            f"{c[0]}, {c[1]}, {c[2]}, ({c[3][0]:.2e}, {c[3][1]:.2e}, "
            f"{c[3][2]:.2e}), {c[4]}" for c in ragged))
    ttft = {name: _first_tokens(torch, model, cfg.vocab, **kw)
            for name, kw in (("dense", {}),
                             ("chunked", {"prefill_chunk": 512}))}
    for name, (short, long_, tps) in ttft.items():
        log(f"    {name}: a 256-token request's first token {short:.4f} s "
            f"behind a 3840-token prompt (its first token {long_:.4f} s); "
            f"{tps:.0f} prompt tokens/s until both")
    readings["first_token_s"] = {n: {"short": s, "long": l, "tokens_per_s": t}
                                 for n, (s, l, t) in ttft.items()}

    # (b) speculate_k=4 (16 rows at G=4) and 8 (32 rows: one launch of B5
    # a layer, two row groups of 16) on repetitive prompts, against the
    # plain greedy engine
    rng = np.random.default_rng(19)
    rep = {rid: np.tile(rng.integers(0, cfg.vocab, size=u),
                        -(-n // u))[:n].astype(np.int32)
           for rid, (u, n) in enumerate(((50, 1000), (17, 600), (120, 1500),
                                         (33, 800)))}
    plain, plain_m, _, plain_st = _engine_run(torch, model, rep, 32)
    readings["spec"] = {}
    for k in (4, 8):
        rows = []
        with _path_run(counters, launches), _checked_verify(torch, rows):
            out, _, _, st = _engine_run(torch, model, rep, 32,
                                        speculate_k=k)
        _parted(f"speculate_k={k} vs plain greedy", plain, plain_m, out)
        spec_logits = _logits_agree(f"speculate_k={k} vs plain greedy",
                                    plain, plain_st["logits"], out,
                                    st["logits"])[0]
        # tokens a lane a decode step: the prefill samples each request's
        # first token, the decode steps the rest
        per_lane = (st["tokens"] - st["prefills"]) / st["lane_steps"]
        log(f"  (b) speculate_k={k}: {st['spec_proposed']} drafts proposed, "
            f"{st['spec_accepted']} accepted "
            f"({100 * st['spec_accepted'] / max(st['spec_proposed'], 1):.1f}"
            f"%), {per_lane:.3f} tokens a lane a decode step over "
            f"{st['decode_steps']} steps (plain greedy "
            f"{plain_st['decode_steps']} steps, 1 token a lane a step); B5 "
            f"held on {len(rows)} verify calls of {rows[0][0]} rows, worst "
            f"|out| {max(r[1][0] for r in rows):.2e}, |lse| "
            f"{max(r[1][1] for r in rows):.2e} (tol {B5_TOL})")
        if st["spec_proposed"] <= 0:
            raise AssertionError(f"speculate_k={k}: no draft was proposed")
        readings["spec"][f"k{k}"] = {
            "proposed": st["spec_proposed"], "accepted": st["spec_accepted"],
            "tokens_per_lane_step": per_lane,
            "decode_steps": st["decode_steps"],
            "plain_decode_steps": plain_st["decode_steps"],
            "logits_rel_err": spec_logits}
    # one verify forward against one plain decode step on the same lanes
    pages, toks, live, tables, lens = _prefilled_lanes(torch, model, rep)
    times = {"decode": _step_times(torch, lambda: _decode_body(
        model, toks, live, _caches(torch, pages, tables, lens)))}
    for k in (4, 8):
        cand = torch.cat([toks[:, None], torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(4, k - 1)), device="cuda")],
            dim=1)
        n_valid = torch.where(live, k, 0).to(torch.int32)
        times[f"verify k={k}"] = _step_times(
            torch, lambda cand=cand, n_valid=n_valid: _spec_verify_body(
                model, cand, n_valid, _caches(torch, pages, tables, lens)))
    log("    one step on 4 lanes, wall ms (median of 5) / device ms: "
        + "; ".join(f"{n} {w:.3f} / {d:.3f}" for n, (w, d) in times.items()))
    readings["spec"]["step_wall_device_ms"] = times

    # (c) mesh=: a tp group of one on this card runs the TP code path
    port = _free_port()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        kw = dict(prefill_chunk=512, speculate_k=4)
        ref, _, _, _ = _engine_run(torch, model, rep, 16, **kw)
        with _path_run(counters, launches):
            got, _, _, _ = _engine_run(torch, model, rep, 16,
                                       mesh=dist.group.WORLD, **kw)
    finally:
        dist.destroy_process_group()
    log(f"  (c) mesh= (a gloo group of one) with prefill_chunk=512 and "
        f"speculate_k=4: the same tokens as without it: {got == ref}")
    if got != ref:
        raise AssertionError("the mesh= engine's tokens differ")
    # tp=2: each rank's shards and kv heads, its partials summed, against
    # the unsharded _decode_body (the kernels and the plain versions)
    shards = [shard_params(model, cfg, tp_rank=r, tp=2) for r in range(2)]
    got = _tp_decode(torch, model, shards, toks, live, pages, tables, lens)
    want, _ = _decode_body(model, toks, live,
                           _caches(torch, pages, tables, lens))
    plain_tp = _tp_decode(torch, model, shards, toks, live, pages, tables,
                          lens, backend="plain")
    errs = (_rel_err(got, want), _rel_err(got, plain_tp))
    log(f"    tp=2 decode step in one process (16/4 heads a rank): the "
        f"ranks' partials summed vs the unsharded _decode_body "
        f"{errs[0]:.2e}, vs the same ranks on the plain versions "
        f"{errs[1]:.2e} of max|logit| (tol {LOGITS_REL_TOL}); argmax equal "
        f"{(got.argmax(-1) == want.argmax(-1)).tolist()}")
    if max(errs) > LOGITS_REL_TOL or not torch.isfinite(got).all():
        raise AssertionError("the tp=2 decode partials disagree")
    del shards, pages, model
    torch.cuda.empty_cache()
    log(f"  launches on the serving_options path (the engine runs with "
        f"the options): {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the serving options never ran: "
                             f"{launches}")
    return launches, readings


def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _adapter_plain_check(torch, what, out, grads, inputs, cu, ref_o,
                         ref_lse, tail=512):
    """Hold the adapter's out (T, Hq, D) and (dq, dk, dv) on a packing
    against the plain versions on the card, as phase 15 does: out and dq
    on the last ``tail`` rows (plain forward and backward over all keys),
    dk and dv of the first ``tail`` keys over every q row (with the lse and
    delta of ``flash_attn_varlen_func``'s result ``ref_o``, ``ref_lse``).
    The mask is the packing's own: causal by index, equal segment ids."""
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (naive_block_bwd,
                                                     naive_block_fwd)
    from ring_flash_attn_tpu_torch.ops.varlen import cu_seqlens_to_segids

    def heads(x):  # (T, H, D) -> (1, H, T, D)
        return x.transpose(0, 1)[None]

    q, k, v, dout = (heads(x) for x in inputs)
    total, scale = q.shape[2], q.shape[3]**-0.5
    seg = cu_seqlens_to_segids(cu, total, q.device)
    rows = MaskArgs(causal=True, offset=total - tail, q_segids=seg[-tail:],
                    kv_segids=seg)
    p_out, p_lse = naive_block_fwd(q[:, :, -tail:], k, v, scale, rows)
    p_dq = naive_block_bwd(dout[:, :, -tail:], q[:, :, -tail:], k, v, p_lse,
                           compute_delta(dout[:, :, -tail:], p_out), scale,
                           rows)[0]
    keys = MaskArgs(causal=True, q_segids=seg, kv_segids=seg[:tail])
    _, p_dk, p_dv = naive_block_bwd(dout, q, k[:, :, :tail], v[:, :, :tail],
                                    ref_lse[None],
                                    compute_delta(dout, heads(ref_o)), scale,
                                    keys)
    got = heads(out)[:, :, -tail:]
    errs = (max_err(got, p_out), rel_err_rows(got, p_out),
            _rel_err(heads(grads[0])[:, :, -tail:], p_dq),
            _rel_err(heads(grads[1])[:, :, :tail], p_dk),
            _rel_err(heads(grads[2])[:, :, :tail], p_dv))
    log(f"    {what} vs plain: out of the last {tail} rows |err| "
        f"{errs[0]:.2e} (tol {B1_OUT_TOL}), of max|plain| by rows "
        f"{errs[1]:.2e} (tol {RING_OUT_REL_TOL}); dq of the last {tail} "
        f"rows {errs[2]:.2e}, dk and dv of the first {tail} keys "
        f"{errs[3]:.2e} {errs[4]:.2e} (tol {BWD_REL_TOL})")
    if (errs[0] > B1_OUT_TOL or errs[1] > RING_OUT_REL_TOL
            or max(errs[2:]) > BWD_REL_TOL):
        raise AssertionError(f"{what}: the adapter disagrees with the plain "
                             f"versions")


def phase_adapter(torch, hq=32, hkv=8, d=128):
    """Phase 20: ``ring_attention_forward`` at Llama-3-8B attention widths
    (or, from phase 23, ``hq``/``hkv`` heads of ``d``) on the reference's
    packings. Returns (the launches of the adapter path, each W=4 rank's
    forward and backward ms)."""
    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.adapters import adapter
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import (
        flash_bwd_cuda, fused_bwd_supported)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.varlen import cu_seqlens_to_positions
    from ring_flash_attn_tpu_torch.parallel import llama3

    log(f"== phase {20 if d == 128 else 23}: the HF adapter's "
        f"ring_attention_forward, {hq}/{hkv} heads of {d}, on the "
        f"reference's packings")
    # the path's launches: ring_attention_forward's runs at W=1, forward
    # and backward, each counted from 0; the references and the W=4 ranks
    # (llama3's rank functions, called here directly) are not counted
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}
    launches = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    world, t = 4, 8192
    total, scale = world * t, d**-0.5

    def rnd(h):
        return torch.randn((total, h, d), generator=gen,
                           device=dev).to(torch.bfloat16)

    q, k, v, dout = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
    packings = [[0, 8192, 16384, 24576, 32768]] + [
        [4 * x for x in cu] for cu in VARLEN_PACKINGS[1:]]
    times = {}
    kv_all = torch.stack([k.transpose(0, 1)[None],
                          v.transpose(0, 1)[None]]).contiguous()
    for n, cu in enumerate(packings):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ref_o, ref_lse, _ = api.flash_attn_varlen_func(
            *leaves, torch.tensor(cu, device=dev), causal=True,
            return_attn_probs=True)
        ref_g = torch.autograd.grad(ref_o, leaves, dout)
        pos = cu_seqlens_to_positions(cu, total, dev)[None]
        # (a) the entry point itself at W=1 (a world of one): position_ids,
        # then DATA_PARAMS, forward and backward
        for path in ("position_ids", "DATA_PARAMS"):
            adapter.DATA_PARAMS.clear()
            kw = {"position_ids": pos}
            if path == "DATA_PARAMS":
                adapter.update_ring_flash_attn_params(cu)
                kw = {}
            leaves = [x.detach()[None].requires_grad_() for x in (q, k, v)]
            with _path_run(counters, launches):
                o = adapter.ring_attention_forward(*leaves, causal=True,
                                                   **kw)
                g = torch.autograd.grad(o, leaves, dout[None])
            o = o.detach()
            errs = (_rel_err(o[0].float(), ref_o.float()),
                    rel_err_rows(o[0].transpose(0, 1), ref_o.transpose(0, 1)))
            log(f"    {cu} W=1 through {path}: out {errs[0]:.2e} of "
                f"max|ref|, by rows {errs[1]:.2e}")
            if max(errs) > RING_OUT_REL_TOL:
                raise AssertionError(f"ring_attention_forward {path} {cu}")
            _grads_check(f"{cu} W=1 {path} backward", [x[0] for x in g],
                         ref_g)
            _adapter_plain_check(torch, f"{cu} W=1 {path}", o[0],
                                 [x[0] for x in g], (q, k, v, dout), cu,
                                 ref_o, ref_lse)
            del o, g, leaves
        # (b) W=4: each rank's labels from its position_ids and from
        # DATA_PARAMS, then llama3's rank functions on the gathered kv
        adapter.update_ring_flash_attn_params(cu)
        labels = []
        for r in range(world):
            a = adapter.segment_labels(t, r, position_ids=pos[:, r * t:(r + 1)
                                                              * t],
                                       device=dev)
            b = adapter.segment_labels(t, r, device=dev)
            if not torch.equal(a, b):
                raise AssertionError(f"{cu} rank {r}: the position_ids and "
                                     f"DATA_PARAMS labels differ")
            labels.append(a)
        adapter.DATA_PARAMS.clear()
        dkv = torch.zeros((2, 1, hkv, total, d), dtype=torch.float32,
                          device=dev)
        fwd_ms, bwd_ms = [], []
        for r in range(world):
            mask = MaskArgs(causal=True, offset=r * t, q_segids=labels[r],
                            kv_segids=torch.cat(labels))
            rows = slice(r * t, (r + 1) * t)
            qr, dr = (x[rows].transpose(0, 1)[None] for x in (q, dout))

            def fwd(qr=qr, mask=mask):
                return llama3._rank_fwd(qr, lambda i: kv_all, hkv, scale,
                                        mask, hkv, None)

            def bwd(o, lse_r, qr=qr, dr=dr, mask=mask):
                return list(llama3._rank_bwd(qr, o, lse_r, dr,
                                             lambda i: kv_all, hkv, scale,
                                             mask, hkv, None))

            o, lse_r = fwd()
            (dq, dk_g, dv_g), = bwd(o, lse_r)
            dkv[0].add_(dk_g)
            dkv[1].add_(dv_g)
            _varlen_check(f"{cu} W=4 rank {r}", (o, lse_r),
                          (ref_o[rows].transpose(0, 1)[None],
                           ref_lse[:, rows][None]), B1_OUT_TOL, RING_LSE_TOL)
            rq = _rel_err(dq.float(), ref_g[0][rows].transpose(0, 1)[None])
            if rq > BWD_REL_TOL:
                raise AssertionError(f"{cu} W=4 rank {r}: dq {rq:.2e}")
            if n in (0, len(packings) - 1):
                fwd_ms.append(_events_ms(torch, fwd, 5))
                bwd_ms.append(_events_ms(torch, lambda: bwd(o, lse_r), 3))
        rel = [_rel_err(dkv[i], ref_g[1 + i].transpose(0, 1)[None].float())
               for i in (0, 1)]
        log(f"    {cu} W=4: dk, dv summed over the ranks {rel[0]:.2e}, "
            f"{rel[1]:.2e} of max|ref| (tol {BWD_REL_TOL})"
            + (f"; per rank forward " + " ".join(f"{x:.3f}" for x in fwd_ms)
               + " ms, backward " + " ".join(f"{x:.3f}" for x in bwd_ms)
               + " ms" if fwd_ms else ""))
        if max(rel) > BWD_REL_TOL:
            raise AssertionError(f"{cu} W=4: dk, dv {rel}")
        if fwd_ms:
            times[str(cu)] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
        del dkv, ref_o, ref_g
        torch.cuda.empty_cache()
    log(f"  launches on the adapter path (ring_attention_forward at W=1, "
        f"forward and backward): {launches}")
    # the backward of the whole packing: B2, or B3a and B3b past its limit
    # (head_dim 256: Skv <= 16384)
    need = ("B2 flash_bwd",) if fused_bwd_supported(total, d) else (
        "B3a flash_bwd_dq", "B3b flash_bwd_dkv")
    if min(launches[n] for n in ("B1 flash_fwd",) + need) <= 0:
        raise AssertionError(f"a kernel of the adapter path never ran: "
                             f"{launches}")
    return launches, times


def phase_pipeline(torch):
    """Phase 21: ``train_step_pp`` with one stage (no pp group) and 2
    microbatches at phase 6's widths against ``train_step`` on the same
    batch, its counted step with a data group of one. Returns (the
    launches of the pipeline path, its readings)."""
    import torch.distributed as dist

    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, init_params, loss_fn, loss_fn_pp, stack_layers,
        train_step, train_step_pp)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda

    log("== phase 21: the GPipe pipeline, one stage, 2 microbatches, at "
        "Llama-3-8B widths, 4 layers")
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    stage = stack_layers(model, cfg)
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda}
    s, m = 4096, 2
    toks = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab, size=(m, s)), device="cuda").long()
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -100)],
                       dim=1)
    pos = torch.arange(s, device="cuda")
    names = [n for n, _ in stage.named_parameters()]
    lp = loss_fn_pp(stage, toks, labels, pos, False, m)
    gp = torch.autograd.grad(lp, list(stage.parameters()))
    lr_ = loss_fn(model, toks, labels, pos)
    gr = torch.autograd.grad(lr_, list(model.parameters()))
    with torch.no_grad():  # attention's plain versions on the card
        l_plain = float(loss_fn(model, toks, labels, pos, backend="plain"))
    errs = _grad_errs(names, gp, gr)
    gmax = [float(g.abs().max()) for g in gr]
    lp, lr_ = float(lp.detach()), float(lr_.detach())
    log(f"  loss_fn_pp {lp:.6f} vs loss_fn {lr_:.6f}, vs loss_fn on the "
        f"plain versions {l_plain:.6f} (tol {LOSS_TOL}); gradients "
        f"||pp - ref|| / ||ref||, worst 3 of {len(errs)}: "
        + ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])
        + f" (tol {GRAD_REL_TOL})")
    if (max(abs(lp - lr_), abs(lp - l_plain)) > LOSS_TOL
            or errs[0][0] > GRAD_REL_TOL):
        raise AssertionError("the pipeline's loss or gradients disagree")
    del gp, gr, lp, lr_
    torch.cuda.empty_cache()
    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = fn(*args)
        loss = float(loss)
        torch.cuda.synchronize()
        return loss, time.perf_counter() - t0

    lr = 1e-3
    launches = {}
    # the counted step with a data group (a gloo group of one on this card:
    # its sums and mean are the identity, the data replicas' code path runs)
    port = _free_port()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        with _path_run(counters, launches):
            loss_pp, _ = timed(train_step_pp, stage, toks, labels, pos, False,
                               m, lr, False, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    loss_ref, _ = timed(train_step, model, toks, labels, pos, lr)
    # the updated bf16 weights: each within one or two ulps (2^-7 of the
    # weight) plus lr times GRAD_REL_TOL of the parameter's largest
    # gradient (the gradients' own limit, which a weight near 0 shows
    # whole) of train_step's
    off = [float(((a.float() - b.float()).abs() - b.float().abs() * 2**-7
                  - lr * GRAD_REL_TOL * g).clamp_min(0).max())
           for a, b, g in zip(stage.parameters(), model.parameters(), gmax)]
    differ = sum(int((a != b).sum()) for a, b in zip(stage.parameters(),
                                                     model.parameters()))
    log(f"  one step: train_step_pp loss {loss_pp:.6f}, train_step "
        f"{loss_ref:.6f}; updated weights: {differ} of "
        f"{sum(p.numel() for p in model.parameters())} differ, all within "
        f"2^-7 of the weight + lr * {GRAD_REL_TOL} * max|g|: "
        f"{max(off) == 0.0}; launches {launches}")
    if (abs(loss_pp - loss_ref) > LOSS_TOL or max(off) > 0.0
            or not np.isfinite(loss_pp)):
        raise AssertionError("train_step_pp disagrees with train_step")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the pipeline never ran: "
                             f"{launches}")
    # a second and a third step each, timed in turns
    dt_pp = timed(train_step_pp, stage, toks, labels, pos, False, m, lr)[1]
    dt_ref = timed(train_step, model, toks, labels, pos, lr)[1]
    dt_pp2 = timed(train_step_pp, stage, toks, labels, pos, False, m, lr)[1]
    dt_ref2 = timed(train_step, model, toks, labels, pos, lr)[1]
    log(f"  a step of 2 x 4096 tokens (second and third, in turns): "
        f"train_step_pp {dt_pp:.4f}, {dt_pp2:.4f} s; train_step "
        f"{dt_ref:.4f}, {dt_ref2:.4f} s")
    del model, stage
    torch.cuda.empty_cache()
    return launches, {"step_s": [dt_pp, dt_pp2],
                      "train_step_s": [dt_ref, dt_ref2]}


# ---------------------------------------------------------------------------
# phase 22: the utils and the entry points on the card

UTILS_TIMED_TOL = 0.10  # timed's per-call slope against the profiler's
# device time of the same chain, relative
SERVING_BUSY_PERF = (0.22, 0.25)  # PERF.md section 5: PR 8's busy share
# of the engine's decode step


def phase_utils_entry(torch):
    """Phase 22: ``entry()``, ``dryrun_multichip(1, "cuda")``, a checkpoint
    round trip of the flagship model, ``utils.timing.timed`` on B1 and
    ``utils.trace_timing`` on the engine's decode step. Returns (the
    launches of the entry, dryrun and checkpoint paths, the readings)."""
    import tempfile

    from ring_flash_attn_tpu_torch.entry import dryrun_multichip, entry
    from ring_flash_attn_tpu_torch.models import (ModelConfig, init_params,
                                                  train_step)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.utils import (abstract_like,
                                                 restore_checkpoint,
                                                 save_checkpoint)
    from ring_flash_attn_tpu_torch.utils.timing import timed
    from ring_flash_attn_tpu_torch.utils.trace_timing import trace_device_time

    log("== phase 22: the utils and the entry points on the card")
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda,
                "B5 paged_decode": paged_decode_cuda}
    paths = {"entry": {}, "dryrun": {}, "checkpoint": {}}
    readings = {}
    dev = torch.device("cuda")

    # (a) entry(): the flagship forward, kernels against backend="plain",
    # on entry()'s zero tokens (every key's v is the same row: attention
    # gives it back whatever p is) and on random tokens
    fn, (model, tokens, positions) = entry()
    gen = torch.Generator(device=dev).manual_seed(22)
    rand = torch.randint(0, model.cfg.vocab, tokens.shape, generator=gen,
                         device=dev)
    rels = []
    for toks in (tokens, rand):
        with torch.no_grad():
            with _path_run(counters, paths["entry"]):
                logits = fn(model, toks, positions)
            ref = model(toks, positions, backend="plain")
        rels.append(_rel_err(logits, ref))
        if rels[-1] > LOGITS_REL_TOL or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("entry(): the logits disagree with plain")
    log(f"  entry(): logits {tuple(logits.shape)}, |kernels - plain| "
        f"{rels[0]:.2e} of max|plain| on its zero tokens, {rels[1]:.2e} on "
        f"random ones (tol {LOGITS_REL_TOL}); launches {paths['entry']}")
    readings["entry_logits_rel_err"] = rels

    # (b) the dry run in one process on this card (NCCL, a group of one):
    # JAX's first configuration, dp 1 x sp 1, in the kernels' operands
    t0 = time.perf_counter()
    values, launches = dryrun_multichip(1, "cuda", return_launches=True)
    readings["dryrun_s"] = time.perf_counter() - t0
    readings["dryrun_loss"] = values["zigzag"]
    paths["dryrun"] = {k: v for k, v in launches.items() if k in counters}
    log(f"  dryrun_multichip(1, 'cuda'): {values} in "
        f"{readings['dryrun_s']:.1f} s; the process's launches {launches}")
    if not np.isfinite(values["zigzag"]) or min(
            launches["B1 flash_fwd"], launches["B2 flash_bwd"]) <= 0:
        raise AssertionError("the dry run did not run B1 and B2 on the card")

    # (c) checkpoint round trip of the flagship model: a step, save,
    # restore into a fresh model, the next step's loss on both
    toks = torch.randint(0, model.cfg.vocab, (1, 1025), generator=gen,
                         device=dev)
    batch = (toks[:, :-1], toks[:, 1:], positions)
    with _path_run(counters, paths["checkpoint"]):
        _, loss1 = train_step(model, *batch, lr=1e-2)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, model.state_dict(), step=1,
                        metadata={"seed": 22})
        state, step, meta = restore_checkpoint(d, like=abstract_like(model))
    same = all(torch.equal(state[n], t) and state[n].device == t.device
               for n, t in model.state_dict().items())
    fresh = init_params(model.cfg, torch.Generator().manual_seed(1))
    fresh.load_state_dict(state)
    with _path_run(counters, paths["checkpoint"]):
        _, loss_a = train_step(model, *batch, lr=1e-2)
        _, loss_b = train_step(fresh, *batch, lr=1e-2)
    log(f"  checkpoint: step {step}, metadata {meta}, restored tensors "
        f"bit-identical on the card {same}; the next step's loss "
        f"uninterrupted {float(loss_a):.6f}, resumed {float(loss_b):.6f} "
        f"(step 1 {float(loss1):.6f}); launches {paths['checkpoint']}")
    if not (same and step == 1 and meta == {"seed": 22}
            and float(loss_a) == float(loss_b)):
        raise AssertionError("checkpoint: the resumed step differs")
    readings["checkpoint_losses"] = [float(loss1), float(loss_a),
                                     float(loss_b)]
    del model, fresh, state, logits, ref
    torch.cuda.empty_cache()

    # (d) timed on B1 at the table's shape (no L2 flush), held against a
    # witness of another mechanism: the profiler's device time of the same
    # feedback chain (trace_device_time, CUPTI's kernel records, no CUDA
    # events). cuda_ms, which times one call at a time with the launcher's
    # host work inside its events, is read beside them
    q, k, v = (torch.randn((1, h, 8192, 128), generator=gen, device=dev)
               .to(torch.bfloat16) for h in (32, 8, 8))
    mask = MaskArgs(causal=True)
    with _uncounted(counters):
        def b1(x):
            return flash_fwd_cuda(x, k, v, 128 ** -0.5, mask,
                                  out_dtype=torch.bfloat16)[0]

        per_call = timed(b1, q, n=20, n0=3) * 1e3
        traced_s, traced_by = trace_device_time(b1, q, 20)
        traced = traced_s * 1e3
        alone = cuda_ms(torch, lambda: b1(q), 20, torch.empty(1, device=dev))
    gap = abs(per_call - traced) / traced
    log(f"  timed(B1) at q (1,32,8192,128) causal: {per_call:.4f} ms a "
        f"call; the profiler's device time of the same chain {traced:.4f} "
        f"ms ({100 * gap:.1f}% apart; tol {100 * UTILS_TIMED_TOL:.0f}%; "
        + ", ".join(f"{_short(n)} {t * 1e3:.4f} ms"
                    for n, t in traced_by.items())
        + f"); cuda_ms, a call at a time, {alone:.4f} ms")
    if gap > UTILS_TIMED_TOL:
        raise AssertionError("timed disagrees with the profiler's device "
                             "time")
    readings["timed_b1_ms"], readings["traced_b1_ms"] = per_call, traced
    readings["cuda_ms_b1_ms"] = alone
    del q, k, v
    torch.cuda.empty_cache()

    # (e) trace_device_time / trace_device_busy on the engine's decode step
    # at phase 4's widths, 4 lanes (profile_torch_serving.py's)
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    with _uncounted(counters):
        wall, dev_s, busy_s, by_name = _decode_step_busy(torch, model,
                                                         cfg.vocab)
    share = busy_s / wall
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"  the engine's decode step (4 lanes): wall {wall * 1e3:.3f} ms, "
        f"device compute {dev_s * 1e3:.3f} ms, busy {busy_s * 1e3:.3f} ms = "
        f"{100 * share:.1f}% of wall (PERF.md section 5: "
        f"{100 * SERVING_BUSY_PERF[0]:.0f} to "
        f"{100 * SERVING_BUSY_PERF[1]:.0f}%)"
        f"; top " + ", ".join(f"{_short(n)} {t * 1e3:.3f} ms"
                              for n, t in top))
    if not (0 < busy_s and dev_s > 0 and share <= 1.0 + 1e-6):
        raise AssertionError("trace_timing read no device time")
    readings["decode_step"] = {"wall_ms": wall * 1e3,
                               "device_ms": dev_s * 1e3,
                               "busy_ms": busy_s * 1e3, "busy_share": share}
    del model
    torch.cuda.empty_cache()
    return paths, readings


# ---------------------------------------------------------------------------
# phase 23: head_dim 256 (Gemma) in B1, B2, B3a and B3b

# the attention of the published Gemma 1 configurations: transformers'
# GemmaConfig() is Gemma-7B (16 q and 16 kv heads of 256); Gemma-2B has 8
# q heads and one kv head of 256
GEMMA_ATTN = {"Gemma-7B": (16, 16), "Gemma-2B": (8, 1)}
GEMMA_HEAD_DIM = 256
# head_dim 256 at its tiles' edges (B1 128 q rows x 80 keys, 64 keys with
# segments; B3a 128 q rows x 64 keys; B2 and B3b 64 keys a block x 64 q
# rows a step), held here (phase 23) and in
# tests/test_torch_cuda.py: (B, Hq, Hkv, Sq, Skv, kind, arg) with kind
# "mask" (arg: (causal, offset)) or a SEG_EDGE_CASES kind (arg: cu); Sq and
# Skv at 1, 63 to 65, 127 to 129, 192, 200, 256, 257, dead rows, a first q
# tile that sees no key and GQA groups 1 to 8
D256_EDGE_CASES = [
    (1, 2, 2, 1, 1, "mask", (True, 0)),
    (1, 4, 1, 63, 65, "mask", (True, 2)),
    (1, 8, 1, 129, 127, "mask", (False, None)),
    (2, 2, 1, 64, 64, "mask", (True, 0)),
    (1, 4, 2, 200, 300, "mask", (True, 100)),
    (1, 4, 4, 100, 70, "mask", (True, -5)),
    (1, 16, 16, 257, 257, "mask", (True, 0)),
    (1, 4, 2, 127, 127, "pos", [0, 1, 60, 127]),
    (1, 8, 1, 129, 129, "pos", [0, 64, 65, 129]),
    (1, 4, 4, 257, 257, "seg", [0, 100, 101, 257]),
    (2, 4, 2, 130, 130, "shuffled", [0, 130]),
    (1, 4, 2, 200, 300, "absent", [0, 70, 300]),
    (1, 8, 2, 129, 257, "idx", [0, 50, 200, 257]),
    # B3a's 128-row q tile: Sq one below, at and one above it, a first q
    # tile that sees no key, a segment edge on the tile's
    (1, 2, 1, 127, 200, "mask", (False, None)),
    (1, 4, 2, 128, 128, "mask", (True, 0)),
    (1, 4, 4, 129, 192, "mask", (True, 63)),
    (1, 4, 2, 256, 128, "mask", (True, -128)),
    (1, 4, 2, 256, 256, "seg", [0, 127, 128, 256]),
    # the mask-free build's 80-key tile: Sq and Skv one below, at and one
    # above 80, 160 and 256 keys; causal diagonals that cross a kv tile
    # inside a 128-row q tile (keys 80 and 160 in q tiles 0 and 1)
    (1, 4, 2, 79, 81, "mask", (True, 2)),
    (1, 2, 1, 80, 80, "mask", (True, 0)),
    (1, 4, 4, 81, 79, "mask", (False, None)),
    (1, 4, 2, 159, 161, "mask", (True, 0)),
    (1, 8, 2, 160, 160, "mask", (True, 0)),
    (2, 4, 1, 161, 159, "mask", (False, None)),
    (1, 4, 2, 255, 257, "mask", (True, 2)),
    (1, 4, 4, 256, 255, "mask", (True, -1)),
    (1, 16, 8, 257, 256, "mask", (True, 0)),
]


# the softcap/ALiBi (XFORM) and window/dropout (BAND) builds of B1, B2, B3a
# and B3b at head_dim 256, held here (phase 25) and in
# tests/test_torch_cuda.py, in the forms of XFORM_EDGE_CASES and
# BAND_EDGE_CASES at D256_EDGE_CASES' tile edges (Sq and Skv at 1, 63 to
# 65, 127 to 130, 255 to 257, 300; GQA groups 1 to 8, dead rows, unseen
# keys). The caps of 2 to 5 bend the N(0, 1) logits on every build (with
# and without SEG, the unmasked and masked bodies), so that a build
# without the cap or its 1 - tanh^2 fails; windows of 0, 63, 64, 65 and
# 127 keys sit on and beside the 64-key and 64-row tiles' edges
D256_XFORM_EDGE_CASES = [
    (1, 2, 2, 1, 1, 256, "causal", None, 50.0, True),
    (1, 4, 1, 63, 65, 256, "causal", None, 4.0, True),
    (1, 8, 1, 129, 127, 256, "full", None, 3.0, True),
    (2, 2, 1, 64, 64, 256, "full", None, None, True),
    (1, 4, 2, 200, 300, 256, "causal", None, 2.0, False),
    (1, 4, 2, 127, 127, 256, "pos", [0, 1, 60, 127], 5.0, True),
    (1, 8, 1, 129, 129, 256, "posfull", [0, 64, 65, 129], 3.0, True),
    (1, 4, 4, 257, 257, 256, "seg", [0, 100, 101, 257], 20.0, True),
    (2, 4, 2, 130, 130, 256, "shuffled", [0, 130], 2.0, False),
    (1, 4, 2, 200, 300, 256, "absent", [0, 70, 300], None, True),
    (1, 8, 2, 129, 257, 256, "idx", [0, 50, 200, 257], 4.0, True),
    (1, 8, 2, 257, 255, 256, "strided", None, 5.0, True),
    # the XFORM build without segments (64-key tiles, O rescaled only when
    # a row's max outgrows its running one by 2^8) at the edges B7's and
    # the mask-free B1's 80-key tiles take: Sq and Skv one below, at and
    # one above 80, 160 and 256; caps of 2 to 5
    (1, 4, 2, 79, 81, 256, "causal", None, 3.0, True),
    (1, 8, 2, 80, 80, 256, "full", None, 2.0, False),
    (1, 4, 1, 81, 79, 256, "causal", None, 5.0, False),
    (1, 4, 2, 159, 161, 256, "full", None, 4.0, True),
    (2, 4, 2, 160, 160, 256, "causal", None, 2.0, True),
    (1, 8, 2, 161, 159, 256, "causal", None, None, True),
    (1, 4, 2, 255, 257, 256, "full", None, 3.0, False),
    (1, 16, 8, 256, 256, 256, "causal", None, 5.0, True),
    (1, 4, 4, 257, 255, 256, "causal", None, 2.0, False),
]
D256_BAND_EDGE_CASES = [
    (1, 4, 2, 257, 257, 256, "causal", None, 0, None, None, None, False),
    (1, 8, 2, 255, 300, 256, "causal", None, 63, None, None, None, False),
    (1, 4, 1, 257, 257, 256, "causal", None, 64, None, None, None, False),
    (2, 4, 2, 130, 130, 256, "causal", None, 127, None, None, 3.0, False),
    (1, 4, 2, 257, 255, 256, "full", None, 63, 64, None, None, False),
    (1, 8, 2, 129, 300, 256, "full", None, 0, 65, None, 4.0, True),
    (2, 4, 2, 257, 257, 256, "causal", None, None, None, 0.1, None, False),
    (1, 8, 2, 129, 300, 256, "full", None, None, None, 0.3, 2.0, False),
    (1, 4, 2, 257, 257, 256, "pos", [0, 100, 101, 257], None, None, 0.2,
     None, False),
    (2, 4, 2, 130, 130, 256, "shuffled", [0, 130], None, None, 0.1, 5.0,
     True),
    (1, 8, 2, 257, 255, 256, "strided", None, None, None, 0.1, None, True),
    (1, 8, 2, 129, 257, 256, "idx", [0, 50, 200, 257], 64, None, 0.1, None,
     False),
    (1, 4, 2, 300, 300, 256, "pos", [0, 3, 131, 132, 300], 65, None, None,
     None, False),
    (1, 4, 2, 200, 300, 256, "absent", [0, 70, 300], 63, None, None, None,
     False),
    (1, 4, 1, 257, 257, 256, "posfull", [0, 128, 129, 257], 40, 40, 0.1,
     None, True),
    (1, 8, 2, 129, 129, 256, "seg", [0, 64, 129], 10, 5, 0.2, 2.0, False),
    (1, 16, 8, 257, 257, 256, "causal", None, 4095, None, None, 50.0,
     False),
]
# B7 and B8 at head_dim 256 (B7: 128 q rows x 80 keys a tile; B8: 64 keys a
# block, 64 q rows a step), held here (phase 25) and in
# tests/test_torch_cuda.py: (Hq, Hkv, Sq, Skv, causal, softcap, ALiBi,
# steps), the steps of the last rank of a ring of ``steps``
# (``ring_steps``), caps of 2 to 5 that bend the logits among them
D256_RING_CASES = [
    (2, 2, 1, 1, True, None, False, 1),
    (4, 1, 63, 65, True, 4.0, True, 3),
    (8, 1, 129, 127, False, 3.0, True, 3),
    (4, 2, 64, 64, True, None, True, 2),
    (4, 4, 200, 200, True, 50.0, False, 2),
    (16, 8, 257, 257, True, 5.0, False, 3),
    (4, 2, 255, 129, False, None, False, 3),
    (8, 2, 130, 257, True, 2.0, True, 2),
    # B7's 80-key tile: shards one below, at and one above 80, 160 and 256
    # keys, rings of 2 and 3 steps (first, middle and last), caps of 2 to 5
    (4, 2, 79, 81, True, 3.0, False, 3),
    (8, 2, 80, 80, False, 2.0, True, 3),
    (4, 1, 81, 79, True, None, True, 2),
    (4, 2, 159, 161, False, 4.0, False, 2),
    (8, 4, 160, 160, True, 5.0, True, 3),
    (4, 4, 161, 159, True, 2.0, False, 3),
    (16, 8, 256, 256, True, 3.0, True, 3),
    (4, 2, 255, 257, False, None, False, 3),
]


def d256_ring_case_check(torch, case, seed=0):
    """One ``D256_RING_CASES`` case through ``fused_ring_case`` (B7 after
    every step, B8 over the steps, against the plain versions). Returns
    the worst errors {"B7": [abs, rel], "B8": [abs, rel]}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    hq, hkv, sq, skv, causal, cap, alibi, n = case
    worst = {"B7": [0.0, 0.0], "B8": [0.0, 0.0]}
    fused_ring_case(torch, rnd, worst, f"D=256 ring {case}", 1, hq, hkv, sq,
                    skv, GEMMA_HEAD_DIM, ring_steps(n, skv, causal),
                    causal=causal, cap=cap, alibi=alibi)
    return worst


def d256_growth_check(torch, seed=0):
    """The running max of B1's and B7's head_dim 256 builds where it must
    catch up: the forward loop (``csrc/flash_fwd.cuh``, LAZY) lets a row's
    running max lag its true max by up to 8 (base 2) and rescales O only
    past that, which N(0, 1) logits never reach after a row's first tile.
    Here q and k grow along the sequence (scaled by 1 to 6), so the maxes
    grow by far more from tile to tile: B1 causal and not, with softcap 50
    and with ALiBi, and B7 over a ring of 3 steps without and with softcap
    50 (the state of the first, middle and last step), at Sq = Skv = 1000,
    against the plain versions (B1_OUT_TOL, RING_OUT_REL_TOL of max|plain|
    by rows, B1_LSE_TOL). Raises past the limits; returns the worst errors
    {"B1": [abs, rel, lse], "B7": [rel, lse]}."""
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import naive_block_fwd
    from ring_flash_attn_tpu_torch.parallel import fused_ring as fr

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, s, d = 8, 4, 1000, GEMMA_HEAD_DIM
    scale = d ** -0.5

    def rnd(h, grow=True):
        x = torch.randn((1, h, s, d), generator=g, device=dev)
        if grow:
            x = x * torch.linspace(1.0, 6.0, s, device=dev)[:, None]
        return x.to(torch.bfloat16)

    q, k, v = rnd(hq), rnd(hkv), rnd(hkv, grow=False)
    worst = {"B1": [0.0, 0.0, 0.0], "B7": [0.0, 0.0]}
    for what, mask in (("causal", MaskArgs(causal=True)),
                       ("not causal", MaskArgs()),
                       ("softcap 50", MaskArgs(causal=True, softcap=50.0)),
                       ("ALiBi", MaskArgs(alibi_slopes=alibi_slopes(
                           torch, hq, dev)))):
        errs = _varlen_check(f"growing logits, B1 {what}",
                             flash_fwd_cuda(q, k, v, scale, mask),
                             naive_block_fwd(q, k, v, scale, mask),
                             B1_OUT_TOL, B1_LSE_TOL)
        worst["B1"] = [max(a, b) for a, b in zip(worst["B1"], errs)]
    qs = fr._prescale(q, scale * fr.LOG2E)
    for cap in (None, 50.0):
        kw = fr._transforms(q, True, cap, None)
        shards = [(rnd(hkv), rnd(hkv, grow=False)) for _ in range(3)]
        st_k, st_p = fr.new_state(qs), fr.new_state(qs)
        for i, (step, (k, v)) in enumerate(zip(ring_steps(3, s, True),
                                               shards)):
            flags = dict(first=i == 0, last=i == 2, **step, **kw)
            got = fr.fwd_step(qs, k, v, st_k, **flags)
            ref = fr.fwd_step(qs, k, v, st_p, backend="plain", **flags)
            if got is None:
                got, ref = _finish(torch, *st_k), _finish(torch, *st_p)
            errs = (_rel_err(got[0].float(), ref[0].float()),
                    max_err(got[1], ref[1]))
            log(f"    growing logits, B7 softcap {cap} step {i}: out "
                f"{errs[0]:.3e} of max|plain|, |lse| err {errs[1]:.3e}")
            if errs[0] > RING_OUT_REL_TOL or errs[1] > B1_LSE_TOL:
                raise AssertionError(f"growing logits, B7 softcap {cap} "
                                     f"step {i}: past the limits")
            worst["B7"] = [max(a, b) for a, b in zip(worst["B7"], errs)]
    return worst


def d256_case_mask(torch, case, dev):
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs

    _, _, _, sq, skv, kind, arg = case
    if kind == "mask":
        return MaskArgs(causal=arg[0], offset=arg[1])
    return seg_case_mask(torch, kind, sq, skv, arg, dev)


def d256_check(torch, what, q, k, v, dout, mask, modes=False):
    """B1, then B2 and B3a/B3b (``flash_bwd_split_cuda``) at head_dim 256
    against their plain versions on the same bf16 inputs, at the head_dim
    128 phases' limits (2, 5, 16): out absolutely and by rows, lse, and the
    gradients relative to max|plain|. With ``modes`` the backward also
    runs in the single-call mode (delta=None, bf16 gradients). Returns
    (max|out| err, out by rows, max rel err of B2, of B3)."""
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_split_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.naive import (naive_block_bwd,
                                                     naive_block_fwd)

    bf16 = torch.bfloat16
    scale = q.shape[-1] ** -0.5
    out, lse = flash_fwd_cuda(q, k, v, scale, mask, out_dtype=bf16)
    errs = _varlen_check(f"{what} B1", (out, lse),
                         naive_block_fwd(q, k, v, scale, mask), B1_OUT_TOL,
                         B1_LSE_TOL)
    delta = compute_delta(dout, out)
    ref = naive_block_bwd(dout, q, k, v, lse, delta, scale, mask)
    one_key = q.shape[2] == k.shape[2] == 1  # dq, dk vanish; dv holds
    worst = []
    for name, bwd in (("B2", flash_bwd_cuda), ("B3", flash_bwd_split_cuda)):
        runs = [(f"{name}", delta, {})]
        if modes:
            runs.append((f"{name} delta=None bf16", None,
                         dict(out=out, dq_dtype=bf16, dkv_dtype=bf16)))
        w = 0.0
        for label, d_arg, kw in runs:
            got = bwd(dout, q, k, v, lse, d_arg, scale, mask, **kw)
            if one_key:
                rel = _rel_err(got[2].float(), ref[2])
                if rel > BWD_REL_TOL:
                    raise AssertionError(f"{what} {label}: dv {rel}")
                w = max(w, rel)
                continue
            w = max(w, _grads_check(f"{what} {label}", got, ref))
            del got
        worst.append(w)
    return errs[0], errs[1], worst[0], worst[1]


def d256_case_check(torch, case, seed=0):
    """One ``D256_EDGE_CASES`` case through ``d256_check``, both modes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, sq, skv = case[:5]

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    d = GEMMA_HEAD_DIM
    return d256_check(torch, f"D=256 edge {case}", rnd(b, hq, sq, d),
                      rnd(b, hkv, skv, d), rnd(b, hkv, skv, d),
                      rnd(b, hq, sq, d), d256_case_mask(torch, case, dev),
                      modes=True)


# the head_dim 256 instantiations (mask-free, segmented) of the four block
# kernels: their libraries and a piece of their mangled names
D256_INSTANTIATIONS = {
    "B1 flash_fwd": ("flash_fwd", "flash_fwd_kernelILi256ELb0ELb0ELb0ELi0EE"),
    "B2 flash_bwd": ("flash_bwd", "bwd_kv_kernelILi256ELb1ELb0ELb0ELb0ELi0EE"),
    "B3a flash_bwd_dq": ("flash_bwd_split",
                         "bwd_dq_kernelILi256ELb0ELb0ELi0EE"),
    "B3b flash_bwd_dkv": ("flash_bwd_split",
                          "bwd_kv_kernelILi256ELb0ELb0ELb0ELb0ELi0EE"),
}
D256_SEG_INSTANTIATIONS = {
    "B1 flash_fwd": ("flash_fwd", "flash_fwd_kernelILi256ELb0ELb0ELb1ELi0EE"),
    "B2 flash_bwd": ("flash_bwd", "bwd_kv_kernelILi256ELb1ELb0ELb1ELb0ELi0EE"),
    "B3a flash_bwd_dq": ("flash_bwd_split",
                         "bwd_dq_kernelILi256ELb1ELb0ELi0EE"),
    "B3b flash_bwd_dkv": ("flash_bwd_split",
                          "bwd_kv_kernelILi256ELb0ELb0ELb1ELb0ELi0EE"),
}


def phase_d256(torch, flush):
    """Phase 23: head_dim 256 in B1, B2, B3a and B3b. Returns (the kernel
    entries of the head_dim 256 instantiations, the launches of the gemma
    path)."""
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.ops import _build
    from ring_flash_attn_tpu_torch.ops.flash import compute_delta
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import flash_bwd_cuda
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (naive_block_bwd,
                                                     naive_block_fwd)

    log("== phase 23: head_dim 256 (Gemma) in B1, B2, B3a and B3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    bf16 = torch.bfloat16
    d, s = GEMMA_HEAD_DIM, 8192
    built = _build.build_all()
    spills = {}
    for name in D256_INSTANTIATIONS:
        spills[name] = {
            "mask_free": kernel_ptxas(built, name, D256_INSTANTIATIONS),
            "segmented": kernel_ptxas(built, name, D256_SEG_INSTANTIATIONS)}
        log(f"  ptxas {name} D=256: {spills[name]}")
    for what, lib, piece in (("B1", "flash_fwd", "flash_fwd_kernel"),
                             ("B2", "flash_bwd", "bwd_kv_kernel"),
                             ("B3a", "flash_bwd_split", "bwd_dq_kernel"),
                             ("B3b", "flash_bwd_split", "bwd_kv_kernel")):
        counts = check_hgmma(what, lib, piece)
        if not any(k.startswith("D=256") for k in counts):
            raise AssertionError(f"{what}: no head_dim 256 build")

    # (a) the tile edges, mask-free and segmented, both backward modes
    worst = {"B1": [0.0, 0.0], "B2": 0.0, "B3": 0.0}

    def keep(errs):
        worst["B1"] = [max(worst["B1"][0], errs[0]),
                       max(worst["B1"][1], errs[1])]
        worst["B2"] = max(worst["B2"], errs[2])
        worst["B3"] = max(worst["B3"], errs[3])

    for i, case in enumerate(D256_EDGE_CASES):
        keep(d256_case_check(torch, case, seed=i))
    torch.cuda.empty_cache()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    # (b) Gemma-7B's and Gemma-2B's attention at S = 8192: causal (both
    # backward modes), then causal on positions on the four packings
    for model, (hq, hkv) in GEMMA_ATTN.items():
        q, k, v, dout = (rnd(1, hq, s, d), rnd(1, hkv, s, d),
                         rnd(1, hkv, s, d), rnd(1, hq, s, d))
        keep(d256_check(torch, f"{model} causal {s}", q, k, v, dout,
                        MaskArgs(causal=True), modes=True))
        torch.cuda.empty_cache()
        for cu in VARLEN_PACKINGS:
            keep(d256_check(torch, f"{model} {cu}", q, k, v, dout,
                            varlen_mask(torch, cu, True, dev)[0]))
            torch.cuda.empty_cache()
        del q, k, v, dout

    # (c) times at Gemma-7B's attention, causal: each kernel beside its
    # flop bound (the same flops as q (1,32,8192,128), kv (1,8,8192,128):
    # Hq D equal), the head_dim 128 kernel at those equal flops, the plain
    # version and SDPA at head_dim 256 (timed only)
    hq, hkv = GEMMA_ATTN["Gemma-7B"]
    mask = MaskArgs(causal=True)

    def kernel_fns(q, k, v, dout, out, lse, delta):
        sc = q.shape[-1] ** -0.5
        return {
            "B1 flash_fwd": lambda: flash_fwd_cuda(q, k, v, sc, mask,
                                                   out_dtype=bf16),
            "B2 flash_bwd": lambda: flash_bwd_cuda(
                dout, q, k, v, lse, None, sc, mask, out=out, dq_dtype=bf16,
                dkv_dtype=bf16),
            "B3a flash_bwd_dq": lambda: flash_bwd_dq_cuda(
                dout, q, k, v, lse, delta, sc, mask, dq_dtype=bf16),
            "B3b flash_bwd_dkv": lambda: flash_bwd_dkv_cuda(
                dout, q, k, v, lse, delta, sc, mask, dkv_dtype=bf16),
        }

    def operands(hq_, hkv_, d_):
        q, k, v, dout = (rnd(1, hq_, s, d_), rnd(1, hkv_, s, d_),
                         rnd(1, hkv_, s, d_), rnd(1, hq_, s, d_))
        out, lse = flash_fwd_cuda(q, k, v, d_ ** -0.5, mask, out_dtype=bf16)
        return q, k, v, dout, out, lse, compute_delta(dout, out)

    ops128 = operands(32, 8, 128)
    d128 = {n: kernel_ms(torch, fn, 10, flush)
            for n, fn in kernel_fns(*ops128).items()}
    del ops128
    ops = operands(hq, hkv, d)
    q, k, v, dout, out, lse, delta = ops
    times = {n: kernel_ms(torch, fn, 10, flush)
             for n, fn in kernel_fns(*ops).items()}
    plain = {"fwd": cuda_ms(torch, lambda: naive_block_fwd(
                 q, k, v, d ** -0.5, mask), 2, flush),
             "bwd": cuda_ms(torch, lambda: naive_block_bwd(
                 dout, q, k, v, lse, delta, d ** -0.5, mask), 2, flush)}
    torch.cuda.empty_cache()
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o_s = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa = {"fwd": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 10, flush),
            "bwd": cuda_ms(torch, lambda: torch.autograd.grad(
                o_s, leaves, dout, retain_graph=True), 10, flush)}
    del o_s, leaves
    pairs = s * (s + 1) // 2
    products = {"B1 flash_fwd": 2, "B2 flash_bwd": 5, "B3a flash_bwd_dq": 3,
                "B3b flash_bwd_dkv": 4}
    in_bytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, dout, k, v bf16
    out_bytes = {"B1 flash_fwd": 2 * q.numel() + 4 * lse.numel(),
                 "B2 flash_bwd": 2 * (q.numel() + 2 * k.numel()),
                 "B3a flash_bwd_dq": 2 * q.numel(),
                 "B3b flash_bwd_dkv": 2 * 2 * k.numel()}
    entries = []
    for name, t in times.items():
        flops = products[name] * 2 * hq * d * pairs
        nbytes = (in_bytes if name != "B1 flash_fwd"
                  else 2 * (q.numel() + 2 * k.numel())) + out_bytes[name]
        bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
        lib = sdpa["fwd" if name == "B1 flash_fwd" else "bwd"]
        log(f"  Gemma-7B causal {name} D=256: {t['ms']:.3f} ms (device "
            f"{t['device_ms']:.3f}), bound {bound:.3f} ms "
            f"({t['ms'] / bound:.2f}x); D=128 at equal flops "
            f"{d128[name]['ms']:.3f} ms; SDPA D=256 {lib:.3f} ms")
        b1 = name == "B1 flash_fwd"
        entries.append({
            "name": f"{name} D256", "route": "cuda",
            "source": "ring_flash_attn_tpu_torch/csrc/" + {
                "B1 flash_fwd": "flash_fwd.cu", "B2 flash_bwd": "flash_bwd.cu",
            }.get(name, "flash_bwd_split.cu"),
            "replaces": {
                "B1 flash_fwd": "ring_flash_attn_tpu/ops/pallas_fwd.py:161",
                "B2 flash_bwd":
                    "ring_flash_attn_tpu/ops/pallas_bwd_fused.py:59",
                "B3a flash_bwd_dq": "ring_flash_attn_tpu/ops/pallas_bwd.py:56",
                "B3b flash_bwd_dkv":
                    "ring_flash_attn_tpu/ops/pallas_bwd.py:256"}[name],
            "shape": f"q (1,{hq},{s},{d}) kv (1,{hkv},{s},{d}) bf16 causal "
                     f"(Gemma-7B attention)",
            "max_abs_err": worst["B1"][0] if b1 else None,
            "max_rel_err": worst["B1"][1] if b1 else worst[
                "B2" if name == "B2 flash_bwd" else "B3"],
            **t, "plain_ms": plain["fwd" if b1 else "bwd"],
            "bound_ms": bound,
            "bound_by": "operations" if flops / H100_BF16_FLOPS
            >= nbytes / H100_BYTES_PER_S else "bytes",
            "library_ms": lib, "d128_equal_flops_ms": d128[name]["ms"],
            "d128_equal_flops_device_ms": d128[name]["device_ms"],
            "ptxas": spills[name]["mask_free"],
            "ptxas_varlen": spills[name]["segmented"]})
    del ops, q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()

    # (d) the gemma path, whose launches are counted: flash_attn_func at
    # Gemma-7B's attention (B1, B2; deterministic: B3a, B3b),
    # flash_attn_varlen_func on the four packings (segmented B1, B2), then
    # the HF adapter's ring_attention_forward at Gemma-7B widths on 32768
    # tokens (segmented B1; B3a and B3b past B2's limit at head_dim 256)
    counters = {"B1 flash_fwd": flash_fwd_cuda, "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda}
    launches = {}
    q, k, v, dout = (rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d),
                     rnd(1, s, hq, d))
    def plain_ref(qb, kb, vb, db, m):
        """The plain versions' (out, lse) and gradients, (B, H, S, D)."""
        ro, rl = naive_block_fwd(qb, kb, vb, d ** -0.5, m)
        rg = naive_block_bwd(db, qb, kb, vb, rl, compute_delta(db, ro),
                             d ** -0.5, m)
        return ro, rl, rg

    def bhsd(x):
        return x.transpose(1, 2)

    for det in (False, True):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        with _path_run(counters, launches):
            o, lse_o, _ = api.flash_attn_func(*leaves, causal=True,
                                              deterministic=det,
                                              return_attn_probs=True)
            g = torch.autograd.grad(o, leaves, dout)
        ro, rl, rg = plain_ref(*(bhsd(x) for x in (q, k, v, dout)),
                               MaskArgs(causal=True))
        _varlen_check(f"flash_attn_func deterministic={det}",
                      (bhsd(o), lse_o), (ro, rl), B1_OUT_TOL, B1_LSE_TOL)
        _grads_check(f"flash_attn_func deterministic={det} backward",
                     [bhsd(x) for x in g], rg)
        del o, g, ro, rg, leaves
        torch.cuda.empty_cache()
    t3 = [x[0] for x in (q, k, v, dout)]  # (T, H, D)
    for cu in VARLEN_PACKINGS:
        leaves = [x.detach().requires_grad_() for x in t3[:3]]
        cu_t = torch.tensor(cu, device=dev, dtype=torch.int32)
        with _path_run(counters, launches):
            o, lse_o, _ = api.flash_attn_varlen_func(
                *leaves, cu_t, causal=True, return_attn_probs=True)
            g = torch.autograd.grad(o, leaves, t3[3])
        ro, rl, rg = plain_ref(*(bhsd(x[None]) for x in (*t3[:3], t3[3])),
                               varlen_mask(torch, cu, True, dev)[0])
        _varlen_check(f"flash_attn_varlen_func {cu}", (bhsd(o[None]),
                                                       lse_o[None]),
                      (ro, rl), B1_OUT_TOL, B1_LSE_TOL)
        _grads_check(f"flash_attn_varlen_func {cu} backward",
                     [bhsd(x[None]) for x in g], rg)
        del o, g, ro, rg, leaves
        torch.cuda.empty_cache()
    del q, k, v, dout, t3
    torch.cuda.empty_cache()
    adapter_launches, adapter_times = phase_adapter(torch, hq, hkv, d)
    for name, n in adapter_launches.items():
        launches[name] = launches.get(name, 0) + n
    log(f"  launches on the gemma path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a head_dim 256 kernel of the gemma path never "
                             f"ran: {launches}")
    for e in entries:
        e["launches"] = launches[e["name"][:-5]]
        e["launches_by_path"] = {"gemma": launches[e["name"][:-5]]}
    entries[0]["adapter_w4_per_rank_ms"] = adapter_times
    return entries, launches


# Gemma-2-9B's attention (google/gemma-2-9b config.json): 16 q heads and 8
# kv heads of 256, attn_logit_softcapping 50.0, query_pre_attn_scalar 256
# (scale 256^-0.5), sliding_window 4096 on every other layer (the window
# (4096, 0) as phase 18 takes Mistral's)
GEMMA2_ATTN = dict(heads=16, kv_heads=8, head_dim=256, softcap=50.0,
                   sliding_window=4096)
# the kernels line's entries of the head_dim 256 builds this phase adds:
# the build the Gemma 2 path times (XFORM: the global layers, softcap;
# BAND: the sliding layers, window and softcap, the ALL build) by its
# library and a piece of its mangled name
D256_NEW_INSTANTIATIONS = {
    "B1 flash_fwd D256 XFORM": (
        "flash_fwd", "flash_fwd_kernelILi256ELb0ELb1ELb0ELi0EE"),
    "B1 flash_fwd D256 BAND": (
        "flash_fwd", "flash_fwd_kernelILi256ELb0ELb1ELb0ELi2EE"),
    "B2 flash_bwd D256 XFORM": (
        "flash_bwd", "bwd_kv_kernelILi256ELb1ELb0ELb0ELb1ELi0EE"),
    "B2 flash_bwd D256 BAND": (
        "flash_bwd", "bwd_kv_kernelILi256ELb1ELb0ELb0ELb1ELi2EE"),
    "B3a flash_bwd_dq D256 XFORM": (
        "flash_bwd_split", "bwd_dq_kernelILi256ELb0ELb1ELi0EE"),
    "B3a flash_bwd_dq D256 BAND": (
        "flash_bwd_split", "bwd_dq_kernelILi256ELb0ELb1ELi2EE"),
    "B3b flash_bwd_dkv D256 XFORM": (
        "flash_bwd_split", "bwd_kv_kernelILi256ELb0ELb0ELb0ELb1ELi0EE"),
    "B3b flash_bwd_dkv D256 BAND": (
        "flash_bwd_split", "bwd_kv_kernelILi256ELb0ELb0ELb0ELb1ELi2EE"),
    "B7 fused_ring_fwd D256": (
        "fused_ring_fwd", "flash_fwd_kernelILi256ELb1ELb1ELb0ELi0EE"),
    "B8 fused_ring_bwd D256": (
        "fused_ring_bwd", "bwd_kv_kernelILi256ELb1ELb1ELb0ELb1ELi0EE"),
}


def d256_builds_ptxas(built, name):
    """ptxas's facts of every head_dim 256 build of a kernel line entry's
    family (the XFORM builds of its kernel, with and without SEG and
    BAND): {template arguments: facts}."""
    lib, piece = D256_NEW_INSTANTIATIONS[name]
    kernel = piece[:piece.index("I")]
    out = {}
    for fn, f in ptxas_facts(built[lib][:-3] + ".log").items():
        flags = loop_flags(kernel, fn)
        if flags and flags["D"] == 256 and flags["xform"]:
            out["<" + ", ".join(map(str, flags.values())) + ">"] = f
    return out


def phase_gemma2(torch, flush):
    """Phase 25: Gemma 2's attention at head_dim 256: the softcap/ALiBi and
    window/dropout builds of B1 to B3b and B7/B8 at 256. Returns (the
    kernel entries of those builds, the gemma2 path's launches)."""
    import torch.nn.functional as F

    from ring_flash_attn_tpu_torch import api
    from ring_flash_attn_tpu_torch.adapters import adapter
    from ring_flash_attn_tpu_torch.models import ModelConfig, init_params
    from ring_flash_attn_tpu_torch.models.serve import (
        _decode_body, _spec_verify_body)
    from ring_flash_attn_tpu_torch.ops import _build
    from ring_flash_attn_tpu_torch.ops.flash import (
        block_bwd, block_fwd, compute_delta)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_cuda import (
        bwd_delta, flash_bwd_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_bwd_split_cuda import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.mask import MaskArgs
    from ring_flash_attn_tpu_torch.ops.naive import (
        naive_block_bwd, naive_block_fwd)
    from ring_flash_attn_tpu_torch.ops.varlen import (
        cu_seqlens_to_positions, cu_seqlens_to_segids)
    from ring_flash_attn_tpu_torch.parallel import (
        fused_ring as fr, layouts, ring, zigzag)
    from ring_flash_attn_tpu_torch.parallel.fused_ring_cuda import (
        fused_ring_bwd_cuda, fused_ring_fwd_cuda)

    log("== phase 25: Gemma 2's attention at head_dim 256: softcap, ALiBi, "
        "windows and dropout in B1, B2, B3a/B3b, and B7/B8")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    bf16 = torch.bfloat16
    hq, hkv, d, cap, wl = (GEMMA2_ATTN[x] for x in (
        "heads", "kv_heads", "head_dim", "softcap", "sliding_window"))
    s, big, tail, world = 8192, 32768, 512, 4
    scale = d ** -0.5
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B2 flash_bwd": flash_bwd_cuda,
                "B3a flash_bwd_dq": flash_bwd_dq_cuda,
                "B3b flash_bwd_dkv": flash_bwd_dkv_cuda,
                "B7 fused_ring_fwd": fused_ring_fwd_cuda,
                "B8 fused_ring_bwd": fused_ring_bwd_cuda}
    built = _build.build_all()
    for what, lib, piece in (("B1", "flash_fwd", "flash_fwd_kernel"),
                             ("B2", "flash_bwd", "bwd_kv_kernel"),
                             ("B3a", "flash_bwd_split", "bwd_dq_kernel"),
                             ("B3b", "flash_bwd_split", "bwd_kv_kernel"),
                             ("B7", "fused_ring_fwd", "flash_fwd_kernel"),
                             ("B8", "fused_ring_bwd", "bwd_kv_kernel")):
        counts = check_hgmma(what, lib, piece)
        want = (["D=256 XFORM"] if what in ("B7", "B8") else
                ["D=256 XFORM", "D=256 XFORM SEG", "D=256 XFORM BAND=1",
                 "D=256 XFORM BAND=2", "D=256 XFORM BAND=1 SEG",
                 "D=256 XFORM BAND=2 SEG"])
        if what == "B7":
            want.append("D=256")
        if any(w not in counts for w in want):
            raise AssertionError(f"{what}: a head_dim 256 build is missing: "
                                 f"{sorted(counts)}")
    ptx = {name: kernel_ptxas(built, name, D256_NEW_INSTANTIATIONS)
           for name in D256_NEW_INSTANTIATIONS}
    for name, f in ptx.items():
        log(f"  ptxas {name}: {f}")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def uncounted():
        return _uncounted(counters)

    # (a) the tile edges of every new build, then the full width's last
    # 512 rows over every key, global and sliding, q and q x 4 (logits of
    # about N(0, 16), which the cap of 50 bends)
    worst = {k: [0.0, 0.0] for k in ("B1", "B2", "B3a", "B3b", "B7", "B8")}

    def keep_worst(w):
        for key, errs in w.items():
            worst[key] = [max(a, b) for a, b in zip(worst[key], errs)]

    with uncounted():
        for i, case in enumerate(D256_XFORM_EDGE_CASES):
            keep_worst(xform_case_check(torch, case, seed=i))
        for i in range(len(D256_BAND_EDGE_CASES)):
            keep_worst(band_case_check(torch, i, D256_BAND_EDGE_CASES))
        for i, case in enumerate(D256_RING_CASES):
            keep_worst(d256_ring_case_check(torch, case, seed=i))
        grown = d256_growth_check(torch)
        log(f"  growing logits (O rescaled past the running max's slack): "
            f"worst {grown}")
        # B7 and B8 at the path's own shape: a rank's diagonal step and an
        # earlier shard of 8192 keys each, plain on the last 512 q rows (as
        # phase 10's headline case at 128), with the path's cap of 50 and a
        # cap of 5 that bends the logits over all 128 key blocks
        for c in (cap, 5.0):
            fused_ring_case(
                torch, rnd, worst, f"Gemma-2-9B q (1,{hq},{s},{d}) kv "
                f"(1,{hkv},{s},{d}), softcap {c}, last {tail} rows", 1, hq,
                hkv, s, s, d, [dict(diagonal=True, q_pos0=s, kv_pos0=s),
                               dict(diagonal=False, q_pos0=s, kv_pos0=0)],
                cap=c, q_slice=tail)
        torch.cuda.empty_cache()
    log(f"  (a) {len(D256_XFORM_EDGE_CASES)} softcap/ALiBi, "
        f"{len(D256_BAND_EDGE_CASES)} window/dropout and "
        f"{len(D256_RING_CASES)} ring tile-edge cases and B7/B8 at "
        f"Gemma-2-9B's shard within the limits; worst {worst}")

    glob = MaskArgs(causal=True, softcap=cap)
    slide = glob._replace(window_left=wl)
    layers = {"global": glob, "sliding": slide}
    q, k, v, dout = (rnd(1, hq, big, d), rnd(1, hkv, big, d),
                     rnd(1, hkv, big, d), rnd(1, hq, big, d))
    q8, k8, v8, d8 = (x[:, :, :s].contiguous() for x in (q, k, v, dout))

    def tail_check(what, qq, kk, vv, dd, mask):
        w, plain = _tail_check(torch, what, qq, kk, vv, dd, mask, scale,
                               tail, counters)
        keep_worst(w)
        return plain

    plain_tail = {}
    for layer, mask in layers.items():
        plain_tail[layer] = tail_check(f"Gemma-2-9B {layer} S={s}", q8, k8,
                                       v8, d8, mask)
        tail_check(f"Gemma-2-9B {layer} S={s}, q x 4", q8 * 4, k8, v8, d8,
                   mask)

    # (b) the times at S = 8192, each layer kind beside its flop bound (the
    # causal pairs, or the window's band), the same kernel without the
    # transform, the plain version and SDPA (is_causal for the global
    # layers, the dense band mask for the sliding ones; SDPA has no
    # softcap: the same work without it)
    products = {"B1": 2, "B2": 5, "B3a": 3, "B3b": 4}
    pairs = {"global": s * (s + 1) // 2, "sliding": band_pairs(s, wl)}

    def fns(mask, qq=q8):
        out, lse = flash_fwd_cuda(qq, k8, v8, scale, mask, out_dtype=bf16)
        delta = compute_delta(d8, out)
        return {
            "B1": lambda: flash_fwd_cuda(qq, k8, v8, scale, mask,
                                         out_dtype=bf16),
            "B2": lambda: flash_bwd_cuda(d8, qq, k8, v8, lse, None, scale,
                                         mask, out=out, dq_dtype=bf16,
                                         dkv_dtype=bf16),
            "B3a": lambda: flash_bwd_dq_cuda(d8, qq, k8, v8, lse, delta,
                                             scale, mask, dq_dtype=bf16),
            "B3b": lambda: flash_bwd_dkv_cuda(d8, qq, k8, v8, lse, delta,
                                              scale, mask, dkv_dtype=bf16)}

    timed = {}
    with uncounted():
        for layer, mask in layers.items():
            timed[layer] = {n: kernel_ms(torch, fn, 5, flush)
                            for n, fn in fns(mask).items()}
            base = mask._replace(softcap=None)
            timed[layer + " without softcap"] = {
                n: kernel_ms(torch, fn, 5, flush)
                for n, fn in fns(base).items()}
    plain_ms = {}
    for layer, mask in layers.items():
        out, lse = flash_fwd_cuda(q8, k8, v8, scale, mask, out_dtype=bf16)
        delta = compute_delta(d8, out)
        plain_ms[layer] = {
            "fwd": cuda_ms(torch, lambda: naive_block_fwd(
                q8, k8, v8, scale, mask), 1, flush),
            "bwd": cuda_ms(torch, lambda: naive_block_bwd(
                d8, q8, k8, v8, lse, delta, scale, mask), 1, flush)}
        del out, lse, delta
        torch.cuda.empty_cache()
    library = {}
    i = torch.arange(s, dtype=torch.int32, device=dev)
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] <= wl)
    qr, kr, vr = (x.repeat_interleave(hq // x.shape[1], dim=1)
                  for x in (q8, k8, v8))
    for layer, kw in (("global", dict(is_causal=True)),
                      ("sliding", dict(attn_mask=band))):
        leaves = [x.detach().requires_grad_() for x in (qr, kr, vr)]
        o = F.scaled_dot_product_attention(*leaves, **kw)
        library[layer] = {
            "fwd": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qr, kr, vr, **kw), 5, flush),
            "bwd": cuda_ms(torch, lambda: torch.autograd.grad(
                o, leaves, d8, retain_graph=True), 3, flush)}
        del o, leaves
    del band, i
    torch.cuda.empty_cache()
    for layer in layers:
        for name in products:
            t = timed[layer][name]
            bound = products[name] * 2 * hq * d * pairs[layer] \
                / H100_BF16_FLOPS * 1e3
            t["bound_ms"] = bound
            lib = library[layer]["fwd" if name == "B1" else "bwd"]
            log(f"  {name} {layer} (softcap {cap}"
                + (f", window ({wl}, 0)" if layer == "sliding" else "")
                + f") S={s}: {t['ms']:.3f} ms (device {t['device_ms']:.3f}), "
                f"bound {bound:.3f} ms ({t['ms'] / bound:.2f}x), without "
                f"softcap {timed[layer + ' without softcap'][name]['ms']:.3f}"
                f" ms; SDPA {lib:.3f} ms; plain "
                f"{plain_ms[layer]['fwd' if name == 'B1' else 'bwd']:.1f} ms")

    # (c) B7 and B8 at 256 with the softcap: one off-diagonal and one
    # diagonal step of a W = 4 ring of 32768 tokens (8192 a rank), beside
    # SDPA not causal at 256
    qs, vsc = fr._prescale(q8, scale * fr.LOG2E), fr._prescale(v8, scale)
    tk = fr._transforms(q8, True, cap, None)
    state = fr.new_state(qs)
    with uncounted():
        fr.fwd_step(qs, k8, v8, state, diagonal=True, first=True,
                    last=False, **tk)
        out, lse = fr.fwd_step(qs, k8, v8, state, diagonal=False,
                               first=False, last=True, **tk)
        lse2 = (lse * fr.LOG2E).contiguous()
        delta = bwd_delta(d8, out) * scale
    dq = torch.zeros(q8.shape, dtype=torch.float32, device=dev)
    dkv = torch.zeros((2, 1, hkv, s, d), dtype=torch.float32, device=dev)

    def fwd(diagonal, backend=None):
        return fr.fwd_step(qs, k8, v8, state, backend=backend,
                           diagonal=diagonal, first=diagonal, last=False,
                           **tk)

    def bwd(diagonal, backend=None):
        return fr.bwd_step(qs, k8, vsc, d8, lse2, delta, dq, dkv[0], dkv[1],
                           backend=backend, diagonal=diagonal,
                           accumulate=not diagonal, **tk)

    with uncounted():
        ring_t = {"B7": kernel_ms(torch, lambda: fwd(False), 5, flush),
                  "B7 diagonal": kernel_ms(torch, lambda: fwd(True), 5,
                                           flush),
                  "B8": kernel_ms(torch, lambda: bwd(False), 3, flush),
                  "B8 diagonal": kernel_ms(torch, lambda: bwd(True), 3,
                                           flush)}
        ring_plain = {"B7": cuda_ms(torch, lambda: fwd(False, "plain"), 1,
                                    flush)}
        torch.cuda.empty_cache()
        ring_plain["B8"] = cuda_ms(torch, lambda: bwd(False, "plain"), 1,
                                   flush)
    torch.cuda.empty_cache()
    leaves = [x.detach().requires_grad_() for x in (qr, kr, vr)]
    o = F.scaled_dot_product_attention(*leaves)
    ring_lib = {"B7": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qr, kr, vr), 5, flush),
                "B8": cuda_ms(torch, lambda: torch.autograd.grad(
                    o, leaves, d8, retain_graph=True), 3, flush)}
    del o, leaves, state, dq, dkv, qs, vsc, out, lse, lse2, delta, qr, kr, vr
    torch.cuda.empty_cache()
    n_q, n_kv, rows = q8.numel(), k8.numel(), hq * s
    per_product = 2 * hq * d * s * s
    ring_bound = {
        "B7": max(2 * per_product / H100_BF16_FLOPS,
                  (2 * (n_q + 2 * n_kv) + 2 * 4 * (n_q + 2 * rows))
                  / H100_BYTES_PER_S) * 1e3,
        "B8": max(5 * per_product / H100_BF16_FLOPS,
                  (2 * (2 * n_q + 2 * n_kv) + 2 * 4 * rows
                   + 2 * 4 * (n_q + 2 * n_kv)) / H100_BYTES_PER_S) * 1e3}
    for name in ("B7", "B8"):
        log(f"  {name} at 256 with softcap {cap}, one step of 8192 rows over "
            f"8192 keys: off-diagonal {ring_t[name]['ms']:.3f} ms (device "
            f"{ring_t[name]['device_ms']:.3f}), diagonal "
            f"{ring_t[name + ' diagonal']['ms']:.3f} ms, bound "
            f"{ring_bound[name]:.3f} ms ({ring_t[name]['ms'] / ring_bound[name]:.2f}x)"
            f"; SDPA not causal {ring_lib[name]:.3f} ms; plain "
            f"{ring_plain[name]:.1f} ms")

    # (d) the gemma2 path, whose launches are counted: flash_attn_func
    # (and deterministic: B3a/B3b) and flash_attn_varlen_func, global and
    # sliding, at S = 8192 against the plain versions' last rows; ring and
    # zigzag at W = 4 over 32768 tokens, global and sliding, against the
    # kernels on the whole sequence; the fused ring (B7; bwd_mode "fused":
    # B8, "auto": the schedule's B2 at these widths) on the global layers;
    # the adapter's ring_attention_forward(softcap=50) at W = 1
    launches = {}

    def path_run():
        return _path_run(counters, launches,
                         ("launches", "xform_launches", "band_launches"))

    def bhsd(x):
        return x.transpose(1, 2)

    for layer, mask in layers.items():
        kw = dict(softcap=cap, window_size=(wl, 0) if layer == "sliding"
                  else (-1, -1))
        for det in (False, True):
            leaves = [bhsd(x).detach().clone().requires_grad_()
                      for x in (q8, k8, v8)]
            with path_run():
                o, lse_a, _ = api.flash_attn_func(
                    *leaves, causal=True, return_attn_probs=True,
                    deterministic=det, **kw)
                g = torch.autograd.grad(o, leaves, bhsd(d8))
            plain = plain_tail[layer]
            got = (bhsd(o.detach())[:, :, -tail:], lse_a[:, :, -tail:],
                   bhsd(g[0])[:, :, -tail:])
            errs = (max_err(got[0], plain[0]), rel_err_rows(got[0], plain[0]),
                    max_err(got[1], plain[1]), _rel_err(got[2], plain[2]))
            log(f"    flash_attn_func {layer} deterministic={det}: last "
                f"{tail} rows against the plain versions: out {errs[0]:.3e} "
                f"(rows {errs[1]:.3e}), lse {errs[2]:.3e}, dq {errs[3]:.2e}")
            if (errs[0] > B1_OUT_TOL or errs[1] > RING_OUT_REL_TOL
                    or errs[2] > B1_LSE_TOL or errs[3] > BWD_REL_TOL
                    or not all(bool(torch.isfinite(y).all()) for y in g)):
                raise AssertionError(f"flash_attn_func {layer} is wrong")
            del leaves, o, lse_a, g, got
        # flash_attn_varlen_func on the five-sequence packing: the last
        # 512 rows against the plain versions with the packing's mask
        cu = VARLEN_PACKINGS[3]
        leaves = [x[0].transpose(0, 1).detach().clone().requires_grad_()
                  for x in (q8, k8, v8)]
        with path_run():
            o, lse_v, _ = api.flash_attn_varlen_func(
                *leaves, torch.tensor(cu, device=dev), causal=True,
                return_attn_probs=True, **kw)
            g = torch.autograd.grad(o, leaves, d8[0].transpose(0, 1))
        seg = cu_seqlens_to_segids(cu, s, dev)
        pos = cu_seqlens_to_positions(cu, s, dev)
        m = mask._replace(q_segids=seg[-tail:], kv_segids=seg,
                          q_pos=pos[-tail:], kv_pos=pos, packed_self=False)
        qt, dt = (x[:, :, -tail:].contiguous() for x in (q8, d8))
        ro, rl = naive_block_fwd(qt, k8, v8, scale, m)
        with uncounted():
            ob = flash_fwd_cuda(qt, k8, v8, scale, m, out_dtype=bf16)[0]
        rg = naive_block_bwd(dt, qt, k8, v8, rl, compute_delta(dt, ob),
                             scale, m)
        got_o = o.detach().transpose(0, 1)[None][:, :, -tail:]
        errs = (max_err(got_o, ro), rel_err_rows(got_o, ro),
                max_err(lse_v[None][:, :, -tail:], rl),
                _rel_err(g[0].transpose(0, 1)[None][:, :, -tail:], rg[0]))
        log(f"    flash_attn_varlen_func {layer} {cu}: last {tail} rows "
            f"against the plain versions: out {errs[0]:.3e} (rows "
            f"{errs[1]:.3e}), lse {errs[2]:.3e}, dq {errs[3]:.2e}")
        if (errs[0] > B1_OUT_TOL or errs[1] > RING_OUT_REL_TOL
                or errs[2] > B1_LSE_TOL or errs[3] > BWD_REL_TOL):
            raise AssertionError(f"flash_attn_varlen_func {layer} is wrong")
        del leaves, o, lse_v, g, ro, rl, rg, ob
        torch.cuda.empty_cache()

    def hold(what, got, ref, parts=world):
        """(out, lse, dq, dk, dv) against the whole-sequence kernels'."""
        errs = [_rel_err_parts(got[0], ref[0], parts), max_err(got[1],
                                                              ref[1])]
        rel = [_rel_err(x, r) for x, r in zip(got[2:], ref[2:])]
        log(f"    {what}: out of max|ref| by parts {errs[0]:.3e}, lse "
            f"{errs[1]:.3e}, rel dq dk dv " + " ".join(
                f"{x:.2e}" for x in rel))
        if (errs[0] > RING_OUT_REL_TOL or errs[1] > RING_LSE_TOL
                or max(rel) > BWD_REL_TOL):
            raise AssertionError(f"{what} is wrong")

    layouts_of = {
        "ring": (lambda x: [c.contiguous() for c in x.chunk(world, dim=2)],
                 lambda parts: torch.cat(parts, dim=2)),
        "zigzag": (lambda x: [layouts.extract_local_zigzag(
            x, r, world, axis=2).contiguous() for r in range(world)],
            lambda parts: layouts.restore_zigzag(
                torch.cat(parts, dim=2), world, axis=2)),
    }
    for layer, mask in layers.items():
        with uncounted():
            ref_o, ref_l = block_fwd(q, k, v, scale, mask, out_dtype=bf16)
            ref_g = block_bwd(dout, q, k, v, ref_l, None, scale, mask,
                              out=ref_o)
        ref = (ref_o, ref_l, *ref_g)
        extras = dict(softcap=cap)
        if layer == "sliding":
            extras["window_left"] = wl
        for sched, (split, join) in layouts_of.items():
            qs_, ks_, vs_, ds_ = (split(x) for x in (q, k, v, dout))
            ll = qs_[0].shape[2]
            if sched == "zigzag":
                step_masks = zigzag._batch_masks(ll // 2, extras, dev)
                rank_fwd, rank_bwd = _zigzag_rank_fwd, _zigzag_rank_bwd
            else:
                step_masks = ring._ring_masks(True, ll, extras)
                rank_fwd, rank_bwd = _rank_fwd, _rank_bwd
            with path_run():
                res = [rank_fwd(qs_, ks_, vs_, r, scale, step_masks)
                       for r in range(world)]
                outs, lses = [o for o, _ in res], [x for _, x in res]
                dkvs = [torch.zeros((2,) + tuple(x.shape),
                                    dtype=torch.float32, device=dev)
                        for x in ks_]
                dqs = [rank_bwd(qs_, ks_, vs_, ds_, outs, lses, dkvs, r,
                                scale, step_masks) for r in range(world)]
            got = (join(outs), join(lses), join(dqs),
                   join([x[0] for x in dkvs]), join([x[1] for x in dkvs]))
            hold(f"{sched} W={world} S={big} {layer}", got, ref)
            del res, outs, lses, dkvs, dqs, got, qs_, ks_, vs_, ds_
            torch.cuda.empty_cache()
        if layer == "global":
            # the fused ring: B7's forward, then bwd_mode "fused" (B8) and
            # "auto", which at these widths picks the schedule (B2)
            ll = big // world
            auto = fr.fused_ring_bwd_supported(ll, d, hq // hkv, 2)
            if auto:
                raise AssertionError("bwd_mode='auto' picks the fused "
                                     "backward at Gemma 2's widths")
            with path_run():
                fo, fl = ring_forward_one_device(q, k, v, world, scale, True,
                                                 softcap=cap)
            with path_run():
                fg = ring_backward_one_device(q, k, v, dout, fo, fl, world,
                                              scale, True, softcap=cap)
            hold(f"fused ring W={world} S={big} global, bwd_mode fused",
                 (fo, fl, *fg), ref)
            del fg
            qs_, ks_, vs_, ds_, os_, ls_ = (
                [c.contiguous() for c in x.chunk(world, dim=2)]
                for x in (q, k, v, dout, fo, fl))
            with path_run():
                dkvs = [torch.zeros((2,) + tuple(x.shape),
                                    dtype=torch.float32, device=dev)
                        for x in ks_]
                dqs = [_rank_bwd(qs_, ks_, vs_, ds_, os_, ls_, dkvs, r,
                                 scale, ring._ring_masks(True, ll, dict(
                                     softcap=cap))) for r in range(world)]
            hold(f"fused ring W={world} S={big} global, bwd_mode auto "
                 f"(schedule)", (fo, fl, torch.cat(dqs, dim=2),
                                 torch.cat([x[0] for x in dkvs], dim=2),
                                 torch.cat([x[1] for x in dkvs], dim=2)),
                 ref)
            del fo, fl, dqs, dkvs, qs_, ks_, vs_, ds_, os_, ls_
        # the adapter's ring_attention_forward at W = 1 (a world of one)
        # on the five-sequence packing x 4 through position_ids
        cu = [4 * x for x in VARLEN_PACKINGS[3]]
        pos = cu_seqlens_to_positions(cu, big, dev)[None]
        t3 = [x[0].transpose(0, 1) for x in (q, k, v, dout)]
        leaves = [x.detach().clone().requires_grad_() for x in t3[:3]]
        with uncounted():
            ref_o2, _, _ = api.flash_attn_varlen_func(
                *leaves, torch.tensor(cu, device=dev), causal=True,
                return_attn_probs=True, softcap=cap,
                window_size=(wl, 0) if layer == "sliding" else (-1, -1))
            ref_g2 = torch.autograd.grad(ref_o2, leaves, t3[3])
        leaves = [x.detach()[None].requires_grad_() for x in t3[:3]]
        adapter.DATA_PARAMS.clear()
        with path_run():
            o = adapter.ring_attention_forward(
                *leaves, causal=True, position_ids=pos, softcap=cap,
                window_left=wl if layer == "sliding" else None)
            g = torch.autograd.grad(o, leaves, t3[3][None])
        err = _rel_err(o.detach()[0].float(), ref_o2.float())
        log(f"    ring_attention_forward(softcap={cap}) {layer} W=1 on {cu}:"
            f" out {err:.2e} of max|ref|")
        if err > RING_OUT_REL_TOL:
            raise AssertionError(f"ring_attention_forward {layer} is wrong")
        _grads_check(f"ring_attention_forward {layer} backward",
                     [x[0] for x in g], ref_g2)
        del ref_o2, ref_g2, leaves, o, g, t3, ref, ref_o, ref_l, ref_g
        torch.cuda.empty_cache()
    del q, k, v, dout, q8, k8, v8, d8
    torch.cuda.empty_cache()
    log(f"  launches on the gemma2 path: {launches}")
    need = [f"{n} {a}" for n in list(counters)[:4]
            for a in ("xform_launches", "band_launches")] + [
        "B7 fused_ring_fwd", "B8 fused_ring_bwd"]
    if min(launches[n] for n in need) <= 0:
        raise AssertionError(f"a head_dim 256 build of the gemma2 path "
                             f"never ran: {launches}")

    # (e) the serving read path alone: a decode step and a verify step with
    # append=False at phase 4's widths, the caches as they were afterwards,
    # the logits against the plain versions' with append=False, and each
    # timed beside append=True
    cfg = ModelConfig(**FULL_WIDTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    pages, toks, live, tables, lens = _prefilled_lanes(
        torch, model, _traffic(cfg.vocab))
    rng = np.random.default_rng(25)
    cand = torch.cat([toks[:, None], torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(4, 3)), device="cuda")], dim=1)
    n_valid = torch.where(live, 4, 0).to(torch.int32)
    bodies = {
        "decode": lambda caches, append, backend=None: _decode_body(
            model, toks, live, caches, backend=backend, append=append),
        "verify": lambda caches, append, backend=None: _spec_verify_body(
            model, cand, n_valid, caches, backend=backend, append=append)}
    serving = {}
    for name, body in bodies.items():
        caches = _caches(torch, pages, tables, lens)
        before = [(c.k_pages.clone(), c.v_pages.clone()) for c in caches]
        got, after = body(caches, False)
        plain, _ = body(_caches(torch, pages, tables, lens), False, "plain")
        appended, _ = body(_caches(torch, pages, tables, lens), True)
        same = all(torch.equal(a.k_pages, b[0]) and torch.equal(a.v_pages,
                                                                b[1])
                   and torch.equal(a.seq_lens, lens)
                   for a, b in zip(after, before))
        err = _rel_err(got, plain)
        moved = _rel_err(got, appended)
        times = {f"append={a}": _step_times(
            torch, lambda a=a: body(_caches(torch, pages, tables, lens), a))
            for a in (False, True)}
        log(f"  (e) {name} step with append=False: caches untouched {same}, "
            f"logits against the plain versions {err:.2e} of max|logit| "
            f"(tol {LOGITS_REL_TOL}), {moved:.2e} from append=True's; wall / "
            f"device ms " + "; ".join(f"{n} {w:.3f} / {dv:.3f}"
                                      for n, (w, dv) in times.items()))
        if not same or err > LOGITS_REL_TOL or not torch.isfinite(got).all():
            raise AssertionError(f"append=False {name} step is wrong")
        serving[name] = {"rel_err_plain": err, "rel_from_append": moved,
                         "wall_device_ms": times}
    del model, pages, caches, before, after
    torch.cuda.empty_cache()

    # the kernels line's entries
    sources = {"B1": "flash_fwd.cu", "B2": "flash_bwd.cu",
               "B3a": "flash_bwd_split.cu", "B3b": "flash_bwd_split.cu",
               "B7": "fused_ring_fwd.cu", "B8": "fused_ring_bwd.cu"}
    replaces = {"B1": "ring_flash_attn_tpu/ops/pallas_fwd.py:161",
                "B2": "ring_flash_attn_tpu/ops/pallas_bwd_fused.py:59",
                "B3a": "ring_flash_attn_tpu/ops/pallas_bwd.py:56",
                "B3b": "ring_flash_attn_tpu/ops/pallas_bwd.py:256",
                "B7": "ring_flash_attn_tpu/parallel/fused_ring.py:74",
                "B8": "ring_flash_attn_tpu/parallel/fused_ring.py:474"}
    entries = []
    for name in D256_NEW_INSTANTIATIONS:
        short, base = name.split()[0], " ".join(name.split()[:2])
        common = {"name": name, "route": "cuda",
                  "source": "ring_flash_attn_tpu_torch/csrc/" + sources[short],
                  "replaces": replaces[short],
                  "max_abs_err": worst[short][0],
                  "max_rel_err": worst[short][1],
                  "ptxas": ptx[name],
                  "ptxas_d256_builds": d256_builds_ptxas(built, name),
                  "bound_by": "operations"}
        if short in ("B7", "B8"):
            t = ring_t[short]
            entries.append(dict(
                common, launches=launches[base],
                ms=t["ms"], device_ms=t["device_ms"],
                diagonal=ring_t[short + " diagonal"],
                plain_ms=ring_plain[short], bound_ms=ring_bound[short],
                library_ms=ring_lib[short],
                library="F.scaled_dot_product_attention, not causal, kv "
                        "repeated to 16 heads"
                        + (", backward" if short == "B8" else ""),
                shape=f"one off-diagonal ring step, q (1,{hq},{s},{d}) kv "
                      f"(1,{hkv},{s},{d}) bf16, softcap {cap}, state read "
                      f"and written (Gemma-2-9B attention, W=4 of {big})"))
            continue
        layer = "global" if name.endswith("XFORM") else "sliding"
        attr = "xform_launches" if layer == "global" else "band_launches"
        t = timed[layer][short]
        entries.append(dict(
            common, launches=launches[f"{base} {attr}"],
            ms=t["ms"], device_ms=t["device_ms"],
            plain_ms=plain_ms[layer]["fwd" if short == "B1" else "bwd"],
            bound_ms=t["bound_ms"],
            library_ms=library[layer]["fwd" if short == "B1" else "bwd"],
            library="F.scaled_dot_product_attention, kv repeated to 16 "
                    "heads, " + ("is_causal" if layer == "global"
                       else "the dense band mask") + ", without softcap",
            without_softcap_ms=timed[layer + " without softcap"][short]["ms"],
            shape=f"q (1,{hq},{s},{d}) kv (1,{hkv},{s},{d}) bf16 causal, "
                  f"softcap {cap}"
                  + (f", window ({wl}, 0)" if layer == "sliding" else "")
                  + f": Gemma-2-9B's {layer} layers"))
    entries[0]["serving_append_false"] = serving
    return entries, launches


# the decode loop's new builds in the kernels line: the library, the TPU
# kernel each replaces, and the family's instantiations by a piece of
# their mangled names (<..., RMAX, D, RG>)
DECODE_KERNELS = {
    "B4": ("quant_decode",
           "ring_flash_attn_tpu/ops/quant_decode_pallas.py:28"),
    "B5": ("paged_decode", "ring_flash_attn_tpu/ops/paged.py:257"),
    "B6": ("paged_quant_decode", "ring_flash_attn_tpu/ops/paged.py:615"),
}
DECODE_FAMILY_PIECES = {"D64": "ELi64ELb", "D256": "ELi256ELb",
                        "G>16": "ELi128ELb1EE"}


def decode_entries(built, kernel, wide, launches):
    """The kernels line's entries of ``kernel``'s new builds: one a family
    of ``decode_wide``'s readings ``wide``, timed at its first case, with
    the worst error over its cases, the launches of its path
    (``launches``: {family: {path: n}}) and ptxas's facts of each of its
    instantiations."""
    lib, replaces = DECODE_KERNELS[kernel]
    facts = ptxas_facts(built[lib][:-3] + ".log")
    entries = []
    for fam, cases in wide.items():
        first = cases[0]
        by_path = launches[fam]
        entries.append({
            "name": f"{kernel} {lib} {fam}", "route": "cuda",
            "source": f"ring_flash_attn_tpu_torch/csrc/{lib}.cu",
            "replaces": replaces,
            "shape": f"{first['case']}: {first['heads'][0]}/"
                     f"{first['heads'][1]} heads of {first['d']}, Tq="
                     f"{first['tq']}, {first['shape']}",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": first["ms"], "device_ms": first["device_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "launches": next(iter(by_path.values())),
            "launches_by_path": by_path,
            "ptxas": {n[n.index("decode_kernel"):][:40]: f
                      for n, f in sorted(facts.items())
                      if DECODE_FAMILY_PIECES[fam] in n},
            "cases": cases})
    return entries


# ---------------------------------------------------------------------------
# phase 24: the engine and generate at the decode loop's new head dims and
# groups

# the models that phase 24 serves, at their published widths with seeded
# random weights (no weight or config is downloaded); depth cut where
# named. "prompt": generate's prompt tokens; "speculate_k": the engine's
# speculative run on repetitive prompts (a verify of k candidates, the
# pending token and k - 1 drafts: StarCoder's takes 4 x 48 = 192 rows a kv
# head); "family": the entries of the kernels line whose launches its
# paths give
DECODE_MODELS = {
    "Llama-3.2-1B": dict(
        source="meta-llama/Llama-3.2-1B config.json (16 layers, whole)",
        cfg=dict(vocab=128256, dim=2048, layers=16, heads=32, kv_heads=8,
                 head_dim=64, mlp_dim=8192, rope_theta=500000.0,
                 dtype="bfloat16"),
        prompt=32768, speculate_k=None, family="D64"),
    "Gemma-7B": dict(
        source="google/gemma-7b config.json (28 layers cut to 4)",
        cfg=dict(vocab=256000, dim=3072, layers=4, heads=16, kv_heads=16,
                 head_dim=256, mlp_dim=24576, dtype="bfloat16"),
        prompt=8192, speculate_k=None, family="D256"),
    "StarCoder": dict(
        source="bigcode/starcoder config.json (40 layers cut to 2)",
        cfg=dict(vocab=49152, dim=6144, layers=2, heads=48, kv_heads=1,
                 head_dim=128, mlp_dim=24576, dtype="bfloat16"),
        prompt=8192, speculate_k=4, family="G>16"),
}


def _repetitive(vocab, seed=19):
    """Phase 19's four repetitive prompts (a unit repeated), on which
    prompt-lookup drafting proposes drafts."""
    rng = np.random.default_rng(seed)
    return {rid: np.tile(rng.integers(0, vocab, size=u),
                         -(-n // u))[:n].astype(np.int32)
            for rid, (u, n) in enumerate(((50, 1000), (17, 600), (120, 1500),
                                          (33, 800)))}


def _decode_step_busy(torch, model, vocab, n_iters=8):
    """The engine's decode step over 4 lanes (3000, 1200, 2600, 300 tokens
    of context) on phase 4's pool (phases 22 and 24): (wall s, device
    compute s, busy s, {kernel: device s}) a step through
    ``utils.timing.timed`` and ``utils.trace_timing``."""
    from ring_flash_attn_tpu_torch.models import ServingEngine
    from ring_flash_attn_tpu_torch.utils.timing import timed
    from ring_flash_attn_tpu_torch.utils.trace_timing import (
        trace_device_busy, trace_device_time)

    rng = np.random.default_rng(0)
    eng = ServingEngine(model, device="cuda", **SERVE_POOL)
    for rid, n in enumerate((3000, 1200, 2600, 300)):
        eng.submit(rid, rng.integers(0, vocab, n).astype(np.int32),
                   8 * n_iters)
    eng.step()  # the prefill
    eng.step()

    def decode(x):
        eng.step()
        return x

    flag = torch.zeros(1, device="cuda")
    wall = timed(decode, flag, n=n_iters, n0=1)
    dev_s, by_name = trace_device_time(decode, flag, n_iters)
    busy_s, _ = trace_device_busy(decode, flag, n_iters)
    return wall, dev_s, busy_s, by_name


def phase_decode_models(torch):
    """Phase 24. Returns ({model: {"serving": launches, "generate":
    launches}}, {model: readings})."""
    from ring_flash_attn_tpu_torch.models import (
        ModelConfig, decode_step, generate, init_params, prefill)
    from ring_flash_attn_tpu_torch.ops.flash_fwd_cuda import flash_fwd_cuda
    from ring_flash_attn_tpu_torch.ops.paged_decode_cuda import (
        paged_decode_cuda)
    from ring_flash_attn_tpu_torch.ops.quant import make_cache
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
        quant_decode_cuda)

    log("== phase 24: the engine and generate at head dims 64 and 256 and "
        "at 48 q heads a kv head")
    counters = {"B1 flash_fwd": flash_fwd_cuda,
                "B4 quant_decode": quant_decode_cuda,
                "B5 paged_decode": paged_decode_cuda}
    paths, readings = {}, {}
    for name, spec in DECODE_MODELS.items():
        cfg = ModelConfig(**spec["cfg"])
        t0 = time.perf_counter()
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        log(f"  {name} ({spec['source']}): "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
            f"parameters, {cfg.heads}/{cfg.kv_heads} heads of "
            f"{cfg.head_dim}, {cfg.layers} layers, init "
            f"{time.perf_counter() - t0:.1f} s")
        rd = readings[name] = {"source": spec["source"], "config": spec["cfg"]}
        serving, gen_launches = {}, {}
        paths[name] = {"serving": serving, "generate": gen_launches}

        # (a) the engine: logits of the kernels against the plain versions,
        # then phase 4's traffic (and, with speculate_k, a speculative run
        # whose every verify is held against the plain version)
        prompts = _traffic(cfg.vocab)
        with _uncounted(counters):
            rd["engine_logits_rel_err"] = _engine_logit_checks(
                torch, model, prompts, 16)
        with _path_run(counters, serving):
            out, steps = _serve(torch, model, prompts, None, 16)
        for rid, toks in out.items():
            if len(toks) != 16 or not all(0 <= t < cfg.vocab for t in toks):
                raise AssertionError(f"{name}: request {rid} gave {toks}")
        pre = [(dt, n) for dt, n, _ in steps if n]
        dec = [dt for dt, n, decoded in steps if decoded and not n]
        rd["prefill_tokens_per_s"] = sum(n for _, n in pre) / sum(
            dt for dt, _ in pre)
        rd["decode_steps_per_s"] = len(dec) / sum(dec)
        if spec["speculate_k"]:
            k, rows = spec["speculate_k"], []
            with _path_run(counters, serving), _checked_verify(torch, rows):
                _, _, _, st = _engine_run(torch, model, _repetitive(cfg.vocab),
                                          32, speculate_k=k)
            widest = max(r[0] for r in rows) * cfg.heads // cfg.kv_heads
            log(f"    speculate_k={k}: {st['spec_proposed']} drafts "
                f"proposed, {st['spec_accepted']} accepted; {len(rows)} "
                f"verify calls held against the plain version, up to "
                f"{widest} rows a kv head, worst |out| "
                f"{max(r[1][0] for r in rows):.2e}, |lse| "
                f"{max(r[1][1] for r in rows):.2e} (tol {B5_TOL})")
            if (st["spec_proposed"] <= 0
                    or widest != k * (cfg.heads // cfg.kv_heads)):
                raise AssertionError(f"{name}: no verify of {k} rows a "
                                     f"q head ran")
            rd["speculative"] = {"proposed": st["spec_proposed"],
                                 "accepted": st["spec_accepted"],
                                 "verify_calls": len(rows),
                                 "rows_a_kv_head": widest}
        with _uncounted(counters):
            wall, dev_s, busy_s, _ = _decode_step_busy(torch, model,
                                                       cfg.vocab)
        rd["decode_step"] = {"wall_ms": wall * 1e3, "device_ms": dev_s * 1e3,
                             "busy_ms": busy_s * 1e3,
                             "busy_share": busy_s / wall}
        log(f"    engine: prefill {rd['prefill_tokens_per_s']:.0f} tokens/s,"
            f" {rd['decode_steps_per_s']:.1f} decode steps/s; a decode step "
            f"(4 lanes) {wall * 1e3:.3f} ms wall, {dev_s * 1e3:.3f} ms of "
            f"device compute, busy {100 * busy_s / wall:.1f}%; launches "
            f"{serving}")
        torch.cuda.empty_cache()

        # (b) generate: the counted run, then its parts, the first decode
        # step's logits against the plain versions over the same caches
        n, steps_ = spec["prompt"], 32
        prompt = torch.as_tensor(np.random.default_rng(24).integers(
            0, cfg.vocab, size=(1, n)), device="cuda")
        with _path_run(counters, gen_launches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = generate(model, prompt, steps_, max_new=steps_)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        want = {"B1 flash_fwd": cfg.layers,
                "B4 quant_decode": cfg.layers * steps_ * 2,
                "B5 paged_decode": 0}
        if gen_launches != want or tuple(toks.shape) != (1, steps_):
            raise AssertionError(f"{name}: generate gave {tuple(toks.shape)}"
                                 f" tokens, launches {gen_launches} (expected"
                                 f" {want})")
        with _uncounted(counters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(model, prompt)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            token = logits[:, -1].argmax(-1)
            del logits

            def tails():
                return [make_cache(1, cfg.kv_heads, steps_, cfg.head_dim)
                        for _ in model.layers]

            first, _ = decode_step(model, token, n, 0, caches, tails())
            plain, _ = decode_step(model, token, n, 0, caches, tails(),
                                   backend="plain")
            err = _rel_err(first, plain)
            tl = tails()
            decode_step(model, token, n, 0, caches, tl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in range(1, 9):
                decode_step(model, token, n + step, step, caches, tl)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) / 8 * 1e3
        log(f"    generate: {n}-token prompt, {steps_} steps in {gen_s:.3f} s "
            f"(launches {gen_launches}); prefill {pre_s:.3f} s "
            f"({n / pre_s:.0f} tokens/s), decode {dec_ms:.3f} ms a step; "
            f"first decode-step logits kernels vs plain {err:.3e} of "
            f"max|plain| (tol {LOGITS_REL_TOL})")
        if not (err <= LOGITS_REL_TOL and bool(torch.isfinite(first).all())):
            raise AssertionError(f"{name}: generate's decode step disagrees "
                                 f"with the plain versions")
        rd["generate"] = {"prompt": n, "steps": steps_, "wall_s": gen_s,
                          "prefill_s": pre_s, "decode_step_ms": dec_ms,
                          "logits_rel_err": err}
        del model, caches, tl, first, plain
        torch.cuda.empty_cache()
    return paths, readings


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import ring_flash_attn_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    smi = run("env+build", phase_env, torch)
    from ring_flash_attn_tpu_torch.ops import _build
    built = _build.build_all()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    b5, b5_wide = run("B5", phase_b5, torch, flush)
    kernels = [run("B1", phase_b1, torch, flush), b5]
    del flush
    torch.cuda.empty_cache()
    serving = run("serving", phase_engine, torch)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels += run("B2/B3", phase_bwd, torch, flush)
    del flush
    torch.cuda.empty_cache()
    training, flash_losses = run("training", phase_train, torch)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    b4, b4_wide = run("B4", phase_b4, torch, flush)
    kernels.append(b4)
    b6, paged_quant, (b6_wide, b6_wide_paths) = run("B6", phase_b6, torch,
                                                    flush)
    kernels.append(b6)
    del flush
    torch.cuda.empty_cache()
    inference = run("generate", phase_generate, torch)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels += run("B7/B8", phase_fused_ring, torch, flush)
    del flush
    torch.cuda.empty_cache()
    ring_compare = run("ring on one card", phase_ring_one_device, torch)
    torch.cuda.empty_cache()
    ring = run("ring entry points", phase_ring_entry_points, torch,
               flash_losses)
    torch.cuda.empty_cache()
    stripe, stripe_times = run("stripe and Ulysses", phase_stripe_ulysses,
                               torch, flash_losses)
    torch.cuda.empty_cache()
    moe, tp = run("MoE and TP", phase_moe_tp, torch)
    torch.cuda.empty_cache()
    llama3, llama3_times = run("llama3", phase_llama3, torch, flash_losses)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    varlen_readings, varlen, varlen_times = run(
        "packed sequences", phase_varlen, torch, flush)
    torch.cuda.empty_cache()
    xform_entries, xform_paths, xform_times = run(
        "softcap and ALiBi, zigzag varlen", phase_xform, torch, flush)
    torch.cuda.empty_cache()
    band_entries, band_paths, band_times = run(
        "windows and dropout", phase_band, torch, flush)
    del flush
    torch.cuda.empty_cache()
    serving_options, serving_readings = run(
        "serving options", phase_serving_options, torch)
    torch.cuda.empty_cache()
    adapter_paths, adapter_times = run("adapter", phase_adapter, torch)
    torch.cuda.empty_cache()
    pipeline, pipeline_readings = run("pipeline", phase_pipeline, torch)
    torch.cuda.empty_cache()
    utils_paths, utils_readings = run("utils and entry", phase_utils_entry,
                                      torch)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    d256_entries, gemma = run("head_dim 256", phase_d256, torch, flush)
    del flush
    torch.cuda.empty_cache()
    decode_paths, decode_readings = run("decode models", phase_decode_models,
                                        torch)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gemma2_entries, gemma2 = run("Gemma 2 at head_dim 256", phase_gemma2,
                                 torch, flush)
    del flush
    torch.cuda.empty_cache()
    # the decode loop's new builds, each family's launches from its path:
    # B5 the engine's, B4 generate's (phase 24), B6 its op-level path's
    # (phase 8)
    by_model = {spec["family"]: name for name, spec in DECODE_MODELS.items()}
    decode_new = []
    for kernel, wide, path in (("B4", b4_wide, "generate"),
                               ("B5", b5_wide, "serving")):
        decode_new += decode_entries(built, kernel, wide, {
            fam: {f"{by_model[fam]} {path}": decode_paths[by_model[fam]][
                path][f"{kernel} {DECODE_KERNELS[kernel][0]}"]}
            for fam in wide})
    decode_new += decode_entries(built, "B6", b6_wide, {
        fam: {f"paged_quant {fam}": n} for fam, n in b6_wide_paths.items()})
    for e in decode_new:
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']} never ran on its path: "
                                 f"{e['launches_by_path']}")
    for k in kernels:
        if k["name"] in ("B4 quant_decode", "B5 paged_decode"):
            k["decode_models"] = decode_readings
    next(k for k in kernels if k["name"].startswith("B7"))[
        "w4_causal_forward_ms"] = ring_compare
    b1 = next(k for k in kernels if k["name"].startswith("B1"))
    b1["w4_per_rank_stripe_vs_ring_ms"] = stripe_times
    b1.update(llama3_times)
    b1["w4_per_rank_varlen_ms"] = varlen_times
    b1.update(xform_times)
    b1.update(band_times)
    b1["chunked_prefill_first_token_s"] = serving_readings["first_token_s"]
    b1["adapter_w4_per_rank_ms"] = adapter_times
    b1["pipeline_step_s"] = pipeline_readings
    b1["utils_and_entry"] = utils_readings
    next(k for k in kernels if k["name"].startswith("B5"))[
        "speculative_verify"] = serving_readings["spec"]
    for k in xform_entries + band_entries:
        # the XFORM and BAND instantiations' counts come from phase 17's
        # and phase 18's paths
        k["ptxas"] = kernel_ptxas(built, k["name"])
        k["ptxas_varlen"] = kernel_ptxas(built, k["name"],
                                         SEG_INSTANTIATIONS)
    for k in band_entries:
        # the builds for dropout, softcap and ALiBi (BAND 2) beside the
        # window builds the names give
        for key, table in (("ptxas_all", INSTANTIATIONS),
                           ("ptxas_all_varlen", SEG_INSTANTIATIONS)):
            lib, piece = table[k["name"]]
            k[key] = kernel_ptxas(built, k["name"], {k["name"]: (
                lib, piece.replace("Li1EE", "Li2EE"))})
    for k in kernels:
        # each kernel's count on the run of its own path: serving for B1
        # and B5, training for B2/B3a/B3b, generate for B4 (B1 runs on all
        # four), the op-level quantized paged path for B6, the ring entry
        # points for B7/B8; the stripe and Ulysses entry points for B1,
        # B2 and B3a/B3b too; the MoE steps, the TP simulation and
        # train_step over llama3 for B1 and B2; the serving options for B1
        # and B5, the adapter for B1 to B3b, the pipeline for B1 and B2
        paths = {p: c[k["name"]] for p, c in (
            ("serving", serving), ("training", training),
            ("generate", inference), ("paged_quant", paged_quant),
            ("ring", ring), ("stripe", stripe), ("moe", moe), ("tp", tp),
            ("llama3", llama3), ("varlen", varlen),
            ("xform", xform_paths["xform"]),
            ("zigzag_varlen", xform_paths["zigzag_varlen"]),
            ("band", band_paths["band"]),
            ("serving_options", serving_options), ("adapter", adapter_paths),
            ("pipeline", pipeline), ("entry", utils_paths["entry"]),
            ("dryrun", utils_paths["dryrun"]),
            ("checkpoint", utils_paths["checkpoint"]))
            if k["name"] in c}
        k["launches"] = next(iter(paths.values()))
        k["launches_by_path"] = paths
        k["ptxas"] = kernel_ptxas(built, k["name"])
        if k["name"] in SEG_INSTANTIATIONS:
            # the segmented instantiation's facts and readings (phase 16)
            k["ptxas_varlen"] = kernel_ptxas(built, k["name"],
                                             SEG_INSTANTIATIONS)
            k.update(varlen_readings[k["name"]])
    for e in gemma2_entries:
        e["launches_by_path"] = {"gemma2": e["launches"]}
    kernels += (xform_entries + band_entries + d256_entries + decode_new
                + gemma2_entries)
    log(f"phase seconds {seconds}; phases took "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": _json_safe(kernels)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
