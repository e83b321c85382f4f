// Softcap and ALiBi in the block kernels B1, B2, B3a and B3b (the TPU
// kernels' softcap / use_alibi, ring_flash_attn_tpu/ops/pallas_fwd.py:310-321,
// pallas_bwd.py:163-189 and :365-399, pallas_bwd_fused.py:216-225).
//
// The logits are in base-2 units, s2 = q.k * scale * log2(e); then
//   softcap: s2 <- cap2 * tanh(s2 / cap2), cap2 = softcap * log2(e)
//   ALiBi:   s2 <- s2 - slope2 * dist, slope2 = slope * log2(e), dist =
//            q_pos - kv_pos (its absolute value when the mask is not
//            causal) on the mask's absolute positions: the explicit
//            positions where the kernel has them (csrc/segments.cuh), else
//            row - col + pos_off (the index plus the offsets)
// and then the mask. The backward recomputes both and multiplies dS by the
// softcap's 1 - tanh^2; ALiBi has no gradient. The fused ring's kernels B7
// and B8 carry the same transform on q pre-scaled to base 2 (their Ring
// structs); B1 to B3 scale first and transform after, as the TPU kernels
// do. Compiled apart (a template flag XFORM), so that the instantiations
// without it keep their code.
//
// B1 to B3 take tanh from one exp2 and a fast division (tanh_fast below):
// 2 to 7% off their time with softcap against CUDA's tanhf, which B7 and
// B8 keep, at q (1, 32, 8192, 128), kv (1, 8, 8192, 128) causal (NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py phase 17). What counted more was
// taking the transform out of the loops' per-element branches: each step
// a loop of its own under one uniform branch (see the kernels).

#pragma once

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1): one ex2.approx and one fast
// division, within about 2e-7 of tanh (absolute; -1 and 1 in the tails)
__device__ __forceinline__ float tanh_fast(float x) {
  float e;
  const float x2 = x * 2.8853900817779268f;  // 2 x log2(e)
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x2));
  return 1.f - __fdividef(2.f, e + 1.f);
}

// What a call with softcap or ALiBi adds (the C interface passes it by
// pointer).
struct rfa_xform_args {
  const float* slopes;  // (Hq,) ALiBi slopes * log2(e), or null: no ALiBi
  float cap2;           // softcap * log2(e); 0: no softcap
  int pos_off;          // q_pos - kv_pos = row - col + pos_off where the
                        // kernel holds no explicit positions
  int alibi_abs;        // ALiBi on |distance| (a mask that is not causal)
};
