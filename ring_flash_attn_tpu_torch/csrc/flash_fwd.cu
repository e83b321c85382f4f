// Kernel B1: blockwise flash-attention forward with online softmax.
//
// Replaces the TPU kernel ring_flash_attn_tpu/ops/pallas_fwd.py::_fwd_kernel
// (wrapper pallas_block_fwd), for the mask model this slice ports: causal
// with a static integer offset (attend iff iq + offset >= ik) or no mask,
// GQA (q head h reads kv head h / (Hq / Hkv)). Contract of
// ops/flash.py::block_fwd: out (B, Hq, Sq, D) in fp32 or bf16, lse fp32
// (B, Hq, Sq) in natural log; dead rows give out = 0 and lse = NEG_INF.
//
// What bounds it on the H100: tensor-core operations. A causal call does
// 2 * 2 * B * Hq * Sq * Skv * D / 2 flops on inputs of a few MB, far above
// the ~295 flop/byte ridge of bf16, so the bound is the 989 TFLOP/s dense
// bf16 rate (0.556 ms at q (1, 32, 8192, 128), kv (1, 8, 8192, 128)
// causal). The tile loop is csrc/flash_fwd.cuh's, shared with kernel B7,
// the ring step of csrc/fused_ring_fwd.cu: the FlashAttention-3 shape, a
// TMA producer warpgroup feeding two wgmma consumer warpgroups over
// 128-row q tiles that overlap their softmax with their products and take
// turns to issue them; its measured time is in that header and in
// PERF.md. The scale stays in fp32 (the Pallas wrapper folds scale * log2 e
// into bf16 k instead).

#include "flash_fwd.cuh"

// strides: q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s in elements,
// 16-byte multiples; the last dimension of q, k and v is contiguous and
// every base 16-byte aligned (the TMA maps' terms). Returns 0 or a
// cudaError_t.
extern "C" int rfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int Hq, int Hkv,
                             int Sq, int Skv, int D, const long long* strides,
                             float scale, int causal, int offset,
                             int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const rfa_fwd::Ring none{};
  if (D == 128)
    return rfa_fwd::launch<128, false>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                       strides, scale_log2, causal, offset,
                                       out_bf16, none, st);
  if (D == 64)
    return rfa_fwd::launch<64, false>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                      strides, scale_log2, causal, offset,
                                      out_bf16, none, st);
  return cudaErrorInvalidValue;
}
