// Kernel B1: blockwise flash-attention forward with online softmax.
//
// Replaces the TPU kernel ring_flash_attn_tpu/ops/pallas_fwd.py::_fwd_kernel
// (wrapper pallas_block_fwd), for the mask model the port carries: causal
// with a static integer offset (attend iff iq + offset >= ik) or no mask,
// segment ids and explicit positions (csrc/segments.cuh), softcap and ALiBi
// (csrc/xform.cuh), sliding windows and dropout (csrc/band.cuh), GQA (q
// head h reads kv head h / (Hq / Hkv)). Contract of ops/flash.py::block_fwd:
// out (B, Hq, Sq, D) in fp32 or bf16, lse fp32 (B, Hq, Sq) in natural log;
// dead rows give out = 0 and lse = NEG_INF.
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

// B1 on packed sequences (csrc/segments.cuh): as rfa_flash_fwd, with the
// segment ids, positions and tile bounds of `seg`. `causal` is the causal
// mask by index (at `offset`); a mask causal by positions passes causal = 0
// and seg->q_pos. Compiled apart from the mask-free instantiations.
extern "C" int rfa_flash_fwd_seg(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int Hq,
                                 int Hkv, int Sq, int Skv, int D,
                                 const long long* strides, float scale,
                                 int causal, int offset, int out_bf16,
                                 const rfa_seg_args* seg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const rfa_fwd::Ring none{};
  if (D == 128)
    return rfa_fwd::launch<128, false, false, true>(
        q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, strides, scale_log2, causal,
        offset, out_bf16, none, st, *seg);
  if (D == 64)
    return rfa_fwd::launch<64, false, false, true>(
        q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, strides, scale_log2, causal,
        offset, out_bf16, none, st, *seg);
  return cudaErrorInvalidValue;
}

// B1 with softcap or ALiBi (csrc/xform.cuh): as rfa_flash_fwd, or with a
// non-null `seg` as rfa_flash_fwd_seg, with the transform of `xf`. Compiled
// apart from the instantiations without it.
extern "C" int rfa_flash_fwd_xf(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int Hq, int Hkv,
                                int Sq, int Skv, int D,
                                const long long* strides, float scale,
                                int causal, int offset, int out_bf16,
                                const rfa_seg_args* seg,
                                const rfa_xform_args* xf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  // the Ring's transform fields alone: its state is never read without RING
  const rfa_fwd::Ring ring{nullptr, nullptr, nullptr, xf->slopes, xf->cap2,
                           xf->pos_off, 0, xf->alibi_abs, 1, 1};
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, strides, scale_log2,
              causal, offset, out_bf16, ring, st, sg, rfa_band_args{});
  };
  if (D == 128)
    return seg ? go(rfa_fwd::launch<128, false, true, true>, *seg)
               : go(rfa_fwd::launch<128, false, true, false>, none);
  if (D == 64)
    return seg ? go(rfa_fwd::launch<64, false, true, true>, *seg)
               : go(rfa_fwd::launch<64, false, true, false>, none);
  return cudaErrorInvalidValue;
}

// B1 with a window or dropout (csrc/band.cuh): as rfa_flash_fwd_xf, with the
// window and dropout of `bd` (and the softcap and ALiBi of `xf`, cap2 0 and
// null slopes where the call has neither). Compiled apart from the
// instantiations without it.
extern "C" int rfa_flash_fwd_band(const void* q, const void* k,
                                  const void* v, void* out, float* lse,
                                  int B, int Hq, int Hkv, int Sq, int Skv,
                                  int D, const long long* strides,
                                  float scale, int causal, int offset,
                                  int out_bf16, const rfa_seg_args* seg,
                                  const rfa_xform_args* xf,
                                  const rfa_band_args* bd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const rfa_fwd::Ring ring{nullptr, nullptr, nullptr, xf->slopes, xf->cap2,
                           xf->pos_off, 0, xf->alibi_abs, 1, 1};
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, strides, scale_log2,
              causal, offset, out_bf16, ring, st, sg, *bd);
  };
  // the build of a window alone, or the one for the rest (csrc/band.cuh)
  constexpr int W = rfa_band::WINDOW, A = rfa_band::ALL;
  const bool all = bd->thr != 0 || xf->cap2 > 0.f || xf->slopes;
  if (D == 128) {
    if (seg)
      return all ? go(rfa_fwd::launch<128, false, true, true, A>, *seg)
                  : go(rfa_fwd::launch<128, false, true, true, W>, *seg);
    return all ? go(rfa_fwd::launch<128, false, true, false, A>, none)
                : go(rfa_fwd::launch<128, false, true, false, W>, none);
  }
  if (D == 64) {
    if (seg)
      return all ? go(rfa_fwd::launch<64, false, true, true, A>, *seg)
                  : go(rfa_fwd::launch<64, false, true, true, W>, *seg);
    return all ? go(rfa_fwd::launch<64, false, true, false, A>, none)
                : go(rfa_fwd::launch<64, false, true, false, W>, none);
  }
  return cudaErrorInvalidValue;
}
