// Kernel B2: fused flash-attention backward, dq, dk and dv in one pass.
//
// Replaces the TPU kernel ring_flash_attn_tpu/ops/pallas_bwd_fused.py::
// _bwd_fused_kernel (wrapper pallas_block_bwd_fused), for the mask model
// the port carries: causal with a static integer offset (attend iff
// iq + offset >= ik) or no mask, segment ids and explicit positions
// (csrc/segments.cuh), softcap and ALiBi (csrc/xform.cuh), sliding windows
// and dropout (csrc/band.cuh), GQA (q head h
// reads kv head h / (Hq/Hkv)),
// head_dim 64, 128 or 256 in every build (256: 64 keys a block with dK's and dV's columns split over the consumer
// warpgroups and dq added by atomics from the registers, see
// csrc/flash_bwd.cuh), bf16 q, k, v and dout. Contract of
// ops/flash.py::block_bwd: dq fp32 (B, Hq, Sq, D); dk, dv (B, Hkv, Skv, D)
// in fp32 or bf16, summed over the GQA group.
//
// What bounds it on the H100: tensor-core operations. A causal call does
// 5 products of 2 * D flops per allowed (q, k) pair and head, about
// 10 * pairs * Hq * D flops, on inputs of a few tens of MB: far above the
// ~295 flop/byte ridge of bf16, so the bound is the 989 TFLOP/s dense bf16
// rate (1.390 ms at q (1, 32, 8192, 128), kv (1, 8, 8192, 128) causal). The
// TPU kernel keeps a head's whole (Skv, D) dk/dv resident in VMEM while one
// program walks every block pair in order; CUDA blocks run in parallel and
// in no order, so the loop is kv-major (csrc/flash_bwd.cuh): a block keeps
// its 128 keys' dk and dv in registers and walks the q tiles, TMA feeds a
// producer/consumer ring, wgmma does the products, and dq, which every kv
// tile adds to, leaves by TMA reduce-adds from a warp of its own. The first
// port of this kernel (mma.sync, 64-key tiles, float2 atomicAdd for dq) ran
// 8.84 ms there, 156 TFLOP/s; this loop 3.26 to 3.45 ms, about 420 TFLOP/s,
// level with SDPA's backward (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// delta comes from a pre-pass (rfa_bwd_delta) when the caller has none,
// rather than being folded into the kv-major loop, which would read the
// forward output once per kv tile.

#include "flash_bwd.cuh"

namespace rfa_bwd {

// ---------------------------------------------------------------------------
// delta = rowsum(dout * out) in fp32: one warp per (b, h, row)

constexpr int DELTA_WARPS = 8;

template <int D>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
bwd_delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                 float* __restrict__ delta, int H, int S, long long rows,
                 long long o_sb, long long o_sh, long long o_ss, long long y_sb,
                 long long y_sh, long long y_ss) {
  const long long r =
      (long long)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int i = r % S;
  const long long bh = r / S;
  const int h = bh % H;
  const long long b = bh / H;
  const bf16* go = dout + b * o_sb + h * o_sh + i * o_ss;
  const bf16* y = out + b * y_sb + h * y_sh + i * y_ss;
  float acc = 0.f;
#pragma unroll
  for (int d = lane * 2; d < D; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(go + d));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(y + d));
    acc += a.x * c.x + a.y * c.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffff, acc, m);
  if (lane == 0) delta[r] = acc;
}

// strides: dout (b, h, s), out (b, h, s) in elements
inline int launch_delta(const void* dout, const void* out, float* delta, int B,
                        int H, int S, int D, const long long* st,
                        cudaStream_t stream) {
  const long long rows = (long long)B * H * S;
  dim3 grid((unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS));
  const bf16* go = static_cast<const bf16*>(dout);
  const bf16* y = static_cast<const bf16*>(out);
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    bwd_delta_kernel<HD><<<grid, DELTA_WARPS * 32, 0, stream>>>(
        go, y, delta, H, S, rows, st[0], st[1], st[2], st[3], st[4], st[5]);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace rfa_bwd

// strides: q, k, v, dout (b, h, s) in elements; returns cudaGetLastError().
// dq_acc must hold zeros: the kernel adds into it.
extern "C" int rfa_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, float* dq_acc, void* dk,
                             void* dv, int B, int Hq, int Hkv, int Sq,
                             int Skv, int D, const long long* strides,
                             float scale, int causal, int offset,
                             int dkv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rfa::by_head_dim(D, [&](auto d) {
    return rfa_bwd::launch_kv<decltype(d)::value, true>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Hq, Hkv, Sq, Skv,
        strides, scale, causal, offset, dkv_bf16, st);
  });
}

// B2 on packed sequences (csrc/segments.cuh), compiled apart: as
// rfa_flash_bwd, with the segment ids, positions and tile bounds of `seg`
// (at 64 q rows a step and 128 keys a block). `causal` is the causal mask
// by index; a mask causal by positions passes causal = 0 and seg->q_pos.
extern "C" int rfa_flash_bwd_seg(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, float* dq_acc, void* dk,
                                 void* dv, int B, int Hq, int Hkv, int Sq,
                                 int Skv, int D, const long long* strides,
                                 float scale, int causal, int offset,
                                 int dkv_bf16, const rfa_seg_args* seg,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rfa::by_head_dim(D, [&](auto d) {
    return rfa_bwd::launch_kv<decltype(d)::value, true, false, true>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Hq, Hkv, Sq, Skv,
        strides, scale, causal, offset, dkv_bf16, st, rfa_bwd::Ring{}, *seg);
  });
}

// B2 with softcap or ALiBi (csrc/xform.cuh): as rfa_flash_bwd, or with a
// non-null `seg` as rfa_flash_bwd_seg, with the transform of `xf`. Compiled
// apart from the instantiations without it.
extern "C" int rfa_flash_bwd_xf(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, float* dq_acc, void* dk,
                                void* dv, int B, int Hq, int Hkv, int Sq,
                                int Skv, int D, const long long* strides,
                                float scale, int causal, int offset,
                                int dkv_bf16, const rfa_seg_args* seg,
                                const rfa_xform_args* xf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_bwd::Ring ring{xf->slopes, xf->cap2, xf->pos_off, 0,
                           xf->alibi_abs, 0};
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Hq, Hkv, Sq, Skv,
              strides, scale, causal, offset, dkv_bf16, st, ring, sg,
              rfa_band_args{});
  };
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    return seg ? go(rfa_bwd::launch_kv<HD, true, false, true, true>, *seg)
               : go(rfa_bwd::launch_kv<HD, true, false, false, true>, none);
  });
}

// B2 with a window or dropout (csrc/band.cuh): as rfa_flash_bwd_xf, with the
// window and dropout of `bd`. Compiled apart from the instantiations
// without it.
extern "C" int rfa_flash_bwd_band(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  float* dq_acc, void* dk, void* dv, int B,
                                  int Hq, int Hkv, int Sq, int Skv, int D,
                                  const long long* strides, float scale,
                                  int causal, int offset, int dkv_bf16,
                                  const rfa_seg_args* seg,
                                  const rfa_xform_args* xf,
                                  const rfa_band_args* bd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_bwd::Ring ring{xf->slopes, xf->cap2, xf->pos_off, 0,
                           xf->alibi_abs, 0};
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Hq, Hkv, Sq, Skv,
              strides, scale, causal, offset, dkv_bf16, st, ring, sg, *bd);
  };
  // the build of a window alone, or the one for the rest (csrc/band.cuh)
  constexpr int W = rfa_band::WINDOW, A = rfa_band::ALL;
  const bool all = bd->thr != 0 || xf->cap2 > 0.f || xf->slopes;
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    if (seg)
      return all
          ? go(rfa_bwd::launch_kv<HD, true, false, true, true, A>, *seg)
          : go(rfa_bwd::launch_kv<HD, true, false, true, true, W>, *seg);
    return all
        ? go(rfa_bwd::launch_kv<HD, true, false, false, true, A>, none)
        : go(rfa_bwd::launch_kv<HD, true, false, false, true, W>, none);
  });
}

// The pre-pass for both backward paths (ops/flash_bwd_cuda.py::bwd_delta):
// B3a/B3b's launcher takes it from this library too.
extern "C" int rfa_bwd_delta(const void* dout, const void* out, float* delta,
                             int B, int H, int S, int D,
                             const long long* strides, void* stream) {
  return rfa_bwd::launch_delta(dout, out, delta, B, H, S, D, strides,
                               static_cast<cudaStream_t>(stream));
}
