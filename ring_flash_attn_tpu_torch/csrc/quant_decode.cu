// Kernel B4: decode attention over a contiguous quantized KV cache.
//
// Replaces the TPU kernel ring_flash_attn_tpu/ops/quant_decode_pallas.py::
// _kernel (wrapper pallas_quant_decode) and computes what its plain
// version ops/quant.py::_plain_quant_decode computes: q (B, Hq, Tq, D)
// against k_q, v_q (B, Hkv, S, D) in int8 / fp8 e4m3 / fp8 e5m2 with fp32
// scales (B, Hkv, S), positions >= length masked, fp32 (out, lse). The
// loop, what bounds it on the H100 and the design are in quant_decode.cuh.
// `length` comes by value or as a device pointer, so a length computed on
// the card costs no host sync; any S >= 1 is taken (a ragged last chunk).

#include "quant_decode.cuh"

namespace {

using namespace rfa_qd;

struct ContigSrc {
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  int n_chunks;
  long long base;  // token index of the group's position 0
  int len;

  __device__ __forceinline__ void locate(int j, long long& tok0,
                                         int& valid) const {
    tok0 = base + (long long)j * C;
    valid = min(C, len - j * C);
  }
};

template <int QT, int RMAX>
__global__ void __launch_bounds__(NTHREADS)
quant_decode_kernel(const void* __restrict__ q, int q_bf16,
                    const unsigned char* __restrict__ k_q,
                    const unsigned char* __restrict__ v_q,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ len_ptr, int len_val, int S,
                    int Hkv, int R, float scale, float softcap,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  const long long g = (long long)blockIdx.z * Hkv + blockIdx.y;
  const int len = min(max(len_ptr ? *len_ptr : len_val, 0), S);
  const ContigSrc src{k_q, v_q, k_scale, v_scale, (len + C - 1) / C, g * S,
                      len};
  decode_split<QT, false, RMAX>(src, q, q_bf16, g * R, R, scale, softcap,
                                part_acc, part_ml,
                                (g * gridDim.x + blockIdx.x) * R);
}

template <int QT, int RMAX>
int launch(const void* q, int q_bf16, const void* k_q, const void* v_q,
           const float* k_scale, const float* v_scale, const int* len_ptr,
           int len_val, float* out, float* lse, float* part_acc,
           float* part_ml, int B, int Hkv, int R, int S, int nsplit,
           float scale, float softcap, cudaStream_t stream) {
  auto kern = quant_decode_kernel<QT, RMAX>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<RMAX>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  kern<<<dim3(nsplit, Hkv, B), NTHREADS, Smem<RMAX>::BYTES, stream>>>(
      q, q_bf16, static_cast<const unsigned char*>(k_q),
      static_cast<const unsigned char*>(v_q), k_scale, v_scale, len_ptr,
      len_val, S, Hkv, R, scale, softcap, part_acc, part_ml);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge_splits(part_acc, part_ml, out, lse, nsplit, R, B * Hkv,
                      stream);
}

template <int QT>
int launch_rows(const void* q, int q_bf16, const void* k_q, const void* v_q,
                const float* k_scale, const float* v_scale,
                const int* len_ptr, int len_val, float* out, float* lse,
                float* part_acc, float* part_ml, int B, int Hkv, int R,
                int S, int nsplit, float scale, float softcap,
                cudaStream_t stream) {
#define RFA_LAUNCH(RM)                                                      \
  return launch<QT, RM>(q, q_bf16, k_q, v_q, k_scale, v_scale, len_ptr,     \
                        len_val, out, lse, part_acc, part_ml, B, Hkv, R, S, \
                        nsplit, scale, softcap, stream)
  if (R <= 4) RFA_LAUNCH(4);
  if (R <= 8) RFA_LAUNCH(8);
  if (R <= 16) RFA_LAUNCH(16);
#undef RFA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, Tq, D) bf16 or fp32; k_q, v_q (B, Hkv, S, D) one byte per
// value, qtype 0 int8, 1 fp8 e4m3, 2 fp8 e5m2; k_scale, v_scale
// (B, Hkv, S) fp32; len_ptr a device int32 or null (then len_val); all
// contiguous. part_acc (B * Hkv, nsplit, R, D) and part_ml
// (B * Hkv, nsplit, R, 2) fp32 scratch, R = (Hq / Hkv) * Tq. out
// (B, Hq, Tq, D) and lse (B, Hq, Tq) fp32. softcap <= 0 disables capping.
// Returns cudaGetLastError().
extern "C" int rfa_quant_decode(const void* q, int q_bf16, const void* k_q,
                                const void* v_q, const float* k_scale,
                                const float* v_scale, const int* len_ptr,
                                int len_val, float* out, float* lse,
                                float* part_acc, float* part_ml, int B,
                                int Hq, int Hkv, int Tq, int head_dim, int S,
                                int qtype, int nsplit, float scale,
                                float softcap, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv || S < 1 || nsplit < 1)
    return cudaErrorInvalidValue;
  const int R = (Hq / Hkv) * Tq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RFA_QT(QT)                                                         \
  return launch_rows<QT>(q, q_bf16, k_q, v_q, k_scale, v_scale, len_ptr,   \
                         len_val, out, lse, part_acc, part_ml, B, Hkv, R,  \
                         S, nsplit, scale, softcap, st)
  if (qtype == QT_INT8) RFA_QT(QT_INT8);
  if (qtype == QT_E4M3) RFA_QT(QT_E4M3);
  if (qtype == QT_E5M2) RFA_QT(QT_E5M2);
#undef RFA_QT
  return cudaErrorInvalidValue;
}
