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

// Kv head h of lane b: the group's position 0 at token index base of the
// (B, Hkv, S) cache, `len` live tokens.
struct ContigSrc {
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  long long base;
  int len;

  __device__ __forceinline__ int count(int j) const {
    return min(C, len - j * C);
  }

  __device__ __forceinline__ void locate(int j, long long& tok0,
                                         int& valid) const {
    tok0 = base + (long long)j * C;
    valid = count(j);
  }
};

// Every lane holds the same `len` live tokens.
struct ContigLanes {
  static constexpr bool EQUAL = true;  // plan_piece's closed form
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  int S, Hkv, len;

  __device__ __forceinline__ int chunks(int) const {
    return (len + C - 1) / C;
  }

  __device__ __forceinline__ ContigSrc src(int b, int h) const {
    return ContigSrc{k, v, ks, vs, ((long long)b * Hkv + h) * S, len};
  }
};

template <int QT, int RMAX, int D, bool RG>
__global__ void __launch_bounds__(launch_threads<D, RMAX, 1, RG>(), 1)
quant_decode_kernel(const void* __restrict__ q, int q_bf16,
                    const unsigned char* __restrict__ k_q,
                    const unsigned char* __restrict__ v_q,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ len_ptr, int len_val, int S,
                    int B, int Hkv, int R, float scale, float softcap,
                    Dest dst) {
  const int len = min(max(len_ptr ? *len_ptr : len_val, 0), S);
  const ContigLanes lanes{k_q, v_q, k_scale, v_scale, S, Hkv, len};
  if constexpr (RG)
    decode_tiles<QT, false, D, false>(lanes, B, Hkv, q, q_bf16, R, scale,
                                      softcap, dst);
  else
    decode_lanes<QT, false, D, RMAX, false>(lanes, B, Hkv, q, q_bf16, R,
                                            scale, softcap, dst);
}

// rfa_quant_decode's launch: run<QT, RMAX, D, RG>() launches that build
// (rfa_qd::dispatch picks it)
struct Launch {
  const void* q;
  int q_bf16;
  const void* k_q;
  const void* v_q;
  const float* k_scale;
  const float* v_scale;
  const int* len_ptr;
  int len_val;
  Dest dst;
  int B, Hkv, R, S, grid;
  float scale, softcap;
  cudaStream_t stream;

  template <int QT, int RMAX, int D, bool RG>
  int run() const {
    auto kern = quant_decode_kernel<QT, RMAX, D, RG>;
    constexpr int bytes = launch_smem<D, RMAX, 1, RG>();
    if (!launch_fits<D, RMAX, 1, RG>(grid, B, Hkv, R))
      return cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      attr = true;
    }
    return launch_build<RG>(
        kern, grid, launch_threads<D, RMAX, 1, RG>(), bytes, stream,
        q, q_bf16, static_cast<const unsigned char*>(k_q),
        static_cast<const unsigned char*>(v_q), k_scale, v_scale, len_ptr,
        len_val, S, B, Hkv, R, scale, softcap, dst);
  }
};

}  // namespace

// q (B, Hq, Tq, D) bf16 or fp32; k_q, v_q (B, Hkv, S, D) one byte per
// value, qtype 0 int8, 1 fp8 e4m3, 2 fp8 e5m2; k_scale, v_scale
// (B, Hkv, S) fp32; len_ptr a device int32 or null (then len_val); all
// contiguous; head_dim D 64, 128 or 256. out (B, Hq, Tq, D) and lse
// (B, Hq, Tq) fp32. `grid` blocks share the work (quant_decode.cuh::
// plan_piece; at least one a group): with grid > 1, part_acc (P, rp, D) and
// part_ml (P, rp, 2) fp32 scratch, P = min(grid, TARGET_BLOCKS), and
// counters (G) int32, zero before the launch and zero
// after it (not read with grid = 1): with R = (Hq / Hkv) * Tq rows a kv
// head, G = B * Hkv groups and rp = R when R <= max_rows(D), else (the
// row-tile loop, whole clusters of TILE_CLUSTER blocks, one a group at
// least) G = B * Hkv * ceil(R / row_tile(D)) * TILE_CLUSTER counters (a
// group's one a rank of its clusters) and rp = row_tile(D); any other rp
// is refused. softcap <= 0 disables capping. Returns
// cudaGetLastError().
extern "C" int rfa_quant_decode(const void* q, int q_bf16, const void* k_q,
                                const void* v_q, const float* k_scale,
                                const float* v_scale, const int* len_ptr,
                                int len_val, float* out, float* lse,
                                float* part_acc, float* part_ml,
                                int* counters, int B, int Hq, int Hkv, int Tq,
                                int head_dim, int S, int qtype, int grid,
                                int rp, float scale, float softcap,
                                void* stream) {
  if (Hkv <= 0 || Hq % Hkv || S < 1 || grid < 1)
    return cudaErrorInvalidValue;
  const int R = (Hq / Hkv) * Tq;
  const Launch launch{q, q_bf16, k_q, v_q, k_scale, v_scale, len_ptr,
                      len_val, Dest{out, lse, part_acc, part_ml, counters},
                      B, Hkv, R, S, grid, scale, softcap,
                      static_cast<cudaStream_t>(stream)};
  return dispatch<QT_INT8, QT_E4M3, QT_E5M2>(qtype, head_dim, R, rp, launch);
}
