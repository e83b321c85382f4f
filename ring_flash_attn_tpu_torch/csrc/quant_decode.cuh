// Decode attention over a KV cache split over blocks: the loop that kernels
// B4 (contiguous quantized cache, quant_decode.cu), B5 (bf16 pages,
// paged_decode.cu) and B6 (quantized pages, paged_quant_decode.cu) share,
// and the kernel that merges their partials.
//
// They replace the TPU kernels ring_flash_attn_tpu/ops/
// quant_decode_pallas.py::_kernel and ring_flash_attn_tpu/ops/paged.py::
// _paged_kernel and ::_quant_paged_kernel. For the R = (Hq / Hkv) * Tq
// query rows of one (batch, kv head) group: logits (q * scale) . k * k_scale
// over the live tokens, optional tanh softcap, online softmax,
// (p * v_scale) @ v; fp32 (out, lse); a row with no live token gives
// out = 0, lse = NEG_INF. A quantized cache holds one byte per value (int8,
// fp8 e4m3 or e5m2) and one fp32 scale per token and head; a bf16 cache
// (QT_BF16, B5) two bytes per value and no scales (unit scales, never
// loaded or applied). With BOUNDS (B5's new_counts) each row has its own
// last live token.
//
// What bounds it on the H100: bytes. A token's K and V are used by only
// the R rows of its group (4 at Llama-3-8B widths), about two operations
// per byte (one for bf16), so the least time is one read of the live cache
// and scales at 3.35 TB/s. The design serves that:
//
//  - a group's tokens are split over gridDim.x blocks, so that a batch of
//    one with 8 kv heads still fills the 132 SMs; each block walks its
//    range in 64-token chunks, double-buffered with cp.async (shared
//    memory is what limits the blocks an SM holds, and a third stage cost
//    more in occupancy than it hid in latency: measured), and
//    writes an unnormalised partial (acc, m, l); a second small kernel
//    merges a row's partials in a fixed order, so the result does not
//    depend on which block finished first;
//  - values are widened in registers: int8 by a byte permute into the
//    mantissa of 2^23 and one subtraction (no integer-to-float
//    conversion), fp8 through the hardware's fp8x2 -> half2 conversion,
//    bf16 by a shift;
//  - QK and PV are fp32 FMAs on CUDA cores (with 4 to 16 rows the work is
//    far below the memory time and too thin for tensor cores); with
//    QK_INT8 (B6 on int8 pages) q is quantized per row to int8 in the
//    block and QK is an exact s8 x s8 -> s32 product (__dp4a) times
//    q_scale * k_scale, the function the TPU kernel computes;
//  - in PV each thread owns 4 output columns and each warp a quarter of
//    the chunk's tokens, so one 32-bit (bf16: 64-bit) shared-memory load
//    feeds 4 * R FMAs; the warps' sums meet once, at the end of the block.
//
// The TPU kernels' sequential (B, n_blk) grid, all-heads block-diagonal
// matmul, 128-multiple blocks and pages_per_step are shapes of that
// machine and are not carried over: any length S >= 1 is taken.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace rfa_qd {

constexpr int D = 128;         // head dim these kernels take
constexpr int C = 64;          // tokens per chunk
constexpr int NTHREADS = 128;  // 4 warps
constexpr int NST = 2;         // cp.async stages (see above)

enum { QT_INT8 = 0, QT_E4M3 = 1, QT_E5M2 = 2, QT_BF16 = 3 };

// bytes per cached value
template <int QT>
__host__ __device__ constexpr int value_bytes() {
  return QT == QT_BF16 ? 2 : 1;
}

// Four quantized values packed in w (lowest byte first) as floats, exact.
template <int QT>
__device__ __forceinline__ void cvt4(uint32_t w, float (&f)[4]) {
  static_assert(QT != QT_BF16, "bf16 values take cvt_bf16x4");
  if constexpr (QT == QT_INT8) {
    // byte x + 128 into the low mantissa bits of 2^23, minus (2^23 + 128)
    w ^= 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        QT == QT_E4M3 ? __NV_E4M3 : __NV_E5M2;
    const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), kind);
    const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), kind);
    const float2 a = __half22float2(__half2(lo));
    const float2 b = __half22float2(__half2(hi));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
}

// Four bf16 values packed in w (lowest first) as floats, exact.
__device__ __forceinline__ void cvt_bf16x4(uint2 w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xffff0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xffff0000u);
}

// EB bytes per cached value
template <int RMAX, int EB = 1>
struct Smem {
  static constexpr int KLD = D * EB + 16;  // bytes per K row: conflict-free
                                           // 16-B reads
  static constexpr int K = 0;                       // u8 [NST][C][KLD]
  static constexpr int V = K + NST * C * KLD;       // u8 [NST][C][D * EB]
  static constexpr int SC = V + NST * C * D * EB;   // f32 [NST][2][C]
  static constexpr int Q = SC + NST * 2 * C * 4;    // f32 [RMAX][D]
  static constexpr int Q8 = Q + RMAX * D * 4;       // s8 [RMAX][D]
  static constexpr int P = Q8 + RMAX * D;           // f32 [RMAX][C]
  static constexpr int STATS = P + RMAX * C * 4;    // m, l, alpha, q_scale
  static constexpr int BYTES = STATS + 4 * RMAX * 4;
  // the end-of-block reduction reuses the K and V stages
  static_assert(4 * RMAX * D * 4 <= SC, "reduction buffer must fit");
};

// One block's share of one group. Src gives the group's live chunks:
//   n_chunks; k, v (bytes), ks, vs (fp32 scales; not read for QT_BF16);
//   locate(j, tok0, valid): chunk j starts at token index tok0 of the k/v
//   arrays (byte offset tok0 * D * value_bytes, scale offset tok0) and
//   holds `valid` live tokens (1..C);
//   with BOUNDS, pos(j): chunk j's first position in the group's sequence,
//   and bound(r): row r sees positions below it only.
// q rows row0 .. row0 + R of the (rows, D) query; the partial goes to
// part_acc[(part0 + r) * D + d] and part_ml[(part0 + r) * 2 + {0, 1}].
template <int QT, bool QK_INT8, int RMAX, bool BOUNDS = false, class Src>
__device__ __forceinline__ void decode_split(
    const Src& src, const void* __restrict__ q, int q_bf16, long long row0,
    int R, float scale, float softcap, float* __restrict__ part_acc,
    float* __restrict__ part_ml, long long part0) {
  constexpr int EB = value_bytes<QT>();
  constexpr bool SCALES = QT != QT_BF16;
  using S = Smem<RMAX, EB>;
  constexpr int KLD = S::KLD;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem + S::K;
  unsigned char* vs = smem + S::V;
  float* sc = reinterpret_cast<float*>(smem + S::SC);
  float* qs = reinterpret_cast<float*>(smem + S::Q);
  signed char* q8 = reinterpret_cast<signed char*>(smem + S::Q8);
  float* ps = reinterpret_cast<float*>(smem + S::P);
  float* m_s = reinterpret_cast<float*>(smem + S::STATS);
  float* l_s = m_s + RMAX;
  float* a_s = l_s + RMAX;
  float* qsc_s = a_s + RMAX;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int nsplit = gridDim.x;
  const int per = (src.n_chunks + nsplit - 1) / nsplit;
  const int j0 = blockIdx.x * per;
  const int n = max(0, min(src.n_chunks - j0, per));

  auto load_chunk = [&](int stage, int j) {
    long long tok0;
    int valid;
    src.locate(j, tok0, valid);
    constexpr int RB = D * EB;  // bytes of a K or V row
    for (int i = t; i < C * (RB / 16); i += NTHREADS) {
      const int r = i / (RB / 16), c = (i % (RB / 16)) * 16;
      const bool ok = r < valid;
      const long long g = ok ? (tok0 + r) * RB + c : 0;
      rfa::cp_async16(ks + (stage * C + r) * KLD + c, src.k + g, ok ? 16 : 0);
      rfa::cp_async16(vs + (stage * C + r) * RB + c, src.v + g, ok ? 16 : 0);
    }
    if constexpr (SCALES) {  // threads 0..63 bring the K scales, 64..127 V's
      const int c = t % C;
      const bool ok = c < valid;
      const float* base = t < C ? src.ks : src.vs;
      rfa::cp_async4(sc + (stage * 2 + t / C) * C + c,
                     base + (ok ? tok0 + c : 0), ok ? 4 : 0);
    }
  };

  for (int s = 0; s < NST - 1; ++s) {
    if (s < n) load_chunk(s, j0 + s);
    rfa::cp_async_commit();
  }
  for (int i = t; i < R * D; i += NTHREADS) {
    const float x = q_bf16
        ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[row0 * D + i])
        : static_cast<const float*>(q)[row0 * D + i];
    qs[i] = x * scale;
  }
  if (t < R) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  if constexpr (QK_INT8) {
    // q rows to int8: scale max|q| / 127 (floor 1e-20), round half to even
    __syncthreads();
    for (int r = warp; r < R; r += NTHREADS / 32) {
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e)
        amax = fmaxf(amax, fabsf(qs[r * D + lane + 32 * e]));
#pragma unroll
      for (int sft = 16; sft > 0; sft /= 2)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, sft));
      const float qsc = fmaxf(amax / 127.f, 1e-20f);
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        const float v = rintf(qs[r * D + lane + 32 * e] / qsc);
        q8[r * D + lane + 32 * e] =
            static_cast<signed char>(fminf(fmaxf(v, -127.f), 127.f));
      }
      if (lane == 0) qsc_s[r] = qsc;
    }
  }

  float o[RMAX][4];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[r][e] = 0.f;

  const int c = t % C, rg = t / C;  // score phase: token c, rows rg + 2i
  int bnd[RMAX / 2];  // with BOUNDS: rows rg + 2 k see positions below
  if constexpr (BOUNDS) {
#pragma unroll
    for (int k = 0; k < RMAX / 2; ++k) bnd[k] = src.bound(rg + 2 * k);
  }
  for (int i = 0; i < n; ++i) {
    rfa::cp_async_wait<NST - 2>();
    __syncthreads();  // chunk i has landed; chunk i - 1's stage is free
    if (i + NST - 1 < n) load_chunk((i + NST - 1) % NST, j0 + i + NST - 1);
    rfa::cp_async_commit();

    const int stage = i % NST;
    long long tok0;
    int valid;
    src.locate(j0 + i, tok0, valid);
    const float* ksc = sc + stage * 2 * C;
    const float* vsc = ksc + C;

    // scores: this thread's token c against rows rg, rg + 2, ...
    const unsigned char* krow = ks + (stage * C + c) * KLD;
    float sv[RMAX / 2];
    if constexpr (QK_INT8) {
      int acc[RMAX / 2];
#pragma unroll
      for (int k = 0; k < RMAX / 2; ++k) acc[k] = 0;
#pragma unroll 2
      for (int d = 0; d < D; d += 16) {
        const uint4 kw = *reinterpret_cast<const uint4*>(krow + d);
#pragma unroll
        for (int k = 0; k < RMAX / 2; ++k) {
          const int r = rg + 2 * k;
          if (r < R) {
            const uint4 qw = *reinterpret_cast<const uint4*>(q8 + r * D + d);
            acc[k] = __dp4a(static_cast<int>(kw.x), static_cast<int>(qw.x),
                            acc[k]);
            acc[k] = __dp4a(static_cast<int>(kw.y), static_cast<int>(qw.y),
                            acc[k]);
            acc[k] = __dp4a(static_cast<int>(kw.z), static_cast<int>(qw.z),
                            acc[k]);
            acc[k] = __dp4a(static_cast<int>(kw.w), static_cast<int>(qw.w),
                            acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RMAX / 2; ++k) {
        const int r = rg + 2 * k;
        sv[k] = r < R ? static_cast<float>(acc[k]) * qsc_s[r] * ksc[c] : 0.f;
      }
    } else if constexpr (QT == QT_BF16) {
#pragma unroll
      for (int k = 0; k < RMAX / 2; ++k) sv[k] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 8) {
        const uint4 kw = *reinterpret_cast<const uint4*>(krow + 2 * d);
        float kf[2][4];
        cvt_bf16x4(make_uint2(kw.x, kw.y), kf[0]);
        cvt_bf16x4(make_uint2(kw.z, kw.w), kf[1]);
#pragma unroll
        for (int k = 0; k < RMAX / 2; ++k) {
          const int r = rg + 2 * k;
          if (r < R) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 q4 = *reinterpret_cast<const float4*>(
                  qs + r * D + d + 4 * e);
              sv[k] += q4.x * kf[e][0] + q4.y * kf[e][1] + q4.z * kf[e][2] +
                       q4.w * kf[e][3];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < RMAX / 2; ++k) sv[k] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 16) {
        const uint4 kw = *reinterpret_cast<const uint4*>(krow + d);
        float kf[4][4];
        cvt4<QT>(kw.x, kf[0]);
        cvt4<QT>(kw.y, kf[1]);
        cvt4<QT>(kw.z, kf[2]);
        cvt4<QT>(kw.w, kf[3]);
#pragma unroll
        for (int k = 0; k < RMAX / 2; ++k) {
          const int r = rg + 2 * k;
          if (r < R) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 q4 = *reinterpret_cast<const float4*>(
                  qs + r * D + d + 4 * e);
              sv[k] += q4.x * kf[e][0] + q4.y * kf[e][1] + q4.z * kf[e][2] +
                       q4.w * kf[e][3];
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RMAX / 2; ++k) sv[k] *= ksc[c];
    }
#pragma unroll
    for (int k = 0; k < RMAX / 2; ++k) {
      const int r = rg + 2 * k;
      if (r < R) {
        float s = sv[k];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        bool live = c < valid;
        if constexpr (BOUNDS) live = live && src.pos(j0 + i) + c < bnd[k];
        ps[r * C + c] = live ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row; ps becomes p * v_scale
    for (int r = warp; r < R; r += NTHREADS / 32) {
      const float x0 = ps[r * C + lane], x1 = ps[r * C + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int sft = 16; sft > 0; sft /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, sft));
      const float m_old = m_s[r];
      float m_new = fmaxf(m_old, mx);  // finite without BOUNDS: valid >= 1
      float m_use = m_new;
      // with BOUNDS a row may have no live token yet: exponentiate
      // against 0, so that it keeps p = 0, alpha = 0 and m = -inf
      if constexpr (BOUNDS) m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = __expf(x0 - m_use), p1 = __expf(x1 - m_use);
      if constexpr (SCALES) {
        ps[r * C + lane] = p0 * vsc[lane];
        ps[r * C + lane + 32] = p1 * vsc[lane + 32];
      } else {
        ps[r * C + lane] = p0;
        ps[r * C + lane + 32] = p1;
      }
      float sum = p0 + p1;
#pragma unroll
      for (int sft = 16; sft > 0; sft /= 2)
        sum += __shfl_xor_sync(0xffffffff, sum, sft);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + (p * v_scale) V: this thread's columns 4 * lane ..
    // + 3, this warp's tokens warp * 16 .. + 15 of the chunk
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) {
        const float alpha = a_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][e] *= alpha;
      }
    const unsigned char* vst = vs + stage * C * D * EB;
    for (int cc = warp * (C / 4); cc < (warp + 1) * (C / 4); cc += 4) {
      if (cc >= valid) break;  // the rest of the chunk is dead (p = 0)
      float vf[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (QT == QT_BF16)
          cvt_bf16x4(reinterpret_cast<const uint2*>(vst)[(cc + k) * (D / 4) +
                                                         lane],
                     vf[k]);
        else
          cvt4<QT>(reinterpret_cast<const uint32_t*>(vst)[(cc + k) * (D / 4) +
                                                          lane],
                   vf[k]);
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * C + cc);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[r][e] += p4.x * vf[0][e] + p4.y * vf[1][e] + p4.z * vf[2][e] +
                       p4.w * vf[3][e];
        }
    }
    // the next iteration's first barrier protects ps, a_s and this stage
  }
  rfa::cp_async_wait<0>();
  __syncthreads();

  // the four warps' sums meet in shared memory (the K and V stages)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < R)
      *reinterpret_cast<float4*>(red + (warp * RMAX + r) * D + 4 * lane) =
          make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) sum += red[(w * RMAX + r) * D + t];
    part_acc[(part0 + r) * D + t] = sum;
    if (t == 0) {
      part_ml[(part0 + r) * 2] = m_s[r];
      part_ml[(part0 + r) * 2 + 1] = l_s[r];
    }
  }
}

// A lane's live chunks in a paged cache (B5, B6): `len` tokens through
// the lane's block-table row, 64-token chunks that never span a page (cpp
// chunks per page, the last may be short).
struct PagedSrc {
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  int n_chunks;
  const int* table;  // this lane's block-table row
  int h, Hkv, num_pages, page_size, cpp, len;

  __device__ __forceinline__ void locate(int j, long long& tok0,
                                         int& valid) const {
    const int pg = j / cpp, off = (j % cpp) * C;
    // out-of-range ids are clamped, as the plain version's gather does
    const int page = min(max(table[pg], 0), num_pages - 1);
    tok0 = ((long long)page * Hkv + h) * page_size + off;
    valid = min(min(C, page_size - off), len - (pg * page_size + off));
  }

  // chunk j's first position in the lane
  __device__ __forceinline__ int pos(int j) const {
    return (j / cpp) * page_size + (j % cpp) * C;
  }
};

// The source of kv head h of lane b: its length clamped to the pages the
// table holds, and the number of live chunks that gives.
__device__ __forceinline__ PagedSrc paged_src(
    const unsigned char* k, const unsigned char* v, const float* ks,
    const float* vs, const int* block_tables, const int* seq_lens, int b,
    int h, int Hkv, int num_pages, int page_size, int npages) {
  const int len = min(max(seq_lens[b], 0), npages * page_size);
  const int cpp = (page_size + C - 1) / C;
  int n_chunks = 0;
  if (len > 0) {
    const int full = (len - 1) / page_size;  // pages before the last live
    n_chunks = full * cpp + (len - full * page_size + C - 1) / C;
  }
  return PagedSrc{k,        v,         ks,        vs,
                  n_chunks, block_tables + (long long)b * npages,
                  h,        Hkv,       num_pages, page_size,
                  cpp,      len};
}

// Merge the nsplit partials of each row, in a fixed order. grid
// (R, groups), NTHREADS threads, nsplit floats of dynamic shared memory.
// Row r of group g is row g * R + r of out (q's (B, Hq, Tq) rows are
// g-major within a kv head). Threads first share the splits (max of m,
// the weights exp(m_i - m) and the sum l); then warp w adds splits w,
// w + 4, ... for 4 columns a lane, and the four warps' sums meet in shared
// memory: no chain of dependent loads as long as nsplit.
__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* scratch) {
  const int t = threadIdx.x;
#pragma unroll
  for (int sft = 16; sft > 0; sft /= 2) {
    const float y = __shfl_xor_sync(0xffffffff, x, sft);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // scratch may still be read from the last call
  if (t % 32 == 0) scratch[t / 32] = x;
  __syncthreads();
  x = scratch[0];
#pragma unroll
  for (int w = 1; w < NTHREADS / 32; ++w)
    x = is_max ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

__global__ void __launch_bounds__(NTHREADS)
merge_splits_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    float* __restrict__ out, float* __restrict__ lse,
                    int nsplit, int R) {
  extern __shared__ __align__(16) float w_s[];  // [nsplit] weights
  __shared__ float scratch[NTHREADS / 32];
  __shared__ __align__(16) float red[NTHREADS / 32][D];
  const int r = blockIdx.x, t = threadIdx.x, warp = t / 32, lane = t % 32;
  const long long g = blockIdx.y;
  const long long first = g * nsplit * R + r;  // + sp * R per split

  float m = -INFINITY;
  for (int sp = t; sp < nsplit; sp += NTHREADS)
    m = fmaxf(m, part_ml[(first + (long long)sp * R) * 2]);
  m = block_reduce(m, true, scratch);
  float l = 0.f;
  for (int sp = t; sp < nsplit; sp += NTHREADS) {
    const long long p = first + (long long)sp * R;
    const float m_i = part_ml[p * 2];
    // an empty split, or a row with no live token at all, weighs nothing
    const float w = m_i > -INFINITY ? __expf(m_i - m) : 0.f;
    w_s[sp] = w;
    l += part_ml[p * 2 + 1] * w;
  }
  l = block_reduce(l, false, scratch);  // its barriers publish w_s too

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int sp = warp; sp < nsplit; sp += NTHREADS / 32) {
    const float4 a = *reinterpret_cast<const float4*>(
        part_acc + (first + (long long)sp * R) * D + 4 * lane);
    const float w = w_s[sp];
    acc.x += a.x * w;
    acc.y += a.y * w;
    acc.z += a.z * w;
    acc.w += a.w * w;
  }
  *reinterpret_cast<float4*>(&red[warp][4 * lane]) = acc;
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) sum += red[w][t];
  const long long row = g * R + r;
  out[row * D + t] = l > 0.f ? sum / l : 0.f;
  if (t == 0) lse[row] = l > 0.f ? m + logf(l) : RFA_NEG_INF;
}

// Launch the merge of `groups` groups of R rows, nsplit partials each.
inline cudaError_t merge_splits(const float* part_acc, const float* part_ml,
                                float* out, float* lse, int nsplit, int R,
                                int groups, cudaStream_t stream) {
  merge_splits_kernel<<<dim3(R, groups), NTHREADS, nsplit * sizeof(float),
                        stream>>>(part_acc, part_ml, out, lse, nsplit, R);
  return cudaGetLastError();
}

}  // namespace rfa_qd
