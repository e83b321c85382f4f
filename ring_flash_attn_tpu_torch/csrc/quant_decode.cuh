// Decode attention over a KV cache spread over blocks: the loop that kernels
// B4 (contiguous quantized cache, quant_decode.cu), B5 (bf16 pages,
// paged_decode.cu) and B6 (quantized pages, paged_quant_decode.cu) share,
// with the merge of a group's partials in the same launch.
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
// What bounds it on the H100: bytes. A token's K and V are used by only the
// R rows of its group (4 at Llama-3-8B widths), about two operations per
// byte (one for bf16), so the least time is one read of the live cache and
// scales at 3.35 TB/s. The design keeps cache bytes in flight on every SM
// all the time and the arithmetic well below them:
//
//  - a work plan made on the device from the live lengths (plan_piece):
//    each live (lane, kv head) group takes whole blocks, as many as its
//    live 64-token chunks ask for at the least per-block load that fits
//    the card's SMs, so that a long lane spreads over the card and a dead
//    or short one takes no more than a block; a block holds at most one
//    piece (a group's consecutive chunks), and the launcher sizes the grid
//    from shapes alone (ops/quant_decode_cuda.py::plan_grid) and never
//    syncs;
//  - a block runs NP pipelines side by side (pipes()), its piece's chunks
//    dealt out in turn to them;
//  - a pipeline is a producer warp and NCW consumer warps over a ring of
//    NST stages in shared memory. One producer thread issues a chunk's K
//    and V rows as two bulk copies (contiguous in both sources: ContigSrc,
//    and PagedSrc, whose chunk never spans a page) that complete on the
//    stage's full mbarrier; the warp's lanes copy the 2 x 64 scales with
//    cp.async (zero past the live tokens), arriving on the same barrier
//    when they land, and look up 32 chunks' pages at once. It waits only
//    for a stage's empty barrier;
//  - consumer warps never meet inside the loop: each owns 16 tokens of a
//    chunk and keeps its own online-softmax state per row, waits on the
//    full barrier and arrives on the empty one. QK and PV run on tensor
//    cores (mma.sync): the cached values are exact in the operand type
//    (int8 and fp8 in fp16, bf16 in bf16), and q and p are each split in
//    two 16-bit halves (fp16 after a power-of-two prescale, ~22 bits; bf16,
//    16 bits, for B5), so the results stay within fp32 rounding of
//    CUDA-core arithmetic, which had set the loop's time (PERF.md). With
//    QK_INT8 (B6 on int8 pages) q is quantized per row to int8 in the
//    block and QK is an exact s8 x s8 -> s32 product times
//    q_scale * k_scale, the function the TPU kernel computes;
//  - the warps' states meet at the end of the piece, in a fixed order, in
//    the K and V stages (every copy has landed); a piece that is its
//    whole group writes (out, lse), otherwise its partial, and the group's
//    last block to finish (a counter per group, between fences; the last
//    block resets it to 0) merges the pieces in piece order, all its loads
//    issued at once: the result depends only on the lengths, not on which
//    block finished first, and there is no second launch.
//
// The TPU kernels' sequential (B, n_blk) grid, all-heads block-diagonal
// matmul, 128-multiple blocks and pages_per_step are shapes of that
// machine and are not carried over: any length S >= 1 is taken.
//
// Head dims D 64, 128 and 256 (a template constant), and any number of
// rows: a block serves at most max_rows(D) of a group's R rows (16; 8 at
// D = 256, where the PV accumulator of 16 rows would take 256 registers a
// lane); past it (RG) each row group is a group of the plan, the row
// groups of a (batch, kv head) in consecutive blocks, so that their reads
// of a chunk meet in L2.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "hopper.cuh"

namespace rfa_qd {

constexpr int C = 64;            // tokens per chunk
constexpr int NCW = 4;           // consumer warps of a pipeline
constexpr int CT = C / NCW;      // tokens a consumer warp owns (16)
constexpr int CONSUMER_BAR = 1;  // named barrier of the consumer warps

enum { QT_INT8 = 0, QT_E4M3 = 1, QT_E5M2 = 2, QT_BF16 = 3 };

// bytes per cached value
template <int QT>
__host__ __device__ constexpr int value_bytes() {
  return QT == QT_BF16 ? 2 : 1;
}

// The most rows a block serves at head dim D: a consumer lane keeps
// D * RMAX / 16 fp32 of O (the hi and lo columns of each row), 128 at
// 16 x 128 and at 8 x 256.
__host__ __device__ constexpr int max_rows(int D) { return D > 128 ? 8 : 16; }

// Stages of a pipeline's chunk ring: a stage is 2 x 64 rows of D values
// (16 KB of int8/fp8 K+V at D = 128, 32 KB of bf16), and the rings of an
// SM's pipelines keep far more than the ~38 KB in flight that 3.35 TB/s
// needs at ~1.5 us of loaded latency: 3 stages up to 16 KB, else 2 (on
// the H100 6 stages at D = 64 and 3 at D = 256 measured no faster).
template <int D, int EB>
__host__ __device__ constexpr int stages() {
  return D * EB <= 128 ? 3 : 2;
}

// Pipelines a block runs side by side, each a producer warp and NCW
// consumer warps over its own ring and its own share of the block's
// chunks; one block an SM. As many as the registers allow at RMAX rows
// (an SM's four schedulers hold 16384 registers each, so a thread gets
// 16384 / (32 ceil(warps / 4)): 128 at 3 pipelines, 15 warps; 4
// pipelines, at 96, spilled and lost): 3 up to 8 rows and 64 fp32 of O a
// lane below D = 256, else 2 (16 rows at 64 spill at 128 registers: their
// QK tiles and p fragments are those of 16 rows whatever D); and the
// shared memory (at D = 128, 3 pipelines of int8/fp8 at ~51 KB, of bf16 at
// ~67 KB; a bf16 ring at D = 256, 2 stages of 64 KB, leaves room for
// one). Their states meet in shared memory at the end of the piece, so a
// group has a third as many partials to merge as with a block a pipeline.
// 8 rows at 64 take 2 (0 spills with a consumer warpgroup a pipeline).
template <int D, int RMAX, int EB>
__host__ __device__ constexpr int pipes() {
  return D * EB >= 512 ? 1
         : (RMAX == 4 && D < 256) || (RMAX == 8 && D == 128) ? 3
                                                              : 2;
}

// Two pipelines take a warpgroup of producers (two of its warps idle), so
// that each pipeline's consumers are a warpgroup of their own: the
// producers give registers back (setmaxnreg, 56 a thread) and the
// consumers take 224 where 10 warps would hold 168 (16 rows at 64 and 128,
// 4 and 8 rows of int8/fp8 at 256 spilled there).
template <int D, int RMAX, int EB>
__host__ __device__ constexpr bool wg_layout() {
  return pipes<D, RMAX, EB>() == 2;
}
// setmaxnreg only moves the registers the launch gave: each of an SM's
// four schedulers holds a producer warp and two consumer warps at 168
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * 168,
              "setmaxnreg.inc would wait for registers that never come");

template <int D, int RMAX, int EB>
__host__ __device__ constexpr int nthreads() {
  constexpr int NP = pipes<D, RMAX, EB>();
  return 32 * (NCW * NP + (wg_layout<D, RMAX, EB>() ? 4 : NP));
}

// A lane's share of a D-wide fp32 row in the merge, D / 32 floats: a
// float2 at 64, a float4 at 128, two float4s (columns 4 lane .. and
// 128 + 4 lane ..) at 256; loaded, zeroed, weighed and stored by the
// functions below.
struct float4x2 {
  float4 lo, hi;
};
template <int D>
using Part = std::conditional_t<D == 64, float2,
                                std::conditional_t<D == 128, float4,
                                                   float4x2>>;

__device__ __forceinline__ void part_ld(float2& a, const float* row,
                                        int lane) {
  a = __ldcg(reinterpret_cast<const float2*>(row) + lane);
}
__device__ __forceinline__ void part_ld(float4& a, const float* row,
                                        int lane) {
  a = __ldcg(reinterpret_cast<const float4*>(row) + lane);
}
__device__ __forceinline__ void part_ld(float4x2& a, const float* row,
                                        int lane) {
  a.lo = __ldcg(reinterpret_cast<const float4*>(row) + lane);
  a.hi = __ldcg(reinterpret_cast<const float4*>(row) + lane + 32);
}
__device__ __forceinline__ void part_st(float* row, int lane,
                                        const float2& a) {
  reinterpret_cast<float2*>(row)[lane] = a;
}
__device__ __forceinline__ void part_st(float* row, int lane,
                                        const float4& a) {
  reinterpret_cast<float4*>(row)[lane] = a;
}
__device__ __forceinline__ void part_st(float* row, int lane,
                                        const float4x2& a) {
  reinterpret_cast<float4*>(row)[lane] = a.lo;
  reinterpret_cast<float4*>(row)[lane + 32] = a.hi;
}
__device__ __forceinline__ void part_zero(float2& a) {
  a = make_float2(0.f, 0.f);
}
__device__ __forceinline__ void part_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void part_zero(float4x2& a) {
  part_zero(a.lo);
  part_zero(a.hi);
}
__device__ __forceinline__ void part_axpy(float2& a, const float2& x,
                                          float w) {
  a.x += x.x * w;
  a.y += x.y * w;
}
__device__ __forceinline__ void part_axpy(float4& a, const float4& x,
                                          float w) {
  a.x += x.x * w;
  a.y += x.y * w;
  a.z += x.z * w;
  a.w += x.w * w;
}
__device__ __forceinline__ void part_axpy(float4x2& a, const float4x2& x,
                                          float w) {
  part_axpy(a.lo, x.lo, w);
  part_axpy(a.hi, x.hi, w);
}

template <int D, int RMAX, int EB>
struct Smem {
  static constexpr int NST = stages<D, EB>();
  static constexpr int NP = pipes<D, RMAX, EB>();
  static constexpr int RB = D * EB;                 // bytes of a K or V row
  // a pipeline's part, PIPE bytes, NP of them one after the other
  static constexpr int BAR = 0;                     // u64 full[NST], empty[NST]
  static constexpr int K = 128;                     // u8 [NST][C][RB]
  static constexpr int V = K + NST * C * RB;        // u8 [NST][C][RB]
  static constexpr int SC = V + NST * C * RB;       // f32 [NST][2][C]
  static constexpr int P = SC + NST * 2 * C * 4;    // f32 [NCW][RMAX][CT]
  static constexpr int ML = P + NCW * RMAX * CT * 4;  // f32 [2][NCW][RMAX]
  static constexpr int INFO = ML + 2 * NCW * RMAX * 4;  // s32x2 [NST]
  static constexpr int PIPE = (INFO + NST * 8 + 127) / 128 * 128;
  // the block's part
  static constexpr int Q = NP * PIPE;               // f32 [RMAX][D]
  static constexpr int Q8 = Q + RMAX * D * 4;       // s8 [RMAX][D]
  static constexpr int QSC = Q8 + RMAX * D;         // f32 [RMAX]
  static constexpr int PRE = QSC + RMAX * 4;        // f32 [RMAX]
  static constexpr int BND = PRE + RMAX * 4;        // s32 [RMAX]
  static constexpr int QF = BND + RMAX * 4;  // u32x2 [D/16][RMAX/4][32]
  static constexpr int PIECE = QF + D / 16 * (RMAX / 4) * 32 * 8;  // Piece
  static constexpr int BYTES = PIECE + 32;
  // the end of the piece reuses each pipeline's K and V stages for its
  // warps' sums [NCW][RMAX][D], and the first's for the merge's m values
  // [pieces][R]
  static constexpr int KV_BYTES = 2 * NST * C * RB;
  static_assert(NCW * RMAX * D * 4 <= KV_BYTES, "reduction must fit");
  static_assert(2 * NST * 8 <= K, "barriers must fit");
  static_assert(BYTES <= 227 * 1024, "one block an SM");
};

// Where a piece's result goes (see plan_piece): (out, lse) rows g * R + r
// when the piece is its whole group; otherwise its partial (acc, (m, l))
// in slot `slot` = its block (a block holds one piece at most, and a
// block with a partial is below TARGET_BLOCKS), part_acc[(slot * PS + r)
// * D + d] and part_ml[(slot * PS + r) * 2 + {0, 1}], merged into (out, lse) by the
// group's last block, which counters[group] (0 between launches) tells.
// With row groups (RG) a group is a row group, (batch, kv head) group *
// ceil(R / RMAX) + row group, and its partials take PS = RMAX rows, the
// last row group's too.
struct Dest {
  float* out;
  float* lse;
  float* part_acc;
  float* part_ml;
  int* counters;
};

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// x as the compiler cannot see it. A thread's place made from
// opaque(threadIdx.x) after the chunk loop, and all that depends on it, is
// made there: nothing of it is kept from before to hold registers through
// the chunk loop, whose registers are the kernel's limit.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float warp_max(float x, int from, int to = 32) {
#pragma unroll
  for (int sft = from; sft < to; sft *= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, sft));
  return x;
}

__device__ __forceinline__ float warp_sum(float x, int from) {
#pragma unroll
  for (int sft = from; sft < 32; sft *= 2)
    x += __shfl_xor_sync(0xffffffff, x, sft);
  return x;
}

// d += a b: mma.sync m16n8k16 with fp16 (BF: bf16) operands and fp32
// accumulators. Fragments (g = lane / 4, t = lane % 4): a holds A rows g,
// g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9; b holds B rows 2t,
// 2t + 1 and 2t + 8, 2t + 9 at column g; d holds D rows g, g + 8 at
// columns 2t, 2t + 1. The lower element of a pair is in the low half.
template <bool BF>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (BF)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b exactly: mma.sync m16n8k32, s8 operands, s32 accumulators (a:
// rows g, g + 8 at columns 4t .. 4t + 3 and 16 + 4t ..; b: rows 4t .. and
// 16 + 4t .. at column g).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 2 pair and 2 pair + 1 of w, int8 or fp8 values, as an fp16 pair,
// exactly: int8 by a byte permute into the mantissa of 1024 and one
// subtraction of 1152, fp8 by the hardware's fp8x2 -> half2 conversion.
template <int QT>
__device__ __forceinline__ uint32_t half2_of(uint32_t w, int pair) {
  if constexpr (QT == QT_INT8) {
    const uint32_t h = __byte_perm(w ^ 0x80808080u, 0x64646464u,
                                   pair ? 0x4342 : 0x4140);
    const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h),
                              __half2(__ushort_as_half(0x6480),
                                      __ushort_as_half(0x6480)));
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        QT == QT_E4M3 ? __NV_E4M3 : __NV_E5M2;
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(pair ? w >> 16 : w & 0xffffu),
        kind);
    return static_cast<uint32_t>(r.x) | (static_cast<uint32_t>(r.y) << 16);
  }
}

// The pair (a, b) as 16-bit halves: part 0 the nearest fp16 (BF: bf16),
// part 1 what is left of it.
template <bool BF>
__device__ __forceinline__ uint32_t split_pair(float a, float b, int part) {
  if constexpr (BF) {
    __nv_bfloat16 x = __float2bfloat16_rn(a), y = __float2bfloat16_rn(b);
    if (part) {
      x = __float2bfloat16_rn(a - __bfloat162float(x));
      y = __float2bfloat16_rn(b - __bfloat162float(y));
    }
    return static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
  } else {
    __half x = __float2half_rn(a), y = __float2half_rn(b);
    if (part) {
      x = __float2half_rn(a - __half2float(x));
      y = __float2half_rn(b - __half2float(y));
    }
    return static_cast<uint32_t>(__half_as_ushort(x)) |
           (static_cast<uint32_t>(__half_as_ushort(y)) << 16);
  }
}

// The o-th row whose scores and output columns lane 4 g + t holds: at 4
// rows rows 2 (t % 2), + 1 (lanes t and t ^ 2 hold the hi and lo halves),
// else rows 8 (o / 2) + 2t + o % 2 (the hi n-tiles first, the lo after).
template <int RMAX>
__device__ __forceinline__ int own_row(int o, int t) {
  return RMAX == 4 ? 2 * (t & 1) + o : 8 * (o / 2) + 2 * t + o % 2;
}

// Warp w's sums [RMAX][D] at the end of the piece, in its pipeline's
// stages.
template <int D, int RMAX, int EB>
__device__ __forceinline__ float* red_of(unsigned char* smem, int w) {
  using S = Smem<D, RMAX, EB>;
  return reinterpret_cast<float*>(smem + (w / NCW) * S::PIPE + S::K) +
         (w % NCW) * RMAX * D;
}

// Merge the np pieces of group g, in slots first / PS .. (their partial
// rows from `first`, PS rows a piece), into (out, lse) rows row0 ..
// row0 + R - 1, in piece order: the group's last block, consumer threads
// only. All loads are issued at once: every (piece, row)'s m into ms, and
// warp w's pieces w, w + NW, ... (UNR of them) into registers, D / 32
// columns a lane. Then warp r takes row r's maximum, each warp weighs and
// adds its pieces, and the warps' sums meet in shared memory, in a fixed
// order. m_s holds RMAX floats, l_w NW * RMAX.
template <int D, int RMAX, int EB>
__device__ __forceinline__ void merge_group(const Dest& dst, long long g,
                                            long long row0, long long first,
                                            int np, int R, int PS,
                                            unsigned char* smem, float* m_s,
                                            float* l_w) {
  constexpr int NW = NCW * pipes<D, RMAX, EB>();
  constexpr int UNR = D * RMAX <= 1024 ? 2 : 1;
  float* ms = red_of<D, RMAX, EB>(smem, 0);
  const int t = opaque(threadIdx.x), warp = t / 32, lane = t % 32;
  for (int i = t; i < np * R; i += 32 * NW)
    ms[i] = __ldcg(dst.part_ml + (first + (long long)(i / R) * PS + i % R) * 2);
  Part<D> acc[RMAX];
  float l[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    part_zero(acc[r]);
    l[r] = 0.f;
  }
  auto row_maxima = [&]() {  // once every m has landed
    hop::bar_sync(CONSUMER_BAR, 32 * NW);
    for (int r = warp; r < R; r += NW) {
      float m = -INFINITY;
      for (int sp = lane; sp < np; sp += 32) m = fmaxf(m, ms[sp * R + r]);
      m = warp_max(m, 1);
      if (lane == 0) m_s[r] = m;
    }
    hop::bar_sync(CONSUMER_BAR, 32 * NW);
  };
  for (int sp0 = warp; sp0 < np; sp0 += NW * UNR) {
    Part<D> a[UNR][RMAX];
    float li[UNR][RMAX];
#pragma unroll
    for (int u = 0; u < UNR; ++u)
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R && sp0 + NW * u < np) {
          const long long row = first + (long long)(sp0 + NW * u) * PS + r;
          part_ld(a[u][r], dst.part_acc + row * D, lane);
          li[u][r] = __ldcg(dst.part_ml + row * 2 + 1);
        }
    if (sp0 == warp) row_maxima();
#pragma unroll
    for (int u = 0; u < UNR; ++u)
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R && sp0 + NW * u < np) {
          const float m_i = ms[(sp0 + NW * u) * R + r];
          // an empty piece, or a row with no live token, weighs nothing
          const float w = m_i > -INFINITY ? __expf(m_i - m_s[r]) : 0.f;
          part_axpy(acc[r], a[u][r], w);
          l[r] += li[u][r] * w;
        }
  }
  if (warp >= np) row_maxima();  // no piece of its own: it still takes them
  hop::bar_sync(CONSUMER_BAR, 32 * NW);  // ms is read; sums may overlap it
  float* red = red_of<D, RMAX, EB>(smem, warp);
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < R) {
      part_st(red + r * D, lane, acc[r]);
      if (lane == 0) l_w[warp * RMAX + r] = l[r];
    }
  hop::bar_sync(CONSUMER_BAR, 32 * NW);
  for (int i = t; i < R * D; i += 32 * NW) {  // a (row, column) a thread
    const int r = i / D, c = i % D;
    float sum = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      sum += red_of<D, RMAX, EB>(smem, w)[r * D + c];
      lsum += l_w[w * RMAX + r];
    }
    const long long row = row0 + r;
    dst.out[row * D + c] = lsum > 0.f ? sum / lsum : 0.f;
    if (c == 0)
      dst.lse[row] = lsum > 0.f ? m_s[r] + logf(lsum) : RFA_NEG_INF;
  }
  if (t == 0) dst.counters[g] = 0;  // no other block of the group is left
}

// The launch's work plan, made on the device from what the kernel reads
// (the lanes' live lengths: seq_lens, or B4's length), by every warp that
// needs it the same way, so that the launcher needs no host sync; ops/
// quant_decode_cuda.py::work_plan is its twin, and the tests hold it.
// Group g = b * GL + x is lane b's x-th (kv head x / nrg, row group
// x % nrg); each of a lane's GL groups holds the lane's n(b) live chunks.
// Each live group takes s(b) = ceil(n(b) / L) whole blocks, its chunks
// cut into s(b) near-equal runs of consecutive chunks (pieces), at the
// least load L of at least MIN_CHUNKS (or the longest lane's chunks) whose
// blocks fit in U = max(live groups, min(grid, TARGET_BLOCKS)): a long
// lane spreads over the card (the balanced split-KV of FlashInfer, arXiv
// 2501.01005, with whole blocks a group), a group never waits for a
// block, and a group is cut only within the first wave. The groups take
// the blocks in order, a group's pieces in consecutive blocks. A block
// holds one piece at most: two pieces of two groups in one block, each
// with its own meeting of the warps and its own merge, cost more than
// the balance they bought.
constexpr int MIN_CHUNKS = 4;
constexpr int TARGET_BLOCKS = 132;  // one block an SM of the H100 SXM

// a / b for 0 <= a < 2^31, 0 < b: a float estimate, made exact. An
// integer division costs ~200 cycles on the H100, and the plan sits in
// front of a block's first load.
__device__ __forceinline__ int udiv(int a, int b) {
  int q = static_cast<int>(__fdividef(static_cast<float>(a),
                                      static_cast<float>(b)));
  while (q > 0 && q * b > a) --q;
  while ((q + 1) * b <= a) ++q;
  return q;
}

// A block's piece: chunks j0 .. j0 + n - 1 of group x of lane b (n = 0:
// the block has none), piece k of the group's s, which lie in blocks
// blockIdx.x - k .. blockIdx.x - k + s - 1.
struct Piece {
  int b, x, j0, n, k, s;
};

// piece k of s of group x of lane b, whose n chunks are cut at k n / s (s
// <= TARGET_BLOCKS where s > 1, so the products stay small)
__device__ __forceinline__ Piece piece_of(int b, int x, int n, int k, int s) {
  const int q = udiv(n, s), rem = n - q * s;
  const int j0 = k * q + udiv(k * rem, s);
  const int j1 = (k + 1) * q + udiv((k + 1) * rem, s);
  return Piece{b, x, j0, j1 - j0, k, s};
}

// blockIdx.x's piece, by the 32 lanes of a warp (the lanes 32 at a time,
// the first 32 lanes' chunks kept in a register: the plan sits in front of
// a block's first load)
template <class Lanes>
__device__ __forceinline__ Piece plan_piece(const Lanes& lanes, int B,
                                            int GL, int lane) {
  const Piece none{0, 0, 0, 0, 0, 1};
  if constexpr (Lanes::EQUAL) {
    // every lane holds n chunks (B4): each group takes s = ceil(n / L)
    // blocks, L the least from the same lower bound with G s <= U
    const int n = lanes.chunks(0), G = B * GL;
    if (n == 0) return none;
    const int U = max(G, min(static_cast<int>(gridDim.x), TARGET_BLOCKS));
    const int most = udiv(U, G);  // blocks a group may take
    const int L = max(max(min(MIN_CHUNKS, n), udiv(G * n + U - 1, U)),
                      udiv(n + most - 1, most));
    const int s = udiv(n + L - 1, L), p = blockIdx.x;
    if (p >= G * s) return none;
    const int g = udiv(p, s), b = udiv(g, GL);
    return piece_of(b, g - b * GL, n, p - g * s, s);
  }
  const int n0 = lane < B ? lanes.chunks(lane) : 0;
  auto chunks_at = [&](int c) {  // lane c + lane's chunks (0 past B)
    return c == 0 ? n0 : c + lane < B ? lanes.chunks(c + lane) : 0;
  };
  int sum = 0, live = 0, nmax = 0;
  for (int c = 0; c < B; c += 32) {
    const int n = chunks_at(c);
    sum += n;
    live += n > 0;
    nmax = max(nmax, n);
  }
  sum = __reduce_add_sync(0xffffffff, sum) * GL;
  live = __reduce_add_sync(0xffffffff, live) * GL;
  nmax = __reduce_max_sync(0xffffffff, nmax);
  if (live == 0) return none;
  const int U = max(live, min(static_cast<int>(gridDim.x), TARGET_BLOCKS));
  // the blocks that a load of L chunks a block takes
  auto blocks_at = [&](int L) {
    int v = 0;
    for (int c = 0; c < B; c += 32) v += udiv(chunks_at(c) + L - 1, L);
    return __reduce_add_sync(0xffffffff, v) * GL;
  };
  // the least L from lo that fits, found in (lo, hi]: hi fits, since a
  // group takes at most n / L + 1 blocks, and so does nmax (a block a
  // live group)
  int L = max(min(MIN_CHUNKS, nmax), udiv(sum + U - 1, U));
  int hi = live < U ? min(nmax, udiv(sum + U - live - 1, U - live)) : nmax;
  if (L < hi && blocks_at(L) > U) {
    while (hi - L > 1) {
      const int mid = (L + hi) / 2;
      if (blocks_at(mid) <= U)
        hi = mid;
      else
        L = mid;
    }
    L = hi;
  }
  const int p = blockIdx.x;
  int base = 0;
  for (int c = 0; c < B; c += 32) {
    const int n = chunks_at(c);
    const int sb = udiv(n + L - 1, L), v = sb * GL;
    int incl = v;
#pragma unroll
    for (int sft = 1; sft < 32; sft *= 2) {
      const int u = __shfl_up_sync(0xffffffff, incl, sft);
      if (lane >= sft) incl += u;
    }
    const unsigned hit = __ballot_sync(0xffffffff, base + incl > p);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const int r = p - base - __shfl_sync(0xffffffff, incl - v, f);
      const int nf = __shfl_sync(0xffffffff, n, f);
      const int s = __shfl_sync(0xffffffff, sb, f);
      const int x = udiv(r, s);
      return piece_of(c + f, x, nf, r - x * s, s);
    }
    base += __shfl_sync(0xffffffff, incl, 31);
  }
  return none;  // past the blocks the plan takes
}

// The launch's share of block blockIdx.x, nthreads() threads: NP
// pipelines. Lanes gives the lanes' live chunks and each group's source:
//   chunks(b): lane b's live chunks (every kv head's alike);
//   src(b, h): lane b's kv head h, with locate(j, tok0, valid): chunk j
//   starts at token index tok0 of the k/v arrays (byte offset
//   tok0 * D * value_bytes, scale offset tok0) and holds `valid` live
//   tokens (1..C); count(j): that `valid` alone; with BOUNDS, pos(j):
//   chunk j's first position in the lane, and bound(r): row r of the group
//   sees positions below it only.
// q rows (b * Hkv + h) * R .. + R of the (rows, D) query; with RG
// (R > RMAX) a group takes row group rg of them, rows rg * RMAX .. + RMAX.
// The block takes its piece (plan_piece): the consumers load its q, their
// pipelines take its chunks in turn, the warps' states meet, and the piece
// writes (out, lse) or its partial, the group's last block merging them.
template <int QT, bool QK_INT8, int D, int RMAX, bool BOUNDS = false,
          bool RG = false, class Lanes>
__device__ __forceinline__ void decode_lanes(const Lanes& lanes, int B,
                                             int Hkv,
                                             const void* __restrict__ q,
                                             int q_bf16, int R_group,
                                             float scale, float softcap,
                                             const Dest& dst) {
  constexpr int EB = value_bytes<QT>();
  constexpr bool SCALES = QT != QT_BF16;
  using S = Smem<D, RMAX, EB>;
  constexpr int NST = S::NST, RB = S::RB, NP = S::NP;
  constexpr int NW = NCW * NP, NCONS = 32 * NW;  // consumer warps, threads
  constexpr bool WG = wg_layout<D, RMAX, EB>();
  constexpr bool BF = QT == QT_BF16;
  constexpr int NT = RMAX / 4;                    // n-tiles of 8 columns
  constexpr int NKT = QK_INT8 ? D / 32 : D / 16;  // k-tiles of QK
  constexpr int NO = RMAX == 4 ? 2 : RMAX / 4;    // rows a lane owns
  constexpr int MT = D / 16;                      // m-tiles of PV
  // bf16 K rows are read in blocks of BK elements, BP pieces of 8 a lane
  constexpr int BK = D < 128 ? D : 128, BP = BK / 32;
  // a group is a (lane, kv head) pair, or with RG one of its nrg row groups
  const int nrg = RG ? (R_group + RMAX - 1) / RMAX : 1;
  const int GL = Hkv * nrg;  // groups a lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);
  signed char* q8 = reinterpret_cast<signed char*>(smem + S::Q8);
  float* qsc_s = reinterpret_cast<float*>(smem + S::QSC);
  float* pre_s = reinterpret_cast<float*>(smem + S::PRE);
  uint2* qf = reinterpret_cast<uint2*>(smem + S::QF);
  int* bnd_s = reinterpret_cast<int*>(smem + S::BND);
  Piece* piece_s = reinterpret_cast<Piece*>(smem + S::PIECE);
  int* last_s = reinterpret_cast<int*>(smem + S::PIECE + sizeof(Piece));
  static_assert(sizeof(Piece) + 4 <= 32, "the piece must fit");

  // warps 0 .. NW - 1 consume, pipeline w / NCW; warps NW .. NW + NP - 1
  // produce, pipeline w - NW (WG: the producers' warpgroup has 4 warps,
  // the last 4 - NP idle)
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int pipe = warp < NW ? warp / NCW : warp - NW;
  unsigned char* ps = smem + min(pipe, NP - 1) * S::PIPE;  // its part
  uint64_t* full = reinterpret_cast<uint64_t*>(ps + S::BAR);
  uint64_t* empty = full + NST;
  unsigned char* ks = ps + S::K;
  unsigned char* vs = ps + S::V;
  float* sc = reinterpret_cast<float*>(ps + S::SC);
  int2* info = reinterpret_cast<int2*>(ps + S::INFO);  // [NST]

  // the block's piece, made while thread 0 sets the barriers up: by each
  // producer, and by consumer warp 1 for the others
  Piece pc{0, 0, 0, 0, 0, 1};
  if (warp == 1 || (warp >= NW && warp < NW + NP))
    pc = plan_piece(lanes, B, GL, lane);
  if (t == 0) {
    for (int p = 0; p < NP; ++p)
      for (int s = 0; s < NST; ++s) {
        uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p * S::PIPE);
        hop::mbar_init(&bar[s], 1 + (SCALES ? 32 : 0));
        hop::mbar_init(&bar[NST + s], NCW);
      }
    hop::mbar_fence_init();
  }
  if (t == 32) *piece_s = pc;
  __syncthreads();

  if (warp >= NW) {  // a producer
    if constexpr (WG) hop::setmaxnreg_dec<PRODUCER_REGS>();
    // this pipeline takes the piece's chunks j0, j0 + NP, ...
    const int n = pipe < NP ? max(0, (pc.n - pipe + NP - 1) / NP) : 0;
    if (n == 0) return;
    const int j0 = pc.j0 + pipe;
    const auto src = lanes.src(pc.b, RG ? udiv(pc.x, nrg) : pc.x);
    long long tok0_l = 0;  // lane l: where chunk 32 (i / 32) + l lies
    int valid_l = 0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int st = i % NST;
      // the lanes look up 32 chunks at once (a paged chunk's page id is
      // a load from the block table), ahead of the wait for the stage
      if (i % 32 == 0 && i + lane < n)
        src.locate(j0 + (i + lane) * NP, tok0_l, valid_l);
      const long long tok0 = __shfl_sync(0xffffffff, tok0_l, i % 32);
      const int valid = __shfl_sync(0xffffffff, valid_l, i % 32);
      if (i >= NST) hop::mbar_wait(&empty[st], ((i / NST) + 1) & 1);
      if (lane == 0) {
        // the chunk's live tokens and first position, for the consumers
        int pos = 0;
        if constexpr (BOUNDS) pos = src.pos(j0 + i * NP);
        info[st] = make_int2(valid, pos);
        const uint32_t bytes = valid * RB;
        hop::mbar_arrive_tx(&full[st], 2 * bytes);
        hop::bulk_load(ks + st * C * RB, src.k + tok0 * RB, bytes,
                       &full[st]);
        hop::bulk_load(vs + st * C * RB, src.v + tok0 * RB, bytes,
                       &full[st]);
      }
      if constexpr (SCALES) {
#pragma unroll
        for (int c = lane; c < C; c += 32) {
          const bool ok = c < valid;
          const long long at = ok ? tok0 + c : 0;
          rfa::cp_async4(sc + st * 2 * C + c, src.ks + at, ok ? 4 : 0);
          rfa::cp_async4(sc + (st * 2 + 1) * C + c, src.vs + at,
                         ok ? 4 : 0);
        }
        hop::cp_async_mbar_arrive(&full[st]);
      }
    }
    if constexpr (SCALES) rfa::cp_async_wait_all();  // none outlives us
    return;
  }
  if constexpr (WG) hop::setmaxnreg_inc<CONSUMER_REGS>();

  // consumers, on tensor cores (mma.sync, lane = 4 g4 + t4): QK is S^T
  // (a warp's 16 tokens x 8 NT columns) = K q^T and PV is O^T (D dims x
  // 8 NT columns) = V^T P^T. A column x is half `x / RMAX` (hi or lo) of
  // row x % RMAX: q and p are each split into two 16-bit halves whose sum
  // holds ~22 bits (fp16, after a power-of-two prescale) or 16 (bf16, B5),
  // against values that are exact in the operand type (int8 and fp8 in
  // fp16, bf16 in bf16), so the products stay within fp32 rounding of the
  // CUDA-core arithmetic. With QK_INT8, QK is an exact s8 x s8 product
  // (m16n8k32), the lo half zero.
  // a lane with no live token: out = 0, lse = NEG_INF on all its rows,
  // the lanes dealt out over the grid
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    if (lanes.chunks(b) == 0) {
      const long long rows = static_cast<long long>(Hkv) * R_group;
      for (long long i = t; i < rows * D; i += NCONS)
        dst.out[b * rows * D + i] = 0.f;
      for (long long i = t; i < rows; i += NCONS)
        dst.lse[b * rows + i] = RFA_NEG_INF;
    }
  {
    // the thread's place, made anew (opaque): none of the prologue's
    // values holds a register through the chunk loop
    const int t = opaque(threadIdx.x), warp = t / 32, lane = t % 32;
    const int g4 = lane >> 2, t4 = lane & 3, wl = warp % NCW;
    const int pipe = warp / NCW;
    unsigned char* ps = smem + pipe * S::PIPE;
    uint64_t* full = reinterpret_cast<uint64_t*>(ps + S::BAR);
    uint64_t* empty = full + NST;
    unsigned char* ks = ps + S::K;
    unsigned char* vs = ps + S::V;
    float* sc = reinterpret_cast<float*>(ps + S::SC);
    int2* info = reinterpret_cast<int2*>(ps + S::INFO);
    float* pw = reinterpret_cast<float*>(ps + S::P) + wl * RMAX * CT;
    // the piece: n chunks of this pipeline; R rows of its group from row
    // r0, q and out rows from row0 = (b * Hkv + h) * R_group + r0 (the
    // chunks' live tokens and positions come with them: info)
    int n, R;
    {
      const Piece w = *piece_s;
      if (w.n == 0) return;
      n = max(0, (w.n - pipe + NP - 1) / NP);
      const int h = RG ? udiv(w.x, nrg) : w.x;
      const int r0 = RG ? (w.x - h * nrg) * RMAX : 0;
      R = RG ? min(RMAX, R_group - r0) : R_group;
      const long long row0 =
          (static_cast<long long>(w.b) * Hkv + h) * R_group + r0;
      for (int i = t; i < R * D; i += NCONS) {
        const float x =
            q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[row0 * D + i])
                   : static_cast<const float*>(q)[row0 * D + i];
        qs[i] = x * scale;
      }
      if constexpr (BOUNDS) {
        if (t < R) bnd_s[t] = lanes.src(w.b, h).bound(r0 + t);
      }
    }
    hop::bar_sync(CONSUMER_BAR, NCONS);
    for (int r = warp; r < R; r += NW) {
      float x[D / 32];
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        x[e] = qs[r * D + lane + 32 * e];
        amax = fmaxf(amax, fabsf(x[e]));
      }
      amax = warp_max(amax, 1);
      if constexpr (QK_INT8) {
        // q rows to int8: scale max|q| / 127 (floor 1e-20), round half to
        // even
        const float qsc = fmaxf(amax / 127.f, 1e-20f);
#pragma unroll
        for (int e = 0; e < D / 32; ++e) {
          const float v = rintf(x[e] / qsc);
          q8[r * D + lane + 32 * e] =
              static_cast<signed char>(fminf(fmaxf(v, -127.f), 127.f));
        }
        if (lane == 0) qsc_s[r] = qsc;
      } else if (lane == 0) {
        // fp16 halves: max|q| * 2^e in [2^14, 2^15), so that the lo half
        // stays a normal number; bf16 halves need no prescale
        int ex = 0;
        frexpf(amax, &ex);
        const float pre = (BF || amax == 0.f) ? 1.f : ldexpf(1.f, 15 - ex);
        pre_s[r] = pre;
        qsc_s[r] = 1.f / pre;  // exact: a power of two
      }
    }
    hop::bar_sync(CONSUMER_BAR, NCONS);
    // q's B fragments, once a block: kt, n-tile, lane
    for (int i = t; i < NKT * NT * 32; i += NCONS) {
      const int kt = i / (NT * 32), nt = (i / 32) % NT, ln = i % 32;
      const int gg = ln >> 2, tt = ln & 3;
      const int x = 8 * nt + gg, part = x / RMAX, row = x % RMAX;
      uint2 b = make_uint2(0u, 0u);
      if (row < R) {
        if constexpr (QK_INT8) {
          if (part == 0) {
            const int d0 = 64 * (kt / 2) + 16 * tt + 8 * (kt % 2);
            b.x = *reinterpret_cast<const uint32_t*>(q8 + row * D + d0);
            b.y = *reinterpret_cast<const uint32_t*>(q8 + row * D + d0 + 4);
          }
        } else {
          // (BF: lane t4 holds elements BK / 4 * t4 .. of each block of BK;
          // see the QK loads below)
          const int d0 = BF ? (D == 128 ? 32 * tt + 8 * (kt / 2) + 4 * (kt % 2)
                                        : BK * (kt / 2 / BP) + BK / 4 * tt +
                                              8 * (kt / 2 % BP) + 4 * (kt % 2))
                            : 64 * (kt / 4) + 16 * tt + 4 * (kt % 4);
          const float* qr = qs + row * D + d0;
          const float pre = pre_s[row];
          b.x = split_pair<BF>(qr[0] * pre, qr[1] * pre, part);
          b.y = split_pair<BF>(qr[2] * pre, qr[3] * pre, part);
        }
      }
      qf[i] = b;
    }
    hop::bar_sync(CONSUMER_BAR, NCONS);

    float oacc[MT][NT][4];  // O^T: m-tile, n-tile, fragment
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][nt][e] = 0.f;
    float m[NO], l[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      m[o] = -INFINITY;
      l[o] = 0.f;
    }
    float U = 1.f;  // oacc holds O / U (1-byte caches: p carries v_scale / U)
    const bool writer = RMAX != 4 || t4 < 2;  // at 4 rows t4 ^ 2 agrees

#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int st = i % NST;
      hop::mbar_wait(&full[st], (i / NST) & 1);
      const int2 inf = info[st];  // the chunk's live tokens, position
      const int valid = inf.x;
      const int tok0 = CT * wl;  // this warp's tokens: tok0 .. tok0 + 15
      if (tok0 < valid) {
        const unsigned char* kst = ks + st * C * RB;
        const unsigned char* vst = vs + st * C * RB;
        const float* ksc = sc + st * 2 * C;
        const float* vsc = ksc + C;
        const int pos0 = inf.y;

        // QK: rows g4 and g4 + 8 of the warp's tokens, 16 bytes a load
        const unsigned char* kr0 = kst + (tok0 + g4) * RB;
        const unsigned char* kr1 = kr0 + 8 * RB;
        float sacc[NT][4];
        int iacc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[nt][e] = 0.f;
            iacc[nt][e] = 0;
          }
        auto qfrag = [&](int kt, int nt) {
          return qf[(kt * NT + nt) * 32 + lane];
        };
        if constexpr (BF) {
#pragma unroll
          for (int p = 0; p < D / 32; ++p) {
            // lane t4's 8 elements of piece p: BK / 4 * t4 + 8 p within a
            // block of BK, so that at 256 the banks meet as they do at 128
            const int at = D == 128 ? 64 * t4 + 16 * p
                                    : 2 * (BK * (p / BP) + BK / 4 * t4 +
                                           8 * (p % BP));
            const uint4 w0 = *reinterpret_cast<const uint4*>(kr0 + at);
            const uint4 w1 = *reinterpret_cast<const uint4*>(kr1 + at);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const uint32_t a[4] = {jj ? w0.z : w0.x, jj ? w1.z : w1.x,
                                     jj ? w0.w : w0.y, jj ? w1.w : w1.y};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const uint2 b = qfrag(2 * p + jj, nt);
                mma16<true>(sacc[nt], a, b.x, b.y);
              }
            }
          }
        } else {
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            const int at = 64 * h + 16 * t4;
            const uint4 w0 = *reinterpret_cast<const uint4*>(kr0 + at);
            const uint4 w1 = *reinterpret_cast<const uint4*>(kr1 + at);
            const uint32_t c0[4] = {w0.x, w0.y, w0.z, w0.w};
            const uint32_t c1[4] = {w1.x, w1.y, w1.z, w1.w};
            if constexpr (QK_INT8) {
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const uint32_t a[4] = {c0[2 * jj], c1[2 * jj], c0[2 * jj + 1],
                                       c1[2 * jj + 1]};
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  const uint2 b = qfrag(2 * h + jj, nt);
                  mma_s8(iacc[nt], a, b.x, b.y);
                }
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const uint32_t a[4] = {
                    half2_of<QT>(c0[j], 0), half2_of<QT>(c1[j], 0),
                    half2_of<QT>(c0[j], 1), half2_of<QT>(c1[j], 1)};
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  const uint2 b = qfrag(4 * h + j, nt);
                  mma16<false>(sacc[nt], a, b.x, b.y);
                }
              }
            }
          }
        }

        // the owned rows' scores: o-th row, tokens g4 (k = 0) and g4 + 8
        float sv[NO][2];
#pragma unroll
        for (int o = 0; o < NO; ++o)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = 2 * k + o % 2;
            float v;
            if constexpr (RMAX == 4) {
              if constexpr (QK_INT8) {
                const int x = iacc[0][e];
                v = static_cast<float>(x + __shfl_xor_sync(0xffffffff, x, 2));
              } else {
                v = sacc[0][e];
                v += __shfl_xor_sync(0xffffffff, v, 2);
              }
            } else {
              const int nt = o / 2;
              if constexpr (QK_INT8)
                v = static_cast<float>(iacc[nt][e] + iacc[nt + NT / 2][e]);
              else
                v = sacc[nt][e] + sacc[nt + NT / 2][e];
            }
            sv[o][k] = v;
          }
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const int r = own_row<RMAX>(o, t4);
          const float rs = qsc_s[min(r, R - 1)];  // q_scale, or 2^-e
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int c = tok0 + g4 + 8 * k;
            float s = sv[o][k];
            if constexpr (QK_INT8)
              s = s * rs * ksc[c];
            else if constexpr (SCALES)
              s = s * rs * ksc[c];
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            bool live = c < valid && r < R;
            if constexpr (BOUNDS) live = live && pos0 + c < bnd_s[r];
            sv[o][k] = live ? s : -INFINITY;
          }
        }

        // online softmax of the owned rows; pw holds p (1-byte caches:
        // p * v_scale / smax * 2^14, and U = smax * 2^-14 carries the rest)
        float pscale = 1.f, u_new = 1.f;
        if constexpr (SCALES) {
          const float smax =
              fmaxf(warp_max(vsc[tok0 + (lane & 15)], 1, 16), 1e-30f);
          pscale = 16384.f / smax;
          u_new = smax * (1.f / 16384.f);
        }
        float f[NO];  // what oacc's columns of each owned row are scaled by
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const int r = own_row<RMAX>(o, t4);
          const float mx = warp_max(fmaxf(sv[o][0], sv[o][1]), 4);
          const float m_new = fmaxf(m[o], mx);
          // a row may have no live token yet (BOUNDS, or past R):
          // exponentiate against 0, so that it keeps p = 0, alpha = 0 and
          // m = -inf
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = __expf(m[o] - m_use);
          const float p0 = __expf(sv[o][0] - m_use);
          const float p1 = __expf(sv[o][1] - m_use);
          l[o] = l[o] * alpha + (p0 + p1);
          m[o] = m_new;
          f[o] = alpha * (U / u_new);
          if (writer && r < R) {
            float w0 = p0, w1 = p1;
            if constexpr (SCALES) {
              w0 *= vsc[tok0 + g4] * pscale;
              w1 *= vsc[tok0 + g4 + 8] * pscale;
            }
            pw[r * CT + g4] = w0;
            pw[r * CT + g4 + 8] = w1;
          }
        }
        U = u_new;
        __syncwarp();

        // PV: oacc = oacc * f + V^T P^T
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int o0 = RMAX == 4 ? 0 : 2 * (nt % (NT / 2 > 0 ? NT / 2 : 1));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            oacc[mt][nt][0] *= f[o0];
            oacc[mt][nt][2] *= f[o0];
            oacc[mt][nt][1] *= f[o0 + 1];
            oacc[mt][nt][3] *= f[o0 + 1];
          }
        }
        uint32_t pb[NT][2];  // P^T's B fragments: tokens 4 t4 .. + 3
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int x = 8 * nt + g4, part = x / RMAX, row = x % RMAX;
          float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < R)
            pv = *reinterpret_cast<const float4*>(pw + row * CT + 4 * t4);
          pb[nt][0] = split_pair<BF>(pv.x, pv.y, part);
          pb[nt][1] = split_pair<BF>(pv.z, pv.w, part);
        }
        // a dead token's row may hold anything: its values are zero here
        bool vlive[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) vlive[k] = tok0 + 4 * t4 + k < valid;
        const unsigned char* vr = vst + (tok0 + 4 * t4) * RB + 4 * g4;
        if constexpr (BF) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {  // dims 16 mt + 2 g4, + 1
            uint32_t u[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              u[k] = vlive[k] ? *reinterpret_cast<const uint32_t*>(
                                    vr + k * RB + 32 * mt)
                              : 0u;
            const uint32_t a[4] = {__byte_perm(u[0], u[1], 0x5410),
                                   __byte_perm(u[0], u[1], 0x7632),
                                   __byte_perm(u[2], u[3], 0x5410),
                                   __byte_perm(u[2], u[3], 0x7632)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma16<true>(oacc[mt][nt], a, pb[nt][0], pb[nt][1]);
          }
        } else {
#pragma unroll
          for (int qd = 0; qd < D / 32; ++qd) {  // dims 32 qd + 4 g4 .. + 3
            uint32_t u[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              u[k] = vlive[k] ? *reinterpret_cast<const uint32_t*>(
                                    vr + k * RB + 32 * qd)
                              : 0u;
#pragma unroll
            for (int sb = 0; sb < 2; ++sb) {
              const uint32_t sel = sb ? 0x7362 : 0x5140;
              const uint32_t p01 = __byte_perm(u[0], u[1], sel);
              const uint32_t p23 = __byte_perm(u[2], u[3], sel);
              const uint32_t a[4] = {
                  half2_of<QT>(p01, 0), half2_of<QT>(p01, 1),
                  half2_of<QT>(p23, 0), half2_of<QT>(p23, 1)};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma16<false>(oacc[2 * qd + sb][nt], a, pb[nt][0], pb[nt][1]);
            }
          }
        }
      }
      __syncwarp();  // the stage and pw are read
      if (lane == 0) hop::mbar_arrive(&empty[st]);
    }

    // the end of the piece, with the thread's place made anew (opaque):
    // the block's warps' states meet in a fixed order (red_of: in the
    // stages, where every copy has landed, since every chunk was waited
    // for). oacc * U is O; the hi and lo columns add up.
    {
      const int t = opaque(threadIdx.x), warp = t / 32, lane = t % 32;
      const int g4 = lane >> 2, t4 = lane & 3, wl = warp % NCW;
      float* m_w =
          reinterpret_cast<float*>(smem + (warp / NCW) * S::PIPE + S::ML);
      float* l_w = m_w + NCW * RMAX;
      const bool writer = RMAX != 4 || t4 < 2;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = oacc[mt][nt][e] * U;
            if constexpr (RMAX == 4) v += __shfl_xor_sync(0xffffffff, v, 2);
            oacc[mt][nt][e] = v;
          }
      hop::bar_sync(CONSUMER_BAR, NCONS);
      float* red = red_of<D, RMAX, EB>(smem, warp);
      if (writer) {
#pragma unroll
        for (int nt = 0; nt < (RMAX == 4 ? 1 : NT / 2); ++nt)
#pragma unroll
          for (int cp = 0; cp < 2; ++cp) {
            const int row = (8 * nt + 2 * t4 + cp) % RMAX;
            if (row >= R) continue;
            float v[MT][2];  // m-tile, fragment row (g4 or g4 + 8)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float x = oacc[mt][nt][2 * hh + cp];
                if constexpr (RMAX != 4)
                  x += oacc[mt][nt + NT / 2][2 * hh + cp];
                v[mt][hh] = x;
              }
            float* rr = red + row * D;
            if constexpr (BF) {
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                *reinterpret_cast<float2*>(rr + 16 * mt + 2 * g4) =
                    make_float2(v[mt][0], v[mt][1]);
            } else {
#pragma unroll
              for (int qd = 0; qd < D / 32; ++qd)
                *reinterpret_cast<float4*>(rr + 32 * qd + 4 * g4) =
                    make_float4(v[2 * qd][0], v[2 * qd][1], v[2 * qd + 1][0],
                                v[2 * qd + 1][1]);
            }
          }
      }
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const float lsum = warp_sum(l[o], 4);
        const int r = own_row<RMAX>(o, t4);
        if (writer && g4 == 0 && r < R) {
          m_w[wl * RMAX + r] = m[o];
          l_w[wl * RMAX + r] = lsum;
        }
      }
      hop::bar_sync(CONSUMER_BAR, NCONS);
      // warp w's m and l: in pipeline w / NCW's part
      auto ml_of = [&](int w, int r, int which) {
        return reinterpret_cast<const float*>(smem + (w / NCW) * S::PIPE +
                                              S::ML)[(which * NCW + w % NCW) *
                                                         RMAX +
                                                     r];
      };
      // where the piece's result goes: a whole group's (out, lse), or its
      // partial in slot block (Dest), the group's in slots first / PS ..
      bool whole;
      long long gd, row0, first, part0;
      int np, PS = RG ? RMAX : R_group;  // the group's pieces, rows a partial
      {
        const Piece w = *piece_s;
        np = w.s;
        whole = np == 1;
        gd = static_cast<long long>(w.b) * GL + w.x;
        const int h = RG ? udiv(w.x, nrg) : w.x;
        row0 = (static_cast<long long>(w.b) * Hkv + h) * R_group +
               (RG ? (w.x - h * nrg) * RMAX : 0);
        part0 = static_cast<long long>(blockIdx.x) * PS;
        first = part0 - static_cast<long long>(w.k) * PS;
      }
      // each (row, warp)'s weight exp(m - the row's max) once, in pipeline
      // 0's p scratch [R][NW + 1] (the max last), then each (row, column)
      // of the result by a thread of its own, the warps in a fixed order
      float* wt_s = reinterpret_cast<float*>(smem + S::P);
      for (int i = t; i < R * NW; i += NCONS) {
        const int r = i / NW, w = i % NW;
        float mb = -INFINITY;
#pragma unroll
        for (int v = 0; v < NW; ++v) mb = fmaxf(mb, ml_of(v, r, 0));
        const float m_i = ml_of(w, r, 0);
        wt_s[r * (NW + 1) + w] = m_i > -INFINITY ? __expf(m_i - mb) : 0.f;
        if (w == 0) wt_s[r * (NW + 1) + NW] = mb;
      }
      hop::bar_sync(CONSUMER_BAR, NCONS);
      for (int i = t; i < R * D; i += NCONS) {
        const int r = i / D, c = i % D;
        const float* wr = wt_s + r * (NW + 1);
        float acc = 0.f, lb = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          acc += red_of<D, RMAX, EB>(smem, w)[r * D + c] * wr[w];
          lb += ml_of(w, r, 1) * wr[w];
        }
        const float mb = wr[NW];
        if (whole) {
          dst.out[(row0 + r) * D + c] = lb > 0.f ? acc / lb : 0.f;
          if (c == 0)
            dst.lse[row0 + r] = lb > 0.f ? mb + logf(lb) : RFA_NEG_INF;
        } else {
          dst.part_acc[(part0 + r) * D + c] = acc;
          if (c == 0) {
            dst.part_ml[(part0 + r) * 2] = mb;
            dst.part_ml[(part0 + r) * 2 + 1] = lb;
          }
        }
      }
      if (whole) return;
      // the group's last block to get here merges its pieces: one thread
      // releases the block's partial (the barrier orders the others' stores
      // before its fence) and, in the last block, acquires the others'
      // before the barrier after which the merge loads them
      hop::bar_sync(CONSUMER_BAR, NCONS);
      if (t == 0) {
        fence_acq_rel_gpu();
        *last_s = atomicAdd(dst.counters + gd, 1) == np - 1;
        fence_acq_rel_gpu();
      }
      hop::bar_sync(CONSUMER_BAR, NCONS);
      if (*last_s)
        merge_group<D, RMAX, EB>(dst, gd, row0, first, np, R, PS, smem,
                                 reinterpret_cast<float*>(smem + S::ML),
                                 reinterpret_cast<float*>(smem + S::P));
    }
  }
}

// The most pieces a group may have at R rows: the merge keeps one m per
// (piece, row) in pipeline 0's stages. A group has at most as many pieces
// as the launch has blocks, and no more than TARGET_BLOCKS (plan_piece).
template <int D, int RMAX, int EB>
__host__ __device__ constexpr bool merge_fits(int blocks, int R) {
  return (long long)(blocks < TARGET_BLOCKS ? blocks : TARGET_BLOCKS) * R *
             4 <=
         Smem<D, RMAX, EB>::KV_BYTES;
}

// A launch's grid gives every group a block (plan_piece): B * Hkv groups,
// times the row groups with RG.
template <int RMAX, bool RG>
__host__ __device__ constexpr bool grid_fits(int grid, int B, int Hkv,
                                             int R) {
  return grid >= (long long)B * Hkv * (RG ? (R + RMAX - 1) / RMAX : 1);
}

// Kv head h of a lane in a paged cache (B5, B6): its `len` tokens through
// the lane's block-table row, 64-token chunks that never span a page (cpp
// chunks per page, the last may be short).
struct PagedSrc {
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  const int* table;  // the lane's block-table row
  int h, Hkv, num_pages, page_size, cpp, len;

  __device__ __forceinline__ int count(int j) const {
    const int pg = j / cpp, off = (j % cpp) * C;
    return min(min(C, page_size - off), len - (pg * page_size + off));
  }

  __device__ __forceinline__ void locate(int j, long long& tok0,
                                         int& valid) const {
    const int pg = j / cpp, off = (j % cpp) * C;
    // out-of-range ids are clamped, as the plain version's gather does
    const int page = min(max(table[pg], 0), num_pages - 1);
    tok0 = ((long long)page * Hkv + h) * page_size + off;
    valid = count(j);
  }

  // chunk j's first position in the lane
  __device__ __forceinline__ int pos(int j) const {
    return (j / cpp) * page_size + (j % cpp) * C;
  }
};

// The lanes of a paged cache: lane b's length clamped to the pages its
// table row holds, and the live chunks that gives.
struct PagedLanes {
  static constexpr bool EQUAL = false;  // lanes of their own lengths
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  const int* block_tables;
  const int* seq_lens;
  int Hkv, num_pages, page_size, npages;

  __device__ __forceinline__ int cpp() const {
    return (page_size + C - 1) / C;
  }

  __device__ __forceinline__ int len(int b) const {
    return min(max(seq_lens[b], 0), npages * page_size);
  }

  __device__ __forceinline__ int chunks(int b) const {
    const int n = len(b);
    if (n <= 0) return 0;
    const int full = (n - 1) / page_size;  // pages before the last live
    return full * cpp() + (n - full * page_size + C - 1) / C;
  }

  __device__ __forceinline__ PagedSrc src(int b, int h) const {
    return PagedSrc{k,         v,   ks,        vs,
                    block_tables + (long long)b * npages,
                    h,         Hkv, num_pages, page_size,
                    cpp(),     len(b)};
  }
};

// The host side's choice of a build, which B4, B5 and B6 share. The build
// for R rows a kv head at head dim D: RMAX 4, 8 or 16 rows up to
// max_rows(D), else row groups (RG) of max_rows(D) rows. rp is the rows a
// piece's partial holds in the caller's workspace (R, or max_rows(D) with
// row groups: ops/quant_decode_cuda.py::row_groups); a build that would
// lay its partials out otherwise is refused, not launched past the
// workspace.
template <int QT, int D, class F>
int dispatch_rows(int R, int rp, const F& f) {
  constexpr int MR = max_rows(D);
  if (rp != (R > MR ? MR : R)) return cudaErrorInvalidValue;
  if (R > MR) return f.template run<QT, MR, D, true>();
  if (R <= 4) return f.template run<QT, 4, D, false>();
  if (R <= 8) return f.template run<QT, 8, D, false>();
  if constexpr (MR >= 16) return f.template run<QT, 16, D, false>();
  return cudaErrorInvalidValue;
}

template <int QT, class F>
int dispatch_dim(int head_dim, int R, int rp, const F& f) {
  if (head_dim == 64) return dispatch_rows<QT, 64>(R, rp, f);
  if (head_dim == 128) return dispatch_rows<QT, 128>(R, rp, f);
  if (head_dim == 256) return dispatch_rows<QT, 256>(R, rp, f);
  return cudaErrorInvalidValue;
}

// f.template run<QT, RMAX, D, RG>() (a launch) for cache type qtype, one
// of QTS, head dim 64, 128 or 256 and R rows a kv head, as above;
// cudaErrorInvalidValue where no build serves them.
template <int... QTS, class F>
int dispatch(int qtype, int head_dim, int R, int rp, const F& f) {
  int rc = cudaErrorInvalidValue;
  (void)((qtype == QTS &&
          (rc = dispatch_dim<QTS>(head_dim, R, rp, f), true)) ||
         ...);
  return rc;
}

}  // namespace rfa_qd
