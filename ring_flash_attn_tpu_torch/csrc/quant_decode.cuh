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
// rows: the loop above serves up to max_rows(D) of a group's R rows (16; 8
// at D = 256, where the PV accumulator of 16 rows would take 256 registers
// a lane); past it (RG) the row-tile loop (decode_tiles, below) serves a
// tile of up to 128 rows (64 at D = 256) on wgmma, each chunk read once
// for all of them.

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
// In the row-tile loop (RG) a group is a row tile, (batch, kv head) group *
// ceil(R / RT) + row tile, and its partials take PS = RT = row_tile(D)
// rows, the last row tile's too.
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
  int b, x, j0, n, k, s;  // in this order (decode_tiles reads them back)
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
// a block's first load). With CS > 1 the plan's units are clusters of CS
// blocks (the row-tile loop): cluster blockIdx.x / CS's piece, of the
// gridDim.x / CS clusters, TARGET of them cut, at a load of at least MINC
// chunks.
template <int CS = 1, int MINC = MIN_CHUNKS, int TARGET = TARGET_BLOCKS,
          class Lanes>
__device__ __forceinline__ Piece plan_piece(const Lanes& lanes, int B,
                                            int GL, int lane) {
  const Piece none{0, 0, 0, 0, 0, 1};
  const int grid = static_cast<int>(gridDim.x) / CS;
  if constexpr (Lanes::EQUAL) {
    // every lane holds n chunks (B4): each group takes s = ceil(n / L)
    // blocks, L the least from the same lower bound with G s <= U
    const int n = lanes.chunks(0), G = B * GL;
    if (n == 0) return none;
    const int U = max(G, min(grid, TARGET));
    const int most = udiv(U, G);  // blocks a group may take
    const int L = max(max(min(MINC, n), udiv(G * n + U - 1, U)),
                      udiv(n + most - 1, most));
    const int s = udiv(n + L - 1, L), p = blockIdx.x / CS;
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
  const int U = max(live, min(grid, TARGET));
  // the blocks that a load of L chunks a block takes
  auto blocks_at = [&](int L) {
    int v = 0;
    for (int c = 0; c < B; c += 32) v += udiv(chunks_at(c) + L - 1, L);
    return __reduce_add_sync(0xffffffff, v) * GL;
  };
  // the least L from lo that fits, found in (lo, hi]: hi fits, since a
  // group takes at most n / L + 1 blocks, and so does nmax (a block a
  // live group)
  int L = max(min(MINC, nmax), udiv(sum + U - 1, U));
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
  const int p = blockIdx.x / CS;
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
// q rows (b * Hkv + h) * R .. + R of the (rows, D) query, R <= RMAX.
// The block takes its piece (plan_piece): the consumers load its q, their
// pipelines take its chunks in turn, the warps' states meet, and the piece
// writes (out, lse) or its partial, the group's last block merging them.
template <int QT, bool QK_INT8, int D, int RMAX, bool BOUNDS = false,
          class Lanes>
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
  const int GL = Hkv;  // groups a lane: a group is a (lane, kv head) pair
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
    const auto src = lanes.src(pc.b, pc.x);
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
    // the piece: n chunks of this pipeline; the R rows of its group, q
    // and out rows from row0 = (b * Hkv + h) * R (the chunks' live tokens
    // and positions come with them: info)
    int n, R;
    {
      const Piece w = *piece_s;
      if (w.n == 0) return;
      n = max(0, (w.n - pipe + NP - 1) / NP);
      R = R_group;
      const long long row0 = (static_cast<long long>(w.b) * Hkv + w.x) * R;
      for (int i = t; i < R * D; i += NCONS) {
        const float x =
            q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[row0 * D + i])
                   : static_cast<const float*>(q)[row0 * D + i];
        qs[i] = x * scale;
      }
      if constexpr (BOUNDS) {
        if (t < R) bnd_s[t] = lanes.src(w.b, w.x).bound(t);
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
      int np, PS = R_group;  // the group's pieces, rows a partial
      {
        const Piece w = *piece_s;
        np = w.s;
        whole = np == 1;
        gd = static_cast<long long>(w.b) * GL + w.x;
        row0 = (static_cast<long long>(w.b) * Hkv + w.x) * R_group;
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

// ---------------------------------------------------------------------------
// The row-tile loop (RG): past max_rows(D) rows a kv head.

// A group of the plan is a (lane, kv head, row tile): a tile of RT =
// row_tile(D) of the head's R rows, so that a block reads each chunk once
// for all of them and a (lane, kv head) of up to RT rows is one group; the
// rows are the M of wgmma, those of a prefill tile (FlashInfer's GQA
// decode, arXiv 2501.01005). The blocks come in clusters of CS =
// TILE_CLUSTER, the plan's unit (plan_piece<CS>): a cluster takes a piece
// of a group and deals its chunks out to its blocks, the first ones a
// chunk more. A block is NC consumer warpgroups of 64 rows each (two, RT = 128,
// up to D = 128; one at 256, where O alone takes 128 fp32 a thread) and a
// producer warpgroup:
//  - its warp 0 copies a chunk's K and V rows into a ring of NRS raw
//    stages, a bulk copy a page for each (a chunk is 64 positions of the
//    lane, over C / page_size whole pages where smaller pages divide C:
//    TileLanes), and its lanes the 2 x 64 scales;
//  - its four warps turn a raw stage into a tile stage: K and V as 64
//    token rows in 128B-swizzled panels (hopper.cuh), fp16 for the 1-byte
//    caches (exact), B5's bf16 as it is, and with QK_INT8 K's int8 bytes as
//    they are (K-major, as an s8 wgmma takes them); rows past the chunk's
//    live tokens are zero, since 0 x a stale NaN is NaN;
//  - consumer warpgroup wg owns tile rows 64 wg .. + 63: S = Q K^T (M = 64
//    rows, N = 64 tokens, K = D; q in two 16-bit halves, two A tiles, or
//    with QK_INT8 as int8, s8 x s8 -> s32), k_scale on S's columns, the
//    online softmax of each row over its quad, v_scale into P, then O += P
//    V (P's two 16-bit halves from registers, V MN-major, N = D). A row is
//    one quad's, so the warpgroups never meet in the loop. A tile of up to
//    64 rows with two warpgroups (split) gives both the same rows and q
//    tiles and the chunks in turn; their states meet once, at the end;
//  - the merge is spread over the cluster (tile_merge): each block leaves
//    its rows' state in its shared memory, and after the cluster's barrier
//    block r of the cluster merges rows r * ceil(R / CS) .. of the CS
//    states, read from its peers' shared memory; a cluster that holds its
//    whole group writes those rows' (out, lse), otherwise their partial,
//    and the last block of the group's clusters to bring its rows (a
//    counter per group and rank) merges them, so the partials a block
//    reads are 1 / CS of a tile's rows. Merges run in a fixed order: the
//    result is bitwise reproducible.
// What rules it on the H100 at the engine's shapes is latency, not bytes
// (PERF.md): a block's dependent round trips to memory (the plan, q, the
// first chunk, the merge's), each ~1 us while the card streams the cache,
// and a merge that one SM would read alone.

template <int D>
__host__ __device__ constexpr int tile_wgs() {
  return D > 128 ? 1 : 2;
}

// the rows of a row tile at head dim D
__host__ __device__ constexpr int row_tile(int D) { return D > 128 ? 64 : 128; }

// blocks a cluster of the row-tile loop, the clusters its plan cuts a
// group over (the H100 SXM holds 30 clusters of 4 such blocks at once:
// cudaOccupancyMaxActiveClusters) and the fewest chunks worth a block of
// it beyond one a cluster (ops/quant_decode_cuda.py::TILE_CLUSTER,
// TILE_CLUSTERS, TILE_MIN_CHUNKS)
constexpr int TILE_CLUSTER = 4;
constexpr int TILE_CLUSTERS = 30;
constexpr int TILE_MIN_CHUNKS = 2;

// The row-tile loop's shared memory, offsets from a 1024-aligned base. A
// raw stage is what the copies bring (2 x 64 rows of D values); a tile
// stage its K and V panels (16-bit; an int8 K in the same room) and
// scales. NTS = 2 tile stages and NRS = 3 raw stages up to 16 KB of K+V
// raw, 2 at 32 KB; at D = 256 one tile stage and (bf16) one raw stage, in
// 227 KB beside the q tiles. After the loop the tile and raw stages hold
// the block's state for the cluster's merge: RT rows of DP floats (O) at
// KV, (m, l) at ML.
template <int D, int EB>
struct TileSmem {
  static constexpr int NC = tile_wgs<D>();
  static constexpr int RT = 64 * NC;
  static constexpr int PANEL = C * 128;     // 64 rows of 128 B
  static constexpr int TILE = C * D * 2;    // a K or V tile
  static constexpr int RAW = C * D * EB;    // a raw K or V chunk
  static constexpr int QT = 64 * D * 2;     // a warpgroup's q half
  static constexpr int NTS = D > 128 ? 1 : 2;
  static constexpr int NRS = D * EB <= 128 ? 3 : D * EB == 256 ? 2 : 1;
  static constexpr int DP = D + 4;          // a state row's floats
  static constexpr int Q = 0;                          // [NC][2][QT]
  static constexpr int KV = Q + NC * 2 * QT;           // [NTS][2][TILE]
  static constexpr int RAWS = KV + NTS * 2 * TILE;     // [NRS][2][RAW]
  static constexpr int RSC = RAWS + NRS * 2 * RAW;     // f32 [NRS][2][C]
  static constexpr int TSC = RSC + NRS * 2 * C * 4;    // f32 [NTS][2][C]
  static constexpr int TINFO = TSC + NTS * 2 * C * 4;  // s32x4 [NTS]
  static constexpr int RINFO = TINFO + NTS * 16;       // s32x2 [NRS]
  // u64 raw full [NRS], tile full, tile empty [NTS]
  static constexpr int BAR = RINFO + NRS * 8;
  static constexpr int QSC = BAR + 8 * (NRS + 2 * NTS);  // f32 [RT]
  static constexpr int ML = QSC + RT * 4;             // f32 [2][RT]
  static constexpr int PIECE = ML + 2 * RT * 4;       // Piece, last flag
  static constexpr int BYTES = PIECE + 32 + 1024;     // + the alignment
  static_assert(BYTES <= 227 * 1024, "one block an SM");
  static_assert(RT * DP * 4 <= RSC - KV, "the state fits the stages");
};

// tanh(x) to a few fp32 ulps, inline (tanhf is a call, whose spills and
// cold code cost more than the chunk's products): an odd polynomial (its
// Taylor series to x^15) below TANH_SMALL (tanh_small), 1 - 2 / (e^(2|x|)
// + 1) above
constexpr float TANH_SMALL = 0.55f;
__device__ __forceinline__ float tanh_small(float x) {
  const float y = x * x;
  float p = -1.4558344e-3f;
  p = fmaf(p, y, 3.5921280e-3f);
  p = fmaf(p, y, -8.8632355e-3f);
  p = fmaf(p, y, 2.1869488e-2f);
  p = fmaf(p, y, -5.3968254e-2f);
  p = fmaf(p, y, 1.3333333e-1f);
  p = fmaf(p, y, -3.3333334e-1f);
  return fmaf(x * y, p, x);
}
__device__ __forceinline__ float tanh_acc(float x) {
  const float a = fabsf(x);
  const float big = copysignf(fmaf(-2.f, __frcp_rn(expf(2.f * a) + 1.f), 1.f), x);
  return a < TANH_SMALL ? tanh_small(x) : big;
}

// split_pair's two halves of (a, b) at once, by packed conversions
template <bool BF>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  if constexpr (BF) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 f = __half22float2(h);
    const __half2 l = __floats2half2_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Byte column bc (a multiple of 16 for a whole chunk) of row r of a tile of
// 128B-swizzled panels: 128 bytes of a row a panel, 16-byte chunk c of row
// r at chunk c ^ (r % 8)
__device__ __forceinline__ unsigned char* tile_at(unsigned char* tile, int r,
                                                  int bc) {
  return tile + (bc >> 7) * (C * 128) + r * 128 +
         ((((bc >> 4) & 7) ^ (r & 7)) << 4) + (bc & 15);
}

// A raw chunk (C rows of D values, value_bytes<QT>() each, rows from
// `valid` on stale) as a tile: 16-bit panels (the 1-byte values converted
// to fp16, exactly; bf16 as it is), or with S8 the int8 bytes as they are;
// rows from `valid` on zero. NCVT threads, 16 raw bytes a step.
template <int QT, bool S8, int D, int NCVT>
__device__ __forceinline__ void to_tile(const unsigned char* raw,
                                        unsigned char* tile, int valid,
                                        int ct) {
  constexpr int EB = value_bytes<QT>();
  constexpr int UPR = D * EB / 16;  // 16-byte units a row
#pragma unroll 4
  for (int u = ct; u < C * UPR; u += NCVT) {
    const int r = u / UPR, cu = u % UPR;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      w = *reinterpret_cast<const uint4*>(raw + r * D * EB + 16 * cu);
    if constexpr (S8 || EB == 2) {
      *reinterpret_cast<uint4*>(tile_at(tile, r, 16 * cu)) = w;
    } else {
      *reinterpret_cast<uint4*>(tile_at(tile, r, 32 * cu)) =
          make_uint4(half2_of<QT>(w.x, 0), half2_of<QT>(w.x, 1),
                     half2_of<QT>(w.y, 0), half2_of<QT>(w.y, 1));
      *reinterpret_cast<uint4*>(tile_at(tile, r, 32 * cu + 16)) =
          make_uint4(half2_of<QT>(w.z, 0), half2_of<QT>(w.z, 1),
                     half2_of<QT>(w.w, 0), half2_of<QT>(w.w, 1));
    }
  }
}

// Pages a chunk of the row-tile loop: a paged cache whose pages hold fewer
// than C tokens and divide C (at least 2 tokens, so that a warp's lanes
// look a chunk's pages up at once) gives C / page_size; every other cache
// 1, its chunks those of the loop above.
__host__ __device__ constexpr int chunk_pages(int page_size) {
  return page_size >= 2 && page_size < C && C % page_size == 0
             ? C / page_size
             : 1;
}
template <class Lanes>
__device__ __forceinline__ int pages_a_chunk(const Lanes& lanes) {
  if constexpr (std::is_base_of_v<PagedLanes, Lanes>)
    return chunk_pages(lanes.page_size);
  else
    return 1;
}

// The lanes as the row-tile loop's plan counts them: with ppc > 1, lane b's
// ceil(len / C) chunks of C positions (ops/quant_decode_cuda.py::
// tile_chunks).
template <class Lanes>
struct TileLanes {
  static constexpr bool EQUAL = Lanes::EQUAL;
  const Lanes& lanes;
  int ppc;

  __device__ __forceinline__ int chunks(int b) const {
    if constexpr (std::is_base_of_v<PagedLanes, Lanes>)
      if (ppc > 1) return (lanes.len(b) + C - 1) / C;
    return lanes.chunks(b);
  }
};

// Page seg of the row-tile loop's chunk j of a source (ppc pages a chunk;
// with ppc = 1 seg 0 is the source's own chunk j): its first token index
// in the k/v arrays and its live tokens (cnt = 0: none, and no read of
// the table).
template <class Src>
__device__ __forceinline__ void tile_locate(const Src& src, int j, int seg,
                                            int ppc, long long& tok0,
                                            int& cnt) {
  if constexpr (std::is_base_of_v<PagedSrc, Src>) {
    if (ppc > 1) {
      const int pg = j * ppc + seg;
      cnt = min(max(src.len - pg * src.page_size, 0), src.page_size);
      if (cnt > 0) {
        // out-of-range ids are clamped, as the plain version's gather does
        const int page = min(max(src.table[pg], 0), src.num_pages - 1);
        tok0 = ((long long)page * src.Hkv + src.h) * src.page_size;
      }
      return;
    }
  }
  cnt = 0;
  if (seg == 0) src.locate(j, tok0, cnt);
}

// chunk j's first position in the lane (BOUNDS)
template <class Src>
__device__ __forceinline__ int tile_pos(const Src& src, int j, int ppc) {
  return ppc > 1 ? j * C : src.pos(j);
}

// Merge rows r .. r + nr - 1 of np partials, RT rows a slot from slot row
// `first` on, into (out, lse) rows row0 + r ..: a thread an item (row, 4
// columns), the partials in order, UNR of them loaded at once and weighed
// against the running maximum (a fixed order: bitwise reproducible).
template <int D, int RT>
__device__ __forceinline__ void merge_rows(const Dest& dst, long long first,
                                           long long row0, int np, int nr,
                                           int t, int nt) {
  constexpr int C4 = D / 4, UNR = 8;
  for (int x = t; x < nr * C4; x += nt) {
    const int r = x / C4, c4 = x - r * C4;
    float M = -INFINITY, L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < np; i0 += UNR) {
      float2 ml[UNR];
      float4 a[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        ml[u] = make_float2(-INFINITY, 0.f);
        a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i0 + u < np) {
          const long long row = first + (long long)(i0 + u) * RT + r;
          ml[u] = __ldcg(reinterpret_cast<const float2*>(dst.part_ml) + row);
          a[u] = __ldcg(reinterpret_cast<const float4*>(dst.part_acc +
                                                        row * D) + c4);
        }
      }
      float Mb = M;
#pragma unroll
      for (int u = 0; u < UNR; ++u) Mb = fmaxf(Mb, ml[u].x);
      // a partial, or a row, with no live token weighs nothing
      const float Mu = Mb == -INFINITY ? 0.f : Mb;
      const float f = M > -INFINITY ? __expf(M - Mu) : 0.f;
      acc = make_float4(acc.x * f, acc.y * f, acc.z * f, acc.w * f);
      L *= f;
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const float w = ml[u].x > -INFINITY ? __expf(ml[u].x - Mu) : 0.f;
        L += ml[u].y * w;
        acc.x += a[u].x * w;
        acc.y += a[u].y * w;
        acc.z += a[u].z * w;
        acc.w += a[u].w * w;
      }
      M = Mb;
    }
    const float il = L > 0.f ? 1.f / L : 0.f;
    const long long row = row0 + r;
    reinterpret_cast<float4*>(dst.out + row * D)[c4] =
        make_float4(acc.x * il, acc.y * il, acc.z * il, acc.w * il);
    if (c4 == 0) dst.lse[row] = L > 0.f ? M + logf(L) : RFA_NEG_INF;
  }
}

// The cluster's merge of a tile's R rows, by all NT threads of every block
// of the cluster, each block's state (O * U at st, RT rows of DP floats;
// m, l at ml) in its shared memory: block `rank` takes rows rank * RS ..
// (RS = ceil(R / CS)) of the CS states, in rank order, read from its
// peers' shared memory, then writes them as (out, lse) rows row0 + r with
// `whole`, else as its cluster's partial in slot `slot` (RT rows a slot),
// and the last block of the group's np clusters to bring its rows (counter
// `cnt`) merges theirs, in cluster order, from slot `first` on.
template <int D, int RT, int NT>
__device__ __forceinline__ void tile_merge(const Dest& dst, float* st,
                                           float* ml, int* last_s, int R,
                                           long long row0, bool whole,
                                           long long slot, long long first,
                                           int np, long long cnt) {
  constexpr int CS = TILE_CLUSTER, C4 = D / 4, DP = D + 4;
  const int t = threadIdx.x, rank = static_cast<int>(hop::cluster_rank());
  const int RS = (R + CS - 1) / CS, r0 = rank * RS;
  const int nr = max(min(RS, R - r0), 0);
  hop::cluster_arrive();  // the states are in place
  hop::cluster_wait();
  uint32_t pst[CS], pml[CS];
#pragma unroll
  for (int p = 0; p < CS; ++p) {
    pst[p] = hop::map_peer(rfa::smem_u32(st), p);
    pml[p] = hop::map_peer(rfa::smem_u32(ml), p);
  }
  for (int x = t; x < nr * C4; x += NT) {
    const int r = r0 + x / C4, c4 = x % C4;
    float m[CS], l[CS];
    float4 o[CS];
#pragma unroll
    for (int p = 0; p < CS; ++p) {
      m[p] = hop::ld_peer(pml[p] + 4 * r);
      l[p] = hop::ld_peer(pml[p] + 4 * (RT + r));
      o[p] = hop::ld_peer4(pst[p] + 4 * (r * DP + 4 * c4));
    }
    float M = -INFINITY;
#pragma unroll
    for (int p = 0; p < CS; ++p) M = fmaxf(M, m[p]);
    const float Mu = M == -INFINITY ? 0.f : M;
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < CS; ++p) {
      // a block with no live token of the row weighs nothing
      const float w = m[p] > -INFINITY ? __expf(m[p] - Mu) : 0.f;
      L += l[p] * w;
      acc.x += o[p].x * w;
      acc.y += o[p].y * w;
      acc.z += o[p].z * w;
      acc.w += o[p].w * w;
    }
    if (whole) {
      const float il = L > 0.f ? 1.f / L : 0.f;
      reinterpret_cast<float4*>(dst.out + (row0 + r) * D)[c4] =
          make_float4(acc.x * il, acc.y * il, acc.z * il, acc.w * il);
      if (c4 == 0) dst.lse[row0 + r] = L > 0.f ? M + logf(L) : RFA_NEG_INF;
    } else {
      const long long row = slot * RT + r;
      reinterpret_cast<float4*>(dst.part_acc + row * D)[c4] = acc;
      if (c4 == 0)
        reinterpret_cast<float2*>(dst.part_ml)[row] = make_float2(M, L);
    }
  }
  hop::cluster_arrive();  // the peers' states are read
  if (!whole) {
    // one thread releases the block's rows (the barrier orders the others'
    // stores before its fence) and, in the last block, acquires the
    // others' before the barrier after which the merge loads them
    __syncthreads();
    if (t == 0) {
      fence_acq_rel_gpu();
      *last_s = atomicAdd(dst.counters + cnt, 1) == np - 1;
      fence_acq_rel_gpu();
    }
    __syncthreads();
    if (*last_s) {
      merge_rows<D, RT>(dst, first * RT + r0, row0 + r0, np, nr, t, NT);
      if (t == 0) dst.counters[cnt] = 0;  // no other cluster is left
    }
  }
  hop::cluster_wait();  // no block leaves while a peer reads its state
}

// The launch's share of block blockIdx.x in the row-tile loop: Lanes and
// the arguments as decode_lanes takes them, R_group > max_rows(D); the
// grid in clusters of TILE_CLUSTER blocks.
template <int QT, bool QK_INT8, int D, bool BOUNDS, class Lanes>
__device__ __forceinline__ void decode_tiles(const Lanes& lanes, int B,
                                             int Hkv,
                                             const void* __restrict__ q,
                                             int q_bf16, int R_group,
                                             float scale, float softcap,
                                             const Dest& dst) {
  constexpr int EB = value_bytes<QT>();
  constexpr bool SCALES = QT != QT_BF16;
  constexpr bool BF = QT == QT_BF16;
  constexpr bool F16 = !BF;  // the 16-bit products' type
  constexpr int CS = TILE_CLUSTER;
  using S = TileSmem<D, EB>;
  constexpr int NC = S::NC, RT = S::RT, NRS = S::NRS, NTS = S::NTS;
  constexpr int PANEL = S::PANEL, RB = D * EB, DP = S::DP;
  constexpr int NCONS = 128 * NC, NCVT = 128;  // consumer, producer threads
  constexpr int PRODUCER_BAR = 4;  // named barrier of the producers
  const int nrt = (R_group + RT - 1) / RT;    // row tiles a kv head
  const int GL = Hkv * nrt;                   // groups a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (rfa::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* tile_full = raw_full + NRS;
  uint64_t* tile_empty = tile_full + NTS;
  float* rsc = reinterpret_cast<float*>(smem + S::RSC);
  float* tsc = reinterpret_cast<float*>(smem + S::TSC);
  int2* rinfo = reinterpret_cast<int2*>(smem + S::RINFO);
  int4* tinfo = reinterpret_cast<int4*>(smem + S::TINFO);
  Piece* piece_s = reinterpret_cast<Piece*>(smem + S::PIECE);
  int* last_s = reinterpret_cast<int*>(smem + S::PIECE + sizeof(Piece));
  static_assert(sizeof(Piece) + 4 <= 32, "the piece must fit");

  // warps 0 .. 4 NC - 1 consume; then the producer warpgroup: its warp 0
  // copies, all four convert
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int ppc = pages_a_chunk(lanes);
  if (warp == 1) {
    const Piece pc = plan_piece<CS, CS * TILE_MIN_CHUNKS, TILE_CLUSTERS>(
        TileLanes<Lanes>{lanes, ppc}, B, GL, lane);
    if (lane == 0) *piece_s = pc;
  }
  if (t == 0) {
    for (int s = 0; s < NRS; ++s)
      hop::mbar_init(&raw_full[s], 1 + (SCALES ? 32 : 0));
    for (int s = 0; s < NTS; ++s) {
      hop::mbar_init(&tile_full[s], NCVT);
      hop::mbar_init(&tile_empty[s], NCONS);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  // the cluster's piece, and the block's share of its chunks (the first
  // n % CS blocks of the cluster one more)
  const Piece pc = *piece_s;
  const int rank = static_cast<int>(hop::cluster_rank());
  const int nq = pc.n / CS, nrem = pc.n - nq * CS;
  const int j0 = pc.j0 + rank * nq + min(rank, nrem);
  const int n = nq + (rank < nrem);
  const int h = udiv(pc.x, nrt), r0 = (pc.x - h * nrt) * RT;

  // consumers: a lane with no live token gives out = 0, lse = NEG_INF on
  // all its rows, the lanes dealt out over the grid (after q's loads, in a
  // block with chunks)
  auto dead_lanes = [&]() {
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      if (lanes.chunks(b) == 0) {
        const long long rows = static_cast<long long>(Hkv) * R_group;
        float4* out4 = reinterpret_cast<float4*>(dst.out + b * rows * D);
        for (long long i = t; i < rows * D / 4; i += NCONS)
          out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (long long i = t; i < rows; i += NCONS)
          dst.lse[b * rows + i] = RFA_NEG_INF;
      }
  };
  if (pc.n == 0) {  // the cluster has no piece: none of its blocks has
    if (t < NCONS) dead_lanes();
    return;
  }
  const int R = min(RT, R_group - r0);
  const long long row0 = (static_cast<long long>(pc.b) * Hkv + h) * R_group +
                         r0;

  if (t >= NCONS) {  // the producer warpgroup
    // warp 0 copies chunk i into raw stage i % NRS (its lanes look up the
    // pages of 32 / ppc chunks at once, lane l holding page l % ppc of
    // chunk 32 (i / per) + l / ppc; lane l of the chunk's ppc copies its
    // page); the warpgroup converts chunk i, then, the raw stage read by
    // all (PRODUCER_BAR), warp 0 copies chunk i + NRS into it
    const int pt = t - NCONS, pw = pt / 32;
    const auto src = lanes.src(pc.b, h);
    const int per = 32 / ppc;  // chunks a look-up
    long long tok0_l = 0;
    int cnt_l = 0;
    auto copy = [&](int i) {
      const int st = i % NRS, ci = i % per, lo = ci * ppc;
      if (ci == 0) {
        cnt_l = 0;
        if (i + lane / ppc < n)
          tile_locate(src, j0 + i + lane / ppc, lane % ppc, ppc, tok0_l,
                      cnt_l);
      }
      int valid = 0;
      for (int g = 0; g < ppc; ++g)
        valid += __shfl_sync(0xffffffff, cnt_l, lo + g);
      unsigned char* kr = smem + S::RAWS + st * 2 * S::RAW;
      if (lane == 0) {
        int pos = 0;
        if constexpr (BOUNDS) pos = tile_pos(src, j0 + i, ppc);
        rinfo[st] = make_int2(valid, pos);
        hop::mbar_arrive_tx(&raw_full[st], 2 * valid * RB);
      }
      __syncwarp();
      const int seg = lane - lo;
      if (seg >= 0 && seg < ppc && cnt_l > 0) {
        const int at = seg * (ppc > 1 ? C / ppc : 0) * RB;
        hop::bulk_load(kr + at, src.k + tok0_l * RB, cnt_l * RB,
                       &raw_full[st]);
        hop::bulk_load(kr + S::RAW + at, src.v + tok0_l * RB, cnt_l * RB,
                       &raw_full[st]);
      }
      if constexpr (SCALES) {
#pragma unroll
        for (int c = lane; c < C; c += 32) {
          // token c lies in page c / (C / ppc) of the chunk
          const int cp = ppc > 1 ? c / (C / ppc) : 0;
          const long long tk =
              __shfl_sync(0xffffffff, tok0_l, lo + cp) + c - cp * (C / ppc);
          const bool ok = c < valid;
          const long long a = ok ? tk : 0;
          rfa::cp_async4(rsc + st * 2 * C + c, src.ks + a, ok ? 4 : 0);
          rfa::cp_async4(rsc + (st * 2 + 1) * C + c, src.vs + a, ok ? 4 : 0);
        }
        hop::cp_async_mbar_arrive(&raw_full[st]);
      }
    };
    if (pw == 0)
      for (int i = 0; i < min(n, NRS); ++i) copy(i);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int rs = i % NRS, ts = i % NTS;
      hop::mbar_wait(&raw_full[rs], (i / NRS) & 1);
      if (i >= NTS) hop::mbar_wait(&tile_empty[ts], ((i / NTS) + 1) & 1);
      const int2 inf = rinfo[rs];
      const unsigned char* kr = smem + S::RAWS + rs * 2 * S::RAW;
      unsigned char* kt = smem + S::KV + ts * 2 * S::TILE;
      to_tile<QT, QK_INT8, D, NCVT>(kr, kt, inf.x, pt);
      to_tile<QT, false, D, NCVT>(kr + S::RAW, kt + S::TILE, inf.x, pt);
      // the scales, and the chunk's v_scale maximum for the consumers
      float smax = 0.f;
      if constexpr (SCALES) {
        tsc[ts * 2 * C + pt] = rsc[rs * 2 * C + pt];
        if (pw == 1)
          smax = warp_max(fmaxf(rsc[(rs * 2 + 1) * C + lane],
                                rsc[(rs * 2 + 1) * C + 32 + lane]),
                          1);
      }
      if (pt == 32)
        tinfo[ts] = make_int4(inf.x, inf.y, __float_as_int(smax), 0);
      hop::fence_proxy_async();  // the tiles, for wgmma
      hop::mbar_arrive(&tile_full[ts]);
      hop::bar_sync(PRODUCER_BAR, NCVT);  // raw stage rs is read
      if (pw == 0 && i + NRS < n) copy(i + NRS);
    }
    if constexpr (SCALES) rfa::cp_async_wait_all();  // none outlives us
  } else {
    // warpgroup wg owns tile rows 64 wg .. + 63; lane 4 g + tq of its warp
    // w4 holds rows 16 w4 + g and + 8 of S, P and O (hopper.cuh). A tile
    // of up to 64 rows with two warpgroups (split) gives both the same
    // rows and the chunks in turn, and their states meet at the end
    const int wg = t / 128, w4 = warp % 4, g = lane >> 2, tq = lane & 3;
    const bool split = NC == 2 && R <= 64;
    const int rw0 = split ? 0 : 64 * wg;
    bool rlive[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      rlive[rr] = rw0 + 16 * w4 + g + 8 * rr < R;
    // O element 4 j + 2 rr + e: row 16 w4 + g + 8 rr, column 8 j + 2 tq
    // + e; O * U is the rows' unnormalised output (1-byte caches: p
    // carries v_scale / U)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, U = 1.f;
    if (n == 0) {
      dead_lanes();
    } else {
      // the warpgroup's q tiles, hi (or int8) and lo; with split both read
      // warpgroup 0's, each building half its rows
      unsigned char* qa = smem + S::Q + (split ? 0 : wg) * 2 * S::QT;
      float* qsc_s = reinterpret_cast<float*>(smem + S::QSC);
      // q * scale into the A tiles, a warp a row (rows qr0 + w4 + 4 k,
      // columns 64 e + 2 lane, + 1), QB rows' loads in flight at once:
      // two fp16 halves after a power-of-two prescale (max|q| * 2^e in
      // [2^14, 2^15), so that the lo half stays normal), bf16 halves for
      // B5, or with QK_INT8 int8 at max|q| / 127 (floor 1e-20, round half
      // to even); the row's scale in sc_s
      float* sc_s = qsc_s + (split ? 0 : 64 * wg);
      constexpr int QB = 1024 / D < 16 ? 1024 / D : 16;  // rows at once
      const int qr0 = split ? 32 * wg : 0, nk = split ? 8 : 16;
#pragma unroll 1
      for (int k0 = 0; k0 < nk; k0 += QB) {
        float2 x[QB][D / 64];
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int r = rw0 + qr0 + w4 + 4 * (k0 + u);
#pragma unroll
          for (int e = 0; e < D / 64; ++e) {
            float2 v = make_float2(0.f, 0.f);
            if (r < R && k0 + u < nk) {
              const long long at = (row0 + r) * D + 64 * e + 2 * lane;
              v = q_bf16 ? __bfloat1622float2(
                               *reinterpret_cast<const __nv_bfloat162*>(
                                   static_cast<const __nv_bfloat16*>(q) + at))
                         : *reinterpret_cast<const float2*>(
                               static_cast<const float*>(q) + at);
            }
            x[u][e] = make_float2(v.x * scale, v.y * scale);
          }
        }
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          if (k0 + u >= nk) break;
          const int rr = qr0 + w4 + 4 * (k0 + u);
          float amax = 0.f;
#pragma unroll
          for (int e = 0; e < D / 64; ++e)
            amax = fmaxf(amax, fmaxf(fabsf(x[u][e].x), fabsf(x[u][e].y)));
          amax = warp_max(amax, 1);
          float rs, pre;
          if constexpr (QK_INT8) {
            rs = fmaxf(amax / 127.f, 1e-20f);
            pre = 0.f;  // q / rs below, as the plain version divides
          } else {
            // amax = m 2^ex, m in [0.5, 1): pre = 2^(15 - ex), rs = 1 /
            // pre, both exact (ldexpf where the bits would leave the
            // normal range)
            const int be = (__float_as_int(amax) >> 23) & 0xff;
            const int ex = be - 126;
            if (BF || amax == 0.f) {
              rs = pre = 1.f;
            } else if (be > 15 && be < 255) {
              pre = __int_as_float((142 - ex) << 23);
              rs = __int_as_float((ex + 112) << 23);
            } else {
              int e2 = 0;
              frexpf(amax, &e2);
              pre = ldexpf(1.f, 15 - e2);
              rs = 1.f / pre;
            }
          }
#pragma unroll
          for (int e = 0; e < D / 64; ++e) {
            const int c = 64 * e + 2 * lane;
            if constexpr (QK_INT8) {
              const float a =
                  fminf(fmaxf(rintf(x[u][e].x / rs), -127.f), 127.f);
              const float b =
                  fminf(fmaxf(rintf(x[u][e].y / rs), -127.f), 127.f);
              *reinterpret_cast<uint16_t*>(tile_at(qa, rr, c)) =
                  static_cast<uint16_t>(
                      static_cast<uint8_t>(static_cast<int>(a)) |
                      (static_cast<uint8_t>(static_cast<int>(b)) << 8));
            } else {
              split2<BF>(x[u][e].x * pre, x[u][e].y * pre,
                         *reinterpret_cast<uint32_t*>(tile_at(qa, rr, 2 * c)),
                         *reinterpret_cast<uint32_t*>(
                             tile_at(qa + S::QT, rr, 2 * c)));
            }
          }
          if (lane == 0) sc_s[rr] = rs;
        }
      }
      hop::fence_proxy_async();  // the q tiles, for wgmma
      dead_lanes();
      // the lane's rows' bounds (BOUNDS; their q scales stay in sc_s, read
      // in the loop: at D = 256 a register spilled)
      int bnd[2] = {0, 0};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if constexpr (BOUNDS)
          if (rlive[rr])
            bnd[rr] = lanes.src(pc.b, h).bound(r0 + rw0 + 16 * w4 + g +
                                               8 * rr);
      if (split)
        hop::bar_sync(CONSUMER_BAR, NCONS);
      else
        hop::bar_sync(2 + wg, 128);
      const bool live_wg = rw0 < R;  // the warpgroup has a row of the tile

#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const int ts = i % NTS;
        hop::mbar_wait(&tile_full[ts], (i / NTS) & 1);
        if (live_wg && (!split || (i & 1) == wg)) {
          // live tokens, first position, max v_scale
          const int4 inf = tinfo[ts];
          const int valid = inf.x, pos0 = inf.y;
          unsigned char* kt = smem + S::KV + ts * 2 * S::TILE;
          unsigned char* vt = kt + S::TILE;
          const float* ksc = tsc + ts * 2 * C;
          const float* vsc = ksc + C;
          using Acc = std::conditional_t<QK_INT8, int, float>;
          Acc sa[32];
          hop::wgmma_fence();
          if constexpr (QK_INT8) {
#pragma unroll
            for (int kk = 0; kk < D / 32; ++kk) {
              const int at = (kk / 4) * PANEL + (kk % 4) * 32;
              hop::wgmma_ss_s8_n64(sa, hop::desc_sw128(qa + at, 16),
                                   hop::desc_sw128(kt + at, 16), kk > 0);
            }
          } else {
#pragma unroll
            for (int part = 0; part < 2; ++part)
#pragma unroll
              for (int kk = 0; kk < D / 16; ++kk) {
                const int at = (kk / 4) * PANEL + (kk % 4) * 32;
                hop::wgmma_ss_n64<0, 0, F16>(
                    sa, hop::desc_sw128(qa + part * S::QT + at, 16),
                    hop::desc_sw128(kt + at, 16), part + kk > 0);
              }
          }
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs(sa);

          // the online softmax of the lane's two rows over their quads; p
          // as P's A fragments (1-byte caches: p * v_scale / smax * 2^14,
          // and U = smax * 2^-14 carries the rest)
          float pscale = 1.f, u_new = 1.f;
          if constexpr (SCALES) {
            const float smax = fmaxf(__int_as_float(inf.z), 1e-30f);
            pscale = 16384.f / smax;
            u_new = smax * (1.f / 16384.f);
          }
          // S's columns times k_scale (and the row's q scale), then the
          // cap, under one branch
          float sv[32], f[2];
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            sv[x] = static_cast<float>(sa[x]);
            if constexpr (QK_INT8 || SCALES)
              sv[x] = sv[x] * sc_s[16 * w4 + g + 8 * ((x % 4) / 2)] *
                      ksc[8 * (x / 4) + 2 * tq + x % 2];
          }
          if (softcap > 0.f) {
            // the polynomial alone where no logit of the warp's reaches
            // past it (the same values: tanh_acc takes it there)
            const float inv = 1.f / softcap;
            float amax = 0.f;
#pragma unroll
            for (int x = 0; x < 32; ++x) amax = fmaxf(amax, fabsf(sv[x] * inv));
            if (__all_sync(0xffffffff, amax < TANH_SMALL)) {
#pragma unroll
              for (int x = 0; x < 32; ++x)
                sv[x] = softcap * tanh_small(sv[x] * inv);
            } else {
#pragma unroll
              for (int x = 0; x < 32; ++x)
                sv[x] = softcap * tanh_acc(sv[x] * inv);
            }
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = 4 * j + 2 * rr + e, c = 8 * j + 2 * tq + e;
                float s = sv[x];
                bool live = rlive[rr] && c < valid;
                if constexpr (BOUNDS) live = live && pos0 + c < bnd[rr];
                sv[x] = live ? s : -INFINITY;
                mx = fmaxf(mx, sv[x]);
              }
            mx = warp_max(mx, 1, 4);
            const float m_new = fmaxf(m[rr], mx);
            // a row may have no live token yet (BOUNDS, or past R):
            // exponentiate against 0, so that it keeps p = 0, alpha = 0
            // and m = -inf
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = __expf(m[rr] - m_use);
            float ls = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = 4 * j + 2 * rr + e;
                float p = __expf(sv[x] - m_use);
                ls += p;
                if constexpr (SCALES) p *= vsc[8 * j + 2 * tq + e] * pscale;
                sv[x] = p;
              }
            l[rr] = l[rr] * alpha + ls;
            m[rr] = m_new;
            f[rr] = alpha * (U / u_new);
          }
          U = u_new;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= f[0];
            o[4 * j + 1] *= f[0];
            o[4 * j + 2] *= f[1];
            o[4 * j + 3] *= f[1];
          }
          // P's A fragments, 16 tokens each (hopper.cuh::pack_fragments),
          // hi and lo halves
          uint32_t pa[2][4][4];
#pragma unroll
          for (int kc = 0; kc < 4; ++kc)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              split2<BF>(sv[8 * kc + 2 * r], sv[8 * kc + 2 * r + 1],
                         pa[0][kc][r], pa[1][kc][r]);
          hop::wgmma_fence();
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
              // V MN-major: its rows, the tokens, are the reduction, 16
              // tokens = 2048 B a step; lbo the step to the next 64
              // columns
              if constexpr (D == 256) {
#pragma unroll
                for (int half = 0; half < 2; ++half)
                  hop::wgmma_rs_n128<1, F16>(
                      *reinterpret_cast<float(*)[64]>(o + 64 * half),
                      pa[part][kc],
                      hop::desc_sw128(vt + 2 * half * PANEL + kc * 2048,
                                      PANEL),
                      1);
              } else if constexpr (D == 128) {
                hop::wgmma_rs_n128<1, F16>(
                    o, pa[part][kc], hop::desc_sw128(vt + kc * 2048, PANEL),
                    1);
              } else {
                hop::wgmma_rs_n64<1, F16>(
                    o, pa[part][kc], hop::desc_sw128(vt + kc * 2048, PANEL),
                    1);
              }
            }
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs(o);
        }
        hop::mbar_arrive(&tile_empty[ts]);
      }

      if (split) {
        // warpgroup 1's state, element by element as its lanes hold it,
        // into the raw stages (every copy has landed and been read), then
        // into warpgroup 0's: the same thread of each holds the same
        // elements
        static_assert(NC == 1 || (D / 2 + 4) * 128 * 4 <= NRS * 2 * S::RAW,
                      "the states must meet in the raw stages");
        float* xo = reinterpret_cast<float*>(smem + S::RAWS);
        const int wt = t % 128;
        if (wg == 1) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) xo[i * 128 + wt] = o[i] * U;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            xo[(D / 2 + rr) * 128 + wt] = m[rr];
            xo[(D / 2 + 2 + rr) * 128 + wt] = l[rr];
          }
        }
        hop::bar_sync(CONSUMER_BAR, NCONS);
        if (wg == 0) {
          float f0[2], f1[2];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float m1 = xo[(D / 2 + rr) * 128 + wt];
            const float M = fmaxf(m[rr], m1);
            const float m_use = M == -INFINITY ? 0.f : M;
            const float a0 = __expf(m[rr] - m_use), a1 = __expf(m1 - m_use);
            l[rr] = l[rr] * a0 + xo[(D / 2 + 2 + rr) * 128 + wt] * a1;
            m[rr] = M;
            f0[rr] = a0 * U;
            f1[rr] = a1;
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i)
            o[i] = o[i] * f0[(i % 4) / 2] + xo[i * 128 + wt] * f1[(i % 4) / 2];
          U = 1.f;
        }
      }
    }
    if (split && wg == 1) rlive[0] = rlive[1] = false;  // warpgroup 0's rows
    // the block's state for the cluster's merge: O * U over the tile and
    // raw stages (every warpgroup is past them), (m, l) at ML
    hop::bar_sync(CONSUMER_BAR, NCONS);
    float* st = reinterpret_cast<float*>(smem + S::KV);
    float* mls = reinterpret_cast<float*>(smem + S::ML);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffff, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffff, l[rr], 2);
      const int r = rw0 + 16 * w4 + g + 8 * rr;
      if (!rlive[rr]) continue;
      float* srow = st + r * DP + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(srow + 8 * j) = make_float2(
            o[4 * j + 2 * rr] * U, o[4 * j + 2 * rr + 1] * U);
      if (tq == 0) {
        mls[r] = m[rr];
        mls[RT + r] = l[rr];
      }
    }
  }

  // the tile's rows: a whole group's (out, lse), or the cluster's partial
  // in slot blockIdx.x / CS, the group's in slots from first on, the
  // group's counters one a rank. The piece is read again from shared
  // memory: nothing of it stays in a register across the loop (at D = 256
  // that spilled)
  const volatile int* pv = reinterpret_cast<const volatile int*>(piece_s);
  const int pb = pv[0], px = pv[1], pk = pv[4], ps = pv[5];
  const int ph = udiv(px, nrt), pr0 = (px - ph * nrt) * RT;
  const long long gd = static_cast<long long>(pb) * GL + px;
  const long long slot = blockIdx.x / CS;
  tile_merge<D, RT, 128 * (NC + 1)>(
      dst, reinterpret_cast<float*>(smem + S::KV),
      reinterpret_cast<float*>(smem + S::ML), last_s,
      min(RT, R_group - pr0),
      (static_cast<long long>(pb) * Hkv + ph) * R_group + pr0, ps == 1, slot,
      slot - pk, ps, gd * CS + static_cast<int>(hop::cluster_rank()));
}

// A launch's threads and shared memory: the loop above up to max_rows(D)
// rows, the row-tile loop past it (RG).
template <int D, int RMAX, int EB, bool RG>
__host__ __device__ constexpr int launch_threads() {
  if constexpr (RG)
    return 128 * (tile_wgs<D>() + 1);
  else
    return nthreads<D, RMAX, EB>();
}

template <int D, int RMAX, int EB, bool RG>
__host__ __device__ constexpr int launch_smem() {
  if constexpr (RG)
    return TileSmem<D, EB>::BYTES;
  else
    return Smem<D, RMAX, EB>::BYTES;
}

// Whether a grid of `grid` blocks serves a launch at R rows a kv head: a
// block a group at least (plan_piece), B * Hkv groups; with RG a cluster
// of TILE_CLUSTER blocks a group (B * Hkv times the row tiles) and whole
// clusters; and without RG the merge's m values, one per (piece, row), in
// pipeline 0's stages (a group has at most as many pieces as the launch
// has blocks, and no more than TARGET_BLOCKS; TileSmem holds its own).
template <int D, int RMAX, int EB, bool RG>
bool launch_fits(int grid, int B, int Hkv, int R) {
  if constexpr (RG)
    return grid % TILE_CLUSTER == 0 &&
           grid / TILE_CLUSTER >=
               (long long)B * Hkv * ((R + row_tile(D) - 1) / row_tile(D));
  else
    return grid >= (long long)B * Hkv &&
           (grid == 1 ||
            (long long)(grid < TARGET_BLOCKS ? grid : TARGET_BLOCKS) * R * 4 <=
                Smem<D, RMAX, EB>::KV_BYTES);
}

// Launch a build: kern<<<grid, threads, bytes, stream>>>(args...), the
// row-tile loop's (RG) in clusters of TILE_CLUSTER blocks. Returns
// cudaGetLastError() (or the launch's own error).
template <bool RG, class... P, class... A>
int launch_build(void (*kern)(P...), int grid, int threads, int bytes,
                 cudaStream_t stream, A... args) {
  if constexpr (RG) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = TILE_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
    if (e != cudaSuccess) return e;
  } else {
    kern<<<grid, threads, bytes, stream>>>(args...);
  }
  return cudaGetLastError();
}

// The host side's choice of a build, which B4, B5 and B6 share. The build
// for R rows a kv head at head dim D: RMAX 4, 8 or 16 rows up to
// max_rows(D), else the row-tile loop (RG) over tiles of row_tile(D) rows.
// rp is the rows a piece's partial holds in the caller's workspace (R, or
// row_tile(D) with RG: ops/quant_decode_cuda.py::row_groups); a build that
// would lay its partials out otherwise is refused, not launched past the
// workspace.
template <int QT, int D, class F>
int dispatch_rows(int R, int rp, const F& f) {
  constexpr int MR = max_rows(D);
  if (rp != (R > MR ? row_tile(D) : R)) return cudaErrorInvalidValue;
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
