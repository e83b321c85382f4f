// The flash-attention forward tile loop, shared by kernel B1
// (csrc/flash_fwd.cu: one call is one whole attention block) and kernel B7
// (csrc/fused_ring_fwd.cu: one call is one step of a ring, with the online
// softmax state carried in device memory from step to step).
//
// What bounds the loop on the H100: tensor-core operations (two bf16
// products of 2 * D flops per allowed (q, k) pair and head, far above the
// ridge of about 295 flop per byte), so the design is about keeping the
// tensor cores fed, after the FlashAttention-3 forward:
//
//  - One block per (batch, q head, 128-row q tile), launched tile-major
//    across heads ((batch, head) in blockIdx.x, the q tile in y, heaviest
//    causal tile first) so that every head's heavy tiles start first and
//    the causal grid ends without a long tail. Three warpgroups: two
//    consumers own 64 q rows each, the third is a producer (setmaxnreg: 240
//    registers a consumer thread, 24 a producer thread).
//  - Loads by TMA from one producer thread: the Q tile once, then 128-key
//    K and V tiles (at head_dim 256 80 keys, 64 in B1's builds with
//    segments, softcap/ALiBi or a band: kv_tile below) into a two-stage
//    ring, K and V each under mbarrier
//    full/empty pairs of their own (a stage's K is free once S is computed,
//    its V once P V is). 4-D tensor maps over the real strides,
//    128B-swizzled panels of 64 columns; rows past S read zero.
//  - Products by wgmma on each consumer warpgroup's 64 rows:
//      S  = Q K^T  (64 x 128 fp32, or 64 x 80 and 64 x 64 at head_dim
//                   256; both operands from shared memory, K-major over
//                   the head dim)
//      O += P V    (P packed to bf16 from the S accumulators as the A
//                   fragments; V read MN-major)
//    the online softmax runs in base 2 on the accumulators, scale * log2 e
//    applied to the fp32 logits; lse converts back to natural log at the
//    end. The kv loop stops at the causal bound of the tile's last row
//    (tiles past the diagonal are never loaded); the ragged edge and the
//    diagonal are masked, never assumed away. Out and lse go from the
//    registers to device memory, masked by row.
//  - Overlap: a warpgroup issues tile j's S and tile j - 1's P V together
//    and runs tile j's softmax while P V does; the two warpgroups take
//    turns to issue (named barriers), so one's softmax runs under the
//    other's products. Together they took up to 18% off the serial loop;
//    the overlap alone moved it by -4 to +7%, and the turns without the
//    overlap ran 12 to 25% behind both (NVIDIA H100, PERF.md).
//  - At head_dim 256, where a thread holds O's 128 fp32 and Q is read from
//    shared memory once for every kv tile: 80-key tiles (224 KB) spread a
//    tile's fixed cost (barriers, waits, the row max and sum) over 25%
//    more keys, and O is rescaled only when a row's max outgrows its
//    running one by 2^8 (LAZY below). O's rescale had been 0.13 ms of B7's
//    1.70 at Gemma-2-9B's 16/8 heads, the state's traffic 0.03 to 0.05,
//    the softmax's exponentials 0.045 (ablations, PERF.md).
//
// Measured (profile_torch_fwd.py, NVIDIA H100 80GB HBM3, 700 W, in turns
// with the loops before it) at q (1, 32, 8192, 128), kv (1, 8, 8192, 128)
// bf16: B1 causal 1.07 to 1.11 ms, about 500 TFLOP/s, 1.1 to 1.2x SDPA's
// forward (0.88 to 0.97), against 0.556 ms at the bf16 peak; B7
// off-diagonal 1.85 to 2.04 ms, diagonal 1.03 to 1.17 (SDPA's non-causal
// forward 1.61 to 1.73), against 1.112 ms. Every build takes head_dim 64,
// 128 and 256 (kv_tile below). At 256, device time in turns with the loop
// before this one: B7's off-diagonal step at q (1, 16, 8192, 256), kv (1,
// 8, 8192, 256) 1.512 to 1.513 ms (before: 1.734 to 1.740; SDPA's
// non-causal forward 1.466 to 1.522), with softcap 50 2.035 to 2.061
// (2.610 to 2.758); B1 causal at q, kv (1, 16, 8192, 256) 0.815 to 0.821
// (0.888 to 0.896; SDPA 0.898 to 0.956), against 0.556; B1 with softcap 50
// at the first shape 0.993 to 1.036 (1.116 to 1.239). B1 with the window
// (4096, 0) and the cap took 0.971 ms (chip_smoke.py phase 25).
//
// With RING the block applies softcap and ALiBi to the base-2 logits (XFORM),
// folds the state (m, l, acc) of the earlier steps into its own in the
// epilogue unless the step is the rank's first, and writes the state back
// instead of out and lse unless the step is the rank's last. The tile loop
// itself always starts from (-inf, 0, 0): the same arithmetic as starting
// from the loaded state, but measured 10% faster on the H100 in the first
// port of this loop (loaded values at the loop's entry cost the compiler
// its schedule). Without RING all of that compiles out and the kernel is
// B1's.
//
// With XFORM and without RING (B1 with softcap or ALiBi, csrc/xform.cuh) the
// block scales the logits to base 2 first and then applies the transform,
// as the TPU kernel does; ALiBi takes its distance from the index and the
// offsets, or (SEG) from the explicit positions: its rows' own, and a kv
// tile's first position and step where the tile's positions have one, else
// the masked body's shuffled ones.
//
// With SEG (B1 on packed sequences, csrc/segments.cuh) the block walks the
// kv tiles [q_meta[4], q_meta[5]] of its q tile, clamped by the index
// bound where the mask is causal by index or packed_self, skips the tiles
// whose segments or positions cannot meet it (producer and consumers alike)
// and masks by segment and position the tiles that straddle an edge.
//
// With BAND (B1 with a window or dropout, csrc/band.cuh; always with
// XFORM, without RING) the kv tiles narrow to the window's band where the
// positions are the index, and the tiles that cross a band edge are masked
// (with SEG and explicit positions the classes take the band); the dropped
// p leave the operand of P V after l has summed them, and the epilogue
// scales out by 1 / (1 - p).

#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "band.cuh"
#include "segments.cuh"
#include "xform.cuh"

namespace rfa_fwd {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // q rows per block, 64 per consumer warpgroup
// keys per tile of a build: 128; at head_dim 256, where Q (64 KB) and two
// stages of 128-key K and V tiles (256 KB) would pass the 227 KB of a block
// and the S tile's 64 fp32 beside O's 128 a consumer thread's 240
// registers, 80 (two stages of 80-key tiles: 224 KB; S 40 fp32 and P 20
// registers), or 64 in B1's builds with segments, a band or softcap/ALiBi:
// the first two lay their tile classes and band walk out for 64-key tiles,
// and at 80 keys B1's softcap loop spilled (24 to 56 bytes)
template <int D, bool RING, bool XFORM, bool SEG, int BAND>
constexpr int kv_tile =
    D <= 128 ? 128 : SEG || BAND || (XFORM && !RING) ? 64 : 80;
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int NTHREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int STAGES = 2;
// named barriers beside __syncthreads' 0: warpgroup wg's turn to issue its
// products is BAR_TURN + wg
constexpr int BAR_TURN = 1;
// how far, base 2, a LAZY build's running max may lag a row's true max
constexpr float MAX_SLACK = 8.f;

// 2^x by the special-function unit alone (exp2f adds a range fix-up for
// denormal results, which p in [0, 1] can spare: 2 to 7% of the loop)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What a ring step adds to a block call (B7). B1 with XFORM reads the
// transform's fields (slopes, cap2, q_pos0 - kv_pos0 the offset of
// positions by index, alibi_abs) and nothing else.
struct Ring {
  float* m;             // (B, Hq, Sq) running max, base 2; NEG_INF = no key yet
  float* l;             // (B, Hq, Sq) running sum
  float* acc;           // (B, Hq, Sq, D) unnormalised output
  const float* slopes;  // (Hq,) ALiBi slopes * log2(e), or null
  float cap2;           // softcap * log2(e); 0 = no capping
  int q_pos0, kv_pos0;  // global positions of q row 0 and of key 0
  int alibi_abs;        // ALiBi on |distance| (a ring without causal mask)
  int first;            // there is no earlier state: do not read it
  int last;             // normalise and write out, lse; do not write the state
};

// Byte offsets from a 1024-aligned base; bf16 tiles in 128B-swizzled panels
// of 64 columns by BM (Q) or BN (K, V) rows.
template <int D, int BN>
struct Smem {
  static constexpr int PANEL = BM * 128;  // a panel of Q: BM rows of 64 bf16
  static constexpr int PANEL_KV = BN * 128;  // of a K or V tile
  static constexpr int TILE = BN * D * 2;    // a K or V tile
  static constexpr int Q = 0;
  static constexpr int KV = Q + BM * D * 2;  // stage s: K at KV + 2 s TILE,
                                             // then V
  static constexpr int BAR = KV + STAGES * 2 * TILE;
  // mbarriers: q, full_k[STAGES], full_v[STAGES], empty_k[STAGES],
  // empty_v[STAGES]
  static constexpr int BYTES = BAR + (1 + 4 * STAGES) * 8 + 1024;
};

// TMA maps of q, k and v, boxes of 64 columns by 128 rows.
struct Maps {
  CUtensorMap q, k, v;
};

// XFORM: the ring step, or B1's call, has softcap or ALiBi. Compiled apart
// so that the common step keeps B1's straight-line tile body: with one
// kernel and a uniform run-time branch around the transform, the headline
// off-diagonal step of the first port of this loop took 5.3 ms on the H100
// where the split took 5.0.
template <int D, bool RING, bool XFORM = false, bool SEG = false,
          int BAND = 0>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps, void* __restrict__ out,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 float scale_log2, int causal, int offset, int out_bf16,
                 Ring ring, const __grid_constant__ rfa_seg_args seg,
                 const rfa_band_args band) {
  static_assert(!(SEG && RING), "a ring step takes no segments");
  static_assert(!BAND || (XFORM && !RING), "BAND comes with XFORM, no ring");
  constexpr int BN = kv_tile<D, RING, XFORM, SEG, BAND>;
  using S = Smem<D, BN>;
  constexpr int NO = D / 2;  // fp32 of a 64 x D accumulator a thread holds
  constexpr int NS = BN / 2;  // fp32 of the 64 x BN S tile a thread holds
  // LAZY (head_dim 256 without segments or a band, where O is 128 fp32 a
  // thread): a row's p are taken against a running max that may lag its
  // true max by up to MAX_SLACK (base 2: p < 2^8, as exact in bf16 as below
  // 1), so that O is rescaled only when some row of the warp outgrows that,
  // a few tiles a row, and not whenever a max moves (FlashAttention-4's
  // conditional rescaling). The same softmax: out and lse move by rounding
  // alone.
  constexpr bool LAZY = D == 256 && !SEG && !BAND;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem =
      smem_raw + ((1024 - (rfa::smem_u32(smem_raw) & 1023)) & 1023);

  // blocks launch in the order of blockIdx.x, then y: every (batch, q
  // head) of a q tile before the next tile, heaviest causal tile first
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;

  // kv tiles [0, n_tiles): up to the causal bound of this q tile's last row
  int n_end = Skv;
  if (causal) n_end = min(Skv, max(0, m0 + BM + offset));
  if constexpr (SEG) {
    if (seg.tri) n_end = min(Skv, m0 + BM);
  }
  int n_tiles = (n_end + BN - 1) / BN;
  // BAND with positions by index: the window's kv tiles [k_lo, k_hi) (the
  // offset of positions is ring.q_pos0, B1's XFORM field); without SEG the
  // walk counts n_tiles from k_lo
  int k_lo = 0;
  if constexpr (BAND) {
    if (!(SEG && seg.q_pos)) {
      int k_hi;
      rfa_band::index_tiles(band, m0, BM, ring.q_pos0, BN, n_tiles, true,
                            k_lo, k_hi);
      n_tiles = SEG ? k_hi : max(0, k_hi - k_lo);
    }
  }

  // SEG: the classes of the kv tiles [t_lo, t_hi] against this q tile, in
  // shared memory past the barriers; the walk visits the live ones in
  // order and n_tiles counts them
  uint32_t* seg_bits = reinterpret_cast<uint32_t*>(smem + S::BYTES - 1024);
  int t_lo = 0, t_hi = 0;
  auto tile_class = [&](int t) {
    return rfa_seg::class_of(seg_bits, t - t_lo);
  };
  auto next_live = [&](int t) {
    while (t <= t_hi && tile_class(t) == 0) ++t;
    return t;
  };

  char* qs = smem + S::Q;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  auto ks = [&](int s) { return smem + S::KV + s * 2 * S::TILE; };
  auto vs = [&](int s) { return ks(s) + S::TILE; };

  if (threadIdx.x == 0) {
    hop::mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full_k[s], 1);
      hop::mbar_init(&full_v[s], 1);
      hop::mbar_init(&empty_k[s], CONSUMERS);
      hop::mbar_init(&empty_v[s], CONSUMERS);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  if constexpr (SEG) {
    const int qt = m0 / BM;
    t_lo = rfa_seg::range_lo(seg.q_meta, seg.n_q, qt);
    if constexpr (BAND) t_lo = max(t_lo, k_lo);
    t_hi = min(n_tiles - 1, rfa_seg::range_hi(seg.q_meta, seg.n_q, qt));
    if constexpr (BAND) {
      n_tiles = rfa_band::fill_classes<NTHREADS>(
          seg_bits, rfa_seg::tile(seg.q_meta, seg.n_q, qt), seg.kv_meta,
          seg.n_kv, t_lo, t_hi, seg.pos_causal != 0, seg.q_pos != nullptr,
          true, band);
    } else {
      n_tiles = rfa_seg::fill_classes<NTHREADS>(
          seg_bits, rfa_seg::tile(seg.q_meta, seg.n_q, qt), seg.kv_meta,
          seg.n_kv, t_lo, t_hi, rfa_seg::skip_on_positions<XFORM>(seg),
          true);
    }
    if constexpr (XFORM) {
      // BAND: dropout on explicit positions hashes each key's, which an
      // unmasked tile gives by its first position and step too
      if (seg.q_pos &&
          (ring.slopes || (BAND == rfa_band::ALL && band.thr)))
        rfa_seg::keep_affine<NTHREADS>(seg_bits, seg.kv_step + t_lo,
                                       t_hi - t_lo + 1);
    }
  }

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the tiles in flight by TMA; a block
    // with no kv tile loads nothing ----
    hop::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
      hop::mbar_arrive_tx(q_bar, BM * D * 2);
      for (int p = 0; p < D / 64; ++p)
        hop::tma_load_4d(qs + p * S::PANEL, &maps.q, q_bar, 64 * p, m0, h, b);
      int t = 0;
      if constexpr (SEG) t = next_live(t_lo);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        const int kt = SEG ? t : k_lo + j;
        hop::mbar_wait(&empty_k[s], parity);
        hop::mbar_arrive_tx(&full_k[s], BN * D * 2);
        for (int p = 0; p < D / 64; ++p)
          hop::tma_load_4d(ks(s) + p * S::PANEL_KV, &maps.k, &full_k[s],
                           64 * p, kt * BN, hk, b);
        hop::mbar_wait(&empty_v[s], parity);
        hop::mbar_arrive_tx(&full_v[s], BN * D * 2);
        for (int p = 0; p < D / 64; ++p)
          hop::tma_load_4d(vs(s) + p * S::PANEL_KV, &maps.v, &full_v[s],
                           64 * p, kt * BN, hk, b);
        if constexpr (SEG) t = next_live(t + 1);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows mw + [0, 64) ----
  hop::setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int mw = m0 + 64 * wg;
  // accumulator element i of S (64 rows x BN keys) or O (64 rows x D) is
  // row r_lo + 8 ((i % 4) / 2) and column 8 (i / 4) + 2 tq + i % 2
  const int r_lo = mw + 16 * warp + g;
  const char* qa = qs + wg * 64 * 128;  // this warpgroup's rows of a panel

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // SEG: segment ids and positions of this thread's rows r_lo, r_lo + 8
  int qseg[2] = {0, 0}, qpos[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      if (row < Sq) {
        if (seg.q_seg) qseg[r] = __ldg(seg.q_seg + row);
        if (seg.q_pos) qpos[r] = __ldg(seg.q_pos + row);
      }
    }
  }

  float slope = 0.f, inv_cap2 = 0.f;
  if constexpr (XFORM) {
    if (ring.slopes) slope = ring.slopes[h];
    if (ring.cap2 > 0.f) inv_cap2 = 1.f / ring.cap2;
  }

  // BAND with dropout: the hashes of this thread's rows r_lo, r_lo + 8
  uint32_t rh[2] = {0u, 0u};
  if constexpr (BAND == rfa_band::ALL) {
    if (band.thr) {
      const uint32_t base = rfa_band::head_base(band, h, b);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t qp = SEG && seg.q_pos
                                ? (uint32_t)qpos[r]
                                : band.q_pos0 + (uint32_t)(r_lo + 8 * r);
        rh[r] = rfa_band::row_hash(base, qp, (uint32_t)qseg[r]);
      }
    }
  }

  // LAZY: whether this warp's last softmax moved its rows' maxes
  bool rescale = true;

  // XFORM, SEG with ALiBi on positions: an unmasked kv tile's first key
  // position and step (its keys sit at kp0 + ksk (col - n0))
  int kp0 = 0, ksk = 0;

  // issue S = Q K^T of stage s: 64 q rows x BN keys
  auto scores = [&](float (&sc)[NS], int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ko = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel
      if constexpr (BN == 128)
        hop::wgmma_ss_n128<0, 0>(
            sc, hop::desc_sw128(qa + (kk / 4) * S::PANEL + ko, 16),
            hop::desc_sw128(ks(s) + (kk / 4) * S::PANEL_KV + ko, 16), kk > 0);
      else if constexpr (BN == 80)
        hop::wgmma_ss_n80<0, 0>(
            sc, hop::desc_sw128(qa + (kk / 4) * S::PANEL + ko, 16),
            hop::desc_sw128(ks(s) + (kk / 4) * S::PANEL_KV + ko, 16), kk > 0);
      else
        hop::wgmma_ss_n64<0, 0>(
            sc, hop::desc_sw128(qa + (kk / 4) * S::PANEL + ko, 16),
            hop::desc_sw128(ks(s) + (kk / 4) * S::PANEL_KV + ko, 16), kk > 0);
    }
    hop::wgmma_commit();
  };

  // issue O += P V of stage s: P as bf16 A fragments, V MN-major (its
  // rows, the keys, are the reduction), stepping 16 keys = 2048 B; at
  // head_dim 256 as two products of 128 columns, O's two halves
  auto accumulate = [&](const uint32_t (&pa)[BN / 16][4], int s) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint64_t db = hop::desc_sw128(vs(s) + kc * 2048, S::PANEL_KV);
      if constexpr (D == 256) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          hop::wgmma_rs_n128<1>(
              *reinterpret_cast<float(*)[64]>(o + 64 * half), pa[kc],
              hop::desc_sw128(vs(s) + 2 * half * S::PANEL_KV + kc * 2048,
                              S::PANEL_KV),
              1);
      } else if constexpr (D == 128) {
        hop::wgmma_rs_n128<1>(o, pa[kc], db, 1);
      } else {
        hop::wgmma_rs_n64<1>(o, pa[kc], db, 1);
      }
    }
    hop::wgmma_commit();
  };

  // the softmax of the S tile of keys n0 + [0, BN) in place: P = exp2(S -
  // m) in sc, (m, l) updated, alpha the factor O still has to take;
  // seg_masked: the tile straddles a segment edge or the positions'
  // diagonal (SEG); lo and hi the lane's keys n0 + 2 lane + {0, 1} and
  // n0 + 64 + 2 lane + {0, 1} (the latter at BN = 128 only)
  auto softmax = [&](float (&sc)[NS], int n0, float (&alpha)[2],
                     bool seg_masked, const rfa_seg::Pair& lo,
                     const rfa_seg::Pair& hi) {
    // the transform, each step a loop of its own under one uniform
    // branch: the cap (B1 scales first, the mask below then scales by 1; a
    // ring step's q arrives pre-scaled to base 2), then ALiBi by index (on
    // global positions in a ring step), or on an unmasked tile's explicit
    // positions (its keys' have a step; on a masked tile ALiBi is the
    // masked body's). One loop with the branches inside ran B1 with
    // softcap 1.3x slower causal, 1.5x on the five-sequence packing (phase
    // 17), and B7 with softcap 50 at head_dim 256 1.24x slower with CUDA's
    // tanhf (profile_torch_fwd.py; NVIDIA H100 80GB HBM3, 700 W).
    if constexpr (XFORM) {
      if (ring.cap2 > 0.f) {
        const float k2 = RING ? inv_cap2 : scale_log2 * inv_cap2;
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = ring.cap2 * tanh_fast(sc[i] * k2);
      } else if constexpr (!RING) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
      }
      if (ring.slopes && !(SEG && seg.q_pos)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int row = r_lo + 8 * ((i % 4) / 2);
          const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
          float dist = (float)((ring.q_pos0 + row) -
                               (RING ? ring.kv_pos0 + col : col));
          if (ring.alibi_abs) dist = fabsf(dist);
          sc[i] -= slope * dist;
        }
      } else if (SEG && ring.slopes && !seg_masked) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = 8 * (i / 4) + 2 * tq + i % 2;
          float dist = (float)(qpos[(i % 4) / 2] - (kp0 + ksk * col));
          if (ring.alibi_abs) dist = fabsf(dist);
          sc[i] -= slope * dist;
        }
      }
    }

    // BAND: the keep bits of the tile's 64 elements (dropout)
    uint32_t kbits[2] = {~0u, ~0u};
    if constexpr (BAND) {
      // the window, on the explicit positions in the masked body, else on
      // the index; then dropout's keep bits
      const bool idx_pos = !(SEG && seg.q_pos);
      const bool drop = BAND == rfa_band::ALL && band.thr != 0;
      auto kill = [&](int i) { kbits[i >> 5] &= ~(1u << (i & 31)); };
      if (SEG && seg_masked) {
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int ks, kp;
            rfa_seg::take(c < 8 ? lo : hi, 4 * (c % 8) + tq, e, ks, kp);
            const int col = n0 + 8 * c + 2 * tq + e;
            const uint32_t kh =
                (idx_pos ? band.kv_pos0 + (uint32_t)col : (uint32_t)kp) *
                rfa_band::H_K;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * c + 2 * r + e;
              const int row = r_lo + 8 * r;
              const int d = idx_pos ? row - col + ring.q_pos0
                                    : rfa_band::diff(qpos[r], kp);
              const bool out_ = col >= Skv ||
                                (causal && row + offset < col) ||
                                rfa_seg::drop<true>(seg, qseg[r], qpos[r], ks,
                                                    kp) ||
                                rfa_band::outside(band, d);
              float x = sc[i];
              if (ring.slopes && seg.q_pos) {
                float dist = (float)(qpos[r] - kp);
                if (ring.alibi_abs) dist = fabsf(dist);
                x -= slope * dist;
              }
              sc[i] = out_ ? -INFINITY : x;
              if (drop && !rfa_band::keep(rh[r], kh, band.thr)) kill(i);
            }
          }
        }
      } else {
        // a tile crosses a band edge by index where some pair of this
        // warpgroup's rows lies outside it
        const long long d_hi = (long long)mw + 63 - n0 + ring.q_pos0;
        const long long d_lo = (long long)mw - (n0 + BN - 1) + ring.q_pos0;
        const bool win = idx_pos && (d_hi > band.wl || d_lo < -band.wr);
        const bool edge = n0 + BN > Skv ||
                          (causal && n0 + BN - 1 > mw + offset) || win;
        if (edge) {
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int row = r_lo + 8 * ((i % 4) / 2);
            const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
            if (col >= Skv || (causal && row + offset < col) ||
                (win && rfa_band::outside(band, row - col + ring.q_pos0)))
              sc[i] = -INFINITY;
          }
        }
        if (drop) {
          // the keys' positions: the index plus kv_pos0, or an unmasked
          // tile's first position and step
          const uint32_t kb = idx_pos ? band.kv_pos0 + (uint32_t)n0
                                      : (uint32_t)kp0;
          const uint32_t kst = idx_pos ? 1u : (uint32_t)ksk;
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const uint32_t cl = 8 * (i / 4) + 2 * tq + i % 2;
            if (!rfa_band::keep(rh[(i % 4) / 2],
                                (kb + kst * cl) * rfa_band::H_K, band.thr))
              kill(i);
          }
        }
      }
    } else {
    // scale to base-2 logits; mask the ragged edge and the causal diagonal
    const bool edge = n0 + BN > Skv || (causal && n0 + BN - 1 > mw + offset);
    if (SEG && seg_masked) {
      // a loop of its own, so that the unmasked tiles' code carries none
      // of it: element 4 c + 2 r + e is key 8 c + 2 tq + e, held by lane
      // 4 (c % 8) + tq of lo (c < 8) or hi
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int ks, kp;
          rfa_seg::take(c < 8 ? lo : hi, 4 * (c % 8) + tq, e, ks, kp);
          const int col = n0 + 8 * c + 2 * tq + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * c + 2 * r + e;
            const bool out_ = col >= Skv ||
                              (causal && r_lo + 8 * r + offset < col) ||
                              rfa_seg::drop<XFORM>(seg, qseg[r], qpos[r], ks,
                                                   kp);
            if constexpr (XFORM) {
              // scaled and capped above; ALiBi on the explicit positions
              float x = sc[i];
              if (ring.slopes && seg.q_pos) {
                float dist = (float)(qpos[r] - kp);
                if (ring.alibi_abs) dist = fabsf(dist);
                x -= slope * dist;
              }
              sc[i] = out_ ? -INFINITY : x;
            } else {
              sc[i] = out_ ? -INFINITY : sc[i] * scale_log2;
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = sc[i] * (XFORM ? 1.f : scale_log2);
        if (edge) {
          const int row = r_lo + 8 * ((i % 4) / 2);
          const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
          if (col >= Skv || (causal && row + offset < col)) x = -INFINITY;
        }
        sc[i] = x;
      }
    }
    }

    // row r's p against its new max m_new (a row with no live key yet
    // keeps m = -inf; it exponentiates against 0)
    auto exponentiate = [&](int r, float m_new) {
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        sc[4 * i + 2 * r] = ex2(sc[4 * i + 2 * r] - m_use);
        sc[4 * i + 2 * r + 1] = ex2(sc[4 * i + 2 * r + 1] - m_use);
        rs += sc[4 * i + 2 * r] + sc[4 * i + 2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha[r] + rs;  // per-thread partial
      m_run[r] = m_new;
    };
    // rows r_lo (r = 0) and r_lo + 8 (r = 1); the four threads of a quad
    // hold a row's BN columns
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      m_new[r] = fmaxf(m_run[r], mx);
      if constexpr (!LAZY) exponentiate(r, m_new[r]);
    }
    if constexpr (LAZY) {
      // the warp keeps its rows' maxes unless one grew past its own by
      // more than MAX_SLACK; O then keeps its scale (alpha is 1, or 0 on a
      // row that has seen no key and holds zeros)
      rescale = __any_sync(0xffffffff, m_new[0] > m_run[0] + MAX_SLACK ||
                                           m_new[1] > m_run[1] + MAX_SLACK);
      if (!rescale) {
        m_new[0] = m_run[0];
        m_new[1] = m_run[1];
      }
      exponentiate(0, m_new[0]);
      exponentiate(1, m_new[1]);
    }
    // BAND: l has summed every p; the dropped ones leave P V's operand
    if constexpr (BAND == rfa_band::ALL) {
      if (band.thr) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (!((kbits[i >> 5] >> (i & 31)) & 1u)) sc[i] = 0.f;
      }
    }
  };

  // the two warpgroups take turns to issue their products (named barriers
  // BAR_TURN + wg, warpgroup 0 first), so that one's softmax runs under
  // the other's products; warpgroup 1 gives no turn after its last issue,
  // which leaves both barriers balanced
  int turns = n_tiles + 1;  // issues of this warpgroup
  auto my_turn = [&]() { hop::bar_sync(BAR_TURN + wg, CONSUMERS); };
  auto next_turn = [&]() {
    if (--turns > 0 || wg == 0)
      hop::bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
  };

  // the loop, one tile behind itself: the products of tile j (S) and j - 1
  // (P V) are issued together and tile j's softmax runs while P V does;
  // O takes tile j's alpha once P V of j - 1 has landed
  if (n_tiles > 0) {
    float sc[NS], alpha[2];
    uint32_t pa[BN / 16][4];
    // SEG: the live kv tile t of pipeline step j, whether it is masked,
    // and then the lane's share of its keys' segment ids and positions
    int t = k_lo;
    if constexpr (SEG) t = next_live(t_lo);
    auto masked = [&](int tt) { return SEG && tile_class(tt) == 1; };
    rfa_seg::Pair lo{}, hi{};
    auto share = [&](int tt) {
      if (SEG && masked(tt)) {
        lo = rfa_seg::load_pair(seg.kv_seg, seg.kv_pos, tt * BN + 2 * lane,
                                Skv);
        if constexpr (BN == 128)
          hi = rfa_seg::load_pair(seg.kv_seg, seg.kv_pos,
                                  tt * BN + 64 + 2 * lane, Skv);
      }
      if constexpr (XFORM && SEG) {
        if (!masked(tt) && seg.q_pos &&
            (ring.slopes ||
             (BAND == rfa_band::ALL && band.thr))) {
          kp0 = __ldg(seg.kv_pos + tt * BN);
          ksk = __ldg(seg.kv_step + tt);
        }
      }
    };
    if (wg == 1) hop::bar_arrive(BAR_TURN, CONSUMERS);
    hop::mbar_wait(q_bar, 0);
    hop::mbar_wait(&full_k[0], 0);
    my_turn();
    hop::wgmma_fence();
    scores(sc, 0);
    next_turn();
    share(t);
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::mbar_arrive(&empty_k[0]);
    // O is still 0: nothing to rescale
    softmax(sc, t * BN, alpha, masked(t), lo, hi);
    hop::pack_fragments(pa, sc);
    for (int j = 1; j < n_tiles; ++j) {
      if constexpr (SEG) t = next_live(t + 1);
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      hop::mbar_wait(&full_k[s], (j / STAGES) & 1);
      hop::mbar_wait(&full_v[sp], ((j - 1) / STAGES) & 1);
      my_turn();
      hop::wgmma_fence();
      scores(sc, s);
      accumulate(pa, sp);
      next_turn();
      share(t);
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      hop::mbar_arrive(&empty_k[s]);  // K of stage s is read
      softmax(sc, (SEG ? t : k_lo + j) * BN, alpha, masked(t), lo, hi);
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::mbar_arrive(&empty_v[sp]);  // V of stage sp is read
      if (!LAZY || rescale) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[4 * i + c] *= alpha[c / 2];
      }
      hop::pack_fragments(pa, sc);
    }
    const int sl = (n_tiles - 1) % STAGES;
    hop::mbar_wait(&full_v[sl], ((n_tiles - 1) / STAGES) & 1);
    my_turn();
    hop::wgmma_fence();
    accumulate(pa, sl);
    next_turn();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
  }

  // epilogue: (a ring step: fold in the state of the earlier steps, and
  // hand the state on unless this is the rank's last step;) normalise,
  // flush dead rows to (0, NEG_INF). O element 4 j + 2 r + c is row
  // r_lo + 8 r, column 8 j + 2 tq + c
  const float LN2 = 0.69314718055994531f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    const long long idx = (long long)(b * Hq + h) * Sq + row;
    float m_tot = m_run[r];
    if constexpr (RING) {
      if (!ring.first) {
        // the tile loop ran from the empty state, exactly as B1's; the
        // earlier steps' (m, l, acc) join here, in registers: the same
        // arithmetic as carrying them through the loop
        const float mv = ring.m[idx];
        const float m_old = mv <= RFA_NEG_INF / 2 ? -INFINITY : mv;
        m_tot = fmaxf(m_old, m_run[r]);
        const float m_use = m_tot == -INFINITY ? 0.f : m_tot;
        const float a_old = exp2f(m_old - m_use);
        const float a_new = exp2f(m_run[r] - m_use);
        l = ring.l[idx] * a_old + l * a_new;
        const float* a = ring.acc + idx * D + tq * 2;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float2 x = *reinterpret_cast<const float2*>(a + i * 8);
          o[4 * i + 2 * r] = x.x * a_old + o[4 * i + 2 * r] * a_new;
          o[4 * i + 2 * r + 1] = x.y * a_old + o[4 * i + 2 * r + 1] * a_new;
        }
      }
      if (!ring.last) {
        if (tq == 0) {
          ring.m[idx] = fmaxf(m_tot, RFA_NEG_INF);
          ring.l[idx] = l;
        }
        float* a = ring.acc + idx * D + tq * 2;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<float2*>(a + i * 8) =
              make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
        continue;
      }
    }
    const bool dead = !(l > 0.f);
    // BAND: the kept p scaled by 1 / (1 - p), out only
    const float inv =
        dead ? 0.f : (BAND == rfa_band::ALL ? band.inv_keep : 1.f) / l;
    const long long orow = idx * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + tq * 2;
      const float x0 = o[4 * i + 2 * r] * inv;
      const float x1 = o[4 * i + 2 * r + 1] * inv;
      if (out_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + orow + col) =
            rfa::pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + orow + col) =
            make_float2(x0, x1);
      }
    }
    if (tq == 0) lse[idx] = dead ? RFA_NEG_INF : (m_tot + log2f(l)) * LN2;
  }
}

// strides: (b, h, s) of q, k and v in elements, 16-byte multiples; the last
// dim contiguous and every base 16-byte aligned (TMA's terms). Returns 0 or
// a cudaError_t.
template <int D, bool RING, bool XFORM = false, bool SEG = false,
          int BAND = 0>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale_log2, int causal, int offset, int out_bf16,
           const Ring& ring, cudaStream_t stream,
           const rfa_seg_args& seg = rfa_seg_args{},
           const rfa_band_args& band = rfa_band_args{}) {
  auto kern = flash_fwd_kernel<D, RING, XFORM, SEG, BAND>;
  constexpr int BN = kv_tile<D, RING, XFORM, SEG, BAND>;
  // SEG: the kv tiles' classes past the barriers
  const int bytes =
      Smem<D, BN>::BYTES + (SEG ? rfa_seg::class_bytes(seg.n_kv) : 0);
  if (bytes > rfa_seg::MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SEG ? rfa_seg::MAX_SMEM : Smem<D, BN>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int tiles = (Sq + BM - 1) / BM;
  if (tiles > 65535) return cudaErrorInvalidValue;  // gridDim.y's limit
  Maps maps = {};
  int e = hop_host::tmap_4d(&maps.q, q, false, B, Hq, Sq, D, st, 64, BM);
  if (!e) e = hop_host::tmap_4d(&maps.k, k, false, B, Hkv, Skv, D, st + 3,
                                64, BN);
  if (!e) e = hop_host::tmap_4d(&maps.v, v, false, B, Hkv, Skv, D, st + 6,
                                64, BN);
  if (e) return e;
  dim3 grid(B * Hq, tiles);
  kern<<<grid, NTHREADS, bytes, stream>>>(maps, out, lse, Hq, Hkv, Sq, Skv,
                                          scale_log2, causal, offset,
                                          out_bf16, ring, seg, band);
  return cudaGetLastError();
}

}  // namespace rfa_fwd
