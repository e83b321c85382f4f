// Shared pieces of the flash-attention backward kernels: the kv-major loop
// of B2 (csrc/flash_bwd.cu, with dq), B3b (csrc/flash_bwd_split.cu, without)
// and B8 (csrc/fused_ring_bwd.cu, with dq and RING). The delta =
// rowsum(dout * out) pre-pass that the launchers run when the caller passes
// delta=None lives in csrc/flash_bwd.cu alone.
//
// Contract (ops/flash.py::block_bwd, the port of the JAX block_bwd):
// q, dout (B, Hq, Sq, D), k, v (B, Hkv, Skv, D) in bf16, lse and delta
// fp32 (B, Hq, Sq) contiguous, lse in natural log from the merged forward.
// p = exp(q k^T * scale - max(lse, NEG_INF / 2)) on allowed (q, k) pairs
// and 0 elsewhere; ds = p * (dout v^T - delta) * scale; dq = ds k,
// dk = ds^T q, dv = p^T dout, dk and dv summed over the GQA group.
//
// What bounds the loop on the H100: tensor-core operations (4 or 5 bf16
// products of 2 * D flops per allowed pair and head, far above the ridge of
// about 295 flop per byte), so the design is about keeping the tensor cores
// fed, after the FlashAttention-3 backward:
//
//  - One block per (batch, kv head, 128-key tile), launched tile-major
//    across heads so that the heaviest causal tiles of every head start
//    first (launched head by head, the causal grid spent a quarter of its
//    time in its tail). Three warpgroups: two consumers own 64 keys each,
//    the third is a producer (setmaxnreg: 240 registers a consumer thread,
//    24 a producer thread).
//  - Loads by TMA: K and V of the tile once, then Q, dout (4-D tensor maps
//    over the real strides, rows past S zero-filled) into a two-stage ring
//    under mbarrier full/empty pairs; lse2 and delta by the producer warp's
//    lanes, which arrive on the same barrier.
//  - Products by wgmma, each warpgroup in the transposed orientation, so
//    that its 64 x D fp32 dk and dv stay in registers for the whole walk and
//    are written once (one writer per key: bitwise reproducible):
//      S^T  = K Q^T     (both from shared memory, K-major)
//      p^T  = exp2(S^T * scale * log2 e - lse2)
//      dV  += P^T dout  (P^T packed to bf16 from the accumulators as the A
//                        fragments; dout read transposed, MN-major)
//      dP^T = V dout^T
//      dS^T = P^T (dP^T - delta) * scale
//      dK  += dS^T Q    (dS^T from registers, Q MN-major)
//    p and ds are rounded to bf16 only as operands; the scale stays in fp32.
//  - With dq (B2, B8) both warpgroups write dS^T to shared memory and meet
//    at a named barrier (the producer is not part of it); each computes half
//    of the tile's 64 x D dQ = dS K by wgmma, stores it in fp32 to one of
//    two swizzled buffers and only arrives at a barrier; the producer
//    warpgroup's second warp adds the tile into the fp32 (B, Hq, Sq, D)
//    accumulator by TMA reduce-adds (cp.reduce.async.bulk.tensor), off the
//    consumers' path. The sum order varies from run to run, so dq's last
//    bits do (deterministic calls take B3a/B3b).
//
// Measured (profile_torch_bwd.py, NVIDIA H100 80GB HBM3, 700 W, the parent
// and this loop in turns in one session) at q (1, 32, 8192, 128), kv (1, 8,
// 8192, 128) bf16: B2 causal 3.26 to 3.45 ms (about 420 TFLOP/s, 1.0 to
// 1.1x SDPA's backward; the mma.sync loop it replaces 8.67 to 9.19), B3b
// 2.16 to 2.28 (6.07 to 6.50), B8 off-diagonal 6.55 to 6.83 (15.40 to
// 15.67), diagonal 3.36 to 3.51 (8.47 to 8.82). At head_dim 256 (the
// SPLIT design below; the same card, parent and change in turns, device
// ms): B2 at Gemma-7B's attention, q and kv (1, 16, 8192, 256) causal,
// 4.10 to 4.12 (the design before it 5.47 to 5.58; SDPA's backward 3.37 to
// 3.41), B3b 2.26 to 2.32 (2.71 to 2.76). What each step of the design gave
// is in PERF.md.
//
// With RING (kernel B8) the same loop is one step of the fused ring
// backward: q arrives pre-scaled by scale * log2 e, v pre-scaled by scale,
// lse in base 2 and clamped, delta times scale, so no scale is applied
// here; softcap and ALiBi are recomputed as the forward applied them (with
// the 1 - tanh^2 factor on dS); dq adds into the rank's accumulator, which
// the launcher does not zero, and dk, dv add into the travelling fp32
// accumulators instead of being written. Without RING all of that compiles
// out.
//
// The transform is its own flag, XFORM (on by default with RING): B2 and B3b
// with softcap or ALiBi (csrc/xform.cuh) compile it without RING, scale the
// logits to base 2 first and transform after, as the TPU kernels do, and
// take ALiBi's distance from the index and the offsets, or (SEG) from the
// explicit positions: its keys' own, and a q step's first position and step
// where the step's positions have one, else the masked body's. Their
// segmented builds make P and P (1 - tanh^2) in one pass, element by
// element, with no array of the softcap's factor (see the loop).
//
// With SEG (B2 and B3b on packed sequences, csrc/segments.cuh) a block walks
// the q steps [kv_meta[4], kv_meta[5]] of its kv tile, clamped by the index
// bound where the mask is causal by index or packed_self, for each q head
// of its group; the producer, the dQ writer and the consumers skip the
// same steps, whose segments or positions cannot meet the tile, and the
// consumers mask by segment and position the steps that straddle an edge.
// Keys no q row reaches get dk = dv = 0.
//
// At head_dim 256 (Gemma; every build of B2, B3b and B8) a 64 x 256 fp32
// dK and dV would take 256 registers a thread, and K and V alone take 64 KB
// of shared memory, so a block takes 64 keys, which both consumer
// warpgroups share (SPLIT). Each product is made once a step:
//  - warpgroup wg computes S^T and dP^T of the step's q rows [32 wg, 32 wg
//    + 32) over the whole head dim, wgmma at N = 32, and makes their P^T
//    and dS^T (16 fp32 a thread each: every transform reads only the
//    logits, rows, keys and positions, so softcap, ALiBi, segments, the
//    window band and the dropout keep bits are made once, by one thread);
//  - both write their bf16 halves of P^T and dS^T into shared panels and
//    meet at the dS^T barrier; then warpgroup wg owns dK's, dV's and dQ's
//    columns [wg D / 2, (wg + 1) D / 2): dV += P^T dout and dK += dS^T Q
//    by wgmma with both operands in shared memory over all 64 rows (64 + 64
//    fp32 a thread), dQ = dS K a 64-column panel at a time;
//  - each dQ panel is staged in fp32 in the warpgroup's own 16 KB buffer,
//    which the warpgroup's lead thread adds into dq_acc by TMA reduce-adds
//    (B8's dq too: the rank's accumulator; its dK and dV join the
//    travelling fp32 accumulators in the epilogue as at 64 and 128);
//  - to fit those buffers dout has one stage of its own (B3b too, which
//    leaves SEG's classes their room); Q keeps two (KvSmem): one Q stage
//    with a 32 KB buffer a warpgroup ran B2 1.25x slower (PERF.md).
//
// With BAND (B2 and B3b with a window or dropout, csrc/band.cuh; always with
// XFORM, without RING) a block's q steps narrow to the window's band where
// the positions are the index, the steps that cross a band edge are masked
// (with SEG and explicit positions the classes take the band), and the
// producer warp hashes each q row of a step beside its lse and delta. P is
// made element by element, as the XFORM segmented build makes it: the
// dropped p leave dV's operand, the keep bits of a thread's 32 elements
// wait in one register for dS, which masks and scales dP and takes the
// undropped p; dV is scaled by 1 / (1 - p) once, at the end.

#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "band.cuh"
#include "segments.cuh"
#include "xform.cuh"

namespace rfa_bwd {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// kv-major loop (B2 with DQ, B3b without, B8 with DQ and RING)

// What a ring step adds to a block call (B8). B2 and B3b with XFORM read
// the transform's fields (slopes, cap2, q_pos0 - kv_pos0 the offset of
// positions by index, alibi_abs) and nothing else.
struct Ring {
  const float* slopes;  // (Hq,) ALiBi slopes * log2(e), or null
  float cap2;           // softcap * log2(e); 0 = no capping
  int q_pos0, kv_pos0;  // global positions of q row 0 and of key 0
  int alibi_abs;        // ALiBi on |distance| (a ring without causal mask)
  int accumulate;       // dk, dv: add to what is there (else write)
};

// keys per block: 128, 64 per consumer warpgroup; at head_dim 256, 64,
// which both consumer warpgroups share, each owning half of dK's and dV's
// columns and half of a step's q rows (a 64 x 256 fp32 dK and dV would take
// 256 registers a thread; K and V alone take 64 KB of the block's 227)
template <int D>
constexpr int kv_keys = D > 128 ? 64 : 128;
constexpr int KV_BM = 64;   // q rows per step
constexpr int KV_CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int KV_THREADS = KV_CONSUMERS + 128;  // + the producer warpgroup
constexpr int KV_STAGES = 2;

// Byte offsets from a 1024-aligned base; bf16 tiles in 128B-swizzled panels
// of 64 columns, the fp32 dQ tile in 128B-swizzled boxes of 32 columns.
//
// SPLIT (head_dim 256): Q has its stages and dout one of its own: the two
// staged 64 x 64 fp32 dQ panels (one a consumer warpgroup) take the room
// of dout's second stage, the choice FlashAttention-3 makes at this head
// dim (K, V 64 KB, Q 64, dout 32, P^T and dS^T 2 x 8 each, dQ 32: 224 KB,
// with SEG's classes of 1760 q tiles within the 227). B3b, without dQ,
// has the same one stage: 192 KB, room for the classes of 120k q tiles.
template <int D, bool DQ = false, int BAND = 0>
struct KvSmem {
  static constexpr int KV_BN = kv_keys<D>;
  static constexpr bool SPLIT = D > 128;
  static constexpr int PANEL_KV = KV_BN * 128;  // one 64-column panel of K
  static constexpr int PANEL_Q = KV_BM * 128;   // of a Q or dout tile
  static constexpr int K = 0;
  static constexpr int V = K + KV_BN * D * 2;
  // stage s: Q, then dout (SPLIT: Q alone)
  static constexpr int Q = V + KV_BN * D * 2;
  static constexpr int STAGE = (SPLIT ? 1 : 2) * KV_BM * D * 2;
  static constexpr int DO_STAGES = SPLIT ? 1 : KV_STAGES;
  static constexpr int DO = Q + KV_STAGES * STAGE;  // SPLIT: dout's stages
  static constexpr int DS =  // 2 x dS^T (keys x rows)
      DO + (SPLIT ? DO_STAGES * KV_BM * D * 2 : 0);
  static constexpr int DS_BYTES = KV_BN * KV_BM * 2;
  static constexpr int PT = DS + 2 * DS_BYTES;  // SPLIT: 2 x P^T
  static constexpr int DQT = PT + (SPLIT ? 2 * DS_BYTES : 0);
  // 2 x the fp32 dQ tile (SPLIT: a 64-column panel a consumer warpgroup)
  static constexpr int DQ_BYTES = SPLIT ? KV_BM * 64 * 4 : KV_BM * D * 4;
  // lse2, delta (BAND: and the rows' dropout hashes)
  static constexpr int ROWS = DQT + (DQ ? 2 * DQ_BYTES : 0);
  static constexpr int BAR =
      ROWS + KV_STAGES * (BAND == rfa_band::ALL ? 3 : 2) * KV_BM * 4;
  // mbarriers: full[KV_STAGES], empty[KV_STAGES], kv (SPLIT: and dout's
  // full[DO_STAGES], empty[DO_STAGES])
  static constexpr int BYTES =
      BAR + (2 * KV_STAGES + 1 + (SPLIT ? 2 * DO_STAGES : 0)) * 8 + 1024;
};

// TMA maps of the four bf16 operands, boxes of 64 columns by KV_BM rows (q,
// dout) or KV_BN rows (k, v), and of the fp32 dq accumulator, boxes of 32
// columns by KV_BM rows.
struct Maps {
  CUtensorMap q, k, v, o, dq;
};

// Named barriers beside __syncthreads' 0: the consumers' dS^T (1), and for
// each dQ buffer b the consumers' "tile written" (2 + b) and the dQ
// writer's "tile read" (4 + b). SPLIT: 2 + wg is consumer warpgroup wg's
// own, around its dQ buffer.
constexpr int BAR_DS = 1, BAR_DQ_FULL = 2, BAR_DQ_EMPTY = 4;
constexpr int DQ_PARTIES = KV_CONSUMERS + 32;

// S^T or dP^T (64 keys x 64 q rows) of this warpgroup: A rows from the K
// or V tile, B the Q or dout tile, both K-major over the head dim.
template <int D>
__device__ __forceinline__ void kv_scores(float (&acc)[32], const char* kv,
                                          const char* qt) {
  using S = KvSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ko = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel
    hop::wgmma_ss_n64<0, 0>(
        acc, hop::desc_sw128(kv + (kk / 4) * S::PANEL_KV + ko, 16),
        hop::desc_sw128(qt + (kk / 4) * S::PANEL_Q + ko, 16), kk > 0);
  }
}

// SPLIT: S^T or dP^T of this warpgroup's 32 q rows (64 keys x 32 rows): A
// rows from the K or V tile, B the warpgroup's rows of the Q or dout tile
// from qt on, both K-major over the head dim.
template <int D>
__device__ __forceinline__ void kv_scores_half(float (&acc)[16],
                                               const char* kv,
                                               const char* qt) {
  using S = KvSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ko = (kk % 4) * 32;
    hop::wgmma_ss_n32<0, 0>(
        acc, hop::desc_sw128(kv + (kk / 4) * S::PANEL_KV + ko, 16),
        hop::desc_sw128(qt + (kk / 4) * S::PANEL_Q + ko, 16), kk > 0);
  }
}

// SPLIT: acc (64 keys x 128) += A (64 keys x 64 q rows, the bf16 P^T or
// dS^T panel at a, K-major) * T (64 q rows x 128 columns of the Q or dout
// tile from t on, MN-major).
template <int D>
__device__ __forceinline__ void kv_accumulate_ss(float (&acc)[64],
                                                 const char* a,
                                                 const char* t) {
  using S = KvSmem<D>;
#pragma unroll
  for (int kc = 0; kc < KV_BM / 16; ++kc)
    hop::wgmma_ss_n128<0, 1>(acc, hop::desc_sw128(a + kc * 32, 16),
                             hop::desc_sw128(t + kc * 16 * 128, S::PANEL_Q),
                             1);
}

// SPLIT: acc (64 q rows x 64 columns of dQ) = dS (64 q rows x 64 keys, A
// MN-major in the stored dS^T at ds) * a 64-column panel kb of K (MN-major).
template <int D>
__device__ __forceinline__ void kv_dq_panel(float (&acc)[32], const char* ds,
                                            const char* kb) {
#pragma unroll
  for (int kc = 0; kc < KvSmem<D>::KV_BN / 16; ++kc)
    hop::wgmma_ss_n64<1, 1>(acc, hop::desc_sw128(ds + kc * 2048, 16),
                            hop::desc_sw128(kb + kc * 2048, 16), kc > 0);
}

// SPLIT: bf16 fragments of a 64 x 32 accumulator (fragment kc, register r:
// key 16 warp + g + 8 (r % 2), q row c0 + 16 kc + 8 (r / 2) + 2 tq and the
// next) into a [key][q row] panel of 64 x 64 in the swizzled layout.
__device__ __forceinline__ void store_half_panel(char* panel,
                                                 const uint32_t (&a)[2][4],
                                                 int c0, int warp, int g,
                                                 int tq) {
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 16 + g + (r % 2) * 8;
      const int chunk = c0 / 8 + 2 * kc + r / 2;
      *reinterpret_cast<uint32_t*>(panel + row * 128 +
                                   ((chunk ^ (row % 8)) << 4) + tq * 4) =
          a[kc][r];
    }
}

// acc (64 keys x N) += A (64 keys x 64 q rows, bf16 fragments) * T (64 q
// rows x N, N = 2 NA columns of the Q or dout tile from t on, MN-major: its
// rows are the reduction).
template <int D, int NA>
__device__ __forceinline__ void kv_accumulate(float (&acc)[NA],
                                              const uint32_t (&a)[4][4],
                                              const char* t) {
  using S = KvSmem<D>;
#pragma unroll
  for (int kc = 0; kc < KV_BM / 16; ++kc) {
    const uint64_t db = hop::desc_sw128(t + kc * 16 * 128, S::PANEL_Q);
    if constexpr (NA == 64)
      hop::wgmma_rs_n128<1>(acc, a[kc], db, 1);
    else
      hop::wgmma_rs_n64<1>(acc, a[kc], db, 1);
  }
}

template <int D, bool DQ, bool RING, bool SEG = false, bool XFORM = RING,
          int BAND = 0>
__global__ void __launch_bounds__(KV_THREADS, 1)
bwd_kv_kernel(const __grid_constant__ Maps maps,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* __restrict__ dk, void* __restrict__ dv, int Hq, int Hkv,
              int Sq, int Skv, float scale, int causal, int offset,
              int dkv_bf16, Ring ring,
              const __grid_constant__ rfa_seg_args seg,
              const rfa_band_args band, float* __restrict__ dq_acc) {
  static_assert(!(SEG && RING), "a ring step takes no segments");
  static_assert(!BAND || (XFORM && !RING), "BAND comes with XFORM, no ring");
  using S = KvSmem<D, DQ, BAND>;
  constexpr int KV_BN = S::KV_BN;
  // head_dim 256: both consumer warpgroups take the same 64 keys, warpgroup
  // wg a step's q rows [32 wg, 32 wg + 32) for S^T and dP^T, and dK's, dV's
  // and dQ's columns [wg D / 2, (wg + 1) D / 2)
  constexpr bool SPLIT = S::SPLIT;
  // fp32 of a 64 x D (SPLIT: 64 x D / 2) accumulator a thread holds
  constexpr int NA = SPLIT ? D / 4 : D / 2;
  // fp32 of this warpgroup's S^T or dP^T a thread holds
  constexpr int NS = SPLIT ? 16 : 32;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem =
      smem_raw + ((1024 - (rfa::smem_u32(smem_raw) & 1023)) & 1023);

  // blocks launch in the order of blockIdx.x, then y: every (batch, kv
  // head) of a kv tile before the next tile, so that under a causal mask,
  // where the first tiles see the most q tiles, the heaviest blocks of all
  // heads start first and the grid ends without a long tail
  const int n0 = blockIdx.y * KV_BN;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int group = Hq / Hkv;
  const int lane = threadIdx.x % 32;

  // q tiles [t0, nq) hold every row that sees a key of this tile; step
  // `it` is q head hk * group + it / per_head, q tile t0 + it % per_head
  int t0 = causal ? max(0, n0 - offset) / KV_BM : 0;
  if constexpr (SEG) {
    if (seg.tri) t0 = n0 / KV_BM;
  }
  int nq = (Sq + KV_BM - 1) / KV_BM;
  // BAND with positions by index: the window's q tiles (the offset of
  // positions is ring.q_pos0, the XFORM field)
  if constexpr (BAND) {
    if (!(SEG && seg.q_pos)) {
      int w_lo, w_hi;
      rfa_band::index_tiles(band, n0, KV_BN, ring.q_pos0, KV_BM, nq, false,
                            w_lo, w_hi);
      t0 = max(t0, w_lo);
      nq = w_hi;
    }
  }
  const int per_head = nq > t0 ? nq - t0 : 0;
  int steps = group * per_head;

  // SEG: the classes of the q steps [t_lo, t_hi] against this kv tile, in
  // shared memory past the barriers; every role walks the live ones alike,
  // for each q head of the group (gi, tt: head and q step)
  uint32_t* seg_bits = reinterpret_cast<uint32_t*>(smem + S::BYTES - 1024);
  int t_lo = 0, t_hi = -1, t_first = 0;
  auto step_class = [&](int t) {
    return rfa_seg::class_of(seg_bits, t - t_lo);
  };
  auto next_live = [&](int t) {
    while (t <= t_hi && step_class(t) == 0) ++t;
    return t;
  };
  auto advance = [&](int& gi, int& tt) {
    tt = next_live(tt + 1);
    if (tt > t_hi) {
      ++gi;
      tt = t_first;
    }
  };

  char* ks = smem + S::K;
  char* vs = smem + S::V;
  float* fs = reinterpret_cast<float*>(smem + S::ROWS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + KV_STAGES;
  uint64_t* kv_bar = empty + KV_STAGES;
  // SPLIT: dout's own stages
  uint64_t* do_full = kv_bar + 1;
  uint64_t* do_empty = do_full + S::DO_STAGES;
  auto qs = [&](int s) { return smem + S::Q + s * S::STAGE; };
  auto dos = [&](int s) {
    return SPLIT ? smem + S::DO + s * KV_BM * D * 2 : qs(s) + KV_BM * D * 2;
  };
  auto lses = [&](int s) {
    return fs + s * (BAND == rfa_band::ALL ? 3 : 2) * KV_BM;
  };
  auto dels = [&](int s) { return lses(s) + KV_BM; };
  auto rhs = [&](int s) {
    return reinterpret_cast<uint32_t*>(dels(s) + KV_BM);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      hop::mbar_init(&full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&empty[s], KV_CONSUMERS);
    }
    hop::mbar_init(kv_bar, 1);
    if constexpr (SPLIT) {
      for (int s = 0; s < S::DO_STAGES; ++s) {
        hop::mbar_init(&do_full[s], 1);
        hop::mbar_init(&do_empty[s], KV_CONSUMERS);
      }
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  if constexpr (SEG) {
    const int kt = blockIdx.y;
    t_lo = max(t0, rfa_seg::range_lo(seg.kv_meta, seg.n_kv, kt));
    t_hi = min(nq - 1, rfa_seg::range_hi(seg.kv_meta, seg.n_kv, kt));
    if constexpr (BAND) {
      steps = group * rfa_band::fill_classes<KV_THREADS>(
          seg_bits, rfa_seg::tile(seg.kv_meta, seg.n_kv, kt), seg.q_meta,
          seg.n_q, t_lo, t_hi, seg.pos_causal != 0, seg.q_pos != nullptr,
          false, band);
    } else {
      steps = group * rfa_seg::fill_classes<KV_THREADS>(
          seg_bits, rfa_seg::tile(seg.kv_meta, seg.n_kv, kt), seg.q_meta,
          seg.n_q, t_lo, t_hi, rfa_seg::skip_on_positions<XFORM>(seg),
          false);
    }
    if constexpr (XFORM) {
      if (seg.q_pos && ring.slopes)
        rfa_seg::keep_affine<KV_THREADS>(seg_bits, seg.q_step + t_lo,
                                         t_hi - t_lo + 1);
    }
    t_first = next_live(t_lo);
  }

  if (threadIdx.x >= KV_CONSUMERS) {
    hop::setmaxnreg_dec<24>();
    if (threadIdx.x < KV_CONSUMERS + 32) {
      // ---- producer: one warp keeps the q-side tiles in flight by TMA ----
      if (lane == 0) {
        hop::mbar_arrive_tx(kv_bar, 2 * KV_BN * D * 2);
        for (int p = 0; p < D / 64; ++p) {
          hop::tma_load_4d(ks + p * S::PANEL_KV, &maps.k, kv_bar, 64 * p, n0,
                           hk, b);
          hop::tma_load_4d(vs + p * S::PANEL_KV, &maps.v, kv_bar, 64 * p, n0,
                           hk, b);
        }
      }
      int gi = 0, tt = t_first;
      for (int it = 0; it < steps; ++it) {
        const int s = it % KV_STAGES;
        const int h = hk * group + (SEG ? gi : it / per_head);
        const int m0 = (SEG ? tt : t0 + it % per_head) * KV_BM;
        if constexpr (SEG) advance(gi, tt);
        hop::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        // BAND with dropout: the hash part of the step's head
        uint32_t hb = 0u;
        if constexpr (BAND == rfa_band::ALL) {
          if (band.thr) hb = rfa_band::head_base(band, h, b);
        }
        for (int i = lane; i < KV_BM; i += 32) {
          const int row = m0 + i;
          float l2 = 0.f, dl = 0.f;
          uint32_t rhv = 0u;
          if (row < Sq) {
            const long long idx = (long long)(b * Hq + h) * Sq + row;
            // dead rows (lse = NEG_INF) clamp so that p underflows to 0
            // (a ring step's lse arrives in base 2, already clamped)
            l2 = RING ? lse[idx] : fmaxf(lse[idx], RFA_NEG_INF / 2) * LOG2E;
            dl = delta[idx];
            if constexpr (BAND == rfa_band::ALL) {
              if (band.thr) {
                const uint32_t qp = SEG && seg.q_pos
                                        ? (uint32_t)__ldg(seg.q_pos + row)
                                        : band.q_pos0 + (uint32_t)row;
                const uint32_t qs =
                    SEG && seg.q_seg ? (uint32_t)__ldg(seg.q_seg + row) : 0u;
                rhv = rfa_band::row_hash(hb, qp, qs);
              }
            }
          }
          lses(s)[i] = l2;
          dels(s)[i] = dl;
          if constexpr (BAND == rfa_band::ALL) rhs(s)[i] = rhv;
        }
        if (lane == 0) {
          hop::mbar_arrive_tx(&full[s], (SPLIT ? 1 : 2) * KV_BM * D * 2);
          for (int p = 0; p < D / 64; ++p) {
            hop::tma_load_4d(qs(s) + p * S::PANEL_Q, &maps.q, &full[s], 64 * p,
                             m0, h, b);
            if constexpr (!SPLIT)
              hop::tma_load_4d(dos(s) + p * S::PANEL_Q, &maps.o, &full[s],
                               64 * p, m0, h, b);
          }
          if constexpr (SPLIT) {
            // dout into its own stage once the consumers' dV has read it
            const int sd = it % S::DO_STAGES;
            hop::mbar_wait(&do_empty[sd], ((it / S::DO_STAGES) & 1) ^ 1);
            hop::mbar_arrive_tx(&do_full[sd], KV_BM * D * 2);
            for (int p = 0; p < D / 64; ++p)
              hop::tma_load_4d(dos(sd) + p * S::PANEL_Q, &maps.o,
                               &do_full[sd], 64 * p, m0, h, b);
          }
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    } else if (DQ && !SPLIT && threadIdx.x < KV_CONSUMERS + 64) {
      // ---- dQ writer: the next warp adds each fp32 dQ tile into dq_acc
      // by TMA, off the consumers' path (the last two warps idle) ----
      int gi = 0, tt = t_first;
      for (int it = 0; it < steps; ++it) {
        const int buf = it & 1;
        const int h = hk * group + (SEG ? gi : it / per_head);
        const int m0 = (SEG ? tt : t0 + it % per_head) * KV_BM;
        if constexpr (SEG) advance(gi, tt);
        hop::bar_sync(BAR_DQ_FULL + buf, DQ_PARTIES);
        if (lane == 0) {
          for (int p = 0; p < D / 32; ++p)
            hop::tma_reduce_add_4d(&maps.dq,
                                   smem + S::DQT + buf * S::DQ_BYTES +
                                       p * KV_BM * 128,
                                   32 * p, m0, h, b);
          hop::bulk_commit();
          hop::bulk_wait_read<0>();
        }
        __syncwarp();
        if (it + 2 < steps) hop::bar_arrive(BAR_DQ_EMPTY + buf, DQ_PARTIES);
      }
      if (lane == 0) hop::bulk_wait<0>();
    }
  } else {
    // ---- consumers: warpgroup wg owns keys nw + [0, 64) (SPLIT: both
    // take the block's 64 keys; wg makes P^T and dS^T of a step's q rows
    // qo + [0, 32)) ----
    hop::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128;
    const int nw = n0 + (SPLIT ? 0 : 64 * wg);
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, tq = lane % 4;
    const int qo = SPLIT ? 32 * wg : 0;
    const float scale_log2 = RING ? 1.f : scale * LOG2E;
    const float ds_scale = RING ? 1.f : scale;
    const float inv_cap2 = XFORM && ring.cap2 > 0.f ? 1.f / ring.cap2 : 0.f;

    // SEG: segment ids and positions of this thread's keys
    int kseg[2] = {0, 0}, kpos[2] = {0, 0};
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = nw + warp * 16 + g + r * 8;
        if (key < Skv) {
          if (seg.kv_seg) kseg[r] = __ldg(seg.kv_seg + key);
          if (seg.kv_pos) kpos[r] = __ldg(seg.kv_pos + key);
        }
      }
    }
    // XFORM on packed sequences: each key's position for ALiBi (explicit,
    // or its index)
    int akey[2] = {0, 0};
    if constexpr (XFORM && SEG && !RING) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        akey[r] = seg.q_pos ? kpos[r] : nw + warp * 16 + g + r * 8;
    }

    // BAND: ALiBi by index (the segmented builds set akey above) and the
    // hashes kv_pos * H_K of this thread's keys for dropout
    uint32_t kh[2] = {0u, 0u};
    if constexpr (BAND) {
      const bool idx_pos = !(SEG && seg.q_pos);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = nw + warp * 16 + g + r * 8;
        if constexpr (!SEG) akey[r] = key;
        if constexpr (BAND == rfa_band::ALL)
          kh[r] = (idx_pos ? band.kv_pos0 + (uint32_t)key
                           : (uint32_t)kpos[r]) * rfa_band::H_K;
      }
    }

    float dk_acc[NA], dv_acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hop::mbar_wait(kv_bar, 0);

    int gi = 0, tt = t_first;
    for (int it = 0; it < steps; ++it) {
      const int s = it % KV_STAGES;
      const int sd = it % S::DO_STAGES;  // SPLIT: dout's stage
      const int h = hk * group + (SEG ? gi : it / per_head);
      const int m0 = (SEG ? tt : t0 + it % per_head) * KV_BM;
      const int mq = m0 + qo;  // the warpgroup's first q row
      const bool seg_masked = SEG && step_class(tt) == 1;
      if constexpr (SEG) advance(gi, tt);
      // SEG: the lane's share of the masked step's q rows m0 + 2 lane +
      // {0, 1}, loaded before the products are waited for
      rfa_seg::Pair qv{};
      if (SEG && seg_masked)
        qv = rfa_seg::load_pair(seg.q_seg, seg.q_pos, m0 + 2 * lane, Sq);
      // XFORM on packed sequences: ALiBi's distance is (qb + qsk row) -
      // akey[r] on every step it applies to: akey the key's position
      // (explicit, or its index), qb and qsk the step's rows' (the offset
      // and 1 by index; on explicit positions an unmasked step's rows sit
      // at q_pos[m0] + qsk (row - m0); a masked step's ALiBi is the masked
      // body's)
      int qb = ring.q_pos0, qsk = 1;
      bool alibi = false;
      if constexpr (BAND && !SEG) alibi = ring.slopes != nullptr;
      if constexpr (XFORM && SEG && !RING) {
        alibi = ring.slopes && !(seg.q_pos && seg_masked);
        if (seg.q_pos && alibi) {
          qsk = __ldg(seg.q_step + m0 / KV_BM);
          qb = __ldg(seg.q_pos + m0) - qsk * m0;
        }
      }
      const char* qt = qs(s);
      const char* dot = dos(SPLIT ? sd : s);
      // SPLIT: the warpgroup's two panels of Q and dout for dK and dV
      const char* qh = SPLIT ? qt + wg * 2 * S::PANEL_Q : qt;
      const char* doh = SPLIT ? dot + wg * 2 * S::PANEL_Q : dot;
      // the warpgroup's rows' lse2 and delta
      const float* l2s = lses(s) + qo;
      const float* dls = dels(s) + qo;
      // dS^T (SPLIT: and P^T) alternate between two buffers: one barrier a
      // step keeps a warpgroup that runs ahead off the buffer the other
      // still reads
      char* dss = smem + S::DS + (it & 1) * S::DS_BYTES;
      char* pts = smem + S::PT + (it & 1) * S::DS_BYTES;
      hop::mbar_wait(&full[s], (it / KV_STAGES) & 1);

      // S^T = K Q^T and dP^T = V dout^T: 64 keys x 64 q rows each (SPLIT:
      // x the warpgroup's 32, by wgmma at N = 32: each product made once).
      // An element i of these accumulators is key 16 warp + g + 8 ((i % 4)
      // / 2) of the warpgroup's and q row qo + 8 (i / 4) + 2 tq + i % 2 of
      // the tile.
      float sc[NS], dpt[NS];
      hop::wgmma_fence();
      if constexpr (SPLIT) {
        kv_scores_half<D>(sc, ks, qt + qo * 128);
        hop::wgmma_commit();
        hop::mbar_wait(&do_full[sd], (it / S::DO_STAGES) & 1);
        kv_scores_half<D>(dpt, vs, dot + qo * 128);
      } else {
        kv_scores<D>(sc, ks + wg * 64 * 128, qt);
        hop::wgmma_commit();
        kv_scores<D>(dpt, vs + wg * 64 * 128, dot);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);

      // P^T; zero outside the mask and on the ragged edges
      const bool edge = m0 + KV_BM > Sq || nw + 64 > Skv ||
                        (causal && m0 + offset < nw + 63);
      uint32_t pa[NS / 8][4];
      uint32_t kbits = ~0u;  // BAND: the keep bits of the 32 elements
      // BAND: a step crosses a band edge by index where some pair of this
      // warpgroup's keys lies outside it
      bool win = false;
      if constexpr (BAND) {
        const long long d_hi = (long long)m0 + KV_BM - 1 - nw + ring.q_pos0;
        const long long d_lo = (long long)m0 - (nw + 63) + ring.q_pos0;
        win = !(SEG && seg.q_pos) && (d_hi > band.wl || d_lo < -band.wr);
      }
      if constexpr (BAND == rfa_band::WINDOW) {
        // a window alone (the launcher sends dropout, softcap and ALiBi to
        // the ALL build): the mask-free body's P, with the band's test on
        // the steps that cross an edge, and on a step masked by segments
        // or positions the segmented body's, with the band on the explicit
        // positions
        if (SEG && seg_masked) {
#pragma unroll
          for (int c = 0; c < NS / 4; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int qsg, qps;
              rfa_seg::take(qv, qo / 2 + 4 * c + tq, e, qsg, qps);
              const int col = 8 * c + 2 * tq + e;
              const int row = mq + col;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * c + 2 * r + e;
                const int key = nw + warp * 16 + g + r * 8;
                const int d = seg.q_pos ? rfa_band::diff(qps, kpos[r])
                                        : row - key + ring.q_pos0;
                const bool out_ =
                    row >= Sq || key >= Skv ||
                    (causal && row + offset < key) ||
                    rfa_seg::drop<true>(seg, qsg, qps, kseg[r], kpos[r]) ||
                    rfa_band::outside(band, d);
                sc[i] = out_ ? 0.f : exp2f(sc[i] * scale_log2 - l2s[col]);
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int col = (i / 4) * 8 + tq * 2 + i % 2;
            float p = exp2f(sc[i] * scale_log2 - l2s[col]);
            if (edge || win) {
              const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
              const int row = mq + col;
              if (row >= Sq || key >= Skv || (causal && row + offset < key) ||
                  (win && rfa_band::outside(band, row - key + ring.q_pos0)))
                p = 0.f;
            }
            sc[i] = p;
          }
        }
        hop::pack_fragments(pa, sc);
        if constexpr (SPLIT) {
          store_half_panel(pts, pa, qo, warp, g, tq);
        } else {
          hop::wgmma_fence();
          kv_accumulate<D>(dv_acc, pa, doh);  // dV += P^T dout
          hop::wgmma_commit();
        }
      } else if constexpr (BAND) {
        // B2 and B3b with dropout, softcap or ALiBi (the ALL build): as the
        // XFORM segmented build below, P element by
        // element into dV's fragments, with the band by index (or, masked,
        // on the explicit positions) and the keep bits; dV's operand takes
        // the kept p, sc the undropped p (1 - tanh^2) for dS
        const float slope = ring.slopes ? ring.slopes[h] : 0.f;
        if (ring.cap2 > 0.f) {
          const float k2 = scale_log2 * inv_cap2;
#pragma unroll
          for (int i = 0; i < NS; ++i)
            sc[i] = ring.cap2 * tanh_fast(sc[i] * k2);
        } else {
#pragma unroll
          for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
        }
        auto logit = [&](int i, int row, float& dc) {
          float x = sc[i];
          const float t = x * inv_cap2;  // 0 without softcap: dc = 1
          dc = 1.f - t * t;
          if (alibi) {
            float dist = (float)((qb + qsk * row) - akey[(i % 4) / 2]);
            if (ring.alibi_abs) dist = fabsf(dist);
            x -= slope * dist;
          }
          return x;
        };
        const bool idx_pos = !(SEG && seg.q_pos);
        const bool drop = BAND == rfa_band::ALL && band.thr != 0;
        const uint32_t* rhs_s = rhs(s) + qo;
        if (SEG && seg_masked) {
#pragma unroll
          for (int c = 0; c < NS / 4; ++c) {
            int qsg[2], qps[2];
            rfa_seg::take(qv, qo / 2 + 4 * c + tq, 0, qsg[0], qps[0]);
            rfa_seg::take(qv, qo / 2 + 4 * c + tq, 1, qsg[1], qps[1]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float pe[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * c + 2 * r + e;
                const int col = 8 * c + 2 * tq + e;
                const int row = mq + col;
                const int key = nw + warp * 16 + g + r * 8;
                float dc;
                float x = logit(i, row, dc);
                if (ring.slopes && seg.q_pos) {
                  float dist = (float)(qps[e] - kpos[r]);
                  if (ring.alibi_abs) dist = fabsf(dist);
                  x -= slope * dist;
                }
                const int d = idx_pos ? row - key + ring.q_pos0
                                      : rfa_band::diff(qps[e], kpos[r]);
                const bool out_ =
                    row >= Sq || key >= Skv ||
                    (causal && row + offset < key) ||
                    rfa_seg::drop<true>(seg, qsg[e], qps[e], kseg[r],
                                        kpos[r]) ||
                    rfa_band::outside(band, d);
                const float p = out_ ? 0.f : exp2f(x - l2s[col]);
                const bool kept =
                    !drop || rfa_band::keep(rhs_s[col], kh[r], band.thr);
                if (!kept) kbits &= ~(1u << i);
                pe[e] = kept ? p : 0.f;
                sc[i] = p * dc;
              }
              pa[(2 * c + r) / 4][(2 * c + r) % 4] =
                  rfa::pack_bf16(pe[0], pe[1]);
            }
          }
        } else {
          const bool edge_b = edge || win;
#pragma unroll
          for (int m = 0; m < NS / 2; ++m) {
            float pe[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * m + e;
              const int col = (i / 4) * 8 + tq * 2 + i % 2;
              const int row = mq + col;
              const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
              float dc;
              float p = exp2f(logit(i, row, dc) - l2s[col]);
              if (edge_b) {
                if (row >= Sq || key >= Skv ||
                    (causal && row + offset < key) ||
                    (win && rfa_band::outside(band, row - key + ring.q_pos0)))
                  p = 0.f;
              }
              const bool kept = !drop || rfa_band::keep(
                                             rhs_s[col], kh[(i % 4) / 2],
                                             band.thr);
              if (!kept) kbits &= ~(1u << i);
              pe[e] = kept ? p : 0.f;
              sc[i] = p * dc;
            }
            pa[m / 4][m % 4] = rfa::pack_bf16(pe[0], pe[1]);
          }
        }
        if constexpr (SPLIT) {
          store_half_panel(pts, pa, qo, warp, g, tq);
        } else {
          hop::wgmma_fence();
          kv_accumulate<D>(dv_acc, pa, doh);  // dV += P^T dout, kept p
          hop::wgmma_commit();
        }
      } else if constexpr (XFORM && !RING && SEG) {
        // B2 and B3b on packed sequences with softcap or ALiBi: each logit
        // scaled to base 2, capped and given its ALiBi bias (by index, or on
        // the explicit positions in the masked body), P made into dV's bf16
        // fragments as it is made and kept times the softcap's 1 - tanh^2
        // for dS, so that the transform holds no register array: the
        // segmented build with the array below spilled 650 bytes and ran
        // 1.5x this one on the five-sequence packing, while without
        // segments this form ran 1.15x the array's (80 to 120 bytes of
        // spills; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 17)
        const float slope = ring.slopes ? ring.slopes[h] : 0.f;
        // the logits in base 2, capped, in place: a loop of their own under
        // one uniform branch (tanh inside the P loops' branches ran B2 with
        // softcap on the five-sequence packing 1.17x slower); tanh comes
        // back below as the capped logit / cap2
        if (ring.cap2 > 0.f) {
          const float k2 = scale_log2 * inv_cap2;
#pragma unroll
          for (int i = 0; i < NS; ++i)
            sc[i] = ring.cap2 * tanh_fast(sc[i] * k2);
        } else {
#pragma unroll
          for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
        }
        auto logit = [&](int i, int row, int key, float& dc) {
          float x = sc[i];
          const float t = x * inv_cap2;  // 0 without softcap: dc = 1
          dc = 1.f - t * t;
          if (alibi) {
            float dist = (float)((qb + qsk * row) - akey[(i % 4) / 2]);
            if (ring.alibi_abs) dist = fabsf(dist);
            x -= slope * dist;
          }
          return x;
        };
        if (SEG && seg_masked) {
          // element 4 c + 2 r + e is q row qo + 8 c + 2 tq + e of the step,
          // held by lane qo / 2 + 4 c + tq; the pair e = 0, 1 is fragment
          // 2 c + r
#pragma unroll
          for (int c = 0; c < NS / 4; ++c) {
            int qsg[2], qps[2];
            rfa_seg::take(qv, qo / 2 + 4 * c + tq, 0, qsg[0], qps[0]);
            rfa_seg::take(qv, qo / 2 + 4 * c + tq, 1, qsg[1], qps[1]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float pe[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * c + 2 * r + e;
                const int col = 8 * c + 2 * tq + e;
                const int row = mq + col;
                const int key = nw + warp * 16 + g + r * 8;
                float dc;
                float x = logit(i, row, key, dc);
                if (ring.slopes && seg.q_pos) {
                  float dist = (float)(qps[e] - kpos[r]);
                  if (ring.alibi_abs) dist = fabsf(dist);
                  x -= slope * dist;
                }
                const bool out_ =
                    row >= Sq || key >= Skv ||
                    (causal && row + offset < key) ||
                    rfa_seg::drop<true>(seg, qsg[e], qps[e], kseg[r],
                                        kpos[r]);
                pe[e] = out_ ? 0.f : exp2f(x - l2s[col]);
                sc[i] = pe[e] * dc;
              }
              pa[(2 * c + r) / 4][(2 * c + r) % 4] =
                  rfa::pack_bf16(pe[0], pe[1]);
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < NS / 2; ++m) {
            float pe[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * m + e;
              const int col = (i / 4) * 8 + tq * 2 + i % 2;
              const int row = mq + col;
              const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
              float dc;
              float p = exp2f(logit(i, row, key, dc) - l2s[col]);
              if (edge) {
                if (row >= Sq || key >= Skv || (causal && row + offset < key))
                  p = 0.f;
              }
              pe[e] = p;
              sc[i] = p * dc;
            }
            pa[m / 4][m % 4] = rfa::pack_bf16(pe[0], pe[1]);
          }
        }
        if constexpr (SPLIT) {
          store_half_panel(pts, pa, qo, warp, g, tq);
        } else {
          hop::wgmma_fence();
          kv_accumulate<D>(dv_acc, pa, doh);  // dV += P^T dout
          hop::wgmma_commit();
        }
      } else {
        // XFORM recomputes the forward's softcap and ALiBi first (B2 and
        // B3b scale to base 2 ahead of them, and P below scales by 1; a
        // ring step's q arrives in base 2) and keeps the softcap's
        // derivative 1 - tanh^2 for dS
        float dcap[XFORM ? NS : 1];
        if constexpr (XFORM && !RING) {
          // the cap, then ALiBi by index, each a loop of its own under one
          // uniform branch
          const float slope = ring.slopes ? ring.slopes[h] : 0.f;
          if (ring.cap2 > 0.f) {
            const float k2 = scale_log2 * inv_cap2;
#pragma unroll
            for (int i = 0; i < NS; ++i) {
              const float t = tanh_fast(sc[i] * k2);
              sc[i] = ring.cap2 * t;
              dcap[i] = 1.f - t * t;
            }
          } else {
#pragma unroll
            for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
          }
          if (ring.slopes) {
#pragma unroll
            for (int i = 0; i < NS; ++i) {
              const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
              const int row = mq + (i / 4) * 8 + tq * 2 + i % 2;
              float dist = (float)((ring.q_pos0 + row) - key);
              if (ring.alibi_abs) dist = fabsf(dist);
              sc[i] -= slope * dist;
            }
          }
        }
        if constexpr (XFORM && RING) {
          // one uniform branch around the whole tile
          if (ring.cap2 > 0.f || ring.slopes) {
            const float slope = ring.slopes ? ring.slopes[h] : 0.f;
#pragma unroll
            for (int i = 0; i < NS; ++i) {
              float x = sc[i];
              dcap[i] = 1.f;
              if (ring.cap2 > 0.f) {
                const float t = tanhf(x * inv_cap2);
                x = ring.cap2 * t;
                dcap[i] = 1.f - t * t;
              }
              if (ring.slopes) {
                const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
                const int row = mq + (i / 4) * 8 + tq * 2 + i % 2;
                float dist =
                    (float)((ring.q_pos0 + row) - (ring.kv_pos0 + key));
                if (ring.alibi_abs) dist = fabsf(dist);
                x -= slope * dist;
              }
              sc[i] = x;
            }
          }
        }
        if (SEG && seg_masked) {
          // a loop of its own, so that the unmasked steps' code carries none
          // of it: element 4 c + 2 r + e is q row qo + 8 c + 2 tq + e of the
          // step, held by lane qo / 2 + 4 c + tq
#pragma unroll
          for (int c = 0; c < NS / 4; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int qs, qp;
              rfa_seg::take(qv, qo / 2 + 4 * c + tq, e, qs, qp);
              const int col = 8 * c + 2 * tq + e;
              const int row = mq + col;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * c + 2 * r + e;
                const int key = nw + warp * 16 + g + r * 8;
                const bool out_ = row >= Sq || key >= Skv ||
                                  (causal && row + offset < key) ||
                                  rfa_seg::drop(seg, qs, qp, kseg[r], kpos[r]);
                sc[i] = out_ ? 0.f : exp2f(sc[i] * scale_log2 - l2s[col]);
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int col = (i / 4) * 8 + tq * 2 + i % 2;
            float p = exp2f(sc[i] * (XFORM && !RING ? 1.f : scale_log2) -
                            l2s[col]);
            if (edge) {
              const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
              const int row = mq + col;
              if (row >= Sq || key >= Skv || (causal && row + offset < key))
                p = 0.f;
            }
            sc[i] = p;
          }
        }

        // dV += P^T dout (SPLIT: P^T to shared memory for it)
        hop::pack_fragments(pa, sc);
        if constexpr (SPLIT) {
          store_half_panel(pts, pa, qo, warp, g, tq);
        } else {
          hop::wgmma_fence();
          kv_accumulate<D>(dv_acc, pa, doh);
          hop::wgmma_commit();
        }
        if constexpr (XFORM) {
          if (ring.cap2 > 0.f) {
#pragma unroll
            for (int i = 0; i < NS; ++i) sc[i] *= dcap[i];  // p (1 - tanh^2)
          }
        }
      }

      // dS^T = P^T (dP^T - delta) * scale, in place of dP^T (BAND with
      // dropout: dP^T masked by the keep bits and scaled by 1 / (1 - p));
      // SPLIT issued no dV, so dP^T is the last group in flight
      if constexpr (SPLIT)
        hop::wgmma_wait<0>();
      else
        hop::wgmma_wait<1>();
      hop::fence_regs(dpt);
      if (BAND == rfa_band::ALL && band.thr) {
        const float ik = band.inv_keep;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float dp = (kbits >> i) & 1u ? dpt[i] * ik : 0.f;
          dpt[i] = sc[i] * (dp - dls[(i / 4) * 8 + tq * 2 + i % 2]) *
                   ds_scale;
        }
      } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        dpt[i] = sc[i] * (dpt[i] - dls[(i / 4) * 8 + tq * 2 + i % 2]) *
                 ds_scale;
      }
      uint32_t da[NS / 8][4];
      hop::pack_fragments(da, dpt);
      if constexpr (SPLIT) {
        // the warpgroup's half of dS^T beside its half of P^T; once both
        // warpgroups' halves are in, dV += P^T dout and dK += dS^T Q over
        // all 64 rows of the step, on the warpgroup's columns, both
        // operands from shared memory
        store_half_panel(dss, da, qo, warp, g, tq);
        hop::fence_proxy_async();
        hop::bar_sync(BAR_DS, KV_CONSUMERS);
        hop::wgmma_fence();
        kv_accumulate_ss<D>(dv_acc, pts, doh);  // dV += P^T dout
        hop::wgmma_commit();
        kv_accumulate_ss<D>(dk_acc, dss, qh);  // dK += dS^T Q
        hop::wgmma_commit();
        if constexpr (DQ) {
          // dQ = dS K over the block's 64 keys: warpgroup wg's columns [wg
          // D / 2, (wg + 1) D / 2), a 64-column panel of K at a time, each
          // staged in fp32 in the warpgroup's buffer, which its lead thread
          // adds into dq_acc by TMA reduce-adds (a writer warp for each
          // warpgroup, as at 128, ran B2 3 to 4% slower; staging panel 0
          // behind panel 1's and dK's products no faster: PERF.md). Element
          // 4 j + 2 r + c of a panel is q row 16 warp + g + 8 r, column 8 j
          // + 2 tq + c, in box column / 32, 16-byte chunk (column % 32) / 4
          // swizzled by row % 8
          char* dqs = smem + S::DQT + wg * S::DQ_BYTES;
          const bool lead = warp == 0 && lane == 0;
          auto stage = [&](const float(&dqa)[32], int pn, bool wait_read) {
            if (wait_read) {  // the buffer's last panel read
              if (lead) hop::bulk_wait_read<0>();
              hop::bar_sync(BAR_DQ_FULL + wg, 128);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int row = warp * 16 + g + r * 8;
                const int col = j * 8 + tq * 2;
                *reinterpret_cast<float2*>(
                    dqs + (col / 32) * KV_BM * 128 + row * 128 +
                    ((((col % 32) / 4) ^ (row % 8)) << 4) + (col % 4) * 4) =
                    make_float2(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
              }
            hop::fence_proxy_async();
            hop::bar_sync(BAR_DQ_FULL + wg, 128);
            if (lead) {
#pragma unroll
              for (int x = 0; x < 2; ++x)
                hop::tma_reduce_add_4d(&maps.dq, dqs + x * KV_BM * 128,
                                       wg * (D / 2) + 64 * pn + 32 * x, m0,
                                       h, b);
              hop::bulk_commit();
            }
          };
          float dqa[32];
#pragma unroll
          for (int pn = 0; pn < 2; ++pn) {
            hop::wgmma_fence();
            kv_dq_panel<D>(dqa, dss, ks + (wg * 2 + pn) * S::PANEL_KV);
            hop::wgmma_commit();
            if (pn == 0) {
              hop::wgmma_wait<2>();
              hop::mbar_arrive(&do_empty[sd]);  // dout is read (dV)
              hop::wgmma_wait<1>();
              hop::mbar_arrive(&empty[s]);  // Q is read (dK)
            }
            hop::wgmma_wait<0>();
            hop::fence_regs(dqa);
            stage(dqa, pn, it > 0 || pn > 0);
          }
        } else {
          hop::wgmma_wait<1>();
          hop::mbar_arrive(&do_empty[sd]);  // dout is read (dV)
          hop::wgmma_wait<0>();
          hop::mbar_arrive(&empty[s]);  // Q is read (dK)
        }
      } else {
        // head_dim 64 and 128
        if constexpr (DQ) {
          // dS^T to shared memory, [key][q row] in the swizzled panel layout
          // (fragment kc, register r: key row g + 8 (r % 2), q columns 16 kc
          // + 8 (r / 2) + 2 tq, i.e. 16-byte chunk 2 kc + r / 2)
#pragma unroll
          for (int kc = 0; kc < 4; ++kc)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int row = wg * 64 + warp * 16 + g + (r % 2) * 8;
              const int chunk = 2 * kc + r / 2;
              *reinterpret_cast<uint32_t*>(
                  dss + row * 128 + ((chunk ^ (row % 8)) << 4) + tq * 4) =
                  da[kc][r];
            }
        }

        // dK += dS^T Q
        hop::wgmma_fence();
        kv_accumulate<D>(dk_acc, da, qh);
        hop::wgmma_commit();

        if constexpr (DQ) {
          // dQ = dS K over all 128 keys; warpgroup wg takes head-dim columns
          // [wg D / 2, (wg + 1) D / 2). A is dS (M = q rows contiguous in the
          // stored dS^T: MN-major), B the K tile (N = head dim contiguous:
          // MN-major), both stepping 16 keys = 2048 bytes at a time.
          hop::fence_proxy_async();
          hop::bar_sync(BAR_DS, KV_CONSUMERS);
          constexpr int NQ = D / 4;  // fp32 of a 64 x D/2 accumulator
          float dqa[NQ];
          const char* kb = D == 128 ? ks + wg * S::PANEL_KV : ks + wg * 64;
          hop::wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < KV_BN / 16; ++kc) {
            const uint64_t da_ = hop::desc_sw128(dss + kc * 2048, 16);
            const uint64_t db_ = hop::desc_sw128(kb + kc * 2048, 16);
            if constexpr (D == 128)
              hop::wgmma_ss_n64<1, 1>(dqa, da_, db_, kc > 0);
            else
              hop::wgmma_ss_n32<1, 1>(dqa, da_, db_, kc > 0);
          }
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::mbar_arrive(&empty[s]);  // stage s is read
          hop::fence_regs(dqa);
          // the tile to dQ buffer it % 2 once the writer has read what it
          // held two steps ago; element (row, col) in box col / 32, 16-byte
          // chunk (col % 32) / 4 swizzled by row % 8
          const int buf = it & 1;
          char* dqs = smem + S::DQT + buf * S::DQ_BYTES;
          if (it >= 2) hop::bar_sync(BAR_DQ_EMPTY + buf, DQ_PARTIES);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < NQ / 4; ++j) {
              const int row = warp * 16 + g + r * 8;
              const int col = wg * (D / 2) + j * 8 + tq * 2;
              *reinterpret_cast<float2*>(
                  dqs + (col / 32) * KV_BM * 128 + row * 128 +
                  ((((col % 32) / 4) ^ (row % 8)) << 4) + (col % 4) * 4) =
                  make_float2(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
            }
          hop::fence_proxy_async();
          hop::bar_arrive(BAR_DQ_FULL + buf, DQ_PARTIES);
        } else {
          hop::wgmma_wait<0>();
          hop::mbar_arrive(&empty[s]);
        }
      }
    }
    if constexpr (DQ && SPLIT) {
      if (warp == 0 && lane == 0) hop::bulk_wait<0>();  // dQ's last adds
    }
    hop::fence_regs(dk_acc);
    hop::fence_regs(dv_acc);

    // dK, dV of this warpgroup's 64 keys, written once: accumulator element
    // 4 j + 2 r + c is key 16 warp + g + 8 r, column 8 j + 2 tq + c (SPLIT:
    // of the warpgroup's columns)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = nw + warp * 16 + g + r * 8;
      if (key >= Skv) continue;
      const long long base = ((long long)(b * Hkv + hk) * Skv + key) * D +
                             (SPLIT ? wg * (D / 2) : 0);
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const long long o = base + j * 8 + tq * 2;
        float2 ka = make_float2(dk_acc[4 * j + 2 * r],
                                dk_acc[4 * j + 2 * r + 1]);
        float2 va = make_float2(dv_acc[4 * j + 2 * r],
                                dv_acc[4 * j + 2 * r + 1]);
        if constexpr (BAND == rfa_band::ALL) {  // dV: the kept p unscaled
          va.x *= band.inv_keep;
          va.y *= band.inv_keep;
        }
        if constexpr (RING) {
          // this block is the only writer of its keys: a plain read, add
          // and write, in the same order every run
          if (ring.accumulate) {
            const float2 a = *reinterpret_cast<float2*>(
                static_cast<float*>(dk) + o);
            const float2 c = *reinterpret_cast<float2*>(
                static_cast<float*>(dv) + o);
            ka.x += a.x;
            ka.y += a.y;
            va.x += c.x;
            va.y += c.y;
          }
        }
        if (dkv_bf16) {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dk) + o) =
              rfa::pack_bf16(ka.x, ka.y);
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dv) + o) =
              rfa::pack_bf16(va.x, va.y);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(dk) + o) = ka;
          *reinterpret_cast<float2*>(static_cast<float*>(dv) + o) = va;
        }
      }
    }
  }
}

// strides: (b, h, s) of q, k, v and dout in elements, 16-byte multiples;
// the last dim contiguous and every base 16-byte aligned (TMA's terms).
template <int D, bool DQ, bool RING = false, bool SEG = false,
          bool XFORM = RING, int BAND = 0>
int launch_kv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq_acc, void* dk,
              void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
              const long long* strides, float scale, int causal, int offset,
              int dkv_bf16, cudaStream_t stream, const Ring& ring = Ring{},
              const rfa_seg_args& seg = rfa_seg_args{},
              const rfa_band_args& band = rfa_band_args{}) {
  auto kern = bwd_kv_kernel<D, DQ, RING, SEG, XFORM, BAND>;
  using Sm = KvSmem<D, DQ, BAND>;
  constexpr int KV_BN = Sm::KV_BN;
  // SEG: the q steps' classes past the barriers
  const int bytes = Sm::BYTES + (SEG ? rfa_seg::class_bytes(seg.n_q) : 0);
  if (bytes > rfa_seg::MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SEG ? rfa_seg::MAX_SMEM : Sm::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  Maps maps = {};
  int e = hop_host::tmap_4d(&maps.q, q, false, B, Hq, Sq, D, strides, 64,
                            KV_BM);
  if (!e) e = hop_host::tmap_4d(&maps.k, k, false, B, Hkv, Skv, D,
                                strides + 3, 64, KV_BN);
  if (!e) e = hop_host::tmap_4d(&maps.v, v, false, B, Hkv, Skv, D,
                                strides + 6, 64, KV_BN);
  if (!e) e = hop_host::tmap_4d(&maps.o, dout, false, B, Hq, Sq, D,
                                strides + 9, 64, KV_BM);
  if (DQ && !e) {
    const long long dq_st[3] = {(long long)Hq * Sq * D, (long long)Sq * D, D};
    e = hop_host::tmap_4d(&maps.dq, dq_acc, true, B, Hq, Sq, D, dq_st, 32,
                          KV_BM);
  }
  if (e) return e;
  const int tiles = (Skv + KV_BN - 1) / KV_BN;
  if (tiles > 65535) return cudaErrorInvalidValue;  // gridDim.y's limit
  dim3 grid(B * Hkv, tiles);
  kern<<<grid, KV_THREADS, bytes, stream>>>(
      maps, lse, delta, dk, dv, Hq, Hkv, Sq, Skv, scale, causal, offset,
      dkv_bf16, ring, seg, band, dq_acc);
  return cudaGetLastError();
}

}  // namespace rfa_bwd
