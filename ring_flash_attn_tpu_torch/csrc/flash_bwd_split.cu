// Kernels B3a and B3b: the split flash-attention backward.
//
// Replace the TPU kernels ring_flash_attn_tpu/ops/pallas_bwd.py::_dq_kernel
// (B3a, wrapper _dq) and ::_dkv_kernel (B3b, wrapper _dkv), which
// pallas_block_bwd runs when the fused kernel's resident dk/dv would not
// fit the TPU's VMEM budget (fused_bwd_supported) or when the caller asks
// for them. Same mask model and contract as B2 (csrc/flash_bwd.cu).
//
// What bounds them on the H100: tensor-core operations, as B2. The split
// recomputes p and dp in both kernels: B3a does 3 products per allowed
// (q, k) pair and head (s, dp, dq), B3b does 4 (s^T, dv, dp^T, dk); 7 of
// 2 * D flops per pair where B2 does 5, the JAX design's cost too. In
// exchange neither kernel uses atomics or reduce-adds: each output element
// is summed by one warpgroup in a fixed order and written once, so the
// results are bitwise reproducible from run to run (which is why
// deterministic calls take them).
//
//  - B3a: the q-major dq loop, built from the forward loop's pieces
//    (csrc/flash_fwd.cuh). One block per (batch, q head, 128-row q tile),
//    launched tile-major across heads ((batch, head) in blockIdx.x, the q
//    heads of one kv head adjacent so that their K/V tiles come from L2;
//    the q tile in y, heaviest causal tile first). Two consumer warpgroups
//    own 64 q rows each; a producer warpgroup's one thread loads Q and dout
//    once by TMA, then 64-key K and V tiles into a two-stage ring, K and V
//    under mbarrier full/empty pairs of their own (setmaxnreg 240/24).
//    Per kv tile, on wgmma:
//      S  = Q K^T, dP = dout V^T  (64 x 64 fp32 each, both operands from
//                                  shared memory, K-major)
//      dS = P (dP - delta) * scale, P = exp2(S * scale * log2 e - lse2)
//      dQ += dS K                  (dS packed to bf16 from the accumulator
//                                   as the A fragments, K read MN-major:
//                                   the forward's P V with K for V)
//    dQ (64 x D fp32) stays in registers and is written once, in fp32 or
//    bf16. A tile's dQ product runs on while the next tile's S and dP are
//    issued, P runs while dP does; V is free once dP is computed, K once dQ
//    is. The kv loop stops at the causal bound of the tile's last row; only
//    the diagonal and the ragged edge are masked. A q tile that sees no key
//    loads nothing and writes zeros. Measured at q (1, 32, 8192, 128), kv
//    (1, 8, 8192, 128) causal (profile_torch_bwd.py, NVIDIA H100 80GB
//    HBM3, 700 W, in turns): 1.57 to 1.76 ms, about 500 TFLOP/s of its 3
//    products; the first port of this kernel (mma.sync, 64-row q tiles,
//    cp.async, heads in blockIdx.y) 3.40 to 3.75. Issuing tile j + 1's S
//    and dP before tile j's dS math (a second S/dP register set, K and V in
//    three stages) ran 2.0 to 2.6 ms: ptxas serialised the wgmma (C7514,
//    and C7512, too few registers, once every wait was static). PERF.md
//    has each step.
//  - B3b: the kv-major loop of B2 (csrc/flash_bwd.cuh) without dq, its
//    fourth product or its writer warp: one block per (batch, kv head,
//    128-key tile) walks the GQA group's q heads and 64-row q tiles, Q and
//    dout fed by TMA, the products on wgmma, and keeps dk and dv in
//    registers, written once and summed over the group. Measured at q (1,
//    32, 8192, 128), kv (1, 8, 8192, 128) causal (profile_torch_bwd.py,
//    NVIDIA H100 80GB HBM3, 700 W): 2.16 to 2.28 ms, about 500 TFLOP/s of
//    its 4 products and faster than SDPA's whole backward; the mma.sync
//    loop before it 6.07 to 6.50 ms.
//
// At head_dim 256 (Gemma; every build) B3a takes 64-row q tiles, which both
// consumer warpgroups share: each computes S and dP over the whole head dim
// (done twice) and owns half of dQ's columns, so each makes the same P and
// dS from the same logits, rows and keys, softcap, ALiBi, window and
// dropout bits included; B3b is the kv-major loop's 64-key build
// (csrc/flash_bwd.cuh).
//
// Packed sequences (csrc/segments.cuh) are compiled apart (SEG): B3a walks
// the kv tiles [q_meta[4], q_meta[5]] of its q tile and B3b the q steps
// [kv_meta[4], kv_meta[5]] of its kv tile, each skipping the tiles whose
// segments or positions cannot meet and masking those that straddle an
// edge, exactly as the forward applied the mask.
//
// Softcap and ALiBi (csrc/xform.cuh) are compiled apart too (XFORM): B3a
// scales its logits to base 2, caps them, takes ALiBi from the index and
// the offsets (or, SEG, from the explicit positions: its rows' own, and a kv
// tile's first position and step where it has one, else the masked
// body's) and masks, as the forward did; P, which
// B3a needs only for dS, is stored already times the softcap's 1 - tanh^2,
// so that the transform costs no register array. B3b is the kv-major
// loop's XFORM instantiation (csrc/flash_bwd.cuh).
//
// Windows and dropout (csrc/band.cuh) are compiled apart as well (BAND,
// always with XFORM): B3a narrows its kv tiles to the window's band where
// the positions are the index and masks the tiles that cross a band edge
// (with SEG and explicit positions the classes take the band); its rows'
// dropout hashes are made once, the keep bits of a thread's 32 elements
// of a tile wait in one register for dS, which masks and scales dP and
// takes the undropped p. B3b is the kv-major loop's BAND instantiation.

#include "flash_bwd.cuh"

namespace {

using rfa_bwd::bf16;
using rfa_bwd::LOG2E;

// q rows per block: 128, 64 per consumer warpgroup; at head_dim 256, 64,
// which both consumer warpgroups share, each owning half of dQ's columns
// (Q, dout and two stages of K and V tiles then take 192 KB of the 227 a
// block has, and dQ 64 fp32 a thread)
template <int D>
constexpr int dq_rows = D > 128 ? 64 : 128;
constexpr int BN = 64;   // keys per tile
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int NTHREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int STAGES = 2;

// Byte offsets from a 1024-aligned base; bf16 tiles in 128B-swizzled panels
// of 64 columns.
template <int D>
struct DqSmem {
  static constexpr int BM = dq_rows<D>;
  static constexpr int PANEL_Q = BM * 128;  // a 64-column panel of Q or dout
  static constexpr int PANEL_KV = BN * 128;  // of a K or V tile
  static constexpr int TILE_KV = BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + BM * D * 2;
  static constexpr int KV = DO + BM * D * 2;  // stage s: K at KV + 2 s
                                              // TILE_KV, then V
  static constexpr int BAR = KV + STAGES * 2 * TILE_KV;
  // mbarriers: q, full_k[STAGES], full_v[STAGES], empty_k[STAGES],
  // empty_v[STAGES]
  static constexpr int BYTES = BAR + (1 + 4 * STAGES) * 8 + 1024;
};

// TMA maps of q and dout (boxes of 64 columns by BM rows) and of k and v
// (64 columns by BN rows).
struct DqMaps {
  CUtensorMap q, k, v, o;
};

// S = A B^T for one warpgroup: 64 rows of A (the Q or dout tile) x the 64
// keys of B (the K or V tile), both K-major over the head dim.
template <int D>
__device__ __forceinline__ void dq_scores(float (&acc)[32], const char* a,
                                          const char* bt) {
  using S = DqSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ko = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel
    hop::wgmma_ss_n64<0, 0>(
        acc, hop::desc_sw128(a + (kk / 4) * S::PANEL_Q + ko, 16),
        hop::desc_sw128(bt + (kk / 4) * S::PANEL_KV + ko, 16), kk > 0);
  }
}

template <int D, bool SEG = false, bool XFORM = false, int BAND = 0>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_dq_kernel(const __grid_constant__ DqMaps maps,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
              float scale, int causal, int offset, int dq_bf16,
              const __grid_constant__ rfa_seg_args seg,
              const rfa_xform_args xf, const rfa_band_args band) {
  static_assert(!BAND || XFORM, "BAND comes with XFORM");
  using S = DqSmem<D>;
  constexpr int BM = dq_rows<D>;
  // head_dim 256: both warpgroups take the same 64 rows, warpgroup wg dQ's
  // columns [wg D / 2, (wg + 1) D / 2)
  constexpr bool SPLIT = D > 128;
  // fp32 of a 64 x D (SPLIT: 64 x D / 2) accumulator a thread holds
  constexpr int NQ = SPLIT ? D / 4 : D / 2;
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
  // BAND with positions by index: the window's kv tiles [k_lo, k_hi);
  // without SEG the walk counts n_tiles from k_lo
  int k_lo = 0;
  if constexpr (BAND) {
    if (!(SEG && seg.q_pos)) {
      int k_hi;
      rfa_band::index_tiles(band, m0, BM, xf.pos_off, BN, n_tiles, true,
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
  char* dos = smem + S::DO;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  auto ks = [&](int s) { return smem + S::KV + s * 2 * S::TILE_KV; };
  auto vs = [&](int s) { return ks(s) + S::TILE_KV; };

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
          (xf.slopes || (BAND == rfa_band::ALL && band.thr)))
        rfa_seg::keep_affine<NTHREADS>(seg_bits, seg.kv_step + t_lo,
                                       t_hi - t_lo + 1);
    }
  }

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the tiles in flight by TMA; a block
    // with no kv tile loads nothing ----
    hop::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
      hop::mbar_arrive_tx(q_bar, 2 * BM * D * 2);
      for (int p = 0; p < D / 64; ++p) {
        hop::tma_load_4d(qs + p * S::PANEL_Q, &maps.q, q_bar, 64 * p, m0, h,
                         b);
        hop::tma_load_4d(dos + p * S::PANEL_Q, &maps.o, q_bar, 64 * p, m0, h,
                         b);
      }
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
  const int mw = m0 + (SPLIT ? 0 : 64 * wg);
  // accumulator element i of S or dP (64 rows x 64 keys) or dQ (64 rows x
  // D) is row r_lo + 8 ((i % 4) / 2) and column 8 (i / 4) + 2 tq + i % 2
  const int r_lo = mw + 16 * warp + g;
  // this warpgroup's rows of a panel
  const char* qa = qs + (SPLIT ? 0 : wg * 64 * 128);
  const char* doa = dos + (SPLIT ? 0 : wg * 64 * 128);
  const float scale_log2 = scale * LOG2E;
  // XFORM: this head's ALiBi slope and the cap's reciprocal (base 2)
  float slope = 0.f, inv_cap2 = 0.f;
  if constexpr (XFORM) {
    if (xf.slopes) slope = xf.slopes[h];
    if (xf.cap2 > 0.f) inv_cap2 = 1.f / xf.cap2;
  }

  float dqa[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) dqa[i] = 0.f;

  if (n_tiles > 0) {
    // lse2 (clamped: a dead row's p underflows to 0 or is masked) and
    // delta of rows r_lo and r_lo + 8; rows past Sq read zero Q and dout
    // and get dS = 0
    float l2[2], dl[2];
    int qseg[2] = {0, 0}, qpos[2] = {0, 0};  // SEG
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      l2[r] = dl[r] = 0.f;
      if (row < Sq) {
        const long long idx = (long long)(b * Hq + h) * Sq + row;
        l2[r] = fmaxf(lse[idx], RFA_NEG_INF / 2) * LOG2E;
        dl[r] = delta[idx];
        if constexpr (SEG) {
          if (seg.q_seg) qseg[r] = __ldg(seg.q_seg + row);
          if (seg.q_pos) qpos[r] = __ldg(seg.q_pos + row);
        }
      }
    }
    // XFORM: ALiBi's distance is arow[r] - (kb + ks col) on every tile it
    // applies to: arow the row's position (explicit, or the index plus the
    // offset), kb and ks the tile's keys' (0 and 1 by index)
    int arow[2] = {0, 0};
    if constexpr (XFORM) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        arow[r] = SEG && seg.q_pos ? qpos[r] : xf.pos_off + r_lo + 8 * r;
    }
    // BAND with dropout: the hashes of this thread's rows
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
    hop::mbar_wait(q_bar, 0);

    // tile j: issue S and dP; P while dP runs; dS; issue dQ += dS K and go
    // on to tile j + 1 without waiting for it: the wait for tile j + 1's S
    // (committed after it) covers it, and K of tile j is freed there
    uint32_t da[4][4];
    int t = k_lo;  // SEG: the live kv tile of step j
    if constexpr (SEG) t = next_live(t_lo);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      const int n0 = (SEG ? t : k_lo + j) * BN;
      const bool seg_masked = SEG && tile_class(t) == 1;
      if constexpr (SEG) t = next_live(t + 1);
      // SEG: the lane's share of the masked tile's keys n0 + 2 lane +
      // {0, 1}, loaded before the products are waited for
      rfa_seg::Pair kv{};
      if (SEG && seg_masked)
        kv = rfa_seg::load_pair(seg.kv_seg, seg.kv_pos, n0 + 2 * lane, Skv);
      // XFORM: the tile's kb and ks (on explicit positions, an unmasked
      // tile's keys sit at kp0 + ksk (col - n0); a masked tile's ALiBi is
      // the masked body's)
      int kb = 0, ksk = 1;
      bool alibi = false;
      if constexpr (XFORM) {
        alibi = xf.slopes && !(SEG && seg.q_pos && seg_masked);
        if (SEG && seg.q_pos &&
            (alibi ||
             (BAND == rfa_band::ALL && band.thr && !seg_masked))) {
          ksk = __ldg(seg.kv_step + n0 / BN);
          kb = __ldg(seg.kv_pos + n0) - ksk * n0;
        }
      }
      float sc[32], dp[32];
      hop::mbar_wait(&full_k[s], ph);
      hop::mbar_wait(&full_v[s], ph);
      hop::wgmma_fence();
      dq_scores<D>(sc, qa, ks(s));
      hop::wgmma_commit();
      dq_scores<D>(dp, doa, vs(s));
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      hop::fence_regs(dqa);
      if (j > 0) hop::mbar_arrive(&empty_k[(j - 1) % STAGES]);

      // XFORM: logit i in base 2 through softcap and ALiBi (one formula
      // for every tile it applies to: an extra branch for the explicit
      // positions' case ran B3a with softcap on the five-sequence packing
      // 1.2x slower), and in dc the softcap's 1 - tanh^2, folded into P
      // where P is made
      if constexpr (XFORM) {
        // the logits in base 2, capped, in place: a loop of their own under
        // one uniform branch; tanh comes back below as capped logit / cap2
        if (xf.cap2 > 0.f) {
          const float k2 = scale_log2 * inv_cap2;
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = xf.cap2 * tanh_fast(sc[i] * k2);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
        }
      }
      auto transform = [&](int i, float& dc) {
        float x = sc[i];
        const float t = x * inv_cap2;  // 0 without softcap: dc = 1
        dc = 1.f - t * t;
        if (alibi) {
          const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
          float dist = (float)(arow[(i % 4) / 2] - (kb + ksk * col));
          if (xf.alibi_abs) dist = fabsf(dist);
          x -= slope * dist;
        }
        return x;
      };

      // P; zero past the ragged key edge and the causal diagonal (and,
      // SEG, outside the segments and the positions' diagonal)
      const bool edge =
          n0 + BN > Skv || (causal && n0 + BN - 1 > mw + offset);
      uint32_t kbits = ~0u;  // BAND: the keep bits of the 32 elements
      // BAND: a tile crosses a band edge by index where some pair of this
      // warpgroup's rows lies outside it
      bool win = false;
      if constexpr (BAND) {
        const long long d_hi = (long long)mw + 63 - n0 + xf.pos_off;
        const long long d_lo = (long long)mw - (n0 + BN - 1) + xf.pos_off;
        win = !(SEG && seg.q_pos) && (d_hi > band.wl || d_lo < -band.wr);
      }
      if constexpr (BAND == rfa_band::WINDOW) {
        // a window alone (the launcher sends dropout, softcap and ALiBi to
        // the ALL build): the mask-free body's P (the logits already in
        // base 2), with the band's test on the tiles that cross an edge,
        // and on a tile masked by segments or positions the segmented
        // body's, with the band on the explicit positions
        if (SEG && seg_masked) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int ks, kp;
              rfa_seg::take(kv, 4 * c + tq, e, ks, kp);
              const int col = n0 + 8 * c + 2 * tq + e;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * c + 2 * r + e;
                const int row = r_lo + 8 * r;
                const int d = seg.q_pos ? rfa_band::diff(qpos[r], kp)
                                        : row - col + xf.pos_off;
                const bool out_ = col >= Skv ||
                                  (causal && row + offset < col) ||
                                  rfa_seg::drop<true>(seg, qseg[r], qpos[r],
                                                      ks, kp) ||
                                  rfa_band::outside(band, d);
                sc[i] = out_ ? 0.f : exp2f(sc[i] - l2[r]);
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i % 4) / 2;
            float p = exp2f(sc[i] - l2[r]);
            if (edge || win) {
              const int row = r_lo + 8 * r;
              const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
              if (col >= Skv || (causal && row + offset < col) ||
                  (win && rfa_band::outside(band, row - col + xf.pos_off)))
                p = 0.f;
            }
            sc[i] = p;
          }
        }
      } else if constexpr (BAND) {
        // the window, on the explicit positions in the masked body, else
        // on the index, and dropout's keep bits; sc keeps the undropped p
        const bool idx_pos = !(SEG && seg.q_pos);
        const bool drop = BAND == rfa_band::ALL && band.thr != 0;
        if (SEG && seg_masked) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int ks, kp;
              rfa_seg::take(kv, 4 * c + tq, e, ks, kp);
              const int col = n0 + 8 * c + 2 * tq + e;
              const uint32_t kh =
                  (idx_pos ? band.kv_pos0 + (uint32_t)col : (uint32_t)kp) *
                  rfa_band::H_K;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * c + 2 * r + e;
                const int row = r_lo + 8 * r;
                const int d = idx_pos ? row - col + xf.pos_off
                                      : rfa_band::diff(qpos[r], kp);
                const bool out_ = col >= Skv ||
                                  (causal && row + offset < col) ||
                                  rfa_seg::drop<true>(seg, qseg[r], qpos[r],
                                                      ks, kp) ||
                                  rfa_band::outside(band, d);
                float dc;
                float x = transform(i, dc);
                if (xf.slopes && seg.q_pos) {
                  float dist = (float)(qpos[r] - kp);
                  if (xf.alibi_abs) dist = fabsf(dist);
                  x -= slope * dist;
                }
                sc[i] = out_ ? 0.f : exp2f(x - l2[r]) * dc;
                if (drop && !rfa_band::keep(rh[r], kh, band.thr))
                  kbits &= ~(1u << i);
              }
            }
          }
        } else {
          const bool edge_b = edge || win;
          // the keys' positions: the index plus kv_pos0, or an unmasked
          // tile's kb + ksk col
          const uint32_t kb0 = idx_pos ? band.kv_pos0 : (uint32_t)kb;
          const uint32_t kst = idx_pos ? 1u : (uint32_t)ksk;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i % 4) / 2;
            const int row = r_lo + 8 * r;
            const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
            float dc;
            float p = exp2f(transform(i, dc) - l2[r]) * dc;
            if (edge_b) {
              if (col >= Skv || (causal && row + offset < col) ||
                  (win && rfa_band::outside(band, row - col + xf.pos_off)))
                p = 0.f;
            }
            sc[i] = p;
            if (drop && !rfa_band::keep(rh[r],
                                        (kb0 + kst * (uint32_t)col) *
                                            rfa_band::H_K,
                                        band.thr))
              kbits &= ~(1u << i);
          }
        }
      } else if (SEG && seg_masked) {
        // a loop of its own, so that the unmasked tiles' code carries none
        // of it: element 4 c + 2 r + e is key 8 c + 2 tq + e, held by lane
        // 4 c + tq
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int ks, kp;
            rfa_seg::take(kv, 4 * c + tq, e, ks, kp);
            const int col = n0 + 8 * c + 2 * tq + e;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * c + 2 * r + e;
              const bool out_ = col >= Skv ||
                                (causal && r_lo + 8 * r + offset < col) ||
                                rfa_seg::drop<XFORM>(seg, qseg[r], qpos[r],
                                                     ks, kp);
              if constexpr (XFORM) {
                float dc;
                float x = transform(i, dc);
                if (xf.slopes && seg.q_pos) {
                  float dist = (float)(qpos[r] - kp);
                  if (xf.alibi_abs) dist = fabsf(dist);
                  x -= slope * dist;
                }
                sc[i] = out_ ? 0.f : exp2f(x - l2[r]) * dc;
              } else {
                sc[i] = out_ ? 0.f : exp2f(sc[i] * scale_log2 - l2[r]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i % 4) / 2;
          float p;
          if constexpr (XFORM) {
            float dc;
            p = exp2f(transform(i, dc) - l2[r]) * dc;
          } else {
            p = exp2f(sc[i] * scale_log2 - l2[r]);
          }
          if (edge) {
            const int row = r_lo + 8 * r;
            const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
            if (col >= Skv || (causal && row + offset < col)) p = 0.f;
          }
          sc[i] = p;
        }
      }

      // dS = P (dP - delta) * scale, in place of dP
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
      hop::mbar_arrive(&empty_v[s]);  // V of stage s is read
      if (BAND == rfa_band::ALL && band.thr) {
        // dropout: dP masked by the keep bits and scaled by 1 / (1 - p)
        const float ik = band.inv_keep;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float d = (kbits >> i) & 1u ? dp[i] * ik : 0.f;
          dp[i] = sc[i] * (d - dl[(i % 4) / 2]) * scale;
        }
      } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = sc[i] * (dp[i] - dl[(i % 4) / 2]) * scale;
      }
      hop::pack_fragments(da, dp);

      // dQ += dS K: K MN-major (its rows, the keys, are the reduction),
      // stepping 16 keys = 2048 bytes
      hop::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t db = hop::desc_sw128(ks(s) + kc * 2048, S::PANEL_KV);
        if constexpr (SPLIT)  // the warpgroup's two panels of K
          hop::wgmma_rs_n128<1>(
              dqa, da[kc],
              hop::desc_sw128(ks(s) + wg * 2 * S::PANEL_KV + kc * 2048,
                              S::PANEL_KV),
              1);
        else if constexpr (D == 128)
          hop::wgmma_rs_n128<1>(dqa, da[kc], db, 1);
        else
          hop::wgmma_rs_n64<1>(dqa, da[kc], db, 1);
      }
      hop::wgmma_commit();
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(dqa);
  }

  // dQ of this warpgroup's rows, written once (zeros where no key was
  // seen): element 4 i + 2 r + c is row r_lo + 8 r, column 8 i + 2 tq + c
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    const long long orow = ((long long)(b * Hq + h) * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < NQ / 4; ++i) {
      const int col = (SPLIT ? wg * (D / 2) : 0) + i * 8 + tq * 2;
      const float x0 = dqa[4 * i + 2 * r], x1 = dqa[4 * i + 2 * r + 1];
      if (dq_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dq) + orow + col) =
            rfa::pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + orow + col) =
            make_float2(x0, x1);
      }
    }
  }
}

// strides: (b, h, s) of q, k, v and dout in elements, 16-byte multiples;
// the last dim contiguous and every base 16-byte aligned (TMA's terms).
template <int D, bool SEG = false, bool XFORM = false, int BAND = 0>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, const long long* strides, float scale,
              int causal, int offset, int dq_bf16, cudaStream_t stream,
              const rfa_seg_args& seg = rfa_seg_args{},
              const rfa_xform_args& xf = rfa_xform_args{},
              const rfa_band_args& band = rfa_band_args{}) {
  auto kern = bwd_dq_kernel<D, SEG, XFORM, BAND>;
  constexpr int BM = dq_rows<D>;
  // SEG: the kv tiles' classes past the barriers
  const int bytes =
      DqSmem<D>::BYTES + (SEG ? rfa_seg::class_bytes(seg.n_kv) : 0);
  if (bytes > rfa_seg::MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SEG ? rfa_seg::MAX_SMEM : DqSmem<D>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int tiles = (Sq + BM - 1) / BM;
  if (tiles > 65535) return cudaErrorInvalidValue;  // gridDim.y's limit
  DqMaps maps = {};
  int e = hop_host::tmap_4d(&maps.q, q, false, B, Hq, Sq, D, strides, 64,
                            BM);
  if (!e) e = hop_host::tmap_4d(&maps.k, k, false, B, Hkv, Skv, D,
                                strides + 3, 64, BN);
  if (!e) e = hop_host::tmap_4d(&maps.v, v, false, B, Hkv, Skv, D,
                                strides + 6, 64, BN);
  if (!e) e = hop_host::tmap_4d(&maps.o, dout, false, B, Hq, Sq, D,
                                strides + 9, 64, BM);
  if (e) return e;
  dim3 grid(B * Hq, tiles);
  kern<<<grid, NTHREADS, bytes, stream>>>(maps, lse, delta, dq, Hq, Hkv, Sq,
                                          Skv, scale, causal, offset,
                                          dq_bf16, seg, xf, band);
  return cudaGetLastError();
}

}  // namespace

// B3a. strides: q, k, v, dout (b, h, s) in elements; returns
// cudaGetLastError(). dq (B, Hq, Sq, D) fp32, or bf16 with dq_bf16.
extern "C" int rfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int Hq,
                                int Hkv, int Sq, int Skv, int D,
                                const long long* strides, float scale,
                                int causal, int offset, int dq_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rfa::by_head_dim(D, [&](auto d) {
    return launch_dq<decltype(d)::value>(q, k, v, dout, lse, delta, dq, B,
                                         Hq, Hkv, Sq, Skv, strides, scale,
                                         causal, offset, dq_bf16, st);
  });
}

// B3b. Same arguments as rfa_flash_bwd without dq.
extern "C" int rfa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int B, int Hq, int Hkv, int Sq, int Skv,
                                 int D, const long long* strides, float scale,
                                 int causal, int offset, int dkv_bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rfa::by_head_dim(D, [&](auto d) {
    return rfa_bwd::launch_kv<decltype(d)::value, false>(
        q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, Sq, Skv,
        strides, scale, causal, offset, dkv_bf16, st);
  });
}

// B3a and B3b on packed sequences (csrc/segments.cuh), compiled apart:
// arguments as above with the segment ids, positions and tile bounds of
// `seg` (B3a's at 128 q rows and 64 keys a tile, B3b's at 64 q rows a step
// and 128 keys a block; at head_dim 256, 64 q rows a tile and 64 keys a
// block). `causal` is the causal mask by index; a mask
// causal by positions passes causal = 0 and seg->q_pos.
extern "C" int rfa_flash_bwd_dq_seg(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, int B, int Hq, int Hkv, int Sq,
                                    int Skv, int D, const long long* strides,
                                    float scale, int causal, int offset,
                                    int dq_bf16, const rfa_seg_args* seg,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rfa::by_head_dim(D, [&](auto d) {
    return launch_dq<decltype(d)::value, true>(
        q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, strides, scale,
        causal, offset, dq_bf16, st, *seg);
  });
}

extern "C" int rfa_flash_bwd_dkv_seg(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int D,
                                     const long long* strides, float scale,
                                     int causal, int offset, int dkv_bf16,
                                     const rfa_seg_args* seg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rfa::by_head_dim(D, [&](auto d) {
    return rfa_bwd::launch_kv<decltype(d)::value, false, false, true>(
        q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, Sq, Skv,
        strides, scale, causal, offset, dkv_bf16, st, rfa_bwd::Ring{}, *seg);
  });
}

// B3a and B3b with softcap or ALiBi (csrc/xform.cuh): as rfa_flash_bwd_dq
// and rfa_flash_bwd_dkv, or with a non-null `seg` as their segmented forms,
// with the transform of `xf`. Compiled apart from the instantiations
// without it.
extern "C" int rfa_flash_bwd_dq_xf(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, const long long* strides,
                                   float scale, int causal, int offset,
                                   int dq_bf16, const rfa_seg_args* seg,
                                   const rfa_xform_args* xf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, strides,
              scale, causal, offset, dq_bf16, st, sg, *xf, rfa_band_args{});
  };
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    return seg ? go(launch_dq<HD, true, true>, *seg)
               : go(launch_dq<HD, false, true>, none);
  });
}

extern "C" int rfa_flash_bwd_dkv_xf(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    const long long* strides, float scale,
                                    int causal, int offset, int dkv_bf16,
                                    const rfa_seg_args* seg,
                                    const rfa_xform_args* xf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_bwd::Ring ring{xf->slopes, xf->cap2, xf->pos_off, 0,
                           xf->alibi_abs, 0};
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, Sq, Skv,
              strides, scale, causal, offset, dkv_bf16, st, ring, sg,
              rfa_band_args{});
  };
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    return seg ? go(rfa_bwd::launch_kv<HD, false, false, true, true>, *seg)
               : go(rfa_bwd::launch_kv<HD, false, false, false, true>, none);
  });
}

// B3a and B3b with a window or dropout (csrc/band.cuh): as their _xf forms,
// with the window and dropout of `bd`. Compiled apart from the
// instantiations without it.
extern "C" int rfa_flash_bwd_dq_band(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int B, int Hq, int Hkv,
                                     int Sq, int Skv, int D,
                                     const long long* strides, float scale,
                                     int causal, int offset, int dq_bf16,
                                     const rfa_seg_args* seg,
                                     const rfa_xform_args* xf,
                                     const rfa_band_args* bd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, strides,
              scale, causal, offset, dq_bf16, st, sg, *xf, *bd);
  };
  // the build of a window alone, or the one for the rest (csrc/band.cuh)
  constexpr int W = rfa_band::WINDOW, A = rfa_band::ALL;
  const bool all = bd->thr != 0 || xf->cap2 > 0.f || xf->slopes;
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    if (seg)
      return all ? go(launch_dq<HD, true, true, A>, *seg)
                 : go(launch_dq<HD, true, true, W>, *seg);
    return all ? go(launch_dq<HD, false, true, A>, none)
               : go(launch_dq<HD, false, true, W>, none);
  });
}

extern "C" int rfa_flash_bwd_dkv_band(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      const long long* strides, float scale,
                                      int causal, int offset, int dkv_bf16,
                                      const rfa_seg_args* seg,
                                      const rfa_xform_args* xf,
                                      const rfa_band_args* bd,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_bwd::Ring ring{xf->slopes, xf->cap2, xf->pos_off, 0,
                           xf->alibi_abs, 0};
  const rfa_seg_args none{};
  auto go = [&](auto fn, const rfa_seg_args& sg) {
    return fn(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, Sq,
              Skv, strides, scale, causal, offset, dkv_bf16, st, ring, sg,
              *bd);
  };
  // the build of a window alone, or the one for the rest (csrc/band.cuh)
  constexpr int W = rfa_band::WINDOW, A = rfa_band::ALL;
  const bool all = bd->thr != 0 || xf->cap2 > 0.f || xf->slopes;
  return rfa::by_head_dim(D, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    if (seg)
      return all
          ? go(rfa_bwd::launch_kv<HD, false, false, true, true, A>, *seg)
          : go(rfa_bwd::launch_kv<HD, false, false, true, true, W>, *seg);
    return all
        ? go(rfa_bwd::launch_kv<HD, false, false, false, true, A>, none)
        : go(rfa_bwd::launch_kv<HD, false, false, false, true, W>, none);
  });
}
