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
// 15.67), diagonal 3.36 to 3.51 (8.47 to 8.82). What each step of the
// design gave is in PERF.md.
//
// With RING (kernel B8) the same loop is one step of the fused ring
// backward: q arrives pre-scaled by scale * log2 e, v pre-scaled by scale,
// lse in base 2 and clamped, delta times scale, so no scale is applied
// here; softcap and ALiBi are recomputed as the forward applied them (with
// the 1 - tanh^2 factor on dS); dq adds into the rank's accumulator, which
// the launcher does not zero, and dk, dv add into the travelling fp32
// accumulators instead of being written. Without RING all of that compiles
// out.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rfa_bwd {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// kv-major loop (B2 with DQ, B3b without, B8 with DQ and RING)

// What a ring step adds to a block call (B8).
struct Ring {
  const float* slopes;  // (Hq,) ALiBi slopes * log2(e), or null
  float cap2;           // softcap * log2(e); 0 = no capping
  int q_pos0, kv_pos0;  // global positions of q row 0 and of key 0
  int alibi_abs;        // ALiBi on |distance| (a ring without causal mask)
  int accumulate;       // dk, dv: add to what is there (else write)
};

constexpr int KV_BN = 128;  // keys per block, 64 per consumer warpgroup
constexpr int KV_BM = 64;   // q rows per step
constexpr int KV_CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int KV_THREADS = KV_CONSUMERS + 128;  // + the producer warpgroup
constexpr int KV_STAGES = 2;

// Byte offsets from a 1024-aligned base; bf16 tiles in 128B-swizzled panels
// of 64 columns, the fp32 dQ tile in 128B-swizzled boxes of 32 columns.
template <int D, bool DQ = false>
struct KvSmem {
  static constexpr int PANEL_KV = KV_BN * 128;  // one 64-column panel of K
  static constexpr int PANEL_Q = KV_BM * 128;   // of a Q or dout tile
  static constexpr int K = 0;
  static constexpr int V = K + KV_BN * D * 2;
  static constexpr int Q = V + KV_BN * D * 2;  // stage s: Q, then dout
  static constexpr int STAGE = 2 * KV_BM * D * 2;
  static constexpr int DS = Q + KV_STAGES * STAGE;  // 2 x dS^T (keys x rows)
  static constexpr int DS_BYTES = KV_BN * KV_BM * 2;
  static constexpr int DQT = DS + 2 * DS_BYTES;  // 2 x the fp32 dQ tile
  static constexpr int DQ_BYTES = KV_BM * D * 4;
  static constexpr int ROWS = DQT + (DQ ? 2 * DQ_BYTES : 0);  // lse2, delta
  static constexpr int BAR = ROWS + KV_STAGES * 2 * KV_BM * 4;
  // mbarriers: full[KV_STAGES], empty[KV_STAGES], kv
  static constexpr int BYTES = BAR + (2 * KV_STAGES + 1) * 8 + 1024;
};

// TMA maps of the four bf16 operands, boxes of 64 columns by KV_BM rows (q,
// dout) or KV_BN rows (k, v), and of the fp32 dq accumulator, boxes of 32
// columns by KV_BM rows.
struct Maps {
  CUtensorMap q, k, v, o, dq;
};

// Named barriers beside __syncthreads' 0: the consumers' dS^T (1), and for
// each dQ buffer b the consumers' "tile written" (2 + b) and the dQ
// writer's "tile read" (4 + b).
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

// acc (64 keys x D) += A (64 keys x 64 q rows, bf16 fragments) * T (64 q
// rows x D, the Q or dout tile, MN-major: its rows are the reduction).
template <int D>
__device__ __forceinline__ void kv_accumulate(float (&acc)[D / 2],
                                              const uint32_t (&a)[4][4],
                                              const char* t) {
  using S = KvSmem<D>;
#pragma unroll
  for (int kc = 0; kc < KV_BM / 16; ++kc) {
    const uint64_t db = hop::desc_sw128(t + kc * 16 * 128, S::PANEL_Q);
    if constexpr (D == 128)
      hop::wgmma_rs_n128<1>(acc, a[kc], db, 1);
    else
      hop::wgmma_rs_n64<1>(acc, a[kc], db, 1);
  }
}

template <int D, bool DQ, bool RING>
__global__ void __launch_bounds__(KV_THREADS, 1)
bwd_kv_kernel(const __grid_constant__ Maps maps,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* __restrict__ dk, void* __restrict__ dv, int Hq, int Hkv,
              int Sq, int Skv, float scale, int causal, int offset,
              int dkv_bf16, Ring ring) {
  using S = KvSmem<D, DQ>;
  constexpr int NA = D / 2;  // fp32 of a 64 x D accumulator a thread holds
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
  const int t0 = causal ? max(0, n0 - offset) / KV_BM : 0;
  const int nq = (Sq + KV_BM - 1) / KV_BM;
  const int per_head = nq > t0 ? nq - t0 : 0;
  const int steps = group * per_head;

  char* ks = smem + S::K;
  char* vs = smem + S::V;
  float* fs = reinterpret_cast<float*>(smem + S::ROWS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + KV_STAGES;
  uint64_t* kv_bar = empty + KV_STAGES;
  auto qs = [&](int s) { return smem + S::Q + s * S::STAGE; };
  auto dos = [&](int s) { return qs(s) + KV_BM * D * 2; };
  auto lses = [&](int s) { return fs + s * 2 * KV_BM; };
  auto dels = [&](int s) { return lses(s) + KV_BM; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      hop::mbar_init(&full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&empty[s], KV_CONSUMERS);
    }
    hop::mbar_init(kv_bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

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
      for (int it = 0; it < steps; ++it) {
        const int s = it % KV_STAGES;
        const int h = hk * group + it / per_head;
        const int m0 = (t0 + it % per_head) * KV_BM;
        hop::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        for (int i = lane; i < KV_BM; i += 32) {
          const int row = m0 + i;
          float l2 = 0.f, dl = 0.f;
          if (row < Sq) {
            const long long idx = (long long)(b * Hq + h) * Sq + row;
            // dead rows (lse = NEG_INF) clamp so that p underflows to 0
            // (a ring step's lse arrives in base 2, already clamped)
            l2 = RING ? lse[idx] : fmaxf(lse[idx], RFA_NEG_INF / 2) * LOG2E;
            dl = delta[idx];
          }
          lses(s)[i] = l2;
          dels(s)[i] = dl;
        }
        if (lane == 0) {
          hop::mbar_arrive_tx(&full[s], 2 * KV_BM * D * 2);
          for (int p = 0; p < D / 64; ++p) {
            hop::tma_load_4d(qs(s) + p * S::PANEL_Q, &maps.q, &full[s], 64 * p,
                             m0, h, b);
            hop::tma_load_4d(dos(s) + p * S::PANEL_Q, &maps.o, &full[s],
                             64 * p, m0, h, b);
          }
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    } else if (DQ && threadIdx.x < KV_CONSUMERS + 64) {
      // ---- dQ writer: the next warp adds each fp32 dQ tile into dq_acc
      // by TMA, off the consumers' path (the last two warps idle) ----
      for (int it = 0; it < steps; ++it) {
        const int buf = it & 1;
        const int h = hk * group + it / per_head;
        const int m0 = (t0 + it % per_head) * KV_BM;
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
    // ---- consumers: warpgroup wg owns keys nw + [0, 64) ----
    hop::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128;
    const int nw = n0 + 64 * wg;
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, tq = lane % 4;
    const float scale_log2 = RING ? 1.f : scale * LOG2E;
    const float ds_scale = RING ? 1.f : scale;
    const float inv_cap2 = RING && ring.cap2 > 0.f ? 1.f / ring.cap2 : 0.f;

    float dk_acc[NA], dv_acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hop::mbar_wait(kv_bar, 0);

    for (int it = 0; it < steps; ++it) {
      const int s = it % KV_STAGES;
      const int h = hk * group + it / per_head;
      const int m0 = (t0 + it % per_head) * KV_BM;
      const char* qt = qs(s);
      const char* dot = dos(s);
      const float* l2s = lses(s);
      const float* dls = dels(s);
      // dS^T alternates between two buffers: one barrier a step keeps a
      // warpgroup that runs ahead off the buffer the other still reads
      char* dss = smem + S::DS + (it & 1) * S::DS_BYTES;
      hop::mbar_wait(&full[s], (it / KV_STAGES) & 1);

      // S^T = K Q^T and dP^T = V dout^T: 64 keys x 64 q rows each. An
      // element i of these accumulators is key 16 warp + g + 8 ((i % 4) / 2)
      // of the warpgroup's and q row 8 (i / 4) + 2 tq + i % 2 of the tile.
      float sc[32], dpt[32];
      hop::wgmma_fence();
      kv_scores<D>(sc, ks + wg * 64 * 128, qt);
      hop::wgmma_commit();
      kv_scores<D>(dpt, vs + wg * 64 * 128, dot);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);

      // P^T; zero outside the mask and on the ragged edges. A ring step
      // recomputes the forward's softcap and ALiBi first and keeps the
      // softcap's derivative 1 - tanh^2 for dS.
      const bool edge = m0 + KV_BM > Sq || nw + 64 > Skv ||
                        (causal && m0 + offset < nw + 63);
      float dcap[RING ? 32 : 1];
      if constexpr (RING) {
        // one uniform branch around the whole tile
        if (ring.cap2 > 0.f || ring.slopes) {
          const float slope = ring.slopes ? ring.slopes[h] : 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            float x = sc[i];
            dcap[i] = 1.f;
            if (ring.cap2 > 0.f) {
              const float t = tanhf(x * inv_cap2);
              x = ring.cap2 * t;
              dcap[i] = 1.f - t * t;
            }
            if (ring.slopes) {
              const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
              const int row = m0 + (i / 4) * 8 + tq * 2 + i % 2;
              float dist =
                  (float)((ring.q_pos0 + row) - (ring.kv_pos0 + key));
              if (ring.alibi_abs) dist = fabsf(dist);
              x -= slope * dist;
            }
            sc[i] = x;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i / 4) * 8 + tq * 2 + i % 2;
        float p = exp2f(sc[i] * scale_log2 - l2s[col]);
        if (edge) {
          const int key = nw + warp * 16 + g + ((i % 4) / 2) * 8;
          const int row = m0 + col;
          if (row >= Sq || key >= Skv || (causal && row + offset < key))
            p = 0.f;
        }
        sc[i] = p;
      }

      // dV += P^T dout
      uint32_t pa[4][4];
      hop::pack_fragments(pa, sc);
      hop::wgmma_fence();
      kv_accumulate<D>(dv_acc, pa, dot);
      hop::wgmma_commit();
      if constexpr (RING) {
        if (ring.cap2 > 0.f) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] *= dcap[i];  // p (1 - tanh^2)
        }
      }

      // dS^T = P^T (dP^T - delta) * scale, in place of dP^T
      hop::wgmma_wait<1>();
      hop::fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dpt[i] = sc[i] * (dpt[i] - dls[(i / 4) * 8 + tq * 2 + i % 2]) *
                 ds_scale;
      uint32_t da[4][4];
      hop::pack_fragments(da, dpt);
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
      kv_accumulate<D>(dk_acc, da, qt);
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
    hop::fence_regs(dk_acc);
    hop::fence_regs(dv_acc);

    // dK, dV of this warpgroup's 64 keys, written once: accumulator element
    // 4 j + 2 r + c is key 16 warp + g + 8 r, column 8 j + 2 tq + c
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = nw + warp * 16 + g + r * 8;
      if (key >= Skv) continue;
      const long long base = ((long long)(b * Hkv + hk) * Skv + key) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const long long o = base + j * 8 + tq * 2;
        float2 ka = make_float2(dk_acc[4 * j + 2 * r],
                                dk_acc[4 * j + 2 * r + 1]);
        float2 va = make_float2(dv_acc[4 * j + 2 * r],
                                dv_acc[4 * j + 2 * r + 1]);
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
template <int D, bool DQ, bool RING = false>
int launch_kv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq_acc, void* dk,
              void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
              const long long* strides, float scale, int causal, int offset,
              int dkv_bf16, cudaStream_t stream, const Ring& ring = Ring{}) {
  auto kern = bwd_kv_kernel<D, DQ, RING>;
  constexpr int bytes = KvSmem<D, DQ>::BYTES;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
      dkv_bf16, ring);
  return cudaGetLastError();
}

}  // namespace rfa_bwd
