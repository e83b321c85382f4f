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
//    K and V tiles into a two-stage ring, K and V each under mbarrier
//    full/empty pairs of their own (a stage's K is free once S is computed,
//    its V once P V is). 4-D tensor maps over the real strides,
//    128B-swizzled panels of 64 columns; rows past S read zero.
//  - Products by wgmma on each consumer warpgroup's 64 rows:
//      S  = Q K^T  (64 x 128 fp32, both operands from shared memory,
//                   K-major over the head dim)
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
//
// Measured (profile_torch_fwd.py, NVIDIA H100 80GB HBM3, 700 W, in turns
// with the loops before it) at q (1, 32, 8192, 128), kv (1, 8, 8192, 128)
// bf16: B1 causal 1.07 to 1.11 ms, about 500 TFLOP/s, 1.1 to 1.2x SDPA's
// forward (0.88 to 0.97), against 0.556 ms at the bf16 peak; B7
// off-diagonal 1.85 to 2.04 ms, diagonal 1.03 to 1.17 (SDPA's non-causal
// forward 1.61 to 1.73), against 1.112 ms.
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

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rfa_fwd {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // q rows per block, 64 per consumer warpgroup
constexpr int BN = 128;  // keys per tile
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int NTHREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int STAGES = 2;
// named barriers beside __syncthreads' 0: warpgroup wg's turn to issue its
// products is BAR_TURN + wg
constexpr int BAR_TURN = 1;

// 2^x by the special-function unit alone (exp2f adds a range fix-up for
// denormal results, which p in [0, 1] can spare: 2 to 7% of the loop)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What a ring step adds to a block call (B7).
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
// of 64 columns by 128 rows.
template <int D>
struct Smem {
  static constexpr int PANEL = 128 * 128;  // 128 rows of 64 bf16
  static constexpr int TILE = BN * D * 2;  // a K or V tile (BM = BN)
  static constexpr int Q = 0;
  static constexpr int KV = Q + TILE;  // stage s: K at KV + 2 s TILE, then V
  static constexpr int BAR = KV + STAGES * 2 * TILE;
  // mbarriers: q, full_k[STAGES], full_v[STAGES], empty_k[STAGES],
  // empty_v[STAGES]
  static constexpr int BYTES = BAR + (1 + 4 * STAGES) * 8 + 1024;
};

// TMA maps of q, k and v, boxes of 64 columns by 128 rows.
struct Maps {
  CUtensorMap q, k, v;
};

// XFORM: the ring step has softcap or ALiBi. Compiled apart so that the
// common step keeps B1's straight-line tile body: with one kernel and a
// uniform run-time branch around the transform, the headline off-diagonal
// step of the first port of this loop took 5.3 ms on the H100 where the
// split took 5.0.
template <int D, bool RING, bool XFORM = false>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps, void* __restrict__ out,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 float scale_log2, int causal, int offset, int out_bf16,
                 Ring ring) {
  using S = Smem<D>;
  constexpr int NO = D / 2;  // fp32 of a 64 x D accumulator a thread holds
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
  const int n_tiles = (n_end + BN - 1) / BN;

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

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the tiles in flight by TMA; a block
    // with no kv tile loads nothing ----
    hop::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
      hop::mbar_arrive_tx(q_bar, BM * D * 2);
      for (int p = 0; p < D / 64; ++p)
        hop::tma_load_4d(qs + p * S::PANEL, &maps.q, q_bar, 64 * p, m0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        hop::mbar_wait(&empty_k[s], parity);
        hop::mbar_arrive_tx(&full_k[s], BN * D * 2);
        for (int p = 0; p < D / 64; ++p)
          hop::tma_load_4d(ks(s) + p * S::PANEL, &maps.k, &full_k[s], 64 * p,
                           j * BN, hk, b);
        hop::mbar_wait(&empty_v[s], parity);
        hop::mbar_arrive_tx(&full_v[s], BN * D * 2);
        for (int p = 0; p < D / 64; ++p)
          hop::tma_load_4d(vs(s) + p * S::PANEL, &maps.v, &full_v[s], 64 * p,
                           j * BN, hk, b);
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
  // accumulator element i of S (64 rows x 128 keys) or O (64 rows x D) is
  // row r_lo + 8 ((i % 4) / 2) and column 8 (i / 4) + 2 tq + i % 2
  const int r_lo = mw + 16 * warp + g;
  const char* qa = qs + wg * 64 * 128;  // this warpgroup's rows of a panel

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  float slope = 0.f, inv_cap2 = 0.f;
  if constexpr (XFORM) {
    if (ring.slopes) slope = ring.slopes[h];
    if (ring.cap2 > 0.f) inv_cap2 = 1.f / ring.cap2;
  }

  // issue S = Q K^T of stage s: 64 q rows x 128 keys
  auto scores = [&](float (&sc)[64], int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ko = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel
      hop::wgmma_ss_n128<0, 0>(
          sc, hop::desc_sw128(qa + (kk / 4) * S::PANEL + ko, 16),
          hop::desc_sw128(ks(s) + (kk / 4) * S::PANEL + ko, 16), kk > 0);
    }
    hop::wgmma_commit();
  };

  // issue O += P V of stage s: P as bf16 A fragments, V MN-major (its
  // rows, the keys, are the reduction), stepping 16 keys = 2048 B
  auto accumulate = [&](const uint32_t (&pa)[8][4], int s) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint64_t db = hop::desc_sw128(vs(s) + kc * 2048, S::PANEL);
      if constexpr (D == 128)
        hop::wgmma_rs_n128<1>(o, pa[kc], db, 1);
      else
        hop::wgmma_rs_n64<1>(o, pa[kc], db, 1);
    }
    hop::wgmma_commit();
  };

  // the softmax of the S tile of keys n0 + [0, 128) in place: P = exp2(S -
  // m) in sc, (m, l) updated, alpha the factor O still has to take
  auto softmax = [&](float (&sc)[64], int n0, float (&alpha)[2]) {
    // a ring step's q arrives pre-scaled to base 2 (scale_log2 is 1): its
    // logits go through softcap, then ALiBi on global positions, where
    // the ring has them
    if constexpr (XFORM) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i];
        if (ring.cap2 > 0.f) x = ring.cap2 * tanhf(x * inv_cap2);
        if (ring.slopes) {
          const int row = r_lo + 8 * ((i % 4) / 2);
          const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
          float dist = (float)((ring.q_pos0 + row) - (ring.kv_pos0 + col));
          if (ring.alibi_abs) dist = fabsf(dist);
          x -= slope * dist;
        }
        sc[i] = x;
      }
    }

    // scale to base-2 logits; mask the ragged edge and the causal diagonal
    const bool edge = n0 + BN > Skv || (causal && n0 + BN - 1 > mw + offset);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int row = r_lo + 8 * ((i % 4) / 2);
        const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
        if (col >= Skv || (causal && row + offset < col)) x = -INFINITY;
      }
      sc[i] = x;
    }

    // rows r_lo (r = 0) and r_lo + 8 (r = 1); the four threads of a quad
    // hold a row's 128 columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      // a row with no live key yet keeps m = -inf; exponentiate against 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[4 * i + 2 * r] = ex2(sc[4 * i + 2 * r] - m_use);
        sc[4 * i + 2 * r + 1] = ex2(sc[4 * i + 2 * r + 1] - m_use);
        rs += sc[4 * i + 2 * r] + sc[4 * i + 2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha[r] + rs;  // per-thread partial
      m_run[r] = m_new;
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
    float sc[64], alpha[2];
    uint32_t pa[8][4];
    if (wg == 1) hop::bar_arrive(BAR_TURN, CONSUMERS);
    hop::mbar_wait(q_bar, 0);
    hop::mbar_wait(&full_k[0], 0);
    my_turn();
    hop::wgmma_fence();
    scores(sc, 0);
    next_turn();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::mbar_arrive(&empty_k[0]);
    softmax(sc, 0, alpha);  // O is still 0: nothing to rescale
    hop::pack_fragments(pa, sc);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      hop::mbar_wait(&full_k[s], (j / STAGES) & 1);
      hop::mbar_wait(&full_v[sp], ((j - 1) / STAGES) & 1);
      my_turn();
      hop::wgmma_fence();
      scores(sc, s);
      accumulate(pa, sp);
      next_turn();
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      hop::mbar_arrive(&empty_k[s]);  // K of stage s is read
      softmax(sc, j * BN, alpha);
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::mbar_arrive(&empty_v[sp]);  // V of stage sp is read
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[4 * i + c] *= alpha[c / 2];
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
    const float inv = dead ? 0.f : 1.f / l;
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
template <int D, bool RING, bool XFORM = false>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale_log2, int causal, int offset, int out_bf16,
           const Ring& ring, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, RING, XFORM>;
  constexpr int bytes = Smem<D>::BYTES;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
                                          out_bf16, ring);
  return cudaGetLastError();
}

}  // namespace rfa_fwd
