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

#include "flash_bwd.cuh"

namespace {

using rfa_bwd::bf16;
using rfa_bwd::LOG2E;

constexpr int BM = 128;  // q rows per block, 64 per consumer warpgroup
constexpr int BN = 64;   // keys per tile
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int NTHREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int STAGES = 2;

// Byte offsets from a 1024-aligned base; bf16 tiles in 128B-swizzled panels
// of 64 columns.
template <int D>
struct DqSmem {
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

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_dq_kernel(const __grid_constant__ DqMaps maps,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
              float scale, int causal, int offset, int dq_bf16) {
  using S = DqSmem<D>;
  constexpr int NQ = D / 2;  // fp32 of a 64 x D accumulator a thread holds
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
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        hop::mbar_wait(&empty_k[s], parity);
        hop::mbar_arrive_tx(&full_k[s], BN * D * 2);
        for (int p = 0; p < D / 64; ++p)
          hop::tma_load_4d(ks(s) + p * S::PANEL_KV, &maps.k, &full_k[s],
                           64 * p, j * BN, hk, b);
        hop::mbar_wait(&empty_v[s], parity);
        hop::mbar_arrive_tx(&full_v[s], BN * D * 2);
        for (int p = 0; p < D / 64; ++p)
          hop::tma_load_4d(vs(s) + p * S::PANEL_KV, &maps.v, &full_v[s],
                           64 * p, j * BN, hk, b);
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
  // accumulator element i of S or dP (64 rows x 64 keys) or dQ (64 rows x
  // D) is row r_lo + 8 ((i % 4) / 2) and column 8 (i / 4) + 2 tq + i % 2
  const int r_lo = mw + 16 * warp + g;
  const char* qa = qs + wg * 64 * 128;  // this warpgroup's rows of a panel
  const char* doa = dos + wg * 64 * 128;
  const float scale_log2 = scale * LOG2E;

  float dqa[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) dqa[i] = 0.f;

  if (n_tiles > 0) {
    // lse2 (clamped: a dead row's p underflows to 0 or is masked) and
    // delta of rows r_lo and r_lo + 8; rows past Sq read zero Q and dout
    // and get dS = 0
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      l2[r] = dl[r] = 0.f;
      if (row < Sq) {
        const long long idx = (long long)(b * Hq + h) * Sq + row;
        l2[r] = fmaxf(lse[idx], RFA_NEG_INF / 2) * LOG2E;
        dl[r] = delta[idx];
      }
    }
    hop::mbar_wait(q_bar, 0);

    // tile j: issue S and dP; P while dP runs; dS; issue dQ += dS K and go
    // on to tile j + 1 without waiting for it: the wait for tile j + 1's S
    // (committed after it) covers it, and K of tile j is freed there
    uint32_t da[4][4];
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      const int n0 = j * BN;
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

      // P; zero past the ragged key edge and the causal diagonal
      const bool edge =
          n0 + BN > Skv || (causal && n0 + BN - 1 > mw + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i % 4) / 2;
        float p = exp2f(sc[i] * scale_log2 - l2[r]);
        if (edge) {
          const int row = r_lo + 8 * r;
          const int col = n0 + 8 * (i / 4) + 2 * tq + i % 2;
          if (col >= Skv || (causal && row + offset < col)) p = 0.f;
        }
        sc[i] = p;
      }

      // dS = P (dP - delta) * scale, in place of dP
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
      hop::mbar_arrive(&empty_v[s]);  // V of stage s is read
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = sc[i] * (dp[i] - dl[(i % 4) / 2]) * scale;
      hop::pack_fragments(da, dp);

      // dQ += dS K: K MN-major (its rows, the keys, are the reduction),
      // stepping 16 keys = 2048 bytes
      hop::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint64_t db = hop::desc_sw128(ks(s) + kc * 2048, S::PANEL_KV);
        if constexpr (D == 128)
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
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + tq * 2;
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
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, const long long* strides, float scale,
              int causal, int offset, int dq_bf16, cudaStream_t stream) {
  auto kern = bwd_dq_kernel<D>;
  constexpr int bytes = DqSmem<D>::BYTES;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
                                          dq_bf16);
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
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,
                          strides, scale, causal, offset, dq_bf16, st);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,
                         strides, scale, causal, offset, dq_bf16, st);
  return cudaErrorInvalidValue;
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
  if (D == 128)
    return rfa_bwd::launch_kv<128, false>(q, k, v, dout, lse, delta, nullptr,
                                          dk, dv, B, Hq, Hkv, Sq, Skv, strides,
                                          scale, causal, offset, dkv_bf16, st);
  if (D == 64)
    return rfa_bwd::launch_kv<64, false>(q, k, v, dout, lse, delta, nullptr,
                                         dk, dv, B, Hq, Hkv, Sq, Skv, strides,
                                         scale, causal, offset, dkv_bf16, st);
  return cudaErrorInvalidValue;
}
