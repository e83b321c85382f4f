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
// exchange neither kernel uses atomics: each
// output element is summed by one thread in a fixed order, so the results
// are bitwise reproducible from run to run.
//
//  - B3a: one block of 4 warps per (batch, q head, 64-row q tile), heaviest
//    causal tiles first, as B1. It loops over 64-key tiles up to the causal
//    bound (K and V double-buffered with cp.async), recomputes p and dp,
//    keeps dq in fp32 registers and writes it once, in fp32 or bf16.
//  - B3b: the kv-major loop of B2 (csrc/flash_bwd.cuh) without dq, its
//    fourth product or its writer warp: one block per (batch, kv head,
//    128-key tile) walks the GQA group's q heads and 64-row q tiles, Q and
//    dout fed by TMA, the products on wgmma, and keeps dk and dv in
//    registers, written once and summed over the group. Measured at q (1,
//    32, 8192, 128), kv (1, 8, 8192, 128) causal (profile_torch_bwd.py,
//    NVIDIA H100 80GB HBM3, 700 W): 2.16 to 2.28 ms, about 500 TFLOP/s of
//    its 4 products and faster than SDPA's whole backward; the mma.sync
//    loop before it 6.07 to 6.50 ms. B3a keeps its mma.sync loop.

#include "flash_bwd.cuh"

namespace {

using rfa_bwd::bf16;

// 12 strides in elements: (b, h, s) of q, k, v and dout; last dim contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

inline Strides make_strides(const long long* st) {
  Strides s;
  for (int i = 0; i < 3; ++i) {
    s.q[i] = st[i];
    s.k[i] = st[3 + i];
    s.v[i] = st[6 + i];
    s.o[i] = st[9 + i];
  }
  return s;
}

// Copy ROWS rows of D bf16 (row r at src + r * stride) into shared memory
// with leading dimension D + 8; rows at or past `valid` are zero-filled.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int valid) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < valid;
    const bf16* g = ok ? src + r * stride + c * 8 : src;
    rfa::cp_async16(dst + r * LD + c * 8, g, ok ? 16 : 0);
  }
}

constexpr int BM = 64;  // q rows per block, 16 per warp
constexpr int BN = 64;  // keys per tile
constexpr int NTHREADS = 128;

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  static constexpr int Q = 0;
  static constexpr int DO = BM * LD;
  static constexpr int KV = 2 * BM * LD;  // stage s: K at KV + s*2*BN*LD, V after
  static constexpr int BYTES = (2 * BM + 2 * 2 * BN) * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              void* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
              Strides st, float scale, int causal, int offset, int dq_bf16) {
  using S = DqSmem<D>;
  constexpr int LD = S::LD;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int NT = BN / 8;  // key n-tiles of S per warp
  constexpr int DT = D / 8;   // d n-tiles of dQ per warp
  extern __shared__ __align__(16) bf16 smem[];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int m0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const float scale_log2 = scale * rfa_bwd::LOG2E;

  const bf16* kb = k + b * st.k[0] + hk * st.k[1];
  const bf16* vb = v + b * st.v[0] + hk * st.v[1];
  int n_end = Skv;  // key tiles [0, n_end): the bound of the tile's last row
  if (causal) n_end = min(Skv, max(0, m0 + BM + offset));
  const int n_tiles = (n_end + BN - 1) / BN;

  bf16* qs = smem + S::Q;
  bf16* dos = smem + S::DO;
  auto ks = [&](int s) { return smem + S::KV + s * 2 * BN * LD; };
  auto vs = [&](int s) { return ks(s) + BN * LD; };

  load_rows<D, BM, NTHREADS>(
      qs, q + b * st.q[0] + h * st.q[1] + (long long)m0 * st.q[2], st.q[2],
      Sq - m0);
  load_rows<D, BM, NTHREADS>(
      dos, dout + b * st.o[0] + h * st.o[1] + (long long)m0 * st.o[2],
      st.o[2], Sq - m0);
  if (n_tiles > 0) {
    load_rows<D, BN, NTHREADS>(ks(0), kb, st.k[2], Skv);
    load_rows<D, BN, NTHREADS>(vs(0), vb, st.v[2], Skv);
  }
  rfa::cp_async_commit();

  // lse (clamped: dead rows give p = 0) and delta of rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + r * 8;
    l2[r] = dl[r] = 0.f;
    if (row < Sq) {
      const long long idx = (long long)(b * Hq + h) * Sq + row;
      l2[r] = fmaxf(lse[idx], RFA_NEG_INF / 2) * rfa_bwd::LOG2E;
      dl[r] = delta[idx];
    }
  }

  float dqa[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    if (j + 1 < n_tiles) {
      const int s = (j + 1) & 1;
      load_rows<D, BN, NTHREADS>(
          ks(s), kb + (long long)(n0 + BN) * st.k[2], st.k[2], Skv - n0 - BN);
      load_rows<D, BN, NTHREADS>(
          vs(s), vb + (long long)(n0 + BN) * st.v[2], st.v[2], Skv - n0 - BN);
      rfa::cp_async_commit();
      rfa::cp_async_wait<1>();
    } else {
      rfa::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks(j & 1);
    const bf16* vt = vs(j & 1);

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      rfa::ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                              (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4(bfr, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                                  kk * 16 + ((lane / 8) % 2) * 8);
        rfa::mma_bf16_16816(sc[2 * np], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(sc[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

    // P; zero past the ragged key edge and the causal diagonal
    const bool edge = n0 + BN > Skv || (causal && n0 + BN - 1 > m0 + offset);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(sc[i][e] * scale_log2 - l2[r]);
        if (edge) {
          const int row = m0 + warp * 16 + g + r * 8;
          const int col = n0 + i * 8 + tq * 2 + (e & 1);
          if (col >= Skv || (causal && row + offset < col)) p = 0.f;
        }
        sc[i][e] = p;
      }
    }

    // dP = dout V^T
    float dpv[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      dpv[i][0] = dpv[i][1] = dpv[i][2] = dpv[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      rfa::ldmatrix_x4(a, dos + (warp * 16 + lane % 16) * LD + kk * 16 +
                              (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4(bfr, vt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                                  kk * 16 + ((lane / 8) % 2) * 8);
        rfa::mma_bf16_16816(dpv[2 * np], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(dpv[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

    // dS = P (dP - delta) * scale, in place of dP
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpv[i][e] = sc[i][e] * (dpv[i][e] - dl[e >> 1]) * scale;

    // dQ += dS K (dS re-packed from the accumulators as the A operand)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = rfa::pack_bf16(dpv[2 * kk][0], dpv[2 * kk][1]);
      a[1] = rfa::pack_bf16(dpv[2 * kk][2], dpv[2 * kk][3]);
      a[2] = rfa::pack_bf16(dpv[2 * kk + 1][0], dpv[2 * kk + 1][1]);
      a[3] = rfa::pack_bf16(dpv[2 * kk + 1][2], dpv[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4_trans(
            bfr, kt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                     dp * 16 + (lane / 16) * 8);
        rfa::mma_bf16_16816(dqa[2 * dp], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(dqa[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }
  rfa::cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const long long orow = ((long long)(b * Hq + h) * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int col = i * 8 + tq * 2;
      if (dq_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dq) + orow + col) =
            rfa::pack_bf16(dqa[i][2 * r], dqa[i][2 * r + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + orow + col) =
            make_float2(dqa[i][2 * r], dqa[i][2 * r + 1]);
      }
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, const long long* strides, float scale,
              int causal, int offset, int dq_bf16, cudaStream_t stream) {
  auto kern = bwd_dq_kernel<D>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<D>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid((Sq + BM - 1) / BM, Hq, B);
  kern<<<grid, NTHREADS, DqSmem<D>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      dq, Hq, Hkv, Sq, Skv, make_strides(strides), scale, causal,
      offset, dq_bf16);
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
