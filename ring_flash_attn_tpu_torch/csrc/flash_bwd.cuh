// Shared pieces of the flash-attention backward kernels: the kv-major loop
// of B2 (csrc/flash_bwd.cu, with dq) and B3b (csrc/flash_bwd_split.cu,
// without). The delta = rowsum(dout * out) pre-pass that both launchers run
// when the caller passes delta=None lives in csrc/flash_bwd.cu alone.
//
// Contract (ops/flash.py::block_bwd, the port of the JAX block_bwd):
// q, dout (B, Hq, Sq, D), k, v (B, Hkv, Skv, D) in bf16, lse and delta
// fp32 (B, Hq, Sq) contiguous, lse in natural log from the merged forward.
// p = exp(q k^T * scale - max(lse, NEG_INF / 2)) on allowed (q, k) pairs
// and 0 elsewhere; ds = p * (dout v^T - delta) * scale; dq = ds k,
// dk = ds^T q, dv = p^T dout, dk and dv summed over the GQA group.
//
// The kv-major kernel: one block of 4 warps per (batch, kv head, 64-key
// tile). K and V of the tile stay in shared memory; the block walks the
// group's q heads and their 32-row q tiles from the causal lower bound,
// double-buffering Q, dout, lse and delta with cp.async. Each warp owns 16
// keys and works in the transposed orientation, so that dk and dv stay in
// its fp32 registers for the whole walk and are written once:
//   S^T  = K Q^T                   p^T = exp2(S^T * scale * log2 e - lse2)
//   dV  += P^T dout                dP^T = V dout^T
//   dS^T = P^T (dP^T - delta) * scale
//   dK  += dS^T Q
// and, with dq (B2), dS^T goes through shared memory so that
//   dQ  += dS K                    by float2 atomicAdd into an fp32
// (B, Hq, Sq, D) accumulator the launcher zeroes. Products are mma.sync
// m16n8k16 bf16 with fp32 accumulation; p and ds are rounded to bf16 only
// as operands of the products, the scale stays in fp32 (the Pallas
// wrappers fold scale * log2 e into bf16 q or k instead).
//
// With RING (kernel B8, csrc/fused_ring_bwd.cu) the same loop is one step
// of the fused ring backward: q arrives pre-scaled by scale * log2 e, v
// pre-scaled by scale, lse in base 2 and clamped, delta times scale, so no
// scale is applied here; softcap and ALiBi are recomputed as the forward
// applied them (with the 1 - tanh^2 factor on dS); dq adds into the rank's
// accumulator, which the launcher does not zero, and dk, dv add into the
// travelling fp32 accumulators instead of being written. Without RING all
// of that compiles out.

#pragma once

#include "common.cuh"

namespace rfa_bwd {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

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

constexpr int KV_BN = 64;  // keys per block, 16 per warp
constexpr int KV_BM = 32;  // q rows per step
constexpr int KV_THREADS = 128;

template <int D>
struct KvSmem {
  static constexpr int LD = D + 8;      // +16 B a row: conflict-free ldmatrix
  static constexpr int LDS = KV_BM + 8; // dS^T tile, [key][q row]
  static constexpr int K = 0;
  static constexpr int V = K + KV_BN * LD;
  static constexpr int Q = V + KV_BN * LD;  // stage s: Q, then dout
  static constexpr int DS = Q + 2 * 2 * KV_BM * LD;
  static constexpr int ELEMS = DS + KV_BN * LDS;
  // then fp32 lse2 and delta of each stage
  static constexpr int BYTES = ELEMS * 2 + 2 * 2 * KV_BM * 4;
};

template <int D, bool DQ, bool RING>
__global__ void __launch_bounds__(KV_THREADS)
bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq_acc, void* __restrict__ dk,
              void* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
              Strides st, float scale, int causal, int offset,
              int dkv_bf16, Ring ring) {
  using S = KvSmem<D>;
  constexpr int LD = S::LD, LDS = S::LDS;
  constexpr int KD = D / 16;      // k-steps over the head dim
  constexpr int NT = KV_BM / 8;   // q n-tiles of S^T per warp
  constexpr int DT = D / 8;       // d n-tiles of dK and dV per warp
  extern __shared__ __align__(16) bf16 smem[];

  // kv tiles in order: under a causal mask the first ones see the most q
  // tiles, so the heaviest blocks start first
  const int n0 = blockIdx.x * KV_BN;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const float scale_log2 = RING ? 1.f : scale * LOG2E;
  const float ds_scale = RING ? 1.f : scale;
  const float inv_cap2 = RING && ring.cap2 > 0.f ? 1.f / ring.cap2 : 0.f;

  // q tiles [t0, nq) hold every row that sees a key of this tile
  const int t0 = causal ? max(0, n0 - offset) / KV_BM : 0;
  const int nq = (Sq + KV_BM - 1) / KV_BM;
  const int per_head = nq > t0 ? nq - t0 : 0;
  const int steps = group * per_head;

  bf16* ks = smem + S::K;
  bf16* vs = smem + S::V;
  bf16* dss = smem + S::DS;
  float* fs = reinterpret_cast<float*>(smem + S::ELEMS);
  auto qs = [&](int s) { return smem + S::Q + s * 2 * KV_BM * LD; };
  auto dos = [&](int s) { return qs(s) + KV_BM * LD; };
  auto lses = [&](int s) { return fs + s * 2 * KV_BM; };
  auto dels = [&](int s) { return lses(s) + KV_BM; };

  load_rows<D, KV_BN, KV_THREADS>(
      ks, k + b * st.k[0] + hk * st.k[1] + (long long)n0 * st.k[2], st.k[2],
      Skv - n0);
  load_rows<D, KV_BN, KV_THREADS>(
      vs, v + b * st.v[0] + hk * st.v[1] + (long long)n0 * st.v[2], st.v[2],
      Skv - n0);

  // step `it` is q head hk * group + it / per_head, q tile t0 + it % per_head
  auto prefetch = [&](int it, int s) {
    const int h = hk * group + it / per_head;
    const int m0 = (t0 + it % per_head) * KV_BM;
    load_rows<D, KV_BM, KV_THREADS>(
        qs(s), q + b * st.q[0] + h * st.q[1] + (long long)m0 * st.q[2],
        st.q[2], Sq - m0);
    load_rows<D, KV_BM, KV_THREADS>(
        dos(s), dout + b * st.o[0] + h * st.o[1] + (long long)m0 * st.o[2],
        st.o[2], Sq - m0);
    for (int i = threadIdx.x; i < KV_BM; i += KV_THREADS) {
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
  };
  if (steps > 0) prefetch(0, 0);
  rfa::cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int s = it & 1;
    if (it + 1 < steps) {
      prefetch(it + 1, s ^ 1);
      rfa::cp_async_commit();
      rfa::cp_async_wait<1>();
    } else {
      rfa::cp_async_wait<0>();
    }
    __syncthreads();
    const int h = hk * group + it / per_head;
    const int m0 = (t0 + it % per_head) * KV_BM;
    const bf16* qt = qs(s);
    const bf16* dot = dos(s);
    const float* l2s = lses(s);
    const float* dls = dels(s);

    // S^T = K Q^T: this warp's 16 keys x 32 q rows
    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      rfa::ldmatrix_x4(a, ks + (warp * 16 + lane % 16) * LD + kk * 16 +
                              (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4(bfr, qt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                                  kk * 16 + ((lane / 8) % 2) * 8);
        rfa::mma_bf16_16816(sc[2 * np], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(sc[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

    // P^T; zero outside the mask and on the ragged edges. A ring step
    // recomputes the forward's softcap and ALiBi first and keeps the
    // softcap's derivative 1 - tanh^2 for dS.
    const bool edge = m0 + KV_BM > Sq || n0 + KV_BN > Skv ||
                      (causal && m0 + offset < n0 + KV_BN - 1);
    float dcap[RING ? NT : 1][4];
    if constexpr (RING) {
      // one uniform branch around the whole tile
      if (ring.cap2 > 0.f || ring.slopes) {
        const float slope = ring.slopes ? ring.slopes[h] : 0.f;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[i][e];
            dcap[i][e] = 1.f;
            if (ring.cap2 > 0.f) {
              const float t = tanhf(x * inv_cap2);
              x = ring.cap2 * t;
              dcap[i][e] = 1.f - t * t;
            }
            if (ring.slopes) {
              const int key = n0 + warp * 16 + g + (e >= 2 ? 8 : 0);
              const int row = m0 + i * 8 + tq * 2 + (e & 1);
              float dist =
                  (float)((ring.q_pos0 + row) - (ring.kv_pos0 + key));
              if (ring.alibi_abs) dist = fabsf(dist);
              x -= slope * dist;
            }
            sc[i][e] = x;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + tq * 2 + (e & 1);
        float p = exp2f(sc[i][e] * scale_log2 - l2s[col]);
        if (edge) {
          const int key = n0 + warp * 16 + g + (e >= 2 ? 8 : 0);
          const int row = m0 + col;
          if (row >= Sq || key >= Skv || (causal && row + offset < key))
            p = 0.f;
        }
        sc[i][e] = p;
      }
    }

    // dV += P^T dout (P^T re-packed from the accumulators as the A operand)
#pragma unroll
    for (int kk = 0; kk < KV_BM / 16; ++kk) {
      uint32_t a[4];
      a[0] = rfa::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = rfa::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = rfa::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = rfa::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4_trans(
            bfr, dot + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                     dp * 16 + (lane / 16) * 8);
        rfa::mma_bf16_16816(dv_acc[2 * dp], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(dv_acc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }

    // dP^T = V dout^T
    float dpt[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      rfa::ldmatrix_x4(a, vs + (warp * 16 + lane % 16) * LD + kk * 16 +
                              (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4(bfr, dot + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                                  kk * 16 + ((lane / 8) % 2) * 8);
        rfa::mma_bf16_16816(dpt[2 * np], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(dpt[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

    // dS^T = P^T (dP^T - delta) * scale, in place of dP^T
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[i][e] = sc[i][e] * (dpt[i][e] - dls[i * 8 + tq * 2 + (e & 1)]) *
                    ds_scale;
        if constexpr (RING) {
          if (ring.cap2 > 0.f) dpt[i][e] *= dcap[i][e];
        }
      }

    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < KV_BM / 16; ++kk) {
      uint32_t a[4];
      a[0] = rfa::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      a[1] = rfa::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      a[2] = rfa::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      a[3] = rfa::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4_trans(
            bfr, qt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                     dp * 16 + (lane / 16) * 8);
        rfa::mma_bf16_16816(dk_acc[2 * dp], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(dk_acc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }

    if constexpr (DQ) {
      // dS^T to shared memory as [key][q row] ...
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = i * 8 + tq * 2;
        *reinterpret_cast<uint32_t*>(dss + (warp * 16 + g) * LDS + c) =
            rfa::pack_bf16(dpt[i][0], dpt[i][1]);
        *reinterpret_cast<uint32_t*>(dss + (warp * 16 + g + 8) * LDS + c) =
            rfa::pack_bf16(dpt[i][2], dpt[i][3]);
      }
      __syncthreads();
      // ... then dQ = dS K: warp w takes q rows (w % 2) * 16 and head-dim
      // columns (w / 2) * D / 2 of the 32 x D product
      constexpr int QT = D / 16;  // d n-tiles per warp
      const int qr = warp % 2, dc = (warp / 2) * (D / 2);
      float dqa[QT][4];
#pragma unroll
      for (int i = 0; i < QT; ++i)
        dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KV_BN / 16; ++kk) {
        uint32_t a[4];  // dS rows from the stored transpose
        rfa::ldmatrix_x4_trans(
            a, dss + (kk * 16 + lane % 8 + (lane / 16) * 8) * LDS + qr * 16 +
                   ((lane / 8) % 2) * 8);
#pragma unroll
        for (int dp = 0; dp < QT / 2; ++dp) {
          uint32_t bfr[4];
          rfa::ldmatrix_x4_trans(
              bfr, ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dc +
                       dp * 16 + (lane / 16) * 8);
          rfa::mma_bf16_16816(dqa[2 * dp], a, bfr[0], bfr[1]);
          rfa::mma_bf16_16816(dqa[2 * dp + 1], a, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + qr * 16 + g + r * 8;
        if (row >= Sq) continue;
        float* dst = dq_acc + ((long long)(b * Hq + h) * Sq + row) * D + dc +
                     tq * 2;
#pragma unroll
        for (int i = 0; i < QT; ++i)
          atomicAdd(reinterpret_cast<float2*>(dst + i * 8),
                    make_float2(dqa[i][2 * r], dqa[i][2 * r + 1]));
      }
    }
    __syncthreads();  // this stage (and dS^T) is refilled next step
  }
  rfa::cp_async_wait<0>();  // no copy outlives the block (steps == 0)

  // dK, dV of this warp's 16 keys, written once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + warp * 16 + g + r * 8;
    if (key >= Skv) continue;
    const long long base = ((long long)(b * Hkv + hk) * Skv + key) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const long long o = base + i * 8 + tq * 2;
      if constexpr (RING) {
        // this block is the only writer of its keys: a plain read, add
        // and write, in the same order every run
        if (ring.accumulate) {
          const float2 a = *reinterpret_cast<float2*>(
              static_cast<float*>(dk) + o);
          const float2 c = *reinterpret_cast<float2*>(
              static_cast<float*>(dv) + o);
          dk_acc[i][2 * r] += a.x;
          dk_acc[i][2 * r + 1] += a.y;
          dv_acc[i][2 * r] += c.x;
          dv_acc[i][2 * r + 1] += c.y;
        }
      }
      if (dkv_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dk) + o) =
            rfa::pack_bf16(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dv) + o) =
            rfa::pack_bf16(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + o) =
            make_float2(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + o) =
            make_float2(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }
}

template <int D, bool DQ, bool RING = false>
int launch_kv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq_acc, void* dk,
              void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
              const long long* strides, float scale, int causal, int offset,
              int dkv_bf16, cudaStream_t stream, const Ring& ring = Ring{}) {
  auto kern = bwd_kv_kernel<D, DQ, RING>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, KvSmem<D>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid((Skv + KV_BN - 1) / KV_BN, Hkv, B);
  kern<<<grid, KV_THREADS, KvSmem<D>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      dq_acc, dk, dv, Hq, Hkv, Sq, Skv, make_strides(strides), scale, causal,
      offset, dkv_bf16, ring);
  return cudaGetLastError();
}

}  // namespace rfa_bwd
