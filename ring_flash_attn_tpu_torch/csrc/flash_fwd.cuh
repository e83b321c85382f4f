// The flash-attention forward tile loop, shared by kernel B1
// (csrc/flash_fwd.cu: one call is one whole attention block) and kernel B7
// (csrc/fused_ring_fwd.cu: one call is one step of a ring, with the online
// softmax state carried in device memory from step to step).
//
//  - one block of 4 warps per (batch, q head, 64-row q tile); each warp owns
//    16 q rows, keeps its Q fragments in registers, and its running max m,
//    sum l and output accumulator in fp32 registers;
//  - a loop over 64-row kv tiles up to the causal bound (tiles past the
//    diagonal are never visited), double-buffered in shared memory with
//    cp.async so the next tile loads while this one is computed;
//  - S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in, fp32 out); the
//    S accumulators are re-packed in registers as the A operand of P V;
//  - the softmax in base 2 with scale * log2(e) applied to the fp32 logits;
//    lse converts back to natural log at the end;
//  - ragged tiles (Sq or Skv not a multiple of 64) are zero-filled by the
//    copy and masked, never assumed away.
//
// With RING the block applies softcap and ALiBi to the base-2 logits (XFORM),
// folds the state (m, l, acc) of the earlier steps into its own in the
// epilogue unless the step is the rank's first, and writes the state back
// instead of out and lse unless the step is the rank's last. The tile loop
// itself always starts from (-inf, 0, 0): the same arithmetic as starting
// from the loaded state, but measured 10% faster on the H100 (loaded values
// at the loop's entry cost the compiler B1's schedule; the loop's
// instruction mix was the same). Without RING all of that compiles out and
// the kernel is B1's.

#pragma once

#include "common.cuh"

namespace rfa_fwd {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int NWARPS = 4;     // 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;

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

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // +16 B per row: conflict-free ldmatrix
  static constexpr int Q = 0;
  static constexpr int KV = BM * LD;                // stage s: K at KV + s*2*BN*LD
  static constexpr int ELEMS = (BM + 2 * 2 * BN) * LD;
  static constexpr int BYTES = ELEMS * 2;
};

// Copy `rows` rows (row r at src + r * stride, D bf16 each) into shared
// memory with leading dimension LD; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int LD = Smem<D>::LD;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    int r = i / CHUNKS, c = i % CHUNKS;
    bool ok = r < valid;
    const __nv_bfloat16* g = ok ? src + r * stride + c * 8 : src;
    rfa::cp_async16(dst + r * LD + c * 8, g, ok ? 16 : 0);
  }
}

// XFORM: the ring step has softcap or ALiBi. Compiled apart so that the
// common step keeps B1's straight-line tile body: with one kernel and a
// uniform run-time branch around the transform, the headline off-diagonal
// step took 5.3 ms on the H100 where this takes 5.0.
template <int D, bool RING, bool XFORM = false>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, void* __restrict__ out,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 float scale_log2, int causal, int offset, int out_bf16,
                 Ring ring) {
  constexpr int LD = Smem<D>::LD;
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NT = BN / 8;   // n-tiles of S per warp
  constexpr int DT = D / 8;    // n-tiles of O per warp
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  // heaviest causal q tiles first: they have the most kv tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int m0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + (long long)m0 * q_ss;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  // kv tiles [0, n_end): the causal bound of this q tile's last row
  int n_end = Skv;
  if (causal) n_end = min(Skv, max(0, m0 + BM + offset));
  const int n_tiles = (n_end + BN - 1) / BN;

  __nv_bfloat16* qs = smem + Smem<D>::Q;
  auto ks = [&](int s) { return smem + Smem<D>::KV + s * 2 * BN * LD; };
  auto vs = [&](int s) { return ks(s) + BN * LD; };

  load_rows<D, BM>(qs, qb, q_ss, Sq - m0);
  if (n_tiles > 0) {
    load_rows<D, BN>(ks(0), kb, k_ss, Skv);
    load_rows<D, BN>(vs(0), vb, v_ss, Skv);
  }
  rfa::cp_async_commit();

  uint32_t qf[KD][4];
  float o[DT][4];
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  float slope = 0.f, inv_cap2 = 0.f;
  if constexpr (XFORM) {
    if (ring.slopes) slope = ring.slopes[h];
    if (ring.cap2 > 0.f) inv_cap2 = 1.f / ring.cap2;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    if (j + 1 < n_tiles) {
      const int s = (j + 1) & 1;
      load_rows<D, BN>(ks(s), kb + (long long)(n0 + BN) * k_ss, k_ss,
                       Skv - n0 - BN);
      load_rows<D, BN>(vs(s), vb + (long long)(n0 + BN) * v_ss, v_ss,
                       Skv - n0 - BN);
      rfa::cp_async_commit();
      rfa::cp_async_wait<1>();
    } else {
      rfa::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        rfa::ldmatrix_x4(qf[kk],
                         qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                             (lane / 16) * 8);
    }
    const __nv_bfloat16* kt = ks(j & 1);
    const __nv_bfloat16* vt = vs(j & 1);

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4(bfr, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                                  kk * 16 + ((lane / 8) % 2) * 8);
        rfa::mma_bf16_16816(s[2 * np], qf[kk], bfr[0], bfr[1]);
        rfa::mma_bf16_16816(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // a ring step's q arrives pre-scaled to base 2 (scale_log2 is 1): its
    // logits go through softcap, then ALiBi on global positions, where the
    // ring has them
    if constexpr (XFORM) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e];
          if (ring.cap2 > 0.f) x = ring.cap2 * tanhf(x * inv_cap2);
          if (ring.slopes) {
            const int row = m0 + warp * 16 + g + (e >= 2 ? 8 : 0);
            const int col = n0 + i * 8 + tq * 2 + (e & 1);
            float dist = (float)((ring.q_pos0 + row) - (ring.kv_pos0 + col));
            if (ring.alibi_abs) dist = fabsf(dist);
            x -= slope * dist;
          }
          s[i][e] = x;
        }
      }
    }

    // scale to base-2 logits; mask the ragged edge and the causal diagonal
    const bool edge = n0 + BN > Skv || (causal && n0 + BN - 1 > m0 + offset);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale_log2;
        if (edge) {
          int row = m0 + warp * 16 + g + (e >= 2 ? 8 : 0);
          int col = n0 + i * 8 + tq * 2 + (e & 1);
          if (col >= Skv || (causal && row + offset < col)) x = -INFINITY;
        }
        s[i][e] = x;
      }
    }

    // online softmax: rows g (r = 0) and g + 8 (r = 1) of this warp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NT; ++i)
        mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      // a row with no live key yet keeps m = -inf; exponentiate against 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[r] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        s[i][2 * r] = exp2f(s[i][2 * r] - m_use);
        s[i][2 * r + 1] = exp2f(s[i][2 * r + 1] - m_use);
        rs += s[i][2 * r] + s[i][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + rs;  // per-thread partial, reduced at end
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        o[i][2 * r] *= alpha;
        o[i][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the S accumulators are already in A-fragment order
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = rfa::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = rfa::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = rfa::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = rfa::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        rfa::ldmatrix_x4_trans(
            bfr, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                     dp * 16 + (lane / 16) * 8);
        rfa::mma_bf16_16816(o[2 * dp], a, bfr[0], bfr[1]);
        rfa::mma_bf16_16816(o[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }
  rfa::cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

  // epilogue: (a ring step: fold in the state of the earlier steps, and
  // hand the state on unless this is the rank's last step;) normalise,
  // flush dead rows to (0, NEG_INF)
  const float LN2 = 0.69314718055994531f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const int row = m0 + warp * 16 + g + r * 8;
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
        for (int i = 0; i < DT; ++i) {
          const float2 x = *reinterpret_cast<const float2*>(a + i * 8);
          o[i][2 * r] = x.x * a_old + o[i][2 * r] * a_new;
          o[i][2 * r + 1] = x.y * a_old + o[i][2 * r + 1] * a_new;
        }
      }
      if (!ring.last) {
        if (tq == 0) {
          ring.m[idx] = fmaxf(m_tot, RFA_NEG_INF);
          ring.l[idx] = l;
        }
        float* a = ring.acc + idx * D + tq * 2;
#pragma unroll
        for (int i = 0; i < DT; ++i)
          *reinterpret_cast<float2*>(a + i * 8) =
              make_float2(o[i][2 * r], o[i][2 * r + 1]);
        continue;
      }
    }
    const bool dead = !(l > 0.f);
    const float inv = dead ? 0.f : 1.f / l;
    const long long orow = idx * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int col = i * 8 + tq * 2;
      const float x0 = o[i][2 * r] * inv, x1 = o[i][2 * r + 1] * inv;
      if (out_bf16) {
        *reinterpret_cast<uint32_t*>(
            static_cast<__nv_bfloat16*>(out) + orow + col) =
            rfa::pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + orow + col) =
            make_float2(x0, x1);
      }
    }
    if (tq == 0) lse[idx] = dead ? RFA_NEG_INF : (m_tot + log2f(l)) * LN2;
  }
}

// strides: q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s in elements.
// Returns cudaGetLastError().
template <int D, bool RING, bool XFORM = false>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
           float scale_log2, int causal, int offset, int out_bf16,
           const Ring& ring, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, RING, XFORM>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid((Sq + BM - 1) / BM, Hq, B);
  kern<<<grid, NTHREADS, Smem<D>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, lse, Hq, Hkv, Sq, Skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2,
      causal, offset, out_bf16, ring);
  return cudaGetLastError();
}

}  // namespace rfa_fwd
