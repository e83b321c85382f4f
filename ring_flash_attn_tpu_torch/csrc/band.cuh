// Sliding windows and dropout in the block kernels B1, B2, B3a and B3b (the
// TPU kernels' window_left / window_right and dropout_p,
// ring_flash_attn_tpu/ops/pallas_fwd.py:267-291 and :405-411,
// pallas_bwd.py:135-147, :182-186, :336-349 and :378-396,
// pallas_bwd_fused.py).
//
// Window: a pair (q row, key) is kept iff d = q_pos - kv_pos <= wl and
// -d <= wr, on the mask's absolute positions: the explicit positions where
// the kernel holds them (csrc/segments.cuh), else row - col + pos_off (the
// index plus the offsets, rfa_xform_args::pos_off). A side without a bound
// is INT_MAX; the launcher passes wr = INT_MAX under a causal mask, which
// bounds the right side at 0 already. Where positions are the index, the
// kernels narrow their tile ranges to the band (the first and last kv tile
// of a q tile, the first and last q step of a kv tile) and test only the
// tiles that cross one of its edges; with explicit positions the tiles'
// classes take the band (fill_classes below): a tile wholly outside it is
// skipped, one wholly inside it keeps the unmasked body, the others take
// the masked body, which tests each pair.
//
// Dropout: the pair is kept iff mix32(row_hash ^ kv_pos * H_K) >= thr,
// row_hash = mix32(q_pos * H_Q + 0xDEADBEEF + seed + (head + head_offset)
// * H_HEAD + batch * H_BATCH + q_seg * H_SEG), in uint32 arithmetic on the
// absolute positions (explicit, or q_pos0 + row and kv_pos0 + col), the JAX
// package's hash bit for bit (ops/mask.py), so that every block shape, the
// forward and the backward and every rank of a schedule drop the same
// pairs. The forward zeroes the dropped p in the operand of P V, sums l
// over the undropped p and scales out by 1 / (1 - p); the backward takes
// dV from the dropped p, masks and scales dP, and takes dS from the
// undropped p. A row's hash is made once a row (B1, B3a: a thread's two
// rows; B2, B3b: by the producer warp beside lse and delta, a q step's 64
// rows into shared memory), kv_pos * H_K once a key, so that a pair costs
// one xor and mix32.
//
// Compiled apart (a template parameter BAND, beside XFORM), so that every
// instantiation without it keeps its code. BAND is WINDOW for a window
// alone (no dropout, softcap or ALiBi), which the backward runs on the
// mask-free body's P (and the segmented body's on a masked tile) with the
// band's test; ALL for the rest, with softcap and ALiBi (cap2 0 and null
// slopes where the call has neither), the hash and a per-element P body.
// One build of both had ptxas serialise the kv-major loop's wgmma for
// registers (C7512) and ran dropout 10 to 16% slower than without the
// window-alone body (NVIDIA H100 80GB HBM3, 700 W; PERF.md).

#pragma once

#include <climits>
#include <cstdint>

#include "segments.cuh"

// What a call with a window or dropout adds (the C interface passes it by
// pointer).
struct rfa_band_args {
  int wl, wr;            // the window's sides; INT_MAX: no bound
  uint32_t thr;          // dropout: keep iff the hash >= thr; 0: none
  float inv_keep;        // 1 / (1 - p)
  uint32_t seed;         // the seed, where seed_ptr is null
  const int* seed_ptr;   // the seed on the card (one int), or null
  uint32_t head_offset;  // global id of q head 0
  uint32_t q_pos0;       // absolute positions of q row 0 and of key 0 where
  uint32_t kv_pos0;      // the kernel holds no explicit positions
};

namespace rfa_band {

// the values of the kernels' BAND template parameter (0: no band)
constexpr int WINDOW = 1;  // a window alone: thr 0, cap2 0, null slopes
constexpr int ALL = 2;     // dropout, softcap or ALiBi, with or without one

constexpr uint32_t H_Q = 0x9E3779B1u;
constexpr uint32_t H_K = 0x85EBCA77u;
constexpr uint32_t H_HEAD = 0xC2B2AE35u;
constexpr uint32_t H_BATCH = 0x27D4EB2Fu;
constexpr uint32_t H_SEG = 0x165667B1u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the part of a row's hash shared by a head's rows: seed, head, batch
__device__ __forceinline__ uint32_t head_base(const rfa_band_args& bd,
                                              int h, int b) {
  const uint32_t seed =
      bd.seed_ptr ? (uint32_t)__ldg(bd.seed_ptr) : bd.seed;
  return 0xDEADBEEFu + seed + ((uint32_t)h + bd.head_offset) * H_HEAD +
         (uint32_t)b * H_BATCH;
}

__device__ __forceinline__ uint32_t row_hash(uint32_t base, uint32_t qp,
                                             uint32_t qseg) {
  return mix32(qp * H_Q + base + qseg * H_SEG);
}

// is the pair of row hash rh and key hash kh = kv_pos * H_K kept?
__device__ __forceinline__ bool keep(uint32_t rh, uint32_t kh,
                                     uint32_t thr) {
  return mix32(rh ^ kh) >= thr;
}

// is the pair at d = q_pos - kv_pos outside the window?
__device__ __forceinline__ bool outside(const rfa_band_args& bd, int d) {
  return d > bd.wl || d < -bd.wr;
}

// q_pos - kv_pos of two explicit positions, wrapped to 32 bits as the JAX
// package's int32 arithmetic wraps
__device__ __forceinline__ int diff(int qp, int kp) {
  return (int)((uint32_t)qp - (uint32_t)kp);
}

// rfa_seg::classify with the window on the tiles' explicit positions (pos:
// the kernel holds them): skipped where every pair lies outside the band,
// unmasked only where every pair lies inside it
__device__ __forceinline__ int classify(const rfa_seg::Bounds& q,
                                        const rfa_seg::Bounds& k,
                                        bool causal_pos, bool pos,
                                        const rfa_band_args& bd) {
  const int c = rfa_seg::classify(q, k, causal_pos);
  if (c == 0 || !pos) return c;
  const long long lo = (long long)q.pmin - k.pmax;
  const long long hi = (long long)q.pmax - k.pmin;
  if (lo > bd.wl || hi < -(long long)bd.wr) return 0;
  if (hi > bd.wl || lo < -(long long)bd.wr) return 1;
  return c;
}

// rfa_seg::fill_classes with the band's classify
template <int NT>
__device__ int fill_classes(uint32_t* bits, const rfa_seg::Bounds& mine,
                            const int* meta, int n, int t_lo, int t_hi,
                            bool causal_pos, bool pos, bool mine_is_q,
                            const rfa_band_args& bd) {
  const int len = t_hi - t_lo + 1;
  const int words = len > 0 ? (len + 15) / 16 : 0;
  for (int w = threadIdx.x; w < words; w += NT) bits[w] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += NT) {
    const rfa_seg::Bounds o = rfa_seg::tile(meta, n, t_lo + i);
    const int c = mine_is_q ? classify(mine, o, causal_pos, pos, bd)
                            : classify(o, mine, causal_pos, pos, bd);
    if (c) atomicOr(&bits[i >> 4], (uint32_t)c << (2 * (i & 15)));
  }
  __syncthreads();
  int live = 0;
  for (int w = 0; w < words; ++w) {
    const uint32_t x = bits[w];
    live += __popc((x | (x >> 1)) & 0x55555555u);
  }
  return live;
}

// The tiles of `blk` entries on the other side that the band by index
// reaches from this block's entries [a0, a0 + na), where the other side's
// entry j pairs with entry i at d = i - j + off (q side: mine_is_q) or d =
// j - i + off: [lo, hi) of tiles, clamped to [0, n_tiles).
__device__ __forceinline__ void index_tiles(const rfa_band_args& bd, int a0,
                                            int na, int off, int blk,
                                            int n_tiles, bool mine_is_q,
                                            int& lo, int& hi) {
  // the other side's entries j with d in [-wr, wl]
  long long jlo, jhi;  // inclusive
  if (mine_is_q) {  // d = i - j + off: j in [i + off - wl, i + off + wr]
    jlo = (long long)a0 + off - bd.wl;
    jhi = (long long)a0 + na - 1 + off + bd.wr;
  } else {  // d = j - i + off: j in [i - off - wr, i - off + wl]
    jlo = (long long)a0 - off - bd.wr;
    jhi = (long long)a0 + na - 1 - off + bd.wl;
  }
  const long long tl = jlo <= 0 ? 0 : jlo / blk;
  const long long th = jhi < 0 ? 0 : jhi / blk + 1;
  lo = (int)min(tl, (long long)n_tiles);
  hi = (int)min(th, (long long)n_tiles);
}

}  // namespace rfa_band
