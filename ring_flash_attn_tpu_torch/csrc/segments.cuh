// Packed sequences in the block kernels B1, B2, B3a and B3b: segment ids
// and explicit positions (the TPU kernels' use_segments / use_positions,
// ring_flash_attn_tpu/ops/pallas_fwd.py:253-300 and :443-490,
// pallas_bwd.py:137-156, 338-358, pallas_bwd_fused.py:189-208).
//
// A pair (q row i, key j) is kept iff seg_q[i] == seg_k[j] and, when the
// call is causal by positions, q_pos[i] >= kv_pos[j] (the kernels' own
// `causal` flag keeps the index form i + offset >= j). The launchers
// compute the tiles' bounds on the card (ops/block_meta.py): rows 0 to 3
// of q_meta and kv_meta are the segment and position ranges of each tile,
// rows 4 and 5 the first and last tile of the other side that a tile
// needs. The kernels walk that range and sort each tile of it three ways,
// as the TPU kernels' _bounds do: skipped (segment ranges disjoint, or
// every q position below every kv position), unmasked (one segment on
// both sides and every pair at or below the diagonal: the mask-free body)
// or masked. The whole block sorts its range once, in parallel, into two
// bits a tile in shared memory past the kernel's barriers (fill_classes);
// producer and consumers then run the same walk over those bits, so the
// pipeline carries the live tiles only. (A first form, which read the
// tile bounds from device memory at every step of every role, ran B1 at
// 9x its bound on the five-sequence packing: NVIDIA H100 80GB HBM3, 700 W,
// profile_torch_fwd.py.)
//
// The masked body, which only tiles that straddle a segment edge or the
// diagonal take, needs the segment ids and positions of the tile's keys (or
// q rows). Each lane of a warp loads two of them (coalesced, issued before
// the tile's products are waited for) and the lanes swap them by warp
// shuffles to where the accumulator fragments need them: 32 shuffles a
// 64-wide tile. (Reading them element by element through the read-only
// cache took 1.3 to 1.7x the time on the five-sequence packing: NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py phase 16.) The q side's own rows are read
// once a block. Compiled apart, as a template flag, so that the mask-free
// instantiations keep their code.
//
// With softcap or ALiBi (the XFORM instantiations, csrc/xform.cuh) positions
// may reach a kernel without a causal mask: ALiBi takes its distance from
// them. Such a kernel tests `pos_causal` where the others test q_pos (they
// get positions only when causal). Where ALiBi meets explicit positions a
// thread knows its own side's positions (its rows, or its keys), and an
// unmasked tile of the other side keeps the unmasked body only where that
// tile's positions run first + step i (q_step, kv_step from
// ops/block_meta.py::tile_steps; keep_affine): the distance is then
// arithmetic. Other tiles take the masked body, whose shuffles hand each
// element its position. (Every live tile in the masked body ran B1 with
// ALiBi at 2.8x the segmented build without XFORM on the five-sequence
// packing; with the steps, 1.5x: NVIDIA H100 80GB HBM3, 700 W, phase 17.)

#pragma once

#include <climits>

// What a segmented call adds (the C interface passes it by pointer).
struct rfa_seg_args {
  const int* q_seg;   // (Sq,) segment ids, or null: no segments
  const int* kv_seg;  // (Skv,)
  const int* q_pos;   // (Sq,) positions, or null: none reach the kernel
  const int* kv_pos;  // (Skv,)
  const int* q_meta;  // (6, n_q) block_meta rows at the kernel's q tiles
  const int* kv_meta; // (6, n_kv) at its kv tiles
  int n_q, n_kv;
  int tri;  // causal by positions with packed_self: keys past the q tile's
            // last row by index are never needed (offset 0)
  int pos_causal;  // causal by positions (read by the XFORM instantiations;
                   // the others take a non-null q_pos to mean it)
  // XFORM with ALiBi on positions: each tile's step (n_q,) / (n_kv,), or
  // INT_MIN where its positions are not first + step i
  const int* q_step;
  const int* kv_step;
};

namespace rfa_seg {

struct Bounds {
  int smin, smax, pmin, pmax;
};

__device__ __forceinline__ Bounds tile(const int* meta, int n, int t) {
  return {__ldg(meta + t), __ldg(meta + n + t), __ldg(meta + 2 * n + t),
          __ldg(meta + 3 * n + t)};
}

__device__ __forceinline__ int range_lo(const int* meta, int n, int t) {
  return __ldg(meta + 4 * n + t);
}

__device__ __forceinline__ int range_hi(const int* meta, int n, int t) {
  return __ldg(meta + 5 * n + t);
}

// 0: the tile pair is skipped; 1: masked; 2: unmasked (as far as segments
// and positions go: the ragged edge and the index diagonal are the
// kernels' own tests)
__device__ __forceinline__ int classify(const Bounds& q, const Bounds& k,
                                        bool pos) {
  if (q.smax < k.smin || k.smax < q.smin) return 0;
  if (pos && q.pmax < k.pmin) return 0;
  const bool one_seg = q.smin == q.smax && k.smin == k.smax &&
                       q.smin == k.smin;
  return one_seg && (!pos || q.pmin >= k.pmax) ? 2 : 1;
}

// a block's shared memory on the H100 (cudaFuncSetAttribute's limit)
constexpr int MAX_SMEM = 232448;

// bytes of shared memory the classes of n tiles take
__host__ __device__ constexpr int class_bytes(int n) {
  return 4 * ((n + 15) / 16);
}

__device__ __forceinline__ int class_of(const uint32_t* bits, int i) {
  return (bits[i >> 4] >> (2 * (i & 15))) & 3;
}

// The classes of the other side's tiles [t_lo, t_hi] against this block's
// tile `mine` (a q tile when mine_is_q, else a kv tile), two bits each
// into `bits`, by all NT threads of the block (it synchronises them);
// returns the number of live tiles.
template <int NT>
__device__ int fill_classes(uint32_t* bits, const Bounds& mine,
                            const int* meta, int n, int t_lo, int t_hi,
                            bool pos, bool mine_is_q) {
  const int len = t_hi - t_lo + 1;
  const int words = len > 0 ? (len + 15) / 16 : 0;
  for (int w = threadIdx.x; w < words; w += NT) bits[w] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += NT) {
    const Bounds o = tile(meta, n, t_lo + i);
    const int c = mine_is_q ? classify(mine, o, pos) : classify(o, mine, pos);
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

// The number of live tiles among [t_lo, t_hi], cls(t) giving tile t's
// class, by all NT threads of the block, summed in the shared int `count`
// (it synchronises them): fill_classes' count where a kernel classifies
// its tiles as it walks them instead of keeping a table.
template <int NT, class Cls>
__device__ int count_live(int* count, int t_lo, int t_hi, Cls cls) {
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  int live = 0;
  for (int t = t_lo + threadIdx.x; t <= t_hi; t += NT) live += cls(t) != 0;
  if (live) atomicAdd(count, live);
  __syncthreads();
  return *count;
}

// The segment ids and positions of entries i and i + 1 of (seg, pos), 0
// past n or where the array is null: a lane's share of a tile.
struct Pair {
  int s[2], p[2];
};

__device__ __forceinline__ Pair load_pair(const int* seg, const int* pos,
                                          int i, int n) {
  Pair v{{0, 0}, {0, 0}};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (i + e < n) {
      if (seg) v.s[e] = __ldg(seg + i + e);
      if (pos) v.p[e] = __ldg(pos + i + e);
    }
  }
  return v;
}

// The unmasked classes of the other side's tiles [t_lo, t_lo + len) made
// "masked" where the tile's positions have no step (steps: the other
// side's q_step or kv_step from t_lo on), by all NT threads of the block,
// after fill_classes.
template <int NT>
__device__ void keep_affine(uint32_t* bits, const int* steps, int len) {
  const int words = len > 0 ? (len + 15) / 16 : 0;
  __syncthreads();
  for (int w = threadIdx.x; w < words; w += NT) {
    uint32_t x = bits[w];
    for (int j = 0; j < 16 && 16 * w + j < len; ++j)
      if (((x >> (2 * j)) & 3u) == 2u &&
          __ldg(steps + 16 * w + j) == INT_MIN)
        x ^= 3u << (2 * j);  // class 2 -> 1
    bits[w] = x;
  }
  __syncthreads();
}

// entry e of lane src's Pair, to every lane (all 32 lanes take part)
__device__ __forceinline__ void take(const Pair& v, int src, int e, int& s,
                                     int& p) {
  s = __shfl_sync(0xffffffffu, v.s[e], src);
  p = __shfl_sync(0xffffffffu, v.p[e], src);
}

// is the pair (q row of segment qs, position qp; key of segment ks,
// position kp) dropped by segments or by the positions' diagonal? (XF: an
// XFORM instantiation, which may hold positions without causal)
template <bool XF = false>
__device__ __forceinline__ bool drop(const rfa_seg_args& sg, int qs, int qp,
                                     int ks, int kp) {
  return (sg.q_seg && qs != ks) ||
         ((XF ? sg.pos_causal != 0 : sg.q_pos != nullptr) && qp < kp);
}

// the `pos` argument of fill_classes: tiles are skipped on positions only
// under a causal mask on them
template <bool XF = false>
__device__ __forceinline__ bool skip_on_positions(const rfa_seg_args& sg) {
  return XF ? sg.pos_causal != 0 : sg.q_pos != nullptr;
}

}  // namespace rfa_seg
