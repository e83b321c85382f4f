// Kernel B5: bf16 paged decode attention.
//
// Replaces the TPU kernel ring_flash_attn_tpu/ops/paged.py::_paged_kernel
// (wrapper _pallas_paged_decode) and computes what its plain version
// ops/paged.py::_plain_paged_decode computes: for lane b and q row
// (g-major, t-minor) of kv head h, attention over the first
// bound = seq_len - max(0, new_count - 1 - t) tokens of the lane's pages,
// read through the block table, with optional tanh softcap. fp32
// (out, lse) partials; dead lanes (seq_len == 0) give out = 0 and
// lse = NEG_INF.
//
// What bounds it on the H100: bytes. Each K/V token is used by only the
// G * Tq query rows of its kv head (4 at Llama-3-8B widths), about one
// flop per byte, so the bound is reading the live K/V pages once at
// 3.35 TB/s. The design serves that with the loop of B4 and B6
// (quant_decode.cuh's decode_lanes, given a bf16 value type with unit
// scales and per-row bounds; B5 has no loop of its own):
//
//  - a block's piece of a (lane, kv head) group serves all G * Tq rows of
//    the head's group, so each K/V page is read from device memory once
//    (past max_rows(D) rows the row-tile loop, decode_tiles: a cluster of
//    blocks a piece of a tile of up to 128 rows, its chunks over pages of
//    fewer than 64 tokens, merged across the cluster);
//  - the lanes' live chunks (64 tokens, never spanning a page; PagedSrc)
//    are spread over the grid's blocks of 1 to 3 pipelines by a plan made
//    on the device from seq_lens (quant_decode.cuh::plan_piece), whole
//    blocks a group, so that a few ragged lanes fill the 132 SMs; a
//    group's last block merges its pieces in order (bitwise reproducible);
//  - QK and PV on tensor cores in bf16, q and p each in two bf16 halves
//    against the exact bf16 cache.
//
// Times against the earlier loop, measured in turns on the H100, are in
// PERF.md section 6. The TPU kernel's all-heads block-diagonal matmul
// answers the TPU's vector-issue overhead and is not carried over.

#include "quant_decode.cuh"

namespace {

using namespace rfa_qd;

// PagedSrc with B5's per-row bounds: row r (t = r % Tq) sees the first
// len - max(0, cnt - 1 - t) positions of the lane.
struct BoundedPagedSrc : PagedSrc {
  int cnt, Tq;

  __device__ __forceinline__ int bound(int r) const {
    return len - max(0, cnt - 1 - r % Tq);
  }
};

// PagedLanes whose groups carry the lane's new_counts.
struct BoundedLanes : PagedLanes {
  const int* new_counts;
  int Tq;

  __device__ __forceinline__ BoundedPagedSrc src(int b, int h) const {
    return BoundedPagedSrc{PagedLanes::src(b, h),
                           new_counts ? new_counts[b] : 1, Tq};
  }
};

template <int RMAX, int D, bool RG>
__global__ void __launch_bounds__(launch_threads<D, RMAX, 2, RG>(), 1)
paged_decode_kernel(const void* __restrict__ q, int q_bf16,
                    const unsigned char* __restrict__ k_pages,
                    const unsigned char* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens,
                    const int* __restrict__ new_counts, int B, int Hkv,
                    int Tq, int R, int num_pages, int page_size, int npages,
                    float scale, float softcap, Dest dst) {
  const BoundedLanes lanes{
      PagedLanes{k_pages, v_pages, nullptr, nullptr, block_tables, seq_lens,
                 Hkv, num_pages, page_size, npages},
      new_counts, Tq};
  if constexpr (RG)
    decode_tiles<QT_BF16, false, D, true>(lanes, B, Hkv, q, q_bf16, R, scale,
                                          softcap, dst);
  else
    decode_lanes<QT_BF16, false, D, RMAX, true>(lanes, B, Hkv, q, q_bf16, R,
                                                scale, softcap, dst);
}

// rfa_paged_decode's launch: run<QT_BF16, RMAX, D, RG>() launches that
// build (rfa_qd::dispatch picks it)
struct Launch {
  const void* q;
  int q_bf16;
  const void* k_pages;
  const void* v_pages;
  const int* block_tables;
  const int* seq_lens;
  const int* new_counts;
  Dest dst;
  int B, Hkv, Tq, R, num_pages, page_size, npages, grid;
  float scale, softcap;
  cudaStream_t stream;

  template <int QT, int RMAX, int D, bool RG>
  int run() const {
    static_assert(QT == QT_BF16, "B5 reads bf16 pages");
    auto kern = paged_decode_kernel<RMAX, D, RG>;
    constexpr int EB = value_bytes<QT_BF16>();
    constexpr int bytes = launch_smem<D, RMAX, EB, RG>();
    if (!launch_fits<D, RMAX, EB, RG>(grid, B, Hkv, R))
      return cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      attr = true;
    }
    return launch_build<RG>(
        kern, grid, launch_threads<D, RMAX, EB, RG>(), bytes, stream,
        q, q_bf16, static_cast<const unsigned char*>(k_pages),
        static_cast<const unsigned char*>(v_pages), block_tables, seq_lens,
        new_counts, B, Hkv, Tq, R, num_pages, page_size, npages, scale,
        softcap, dst);
  }
};

}  // namespace

// q (B, Hq, Tq, D) bf16 or fp32; pages (num_pages, Hkv, page_size, D) bf16;
// block_tables (B, npages) int32; seq_lens, new_counts (B,) int32 (new_counts
// may be null: every row sees the whole lane); all contiguous; any
// page_size >= 1; head_dim D 64, 128 or 256. out (B, Hq, Tq, D) and lse
// (B, Hq, Tq) fp32. `grid` blocks share the work; with grid > 1,
// part_acc, part_ml and counters laid out by rp as rfa_quant_decode
// (quant_decode.cu) takes them. softcap <= 0 disables capping. Returns
// cudaGetLastError().
extern "C" int rfa_paged_decode(const void* q, int q_bf16,
                                const void* k_pages, const void* v_pages,
                                const int* block_tables, const int* seq_lens,
                                const int* new_counts, float* out, float* lse,
                                float* part_acc, float* part_ml,
                                int* counters, int B, int Hq, int Hkv, int Tq,
                                int head_dim, int num_pages, int page_size,
                                int npages, int grid, int rp, float scale,
                                float softcap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || grid < 1 || num_pages < 1 || page_size < 1)
    return cudaErrorInvalidValue;
  const int R = (Hq / Hkv) * Tq;
  const Launch launch{q, q_bf16, k_pages, v_pages, block_tables, seq_lens,
                      new_counts, Dest{out, lse, part_acc, part_ml, counters},
                      B, Hkv, Tq, R, num_pages, page_size, npages, grid,
                      scale, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<QT_BF16>(QT_BF16, head_dim, R, rp, launch);
}
