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
// (quant_decode.cuh's decode_split, given a bf16 value type with unit
// scales and per-row bounds; B5 has no loop of its own):
//
//  - one block per (lane, kv head, split) serves all G * Tq rows of the
//    head's group, so each K/V page is read from device memory once;
//  - a lane's live chunks (64 tokens, never spanning a page; PagedSrc)
//    are split over gridDim.x blocks, chosen from shapes only
//    (ops/quant_decode_cuda.py::num_splits), so that a few lanes fill the
//    132 SMs; a block past its lane's length writes an empty partial, and
//    merge_splits_kernel merges the partials in split order (bitwise
//    reproducible);
//  - scores and P V are fp32 FMAs (q stays fp32; no tensor cores: with 4
//    to 16 rows the work is too thin for them to matter), each warp taking
//    a quarter of a chunk's tokens in P V, so the warps' sums meet once a
//    block.
//
// Measured (profile_torch_decode.py, NVIDIA H100 80GB HBM3, 700 W, device
// time, in turns with the first port of this kernel, which ran one block
// per (lane, kv head) over its chunks in turn with four barriers each): at
// the serving table's shape, q (8, 32, 1, 128), lens 0 to 4096, pages of
// 256, 0.049 ms, 4.0x its byte bound (0.261); at the engine's 4 lanes
// 0.026 (0.196); with R = 16 rows (Tq = 4) 0.116 (1.21), 9.3x its bound,
// the chunk's FMAs and q reads growing with the rows. The TPU kernel's all-heads block-diagonal
// matmul answers the TPU's vector-issue overhead and is not carried over.

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

template <int RMAX>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const void* __restrict__ q, int q_bf16,
                    const unsigned char* __restrict__ k_pages,
                    const unsigned char* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens,
                    const int* __restrict__ new_counts, int Hkv, int Tq,
                    int R, int num_pages, int page_size, int npages,
                    float scale, float softcap, float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long g = (long long)b * Hkv + h;
  const BoundedPagedSrc src{
      paged_src(k_pages, v_pages, nullptr, nullptr, block_tables, seq_lens,
                b, h, Hkv, num_pages, page_size, npages),
      new_counts ? new_counts[b] : 1, Tq};
  decode_split<QT_BF16, false, RMAX, true>(src, q, q_bf16, g * R, R, scale,
                                           softcap, part_acc, part_ml,
                                           (g * gridDim.x + blockIdx.x) * R);
}

template <int RMAX>
int launch(const void* q, int q_bf16, const void* k_pages,
           const void* v_pages, const int* block_tables, const int* seq_lens,
           const int* new_counts, float* out, float* lse, float* part_acc,
           float* part_ml, int B, int Hkv, int Tq, int R, int num_pages,
           int page_size, int npages, int nsplit, float scale, float softcap,
           cudaStream_t stream) {
  auto kern = paged_decode_kernel<RMAX>;
  constexpr int bytes = Smem<RMAX, value_bytes<QT_BF16>()>::BYTES;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  kern<<<dim3(nsplit, Hkv, B), NTHREADS, bytes, stream>>>(
      q, q_bf16, static_cast<const unsigned char*>(k_pages),
      static_cast<const unsigned char*>(v_pages), block_tables, seq_lens,
      new_counts, Hkv, Tq, R, num_pages, page_size, npages, scale, softcap,
      part_acc, part_ml);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge_splits(part_acc, part_ml, out, lse, nsplit, R, B * Hkv,
                      stream);
}

}  // namespace

// q (B, Hq, Tq, D) bf16 or fp32; pages (num_pages, Hkv, page_size, D) bf16;
// block_tables (B, npages) int32; seq_lens, new_counts (B,) int32 (new_counts
// may be null: every row sees the whole lane); all contiguous; any
// page_size >= 1. part_acc (B * Hkv, nsplit, R, D) and part_ml
// (B * Hkv, nsplit, R, 2) fp32 scratch, R = (Hq / Hkv) * Tq. out
// (B, Hq, Tq, D) and lse (B, Hq, Tq) fp32. softcap <= 0 disables capping.
// Returns cudaGetLastError().
extern "C" int rfa_paged_decode(const void* q, int q_bf16,
                                const void* k_pages, const void* v_pages,
                                const int* block_tables, const int* seq_lens,
                                const int* new_counts, float* out, float* lse,
                                float* part_acc, float* part_ml, int B,
                                int Hq, int Hkv, int Tq, int head_dim,
                                int num_pages, int page_size, int npages,
                                int nsplit, float scale, float softcap,
                                void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv || nsplit < 1 || num_pages < 1 ||
      page_size < 1)
    return cudaErrorInvalidValue;
  const int R = (Hq / Hkv) * Tq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RFA_LAUNCH(RM)                                                       \
  return launch<RM>(q, q_bf16, k_pages, v_pages, block_tables, seq_lens,     \
                    new_counts, out, lse, part_acc, part_ml, B, Hkv, Tq, R,  \
                    num_pages, page_size, npages, nsplit, scale, softcap, st)
  if (R <= 4) RFA_LAUNCH(4);
  if (R <= 8) RFA_LAUNCH(8);
  if (R <= 16) RFA_LAUNCH(16);
#undef RFA_LAUNCH
  return cudaErrorInvalidValue;
}
