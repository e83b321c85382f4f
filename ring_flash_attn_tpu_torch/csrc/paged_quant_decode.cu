// Kernel B6: decode attention over a quantized paged KV cache.
//
// Replaces the TPU kernel ring_flash_attn_tpu/ops/paged.py::
// _quant_paged_kernel (wrapper _pallas_quant_paged_decode) and computes
// what its plain version ops/paged.py::_plain_quant_paged_decode computes:
// q (B, Hq, Tq, D) against pages (num_pages, Hkv, page_size, D) in int8 /
// fp8 e4m3 / fp8 e5m2 with fp32 scales (num_pages, Hkv, 1, page_size),
// read through int32 block tables, positions >= seq_lens[b] masked, fp32
// (out, lse); dead lanes (seq_len == 0) give out = 0, lse = NEG_INF.
//
// On int8 pages the function is the TPU kernel's: q * scale is quantized
// per row to int8 (scale max|q| / 127, floor 1e-20, round half to even),
// QK is an exact s8 x s8 -> s32 product (__dp4a here) and the logits are
// that times q_scale * k_scale. fp8 pages are widened and q stays fp32. PV
// uses V widened in both cases.
//
// The loop, what bounds it on the H100 and the design are in
// quant_decode.cuh: a lane's live chunks (64 tokens, never spanning a
// page; PagedSrc) are split over gridDim.x blocks and the partials merged
// in order.
// The scale layout's unit dim exists for the TPU's tiling; the kernel
// indexes (page, head, token) directly.

#include "quant_decode.cuh"

namespace {

using namespace rfa_qd;

template <int QT, int RMAX>
__global__ void __launch_bounds__(NTHREADS)
paged_quant_decode_kernel(const void* __restrict__ q, int q_bf16,
                          const unsigned char* __restrict__ k_pages,
                          const unsigned char* __restrict__ v_pages,
                          const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ seq_lens, int Hkv, int R,
                          int num_pages, int page_size, int npages,
                          float scale, float softcap,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long g = (long long)b * Hkv + h;
  const PagedSrc src =
      paged_src(k_pages, v_pages, k_scales, v_scales, block_tables, seq_lens,
                b, h, Hkv, num_pages, page_size, npages);
  decode_split<QT, QT == QT_INT8, RMAX>(src, q, q_bf16, g * R, R, scale,
                                        softcap, part_acc, part_ml,
                                        (g * gridDim.x + blockIdx.x) * R);
}

template <int QT, int RMAX>
int launch(const void* q, int q_bf16, const void* k_pages,
           const void* v_pages, const float* k_scales, const float* v_scales,
           const int* block_tables, const int* seq_lens, float* out,
           float* lse, float* part_acc, float* part_ml, int B, int Hkv, int R,
           int num_pages, int page_size, int npages, int nsplit, float scale,
           float softcap, cudaStream_t stream) {
  auto kern = paged_quant_decode_kernel<QT, RMAX>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<RMAX>::BYTES);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  kern<<<dim3(nsplit, Hkv, B), NTHREADS, Smem<RMAX>::BYTES, stream>>>(
      q, q_bf16, static_cast<const unsigned char*>(k_pages),
      static_cast<const unsigned char*>(v_pages), k_scales, v_scales,
      block_tables, seq_lens, Hkv, R, num_pages, page_size, npages, scale,
      softcap, part_acc, part_ml);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge_splits(part_acc, part_ml, out, lse, nsplit, R, B * Hkv,
                      stream);
}

template <int QT>
int launch_rows(const void* q, int q_bf16, const void* k_pages,
                const void* v_pages, const float* k_scales,
                const float* v_scales, const int* block_tables,
                const int* seq_lens, float* out, float* lse, float* part_acc,
                float* part_ml, int B, int Hkv, int R, int num_pages,
                int page_size, int npages, int nsplit, float scale,
                float softcap, cudaStream_t stream) {
#define RFA_LAUNCH(RM)                                                       \
  return launch<QT, RM>(q, q_bf16, k_pages, v_pages, k_scales, v_scales,     \
                        block_tables, seq_lens, out, lse, part_acc, part_ml, \
                        B, Hkv, R, num_pages, page_size, npages, nsplit,     \
                        scale, softcap, stream)
  if (R <= 4) RFA_LAUNCH(4);
  if (R <= 8) RFA_LAUNCH(8);
  if (R <= 16) RFA_LAUNCH(16);
#undef RFA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, Tq, D) bf16 or fp32; pages (num_pages, Hkv, page_size, D) one
// byte per value, qtype 0 int8, 1 fp8 e4m3, 2 fp8 e5m2; scales
// (num_pages, Hkv, 1, page_size) fp32; block_tables (B, npages) and
// seq_lens (B,) int32; all contiguous; any page_size >= 1.
// part_acc (B * Hkv, nsplit, R, D) and part_ml (B * Hkv, nsplit, R, 2)
// fp32 scratch, R = (Hq / Hkv) * Tq. out (B, Hq, Tq, D) and lse
// (B, Hq, Tq) fp32. softcap <= 0 disables capping. Returns
// cudaGetLastError().
extern "C" int rfa_paged_quant_decode(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* seq_lens, float* out, float* lse, float* part_acc,
    float* part_ml, int B, int Hq, int Hkv, int Tq, int head_dim,
    int num_pages, int page_size, int npages, int qtype, int nsplit,
    float scale, float softcap, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv || nsplit < 1 || num_pages < 1 ||
      page_size < 1)
    return cudaErrorInvalidValue;
  const int R = (Hq / Hkv) * Tq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RFA_QT(QT)                                                          \
  return launch_rows<QT>(q, q_bf16, k_pages, v_pages, k_scales, v_scales,   \
                         block_tables, seq_lens, out, lse, part_acc,        \
                         part_ml, B, Hkv, R, num_pages, page_size, npages,  \
                         nsplit, scale, softcap, st)
  if (qtype == QT_INT8) RFA_QT(QT_INT8);
  if (qtype == QT_E4M3) RFA_QT(QT_E4M3);
  if (qtype == QT_E5M2) RFA_QT(QT_E5M2);
#undef RFA_QT
  return cudaErrorInvalidValue;
}
