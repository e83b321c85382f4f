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
// QK is an exact s8 x s8 -> s32 product (mma.sync m16n8k32 here) and the
// logits are that times q_scale * k_scale. On fp8 pages q stays fp32 (two
// fp16 halves against the exact fp8 values). PV takes V as it is cached,
// p * v_scale in two fp16 halves, in both cases.
//
// The loop, what bounds it on the H100 and the design are in
// quant_decode.cuh: the lanes' live chunks (64 tokens, never spanning a
// page; PagedSrc) are spread over the grid's blocks by a plan made on the
// device from seq_lens, and a group's pieces merged in order by its last
// block.
// The scale layout's unit dim exists for the TPU's tiling; the kernel
// indexes (page, head, token) directly.

#include "quant_decode.cuh"

namespace {

using namespace rfa_qd;

template <int QT, int RMAX, int D, bool RG>
__global__ void __launch_bounds__(launch_threads<D, RMAX, 1, RG>(), 1)
paged_quant_decode_kernel(const void* __restrict__ q, int q_bf16,
                          const unsigned char* __restrict__ k_pages,
                          const unsigned char* __restrict__ v_pages,
                          const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ seq_lens, int B, int Hkv,
                          int R, int num_pages, int page_size, int npages,
                          float scale, float softcap, Dest dst) {
  const PagedLanes lanes{k_pages,      v_pages,  k_scales, v_scales,
                         block_tables, seq_lens, Hkv,      num_pages,
                         page_size,    npages};
  if constexpr (RG)
    decode_tiles<QT, QT == QT_INT8, D, false>(lanes, B, Hkv, q, q_bf16, R,
                                              scale, softcap, dst);
  else
    decode_lanes<QT, QT == QT_INT8, D, RMAX, false>(lanes, B, Hkv, q, q_bf16,
                                                    R, scale, softcap, dst);
}

// rfa_paged_quant_decode's launch: run<QT, RMAX, D, RG>() launches that
// build (rfa_qd::dispatch picks it)
struct Launch {
  const void* q;
  int q_bf16;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* seq_lens;
  Dest dst;
  int B, Hkv, R, num_pages, page_size, npages, grid;
  float scale, softcap;
  cudaStream_t stream;

  template <int QT, int RMAX, int D, bool RG>
  int run() const {
    auto kern = paged_quant_decode_kernel<QT, RMAX, D, RG>;
    constexpr int bytes = launch_smem<D, RMAX, 1, RG>();
    if (!launch_fits<D, RMAX, 1, RG>(grid, B, Hkv, R))
      return cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      attr = true;
    }
    return launch_build<RG>(
        kern, grid, launch_threads<D, RMAX, 1, RG>(), bytes, stream,
        q, q_bf16, static_cast<const unsigned char*>(k_pages),
        static_cast<const unsigned char*>(v_pages), k_scales, v_scales,
        block_tables, seq_lens, B, Hkv, R, num_pages, page_size, npages,
        scale, softcap, dst);
  }
};

}  // namespace

// q (B, Hq, Tq, D) bf16 or fp32; pages (num_pages, Hkv, page_size, D) one
// byte per value, qtype 0 int8, 1 fp8 e4m3, 2 fp8 e5m2; scales
// (num_pages, Hkv, 1, page_size) fp32; block_tables (B, npages) and
// seq_lens (B,) int32; all contiguous; any page_size >= 1; head_dim D
// 64, 128 or 256. out (B, Hq, Tq, D) and lse (B, Hq, Tq) fp32. `grid`
// blocks share the work; with grid > 1, part_acc, part_ml and counters
// laid out by rp as rfa_quant_decode (quant_decode.cu) takes them.
// softcap <= 0 disables capping. Returns cudaGetLastError().
extern "C" int rfa_paged_quant_decode(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* seq_lens, float* out, float* lse, float* part_acc,
    float* part_ml, int* counters, int B, int Hq, int Hkv, int Tq,
    int head_dim, int num_pages, int page_size, int npages, int qtype,
    int grid, int rp, float scale, float softcap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || grid < 1 || num_pages < 1 || page_size < 1)
    return cudaErrorInvalidValue;
  const int R = (Hq / Hkv) * Tq;
  const Launch launch{q, q_bf16, k_pages, v_pages, k_scales, v_scales,
                      block_tables, seq_lens,
                      Dest{out, lse, part_acc, part_ml, counters}, B, Hkv, R,
                      num_pages, page_size, npages, grid, scale, softcap,
                      static_cast<cudaStream_t>(stream)};
  return dispatch<QT_INT8, QT_E4M3, QT_E5M2>(qtype, head_dim, R, rp, launch);
}
