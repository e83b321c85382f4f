// Shared device helpers for the port's kernels (sm_90a, plain C interface).
//
// Each kernel source is built into its own shared library by
// ops/_build.py and loaded with ctypes, so the C-linkage helper below is
// defined once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Masked-logit sentinel of the (out, lse) contract: dead rows report
// lse = NEG_INF (never -inf) so a partial merge weights them zero.
#define RFA_NEG_INF (-1e30f)

extern "C" const char* rfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace rfa {

// The head dims every attention kernel is built for. An entry point names
// its build once, for the constant head dim of `d`:
//   by_head_dim(D, [&](auto d) { return launch<decltype(d)::value>(...); })
// cudaErrorInvalidValue for any other D.
template <class F>
int by_head_dim(int D, const F& f) {
  if (D == 128) return f(std::integral_constant<int, 128>{});
  if (D == 64) return f(std::integral_constant<int, 64>{});
  if (D == 256) return f(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with
// zeros without reading global memory (the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

// 4-byte form of the same (one fp32 scale).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace rfa
