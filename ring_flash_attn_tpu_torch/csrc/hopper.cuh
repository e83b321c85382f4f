// Hopper (sm_90a) building blocks as inline PTX, beside common.cuh's:
// wgmma with its shared-memory descriptors, fences and groups; named
// barriers; mbarriers; TMA tile loads and reduce-adds; setmaxnreg; and, on
// the host, TMA tensor maps encoded through the driver entry point.
//
// Shared-memory tiles here use the 128-byte swizzle of TMA and wgmma: a tile
// of R rows x 64 bf16 columns (a "panel") is R rows of 128 B, and the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8). A tile wider than 64 columns
// is D / 64 panels one after the other. Panels start 1024-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include "common.cuh"

namespace hop {

// ---------------------------------------------------------------------------
// wgmma

// Descriptor of a 128B-swizzled operand in shared memory. For a K-major
// operand (the reduction dim contiguous) sbo is the step between 8-row
// groups, 1024 B for a panel, and lbo is not read. For an MN-major operand
// (the M or N dim contiguous) sbo is the step between 8-row groups along
// the reduction and lbo the step to the next 64-wide panel along M or N.
// Moving the start within a 128 B row (K-major: 16 reduction elements at
// a time) is allowed: the swizzle is applied to the address bits.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo = 1024) {
  return (uint64_t)((rfa::smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin a register array at this point of the program, so that the compiler
// moves no read or write of it across an asynchronous product's issue or
// wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The 32 accumulator operands d[0] .. d[31] of an asm statement, read and
// written: fp32 (HOP_F32) or s32 (HOP_S32).
#define HOP_8(k, d, i)                                                      \
  k(d[i]), k(d[i + 1]), k(d[i + 2]), k(d[i + 3]), k(d[i + 4]), k(d[i + 5]), \
      k(d[i + 6]), k(d[i + 7])
#define HOP_32(k, d) \
  HOP_8(k, d, 0), HOP_8(k, d, 8), HOP_8(k, d, 16), HOP_8(k, d, 24)
#define HOP_FOP(x) "+f"(x)
#define HOP_IOP(x) "+r"(x)
#define HOP_F32(d) HOP_32(HOP_FOP, d)
#define HOP_S32(d) HOP_32(HOP_IOP, d)

// D (64 x 64 fp32) = A (64 x 16) * B (16 x 64) [+ D]; A and B in shared
// memory through their descriptors; TA / TB: 1 = MN-major (transposed);
// bf16, or fp16 with F16.
template <int TA, int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
#define HOP_SS_N64(TY)                                                     \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                              \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                          \
      "%32, %33, p, 1, 1, %35, %36;\n}\n"                                  \
      : HOP_F32(d)                                                         \
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB))
  if constexpr (F16)
    HOP_SS_N64("f16");
  else
    HOP_SS_N64("bf16");
#undef HOP_SS_N64
}

// S (64 x 64 s32) = A (64 x 32) * B (32 x 64) [+ S], int8, both K-major in
// shared memory through their descriptors: exact.
__device__ __forceinline__ void wgmma_ss_s8_n64(int (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : HOP_S32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 80 fp32) = A (64 x 16) * B (16 x 80) [+ D]; A and B in shared
// memory through their descriptors; TA / TB: 1 = MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 128 fp32) = A (64 x 16) * B (16 x 128) [+ D]; A and B in shared
// memory through their descriptors; TA / TB: 1 = MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 32 fp32) = A (64 x 16) * B (16 x 32) [+ D]; A and B in shared
// memory through their descriptors; TA / TB: 1 = MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D (64 x 128 fp32) = A (64 x 16, bf16 fragments in registers; fp16 with
// F16) * B (16 x 128, shared memory) [+ D]; TB: 1 = B is MN-major.
template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
#define HOP_RS_N128(TY)                                                    \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                              \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                            \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                            \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                            \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                            \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                          \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                      \
      : HOP_F32(d), HOP_F32((d + 32))                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),               \
        "r"(accumulate), "n"(TB))
  if constexpr (F16)
    HOP_RS_N128("f16");
  else
    HOP_RS_N128("bf16");
#undef HOP_RS_N128
}

// D (64 x 64 fp32) = A (64 x 16, bf16 fragments in registers; fp16 with
// F16) * B (16 x 64, shared memory) [+ D]; TB: 1 = B is MN-major.
template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
#define HOP_RS_N64(TY)                                                     \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                              \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                          \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                      \
      : HOP_F32(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),               \
        "r"(accumulate), "n"(TB))
  if constexpr (F16)
    HOP_RS_N64("f16");
  else
    HOP_RS_N64("bf16");
#undef HOP_RS_N64
}

// The m64nN accumulator of a warpgroup (element i: row 16 warp + g + 8 ((i
// % 4) / 2), column 8 (i / 4) + 2 tq + i % 2, with g = lane / 4, tq = lane %
// 4) as the A fragments of an RS wgmma: fragment kc holds columns [16 kc,
// 16 kc + 16) in bf16.
template <int K>
__device__ __forceinline__ void pack_fragments(uint32_t (&a)[K][4],
                                               const float (&x)[8 * K]) {
#pragma unroll
  for (int kc = 0; kc < K; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kc][r] = rfa::pack_bf16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1]);
}

// ---------------------------------------------------------------------------
// barriers, proxies, register budgets

// Barrier `id` among the first `n` threads that reach it (a multiple of 32);
// the other warps of the block do not take part.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrive at barrier `id` of `n` threads without waiting for the others.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Make this thread's shared-memory writes (st.shared, cp.async) visible to
// the async proxy: wgmma operands and bulk copies read through it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   rfa::smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Publish mbarrier initialisation before any thread or copy uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   rfa::smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          rfa::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(rfa::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// Clusters

// The block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster's barrier, in two halves: every thread of every block of the
// cluster arrives (releasing its shared-memory writes), then waits
// (acquiring its peers').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of this block's shared-memory address `addr` in the shared
// memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t map_peer(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Loads from a cluster shared-memory address (map_peer).
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// TMA and bulk copies

// One box of a 4-D tensor map into shared memory at coordinates (c0 the
// innermost), completing on `bar`. Elements outside the tensor read zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          rfa::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(rfa::smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory by the copy engine, completing
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(rfa::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(rfa::smem_u32(bar))
      : "memory");
}

// Arrive on `bar` once every cp.async this thread has issued so far has
// landed. The arrival is not counted in advance (.noinc): the barrier's
// count must include it.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   rfa::smem_u32(bar))
               : "memory");
}

// global += shared, one box of a 4-D fp32 tensor map at coordinates (c0
// the innermost), added by the copy engine as one bulk group of this
// thread; elements outside the tensor are dropped.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(rfa::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups have not yet read
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace hop

// ---------------------------------------------------------------------------
// host: TMA tensor maps

namespace hop_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API symbol; the libraries are built
// without -lcuda, so it is fetched from the driver through the runtime.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (D, S, H, B) over a (B, H, S, D) tensor of bf16 or fp32 with
// element strides st = (b, h, s) and a contiguous last dim, read or
// written in boxes of `cols` x `rows` with the 128 B swizzle (cols * the
// element size = 128 bytes); rows past S read zero and are not written. A
// dimension of size 1 takes its contiguous stride (its own may be any).
// Returns 0 or a cudaError_t.
inline int tmap_4d(CUtensorMap* map, const void* base, bool fp32, int B,
                   int H, int S, int D, const long long* st, int cols,
                   int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t esize = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * esize,
                           (cuuint64_t)st[1] * esize,
                           (cuuint64_t)st[0] * esize};
  cuuint64_t extent = (cuuint64_t)D * esize;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = extent;
    extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace hop_host
