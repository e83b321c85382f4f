// Kernel B8: one step of the fused ring-attention backward (the dual ring).
//
// Replaces the TPU kernel ring_flash_attn_tpu/parallel/fused_ring.py::
// _fused_ring_bwd_kernel (wrapper _fused_ring_backward). That kernel runs
// all W steps in one call: KV rotates rank to rank by remote copies while
// the fp32 dk/dv accumulators co-rotate with it, both double-buffered in
// VMEM beside the (group, L, D) dq accumulator (tens of MB), under two
// credit/ack handshakes. A Hopper block has 227 KB of shared memory and no
// remote-copy engine, so here both hops are posted torch.distributed
// rotations (parallel/mesh.py) and THIS KERNEL IS THE RING STEP: the credit
// protocols, the slots and the ack buffers have no counterpart and are not
// carried over. What the fusion saves is kept: a step adds in place, dq
// into the rank's fp32 accumulator and dk, dv into the travelling fp32
// accumulators it is handed (the TPU kernel's comm_dkv[slot] += dk_s,
// folded into this kernel's epilogue), so no step returns partial
// gradients to be summed by a separate pass.
//
// A call takes, as the JAX wrapper prepares them, q * scale * log2(e) and
// v * scale rounded to bf16, raw k, dout, lse2 = max(lse * log2 e,
// NEG_INF / 2) and delta = scale * rowsum(dout * out) (the pre-pass
// rfa_bwd_delta of csrc/flash_bwd.cu, times scale). It recomputes
// p = exp2(s' - lse2), where s' is q k^T through the forward's softcap
// (cap2 * tanh(s / cap2)) and ALiBi on global positions, masked on the
// diagonal step (attend iff row + q_row0 >= key); dS = p * (dout v^T -
// delta) * (1 - tanh^2) and
//   dq += dS k            (already in q's units: v carries the scale)
//   dk += dS^T q          (in units of scale * log2 e: the wrapper applies
//                          dk_rescale = ln 2 / scale once, when the
//                          accumulator is home)
//   dv += p^T dout.
// One block owns a (batch, kv head, 128-key tile) and is the only writer
// of its dk, dv rows: a plain read-add-write, bitwise reproducible. dq,
// which every key tile adds to, leaves by TMA reduce-adds as in B2, so its
// last bits vary from run to run.
//
// What bounds it on the H100: tensor-core operations. An off-diagonal step
// at the headline shape (q (1, 32, 8192, 128), kv (1, 8, 8192, 128)) is 5
// products of 2 * B * Hq * L^2 * D flops = 2.75e12, 2.78 ms at 989
// TFLOP/s, a diagonal step half of that. The loop is B2's kv-major loop
// (csrc/flash_bwd.cuh: TMA producer, wgmma consumers, dq by a writer warp)
// with the ring additions compiled in; the softcap's 1 - tanh^2 factor
// costs it 120 bytes of spills at 240 registers a consumer thread (136 at
// head_dim 256, where a block takes 64 keys, both consumer warpgroups make
// the same P^T and dS^T and each owns half of dK's and dV's columns, and
// dq leaves by atomic adds from the registers; ptxas). Measured
// there (profile_torch_bwd.py, NVIDIA H100 80GB HBM3, 700 W): 6.55 to 6.83
// ms off-diagonal, about 415 TFLOP/s and 1.2x SDPA's non-causal backward,
// 3.36 to 3.51 ms diagonal; the mma.sync loop before it 15.40 to 15.67 and
// 8.47 to 8.82. At head_dim 256, q (1, 16, 8192, 256), kv (1, 8, 8192, 256)
// with softcap 50 (the same flops; chip_smoke.py phase 25, same card;
// PERF.md section 6): 15.125 ms off-diagonal, 5.4x the 2.779 ms bound and
// 1.9x SDPA's non-causal backward without the cap; 7.418 diagonal.

#include "flash_bwd.cuh"

// strides: q, k, v, dout (b, h, s) in elements. dq_acc, dk_acc, dv_acc are
// fp32 and contiguous; dq_acc is added to; dk_acc and dv_acc are added to
// when `accumulate`, else written. slopes may be null. Returns
// cudaGetLastError().
extern "C" int rfa_fused_ring_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse2, const float* delta, const float* slopes, float* dq_acc,
    float* dk_acc, float* dv_acc, int B, int Hq, int Hkv, int Sq, int Skv,
    int D, const long long* strides, int diagonal, int q_row0, float cap2,
    int q_pos0, int kv_pos0, int alibi_abs, int accumulate, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_bwd::Ring ring{slopes, cap2, q_pos0, kv_pos0, alibi_abs,
                           accumulate};
  return rfa::by_head_dim(D, [&](auto d) {
    return rfa_bwd::launch_kv<decltype(d)::value, true, true>(
        q, k, v, dout, lse2, delta, dq_acc, dk_acc, dv_acc, B, Hq, Hkv, Sq,
        Skv, strides, 1.f, diagonal, q_row0, 0, st, ring);
  });
}
