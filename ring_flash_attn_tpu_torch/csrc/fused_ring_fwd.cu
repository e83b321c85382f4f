// Kernel B7: one step of the fused ring-attention forward.
//
// Replaces the TPU kernel ring_flash_attn_tpu/parallel/fused_ring.py::
// _fused_ring_fwd_kernel (wrapper _fused_ring_forward). That kernel runs
// the whole W-step ring in one call: it keeps a rank's KV shard, two
// receive slots and the (group, L, D) fp32 accumulator in the TPU's VMEM
// (tens of MB) and moves KV to the next rank with remote copies under a
// credit/ack handshake. A Hopper block has 227 KB of shared memory and no
// remote-copy engine, so here the hop between ranks is a posted
// torch.distributed rotation (parallel/mesh.py) and THIS KERNEL IS THE RING
// STEP: the credit protocol, the slots and the ack buffers have no
// counterpart and are not carried over. What the fusion saves is kept: the
// online-softmax state (m, l, acc) is carried from step to step, base 2,
// and normalised once, so no step writes an (out, lse) partial and nothing
// is merged between steps (per step one read and one write of acc, where
// the schedule-level ring pays B1's write plus the merge's two reads and a
// write).
//
// A call takes q pre-scaled by scale * log2(e) (rounded to bf16 as the JAX
// wrapper rounds it), the resident K and V of rank kv_rank, and the state
// m, l fp32 (B, Hq, Sq) and acc fp32 (B, Hq, Sq, D), and updates the state
// in place:
//  - `diagonal`: the local causal mask (attend iff row + q_row0 >= col), the
//    key loop bounded at each q tile's diagonal; other steps are mask-free;
//  - softcap as cap2 * tanh(s / cap2) with cap2 = softcap * log2(e), then
//    ALiBi on the global positions q_pos0 + row and kv_pos0 + col (|.| when
//    the ring is not causal), slopes pre-multiplied by log2(e);
//  - `first`: the rank's first computing step reads no state, so the state
//    needs no fill pass; a later step folds the stored (m, l, acc) into its
//    own in registers, after its tile loop;
//  - `last`: the rank's last computing step normalises instead of writing
//    the state back: out = acc / l in bf16 and lse = (m + log2 l) * ln 2,
//    with (0, NEG_INF) for a row that saw no key.
// Sq and Skv need not be multiples of the tile (the TPU kernel asserts
// L % block == 0).
//
// What bounds it on the H100: tensor-core operations. An off-diagonal step
// at the headline shape (q (1, 32, 8192, 128), kv (1, 8, 8192, 128)) is
// 4 * B * Hq * L^2 * D = 1.10e12 flops, 1.11 ms at 989 TFLOP/s, a diagonal
// step half of that; the state's 2 * 134 MB of fp32 acc traffic is 0.08 ms
// at 3.35 TB/s. The tile loop is B1's (csrc/flash_fwd.cuh: TMA producer,
// wgmma consumers on 128-row q tiles) with the ring additions compiled in;
// the state joins in the epilogue, so the loop is B1's to the instruction.
// That step's measured time is in flash_fwd.cuh's header and PERF.md.

#include "flash_fwd.cuh"

// strides: q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s in elements, on the
// TMA maps' terms as B1's. out and lse are written only when `last`; m, l,
// acc are read unless `first` and written unless `last`. slopes may be
// null. Returns 0 or a cudaError_t.
extern "C" int rfa_fused_ring_fwd(
    const void* q, const void* k, const void* v, float* m, float* l,
    float* acc, const float* slopes, void* out, float* lse, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, const long long* strides, int diagonal,
    int q_row0, float cap2, int q_pos0, int kv_pos0, int alibi_abs, int first,
    int last, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rfa_fwd::Ring ring{m,      l,       acc,       slopes, cap2,
                           q_pos0, kv_pos0, alibi_abs, first,  last};
  const bool xform = cap2 > 0.f || slopes;
  auto go = [&](auto fn) {
    return fn(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, strides, 1.f, diagonal,
              q_row0, 1, ring, st, rfa_seg_args{}, rfa_band_args{});
  };
  if (D == 128)
    return xform ? go(rfa_fwd::launch<128, true, true>)
                 : go(rfa_fwd::launch<128, true, false>);
  if (D == 64)
    return xform ? go(rfa_fwd::launch<64, true, true>)
                 : go(rfa_fwd::launch<64, true, false>);
  return cudaErrorInvalidValue;
}
