// The network kernels K1-K5 in the three-word carries of 64-bit keys, for
// Hopper (sm_90a).
//
// CUDA counterparts of the JAX package's chunk, fused-rounds, cross and
// local Pallas kernels (and their validity gate) in the two carries that
// only its 64-bit key-value sort reaches (`sort_pairs_w64`,
// vulkan_radix_sort_tpu/ops/bitonic.py:1516):
//
//   W3 <3,0>      MODE_W3 (bitonic.py:201): (hi, lo, v), all three words
//                 compared; non-stable 64-bit key-value.
//   W4_BIG <3,1>  MODE_W4_BIG (:203): (hi, lo, idx) compared, v rides;
//                 stable 64-bit key-value, the index tiebreak.
//
// K1, and K2 in W3, are a design of their own for three words (wide.cuh:
// chunk_merge_kernel, a merge sort, is K1 in W3; chunk_wide_kernel, the
// network at 16 elements a thread with a phase's far stages in registers
// after a transpose, is K1 in W4_BIG up to 2^12; fused_wide_kernel, that
// network in persistent blocks that stage their next group in shared
// memory, is K2 in W3), which the launchers of bitonic.cuh and fused.cuh
// take at compile time. The rest are the templates of bitonic.cuh
// (chunk_kernel at 2^13 in W4_BIG, cross_kernel K3, local_kernel K4) and
// fused.cuh (fused_kernel, K2 in W4_BIG), with K5 as their `valid`
// pointer. The templates compare (hi, lo) as one 64-bit word and the third
// word on a tie, wide.cuh's kernels the three words as one borrow chain;
// all negate the three compared words where a pair descends. Their
// instantiations live in this source of their own so that nvcc builds
// them in parallel with bitonic.cu and fused.cu; VRS_DISPATCH
// (network.cuh) routes modes 3 and 4 here. Chunks and groups run from 2^8
// and 2^9 up to 2^13 in both carries: W4_BIG's shared-memory cap (16 bytes
// an element), and W3's register cap (reg_cap_log: at 2^14 its chunk,
// local and fused kernels spilled registers). W3's cross tiles still
// reach its shared-memory cap, 2^14 (12 bytes an element).
//
// What bounds them on an H100: as for the 32-bit carries (see bitonic.cu),
// K1 by integer operations, the others by HBM bytes: 12 (W3) or 16
// (W4_BIG) bytes an element each way.

#include "bitonic.cuh"
#include "fused.cuh"

namespace vrs {

int launch_regs_w64(int mode, void* a0, void* a1, void* a2, void* a3,
                    long long nunits, int lc, int r, const int* valid,
                    cudaStream_t st) {
  VRS_DISPATCH_W64(mode, launch_regs, a0, a1, a2, a3, nunits, lc, r, valid,
                   st);
}

int launch_cross_w64(int mode, void* a0, void* a1, void* a2, void* a3,
                     long long ngroups, int lc, int r, int t_lo, int span,
                     const int* valid, cudaStream_t st) {
  VRS_DISPATCH_W64(mode, launch_cross, a0, a1, a2, a3, ngroups, lc, r, t_lo,
                   span, valid, st);
}

int launch_fused_w64(int mode, void* a0, void* a1, void* a2, void* a3,
                     long long ngroups, int lc, int r_lo, int r_hi,
                     const int* valid, cudaStream_t st) {
  VRS_DISPATCH_W64(mode, launch_fused, a0, a1, a2, a3, ngroups, lc, r_lo,
                   r_hi, valid, st);
}

}  // namespace vrs
