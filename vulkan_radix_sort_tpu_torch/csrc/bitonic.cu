// Bitonic compare-exchange network kernels for Hopper (sm_90a).
//
// CUDA counterparts of the four Pallas kernels behind `_sort_padded` in
// vulkan_radix_sort_tpu/ops/bitonic.py, plus that file's validity gate:
//
//   chunk_kernel   K1  _run_chunk / _chunk_phases_body   (bitonic.py:934, 513)
//   fused_kernel   K2  _run_fused_rounds / _fused_rounds_body (723, 628),
//                      in fused.cu, which nvcc builds beside this file
//   cross_cols_kernel, cross_kernel
//                  K3  _run_cross / _cross_kernel_body   (948, 579): the
//                      first in the 32-bit carries, the second in W3 and
//                      W4_BIG
//   local_kernel   K4  _run_local / _local_kernel_body   (993, 604)
//   `valid`        K5  _gate_body (746): a block whose flag is 0 returns at
//                      once; the buffers are updated in place, so its region
//                      is already correct.
//   local_kernel   K6  _block_call_dma_gated (793): the slot merge's local
//                      pass, launched over every C-block of the slot buffer
//                      with its per-block mask and no prefix clip. K6 exists
//                      on the TPU only because a BlockSpec pipeline DMAs
//                      every grid step; its manual double-buffered DMA
//                      (843-874) is how the TPU makes a gated block move zero
//                      bytes. Here a thread block that returns before its
//                      first load already moves zero bytes, so no DMA code
//                      carries over.
//
// Every kernel works in place on up to four uint32 arrays, templated on
// the carry <WORDS, RIDE>: KEYS <1,0> (k), PAIRS <2,0> ((k, v) compared
// lexicographically), STABLE <2,1> ((k, idx) compared, v rides), and for
// 64-bit keys split into (hi, lo) words W3 <3,0> ((hi, lo, v) compared:
// MODE_W3, bitonic.py:201) and W4_BIG <3,1> ((hi, lo, idx) compared, v
// rides: MODE_W4_BIG, :203). The three-word carries compare (hi, lo) as
// one 64-bit word and the third word on a tie; their instantiations are
// built in network_w64.cu, which nvcc compiles beside this file, from the
// same templates, except K1 and W3's K2, which are wide.cuh's. The JAX package's
// MODE_W4 and MODE_PACKED (a packed lane-origin tiebreak) compute the
// same function as W4_BIG and STABLE and do not carry over. CUDA compares
// unsigned words natively, so none of the Mosaic workarounds of the TPU
// version (sign flip, XOR negation, packed lane-origin aux, 128x128 tile
// transposes) carry over.
//
// One direction rule serves all four kernels: while runs of length 2^p are
// being built, the pair (i, i ^ 2^j) sorts ascending iff bit p of the
// global flat index i is 0. A chunk's phase pk has p = pk (the last phase,
// p = log2 C, is chunk parity); merge round r has p = log2 C + r.
//
// What bounds them on an H100: the chunk kernel runs log2C(log2C+1)/2
// stages per element read, so it is bound by operations (int32 compares
// and selects); the local, fused and cross kernels run few stages per
// element moved and are bound by HBM bytes. The chunk, local and fused
// kernels keep a thread's elements in registers and run each stage between
// registers or lanes, with a shared-memory transpose (one barrier) only
// to reach distances of 32 threads and more (see Regs in network.cuh): the
// fused kernel is the chunk kernel's last phases run on a group of chunks. The
// cross kernel of the 32-bit carries holds columns of the tile in
// registers too (8-byte vector loads, every load issued first) and runs
// a span's stages between them, with one transpose through shared memory
// (one barrier) for spans deeper than a thread's rows (see Cols in
// bitonic.cuh); the three-word carries' cross kernel loads its tile once
// into shared memory and runs every stage there with one __syncthreads()
// per stage. Cluster (distributed shared memory) groups are left for
// later work.

#include "bitonic.cuh"

// a0..a3: the carry's arrays in order (compared words, then the riding
// one), null past the last.
extern "C" {

int vrs_chunk(int mode, void* a0, void* a1, void* a2, void* a3,
              long long nunits, int lc, const int* valid, void* stream) {
  VRS_DISPATCH(mode, launch_regs, a0, a1, a2, a3, nunits, lc, -1, valid,
               static_cast<cudaStream_t>(stream));
}

int vrs_local(int mode, void* a0, void* a1, void* a2, void* a3,
              long long nunits, int lc, int r, const int* valid,
              void* stream) {
  if (r < 0) return int(cudaErrorInvalidValue);  // r < 0 selects K1
  VRS_DISPATCH(mode, launch_regs, a0, a1, a2, a3, nunits, lc, r, valid,
               static_cast<cudaStream_t>(stream));
}

int vrs_cross(int mode, void* a0, void* a1, void* a2, void* a3,
              long long ngroups, int lc, int r, int t_lo, int span,
              const int* valid, void* stream) {
  VRS_DISPATCH(mode, launch_cross, a0, a1, a2, a3, ngroups, lc, r, t_lo,
               span, valid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
