// The fused-rounds kernel of the bitonic network for Hopper (sm_90a).
//
// CUDA counterpart of the JAX package's fused-rounds Pallas kernel:
//
//   fused_kernel   K2  _run_fused_rounds / _fused_rounds_body
//                      (vulkan_radix_sort_tpu/ops/bitonic.py:723, 628)
//
// with K5's gate as its `valid` pointer, as in bitonic.cu. It has a source
// of its own so that nvcc builds it beside bitonic.cu's unrolled chunk and
// local kernels, in parallel; the kernel template is in fused.cuh, whose
// three-word carries (W3, W4_BIG) network_w64.cu instantiates.
//
// What bounds it on an H100: HBM bytes (one read and one write of every
// element for several merge phases), once its stages cost no barrier.
// A group takes 27-29 stages at the main path's shapes; in a shared-memory
// tile each would be a full pass behind a __syncthreads(). So the kernel
// holds the group in registers as K1 does (see Regs in network.cuh), and a
// merge phase costs register and shuffle stages and at most one transpose
// pair.

#include "fused.cuh"

extern "C" {

int vrs_fused(int mode, void* a0, void* a1, void* a2, void* a3,
              long long ngroups, int lc, int r_lo, int r_hi, const int* valid,
              void* stream) {
  VRS_DISPATCH(mode, launch_fused, a0, a1, a2, a3, ngroups, lc, r_lo, r_hi,
               valid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
