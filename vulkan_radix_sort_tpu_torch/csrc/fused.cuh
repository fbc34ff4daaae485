// The template of the fused-rounds kernel (K2) and its launcher, shared by
// fused.cu (the 32-bit carries) and network_w64.cu (the three-word
// carries); see fused.cu for what it replaces and what bounds it.

#pragma once

#include "network.cuh"
#include "wide.cuh"

namespace {

// Threads of a K2 block on a group of 2^lg elements: the chunk kernel's
// rule at C = 2^lg where a thread holds fewer than 64 words. At each
// carry's largest groups that rule takes 256 threads, and shared memory
// (the transpose) admits one block a SM: 8 warps, too few to hide the
// latency of the shuffle stages. There K2 takes 1024 threads if a thread
// then holds at most 32 words (64 registers), else 512 (the stable
// carry: 96 words in 128 registers). Must match `block_geometry` in
// ops/bitonic_kernels.py.
__host__ __device__ constexpr int fused_threads(int words, int ride,
                                                int lg) {
  const int t = net_threads(words, ride, lg);
  const int arrays = words + ride;
  if ((1 << lg) / t * arrays < 64) return t;
  return (1 << lg) / 1024 * arrays <= 32 ? 1024 : 512;
}

// Blocks each SM must be able to hold: the chunk kernel's rule where K2
// has the chunk geometry, else one.
__host__ __device__ constexpr int fused_min_blocks(int words, int ride,
                                                   int lg) {
  return fused_threads(words, ride, lg) == net_threads(words, ride, lg)
             ? net_min_blocks(words, ride, lg)
             : 1;
}

// K2: merge rounds r_lo..r_hi, cross and local stages alike, on one group
// of G = 2^LG elements (2^r_hi chunks, LG = lc + r_hi) per block. A group
// of 2^g aligned chunks holds every pair of rounds r <= g, so one HBM
// round trip serves all of them. Round r is phase p = lc + r of the chunk
// network run on a chunk of G (direction bit p, stages p-1..0), so K2 is
// K1's last phases, lc + r_lo .. LG, on the registers of Regs<..., LG>:
// one instantiation per group size serves every (C, r_lo), entering K1's
// compile-time phases at a run-time one (chunk_phases_from), and each
// phase takes at most one transpose pair. (A loop over phases of run-time
// depth spilled registers in ptxas at every geometry tried.) The group
// enters and leaves plain (not negated).
template <int WORDS, int RIDE, int LG,
          int THREADS = fused_threads(WORDS, RIDE, LG)>
__global__ void __launch_bounds__(THREADS, fused_min_blocks(WORDS, RIDE, LG))
    fused_kernel(Bufs<WORDS, RIDE> g, int lc, int r_lo, const int* valid) {
  if (valid != nullptr && valid[blockIdx.x] == 0) return;
  extern __shared__ uint32_t smem[];
  using R = Regs<WORDS, RIDE, LG, THREADS>;
  R x;
  x.load(g, R::base());
  const int p0 = lc + r_lo;
  x.negate_all(R::dir_mask(p0 - 1));  // as phase p0 - 1 would leave them
  x.chunk_phases_from(p0, smem);
  x.negate_all(R::dir_mask(LG));
  x.store(g, R::base());
}

// K2 on groups of 2^LG elements; in W3 fused_wide_kernel (wide.cuh),
// chosen at compile time.
template <int W, int R, int LG>
int launch_fused_lg(const Bufs<W, R>& g, long long ngroups, int lc, int r_lo,
                    const int* valid, cudaStream_t st) {
  if constexpr (W == 3 && R == 0) {
    return launch_fused_wide<W, R, LG>(g, ngroups, lc, r_lo, valid, st);
  } else {
    constexpr int kThreads = fused_threads(W, R, LG);
    constexpr size_t smem = Regs<W, R, LG, kThreads>::kSmemBytes;
    cudaError_t e = allow_smem(fused_kernel<W, R, LG>, smem);
    if (e != cudaSuccess) return int(e);
    fused_kernel<W, R, LG><<<unsigned(ngroups), kThreads, smem, st>>>(
        g, lc, r_lo, valid);
    return int(cudaGetLastError());
  }
}

// K2 on groups of 2^(lc + r_hi) elements, from 2^9 (two MIN_CHUNK chunks)
// to the carry's register cap.
template <int W, int R>
int launch_fused(void* a0, void* a1, void* a2, void* a3, long long ngroups,
                 int lc, int r_lo, int r_hi, const int* valid,
                 cudaStream_t st) {
  const Bufs<W, R> g = bufs<W, R>(a0, a1, a2, a3);
  if (lc < 8 || r_lo < 1 || r_lo > r_hi) return int(cudaErrorInvalidValue);
  switch (lc + r_hi) {
#define VRS_LG(n)                                                      \
  case n:                                                              \
    if constexpr (n <= reg_cap_log(W, R))                              \
      return launch_fused_lg<W, R, n>(g, ngroups, lc, r_lo, valid, st); \
    break;
    VRS_LG(9) VRS_LG(10) VRS_LG(11) VRS_LG(12) VRS_LG(13) VRS_LG(14)
    VRS_LG(15)
#undef VRS_LG
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
