// LSD radix sort kernels for Hopper (sm_90a): one pass's block sort and
// placement.
//
// CUDA counterparts of the two Pallas kernels of the JAX package's radix
// pipeline (vulkan_radix_sort_tpu/ops/radix.py):
//
//   block_sort_kernel  K7  block_sort / _block_sort_body
//                          (ops/block_sort.py:154, 65)
//   place_kernel       K8  stream_place / _stream_place_body
//                          (ops/stream_place.py:228, 54)
//
// A pass is K7 -> spine -> K8, as the reference's upsweep -> spine ->
// downsweep (src/shader/{upsweep,spine,downsweep}.slang). K7 sorts each
// `block`-key block stably by the digit (key >> shift) & (radix - 1) and
// writes the block's radix-bin histogram. The spine (torch: ops/radix.py
// `_spine` and ops/stream_place.py `block_offsets`) turns the histograms
// into each (block, digit) run's global output offset: a column-wise
// exclusive scan over blocks plus the global exclusive scan over digits,
// the reference spine's two halves. K8 then
// copies element i of run (p, b) to offset[p][b] + (i - start of the run).
//
// What changed from the TPU: there, ranks came from one-hot matmuls on the
// MXU (no atomics, no ballots), and placement walked the blocks in order on
// one core with per-bucket append streams. Hopper blocks run in parallel
// and in no order, so each block gets its own base per digit from the
// spine, and ranks come from warp match masks.
//
// Stability is the whole LSD contract, so no rank comes from an atomic
// counter, whose order changes from run to run. Warp w of a K7 block owns
// the contiguous segment [w*seg, (w+1)*seg) of the block and walks it 32
// keys at a time in order: __match_any_sync groups the lanes holding one
// digit, a key's rank is the warp's running count of its digit plus the
// peers in lower lanes. A column scan over warps and an exclusive scan over
// digits then give every key its stable local position.
//
// What bounds them on an H100: both move every key (and value) once in and
// once out of HBM and do a few integer operations per key, so both are
// bound by bytes. K7 reads and writes its block coalesced and does the
// scatter inside shared memory. K8 reads coalesced; its writes are
// contiguous within each (block, digit) run (16 keys on average at 8 bits
// and 4096-key blocks), which a later design could stage through shared
// memory into longer runs. This is the simple first design: no TMA, no
// clusters, no decoupled look-back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // K7 block: RADIX_THREADS in config.py
constexpr int kWarps = kThreads / 32;
constexpr int kPlaceThreads = 256;
constexpr int kMaxRadix = 256;  // scans below need blockDim >= radix
constexpr int kSmemBytes = 232448;

// In-place exclusive scan of a[0, n), n <= blockDim.x and n <= 1024, by the
// whole block. `wsum` holds 32 ints of scratch.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n,
                                                     int* wsum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nw = (n + 31) >> 5;
  int x = 0, v = 0;
  if (w < nw) {
    x = t < n ? a[t] : 0;
    v = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane == 31) wsum[w] = v;
  }
  __syncthreads();
  if (t < n) {
    int base = 0;
    for (int i = 0; i < w; ++i) base += wsum[i];
    a[t] = base + v - x;
  }
  __syncthreads();
}

constexpr size_t block_sort_smem(int block, int radix) {
  // keys in, keys (then values) out, per-warp digit counts, digit bases,
  // scan scratch, 16-bit ranks
  return size_t(block) * 4 * 2 + size_t(kWarps) * radix * 4 + radix * 4 +
         32 * 4 + size_t(block) * 2;
}

// K7: one block per `block` keys. Writes the block stably sorted by the
// digit at `shift` to out_k (and the values, moved alike, to out_v), and
// its histogram to hist[blockIdx.x][0, radix).
template <bool KV>
__global__ void __launch_bounds__(kThreads)
    block_sort_kernel(const uint32_t* __restrict__ keys,
                      const uint32_t* __restrict__ vals,
                      uint32_t* __restrict__ out_k,
                      uint32_t* __restrict__ out_v, int* __restrict__ hist,
                      int block, int shift, int bits) {
  extern __shared__ uint32_t smem[];
  const int radix = 1 << bits;
  const uint32_t mask = uint32_t(radix - 1);
  uint32_t* sk = smem;                              // [block] input order
  uint32_t* so = sk + block;                        // [block] sorted
  int* wcnt = reinterpret_cast<int*>(so + block);   // [kWarps][radix]
  int* dbase = wcnt + kWarps * radix;               // [radix]
  int* wsum = dbase + radix;                        // [32]
  uint16_t* rank = reinterpret_cast<uint16_t*>(wsum + 32);  // [block]
  const uint64_t base = uint64_t(blockIdx.x) * uint64_t(block);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int seg = block / kWarps;

  for (int i = t; i < block; i += kThreads) sk[i] = keys[base + i];
  for (int i = t; i < kWarps * radix; i += kThreads) wcnt[i] = 0;
  __syncthreads();

  // Stable rank of each key among its warp segment's keys of one digit.
  int* cnt = wcnt + w * radix;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = w * seg + lane; i < (w + 1) * seg; i += 32) {
    const uint32_t d = (sk[i] >> shift) & mask;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    int prior = lane == leader ? cnt[d] : 0;
    prior = __shfl_sync(0xffffffffu, prior, leader);
    rank[i] = uint16_t(prior + __popc(peers & lower));
    if (lane == leader) cnt[d] = prior + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Per digit: each warp's exclusive offset among the warps, and the
  // block's count, which is its histogram entry.
  if (t < radix) {
    int run = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = wcnt[k * radix + t];
      wcnt[k * radix + t] = run;
      run += c;
    }
    dbase[t] = run;
    hist[uint64_t(blockIdx.x) * radix + t] = run;
  }
  __syncthreads();
  block_exclusive_scan(dbase, radix, wsum);

  for (int i = t; i < block; i += kThreads) {
    const uint32_t k = sk[i];
    const uint32_t d = (k >> shift) & mask;
    so[dbase[d] + wcnt[(i / seg) * radix + d] + rank[i]] = k;
  }
  __syncthreads();
  for (int i = t; i < block; i += kThreads) out_k[base + i] = so[i];
  if constexpr (KV) {
    __syncthreads();
    for (int i = t; i < block; i += kThreads) {
      const uint32_t d = (sk[i] >> shift) & mask;
      so[dbase[d] + wcnt[(i / seg) * radix + d] + rank[i]] = vals[base + i];
    }
    __syncthreads();
    for (int i = t; i < block; i += kThreads) out_v[base + i] = so[i];
  }
}

// K8: one block per `block` keys of block-sorted input. Run b of block p
// holds elements [s_b, s_b + hist[p][b]) of the block, s the exclusive scan
// of the histogram row; element i of it goes to offsets[p][b] + i - s_b.
template <bool KV>
__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ yv,
                 const int* __restrict__ hist,
                 const int* __restrict__ offsets, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ outv, int block, int bits) {
  __shared__ int start[kMaxRadix];
  __shared__ int off[kMaxRadix];
  __shared__ int wsum[32];
  const int radix = 1 << bits;
  const uint64_t p = blockIdx.x;
  const uint64_t base = p * uint64_t(block);
  const int t = threadIdx.x;
  if (t < radix) {
    start[t] = hist[p * radix + t];
    off[t] = offsets[p * radix + t];
  }
  __syncthreads();
  block_exclusive_scan(start, radix, wsum);
  for (int i = t; i < block; i += kPlaceThreads) {
    // the last run starting at or before i; it is not empty, since the
    // next run starts past i
    int b = 0;
    for (int s = radix >> 1; s > 0; s >>= 1)
      if (start[b + s] <= i) b += s;
    const int64_t dst = int64_t(off[b]) + (i - start[b]);
    out[dst] = y[base + i];
    if constexpr (KV) outv[dst] = yv[base + i];
  }
}

bool bad_geometry(long long nblocks, int block, int bits) {
  return nblocks < 0 || nblocks > 0x7fffffffLL || (bits != 4 && bits != 8) ||
         block <= 0 || block % kThreads != 0 ||
         block_sort_smem(block, 1 << bits) > size_t(kSmemBytes);
}

template <bool KV>
int launch_block_sort(const void* keys, const void* vals, void* out_k,
                      void* out_v, void* hist, long long nblocks, int block,
                      int shift, int bits, cudaStream_t st) {
  const size_t smem = block_sort_smem(block, 1 << bits);
  cudaError_t e = cudaFuncSetAttribute(
      block_sort_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  if (nblocks == 0) return int(cudaSuccess);
  block_sort_kernel<KV><<<unsigned(nblocks), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(vals),
      static_cast<uint32_t*>(out_k), static_cast<uint32_t*>(out_v),
      static_cast<int*>(hist), block, shift, bits);
  return int(cudaGetLastError());
}

template <bool KV>
int launch_place(const void* y, const void* yv, const void* hist,
                 const void* offsets, void* out, void* outv,
                 long long nblocks, int block, int bits, cudaStream_t st) {
  if (nblocks == 0) return int(cudaSuccess);
  place_kernel<KV><<<unsigned(nblocks), kPlaceThreads, 0, st>>>(
      static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(yv),
      static_cast<const int*>(hist), static_cast<const int*>(offsets),
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(outv), block, bits);
  return int(cudaGetLastError());
}

}  // namespace

// Each call launches one kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry the kernels do not take). `kv` != 0
// moves the values too; otherwise their pointers are not read.
extern "C" {

int vrs_block_sort(int kv, const void* keys, const void* vals, void* out_k,
                   void* out_v, void* hist, long long nblocks, int block,
                   int shift, int bits, void* stream) {
  if (bad_geometry(nblocks, block, bits) || shift < 0 || shift > 31)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return kv ? launch_block_sort<true>(keys, vals, out_k, out_v, hist, nblocks,
                                      block, shift, bits, st)
            : launch_block_sort<false>(keys, vals, out_k, out_v, hist,
                                       nblocks, block, shift, bits, st);
}

int vrs_place(int kv, const void* y, const void* yv, const void* hist,
              const void* offsets, void* out, void* outv, long long nblocks,
              int block, int bits, void* stream) {
  if (bad_geometry(nblocks, block, bits)) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return kv ? launch_place<true>(y, yv, hist, offsets, out, outv, nblocks,
                                 block, bits, st)
            : launch_place<false>(y, yv, hist, offsets, out, outv, nblocks,
                                  block, bits, st);
}

}  // extern "C"
