// Bitonic compare-exchange network kernels for Hopper (sm_90a).
//
// CUDA counterparts of the four Pallas kernels behind `_sort_padded` in
// vulkan_radix_sort_tpu/ops/bitonic.py, plus that file's validity gate:
//
//   chunk_kernel   K1  _run_chunk / _chunk_phases_body   (bitonic.py:934, 513)
//   fused_kernel   K2  _run_fused_rounds / _fused_rounds_body (723, 628),
//                      in fused.cu, which nvcc builds beside this file
//   cross_kernel   K3  _run_cross / _cross_kernel_body   (948, 579)
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
// Every kernel works in place on up to three uint32 arrays, templated on
// the carry <WORDS, RIDE>: KEYS <1,0> (k), PAIRS <2,0> ((k, v) compared
// lexicographically) and STABLE <2,1> ((k, idx) compared, v rides). CUDA
// compares unsigned words natively, so none of the Mosaic workarounds of
// the TPU version (sign flip, XOR negation, packed lane-origin aux,
// 128x128 tile transposes) carry over.
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
// cross kernel loads its tile once with coalesced accesses into shared
// memory, runs every stage there with one __syncthreads() per stage, and
// writes it back once; cluster (distributed shared memory) groups are
// left for later work.

#include "network.cuh"

namespace {

// Consecutive elements per row of a cross tile (256 bytes of keys); must
// match CROSS_W in ops/bitonic_kernels.py.
constexpr int kLogCrossW = 6;
constexpr int kCrossW = 1 << kLogCrossW;
constexpr int kMaxThreads = 1024;

// A cross tile of n elements in dynamic shared memory, one array after
// another.
template <int WORDS, int RIDE>
struct Tile {
  uint32_t* k;
  uint32_t* t;
  uint32_t* v;
  __device__ Tile(uint32_t* smem, int n)
      : k(smem), t(smem + n), v(smem + WORDS * n) {}

  __device__ __forceinline__ void load(int i, const Bufs<WORDS, RIDE>& g,
                                       uint64_t gi) {
    k[i] = g.k[gi];
    if constexpr (WORDS == 2) t[i] = g.t[gi];
    if constexpr (RIDE != 0) v[i] = g.v[gi];
  }

  __device__ __forceinline__ void store(int i, const Bufs<WORDS, RIDE>& g,
                                        uint64_t gi) const {
    g.k[gi] = k[i];
    if constexpr (WORDS == 2) g.t[gi] = t[i];
    if constexpr (RIDE != 0) g.v[gi] = v[i];
  }

  // Compare-exchange of slots a < b: ascending leaves the smaller at a.
  // Ties never swap, so a riding value stays put between equal tuples.
  __device__ __forceinline__ void ce(int a, int b, bool desc) {
    if constexpr (WORDS == 1) {
      const uint32_t x = k[a], y = k[b];
      const uint32_t lo = min(x, y), hi = max(x, y);
      k[a] = desc ? hi : lo;
      k[b] = desc ? lo : hi;
    } else {
      const uint64_t x = (uint64_t(k[a]) << 32) | t[a];
      const uint64_t y = (uint64_t(k[b]) << 32) | t[b];
      if (desc ? (x < y) : (x > y)) {
        k[a] = uint32_t(y >> 32);
        t[a] = uint32_t(y);
        k[b] = uint32_t(x >> 32);
        t[b] = uint32_t(x);
        if constexpr (RIDE != 0) {
          const uint32_t va = v[a];
          v[a] = v[b];
          v[b] = va;
        }
      }
    }
  }

  // One stage over n tile slots at slot distance 2^j, every pair in the
  // direction `desc`.
  __device__ __forceinline__ void stage(int n, int j, bool desc) {
    const int low = (1 << j) - 1;
    for (int c = threadIdx.x; c < n / 2; c += blockDim.x) {
      const int lo = ((c & ~low) << 1) | (c & low);
      ce(lo, lo | (1 << j), desc);
    }
    __syncthreads();
  }
};

int threads_for(int n) { return n / 2 < kMaxThreads ? n / 2 : kMaxThreads; }

constexpr size_t tile_bytes(int n, int words, int ride) {
  return size_t(n) * 4 * (words + ride);
}

// K1: full bitonic sort of one 2^LC-element chunk per block. Even chunks
// end ascending, odd chunks descending, so neighbours form bitonic pairs.
// Phases 1..L run in registers right after the load.
template <int WORDS, int RIDE, int LC>
__global__ void __launch_bounds__(net_threads(WORDS, RIDE, LC),
                      net_min_blocks(WORDS, RIDE, LC))
    chunk_kernel(Bufs<WORDS, RIDE> g, const int* valid) {
  if (valid != nullptr && valid[blockIdx.x] == 0) return;
  extern __shared__ uint32_t smem[];
  using R = Regs<WORDS, RIDE, LC>;
  R x;
  x.load(g, R::base());
  x.chunk_phases(smem, std::make_integer_sequence<int, LC>{});
  x.negate_all(R::dir_mask(LC));
  x.store(g, R::base());
}

// K4 (and K6): merge round r's stages at distance < C inside one chunk per
// block; the direction, bit LC + r of the index, is the block's.
template <int WORDS, int RIDE, int LC>
__global__ void __launch_bounds__(net_threads(WORDS, RIDE, LC),
                      net_min_blocks(WORDS, RIDE, LC))
    local_kernel(Bufs<WORDS, RIDE> g, int r, const int* valid) {
  if (valid != nullptr && valid[blockIdx.x] == 0) return;
  extern __shared__ uint32_t smem[];
  using R = Regs<WORDS, RIDE, LC>;
  R x;
  x.load(g, R::base());
  x.negate_all(0u - (blockIdx.x >> r & 1));
  x.template merge<LC - 1>(smem);
  x.negate_all(0u - (blockIdx.x >> r & 1));
  x.store(g, R::base());
}

// K3: a span of merge round r's cross stages, at distances 2^(lc+t) for
// t = t_lo+span-1 .. t_lo. Those stages only pair elements that differ in
// flat-index bits lc+t_lo .. lc+t_lo+span-1, so a tile is the 2^span
// elements differing in those bits, for each of kCrossW consecutive
// offsets (one coalesced 256-byte run per row). Flat index bits, low to
// high: w (kLogCrossW) | q1 | span bits | q2; the tile id enumerates
// (q1, q2). Tiles never straddle a round-r group (span bits lie below
// bit lc+r), so the direction and the validity flag are per tile.
template <int WORDS, int RIDE>
__global__ void __launch_bounds__(kMaxThreads)
    cross_kernel(Bufs<WORDS, RIDE> g, int lc, int r, int t_lo, int span,
                 const int* valid) {
  const int q1_bits = lc + t_lo - kLogCrossW;
  const int lspan = lc + t_lo;
  const uint64_t tid = blockIdx.x;
  const uint64_t q1 = tid & ((uint64_t(1) << q1_bits) - 1);
  const uint64_t q2 = tid >> q1_bits;
  const uint64_t base = (q1 << kLogCrossW) | (q2 << (lspan + span));
  if (valid != nullptr && valid[base >> (lc + r)] == 0) return;
  extern __shared__ uint32_t smem[];
  const int n = kCrossW << span;
  Tile<WORDS, RIDE> s(smem, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s.load(i, g, base + (uint64_t(i >> kLogCrossW) << lspan) +
                     (i & (kCrossW - 1)));
  __syncthreads();
  const bool desc = ((base >> (lc + r)) & 1) != 0;
  for (int t = span - 1; t >= 0; --t) s.stage(n, kLogCrossW + t, desc);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s.store(i, g, base + (uint64_t(i >> kLogCrossW) << lspan) +
                      (i & (kCrossW - 1)));
}

// Launch K1 (r < 0) or K4 at C = 2^LC; layout B needs shared memory only
// when a stage lies at distance 2^(L+5) or more.
template <int W, int R, int LC>
int launch_chunk_local(const Bufs<W, R>& g, long long nunits, int r,
                       const int* valid, cudaStream_t st) {
  using Rg = Regs<W, R, LC>;
  constexpr size_t smem = Rg::kSmemBytes;
  cudaError_t e;
  if (r < 0) {
    e = allow_smem(chunk_kernel<W, R, LC>, smem);
    if (e != cudaSuccess) return int(e);
    chunk_kernel<W, R, LC><<<unsigned(nunits), Rg::kThreads, smem, st>>>(
        g, valid);
  } else {
    e = allow_smem(local_kernel<W, R, LC>, smem);
    if (e != cudaSuccess) return int(e);
    local_kernel<W, R, LC><<<unsigned(nunits), Rg::kThreads, smem, st>>>(
        g, r, valid);
  }
  return int(cudaGetLastError());
}

// K1 (r < 0) or K4 at every chunk from 2^8 (MIN_CHUNK) to the carry's
// shared-memory cap: 2^15 for keys, 2^14 for the two-word carries.
template <int W, int R>
int launch_regs(void* k, void* t, void* v, long long nunits, int lc, int r,
                const int* valid, cudaStream_t st) {
  const Bufs<W, R> g = bufs<W, R>(k, t, v);
  switch (lc) {
#define VRS_LC(n) \
  case n:         \
    return launch_chunk_local<W, R, n>(g, nunits, r, valid, st);
    VRS_LC(8) VRS_LC(9) VRS_LC(10) VRS_LC(11) VRS_LC(12) VRS_LC(13)
    VRS_LC(14)
#undef VRS_LC
    case 15:
      if constexpr (W == 1)
        return launch_chunk_local<W, R, 15>(g, nunits, r, valid, st);
      break;
  }
  return int(cudaErrorInvalidValue);
}

template <int W, int R>
int launch_cross(void* k, void* t, void* v, long long ngroups, int lc, int r,
                 int t_lo, int span, const int* valid, cudaStream_t st) {
  const int n = kCrossW << span;
  const size_t smem = tile_bytes(n, W, R);
  cudaError_t e = allow_smem(cross_kernel<W, R>, smem);
  if (e != cudaSuccess) return int(e);
  // a round-r group of 2^(lc+r) elements splits into tiles of n elements
  const long long tiles = ngroups << (lc + r - kLogCrossW - span);
  cross_kernel<W, R><<<unsigned(tiles), threads_for(n), smem, st>>>(
      bufs<W, R>(k, t, v), lc, r, t_lo, span, valid);
  return int(cudaGetLastError());
}

}  // namespace
extern "C" {

int vrs_chunk(int mode, void* k, void* t, void* v, long long nunits, int lc,
              const int* valid, void* stream) {
  VRS_DISPATCH(mode, launch_regs, k, t, v, nunits, lc, -1, valid,
               static_cast<cudaStream_t>(stream));
}

int vrs_local(int mode, void* k, void* t, void* v, long long nunits, int lc,
              int r, const int* valid, void* stream) {
  if (r < 0) return int(cudaErrorInvalidValue);  // r < 0 selects K1
  VRS_DISPATCH(mode, launch_regs, k, t, v, nunits, lc, r, valid,
               static_cast<cudaStream_t>(stream));
}

int vrs_cross(int mode, void* k, void* t, void* v, long long ngroups, int lc,
              int r, int t_lo, int span, const int* valid, void* stream) {
  VRS_DISPATCH(mode, launch_cross, k, t, v, ngroups, lc, r, t_lo, span, valid,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
