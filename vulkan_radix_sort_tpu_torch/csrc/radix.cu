// LSD radix sort kernels for Hopper (sm_90a): one pass's block sort, spine
// and placement.
//
// CUDA counterparts of the two Pallas kernels of the JAX package's radix
// pipeline (vulkan_radix_sort_tpu/ops/radix.py):
//
//   block_sort_kernel  K7  block_sort / _block_sort_body
//                          (ops/block_sort.py:154, 65)
//   spine_kernel       K8  the column accumulation over blocks that
//                          _stream_place_body does as it walks the blocks,
//                          plus radix.py's _spine (ops/radix.py:34)
//   place_kernel       K8  stream_place / _stream_place_body
//                          (ops/stream_place.py:228, 54)
//
// A pass is three launches with nothing between them, K7 -> spine -> K8,
// as the reference's upsweep -> spine -> downsweep
// (src/shader/{upsweep,spine,downsweep}.slang). K7 sorts each `block`-key
// block stably by the digit (key >> shift) & (radix - 1) and writes the
// block's radix-bin histogram. The spine turns the (nblocks, radix)
// histograms into the global exclusive digit offsets g and each
// (block, digit) run's output offset, offsets[p][d] = g[d] + the sum of
// hist[q][d] over q < p: the reference spine's two halves. K8 then copies
// element i of block p, of digit d, to offsets[p][d] + i - (start of d's
// run in the block).
//
// What changed from the TPU: there, ranks came from one-hot matmuls on the
// MXU (no atomics, no ballots), and placement walked the blocks in order on
// one core with per-bucket append streams, accumulating each digit's
// position as it went. Hopper blocks run in parallel and in no order, so
// the spine gives each block its own base per digit, and ranks come from
// warp match masks.
//
// Stability is the whole LSD contract, so no rank comes from an atomic
// counter, whose order changes from run to run. K7 ranks as CUB's
// match-based block rank does. Warp w of a block owns a contiguous
// segment of 32·KPT keys and holds them in registers, slot e of lane l
// being key 32e + l of the segment, so (slot, lane) is input order. Per
// slot, one ballot per digit bit groups the lanes holding one digit (the
// peers __match_any_sync would give, for less); a key's rank
// in the warp is the warp's running count of its digit (one entry of a
// shared (digit, warp) table, which the walk leaves holding the warp's
// count) plus its peers in lower lanes. One block-wide exclusive scan of
// the table in digit-major order then gives each (digit, warp) run its
// start in the sorted block, and the block's histogram.
//
// What bounds them on an H100: K7 and K8 move every key (and value) once
// in and once out of HBM and do a few integer operations per key, so both
// are bound by bytes. K7 copies its block into shared memory with 16-byte
// asynchronous copies (cp.async), keeps keys, values and ranks in
// registers, scatters keys and values into shared memory in one pass and
// writes the sorted block back with 16-byte stores: five barriers a block,
// and shared memory for the block and the count table only. K8 takes each
// key's digit from the key itself and writes it to delta[digit] + its
// index: one shared lookup a key and no search for its run (CUB's
// onesweep downsweep does the same). Its loads are issued before the
// block builds its delta table, and a warp's stores cover 32 consecutive
// keys, contiguous within each (block, digit) run (64 keys on average at
// 8 bits and 16384-key blocks). What holds it back is the scatter: it
// reaches about two thirds of the byte bound on an H100. Small tiles (512
// keys, 65536 blocks at 2^25) were faster than larger ones, than tiles
// staged through shared memory by 16-byte copies, and, for keys, than
// staging the output so that each warp store fills one 128-byte line
// (PERF.md, section 6). The spine's table is 2 MB at 2^25 keys and sits in L2
// after K7, so its bound is about a microsecond. It runs as one cluster
// of 8 blocks that share their column sums through distributed shared
// memory, so that no torch op and no second launch is needed; with 8
// rows a thread in flight on 8 SMs it takes about 18 us at 2048 rows,
// and its time grows with the rows (0.3 ms at 65536). No TMA and no
// decoupled look-back yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // most threads of a K7 block: RADIX_THREADS
constexpr int kVecKeys = 4;    // keys in one 16-byte vector
constexpr int kPlaceThreads = 256;  // K8 scans radix <= 256 digits
constexpr int kPlaceTile = 512;     // keys of a K8 block: 2 a thread
constexpr int kSpineCluster = 8;  // blocks of the spine's one cluster
constexpr int kSpineThreads = 1024;
constexpr int kSpineUnroll = 8;   // rows a spine thread has in flight
constexpr int kMaxRadix = 256;  // scans below need blockDim >= radix
constexpr int kSmemBytes = 232448;
constexpr int kMinBlock = 512;    // RADIX_THREADS in config.py
constexpr int kMaxBlock = 16384;  // MAX_RADIX_BLOCK in config.py
static_assert(kMinBlock % kPlaceTile == 0, "a K8 tile lies in one block");

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

// Threads of a K7 block: one per 4 keys (one 16-byte vector) up to
// kThreads, so 4 to 32 keys a thread. Must match `sort_geometry` in
// ops/block_sort.py.
__host__ __device__ constexpr int sort_threads(int block) {
  return block / kVecKeys < kThreads ? block / kVecKeys : kThreads;
}

// Row stride of the (digit, warp) count table: one word more than the
// warps, an odd number, so a warp's entries for 32 different digits lie
// in 32 different banks (at a stride of 16 they shared two).
__host__ __device__ constexpr int table_stride(int warps) { return warps + 1; }

// Keys (and values) of the block, the (digit, warp) count table, and 32
// ints of scan scratch.
constexpr size_t sort_smem(int block, int bits, bool kv) {
  return size_t(4) *
         (size_t(block) * (kv ? 2 : 1) +
          (size_t(1) << bits) * table_stride(sort_threads(block) / 32) + 32);
}

__device__ __forceinline__ void copy16_async(uint32_t* dst,
                                             const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// In-place exclusive scan of the (digit, warp) table in digit-major order
// (entry e = (d, w) at tab[d * table_stride + w]) by the whole block: each
// thread takes PER consecutive entries (8 at 8-bit digits; at 4-bit
// digits the first half of the threads take one each), then the threads'
// sums are scanned across each warp and the warps' totals across the
// block with shuffles: one barrier. The caller syncs before and after.
template <int BITS>
__device__ __forceinline__ void table_exclusive_scan(int* tab, int* wsum) {
  constexpr int PER = (1 << BITS) >= 32 ? (1 << BITS) / 32 : 1;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nw = blockDim.x >> 5, lw = __ffs(nw) - 1;
  const bool mine = t * PER < (1 << BITS) * nw;
  // entry t * PER + i; read twice rather than held, to spare registers
  auto at = [&](int i) {
    const int e = t * PER + i;
    return (e >> lw) * table_stride(nw) + (e & (nw - 1));
  };
  int sum = 0;
  if (mine) {
#pragma unroll
    for (int i = 0; i < PER; ++i) sum += tab[at(i)];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  int wt = lane < nw ? wsum[lane] : 0;  // lane i: warp i's total
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wt, o);
    if (lane >= o) wt += y;
  }
  const int before = __shfl_sync(0xffffffffu, wt, w > 0 ? w - 1 : 0);
  int run = (w > 0 ? before : 0) + incl - sum;
  if (mine) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int x = tab[at(i)];
      tab[at(i)] = run;
      run += x;
    }
  }
}

// The lanes of the warp whose digit equals this lane's d < 2^BITS: one
// ballot per digit bit, as CUB's MatchAny builds it, in place of
// __match_any_sync (measured slower on the H100).
template <int BITS>
__device__ __forceinline__ unsigned digit_peers(uint32_t d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const bool one = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(0xffffffffu, one);
    peers &= one ? ones : ~ones;
  }
  return peers;
}

// K7: one block per `block` = blockDim.x * KPT keys. Writes the block
// stably sorted by the digit at `shift` to out_k (and the values, moved
// alike, to out_v), and its histogram to hist[blockIdx.x][0, 2^BITS).
template <bool KV, int KPT, int BITS>
__global__ void __launch_bounds__(kThreads, KPT > 8 ? 1 : KV ? 2 : 3)
    block_sort_kernel(const uint32_t* __restrict__ keys,
                      const uint32_t* __restrict__ vals,
                      uint32_t* __restrict__ out_k,
                      uint32_t* __restrict__ out_v, int* __restrict__ hist,
                      int shift) {
  constexpr int kRadix = 1 << BITS;
  constexpr uint32_t kMask = kRadix - 1;
  extern __shared__ uint4 tile4[];
  const int nthreads = blockDim.x, nw = nthreads >> 5;
  const int ts = table_stride(nw);
  const int block = nthreads * KPT;
  uint32_t* sk = reinterpret_cast<uint32_t*>(tile4);  // [block] keys
  uint32_t* sv = sk + block;                           // [block] values
  int* tab = reinterpret_cast<int*>(sk + (KV ? 2 : 1) * block);  // [radix][ts]
  int* wsum = tab + kRadix * ts;                                 // [32]
  const uint64_t base = uint64_t(blockIdx.x) * uint64_t(block);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;

  // The block into shared memory in input order by 16-byte asynchronous
  // copies; the count table is zeroed while they fly.
#pragma unroll
  for (int q = 0; q < KPT / kVecKeys; ++q) {
    const int i = (q * nthreads + t) * kVecKeys;
    copy16_async(sk + i, keys + base + i);
    if constexpr (KV) copy16_async(sv + i, vals + base + i);
  }
  for (int i = t; i < kRadix * ts; i += nthreads) tab[i] = 0;
  copies_wait();
  __syncthreads();

  // Warp w's segment into registers, slot e of lane l holding key
  // 32 KPT w + 32 e + l: (slot, lane) is input order.
  const int seg = w * 32 * KPT + lane;
  uint32_t k[KPT];
  uint32_t v[KV ? KPT : 1];
  uint32_t rank2[KPT / 2];  // two ranks (< 32 KPT) a register, 16 bits each
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    k[e] = sk[seg + 32 * e];
    if constexpr (KV) v[e] = sv[seg + 32 * e];
  }

  // Rank of each key among the warp's keys of its digit, in input order:
  // the warp's running count (its table entry, which every peer reads
  // and the lowest peer advances) plus the peers in lower lanes.
  const unsigned lower = (1u << lane) - 1u;
  volatile int* col = tab + w;  // col[d * ts]: warp w's count of digit d
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const uint32_t d = (k[e] >> shift) & kMask;
    const unsigned peers = digit_peers<BITS>(d);
    const int prior = col[d * ts];
    const int below = __popc(peers & lower);
    __syncwarp();
    if (below == 0) col[d * ts] = prior + __popc(peers);
    __syncwarp();
    const uint32_t r = uint32_t(prior + below);
    rank2[e / 2] = e & 1 ? rank2[e / 2] | r << 16 : r;
  }
  __syncthreads();

  // tab[d][w] becomes the start of warp w's keys of digit d in the sorted
  // block; digit d's count is the gap to digit d+1's start.
  table_exclusive_scan<BITS>(tab, wsum);
  __syncthreads();
  for (int d = t; d < kRadix; d += nthreads) {
    const int end = d + 1 < kRadix ? tab[(d + 1) * ts] : block;
    hist[uint64_t(blockIdx.x) * kRadix + d] = end - tab[d * ts];
  }

  // Keys and values to their sorted slots in one pass (every thread read
  // its segment before the barriers above), then out as 16-byte vectors.
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int pos = tab[((k[e] >> shift) & kMask) * ts + w] +
                    int(rank2[e / 2] >> (16 * (e & 1)) & 0xFFFFu);
    sk[pos] = k[e];
    if constexpr (KV) sv[pos] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < KPT / kVecKeys; ++q) {
    const int i = (q * nthreads + t) * kVecKeys;
    *reinterpret_cast<uint4*>(out_k + base + i) =
        *reinterpret_cast<const uint4*>(sk + i);
    if constexpr (KV)
      *reinterpret_cast<uint4*>(out_v + base + i) =
          *reinterpret_cast<const uint4*>(sv + i);
  }
}

// The spine: one cluster of CL blocks over the (nblocks, radix) histogram.
// Block k takes a contiguous slice of rows; thread (j, c) of it (c = t %
// radix, j = t / radix) a contiguous part of that slice in column c, so a
// warp reads whole rows (128 bytes at radix 256). Phase 1 sums
// each thread's part; a scan over j gives each part's start within the
// slice and the slice's column sums, which the blocks of the cluster read
// from each other's shared memory: each column's total, and its sum over
// the slices before this one. The totals' exclusive scan is g (g_row,
// written by block 0); phase 2 reads the rows again and writes each row's
// running column sums plus g.
template <int CL>
__global__ void __launch_bounds__(kSpineThreads)
    spine_kernel(const int* __restrict__ hist, int* __restrict__ g_row,
                 int* __restrict__ offsets, long long nblocks, int bits) {
  __shared__ int part[kSpineThreads];  // [j][c]: part sums, then starts
  __shared__ int colsum[kMaxRadix];    // this slice's column sums
  __shared__ int base[kMaxRadix];
  __shared__ int wsum[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int radix = 1 << bits, t = threadIdx.x;
  const int c = t & (radix - 1), j = t >> bits;
  const int parts = kSpineThreads >> bits;
  const long long slice = (nblocks + CL - 1) / CL;
  const long long r0 = min(rank * slice, nblocks);
  const long long r1 = min(r0 + slice, nblocks);
  const long long each = (r1 - r0 + parts - 1) / parts;
  const long long a = min(r0 + j * each, r1), b = min(a + each, r1);
  const int* col = hist + c;

  int sum = 0;
  long long r = a;
  for (; r + kSpineUnroll <= b; r += kSpineUnroll) {
    int v[kSpineUnroll];
#pragma unroll
    for (int u = 0; u < kSpineUnroll; ++u) v[u] = col[(r + u) * radix];
#pragma unroll
    for (int u = 0; u < kSpineUnroll; ++u) sum += v[u];
  }
  for (; r < b; ++r) sum += col[r * radix];
  part[t] = sum;
  __syncthreads();
  if (t < radix) {
    int run = 0;
    for (int q = 0; q < parts; ++q) {
      const int x = part[q * radix + t];
      part[q * radix + t] = run;
      run += x;
    }
    colsum[t] = run;
  }
  cluster.sync();
  int before = 0;
  if (t < radix) {
    int total = 0;
    for (int k = 0; k < CL; ++k) {
      const int x = cluster.map_shared_rank(colsum, k)[t];
      total += x;
      if (k < rank) before += x;
    }
    base[t] = total;
  }
  cluster.sync();  // no block leaves while another reads its colsum
  block_exclusive_scan(base, radix, wsum);
  if (t < radix) {
    if (rank == 0) g_row[t] = base[t];
    base[t] += before;
  }
  __syncthreads();

  int run = base[c] + part[t];
  int* out = offsets + c;
  r = a;
  for (; r + kSpineUnroll <= b; r += kSpineUnroll) {
    int v[kSpineUnroll];
#pragma unroll
    for (int u = 0; u < kSpineUnroll; ++u) v[u] = col[(r + u) * radix];
#pragma unroll
    for (int u = 0; u < kSpineUnroll; ++u) {
      out[(r + u) * radix] = run;
      run += v[u];
    }
  }
  for (; r < b; ++r) {
    const int v = col[r * radix];
    out[r * radix] = run;
    run += v;
  }
}

// K8: one block per kPlaceTile keys of block-sorted input; block p's
// tiles are blocks p * tiles .. p * tiles + tiles - 1. Thread t loads keys
// t and t + kPlaceThreads of the tile (and their values), coalesced, before
// the block builds delta[d] = offsets[p][d] - s_d + (the tile's first
// index in block p), s the exclusive scan of hist[p]. Then key i of the
// tile, of digit d, goes to delta[d] + i: the same place as the run
// formula, since the block is sorted by d and hist[p] is its histogram.
// A warp's stores are 32 consecutive keys of the block.
template <bool KV>
__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ yv,
                 const int* __restrict__ hist,
                 const int* __restrict__ offsets, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ outv, int block, int shift,
                 int bits) {
  constexpr int KPT = kPlaceTile / kPlaceThreads;
  __shared__ int delta[kMaxRadix];
  __shared__ int wsum[32];
  const int radix = 1 << bits, t = threadIdx.x;
  const int tiles = block / kPlaceTile;
  const uint64_t p = blockIdx.x / tiles;
  const int i0 = int(blockIdx.x % tiles) * kPlaceTile;
  const uint64_t base = p * uint64_t(block) + i0;

  uint32_t k[KPT], v[KV ? KPT : 1];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    k[j] = y[base + j * kPlaceThreads + t];
    if constexpr (KV) v[j] = yv[base + j * kPlaceThreads + t];
  }
  int off = 0;
  if (t < radix) {
    delta[t] = hist[p * radix + t];
    off = offsets[p * radix + t];
  }
  block_exclusive_scan(delta, radix, wsum);
  if (t < radix) delta[t] = off - delta[t] + i0;
  __syncthreads();

  const uint32_t mask = uint32_t(radix - 1);
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = j * kPlaceThreads + t;
    const int dst = delta[(k[j] >> shift) & mask] + i;
    out[dst] = k[j];
    if constexpr (KV) outv[dst] = v[j];
  }
}

// Every power of two from kMinBlock to kMaxBlock, 4- or 8-bit digits.
bool bad_geometry(long long nblocks, int block, int bits) {
  return nblocks < 0 || nblocks > 0x7fffffffLL || (bits != 4 && bits != 8) ||
         block < kMinBlock || block > kMaxBlock || (block & (block - 1));
}

struct SortArgs {
  const uint32_t* keys;
  const uint32_t* vals;
  uint32_t* out_k;
  uint32_t* out_v;
  int* hist;
  long long nblocks;
  int block, shift, bits;
  cudaStream_t st;
};

template <bool KV, int KPT, int BITS>
int launch_match(const SortArgs& a) {
  const size_t smem = sort_smem(a.block, BITS, KV);
  cudaError_t e = cudaFuncSetAttribute(
      block_sort_kernel<KV, KPT, BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  block_sort_kernel<KV, KPT, BITS>
      <<<unsigned(a.nblocks), a.block / KPT, smem, a.st>>>(
          a.keys, a.vals, a.out_k, a.out_v, a.hist, a.shift);
  return int(cudaGetLastError());
}

template <bool KV, int BITS>
int launch_match_kpt(const SortArgs& a) {
  switch (a.block / sort_threads(a.block)) {
    case 4:
      return launch_match<KV, 4, BITS>(a);
    case 8:
      return launch_match<KV, 8, BITS>(a);
    case 16:
      return launch_match<KV, 16, BITS>(a);
    case 32:
      return launch_match<KV, 32, BITS>(a);
  }
  return int(cudaErrorInvalidValue);
}

template <bool KV>
int launch_block_sort(const SortArgs& a) {
  if (a.nblocks == 0) return int(cudaSuccess);
  return a.bits == 4 ? launch_match_kpt<KV, 4>(a)
                     : launch_match_kpt<KV, 8>(a);
}

template <bool KV>
int launch_place(const void* y, const void* yv, const void* hist,
                 const void* offsets, void* out, void* outv,
                 long long nblocks, int block, int shift, int bits,
                 cudaStream_t st) {
  if (nblocks == 0) return int(cudaSuccess);
  const long long grid = nblocks * (block / kPlaceTile);
  place_kernel<KV><<<unsigned(grid), kPlaceThreads, 0, st>>>(
      static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(yv),
      static_cast<const int*>(hist), static_cast<const int*>(offsets),
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(outv), block,
      shift, bits);
  return int(cudaGetLastError());
}

}  // namespace

// Each call launches one kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry the kernels do not take). `kv` != 0
// moves the values too; otherwise their pointers are not read. K7's
// buffers must be 16-byte aligned (its copies and stores are 16-byte
// vectors).
extern "C" {

int vrs_block_sort(int kv, const void* keys, const void* vals, void* out_k,
                   void* out_v, void* hist, long long nblocks, int block,
                   int shift, int bits, void* stream) {
  if (bad_geometry(nblocks, block, bits) || shift < 0 || shift > 31 ||
      sort_smem(block, bits, kv != 0) > size_t(kSmemBytes))
    return int(cudaErrorInvalidValue);
  const SortArgs a{static_cast<const uint32_t*>(keys),
                   static_cast<const uint32_t*>(vals),
                   static_cast<uint32_t*>(out_k),
                   static_cast<uint32_t*>(out_v),
                   static_cast<int*>(hist),
                   nblocks,
                   block,
                   shift,
                   bits,
                   static_cast<cudaStream_t>(stream)};
  return kv ? launch_block_sort<true>(a) : launch_block_sort<false>(a);
}

int vrs_place(int kv, const void* y, const void* yv, const void* hist,
              const void* offsets, void* out, void* outv, long long nblocks,
              int block, int shift, int bits, void* stream) {
  if (bad_geometry(nblocks, block, bits) || shift < 0 || shift > 31 ||
      nblocks * (block / kPlaceTile) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return kv ? launch_place<true>(y, yv, hist, offsets, out, outv, nblocks,
                                 block, shift, bits, st)
            : launch_place<false>(y, yv, hist, offsets, out, outv, nblocks,
                                  block, shift, bits, st);
}

// One launch: g_row (radix,) and offsets (nblocks, radix) from hist
// (nblocks, radix), all int32.
int vrs_spine(const void* hist, void* g_row, void* offsets,
              long long nblocks, int bits, void* stream) {
  if (nblocks < 0 || (bits != 4 && bits != 8))
    return int(cudaErrorInvalidValue);
  // the cluster's shape is a launch attribute: its blocks are resident
  // together and read each other's shared memory
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSpineCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSpineCluster);
  cfg.blockDim = dim3(kSpineThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, spine_kernel<kSpineCluster>,
                                static_cast<const int*>(hist),
                                static_cast<int*>(g_row),
                                static_cast<int*>(offsets), nblocks, bits));
}

}  // extern "C"
