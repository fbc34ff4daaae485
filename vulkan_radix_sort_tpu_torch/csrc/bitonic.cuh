// The templates of the chunk (K1), local (K4, K6) and cross (K3) kernels
// and their launchers, shared by bitonic.cu (the 32-bit carries) and
// network_w64.cu (the three-word carries); see bitonic.cu for what each
// kernel replaces and what bounds it.

#pragma once

#include "network.cuh"
#include "wide.cuh"

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
  uint32_t* u;
  uint32_t* v;
  __device__ Tile(uint32_t* smem, int n)
      : k(smem), t(smem + n), u(smem + 2 * n), v(smem + WORDS * n) {}

  __device__ __forceinline__ void load(int i, const Bufs<WORDS, RIDE>& g,
                                       uint64_t gi) {
    k[i] = g.k[gi];
    if constexpr (WORDS >= 2) t[i] = g.t[gi];
    if constexpr (WORDS == 3) u[i] = g.u[gi];
    if constexpr (RIDE != 0) v[i] = g.v[gi];
  }

  __device__ __forceinline__ void store(int i, const Bufs<WORDS, RIDE>& g,
                                        uint64_t gi) const {
    g.k[gi] = k[i];
    if constexpr (WORDS >= 2) g.t[gi] = t[i];
    if constexpr (WORDS == 3) g.u[gi] = u[i];
    if constexpr (RIDE != 0) g.v[gi] = v[i];
  }

  // Compare-exchange of slots a < b: ascending leaves the smaller at a.
  // Ties never swap, so a riding value stays put between equal tuples.
  // The first two words compare as one 64-bit word, a third on a tie.
  __device__ __forceinline__ void ce(int a, int b, bool desc) {
    if constexpr (WORDS == 1) {
      const uint32_t x = k[a], y = k[b];
      const uint32_t lo = min(x, y), hi = max(x, y);
      k[a] = desc ? hi : lo;
      k[b] = desc ? lo : hi;
    } else {
      const uint64_t x = (uint64_t(k[a]) << 32) | t[a];
      const uint64_t y = (uint64_t(k[b]) << 32) | t[b];
      bool gt = x > y, lt = x < y;
      if constexpr (WORDS == 3) {
        gt = gt || (x == y && u[a] > u[b]);
        lt = lt || (x == y && u[a] < u[b]);
      }
      if (desc ? lt : gt) {
        k[a] = uint32_t(y >> 32);
        t[a] = uint32_t(y);
        k[b] = uint32_t(x >> 32);
        t[b] = uint32_t(x);
        if constexpr (WORDS == 3) {
          const uint32_t ua = u[a];
          u[a] = u[b];
          u[b] = ua;
        }
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

// K3 in the three-word carries (W3, W4_BIG): a span of merge round r's
// cross stages, at distances 2^(lc+t) for t = t_lo+span-1 .. t_lo. Those
// stages only pair elements that differ in flat-index bits lc+t_lo ..
// lc+t_lo+span-1, so a tile is the 2^span elements differing in those
// bits, for each of kCrossW consecutive offsets (one coalesced 256-byte
// run per row), held in shared memory with one barrier per stage. Flat
// index bits, low to high: w (kLogCrossW) | q1 | span bits | q2; the tile
// id enumerates (q1, q2). Tiles never straddle a round-r group (span bits
// lie below bit lc+r), so the direction and the validity flag are per
// tile. The 32-bit carries take cross_cols_kernel below.
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
// when a stage lies at distance 2^(L+5) or more. K1 in the three-word
// carries is wide.cuh's where wide_chunk admits it, chosen at compile time.
template <int W, int R, int LC>
int launch_chunk_local(const Bufs<W, R>& g, long long nunits, int r,
                       const int* valid, cudaStream_t st) {
  using Rg = Regs<W, R, LC>;
  constexpr size_t smem = Rg::kSmemBytes;
  cudaError_t e;
  if (r < 0) {
    if constexpr (W == 3 && wide_chunk(R, LC)) {
      return launch_chunk_wide<W, R, LC>(g, nunits, valid, st);
    } else {
      e = allow_smem(chunk_kernel<W, R, LC>, smem);
      if (e != cudaSuccess) return int(e);
      chunk_kernel<W, R, LC><<<unsigned(nunits), Rg::kThreads, smem, st>>>(
          g, valid);
    }
  } else {
    e = allow_smem(local_kernel<W, R, LC>, smem);
    if (e != cudaSuccess) return int(e);
    local_kernel<W, R, LC><<<unsigned(nunits), Rg::kThreads, smem, st>>>(
        g, r, valid);
  }
  return int(cudaGetLastError());
}

// K1 (r < 0) or K4 at every chunk from 2^8 (MIN_CHUNK) to the carry's
// register cap: 2^15 for keys, 2^14 for the two-word carries, 2^13 for
// the three-word ones.
template <int W, int R>
int launch_regs(void* a0, void* a1, void* a2, void* a3, long long nunits,
                int lc, int r, const int* valid, cudaStream_t st) {
  const Bufs<W, R> g = bufs<W, R>(a0, a1, a2, a3);
  switch (lc) {
#define VRS_LC(n)                                                  \
  case n:                                                          \
    if constexpr (n <= reg_cap_log(W, R))                          \
      return launch_chunk_local<W, R, n>(g, nunits, r, valid, st); \
    break;
    VRS_LC(8) VRS_LC(9) VRS_LC(10) VRS_LC(11) VRS_LC(12) VRS_LC(13)
    VRS_LC(14) VRS_LC(15)
#undef VRS_LC
  }
  return int(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K3 in the 32-bit carries (KEYS, PAIRS, STABLE): register columns.
//
// A span's stages only pair elements that differ in its span bits, so
// each column (one low offset, all 2^S span positions) is a problem of its
// own. A thread holds V = kColsVec consecutive columns (one 8-byte vector
// access a row) at 2^A span positions in registers, A = min(S,
// cols_rows_log): kColsWordsCompared compared words a thread at A =
// cols_rows_log (32 positions of keys, 16 of a two-word carry). Flat
// index bits, low to high: vector (log2 V) | the rest of the low lc+t_lo
// bits | span bits (S) | q2. Every load is issued before the first
// compare-exchange, and a stage whose pair the thread holds runs between
// its registers: no shared memory, no barrier.
//   S <= A  every thread is a tile of its own: threads take consecutive
//           vectors of one row, so a warp moves 32 V-word runs, and run
//           all S stages in registers.
//   S > A   a tile of kColsW consecutive columns by 2^S rows, kColsW / V
//           threads across a row and 2^(S-A) row groups. Layout A (the
//           load): thread (c, g) holds rows g + (e << (S-A)), so its registers
//           span the high A span bits and run stages S-1 .. S-A. One
//           transpose through shared memory (one barrier) gives layout B:
//           rows e + (g << A), the low A span bits, stages S-A-1 .. 0;
//           the thread stores from B. So the cap is S = 2A. Both layouts
//           move contiguous rows of kColsW words (128 bytes) and a warp's
//           shared-memory accesses are contiguous per row, free of bank
//           conflicts.
// The direction is the thread's (bit lc+r of its index: span bits lie
// below it), so a descending thread holds its compared words negated and
// every stage sorts ascending (see Regs); the validity flag is its
// round-r group's.
//
// Bound: HBM bytes (each element read and written once a launch). On an
// H100 these launches reach 83-86% of it at 2^25 elements, where the
// first design (cross_kernel) reached 37-63% (PERF.md). Geometry
// measured there against 16-byte vectors of keys (16 positions, cap 8),
// 64-column tiles (a spill in the stable carry at S = 8) and 16-byte
// vectors in the two-word carries (8 positions, cap 6, more launches):
// keys with 32 positions and cap 10 took the least time a sort.

constexpr int kColsThreads = 256;  // threads a block where S <= A
constexpr int kColsW = 32;         // columns of a shared-memory tile
constexpr int kColsVec = 2;        // columns a thread (V)
constexpr int kColsWordsCompared = 64;  // compared words a thread

// log2 of the span positions a thread holds in a carry of `words`
// compared words: 5 for keys, 4 for the two-word carries.
__host__ __device__ constexpr int cols_rows_log(int words) {
  return log2_of(kColsWordsCompared / (kColsVec * words));
}

// The deepest cross span of a carry: twice cols_rows_log in the 32-bit
// carries (one transpose), the shared-memory tile's for W3 and W4_BIG.
// `Mode.cross_cap` in Python.
__host__ __device__ constexpr int cross_cap_log(int words, int ride) {
  return words == 3 ? smem_cap_log(words + ride) - kLogCrossW
                    : 2 * cols_rows_log(words);
}

// A thread's kColsVec = 2 words of a row as one 8-byte access.
__device__ __forceinline__ void vec_load(uint32_t* d, const uint32_t* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  d[0] = x.x;
  d[1] = x.y;
}

__device__ __forceinline__ void vec_store(uint32_t* p, const uint32_t* d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(d[0], d[1]);
}

// kColsVec columns by NR rows of a carry in registers: element (row e,
// column c) is register c + V * e, so row bit j is register bit j + 1.
template <int WORDS, int RIDE, int NR>
struct Cols : Elems<WORDS, RIDE, kColsVec * NR> {
  static_assert(WORDS <= 2, "the three-word carries take cross_kernel");
  static constexpr int V = kColsVec;
  using Base = Elems<WORDS, RIDE, V * NR>;
  using Base::k;
  using Base::t;
  using Base::v;

  // Row e from or to index base + ((r0 + e * step) << shift) of each
  // array of g (global or shared memory).
  template <typename I>
  __device__ __forceinline__ void load(const Bufs<WORDS, RIDE>& g, I base,
                                       I r0, I step, int shift) {
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const I i = base + ((r0 + e * step) << shift);
      vec_load(k + V * e, g.k + i);
      if constexpr (WORDS == 2) vec_load(t + V * e, g.t + i);
      if constexpr (RIDE != 0) vec_load(v + V * e, g.v + i);
    }
  }

  template <typename I>
  __device__ __forceinline__ void store(const Bufs<WORDS, RIDE>& g, I base,
                                        I r0, I step, int shift) const {
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const I i = base + ((r0 + e * step) << shift);
      vec_store(g.k + i, k + V * e);
      if constexpr (WORDS == 2) vec_store(g.t + i, t + V * e);
      if constexpr (RIDE != 0) vec_store(g.v + i, v + V * e);
    }
  }

  // Stages at span bits TOP-1 .. LO, span bit LO held at row bit 0.
  template <int TOP, int LO>
  __device__ __forceinline__ void stages() {
#pragma unroll
    for (int s = TOP - 1; s >= LO; --s) this->reg_stage(log2_of(V) + s - LO);
  }
};

// The geometry of a span of S stages in a carry of WORDS compared words:
// A span positions a thread (log2), threads a tile (TT) and a block.
// Blocks are kColsThreads threads where every thread is a tile (S <= A),
// else one or more tiles of (kColsW / V) << (S - A) threads, at least
// kColsTileThreads.
constexpr int kColsTileThreads = 128;
template <int WORDS, int S>
struct ColsGeo {
  static constexpr int V = kColsVec;
  static constexpr int A =
      S < cols_rows_log(WORDS) ? S : cols_rows_log(WORDS);
  static constexpr int G = S - A;  // span bits across a tile's threads
  static constexpr int CT = kColsW / V;  // threads a row
  static constexpr int TT = CT << G;     // threads a tile
  static constexpr int kThreads =
      G == 0 ? kColsThreads
             : (TT < kColsTileThreads ? kColsTileThreads : TT);
  static constexpr int NB = G == 0 ? 0 : (kColsW << S) * (kThreads / TT);
  static constexpr size_t kSmemBytes = size_t(NB) * 4;  // a block's, a word
  static_assert(0 < A && G <= A, "unsupported span geometry");
  // a group holds 2^(lc+r-log2 kColsW-S) >= 2^(8-log2 kColsW) tiles (lc >=
  // 8, r >= S), so a block's tiles share one group: its flag and direction
  static_assert(G == 0 || kThreads / TT <= 1 << (8 - log2_of(kColsW)),
                "a block's tiles would straddle a round-r group");
};

template <int WORDS, int RIDE, int S>
__global__ void __launch_bounds__(ColsGeo<WORDS, S>::kThreads)
    cross_cols_kernel(Bufs<WORDS, RIDE> g, int lc, int r, int t_lo,
                      const int* valid) {
  using Geo = ColsGeo<WORDS, S>;
  constexpr int V = Geo::V, A = Geo::A, G = Geo::G, CT = Geo::CT;
  constexpr int TT = Geo::TT, LW = log2_of(kColsW);
  const int lspan = lc + t_lo;
  uint64_t base;      // the thread's first element
  uint32_t row0 = 0;  // its row group
  uint32_t col = 0;   // its first column in the block's shared memory
  if constexpr (G == 0) {
    const uint64_t x = uint64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    const int cbits = lspan - log2_of(V);
    base = ((x & ((uint64_t(1) << cbits) - 1)) << log2_of(V)) |
           ((x >> cbits) << (lspan + S));
  } else {
    const uint64_t tile =
        uint64_t(blockIdx.x) * (Geo::kThreads / TT) + threadIdx.x / TT;
    const int q1_bits = lspan - LW;
    const uint32_t c = threadIdx.x % TT % CT * V;
    base = ((tile & ((uint64_t(1) << q1_bits) - 1)) << LW) |
           ((tile >> q1_bits) << (lspan + S)) | c;
    row0 = threadIdx.x % TT / CT;
    col = (threadIdx.x / TT << (LW + S)) + c;
  }
  if (valid != nullptr && valid[base >> (lc + r)] == 0) return;
  const uint32_t desc = 0u - uint32_t(base >> (lc + r) & 1);
  Cols<WORDS, RIDE, 1 << A> x;
  // layout A: row e is span row row0 + (e << G)
  x.load(g, base, uint64_t(row0), uint64_t(1) << G, lspan);
  x.negate_all(desc);
  x.template stages<S, G>();
  if constexpr (G > 0) {
    extern __shared__ uint32_t smem[];
    constexpr int NB = Geo::NB;
    const Bufs<WORDS, RIDE> s{smem, smem + NB, nullptr, smem + WORDS * NB};
    x.store(s, col, row0, uint32_t(1) << G, LW);
    __syncthreads();
    // layout B: row e is span row e + (row0 << A)
    x.load(s, col, row0 << A, 1u, LW);
    x.template stages<G, 0>();
  }
  x.negate_all(desc);
  x.store(g, base, uint64_t(row0) << A, uint64_t(1), lspan);
}

// One cross_cols_kernel launch on round-r groups of 2^(lc+r) elements.
template <int W, int R, int S>
int launch_cols(const Bufs<W, R>& g, long long ngroups, int lc, int r,
                int t_lo, const int* valid, cudaStream_t st) {
  using Geo = ColsGeo<W, S>;
  constexpr size_t smem = Geo::kSmemBytes * (W + R);
  const cudaError_t e = allow_smem(cross_cols_kernel<W, R, S>, smem);
  if (e != cudaSuccess) return int(e);
  // V << A elements a thread; a group has at least 64 threads (lc >= 8,
  // r >= S), which a block of kColsThreads may exceed where S == A
  const long long per_group = 1LL << (lc + r - Geo::A - log2_of(Geo::V));
  const int block =
      per_group < Geo::kThreads ? int(per_group) : Geo::kThreads;
  cross_cols_kernel<W, R, S>
      <<<unsigned(ngroups * per_group / block), block, smem, st>>>(
          g, lc, r, t_lo, valid);
  return int(cudaGetLastError());
}

// K3: cross_cols_kernel at every span up to cross_cap_log in the 32-bit
// carries; cross_kernel in the three-word ones (network_w64.cu), chosen
// at compile time by the carry.
template <int W, int R>
int launch_cross(void* a0, void* a1, void* a2, void* a3, long long ngroups,
                 int lc, int r, int t_lo, int span, const int* valid,
                 cudaStream_t st) {
  const Bufs<W, R> g = bufs<W, R>(a0, a1, a2, a3);
  if constexpr (W == 3) {
    const int n = kCrossW << span;
    const size_t smem = tile_bytes(n, W, R);
    cudaError_t e = allow_smem(cross_kernel<W, R>, smem);
    if (e != cudaSuccess) return int(e);
    // a round-r group of 2^(lc+r) elements splits into tiles of n elements
    const long long tiles = ngroups << (lc + r - kLogCrossW - span);
    cross_kernel<W, R><<<unsigned(tiles), threads_for(n), smem, st>>>(
        g, lc, r, t_lo, span, valid);
    return int(cudaGetLastError());
  } else {
    switch (span) {
#define VRS_SPAN(s)                                                        \
  case s:                                                                  \
    if constexpr (s <= cross_cap_log(W, R))                                \
      return launch_cols<W, R, s>(g, ngroups, lc, r, t_lo, valid, st);     \
    break;
      VRS_SPAN(1) VRS_SPAN(2) VRS_SPAN(3) VRS_SPAN(4) VRS_SPAN(5)
      VRS_SPAN(6) VRS_SPAN(7) VRS_SPAN(8) VRS_SPAN(9) VRS_SPAN(10)
#undef VRS_SPAN
    }
    return int(cudaErrorInvalidValue);
  }
}

}  // namespace
