// Bitonic compare-exchange network kernels for Hopper (sm_90a).
//
// CUDA counterparts of the four Pallas kernels behind `_sort_padded` in
// vulkan_radix_sort_tpu/ops/bitonic.py, plus that file's validity gate:
//
//   chunk_kernel   K1  _run_chunk / _chunk_phases_body   (bitonic.py:934, 513)
//   fused_kernel   K2  _run_fused_rounds / _fused_rounds_body (723, 628)
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
// element moved and are bound by HBM bytes. The chunk and local kernels
// keep a thread's elements in registers and run each stage between
// registers or lanes, with a shared-memory transpose (one barrier) only
// to reach distances of 32 threads and more (see Regs below). The fused
// and cross kernels load their tile once with coalesced accesses into
// shared memory, run every stage there with one __syncthreads() per stage,
// and write it back once; cluster (distributed shared memory) groups are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemBytes = 232448;
// Consecutive elements per row of a cross tile (256 bytes of keys); must
// match CROSS_W in ops/bitonic_kernels.py.
constexpr int kLogCrossW = 6;
constexpr int kCrossW = 1 << kLogCrossW;

template <int WORDS, int RIDE>
struct Bufs {
  uint32_t* k;
  uint32_t* t;
  uint32_t* v;
};

// A tile of n elements in dynamic shared memory, one array after another.
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

  // One stage over n tile slots at slot distance 2^j. With desc_const < 0
  // the direction is bit p of the pair's global index gbase + lo (tiles of
  // consecutive elements); otherwise it is desc_const for the whole tile.
  __device__ __forceinline__ void stage(int n, int j, uint64_t gbase, int p,
                                        int desc_const) {
    const int low = (1 << j) - 1;
    for (int c = threadIdx.x; c < n / 2; c += blockDim.x) {
      const int lo = ((c & ~low) << 1) | (c & low);
      const bool desc = desc_const >= 0
                            ? desc_const != 0
                            : (((gbase + uint64_t(lo)) >> p) & 1) != 0;
      ce(lo, lo | (1 << j), desc);
    }
    __syncthreads();
  }

  __device__ __forceinline__ void load_contig(const Bufs<WORDS, RIDE>& g,
                                              uint64_t gbase, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) load(i, g, gbase + i);
    __syncthreads();
  }

  __device__ __forceinline__ void store_contig(const Bufs<WORDS, RIDE>& g,
                                               uint64_t gbase, int n) const {
    for (int i = threadIdx.x; i < n; i += blockDim.x) store(i, g, gbase + i);
  }
};

// ---------------------------------------------------------------------------
// K1 and K4 (and K6): one C-element chunk per block, E elements per thread
// in registers.
//
// Thread t of C / E threads owns chunk elements [tE, tE + E), loaded and
// stored with 16-byte vector accesses, every load issued before the first
// compare-exchange. Write L = log2 E and T = log2(C / E). A stage at
// distance 2^j then runs where its pair lives:
//   j < L          between two registers of one thread;
//   L <= j < L+5   between lanes, with __shfl_xor_sync;
//   j >= L+5       in layout B, reached through one shared-memory round
//                  trip (a transpose, one barrier). In B thread (warp w,
//                  lane l) owns the elements w | l << (T-5) | e << T, so
//                  distances j >= T are register pairs and T-5 <= j < T
//                  lane pairs. Every admitted (E, C) has C <= 2^(2L+10),
//                  so B covers every j >= L+5 and no stage takes a
//                  barrier of its own: a merge phase with stages at
//                  j >= L+5 costs two transposes, one barrier each.
// The shared-memory layouts are padded by one word in 32 (and one in
// 1024), which makes both transposes free of bank conflicts.
//
// Directions: within a phase (direction bit p) each element's direction
// is fixed, so an element whose pair descends is held bitwise negated in
// both compared words; every stage then sorts ascending with the strict
// test, which on negated words is exactly the descending one (ties never
// swap, riding values are never negated). Masks change only between
// phases, with one XOR per compared word.
//
// Bound: K4 is HBM-bound (every element read and written once); K1 does
// log2C(log2C+1)/2 stages per element and is bound by int32 operations,
// which is why its stages avoid shared memory and barriers.

constexpr int kNetThreads = 512;  // largest block; NET_THREADS in the wrapper

// Threads of a chunk or local block at C = 2^lc: one per 16 keys or per 8
// elements of a two-word carry, at least one warp and at most kNetThreads;
// and 256 where a thread would hold 64 words or more (each carry's largest
// chunk), so its registers stay within the 255 a thread may have at 256
// threads rather than the 128 it has at 512. Must match `block_geometry`
// in ops/bitonic_kernels.py.
__host__ __device__ constexpr int net_threads(int words, int ride, int lc) {
  const int c = 1 << lc;
  int t = c / (words == 1 ? 16 : 8);
  t = t < 32 ? 32 : (t > kNetThreads ? kNetThreads : t);
  return c / t * (words + ride) >= 64 ? 256 : t;
}

// Blocks each SM must be able to hold: two while a thread holds at most
// 32 words of its carry (64 registers a thread at 512 threads), else one.
__host__ __device__ constexpr int net_min_blocks(int words, int ride, int lc) {
  return (1 << lc) / net_threads(words, ride, lc) * (words + ride) <= 32 ? 2
                                                                          : 1;
}

// Shared-memory slot of tile element i, and the words a tile of n takes.
// pad(a + b) == pad(a) + pad(b) for the sums the layouts form (b a
// multiple of 64 above a, or a multiple of E with b < E), so every
// per-register slot is a thread base plus a constant.
__host__ __device__ constexpr int pad_index(int i) {
  return i + (i >> 5) + (i >> 10);
}

__host__ __device__ constexpr int padded_words(int n) { return pad_index(n); }

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n >> 1); }

template <int WORDS, int RIDE, int LC>
struct Regs {
  static constexpr int kThreads = net_threads(WORDS, RIDE, LC);
  static constexpr int E = (1 << LC) / kThreads;  // elements per thread
  static constexpr int L = log2_of(E);
  static constexpr int WORDS_PAD = padded_words(1 << LC);
  // layout B reaches every distance from 2^(L+5) up
  static_assert(E >= 4 && LC <= 2 * L + 10, "unsupported chunk geometry");
  static constexpr bool kUsesSmem = LC - 1 >= L + 5;
  // Lane stages in a loop for the carry with a riding array: unrolled, its
  // chunk and local kernels need more than the 64 registers a thread that
  // two 512-thread blocks on one SM allow (measured, ptxas of CUDA 12.9).
  static constexpr int kShflUnroll = RIDE ? 1 : 5;
  static constexpr size_t kSmemBytes =
      kUsesSmem ? size_t(WORDS_PAD) * 4 * (WORDS + RIDE) : 0;

  uint32_t k[E];
  uint32_t t[WORDS == 2 ? E : 1];
  uint32_t v[RIDE ? E : 1];

  // First global index of the thread's elements.
  static __device__ __forceinline__ uint64_t base() {
    return (uint64_t(blockIdx.x) << LC) + threadIdx.x * E;
  }

  // 0 or ~0: the direction of the thread's elements while runs of 2^p are
  // built, p >= L (bit p of the index; p = LC is the chunk's parity).
  static __device__ __forceinline__ uint32_t dir_mask(int p) {
    return 0u - (((threadIdx.x * E) | ((blockIdx.x & 1) << LC)) >> p & 1);
  }

  __device__ __forceinline__ void load(const Bufs<WORDS, RIDE>& g,
                                       uint64_t base) {
    const uint4* pk = reinterpret_cast<const uint4*>(g.k + base);
    const uint4* pt = reinterpret_cast<const uint4*>(g.t + base);
    const uint4* pv = reinterpret_cast<const uint4*>(g.v + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      unpack(k, q, pk[q]);
      if constexpr (WORDS == 2) unpack(t, q, pt[q]);
      if constexpr (RIDE != 0) unpack(v, q, pv[q]);
    }
  }

  __device__ __forceinline__ void store(const Bufs<WORDS, RIDE>& g,
                                        uint64_t base) const {
    uint4* pk = reinterpret_cast<uint4*>(g.k + base);
    uint4* pt = reinterpret_cast<uint4*>(g.t + base);
    uint4* pv = reinterpret_cast<uint4*>(g.v + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      pk[q] = pack(k, q);
      if constexpr (WORDS == 2) pt[q] = pack(t, q);
      if constexpr (RIDE != 0) pv[q] = pack(v, q);
    }
  }

  static __device__ __forceinline__ void unpack(uint32_t* a, int q, uint4 x) {
    a[4 * q] = x.x;
    a[4 * q + 1] = x.y;
    a[4 * q + 2] = x.z;
    a[4 * q + 3] = x.w;
  }

  static __device__ __forceinline__ uint4 pack(const uint32_t* a, int q) {
    return make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }

  __device__ __forceinline__ void negate(int e, uint32_t m) {
    k[e] ^= m;
    if constexpr (WORDS == 2) t[e] ^= m;
  }

  __device__ __forceinline__ void negate_all(uint32_t m) {
#pragma unroll
    for (int e = 0; e < E; ++e) negate(e, m);
  }

  // Ascending compare-exchange of registers a < b; ties never swap.
  __device__ __forceinline__ void ce(int a, int b) {
    if constexpr (WORDS == 1) {
      const uint32_t x = k[a], y = k[b];
      k[a] = min(x, y);
      k[b] = max(x, y);
    } else {
      const uint32_t ka = k[a], ta = t[a];
      const bool swap = ((uint64_t(ka) << 32) | ta) >
                        ((uint64_t(k[b]) << 32) | t[b]);
      k[a] = swap ? k[b] : ka;
      k[b] = swap ? ka : k[b];
      t[a] = swap ? t[b] : ta;
      t[b] = swap ? ta : t[b];
      if constexpr (RIDE != 0) {
        const uint32_t va = v[a];
        v[a] = swap ? v[b] : va;
        v[b] = swap ? va : v[b];
      }
    }
  }

  // The stage between registers e and e ^ 2^jr of every thread.
  __device__ __forceinline__ void reg_stage(int jr) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (!(e & (1 << jr))) ce(e, e | (1 << jr));
  }

  // The stage between lanes l and l ^ m: the lower lane keeps the smaller
  // of each pair, the upper lane the larger. Both lanes decide on the same
  // strict test, so equal tuples stay where they are.
  __device__ __forceinline__ void shfl_stage(int m) {
    const bool upper = (threadIdx.x & m) != 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t yk = __shfl_xor_sync(0xFFFFFFFFu, k[e], m);
      if constexpr (WORDS == 1) {
        k[e] = upper ? max(k[e], yk) : min(k[e], yk);
      } else {
        const uint32_t yt = __shfl_xor_sync(0xFFFFFFFFu, t[e], m);
        uint32_t yv = 0;
        if constexpr (RIDE != 0) yv = __shfl_xor_sync(0xFFFFFFFFu, v[e], m);
        const uint64_t x = (uint64_t(k[e]) << 32) | t[e];
        const uint64_t y = (uint64_t(yk) << 32) | yt;
        const bool take = upper ? y > x : y < x;
        k[e] = take ? yk : k[e];
        t[e] = take ? yt : t[e];
        if constexpr (RIDE != 0) v[e] = take ? yv : v[e];
      }
    }
  }

  // Register e to or from slot pad(base) + pad(e << SH) of each array.
  template <int SH>
  __device__ __forceinline__ void to_smem(uint32_t* s, int pbase) const {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      uint32_t* p = s + pbase + pad_index(e << SH);
      p[0] = k[e];
      if constexpr (WORDS == 2) p[WORDS_PAD] = t[e];
      if constexpr (RIDE != 0) p[2 * WORDS_PAD] = v[e];
    }
  }

  template <int SH>
  __device__ __forceinline__ void from_smem(const uint32_t* s, int pbase) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t* p = s + pbase + pad_index(e << SH);
      k[e] = p[0];
      if constexpr (WORDS == 2) t[e] = p[WORDS_PAD];
      if constexpr (RIDE != 0) v[e] = p[2 * WORDS_PAD];
    }
  }

  // Stages JTOP..0 of one merge phase, starting and ending in layout A.
  template <int JTOP>
  __device__ __forceinline__ void merge(uint32_t* smem) {
    if constexpr (kUsesSmem && JTOP >= L + 5) transposed<JTOP>(smem);
#pragma unroll kShflUnroll
    for (int j = JTOP < L + 4 ? JTOP : L + 4; j >= L; --j)
      shfl_stage(1 << (j - L));
#pragma unroll
    for (int jr = JTOP < L - 1 ? JTOP : L - 1; jr >= 0; --jr) reg_stage(jr);
  }

  // Stages JTOP..L+5 in layout B, between two transposes.
  template <int JTOP>
  __device__ __forceinline__ void transposed(uint32_t* smem) {
    constexpr int LT = LC - L;  // log2 threads
    constexpr int BW = LT - 5;  // warp bits of layout B
    const int a = pad_index(threadIdx.x * E);
    const int b = pad_index((threadIdx.x >> 5) | ((threadIdx.x & 31) << BW));
    to_smem<0>(smem, a);
    __syncthreads();
    from_smem<LT>(smem, b);
#pragma unroll
    for (int jr = L - 1; jr >= 0; --jr)
      if (LT + jr <= JTOP && LT + jr >= L + 5) reg_stage(jr);
#pragma unroll kShflUnroll
    for (int j = JTOP < LT - 1 ? JTOP : LT - 1; j >= L + 5; --j)
      shfl_stage(1 << (j - BW));
    // each thread rewrites only the slots it read: no barrier before
    to_smem<LT>(smem, b);
    __syncthreads();
    from_smem<0>(smem, a);
  }

  // Phase PK of the chunk sort: set each element's direction (bit PK of
  // its index), then stages PK-1..0. Bit p < L of the index is bit p of
  // the register number, bit L the thread's lowest bit.
  template <int PK>
  __device__ __forceinline__ void chunk_phase(uint32_t* smem) {
    if constexpr (PK <= L) {
      const uint32_t now_l = PK == L ? dir_mask(L) : 0u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t was = PK == 1 ? 0u : (e >> (PK - 1)) & 1;
        const uint32_t now = PK == L ? 0u : (e >> PK) & 1;
        negate(e, (0u - (was ^ now)) ^ now_l);
      }
    } else {
      negate_all(dir_mask(PK - 1) ^ dir_mask(PK));
    }
    merge<PK - 1>(smem);
  }

  // Phases 1..LC, each compiled for its own depth.
  template <int... P>
  __device__ __forceinline__ void chunk_phases(
      uint32_t* smem, std::integer_sequence<int, P...>) {
    (chunk_phase<P + 1>(smem), ...);
  }
};

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

// K2: merge rounds r_lo..r_hi, cross and local stages alike, on one group
// of 2^r_hi chunks per block. A group of 2^g aligned chunks holds every
// pair of rounds r <= g, so one HBM round trip serves all of them.
template <int WORDS, int RIDE>
__global__ void __launch_bounds__(kMaxThreads)
    fused_kernel(Bufs<WORDS, RIDE> g, int lc, int r_lo, int r_hi,
                 const int* valid) {
  if (valid != nullptr && valid[blockIdx.x] == 0) return;
  extern __shared__ uint32_t smem[];
  const int lg = lc + r_hi;
  const int n = 1 << lg;
  Tile<WORDS, RIDE> s(smem, n);
  const uint64_t gbase = uint64_t(blockIdx.x) << lg;
  s.load_contig(g, gbase, n);
  for (int r = r_lo; r <= r_hi; ++r)
    for (int j = lc + r - 1; j >= 0; --j) s.stage(n, j, gbase, lc + r, -1);
  s.store_contig(g, gbase, n);
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
  const int desc = int((base >> (lc + r)) & 1);
  for (int t = span - 1; t >= 0; --t)
    s.stage(n, kLogCrossW + t, 0, 0, desc);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s.store(i, g, base + (uint64_t(i >> kLogCrossW) << lspan) +
                      (i & (kCrossW - 1)));
}

int threads_for(int n) { return n / 2 < kMaxThreads ? n / 2 : kMaxThreads; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > size_t(kSmemBytes)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

template <int W, int R>
Bufs<W, R> bufs(void* k, void* t, void* v) {
  return Bufs<W, R>{static_cast<uint32_t*>(k), static_cast<uint32_t*>(t),
                    static_cast<uint32_t*>(v)};
}

constexpr size_t tile_bytes(int n, int words, int ride) {
  return size_t(n) * 4 * (words + ride);
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
int launch_fused(void* k, void* t, void* v, long long ngroups, int lc,
                 int r_lo, int r_hi, const int* valid, cudaStream_t st) {
  const int n = 1 << (lc + r_hi);
  const size_t smem = tile_bytes(n, W, R);
  cudaError_t e = allow_smem(fused_kernel<W, R>, smem);
  if (e != cudaSuccess) return int(e);
  fused_kernel<W, R><<<unsigned(ngroups), threads_for(n), smem, st>>>(
      bufs<W, R>(k, t, v), lc, r_lo, r_hi, valid);
  return int(cudaGetLastError());
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

// Mode codes: 0 = KEYS <1,0>, 1 = PAIRS <2,0>, 2 = STABLE <2,1>. Each call
// launches one kernel on `stream` and returns cudaGetLastError().
#define VRS_DISPATCH(mode, fn, ...)                      \
  switch (mode) {                                        \
    case 0:                                              \
      return fn<1, 0>(__VA_ARGS__);                      \
    case 1:                                              \
      return fn<2, 0>(__VA_ARGS__);                      \
    case 2:                                              \
      return fn<2, 1>(__VA_ARGS__);                      \
    default:                                             \
      return int(cudaErrorInvalidValue);                 \
  }

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

int vrs_fused(int mode, void* k, void* t, void* v, long long ngroups, int lc,
              int r_lo, int r_hi, const int* valid, void* stream) {
  VRS_DISPATCH(mode, launch_fused, k, t, v, ngroups, lc, r_lo, r_hi, valid,
               static_cast<cudaStream_t>(stream));
}

int vrs_cross(int mode, void* k, void* t, void* v, long long ngroups, int lc,
              int r, int t_lo, int span, const int* valid, void* stream) {
  VRS_DISPATCH(mode, launch_cross, k, t, v, ngroups, lc, r, t_lo, span, valid,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
