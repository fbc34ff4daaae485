// Shared by the network kernels' sources (bitonic.cu, fused.cu): the
// carry's buffers and the register layout of K1, K2 and K4 (Regs).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kSmemBytes = 232448;

template <int WORDS, int RIDE>
struct Bufs {
  uint32_t* k;
  uint32_t* t;
  uint32_t* v;
};

// ---------------------------------------------------------------------------
// K1 and K4 (and K6): one C-element chunk per block, E elements per thread
// in registers; K2 likewise on one group of chunks per block.
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

template <int WORDS, int RIDE, int LC,
          int THREADS = net_threads(WORDS, RIDE, LC)>
struct Regs {
  static constexpr int kThreads = THREADS;
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

  // Phases p0..LC, 9 <= p0 <= LC, p0 known only at run time (K2): entered
  // by falling through a switch into the same straight-line phases that
  // chunk_phases runs, so K2's code is K1's tail. The elements must be
  // negated as phase p0 - 1 leaves them (dir_mask(p0 - 1)).
  __device__ __forceinline__ void chunk_phases_from(int p0, uint32_t* smem) {
    static_assert(L < 8, "phases from 9 on must be merge phases");
    switch (p0) {
#define VRS_PHASE(pk)                                  \
  case pk:                                             \
    if constexpr (pk <= LC) chunk_phase<pk>(smem);     \
    [[fallthrough]];
      VRS_PHASE(9) VRS_PHASE(10) VRS_PHASE(11) VRS_PHASE(12) VRS_PHASE(13)
      VRS_PHASE(14) VRS_PHASE(15)
#undef VRS_PHASE
      default:
        break;
    }
  }
};

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
