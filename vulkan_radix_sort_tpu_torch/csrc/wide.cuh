// The chunk (K1) and fused-rounds (K2) kernels in the three-word carries of
// 64-bit keys, W3 <3,0> (hi, lo, v) and W4_BIG <3,1> (hi, lo, idx; v
// rides), for Hopper. The launchers of bitonic.cuh and fused.cuh take them
// at compile time (network_w64.cu builds them); the 32-bit carries keep
// Regs (network.cuh).
//
//   chunk_merge_kernel  K1 in W3: a merge sort (see Merge3). Every word is
//                       compared, so equal tuples are identical and any
//                       exact sort in the chunk's direction is bitwise the
//                       network's output.
//   chunk_wide_kernel   K1 in W4_BIG, chunks up to 2^12: the network (see
//                       Wide). Tied tuples (a pad index) carry distinct
//                       riding values, whose places are the network's, so
//                       its compare-exchange sequence is kept pair for
//                       pair. At 2^13 a thread of Wide would need more than
//                       the 128 registers of a 512-thread block, and
//                       chunk_kernel (Regs) sorts the chunk.
//   fused_wide_kernel   K2 in W3: Wide on a group, in persistent blocks
//                       that stage the next group in shared memory while
//                       they sort the current one. K2 in W4_BIG stays
//                       fused_kernel (fused.cuh): at 2^13 its four arrays
//                       leave Wide's thread 128 registers, and it spilled.
//
// What bounds them on an H100: K1 by integer instructions (log2C(log2C+1)/2
// compare-exchange stages an element), K2 by HBM bytes. The Regs kernels
// spend 10-13 ISETP and PLOP3 instructions on a compare-exchange's
// three-word compare beside its selects, and their fully unrolled phases
// (7688 instructions at chunk_kernel<3, 1, 12>) outgrow the instruction
// cache (PERF.md). Here a compare is one borrow chain (less3: 4 integer
// operations) whose mask picks each word with one bitwise select, and the
// phases are run-time loops over one copy of each stage's code.

#pragma once

#include "network.cuh"

namespace {

// Elements a thread of Wide holds (E), the most far stages a merge phase
// runs between lanes, and the most threads of a chunk_wide_kernel block.
// `WIDE_ELEMS` and `WIDE_MAX_THREADS` in ops/bitonic_kernels.py.
constexpr int kWideElems = 16;
constexpr int kWideShuffles = 3;
constexpr int kWideMaxThreads = 256;

// Threads of a Wide block on 2^lc elements: kWideElems elements a thread,
// at least one warp. Must match `block_geometry` in ops/bitonic_kernels.py.
__host__ __device__ constexpr int wide_threads(int lc) {
  return (1 << lc) / kWideElems < 32 ? 32 : (1 << lc) / kWideElems;
}

// Whether K1 of a three-word carry at C = 2^lc is this file's: in W3
// always (the merge sort), in W4_BIG where a block has at most
// kWideMaxThreads threads, so that each may hold 255 registers.
__host__ __device__ constexpr bool wide_chunk(int ride, int lc) {
  return ride == 0 || wide_threads(lc) <= kWideMaxThreads;
}

// The shared-memory slot of tile element i (linear over XOR: the slot of
// a ^ b is the XOR of theirs).
__host__ __device__ constexpr int swizzle(int i) { return i ^ ((i >> 5) & 31); }

// A 16-byte copy from global to shared memory that the thread does not
// wait for (cp.async, past L1); the commit that closes a group of them;
// and the wait for every group but the last committed one.
__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Word offset of 16-byte chunk c of a staged tile: eight chunks a 128-byte
// row, the chunk's place in its row XORed with the row's low three bits,
// so that the eight threads of a quarter warp, each reading a 16-byte
// chunk of its own row, reach 32 banks.
__host__ __device__ constexpr int chunk_slot(int c) {
  return ((c & ~7) | ((c ^ (c >> 3)) & 7)) * 4;
}

// All ones if (ak, at, au) < (bk, bt, bu) as one 96-bit number, else 0:
// the borrow of the subtraction, four integer operations. The predicated
// form (a 64-bit compare, then the third word on a tie) took 10-13 compare
// and predicate instructions a compare-exchange (SASS of the parent's
// chunk_kernel<3, 1, 12>: 1835 ISETP and 603 PLOP3 for 1404 SEL).
__device__ __forceinline__ uint32_t less3(uint32_t ak, uint32_t at,
                                          uint32_t au, uint32_t bk,
                                          uint32_t bt, uint32_t bu) {
  uint32_t m;
  asm("{\n\t.reg .u32 d;\n\t"
      "sub.cc.u32 d, %1, %2;\n\t"
      "subc.cc.u32 d, %3, %4;\n\t"
      "subc.cc.u32 d, %5, %6;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(m)
      : "r"(au), "r"(bu), "r"(at), "r"(bt), "r"(ak), "r"(bk));
  return m;
}

// y where the mask is set, else x: one bitwise select.
__device__ __forceinline__ uint32_t pick(uint32_t x, uint32_t y, uint32_t m) {
  return (y & m) | (x & ~m);
}

// Ascending compare-exchange of registers a and b of a three-word carry:
// the smaller tuple to a; ties never swap.
template <int RIDE, int E>
__device__ __forceinline__ void ce3(Elems<3, RIDE, E>& x, int a, int b) {
  const uint32_t m = less3(x.k[b], x.t[b], x.u[b], x.k[a], x.t[a], x.u[a]);
  const uint32_t ka = x.k[a], ta = x.t[a], ua = x.u[a];
  x.k[a] = pick(ka, x.k[b], m);
  x.k[b] = pick(x.k[b], ka, m);
  x.t[a] = pick(ta, x.t[b], m);
  x.t[b] = pick(x.t[b], ta, m);
  x.u[a] = pick(ua, x.u[b], m);
  x.u[b] = pick(x.u[b], ua, m);
  if constexpr (RIDE != 0) {
    const uint32_t va = x.v[a];
    x.v[a] = pick(va, x.v[b], m);
    x.v[b] = pick(x.v[b], va, m);
  }
}

// The layouts of a tile of 2^lc elements, E = 2^l a thread. Index bit of
// thread bit b in layout rlo:
__host__ __device__ constexpr int wide_index_bit(int l, int rlo, int b) {
  return b < rlo ? b : b + l;
}

// A warp's lanes reach 32 banks in layout rlo: no nonzero combination of
// its lane bits maps to bank 0 (the bank of slot swizzle(i) is
// (i ^ (i >> 5)) & 31).
__host__ __device__ constexpr bool wide_conflict_free(int l, int rlo) {
  for (int m = 1; m < 32; ++m) {
    int x = 0;
    for (int b = 0; b < 5; ++b) {
      const int i = 1 << wide_index_bit(l, rlo, b);
      if (m >> b & 1) x ^= (i ^ (i >> 5)) & 31;
    }
    if (x == 0) return false;
  }
  return true;
}

// The layout of phase stages jtop and down: the lowest register bit that
// keeps jtop in registers and is conflict-free, or -1.
__host__ __device__ constexpr int wide_rlo_for(int l, int lc, int jtop) {
  for (int r = jtop - l + 1 < 0 ? 0 : jtop - l + 1; r <= jtop && r + l <= lc;
       ++r)
    if (wide_conflict_free(l, r)) return r;
  return -1;
}

// Whether stages jtop..l leave R0: always past the lanes (j >= l + 5), and
// where there are more than kWideShuffles of them and a layout admits them.
__host__ __device__ constexpr bool wide_transposes(int l, int lc, int jtop) {
  return jtop >= l &&
         (jtop >= l + 5 ||
          (jtop - l + 1 > kWideShuffles && wide_rlo_for(l, lc, jtop) >= 0));
}

// The plan of a tile's phases, one bit (or four) for each stage j < lc:
// the stages that leave R0 through a transpose, and the layout they take.
__host__ __device__ constexpr uint32_t wide_transposing(int l, int lc) {
  uint32_t m = 0;
  for (int j = 0; j < lc; ++j)
    if (wide_transposes(l, lc, j)) m |= 1u << j;
  return m;
}

__host__ __device__ constexpr uint64_t wide_layouts(int l, int lc) {
  uint64_t m = 0;
  for (int j = 0; j < lc; ++j)
    if (wide_transposes(l, lc, j))
      m |= uint64_t(wide_rlo_for(l, lc, j)) << (4 * j);
  return m;
}

// The network in registers, E = kWideElems elements a thread:
//
//   layout RLO: register e of thread t holds the element whose index has
//   bits [RLO, RLO + L) = e (L = log2 E) and the thread's bits, low to
//   high, in the others. R0 (RLO = 0) is the layout of the loads, the
//   stores and the near stages (j < L). A merge phase whose far stages
//   (j >= L) number more than kWideShuffles moves to the layout whose
//   registers hold its top stage and the L - 1 below it (one
//   shared-memory write, a barrier, one read), runs them between
//   registers, and moves back; a phase with fewer far stages runs them
//   between lanes. At C = 2^12: 64 register stages, 14 lane stages and 12
//   transposes, where Regs runs 39, 39 and 8.
//
// Shared memory holds a tile in the XOR swizzle slot(i) = i ^ ((i >> 5) &
// 31): in every layout taken a warp's 32 lanes write and read one register
// in 32 banks (checked at compile time, wide_conflict_free), with no
// padding. A descending element holds its compared words negated, as in
// Regs, so every stage sorts ascending; the compare-exchange sequence is
// Regs's, pair for pair: only where each stage runs changes.
template <int WORDS, int RIDE, int LC>
struct Wide : Elems<WORDS, RIDE, (1 << LC) / wide_threads(LC)> {
  using Base = Elems<WORDS, RIDE, (1 << LC) / wide_threads(LC)>;
  using Base::k;
  using Base::t;
  using Base::u;
  using Base::v;
  using Base::negate;
  using Base::negate_all;
  static constexpr int kThreads = wide_threads(LC);
  static constexpr int E = (1 << LC) / kThreads;  // elements per thread
  static constexpr int L = log2_of(E);
  static constexpr int N = 1 << LC;
  static_assert(WORDS == 3 && E >= 8 && L < 8 && LC <= 16,
                "the three-word carries, phases from 9 on merge phases, "
                "four bits a stage in kLayouts");

  static constexpr size_t kSmemBytes =
      wide_transposing(L, LC) != 0 ? size_t(N) * 4 * (WORDS + RIDE) : 0;

  uint32_t par;  // the parity of the tile's unit (chunk or group)

  // The tile's unit; the thread's first element in it.
  __device__ __forceinline__ uint64_t begin(long long unit) {
    par = uint32_t(unit) & 1;
    return (uint64_t(unit) << LC) + threadIdx.x * E;
  }

  // 0 or ~0: the direction of the thread's elements (in R0) while runs of
  // 2^p are built, p >= L (bit p of the index; p = LC the unit's parity).
  __device__ __forceinline__ uint32_t dir_mask(int p) const {
    return 0u - (((threadIdx.x * E) | (par << LC)) >> p & 1);
  }

  __device__ __forceinline__ void load(const Bufs<WORDS, RIDE>& g,
                                       uint64_t base) {
    const uint4* pk = reinterpret_cast<const uint4*>(g.k + base);
    const uint4* pt = reinterpret_cast<const uint4*>(g.t + base);
    const uint4* pu = reinterpret_cast<const uint4*>(g.u + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      unpack(k, q, pk[q]);
      unpack(t, q, pt[q]);
      unpack(u, q, pu[q]);
    }
    if constexpr (RIDE != 0) {
      const uint4* pv = reinterpret_cast<const uint4*>(g.v + base);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) unpack(v, q, pv[q]);
    }
  }

  // The compared words of the thread's elements (R0) from a tile staged
  // at s in chunk_slot order, with 16-byte reads.
  __device__ __forceinline__ void load_staged(const uint32_t* s) {
    const int c0 = threadIdx.x * (E / 4);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int o = chunk_slot(c0 + q);
      unpack(k, q, *reinterpret_cast<const uint4*>(s + o));
      unpack(t, q, *reinterpret_cast<const uint4*>(s + N + o));
      unpack(u, q, *reinterpret_cast<const uint4*>(s + 2 * N + o));
    }
  }

  __device__ __forceinline__ void store(const Bufs<WORDS, RIDE>& g,
                                        uint64_t base) const {
    uint4* pk = reinterpret_cast<uint4*>(g.k + base);
    uint4* pt = reinterpret_cast<uint4*>(g.t + base);
    uint4* pu = reinterpret_cast<uint4*>(g.u + base);
    uint4* pv = reinterpret_cast<uint4*>(g.v + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      pk[q] = pack(k, q);
      pt[q] = pack(t, q);
      pu[q] = pack(u, q);
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

  // The stage between lanes l and l ^ m (R0): the lower lane keeps the
  // smaller tuple of each pair, the upper lane the larger; equal tuples
  // stay where they are.
  __device__ __forceinline__ void shfl_stage(int m) {
    const uint32_t up = 0u - uint32_t((threadIdx.x & m) != 0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t yk = __shfl_xor_sync(0xFFFFFFFFu, k[e], m);
      const uint32_t yt = __shfl_xor_sync(0xFFFFFFFFu, t[e], m);
      const uint32_t yu = __shfl_xor_sync(0xFFFFFFFFu, u[e], m);
      uint32_t yv = 0;
      if constexpr (RIDE != 0) yv = __shfl_xor_sync(0xFFFFFFFFu, v[e], m);
      const uint32_t lt = less3(yk, yt, yu, k[e], t[e], u[e]);
      const uint32_t gt = less3(k[e], t[e], u[e], yk, yt, yu);
      const uint32_t take = pick(lt, gt, up);
      k[e] = pick(k[e], yk, take);
      t[e] = pick(t[e], yt, take);
      u[e] = pick(u[e], yu, take);
      if constexpr (RIDE != 0) v[e] = pick(v[e], yv, take);
    }
  }

  // The plan of a phase's stages, as integers the loop of `phases` reads
  // at run time: wide_transposing and wide_layouts.
  static constexpr uint32_t kTransposing = wide_transposing(L, LC);
  static constexpr uint64_t kLayouts = wide_layouts(L, LC);

  __device__ __forceinline__ void stage(int jr) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (!(e & (1 << jr))) ce3(*this, e, e | (1 << jr));
  }

  // The stage at register bit jr < L, known at run time: one copy of each
  // stage's unrolled code, reached through a switch, so that the kernel's
  // code stays small enough for the instruction cache.
  __device__ __forceinline__ void reg_stage_at(int jr) {
    switch (jr) {
#define VRS_JR(j)                          \
  case j:                                  \
    if constexpr (j < L) stage(j);         \
    break;
      VRS_JR(0) VRS_JR(1) VRS_JR(2) VRS_JR(3) VRS_JR(4) VRS_JR(5)
#undef VRS_JR
      default:
        break;
    }
  }

  // Registers to or from their slots in layout rlo: the compared words'
  // tiles one after another at s, the riding one at sv.
  __device__ __forceinline__ int slot0(int rlo) const {
    const int x = threadIdx.x;
    return swizzle((x & ((1 << rlo) - 1)) | ((x >> rlo) << (rlo + L)));
  }

  __device__ __forceinline__ void to_smem(uint32_t* s, uint32_t* sv,
                                          int rlo) const {
    const int b = slot0(rlo);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = b ^ swizzle(e << rlo);
      s[i] = k[e];
      s[N + i] = t[e];
      s[2 * N + i] = u[e];
      if constexpr (RIDE != 0) sv[i] = v[e];
    }
  }

  __device__ __forceinline__ void from_smem(const uint32_t* s,
                                            const uint32_t* sv, int rlo) {
    const int b = slot0(rlo);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = b ^ swizzle(e << rlo);
      k[e] = s[i];
      t[e] = s[N + i];
      u[e] = s[2 * N + i];
      if constexpr (RIDE != 0) v[e] = sv[i];
    }
  }

  // Phases p0..LC of the chunk network, in R0 at entry and exit, the
  // elements negated as phase p0 - 1 leaves them. Phase pk sets each
  // element's direction (bit pk of its index; bit p < L of the index is
  // bit p of the register number, bit L the thread's lowest bit), then
  // runs stages pk-1..0: registers below L; lanes where the phase's far
  // stages are few; else a transpose to the layout of the stage and the
  // L - 1 below it, those stages in registers, and a transpose back. Each
  // excursion costs two barriers; a thread rewrites only the slots it
  // read, so none is needed before a write. Loops, not unrolled phases:
  // one copy of each stage's code.
  __device__ __forceinline__ void phases(int p0, uint32_t* s, uint32_t* sv) {
    constexpr uint32_t kT = kTransposing;
    constexpr uint64_t kR = kLayouts;
#pragma unroll 1
    for (int pk = p0; pk <= LC; ++pk) {
      if (pk <= L) {
        const uint32_t now_l = pk == L ? dir_mask(L) : 0u;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const uint32_t was = pk == 1 ? 0u : (e >> (pk - 1)) & 1;
          const uint32_t now = pk == L ? 0u : (e >> pk) & 1;
          negate(e, (0u - (was ^ now)) ^ now_l);
        }
      } else {
        negate_all(dir_mask(pk - 1) ^ dir_mask(pk));
      }
      int j = pk - 1;
#pragma unroll 1
      while (j >= 0) {
        if (j < L) {
          reg_stage_at(j--);
        } else if (!(kT >> j & 1)) {
          shfl_stage(1 << (j - L));
          --j;
        } else {
          const int rlo = int(kR >> (4 * j) & 15);
          to_smem(s, sv, 0);
          __syncthreads();
          from_smem(s, sv, rlo);
#pragma unroll 1
          for (; j >= rlo; --j) reg_stage_at(j - rlo);
          to_smem(s, sv, rlo);
          __syncthreads();
          from_smem(s, sv, 0);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// K1 in W3 as a merge sort (chunk_merge_kernel). W3 compares all three
// words, so equal tuples are identical and any exact sort of a chunk in
// its direction is bitwise the network's output; W4_BIG (a riding value
// under tied tuples) keeps the network. A thread sorts its E registers
// (a bitonic network, ascending), then each of log2(C / E) merge levels
// writes the runs to shared memory and every thread takes E outputs of
// its pair of runs: a binary search for its start on the merge path, then
// E steps of a two-way merge, A first on ties. An odd chunk holds its
// words negated throughout: it is sorted with the descending comparator,
// as the network sorts it. O(log C) passes over the chunk, not O(log^2 C)
// stages.

constexpr int kMergeElems = 16;  // elements a thread where C allows

__host__ __device__ constexpr int merge_threads(int lc) {
  return (1 << lc) / kMergeElems < 32 ? 32 : (1 << lc) / kMergeElems;
}

// Slot of tile element i: one word of padding in 32, so that the threads
// of a warp writing E consecutive elements each reach 32 banks.
__host__ __device__ constexpr int merge_pad(int i) { return i + (i >> 5); }

template <int LC>
struct Merge3 : Elems<3, 0, (1 << LC) / merge_threads(LC)> {
  using Base = Elems<3, 0, (1 << LC) / merge_threads(LC)>;
  using Base::k;
  using Base::t;
  using Base::u;
  using Base::negate_all;
  static constexpr int kThreads = merge_threads(LC);
  static constexpr int E = (1 << LC) / kThreads;
  static constexpr int L = log2_of(E);
  static constexpr int N = 1 << LC;
  static constexpr int P = merge_pad(N);  // words an array's tile takes
  static constexpr size_t kSmemBytes = size_t(P) * 4 * 3;

  static __device__ __forceinline__ bool less(uint32_t ak, uint32_t at,
                                              uint32_t au, uint32_t bk,
                                              uint32_t bt, uint32_t bu) {
    return less3(ak, at, au, bk, bt, bu) != 0;
  }

  __device__ __forceinline__ void load(const Bufs<3, 0>& g, uint64_t base) {
    const uint4* pk = reinterpret_cast<const uint4*>(g.k + base);
    const uint4* pt = reinterpret_cast<const uint4*>(g.t + base);
    const uint4* pu = reinterpret_cast<const uint4*>(g.u + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint4 a = pk[q], b = pt[q], c = pu[q];
      k[4 * q] = a.x, k[4 * q + 1] = a.y, k[4 * q + 2] = a.z, k[4 * q + 3] = a.w;
      t[4 * q] = b.x, t[4 * q + 1] = b.y, t[4 * q + 2] = b.z, t[4 * q + 3] = b.w;
      u[4 * q] = c.x, u[4 * q + 1] = c.y, u[4 * q + 2] = c.z, u[4 * q + 3] = c.w;
    }
  }

  __device__ __forceinline__ void store(const Bufs<3, 0>& g,
                                        uint64_t base) const {
    uint4* pk = reinterpret_cast<uint4*>(g.k + base);
    uint4* pt = reinterpret_cast<uint4*>(g.t + base);
    uint4* pu = reinterpret_cast<uint4*>(g.u + base);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      pk[q] = make_uint4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
      pt[q] = make_uint4(t[4 * q], t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);
      pu[q] = make_uint4(u[4 * q], u[4 * q + 1], u[4 * q + 2], u[4 * q + 3]);
    }
  }

  // The thread's E registers ascending: a bitonic network whose runs
  // alternate in direction until the last phase.
  __device__ __forceinline__ void sort_regs() {
#pragma unroll
    for (int pk = 1; pk <= L; ++pk)
#pragma unroll
      for (int j = pk - 1; j >= 0; --j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (!(e & (1 << j))) {
            if (pk < L && (e >> pk & 1))
              ce3(*this, e | (1 << j), e);
            else
              ce3(*this, e, e | (1 << j));
          }
  }

  // The thread's elements, consecutive from threadIdx.x * E, to the tile.
  __device__ __forceinline__ void to_smem(uint32_t* s) const {
    const int b = merge_pad(threadIdx.x * E);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s[b + e] = k[e];
      s[P + b + e] = t[e];
      s[2 * P + b + e] = u[e];
    }
  }

  // Outputs threadIdx.x * E .. + E - 1 of the merge of the tile's sorted
  // runs of S elements, two by two.
  __device__ __forceinline__ void merge_level(const uint32_t* s, int S) {
    const int me = threadIdx.x * E;
    const int a0 = me & ~(2 * S - 1), b0 = a0 + S;  // the pair's runs
    const int d = me - a0;  // outputs of the pair before the thread's
    const auto at = [&](int i, uint32_t& xk, uint32_t& xt, uint32_t& xu) {
      const int q = merge_pad(i);
      xk = s[q];
      xt = s[P + q];
      xu = s[2 * P + q];
    };
    // i elements of A and d - i of B come first: the least i whose A[i]
    // follows B[d - 1 - i] (B only if strictly less)
    int lo = d > S ? d - S : 0, hi = d < S ? d : S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      uint32_t ak, at_, au, bk, bt, bu;
      at(a0 + mid, ak, at_, au);
      at(b0 + d - 1 - mid, bk, bt, bu);
      if (less(bk, bt, bu, ak, at_, au))
        hi = mid;
      else
        lo = mid + 1;
    }
    int ia = a0 + lo, ib = b0 + d - lo;
    const int ea = a0 + S, eb = b0 + S;
    uint32_t xk, xt, xu, yk, yt, yu;  // the heads of A and B
    at(ia < ea ? ia : ea - 1, xk, xt, xu);
    at(ib < eb ? ib : eb - 1, yk, yt, yu);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool take_b = ib < eb && (ia >= ea || less(yk, yt, yu, xk, xt, xu));
      k[e] = take_b ? yk : xk;
      t[e] = take_b ? yt : xt;
      u[e] = take_b ? yu : xu;
      ia += !take_b;
      ib += take_b;
      uint32_t nk, nt, nu;
      at(take_b ? (ib < eb ? ib : eb - 1) : (ia < ea ? ia : ea - 1), nk, nt,
         nu);
      xk = take_b ? xk : nk;
      xt = take_b ? xt : nt;
      xu = take_b ? xu : nu;
      yk = take_b ? nk : yk;
      yt = take_b ? nt : yt;
      yu = take_b ? nu : yu;
    }
  }
};

template <int LC>
__global__ void __launch_bounds__(merge_threads(LC))
    chunk_merge_kernel(Bufs<3, 0> g, const int* valid) {
  if (valid != nullptr && valid[blockIdx.x] == 0) return;
  extern __shared__ uint32_t smem[];
  using M = Merge3<LC>;
  M x;
  const uint64_t base = (uint64_t(blockIdx.x) << LC) + threadIdx.x * M::E;
  x.load(g, base);
  const uint32_t desc = 0u - (blockIdx.x & 1);
  x.negate_all(desc);
  x.sort_regs();
  for (int S = M::E; S < M::N; S *= 2) {
    x.to_smem(smem);
    __syncthreads();
    x.merge_level(smem, S);
    __syncthreads();
  }
  x.negate_all(desc);
  x.store(g, base);
}

// K1 in W4_BIG: full bitonic sort of one 2^LC-element chunk per block,
// even chunks ascending, odd ones descending.
template <int WORDS, int RIDE, int LC>
__global__ void __launch_bounds__(wide_threads(LC))
    chunk_wide_kernel(Bufs<WORDS, RIDE> g, const int* valid) {
  if (valid != nullptr && valid[blockIdx.x] == 0) return;
  extern __shared__ uint32_t smem[];
  using R = Wide<WORDS, RIDE, LC>;
  R x;
  x.load(g, x.begin(blockIdx.x));
  x.phases(1, smem, smem + 3 * R::N);
  x.negate_all(x.dir_mask(LC));
  x.store(g, x.begin(blockIdx.x));
}

// K2 in W3: merge rounds r_lo.. on each of the first `ngroups` groups of
// 2^LG elements, as fused_kernel (fused.cuh): phases lc + r_lo .. LG.
// Persistent blocks (as many as the card holds at once) walk the groups,
// and each stages its next group in shared memory (cp.async) while it
// sorts the current one, so that HBM reads overlap the stages: two tiles
// of the group (192 KB at 2^13), the current one also the transposes'. A
// group whose `valid` flag is 0 is skipped whole.
template <int WORDS, int RIDE, int LG>
__global__ void __launch_bounds__(wide_threads(LG), 1)
    fused_wide_kernel(Bufs<WORDS, RIDE> g, long long ngroups, int lc,
                      int r_lo, const int* valid) {
  static_assert(RIDE == 0, "W3 only");
  extern __shared__ uint32_t smem[];
  using R = Wide<WORDS, RIDE, LG>;
  constexpr int N = R::N;
  const auto next = [&](long long gi) {
    while (gi < ngroups && valid != nullptr && valid[gi] == 0)
      gi += gridDim.x;
    return gi;
  };
  const auto stage = [&](long long gi, uint32_t* s) {
    const uint64_t base = uint64_t(gi) << LG;
    for (int c = threadIdx.x; c < N / 4; c += R::kThreads) {
      const int o = chunk_slot(c);
      cp_async16(s + o, g.k + base + 4 * c);
      cp_async16(s + N + o, g.t + base + 4 * c);
      cp_async16(s + 2 * N + o, g.u + base + 4 * c);
    }
  };
  long long gi = next(blockIdx.x);
  if (gi < ngroups) stage(gi, smem);
  cp_async_commit();
  for (int cur = 0; gi < ngroups; cur ^= 1) {
    const long long gn = next(gi + gridDim.x);
    uint32_t* const s = smem + cur * WORDS * N;
    __syncthreads();  // the last group is done with the other tile
    if (gn < ngroups) stage(gn, smem + (cur ^ 1) * WORDS * N);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // every thread's copies of this group have landed
    R x;
    const uint64_t base = x.begin(gi);
    x.load_staged(s);
    __syncthreads();  // the tile is read before the transposes reuse it
    const int p0 = lc + r_lo;
    x.negate_all(x.dir_mask(p0 - 1));  // as phase p0 - 1 would leave them
    x.phases(p0, s, nullptr);
    x.negate_all(x.dir_mask(LG));
    x.store(g, base);
    gi = gn;
  }
}

// K1 at C = 2^LC in W3 (the merge sort) or W4_BIG (the network).
template <int W, int R, int LC>
int launch_chunk_wide(const Bufs<W, R>& g, long long nunits,
                      const int* valid, cudaStream_t st) {
  if constexpr (R == 0) {
    using M = Merge3<LC>;
    const cudaError_t e = allow_smem(chunk_merge_kernel<LC>, M::kSmemBytes);
    if (e != cudaSuccess) return int(e);
    chunk_merge_kernel<LC>
        <<<unsigned(nunits), M::kThreads, M::kSmemBytes, st>>>(g, valid);
  } else {
    using Wd = Wide<W, R, LC>;
    const cudaError_t e = allow_smem(chunk_wide_kernel<W, R, LC>,
                                     Wd::kSmemBytes);
    if (e != cudaSuccess) return int(e);
    chunk_wide_kernel<W, R, LC>
        <<<unsigned(nunits), Wd::kThreads, Wd::kSmemBytes, st>>>(g, valid);
  }
  return int(cudaGetLastError());
}

// K2 in W3 on groups of 2^LG elements: one block for each block the card
// holds at once (found on the first launch), at most one a group.
template <int W, int R, int LG>
int launch_fused_wide(const Bufs<W, R>& g, long long ngroups, int lc,
                      int r_lo, const int* valid, cudaStream_t st) {
  constexpr int kThreads = wide_threads(LG);
  constexpr size_t smem = size_t(2 * W) << (LG + 2);
  const auto kernel = fused_wide_kernel<W, R, LG>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kernel, kThreads, smem)) != cudaSuccess)
      return int(e);
    if (per < 1) return int(cudaErrorInvalidConfiguration);
    blocks = sms * per;
  }
  const long long grid = ngroups < blocks ? ngroups : blocks;
  kernel<<<unsigned(grid), kThreads, smem, st>>>(g, ngroups, lc, r_lo,
                                                 valid);
  return int(cudaGetLastError());
}

}  // namespace
