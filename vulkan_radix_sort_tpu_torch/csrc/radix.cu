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
// (src/shader/{upsweep,spine,downsweep}.slang). The first pass's K7 reads
// the caller's keys and values where they lie, of any length and
// alignment: keys at or past the count (read on the card) or past n load as
// 0xFFFFFFFF and values past n as 0, as upstream's upsweep reads them
// (upsweep.slang:32), so no pad is copied. A count= sort adds one launch
// after the passes, restore_tail_kernel (the masked tail's keys back in
// place). A sort of 64-bit keys, or of 32-bit keys by a number of low bits
// that is no multiple of the digit (CUB's end_bit), runs the kv carries on
// (masked
// word, position) pairs instead: split_pad_kernel writes the low words,
// the positions, (key, value) records and the high words, gather_kernel
// fetches each sorted position's high word for the high-word passes and,
// last, the whole keys and values. K7 sorts
// each `block`-key block stably by the digit (key >> shift) & (radix - 1)
// and writes the block's radix-bin histogram. The spine turns the
// (nblocks, radix) histograms into the global exclusive digit offsets g
// and each (block, digit) run's output offset, offsets[p][d] = g[d] + the
// sum of hist[q][d] over q < p: the reference spine's two halves. K8 then
// copies element i of block p, of digit d, to offsets[p][d] + i - (start
// of d's run in the block).
//
// What changed from the TPU: there, ranks came from one-hot matmuls on the
// MXU (no atomics, no ballots), and placement walked the blocks in order on
// one core with per-bucket append streams, accumulating each digit's
// position as it went. Hopper blocks run in parallel and in no order, so
// the spine gives each block its own base per digit, and ranks come from
// warp match masks.
//
// Stability is the whole LSD contract, so no rank comes from a counter
// that several warps advance, in an order that changes from run to run.
// K7 ranks as CUB's onesweep does (BlockRadixRankMatchEarlyCounts,
// WARP_MATCH_ATOMIC_OR). Warp w of a block owns a contiguous segment of
// 32·KPT keys, slot e of lane l being key 32e + l of the segment, so
// (slot, lane) is input order. Per slot, each lane ORs its bit into a
// shared word of its digit (one word per digit for the warp) and reads it
// back: the lanes of its digit, whatever the order of the ORs. The highest
// of them adds the group's size to the warp's count of the digit (one
// entry of a (digit, warp) table that only this warp touches, slot after
// slot) with one atomic add that returns the count before it, and a
// shuffle hands it on: a key's rank in the warp is that count plus its
// peers in lower lanes. A slot whose 32 keys share one digit skips the
// words (the ORs on one word queue). One block-wide exclusive scan of the
// table in digit-major order then gives each (digit, warp) run its start
// in the sorted block, and the block's histogram.
//
// What bounds them on an H100: K7 and K8 move every key (and value) once
// in and once out of HBM and do a few integer operations per key, so both
// are bound by bytes. K7's thread blocks stay resident, one an SM at the
// default block (as many as fit), and walk the blocks; the bulk copy
// engine (TMA) loads the keys of the next two blocks (one for key-value)
// into spare shared-memory buffers while a block is ranked and stores the
// sorted block from shared memory while the next is, so that HBM moves
// while the SM ranks. The earlier design, one 16-warp block an SM that
// loaded, ranked with 8 ballots a slot, scanned, scattered and stored in
// turn, reached 35% of the byte bound for keys; the measurement that chose
// this one is in PERF.md, section 6 (one NVIDIA H100 80GB HBM3, 700 W,
// `utils/block_sort_probe.py`). What holds K7 back now is shared memory:
// the match words, the count adds and the scatter each meet the bank
// conflicts of 32 random digits a slot. K8 takes each
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
// and its time grows with the rows (0.3 ms at 65536). No decoupled
// look-back yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // most threads of a K7 block: RADIX_THREADS
constexpr int kVecKeys = 4;    // fewest keys a K7 thread holds: 16 bytes
constexpr int kLoadBatch = 8;  // K7's first pass: word loads in flight
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
constexpr int kCopyThreads = 256;    // the copy-like kernels below
constexpr int kCopyBlocksPerSm = 8;  // 2048 threads: a full SM
constexpr int kCopyVecs = 2;         // loads a thread has in flight

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

// Threads of a K7 block: one per 4 keys (16 bytes) up to kThreads, so 4
// to 32 keys a thread. Must match `sort_geometry` in ops/block_sort.py.
__host__ __device__ constexpr int sort_threads(int block) {
  return block / kVecKeys < kThreads ? block / kVecKeys : kThreads;
}

// Row stride of the (digit, warp) count table: one word more than the
// warps, an odd number, so a warp's entries for 32 different digits lie
// in 32 different banks (at a stride of 16 they shared two).
__host__ __device__ constexpr int table_stride(int warps) { return warps + 1; }

// Key buffers of a K7 block: the block it sorts and the next two (keys) or
// the next one (key-value, whose values take the third buffer's room).
// Must match `sort_stages` in ops/block_sort.py.
__host__ __device__ constexpr int sort_stages(bool kv) { return kv ? 2 : 3; }

// The key buffers, one of values, the (digit, warp) count table, 32 ints
// of scan scratch, the warps' match words (one per digit) and a load
// barrier per key buffer (8 words). Must match `sort_smem` in
// ops/block_sort.py.
constexpr size_t sort_smem(int block, int bits, bool kv) {
  return size_t(4) *
         (size_t(block) * (sort_stages(kv) + (kv ? 1 : 0)) +
          (size_t(1) << bits) * (table_stride(sort_threads(block) / 32) +
                                 sort_threads(block) / 32) +
          32 + 8);
}

// Thread blocks of a K7 launch: as many as the card holds at once (`sms`
// multiprocessors, `resident` blocks each), and no more than there are
// blocks to sort. Must match `sort_grid` in ops/block_sort.py.
__host__ __device__ constexpr long long sort_grid(long long nblocks, int sms,
                                                  int resident) {
  return nblocks < (long long)sms * (resident > 1 ? resident : 1)
             ? nblocks
             : (long long)sms * (resident > 1 ? resident : 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that one arrival (with its transaction bytes) completes.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The bulk copy engine (TMA) copies `bytes` at src (global) to dst
// (shared) in the background and completes the transaction on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t* dst, const uint32_t* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the phase of `bar` of the given parity to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The bulk copy engine writes `bytes` of shared memory at src to global
// memory at dst in the background, as part of this thread's open group,
// with the lines marked to leave L2 last: K8 reads them next, and without
// the mark it ran 1.5-2.7% slower after this kernel than after the one
// before it (PERF.md, section 6).
__device__ __forceinline__ void bulk_store(uint32_t* dst, const uint32_t* src,
                                           int bytes) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the bulk copies.
__device__ __forceinline__ void fence_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// The live prefix of a count= sort: the count, read on the card, clamped
// to [0, n] (the `arange(n) < count` of the plain version).
__device__ __forceinline__ long long live_count(const long long* count,
                                                long long n) {
  const long long c = *count;
  return c < 0 ? 0 : c > n ? n : c;
}

// Rank of each of a thread's KPT keys, key(e) for slot e, among its
// warp's keys of the same digit, in input order: the warp's count of the
// digit so far (col[d * ts], an entry of the (digit, warp) table that no
// other warp touches) plus the key's peers in lower lanes. The peers come
// from `match`, one word per digit for the warp: each lane ORs its bit into
// its digit's word and reads the word back (OR commutes, so the order of
// the ORs does not matter). Lanes of one digit meet on one word and their
// ORs queue, so a slot whose 32 keys share one digit (the top digits of
// small keys) skips the words: every lane is a peer. That test (a shuffle
// and a vote) runs only after a slot that was one group, or first, so
// that mixed digits do not pay for it; a run of one digit that starts
// later pays the queued ORs once, then takes the test. The highest peer
// advances the count by the group's size with one atomic add, which
// returns the count before it, and clears the word; a shuffle hands the
// count to the group. A warp barrier closes each slot, so each count
// advances slot by slot in input order on every run (the rank of CUB's
// onesweep, WARP_MATCH_ATOMIC_OR). Ranks are < 32 KPT: two a register.
template <int BITS, int KPT, class Key>
__device__ __forceinline__ void rank_keys(Key key, uint32_t (&rank2)[KPT / 2],
                                          int* col, int ts, unsigned* match,
                                          int shift, int lane) {
  constexpr uint32_t kMask = (1u << BITS) - 1;
  const unsigned lower = (1u << lane) - 1u;
  volatile unsigned* vm = match;
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const uint32_t d = (key(e) >> shift) & kMask;
    const bool one = peers == 0xffffffffu &&
                     __all_sync(0xffffffffu,
                                d == __shfl_sync(0xffffffffu, d, 0));
    peers = 0xffffffffu;
    if (!one) {
      atomicOr(match + d, 1u << lane);
      __syncwarp();
      peers = vm[d];
    }
    const int top = 31 - __clz(peers);
    int prior = 0;
    if (lane == top) prior = atomicAdd(col + d * ts, __popc(peers));
    prior = __shfl_sync(0xffffffffu, prior, top);  // every lane read vm[d]
    if (lane == top && !one) vm[d] = 0;
    __syncwarp();
    const uint32_t r = uint32_t(prior + __popc(peers & lower));
    rank2[e / 2] = e & 1 ? rank2[e / 2] | r << 16 : r;
  }
}

// K7: thread blocks that stay resident (no more than the card holds at
// once, `sort_grid`) walk the `block`-key blocks p = blockIdx.x,
// blockIdx.x + gridDim.x, ... < nblocks, blockDim.x * KPT keys each.
// Writes block p stably sorted by the digit at `shift` to out_k (and the
// values, moved alike, to out_v), and its histogram to hist[p][0, 2^BITS).
// The bulk copy engine brings the keys of the next blocks into spare
// buffers while block p is ranked, and writes block p out of shared memory
// while the next one is; block p's values come into registers by loads
// issued before its rank. The key-value kernel ranks from the keys in
// shared memory and takes them into registers only for the scatter, so
// that keys, values and ranks (96 words a thread at 32 keys) are never all
// held through the rank: at 128 registers a thread they spilled.
//
// FIRST (a sort's first pass) reads the caller's n keys (and values) in
// place for the nblocks * block slots of the pass: key i < c as it is and
// 0xFFFFFFFF from c on, c the live count (`count` read on the card, or n
// if null), value i < n as it is and 0 from n on, the buffers the plain
// version pads (`mask_pad_plain`). A block wholly below c is bulk-loaded
// as in any pass if the keys are 16-byte aligned; the rest (the block
// across c, those past it, every block of an unaligned view) are loaded a
// word a thread, so no key at or past c is read. Without FIRST, count and
// n are not read.
template <bool KV, int KPT, int BITS, bool FIRST>
__global__ void __launch_bounds__(kThreads, KPT > 8 ? 1 : KV ? 2 : 3)
    block_sort_kernel(const uint32_t* __restrict__ keys,
                      const uint32_t* __restrict__ vals,
                      uint32_t* __restrict__ out_k,
                      uint32_t* __restrict__ out_v, int* __restrict__ hist,
                      long long nblocks, int shift,
                      const long long* __restrict__ count, long long n) {
  constexpr int kRadix = 1 << BITS, NS = sort_stages(KV);
  constexpr uint32_t kMask = kRadix - 1;
  extern __shared__ uint4 tile4[];
  const int nthreads = blockDim.x, nw = nthreads >> 5;
  const int ts = table_stride(nw);
  const int block = nthreads * KPT;
  uint32_t* sk = reinterpret_cast<uint32_t*>(tile4);  // [NS][block] keys
  uint32_t* sv = sk + NS * block;                      // [block] values
  int* tab = reinterpret_cast<int*>(sv + (KV ? block : 0));  // [radix][ts]
  int* wsum = tab + kRadix * ts;                             // [32]
  unsigned* match = reinterpret_cast<unsigned*>(wsum + 32);  // [nw][radix]
  uint64_t* bars = reinterpret_cast<uint64_t*>(match + kRadix * nw);  // [NS]
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // slot e of lane l of warp w holds key seg + 32 e of the block, so
  // (slot, lane) is input order
  const int seg = w * 32 * KPT + lane;
  // FIRST: the live keys [0, c), and whether the bulk copy engine may load
  // them (it moves 16-byte aligned blocks)
  const long long c = !FIRST ? 0 : count ? live_count(count, n) : n;
  const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  auto bulk = [&](long long p) {
    return !FIRST || (aligned && (p + 1) * block <= c);
  };

  if (t == 0) {
    for (int b = 0; b < NS; ++b) bar_init(bars + b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < kRadix * ts; i += nthreads) tab[i] = 0;
  for (int i = t; i < kRadix * nw; i += nthreads) match[i] = 0;
  __syncthreads();
  // Block p's keys into key buffer b.
  auto stage = [&](int b, long long p) {
    if (t == 0 && p < nblocks && bulk(p))
      bulk_load(sk + b * block, keys + uint64_t(p) * uint64_t(block),
                4 * block, bars + b);
  };
  for (int b = 0; b < NS - 1; ++b) stage(b, blockIdx.x + b * gridDim.x);

  unsigned parity = 0;  // bit b: the parity of key buffer b's next load
  int buf = 0;          // block p's key buffer
  for (long long p = blockIdx.x; p < nblocks;
       p += gridDim.x, buf = buf + 1 == NS ? 0 : buf + 1) {
    const uint64_t base = uint64_t(p) * uint64_t(block);
    uint32_t* cur = sk + buf * block;
    const bool bulk_p = bulk(p);
    if (!bulk_p) {  // FIRST: a word a thread, kLoadBatch loads in flight,
                    // before the values hold their registers; the
                    // buffer's last store has read it
      constexpr int kB = KPT < kLoadBatch ? KPT : kLoadBatch;
#pragma unroll 1
      for (int e0 = 0; e0 < KPT; e0 += kB) {
        uint32_t wd[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const long long i = (long long)base + t + (e0 + u) * nthreads;
          wd[u] = i < c ? __ldcs(keys + i) : ~0u;
        }
#pragma unroll
        for (int u = 0; u < kB; ++u) cur[t + (e0 + u) * nthreads] = wd[u];
      }
    }
    uint32_t v[KV ? KPT : 1];
    if constexpr (KV) {
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        const uint64_t i = base + seg + 32 * e;
        v[e] = !FIRST || i < uint64_t(n) ? __ldcs(vals + i) : 0u;
      }
    }
    if (bulk_p) {
      bar_wait(bars + buf, parity >> buf & 1u);  // block p's keys are in
      parity ^= 1u << buf;
    }
    __syncthreads();  // and the table is zero again
    uint32_t k[KPT];
    if constexpr (!KV) {
#pragma unroll
      for (int e = 0; e < KPT; ++e) k[e] = cur[seg + 32 * e];
    }

    uint32_t rank2[KPT / 2];
    if constexpr (KV)
      rank_keys<BITS, KPT>([&](int e) { return cur[seg + 32 * e]; }, rank2,
                           tab + w, ts, match + w * kRadix, shift, lane);
    else
      rank_keys<BITS, KPT>([&](int e) { return k[e]; }, rank2, tab + w, ts,
                           match + w * kRadix, shift, lane);
    // Once the bulk stores of the block before have read their buffer (and
    // the values), the keys of block p + (NS - 1) gridDim.x go there.
    if (t == 0) bulk_wait_read();
    __syncthreads();
    stage(buf == 0 ? NS - 1 : buf - 1, p + (NS - 1) * gridDim.x);
    // phase rank ends; probe sink: rank2[0] + rank2[KPT / 2 - 1]; continue

    // tab[d][w] becomes the start of warp w's keys of digit d in the
    // sorted block; digit d's count is the gap to digit d+1's start.
    table_exclusive_scan<BITS>(tab, wsum);
    __syncthreads();
    for (int d = t; d < kRadix; d += nthreads) {
      const int end = d + 1 < kRadix ? tab[(d + 1) * ts] : block;
      hist[uint64_t(p) * kRadix + d] = end - tab[d * ts];
    }
    if constexpr (KV) {
#pragma unroll
      for (int e = 0; e < KPT; ++e) k[e] = cur[seg + 32 * e];
      __syncthreads();  // every key read before the scatter overwrites them
    }
    // phase scan ends; probe sink: tab[t]; continue

    // Keys and values to their sorted slots in one pass (every thread read
    // its keys from `cur` before a barrier above); the table is zeroed for
    // the next block once every thread has read its starts.
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int pos = tab[((k[e] >> shift) & kMask) * ts + w] +
                      int(rank2[e / 2] >> (16 * (e & 1)) & 0xFFFFu);
      cur[pos] = k[e];
      if constexpr (KV) sv[pos] = v[e];
    }
    fence_to_bulk();
    __syncthreads();
    for (int i = t; i < kRadix * ts; i += nthreads) tab[i] = 0;
    // phase scatter ends; probe sink: cur[t]; continue

    // Out by the bulk copy engine while the next block ranks.
    if (t == 0) {
      bulk_store(out_k + base, cur, 4 * block);
      if constexpr (KV) bulk_store(out_v + base, sv, 4 * block);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();  // shared memory lives until the stores read it
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

// After the last pass of a count= sort: x[i] = keys[i] for c <= i < n, in
// place. The stable passes leave the masked tail, 0xFFFFFFFF keys behind
// every genuine one, at [c, n) in input order, so its values are already
// right and only its keys come back. Every thread exits at once when
// c == n.
__global__ void __launch_bounds__(kCopyThreads)
    restore_tail_kernel(const long long* __restrict__ count, long long n,
                        const uint32_t* __restrict__ keys,
                        uint32_t* __restrict__ out) {
  const long long c = live_count(count, n);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = c + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += kCopyVecs * step) {
    uint32_t w[kCopyVecs];
#pragma unroll
    for (int u = 0; u < kCopyVecs; ++u)
      w[u] = i + u * step < n ? __ldcs(keys + i + u * step) : 0u;
#pragma unroll
    for (int u = 0; u < kCopyVecs; ++u)
      if (i + u * step < n) out[i + u * step] = w[u];
  }
}

// Items a thread of split_pad_kernel or gather_kernel has in flight: item
// base + u * blockDim.x for u < kItems, so that each load and store of a
// warp covers 32 consecutive items (a gather's random loads all issued
// before its first store).
constexpr int kItems = 8;

// The first buffers of the (word, position) path, in one pass over the
// keys (and values): lo[i] = (the low word of keys[i]) & mask for i < c
// and 0xFFFFFFFF for c <= i < size, pos[i] = i, c the live count (n
// without a count); with REC, rec[i] = the whole key and its value, for
// the output's gather to read with one random load: (low word, high word,
// value, 0) for 64-bit keys (WIDE), (key, value) for 32-bit ones, zeros
// past n; with hi_bytes 2 or 4 (64-bit keys by an end bit past 32), hi[i]
// = (the high word of keys[i]) & hmask in that many bytes for i < c and
// all ones for c <= i < size, for the high-word gather to read from a
// dense array: 16 bits, which the L2 mostly holds, for an end bit up to
// 48. The stable passes keep every key at or past c behind the live ones,
// in input order, as the first pass's masked tail: the low-word passes
// leave it last, and its all-ones high words tie only with live ones ahead
// of it. Keys past c (past n with REC) are not read.
template <bool WIDE, bool REC>
__global__ void __launch_bounds__(kCopyThreads)
    split_pad_kernel(const long long* __restrict__ count, long long n,
                     long long size, const uint32_t* __restrict__ keys,
                     const uint32_t* __restrict__ vals, uint32_t mask,
                     uint32_t hmask, int hi_bytes, uint32_t* __restrict__ lo,
                     uint32_t* __restrict__ pos, uint32_t* __restrict__ rec,
                     void* __restrict__ hi) {
  const long long c = count ? live_count(count, n) : n;
  const long long end = REC ? n : c;  // the keys read
  const long long step = blockDim.x;
  const long long stride = step * kItems * gridDim.x;
  for (long long base = step * kItems * blockIdx.x + threadIdx.x;
       base < size; base += stride) {
    uint32_t l[kItems], h[kItems], v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = base + u * step;
      if constexpr (WIDE) {
        const uint2 k = i < end
                            ? __ldcs(reinterpret_cast<const uint2*>(keys) + i)
                            : make_uint2(0u, 0u);
        l[u] = k.x;
        h[u] = k.y;
      } else {
        l[u] = i < end ? __ldcs(keys + i) : 0u;
      }
      if constexpr (REC) v[u] = i < n ? __ldcs(vals + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = base + u * step;
      if (i >= size) break;
      if constexpr (REC && WIDE)
        reinterpret_cast<uint4*>(rec)[i] = make_uint4(l[u], h[u], v[u], 0u);
      else if constexpr (REC)
        reinterpret_cast<uint2*>(rec)[i] = make_uint2(l[u], v[u]);
      if constexpr (WIDE) {
        const uint32_t hw = i < c ? h[u] & hmask : ~0u;
        if (hi_bytes == 2)
          static_cast<uint16_t*>(hi)[i] = uint16_t(hw);
        else if (hi_bytes == 4)
          static_cast<uint32_t*>(hi)[i] = hw;
      }
      __stcs(lo + i, i < c ? l[u] & mask : ~0u);
      __stcs(pos + i, uint32_t(i));
    }
  }
}

// The unsigned type of B bytes.
template <int B>
struct Word;
template <>
struct Word<2> {
  using T = uint16_t;
};
template <>
struct Word<4> {
  using T = uint32_t;
};
template <>
struct Word<8> {
  using T = unsigned long long;
};
template <>
struct Word<16> {
  using T = uint4;
};

// One gather of the (word, position) path by the sorted positions pos,
// for j < m, from src of B bytes an item: out[j] = src[pos[j]], widened
// to 32 bits if narrower; with KV (src split_pad's records: a 32-bit key
// and its value, B = 8, or a 64-bit key, its value and a pad word, B =
// 16) out[j] = the record's key and out_v[j] = its value. Two gathers a
// sort: the high-word passes' keys from split_pad's high words (masked,
// and all ones for the tail and the pads already; m the padded size), and
// last the sorted keys (and values) from the keys or the records (m = n;
// a count= tail is at its own positions already). The random loads are
// the cost (about a millisecond for 2^25 of them from HBM, whatever their
// width up to 16 bytes), so they go to L2 only and are all issued before
// the first store, and the streamed positions and outputs are marked to
// leave L2 first.
template <int B, bool KV>
__global__ void __launch_bounds__(kCopyThreads)
    gather_kernel(long long m, const uint32_t* __restrict__ pos,
                  const typename Word<B>::T* __restrict__ src,
                  typename Word<KV ? B / 2 : (B < 4 ? 4 : B)>::T* __restrict__
                      out,
                  uint32_t* __restrict__ out_v) {
  const long long step = blockDim.x;
  const long long stride = step * kItems * gridDim.x;
  for (long long base = step * kItems * blockIdx.x + threadIdx.x; base < m;
       base += stride) {
    uint32_t q[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = base + u * step;
      q[u] = i < m ? __ldcs(pos + i) : 0u;
    }
    typename Word<B>::T r[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      if (base + u * step < m) r[u] = __ldcg(src + q[u]);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = base + u * step;
      if (i >= m) break;
      if constexpr (KV && B == 16) {
        __stcs(out + i, (static_cast<unsigned long long>(r[u].y) << 32) |
                            r[u].x);
        __stcs(out_v + i, r[u].z);
      } else if constexpr (KV) {
        __stcs(out + i, uint32_t(r[u]));
        __stcs(out_v + i, uint32_t(r[u] >> 32));
      } else {
        __stcs(out + i, r[u]);
      }
    }
  }
}

// Thread blocks of a copy-like launch: enough to fill every
// SM (kCopyBlocksPerSm of kCopyThreads), and no more than `words` need.
int copy_grid(long long words, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const long long per = 4LL * kCopyThreads * kCopyVecs;
  const long long need = (words + per - 1) / per;
  const long long full = (long long)sms * kCopyBlocksPerSm;
  *grid = unsigned(need < 1 ? 1 : need < full ? need : full);
  return int(cudaSuccess);
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
  const long long* count;  // the first pass's: see block_sort_kernel
  long long n;
};

template <bool KV, int KPT, int BITS, bool FIRST>
int launch_match(const SortArgs& a) {
  const auto kernel = block_sort_kernel<KV, KPT, BITS, FIRST>;
  const int threads = a.block / KPT;
  const size_t smem = sort_smem(a.block, BITS, KV);
  int dev = 0, sms = 0, resident = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<unsigned(sort_grid(a.nblocks, sms, resident)), threads, smem,
           a.st>>>(a.keys, a.vals, a.out_k, a.out_v, a.hist, a.nblocks,
                   a.shift, a.count, a.n);
  return int(cudaGetLastError());
}

template <bool KV, int BITS, bool FIRST>
int launch_match_kpt(const SortArgs& a) {
  switch (a.block / sort_threads(a.block)) {
    case 4:
      return launch_match<KV, 4, BITS, FIRST>(a);
    case 8:
      return launch_match<KV, 8, BITS, FIRST>(a);
    case 16:
      return launch_match<KV, 16, BITS, FIRST>(a);
    case 32:
      return launch_match<KV, 32, BITS, FIRST>(a);
  }
  return int(cudaErrorInvalidValue);
}

template <bool KV, bool FIRST>
int launch_block_sort(const SortArgs& a) {
  if (a.nblocks == 0) return int(cudaSuccess);
  return a.bits == 4 ? launch_match_kpt<KV, 4, FIRST>(a)
                     : launch_match_kpt<KV, 8, FIRST>(a);
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

// vrs_block_sort and vrs_block_sort_first: K7, FIRST or not.
int block_sort_call(bool first, int kv, const void* count, long long n,
                    const void* keys, const void* vals, void* out_k,
                    void* out_v, void* hist, long long nblocks, int block,
                    int shift, int bits, void* stream) {
  if (bad_geometry(nblocks, block, bits) || shift < 0 || shift > 31 ||
      n < 0 || n > nblocks * block ||
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
                   static_cast<cudaStream_t>(stream),
                   static_cast<const long long*>(count),
                   n};
  if (first)
    return kv ? launch_block_sort<true, true>(a)
              : launch_block_sort<false, true>(a);
  return kv ? launch_block_sort<true, false>(a)
            : launch_block_sort<false, false>(a);
}

}  // namespace

// Each call launches one kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry the kernels do not take). `kv` != 0
// moves the values too; otherwise their pointers are not read. K7's
// buffers must be 16-byte aligned (the bulk copy engine moves its blocks),
// but for the first pass's inputs.
extern "C" {

int vrs_block_sort(int kv, const void* keys, const void* vals, void* out_k,
                   void* out_v, void* hist, long long nblocks, int block,
                   int shift, int bits, void* stream) {
  return block_sort_call(false, kv, nullptr, 0, keys, vals, out_k, out_v,
                         hist, nblocks, block, shift, bits, stream);
}

// A sort's first pass: K7 over nblocks * block slots from the caller's n
// keys (and values), at any alignment, those at or past the int64 count on
// the card (if `count` is not null; never read on the host) or past n
// read as 0xFFFFFFFF, values past n as 0. The outputs as vrs_block_sort's.
int vrs_block_sort_first(int kv, const void* count, long long n,
                         const void* keys, const void* vals, void* out_k,
                         void* out_v, void* hist, long long nblocks,
                         int block, int shift, int bits, void* stream) {
  return block_sort_call(true, kv, count, n, keys, vals, out_k, out_v, hist,
                         nblocks, block, shift, bits, stream);
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

// After a count= sort: out[i] = keys[i] for count <= i < n, in place.
int vrs_restore_tail(const void* count, long long n, const void* keys,
                     void* out, void* stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  unsigned grid = 0;
  const int e = copy_grid(n, &grid);
  if (e != int(cudaSuccess)) return e;
  restore_tail_kernel<<<grid, kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(count), n,
      static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

// The (word, position) path's first buffers: lo and pos, `size` words
// each; with `vals` not null the records (`size` of 16 bytes with `wide`,
// else 8); with `hi_bytes` 2 or 4 (64-bit keys only) the high words masked
// by `hmask` into `hi`, `size` of that many bytes. The masks are 32-bit
// patterns passed as int. From the n keys (uint64 with `wide`, else
// uint32), the values, and, if `count` is not null, the int64 count on the
// card.
int vrs_split_pad(int wide, const void* count, long long n, long long size,
                  const void* keys, const void* vals, int mask, int hmask,
                  int hi_bytes, void* lo, void* pos, void* rec, void* hi,
                  void* stream) {
  if (n < 0 || size < n || size > 0x100000000LL ||
      (hi_bytes && (!wide || !hi || (hi_bytes != 2 && hi_bytes != 4))) ||
      (vals && (reinterpret_cast<uintptr_t>(rec) & (wide ? 15 : 7))))
    return int(cudaErrorInvalidValue);
  if (size == 0) return int(cudaSuccess);
  unsigned grid = 0;
  const int e = copy_grid(size, &grid);
  if (e != int(cudaSuccess)) return e;
  auto st = static_cast<cudaStream_t>(stream);
  auto cnt = static_cast<const long long*>(count);
  auto k = static_cast<const uint32_t*>(keys);
  auto v = static_cast<const uint32_t*>(vals);
  auto l = static_cast<uint32_t*>(lo);
  auto p = static_cast<uint32_t*>(pos);
  auto r = static_cast<uint32_t*>(rec);
#define VRS_SPLIT(W, R)                                                   \
  split_pad_kernel<W, R><<<grid, kCopyThreads, 0, st>>>(                 \
      cnt, n, size, k, v, uint32_t(mask), uint32_t(hmask), hi_bytes, l, p, \
      r, hi)
  if (wide && vals)
    VRS_SPLIT(true, true);
  else if (wide)
    VRS_SPLIT(true, false);
  else if (vals)
    VRS_SPLIT(false, true);
  else
    VRS_SPLIT(false, false);
#undef VRS_SPLIT
  return int(cudaGetLastError());
}

// A gather of the (word, position) path by the m positions pos, from
// `src` of `src_bytes` an item: without `out_v`, split_pad's high words
// (2 or 4, widened to uint32) or keys (4 or 8); with `out_v`, split_pad's
// records (8 for uint32 keys, 16 for uint64), their keys into `out` and
// their values into `out_v`.
int vrs_gather(int src_bytes, long long m, const void* pos, const void* src,
               void* out, void* out_v, void* stream) {
  const bool rec = out_v != nullptr;
  const bool ok = rec ? src_bytes == 8 || src_bytes == 16
                      : src_bytes == 2 || src_bytes == 4 || src_bytes == 8;
  if (m < 0 || !ok || (reinterpret_cast<uintptr_t>(src) & (src_bytes - 1)))
    return int(cudaErrorInvalidValue);
  if (m == 0) return int(cudaSuccess);
  unsigned grid = 0;
  const int e = copy_grid(m, &grid);
  if (e != int(cudaSuccess)) return e;
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(pos);
  auto ov = static_cast<uint32_t*>(out_v);
#define VRS_GATHER(B, KV)                                                 \
  gather_kernel<B, KV><<<grid, kCopyThreads, 0, st>>>(                    \
      m, p, static_cast<const Word<B>::T*>(src),                          \
      static_cast<Word<KV ? B / 2 : (B < 4 ? 4 : B)>::T*>(out), ov)
  if (rec && src_bytes == 16)
    VRS_GATHER(16, true);
  else if (rec)
    VRS_GATHER(8, true);
  else if (src_bytes == 8)
    VRS_GATHER(8, false);
  else if (src_bytes == 4)
    VRS_GATHER(4, false);
  else
    VRS_GATHER(2, false);
#undef VRS_GATHER
  return int(cudaGetLastError());
}

}  // extern "C"
