"""The register layouts of the three-word carries' chunk (K1) and fused
(K2) kernels, `csrc/wide.cuh`, emulated thread by thread on the CPU.

The kernels cannot run here, so this mirrors their plan in numpy: each
thread's registers in layout R0, the stages a phase runs between
registers, between lanes (shuffles) and, past its lanes, through a
transpose pair to the layout that holds them in registers, with the
XOR-swizzled shared-memory slots of both layouts. The emulation is held
bitwise against the plain network (`bitonic_kernels.run_plain`) at every
chunk and fused group of W3 and W4_BIG, with a tied (max, max, pad) tail
that starts mid-chunk; every transpose must write each slot once and
reach 32 banks with a warp's 32 lanes. The geometry constants are read
from the header, so a change there is checked here. The CUDA kernels
themselves are held against the plain versions on the card
(`test_torch_cuda.py`, `chip_smoke.py`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vulkan_radix_sort_tpu_torch.config import MIN_CHUNK
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk

WIDE = (Path(bk.__file__).parents[1] / "csrc" / "wide.cuh").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", WIDE)[1])


ELEMS = _constant("kWideElems")
SHUFFLES = _constant("kWideShuffles")
MERGE_ELEMS = _constant("kMergeElems")
MAX_THREADS = _constant("kWideMaxThreads")


def _wide(kernel, mode, c):
    """Whether csrc/wide.cuh's network (Wide) runs the launch: K2 of W3,
    and K1 of W4_BIG where a block has at most kWideMaxThreads threads."""
    if kernel == "fused":
        return mode is bk.W3
    return mode is bk.W4_BIG and max(c // ELEMS, bk.WARP) <= MAX_THREADS


def test_wide_geometry_mirrors_the_cuda_source():
    """block_geometry gives Wide's launches kWideElems elements a thread,
    K1 of W3 (the merge sort) kMergeElems, every block at least a warp;
    the main path's K1 of W4_BIG (2^12) is Wide's, and the rest keep
    Regs's geometry."""
    assert ELEMS == bk.WIDE_ELEMS and MERGE_ELEMS == bk.MERGE_ELEMS
    assert MAX_THREADS == bk.WIDE_MAX_THREADS
    assert _wide("chunk", bk.W4_BIG, 1 << 12)
    assert not _wide("chunk", bk.W4_BIG, 1 << 13)
    for mode in (bk.W3, bk.W4_BIG):
        c = MIN_CHUNK
        while c <= mode.reg_cap:
            for kernel in ("chunk", "fused"):
                got = bk.block_geometry(kernel, mode, c)
                if (kernel, mode) == ("chunk", bk.W3):
                    threads = max(c // MERGE_ELEMS, bk.WARP)
                    assert got == (threads, c // threads)
                elif _wide(kernel, mode, c):
                    threads = max(c // ELEMS, bk.WARP)
                    assert got == (threads, c // threads)
                else:  # Regs: 8 elements a thread, 32 at 256 threads
                    assert got[0] * got[1] == c and got[1] in (8, 16, 32)
            c *= 2


def _swizzle(i):
    return i ^ ((i >> 5) & 31)


def _index_bit(l, rlo, b):
    return b if b < rlo else b + l


def _conflict_free(l, rlo):
    for m in range(1, 32):
        x = 0
        for b in range(5):
            i = 1 << _index_bit(l, rlo, b)
            if m >> b & 1:
                x ^= (i ^ (i >> 5)) & 31
        if x == 0:
            return False
    return True


def _rlo_for(l, lc, jtop):
    r = max(jtop - l + 1, 0)
    while r <= jtop and r + l <= lc:
        if _conflict_free(l, r):
            return r
        r += 1
    return -1


def _transposes(l, lc, jtop):
    return jtop >= l and (jtop >= l + 5 or (
        jtop - l + 1 > SHUFFLES and _rlo_for(l, lc, jtop) >= 0))


def _less(a, b):
    """a < b over the three compared words, elementwise."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (
        (a[1] < b[1]) | ((a[1] == b[1]) & (a[2] < b[2]))))


class _Wide:
    """One block of `Wide<3, RIDE, LC>`: regs[array][thread, register]."""

    def __init__(self, lc, arrs, block):
        self.lc, self.block = lc, block
        self.threads = max((1 << lc) // ELEMS, bk.WARP)
        self.e = (1 << lc) // self.threads
        self.l = self.e.bit_length() - 1
        self.r = [a.reshape(self.threads, self.e).copy() for a in arrs]
        self.counts = {"reg": 0, "shfl": 0, "transposes": 0}

    def dir_mask(self, p):
        x = np.arange(self.threads, dtype=np.int64)
        bit = (((x * self.e) | ((self.block & 1) << self.lc)) >> p) & 1
        return (bit * 0xFFFFFFFF).astype(np.uint32)[:, None]

    def negate(self, mask):  # mask: (threads, 1) or (threads, E)
        for a in self.r[:3]:
            a ^= mask

    def reg_stage(self, jr):
        self.counts["reg"] += 1
        a = [e for e in range(self.e) if not e & (1 << jr)]
        b = [e | (1 << jr) for e in a]
        swap = _less([x[:, b] for x in self.r[:3]],
                     [x[:, a] for x in self.r[:3]])
        for x in self.r:
            xa, xb = x[:, a].copy(), x[:, b].copy()
            x[:, a] = np.where(swap, xb, xa)
            x[:, b] = np.where(swap, xa, xb)

    def shfl_stage(self, m):
        self.counts["shfl"] += 1
        x = np.arange(self.threads)
        y = x ^ m
        upper = ((x & m) != 0)[:, None]
        mine, theirs = self.r[:3], [a[y] for a in self.r[:3]]
        take = np.where(upper, _less(mine, theirs), _less(theirs, mine))
        self.r = [np.where(take, a[y], a) for a in self.r]

    def slots(self, rlo):
        x = np.arange(self.threads)[:, None]
        e = np.arange(self.e)[None, :]
        idx = ((x & ((1 << rlo) - 1)) | (e << rlo)
               | ((x >> rlo) << (rlo + self.l)))
        s = _swizzle(idx)
        assert np.unique(s).size == 1 << self.lc  # each slot once
        for w in range(self.threads // 32):  # a warp's 32 lanes, 32 banks
            banks = s[32 * w:32 * w + 32] % 32
            assert all(np.unique(banks[:, k]).size == 32
                       for k in range(self.e)), (rlo, w)
        return s

    def transpose(self, src, dst):
        self.counts["transposes"] += 1
        s, d = self.slots(src), self.slots(dst)
        for i, a in enumerate(self.r):
            smem = np.zeros(1 << self.lc, dtype=a.dtype)
            smem[s.ravel()] = a.ravel()
            self.r[i] = smem[d.ravel()].reshape(a.shape)

    def merge(self, jtop):
        l = self.l
        if jtop < 0:
            return
        if jtop < l:
            for j in range(jtop, -1, -1):
                self.reg_stage(j)
        elif not _transposes(l, self.lc, jtop):
            for j in range(jtop, l - 1, -1):
                assert j - l < 5  # a lane bit of R0
                self.shfl_stage(1 << (j - l))
            self.merge(l - 1)
        else:
            rlo = _rlo_for(l, self.lc, jtop)
            assert rlo >= 0
            self.transpose(0, rlo)
            for j in range(jtop, rlo - 1, -1):
                self.reg_stage(j - rlo)
            self.transpose(rlo, 0)
            self.merge(rlo - 1)

    def phase(self, pk):
        l = self.l
        if pk <= l:
            e = np.arange(self.e)
            was = 0 if pk == 1 else (e >> (pk - 1)) & 1
            now = 0 if pk == l else (e >> pk) & 1
            mask = ((was ^ now) * 0xFFFFFFFF).astype(np.uint32)[None, :]
            if pk == l:
                mask = mask ^ self.dir_mask(l)
            self.negate(mask)
        else:
            self.negate(self.dir_mask(pk - 1) ^ self.dir_mask(pk))
        self.merge(pk - 1)


def _inputs(mode, n, seed):
    """Few (hi, lo) values so the third word decides; in W4_BIG a tied
    (max, max, pad) tail with distinct riding values from mid-chunk on."""
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(0, 5, n).astype(np.uint32) for _ in range(2)]
    arrs += [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
             for _ in range(mode.ride + 1)]
    if mode.ride:
        start = n - n // 4 - 37
        arrs[0][start:] = arrs[1][start:] = 0xFFFFFFFF
        arrs[2][start:] = tbit.STABLE_PAD_IDX
    return arrs


def _emulate(mode, launch, lg, arrs):
    """The kernel on two blocks (both parities) of 2^lg elements."""
    out, counts = [], None
    for block in range(2):
        w = _Wide(lg, [a[block << lg:(block + 1) << lg] for a in arrs],
                  block)
        if launch.kernel == "chunk":
            phases = range(1, lg + 1)
        else:
            lc, r_lo = launch.cargs[0], launch.cargs[1]
            w.negate(w.dir_mask(lc + r_lo - 1))
            phases = range(lc + r_lo, lg + 1)
        for pk in phases:
            w.phase(pk)
        w.negate(w.dir_mask(lg))
        out.append([a.reshape(-1) for a in w.r])
        counts = w.counts
    return [np.concatenate(parts) for parts in zip(*out)], counts


def _plain(mode, launch, arrs):
    bufs = [torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
            for a in arrs]
    bk.run_plain(launch, bufs, mode, 2)
    return [b.view(torch.int32).numpy().view(np.uint32) for b in bufs]


def _cases():
    """Every launch Wide runs: K1 of W4_BIG at every chunk it takes, K2 of
    W3 at every group (K1 of W3 is the merge sort, below)."""
    cases = []
    for mode in (bk.W3, bk.W4_BIG):
        c = MIN_CHUNK
        while c <= mode.reg_cap:
            if _wide("chunk", mode, c):
                cases.append(pytest.param(mode, ("chunk", c),
                                          id=f"{mode.name}-chunk-{c}"))
            if c > MIN_CHUNK and _wide("fused", mode, c):  # groups of two
                # MIN_CHUNK chunks up
                for lc in sorted({bk.log2(MIN_CHUNK), bk.log2(c) - 1}):
                    top = bk.log2(c) - lc
                    for r_lo in sorted({1, top}):
                        cases.append(pytest.param(
                            mode, ("fused", 1 << lc, r_lo, top),
                            id=f"{mode.name}-fused-{c}-{1 << lc}-{r_lo}"))
            c *= 2
    return cases


@pytest.mark.parametrize("mode,case", _cases())
def test_wide_layouts_match_the_plain_network(mode, case):
    """The emulated kernel equals the plain network bitwise, and runs
    every stage of the network once."""
    launch = bk.spec(*case)
    lg = bk.log2(launch.unit)
    arrs = _inputs(mode, 2 << lg, lg + mode.code)
    got, counts = _emulate(mode, launch, lg, arrs)
    for g, w in zip(got, _plain(mode, launch, arrs)):
        np.testing.assert_array_equal(g, w)
    assert counts["reg"] + counts["shfl"] == len(launch.stages)


def _merge_sort_block(words, block):
    """One block of chunk_merge_kernel: each thread's registers sorted, then
    merge levels, each thread taking its outputs of its pair of runs by a
    binary search on the merge path and a two-way merge (A first on
    ties). An odd block's words are negated throughout."""
    n = words[0].size
    threads = max(n // MERGE_ELEMS, bk.WARP)
    e = n // threads
    neg = np.uint32(0xFFFFFFFF if block & 1 else 0)
    keys = [tuple(int(w[i] ^ neg) for w in words) for i in range(n)]
    regs = [sorted(keys[x * e:(x + 1) * e]) for x in range(threads)]
    size = e
    while size < n:
        tile = [key for r in regs for key in r]
        nxt = []
        for x in range(threads):
            a0 = (x * e) & ~(2 * size - 1)
            b0, d = a0 + size, x * e - a0
            lo, hi = max(d - size, 0), min(d, size)
            while lo < hi:
                mid = (lo + hi) >> 1
                if tile[b0 + d - 1 - mid] < tile[a0 + mid]:
                    hi = mid
                else:
                    lo = mid + 1
            ia, ib, ea, eb = a0 + lo, b0 + d - lo, a0 + size, b0 + size
            out = []
            for _ in range(e):
                take_b = ib < eb and (ia >= ea or tile[ib] < tile[ia])
                out.append(tile[ib] if take_b else tile[ia])
                ib, ia = (ib + 1, ia) if take_b else (ib, ia + 1)
            nxt.append(out)
        regs, size = nxt, size * 2
    flat = [key for r in regs for key in r]
    return [np.array([key[i] for key in flat], dtype=np.uint32) ^ neg
            for i in range(3)]


@pytest.mark.parametrize("lc", range(bk.log2(MIN_CHUNK),
                                     bk.log2(bk.W3.reg_cap) + 1))
def test_w3_merge_sort_matches_the_plain_network(lc):
    """K1 of W3 sorts by merging, which is the network's function there:
    every word is compared, so equal tuples are identical. The emulated
    kernel equals the plain network bitwise on both parities, with few
    distinct (hi, lo) so the third word decides."""
    launch = bk.spec("chunk", 1 << lc)
    arrs = _inputs(bk.W3, 2 << lc, lc)
    want = _plain(bk.W3, launch, arrs)
    for block in range(2):
        part = slice(block << lc, (block + 1) << lc)
        got = _merge_sort_block([a[part] for a in arrs], block)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[part])
