"""The port's radix kernels, K7 (block sort), the spine and K8 (placement),
against the JAX package's Pallas kernels and against numpy.

On the CPU each wrapper of `vulkan_radix_sort_tpu_torch.ops.block_sort` /
`stream_place` runs its kernel's plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, at the JAX package's own test
geometry (block=1024, 4-bit digits, 8 blocks), as `tests/test_kernels.py`
does. Same numpy-seeded inputs; tolerance: bitwise equality (all data is
integer). The JAX tiles are (rows, 128) and its histogram rows are padded
to 128 lanes: the port's flat keys are compared with the flattened tiles,
and its (nblocks, radix) histogram with the first `radix` lanes. The CUDA
kernels themselves are held against these plain versions on the card in
`test_torch_cuda.py` and `chip_smoke.py`.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.config import SortConfig as JaxConfig
from vulkan_radix_sort_tpu.ops.block_sort import block_sort as jax_block_sort
from vulkan_radix_sort_tpu.ops.radix import _pad2d, _spine as jax_spine
from vulkan_radix_sort_tpu.ops.stream_place import (
    stream_place as jax_stream_place)
from vulkan_radix_sort_tpu_torch.config import (
    MAX_RADIX_BLOCK, RADIX_THREADS, SMEM_BYTES, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
from vulkan_radix_sort_tpu_torch.utils import timing

JCFG = JaxConfig(block=1024, flush_rows=4, interpret=True)
CFG = SortConfig(block=1024, digit_bits=4)
B = 1024
N = 8 * B
R = CFG.radix


def _keys(seed, hi=2**32, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


def _vals(seed, n=N):
    return _keys(seed + 1000, n=n)


def _tile(x, fill):
    return _pad2d(jnp.asarray(x), x.size, fill)


def _flat(a):
    return np.array(a).reshape(-1)  # a writable copy, for torch.from_numpy


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("shift", [0, 4, 28])
def test_block_sort_matches_jax(shift, key_value, skew):
    """K7 bitwise equal to the Pallas block sort; `skew` leaves the digit at
    `shift` two values, so nearly every key ties and stability decides."""
    keys = _keys(shift + 10 * key_value)
    if skew:
        keys &= ~np.uint32(0xE << shift)
    vals = _vals(shift)
    got = k7.block_sort(torch.from_numpy(keys),
                        torch.from_numpy(vals) if key_value else None,
                        shift=shift, config=CFG, key_value=key_value)
    want = jax_block_sort(_tile(keys, 0xFFFFFFFF),
                          _tile(vals, 0) if key_value else None,
                          shift=shift, config=JCFG, key_value=key_value,
                          interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), _flat(want[0]))
    if key_value:
        np.testing.assert_array_equal(got[1].numpy(), _flat(want[1]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1])[:, :R])


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("kind", ["one digit", "all equal"])
def test_block_sort_degenerate_blocks_match_jax(kind, key_value):
    """K7 where every lane of a warp is a peer, bitwise equal to the Pallas
    block sort: keys that differ everywhere but in the digit at `shift`
    (every position set by stability alone), and keys all equal."""
    shift = 8
    if kind == "one digit":
        keys = (_keys(77 + key_value) & ~np.uint32(0xF << shift)) \
            | np.uint32(0x9 << shift)
    else:
        keys = np.full(N, 0x12345978, np.uint32)  # digit 9 too
    vals = _vals(77)
    got = k7.block_sort(torch.from_numpy(keys),
                        torch.from_numpy(vals) if key_value else None,
                        shift=shift, config=CFG, key_value=key_value)
    want = jax_block_sort(_tile(keys, 0xFFFFFFFF),
                          _tile(vals, 0) if key_value else None,
                          shift=shift, config=JCFG, key_value=key_value,
                          interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), _flat(want[0]))
    if key_value:
        np.testing.assert_array_equal(got[1].numpy(), _flat(want[1]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1])[:, :R])
    assert (got[-1].numpy()[:, 9] == B).all()


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("dist_hi", [2**32, 16, 2])
def test_stream_place_matches_jax(dist_hi, key_value):
    """K8 fed the same block-sorted (y, hist, g) as the Pallas placement,
    uniform and skewed digits; the pass's result is also the stable digit
    sort of the input."""
    keys = _keys(dist_hi % 97 + key_value, hi=dist_hi)
    vals = _vals(7)
    y, yv, hist = jax_block_sort(_tile(keys, 0xFFFFFFFF), _tile(vals, 0),
                                 shift=0, config=JCFG, key_value=True,
                                 interpret=True)
    g = jax_spine(hist, R)
    if key_value:
        want = jax_stream_place(y, hist, g, yv, config=JCFG, key_value=True,
                                interpret=True)
    else:
        want = (jax_stream_place(y, hist, g, config=JCFG, interpret=True),)
    ty, tyv = torch.from_numpy(_flat(y)), torch.from_numpy(_flat(yv))
    th = torch.tensor(np.asarray(hist)[:, :R])  # copies: contiguous
    tg = torch.tensor(np.asarray(g)[0, :R])
    got = k8.stream_place(ty, th, tg, tyv if key_value else None, config=CFG,
                          key_value=key_value)
    got = got if key_value else (got,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _flat(b))
    order = np.argsort(keys & 15, kind="stable")
    np.testing.assert_array_equal(got[0].numpy(), keys[order])
    if key_value:
        np.testing.assert_array_equal(got[1].numpy(), vals[order])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("nblocks", [1, 3, 37])
def test_spine_plain_matches_jax_and_numpy(nblocks, bits):
    """`spine` on the CPU (its plain version) bitwise equal to the JAX
    `_spine` and to a numpy column scan, with empty columns (a digit no
    block holds, and the first and last digits) and one-block tables."""
    radix = 1 << bits
    rng = np.random.default_rng(nblocks * 10 + bits)
    hist = rng.integers(0, 300, size=(nblocks, radix)).astype(np.int32)
    hist[:, [0, radix // 3, radix - 1]] = 0
    g, off = k8.spine(torch.from_numpy(hist))
    assert g.dtype == off.dtype == torch.int32 and off.is_contiguous()
    tot = hist.sum(0)
    want_g = np.cumsum(tot) - tot
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(off.numpy(),
                                  np.cumsum(hist, 0) - hist + want_g)
    # the JAX spine on its lane-padded rows (128 lanes; 256 columns as
    # they are)
    padded = np.zeros((nblocks, max(radix, 128)), np.int32)
    padded[:, :radix] = hist
    np.testing.assert_array_equal(
        np.asarray(jax_spine(jnp.asarray(padded), radix))[0, :radix],
        g.numpy())


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("dist_hi", [2**32, 3])
@pytest.mark.parametrize("shift", [4, 28])
def test_stream_place_with_spine_matches_jax(shift, dist_hi, key_value):
    """K8 as a radix pass calls it (the pass's shift, the run offsets from
    `spine`) bitwise equal to the Pallas placement after the Pallas block
    sort at that shift, uniform and skewed digits (three values)."""
    keys = _keys(shift + key_value, hi=dist_hi) << np.uint32(shift)
    keys |= _keys(shift + 50, hi=1 << shift)  # lower digits: noise
    vals = _vals(shift + 3)
    y, yv, hist = jax_block_sort(_tile(keys, 0xFFFFFFFF), _tile(vals, 0),
                                 shift=shift, config=JCFG, key_value=True,
                                 interpret=True)
    g = jax_spine(hist, R)
    if key_value:
        want = jax_stream_place(y, hist, g, yv, config=JCFG, key_value=True,
                                interpret=True)
    else:
        want = (jax_stream_place(y, hist, g, config=JCFG, interpret=True),)
    th = torch.tensor(np.asarray(hist)[:, :R])
    tg, offsets = k8.spine(th)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g)[0, :R])
    got = k8.stream_place(torch.from_numpy(_flat(y)), th, tg,
                          torch.from_numpy(_flat(yv)) if key_value else None,
                          config=CFG, key_value=key_value, shift=shift,
                          offsets=offsets)
    got = got if key_value else (got,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _flat(b))
    order = np.argsort((keys >> np.uint32(shift)) & np.uint32(15),
                       kind="stable")
    np.testing.assert_array_equal(got[0].numpy(), keys[order])


def test_spine_and_block_offsets_match_numpy():
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 100, size=(37, 256)).astype(np.int32)
    hist[:, 5] = 0  # an empty digit
    tot = hist.sum(0)
    g = np.cumsum(tot) - tot
    got_g = k8.digit_offsets(torch.from_numpy(hist))
    assert got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), g)
    off = k8.block_offsets(torch.from_numpy(hist), got_g)
    assert off.dtype == torch.int32 and off.is_contiguous()
    np.testing.assert_array_equal(off.numpy(),
                                  np.cumsum(hist, 0) - hist + g[None, :])
    # the JAX package's spine agrees on its lane-padded layout
    padded = np.zeros((37, 128), np.int32)
    padded[:, :16] = hist[:, :16]
    np.testing.assert_array_equal(
        np.asarray(jax_spine(jnp.asarray(padded), 16))[0, :16],
        k8.digit_offsets(torch.from_numpy(hist[:, :16].copy())).numpy())


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("shift", [0, 8, 24])
def test_plain_kernels_8bit_match_numpy(shift, key_value):
    """At the port's own geometry (8-bit digits, the default blocks): K7 is
    a stable digit sort of each block with its bincount, and K7 then K8 is
    a stable digit sort of the whole input."""
    cfg = SortConfig()
    n = 4 * cfg.block
    keys = _keys(shift + 1, n=n)
    ties = keys[1::5] & np.uint32(0xFF << shift)
    keys[::5][:ties.size] = ties
    vals = _vals(shift, n=n)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    out = k7.block_sort(tk, tv if key_value else None, shift=shift,
                        config=cfg, key_value=key_value)
    digit = (keys >> np.uint32(shift)) & np.uint32(255)
    for b in range(n // cfg.block):
        s = slice(b * cfg.block, (b + 1) * cfg.block)
        order = np.argsort(digit[s], kind="stable")
        np.testing.assert_array_equal(out[0][s].numpy(), keys[s][order])
        if key_value:
            np.testing.assert_array_equal(out[1][s].numpy(), vals[s][order])
        np.testing.assert_array_equal(out[-1][b].numpy(),
                                      np.bincount(digit[s], minlength=256))
    placed = k8.stream_place(out[0], out[-1], k8.digit_offsets(out[-1]),
                             out[1] if key_value else None, config=cfg,
                             key_value=key_value)
    placed = placed if key_value else (placed,)
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(placed[0].numpy(), keys[order])
    if key_value:
        np.testing.assert_array_equal(placed[1].numpy(), vals[order])


def test_block_sort_geometry():
    """Every block SortConfig admits gives K7 whole warps of at most
    RADIX_THREADS threads holding 4 to 32 keys each, a whole number of
    16-byte vectors (csrc/radix.cu, sort_threads)."""
    block = RADIX_THREADS
    while block <= MAX_RADIX_BLOCK:
        SortConfig(block=block)
        threads, per = k7.sort_geometry(block)
        assert threads * per == block and threads % 32 == 0
        assert threads <= RADIX_THREADS and per % 4 == 0 and 4 <= per <= 32
        block *= 2
    assert k7.sort_geometry(SortConfig().block) == (512, 32)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    keys = torch.from_numpy(_keys(5))
    with timing.LaunchTimer() as timer:
        y, hist = k7.block_sort(keys, shift=4, config=CFG)
        g, offsets = k8.spine(hist)
        placed = k8.stream_place(y, hist, g, config=CFG, shift=4,
                                 offsets=offsets)
    want = k7.block_sort_plain(keys, shift=4, config=CFG)
    assert torch.equal(y, want[0]) and torch.equal(hist, want[1])
    want_g, want_off = k8.spine_plain(hist)
    assert torch.equal(g, want_g) and torch.equal(offsets, want_off)
    assert torch.equal(placed, k8.stream_place_plain(y, hist, g, config=CFG))
    # the three plain stand-ins, recorded without events: no kernel launch
    assert [r["names"] for r in timer.records] == [["block_sort"], ["spine"],
                                                   ["place"]]
    assert all(r["events"] is None for r in timer.records)


def test_wrappers_reject_bad_inputs():
    keys = torch.from_numpy(_keys(6))
    with pytest.raises(TypeError):
        k7.block_sort(keys.view(torch.int32), shift=0, config=CFG)
    with pytest.raises(ValueError):  # not a block multiple
        k7.block_sort(keys[:-1], shift=0, config=CFG)
    with pytest.raises(ValueError):
        k7.block_sort(keys, shift=32, config=CFG)
    with pytest.raises(TypeError):  # key_value without values
        k7.block_sort(keys, shift=0, config=CFG, key_value=True)
    with pytest.raises(ValueError):
        k7.block_sort(keys, keys[:B], shift=0, config=CFG, key_value=True)
    y, hist = k7.block_sort(keys, shift=0, config=CFG)
    g = k8.digit_offsets(hist)
    with pytest.raises(ValueError):  # histogram of another geometry
        k8.stream_place(y, hist[:, :8].contiguous(), g, config=CFG)
    with pytest.raises(ValueError):
        k8.stream_place(y, hist, g.to(torch.int64), config=CFG)
    with pytest.raises(ValueError):  # run offsets of another geometry
        k8.stream_place(y, hist, g, config=CFG, offsets=hist[:4].clone())
    for bad in (hist.to(torch.int64), hist[:, :8].contiguous(), hist.t(),
                hist[0]):
        with pytest.raises(ValueError):
            k8.spine(bad)
    meta = torch.empty(N, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):  # no kernel and no plain off the CPU/GPU
        k7.block_sort(meta, shift=0, config=CFG)
    mh = torch.empty(N // B, R, dtype=torch.int32, device="meta")
    mg = torch.empty(R, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k8.spine(mh)
    for shift in (None, 32):  # off the CPU the kernel needs the shift
        with pytest.raises(ValueError, match="shift"):
            k8.stream_place(meta, mh, mg, config=CFG, shift=shift)
    with pytest.raises(ValueError, match="no kernel"):
        k8.stream_place(meta, mh, mg, config=CFG, shift=0)


# -- K7's design (csrc/radix.cu), emulated warp by warp ----------------------

RADIX_CU = (Path(k7.__file__).parents[1] / "csrc" / "radix.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", RADIX_CU)[1])


def test_block_sort_layout_mirrors_the_cuda_source():
    """sort_geometry, sort_stages, sort_smem and sort_grid hold the
    constants and formulas of csrc/radix.cu: threads, keys a thread, key
    buffers (three for keys, two for key-value), and every block and digit
    width fits one H100 block's shared memory."""
    assert _constant("kThreads") == RADIX_THREADS
    assert _constant("kVecKeys") == k7.VECTOR_KEYS
    assert _constant("kSmemBytes") == SMEM_BYTES
    stages = re.search(r"int sort_stages\(bool kv\) \{ return kv \? (\d) : "
                       r"(\d); \}", RADIX_CU)
    assert (k7.sort_stages(True), k7.sort_stages(False)) == \
        (int(stages[1]), int(stages[2])) == (2, 3)
    block = RADIX_THREADS
    while block <= MAX_RADIX_BLOCK:
        warps = k7.sort_geometry(block)[0] // 32
        for bits in (4, 8):
            for kv in (False, True):
                smem = k7.sort_smem(block, bits, kv)
                assert smem == 4 * (block * ((2 if kv else 3) + kv)
                                    + (1 << bits) * (2 * warps + 1)
                                    + 32 + 8) <= SMEM_BYTES
        block *= 2
    assert k7.sort_smem(MAX_RADIX_BLOCK, 8, False) == \
        k7.sort_smem(MAX_RADIX_BLOCK, 8, True) == 230_560
    assert k7.sort_grid(2048, 132, 1) == 132
    assert k7.sort_grid(100, 132, 1) == 100
    assert k7.sort_grid(65536, 132, 0) == 132
    assert k7.sort_grid(65536, 132, 7) == 924


def _popc(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") for v in x])


def emulate_block_sort(keys, vals, *, shift, block, bits, grid):
    """K7 as csrc/radix.cu runs it, in numpy: `grid` resident thread blocks
    walk the blocks p = b, b + grid, ...; warp w holds keys w 32 KPT +
    32 e + l (slot e, lane l) and ranks them slot by slot: a slot whose 32
    digits are equal takes every lane as a peer (tested first and after a
    slot of one group only), else each lane ORs its bit into its digit's
    match word and reads it back; the highest peer
    advances the warp's count of the digit (the count before is the
    group's base) and clears the word. Then the (digit, warp) table's
    digit-major exclusive scan gives each run its start, the gaps give the
    histogram, and key i lands at start + rank. Asserts that every match
    word is zero after every slot and that every block writes each slot
    once."""
    kv = vals is not None
    threads, kpt = k7.sort_geometry(block)
    nw, radix = threads // 32, 1 << bits
    nblocks = keys.size // block
    out_k = np.empty_like(keys)
    out_v = np.empty_like(vals) if kv else None
    hist = np.zeros((nblocks, radix), np.int32)
    lanes = np.arange(32)
    lower = (np.uint64(1) << lanes.astype(np.uint64)) - np.uint64(1)
    for b in range(grid):
        tab = np.zeros((radix, nw), np.int64)  # zeroed once, then by p
        match = np.zeros((nw, radix), np.uint64)
        for p in range(b, nblocks, grid):
            blk = keys[p * block:(p + 1) * block]
            digit = ((blk >> np.uint32(shift)) & np.uint32(radix - 1)
                     ).astype(np.int64)
            rank = np.empty(block, np.int64)
            for w in range(nw):
                seg = digit[w * 32 * kpt:(w + 1) * 32 * kpt].reshape(kpt, 32)
                tested = True  # first, or after a slot of one group
                for e in range(kpt):
                    d = seg[e]
                    one = tested and (d == d[0]).all()
                    if one:
                        peers = np.full(32, 0xFFFFFFFF, np.uint64)
                    else:
                        for lane in lanes:
                            match[w, d[lane]] |= np.uint64(1 << lane)
                        peers = match[w, d]
                    tested = bool((peers == 0xFFFFFFFF).all())
                    top = np.array([int(x).bit_length() - 1 for x in peers])
                    prior = tab[d, w].copy()
                    leaders = lanes == top
                    tab[d[leaders], w] += _popc(peers[leaders])
                    if not one:
                        match[w, d[leaders]] = 0
                    assert not match.any()
                    rank[w * 32 * kpt + 32 * e + lanes] = \
                        prior + _popc(peers & lower)
            flat = tab.reshape(-1)
            start = (np.cumsum(flat) - flat).reshape(radix, nw)
            hist[p] = tab.sum(axis=1)
            pos = start[digit, np.arange(block) // (32 * kpt)] + rank
            assert np.array_equal(np.sort(pos), np.arange(block))
            out_k[p * block + pos] = blk
            if kv:
                out_v[p * block + pos] = vals[p * block:(p + 1) * block]
            tab[:] = 0
    return (out_k, out_v, hist) if kv else (out_k, hist)


def _k7_keys(kind: str, n: int, shift: int, seed: int) -> np.ndarray:
    keys = _keys(seed, n=n)
    if kind == "one digit":  # every lane of every slot a peer
        keys = (keys & ~np.uint32(0xFF << shift)) | np.uint32(0x2A << shift)
    elif kind == "two digits":  # ~16 peers a lane: queued ORs
        keys = (keys & ~np.uint32(0xFE << shift)) | np.uint32(0x2A << shift)
    elif kind == "all equal":
        keys = np.full(n, 0x12345978, np.uint32)
    return keys


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "one digit", "two digits",
                                  "all equal"])
@pytest.mark.parametrize("block", [512, 2048])
def test_block_sort_emulation_matches_plain_and_jax(block, kind, key_value):
    """The warp-by-warp emulation of K7 at 4-bit digits, 5 blocks on a grid
    of 2 (a block count no multiple of the grid), bitwise equal to the
    plain version and to the Pallas block sort in interpret mode."""
    shift, n = 4, 5 * block
    keys = _k7_keys(kind, n, shift, seed=block + len(kind) + key_value)
    vals = _vals(block + 3, n=n)
    cfg = SortConfig(block=block, digit_bits=4)
    got = emulate_block_sort(keys, vals if key_value else None, shift=shift,
                             block=block, bits=4, grid=2)
    plain = k7.block_sort_plain(torch.from_numpy(keys),
                                torch.from_numpy(vals) if key_value
                                else None, shift=shift, config=cfg,
                                key_value=key_value)
    jcfg = JaxConfig(block=block, flush_rows=4, interpret=True)
    want = jax_block_sort(_tile(keys, 0xFFFFFFFF),
                          _tile(vals, 0) if key_value else None,
                          shift=shift, config=jcfg, key_value=key_value,
                          interpret=True)
    for g, p_, w in zip(got[:-1], plain[:-1], want[:-1]):
        np.testing.assert_array_equal(g, p_.numpy())
        np.testing.assert_array_equal(g, _flat(w))
    np.testing.assert_array_equal(got[-1], plain[-1].numpy())
    np.testing.assert_array_equal(got[-1], np.asarray(want[-1])[:, :16])


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "one digit", "two digits",
                                  "all equal"])
def test_block_sort_emulation_8bit_matches_plain(kind, key_value):
    """The emulation at 8-bit digits (the main path's radix; the Pallas
    kernel's histogram rows hold 128 lanes, so plain only), block 2048, 3
    blocks on a grid of 2, at the top digit."""
    shift, block, n = 24, 2048, 3 * 2048
    keys = _k7_keys(kind, n, shift, seed=31 + len(kind))
    vals = _vals(41, n=n)
    cfg = SortConfig(block=block, digit_bits=8)
    got = emulate_block_sort(keys, vals if key_value else None, shift=shift,
                             block=block, bits=8, grid=2)
    plain = k7.block_sort_plain(torch.from_numpy(keys),
                                torch.from_numpy(vals) if key_value
                                else None, shift=shift, config=cfg,
                                key_value=key_value)
    for g, p_ in zip(got, plain):
        np.testing.assert_array_equal(g, p_.numpy())
