"""The port's network kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of `vulkan_radix_sort_tpu_torch.ops.bitonic_kernels`
runs its kernel's plain PyTorch version; the JAX side runs the Pallas kernel
in interpret mode, as `tests/test_bitonic.py` does. Same numpy-seeded
inputs, same chunk size C; tolerance: bitwise equality (all data is
integer). In the stable carry only keys and values are compared: the
tiebreak word's encoding differs (plain index here, packed idx<<7|origin
in the JAX package). The 64-bit key carries W3 (hi, lo, v) and W4_BIG
(hi, lo, idx, v) encode every word alike on both sides, so every array is
compared. The CUDA kernels themselves are held against their plain
versions on the card in `test_torch_cuda.py` and `chip_smoke.py`.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.ops import bitonic as jbit
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, MIN_CHUNK)
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.utils import timing

C = 1 << 10
NP2 = 1 << 12
LANES = 128

MODES = {
    "keys": (bk.KEYS, jbit.MODE_KEYS),
    "pairs": (bk.PAIRS, jbit.MODE_PAIRS),
    "stable": (bk.STABLE, jbit.MODE_PACKED),
    "w3": (bk.W3, jbit.MODE_W3),
    "w4_big": (bk.W4_BIG, jbit.MODE_W4_BIG),
}


def _data(mode_name: str, seed: int, n: int = NP2):
    """(port buffers, JAX arrays, indices of the arrays to compare)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if mode_name != "keys":  # duplicates, so the second word decides
        k %= np.uint32(7)
        k[::11] = 0xFFFFFFFF
    idx = np.arange(n, dtype=np.uint32)
    if mode_name in ("w3", "w4_big"):  # few (hi, lo): the third word decides
        lo = rng.integers(0, 3, NP2).astype(np.uint32)
        lo[::13] = 0xFFFFFFFF
        third = v if mode_name == "w3" else idx
        if mode_name == "w4_big":  # a tail of tied (max, max, pad) tuples
            k, lo, third = k.copy(), lo.copy(), third.copy()
            k[-NP2 // 8:] = lo[-NP2 // 8:] = 0xFFFFFFFF
            third[-NP2 // 8:] = tbit.STABLE_PAD_IDX
        arrs = [k, lo, third] + ([v] if mode_name == "w4_big" else [])
        return ([torch.from_numpy(a.copy()) for a in arrs],
                [jnp.asarray(a.reshape(-1, LANES)) for a in arrs],
                list(range(len(arrs))))
    port = {"keys": [k], "pairs": [k, v], "stable": [k, idx, v]}[mode_name]
    jax_ = {"keys": [k], "pairs": [k, v],
            "stable": [k, idx << np.uint32(7), v]}[mode_name]
    cmp = {"keys": [0], "pairs": [0, 1], "stable": [0, 2]}[mode_name]
    return ([torch.from_numpy(a.copy()) for a in port],
            [jnp.asarray(a.reshape(-1, LANES)) for a in jax_], cmp)


def _port_call(kernel, arrs, mode, nunits, valid):
    if kernel == "chunk":
        bk.chunk(arrs, mode, C, nunits, valid)
    elif kernel == "fused":
        bk.fused(arrs, mode, C, 1, 1, nunits, valid)
    elif kernel == "cross":
        bk.cross(arrs, mode, C, 1, 0, 1, nunits, valid)
    else:
        bk.local(arrs, mode, C, 1, nunits, valid)


def _jax_call(kernel, arrs, mode, real_rows, valid):
    if kernel == "chunk":
        return jbit._run_chunk(arrs, C, mode, True, real_rows, valid)
    if kernel == "fused":
        return jbit._run_fused_rounds(arrs, C, 1, 1, mode, True, real_rows,
                                      valid)
    if kernel == "cross":
        return jbit._run_cross(arrs, C, 1, mode, True, real_rows, valid)
    return jbit._run_local(arrs, C, 1, mode, True, real_rows, valid)


UNIT = {"chunk": C, "fused": 2 * C, "cross": 2 * C, "local": C}  # per flag


@pytest.mark.parametrize("variant", ["full", "clip", "gate"])
@pytest.mark.parametrize("kernel", ["chunk", "fused", "cross", "local"])
@pytest.mark.parametrize("mode_name", list(MODES))
def test_kernel_matches_jax(mode_name, kernel, variant):
    """K1-K4 (and K5 in the gate variant) bitwise equal to the Pallas
    kernels: full grid, a grid clipped to the genuine prefix (real_rows),
    and a validity mask with zeros."""
    mode, jmode = MODES[mode_name]
    seed = 10 * list(UNIT).index(kernel) + ["full", "clip", "gate"].index(
        variant)
    port, jarrs, cmp = _data(mode_name, seed=seed)
    units = NP2 // UNIT[kernel]
    nunits, real_rows, valid = units, None, None
    if variant == "clip":
        nunits = units - 1
        real_rows = nunits * UNIT[kernel] // LANES
    elif variant == "gate":
        flags = np.ones(units, np.int32)
        flags[1::2] = 0
        valid = flags
        real_rows = NP2 // LANES  # the BlockSpec path with the SMEM gate
    _port_call(kernel, port, mode, nunits,
               None if valid is None else torch.from_numpy(valid))
    out = _jax_call(kernel, jarrs, jmode, real_rows,
                    None if valid is None else jnp.asarray(valid))
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


@pytest.mark.parametrize("variant", ["full", "gate"])
@pytest.mark.parametrize("kernel", ["chunk", "local"])
@pytest.mark.parametrize("mode_name", list(MODES))
def test_min_chunk_matches_jax(mode_name, kernel, variant):
    """K1 and K4 at the smallest chunk (256, where a block of the register
    kernels is one warp) bitwise equal to the Pallas kernels, without and
    with a validity mask."""
    mode, jmode = MODES[mode_name]
    c = MIN_CHUNK
    port, jarrs, cmp = _data(mode_name, seed=40 + 2 * (kernel == "local")
                             + (variant == "gate"))
    units = NP2 // c
    valid = None
    if variant == "gate":
        valid = np.ones(units, np.int32)
        valid[::3] = 0
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    if kernel == "chunk":
        bk.chunk(port, mode, c, units, tv)
        out = jbit._run_chunk(jarrs, c, jmode, True, NP2 // LANES, jv)
    else:
        bk.local(port, mode, c, 2, units, tv)
        out = jbit._run_local(jarrs, c, 2, jmode, True, NP2 // LANES, jv)
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


@pytest.mark.parametrize("kernel", ["chunk", "local", "local_gated",
                                    "fused"])
@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_register_kernel_geometry(mode, kernel):
    """Every chunk the config admits (MIN_CHUNK to the carry's register
    cap), and every fused group (two MIN_CHUNK chunks to the cap), gives a
    block of
    one warp to 1024 threads that holds it exactly, with a whole number of
    16-byte vectors per thread and array, and every merge stage reachable
    by registers, lanes, or layout B's registers and lanes (csrc/bitonic.cu,
    Regs: log2 of the elements at most 2 log2 E + 10)."""
    fused = kernel == "fused"
    c = 2 * MIN_CHUNK if fused else MIN_CHUNK
    while c <= mode.reg_cap:
        threads, per = bk.block_geometry(kernel, mode, c)
        assert 32 <= threads <= 1024 and threads & (threads - 1) == 0
        assert threads * per == c and per % 4 == 0
        assert bk.log2(c) <= 2 * bk.log2(per) + 10
        c *= 2
    chunk = CHUNK_KEYS if mode is bk.KEYS else CHUNK_CARRY
    if fused:  # the main path's group: four chunks, two for the 64-bit
        group = chunk << tbit._fused_rounds(chunk, 10, mode)  # carries
        assert group == mode.reg_cap
        assert bk.block_geometry(kernel, mode, group) == {
            "keys": (1024, 32), "pairs": (1024, 16), "stable": (512, 32),
            "w3": (512, 16), "w4_big": (1024, 8)}[mode.name]
    elif kernel == "chunk" and mode.words == 3:  # csrc/wide.cuh
        assert bk.block_geometry(kernel, mode, chunk) == (256, 16)
    else:
        assert bk.block_geometry(kernel, mode, chunk) == (
            512, 16 if mode.words == 1 else 8)


def test_register_kernel_geometry_refuses_tile_kernels():
    """The cross kernel is the one left with a shared-memory tile."""
    with pytest.raises(ValueError):
        bk.block_geometry("cross", bk.KEYS, C)


def test_unaligned_buffer_is_refused():
    """The vector loads need 16-byte aligned buffers: an offset view is
    refused before any launch, an aligned one passes."""
    k = torch.zeros(NP2 + 4, dtype=torch.int32).view(torch.uint32)
    bk.check_aligned([k, k[4:]])
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="aligned"):
            bk.check_aligned([k, k[off:]])


@pytest.mark.parametrize("mode_name", ["keys", "stable", "w3"])
def test_fused_two_rounds_matches_jax(mode_name):
    """K2 over rounds 1..2: one group of 4 chunks holds the whole input."""
    mode, jmode = MODES[mode_name]
    port, jarrs, cmp = _data(mode_name, seed=5)
    bk.fused(port, mode, C, 1, 2, 1)
    out = jbit._run_fused_rounds(jarrs, C, 1, 2, jmode, True)
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


@pytest.mark.parametrize("mode_name", list(MODES))
def test_fused_from_round_two_matches_jax(mode_name):
    """K2 over round 2 alone (r_lo = r_hi = 2: its one phase enters at
    depth log2 C + 1 and ends on the group's parity), bitwise equal to the
    Pallas kernel."""
    mode, jmode = MODES[mode_name]
    port, jarrs, cmp = _data(mode_name, seed=15)
    bk.fused(port, mode, C, 2, 2, 1)
    out = jbit._run_fused_rounds(jarrs, C, 2, 2, jmode, True)
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


def _cross_span_cases():
    """(mode name, spans of one round): round 2 as one span or two, in
    three carries; and each 32-bit carry's deepest span (its
    `Mode.cross_cap`), alone and split in two."""
    cases = []
    for name in ("keys", "pairs", "w4_big"):
        cases += [pytest.param(name, [(1, 1), (0, 1)], id=f"{name}-spans0"),
                  pytest.param(name, [(0, 2)], id=f"{name}-spans1")]
    for name in ("keys", "pairs", "stable"):
        cap = MODES[name][0].cross_cap
        half = cap // 2
        cases += [pytest.param(name, [(0, cap)], id=f"{name}-deepest"),
                  pytest.param(name, [(half, cap - half), (0, half)],
                               id=f"{name}-deepest-split")]
    return cases


@pytest.mark.parametrize("mode_name,spans", _cross_span_cases())
def test_cross_spans_match_jax(mode_name, spans):
    """A round's cross stages, as one span or as several launches, equal
    the JAX cross kernel's single pass: round 2 at C = 1024, and the
    carry's deepest span on one group of chunks of 256."""
    mode, jmode = MODES[mode_name]
    r = sum(s for _, s in spans)
    c = C if r == 2 else MIN_CHUNK
    port, jarrs, cmp = _data(mode_name, seed=6, n=c << r)
    for t_lo, span in spans:
        bk.cross(port, mode, c, r, t_lo, span, 1)
    out = jbit._run_cross(jarrs, c, r, jmode, True)
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


SPLITS = {6: [(3, 3), (1, 2), (0, 1)], 8: [(4, 4), (1, 3), (0, 1)],
          10: [(6, 4), (3, 3), (1, 2), (0, 1)]}


@pytest.mark.parametrize("mode,r", [
    *(pytest.param(m, 6, id=m.name) for m in bk.MODES),
    *(pytest.param(m, m.cross_cap, id=f"{m.name}-deepest")
      for m in (bk.KEYS, bk.PAIRS, bk.STABLE))])
def test_cross_span_split_is_exact(mode, r):
    """Splitting a round's cross stages into spans of any size leaves the
    result unchanged (port only; larger rounds than the JAX tests run,
    up to the 32-bit carries' deepest span)."""
    rng = np.random.default_rng(7)
    n = 256 << r
    arrs = [torch.from_numpy(
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) % 97)
        for _ in range(mode.n_arrays)]
    ref = [a.clone() for a in arrs]
    bk.cross(ref, mode, 256, r, 0, r, 1)
    for t_lo, span in SPLITS[r]:
        bk.cross(arrs, mode, 256, r, t_lo, span, 1)
    for a, b in zip(arrs, ref):
        assert torch.equal(a, b)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    port, _, _ = _data("keys", seed=8)
    want = [a.clone() for a in port]
    bk.run_plain(bk.spec("chunk", C), want, bk.KEYS, NP2 // C)
    with timing.LaunchTimer() as timer:
        bk.chunk(port, bk.KEYS, C, NP2 // C)
    assert torch.equal(port[0], want[0])
    # one plain stand-in, recorded without events: no kernel launch
    assert [r["names"] for r in timer.records] == [["chunk"]]
    assert all(r["events"] is None for r in timer.records)


def test_wrapper_rejects_bad_buffers():
    k = torch.zeros(NP2, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(TypeError):
        bk.chunk([k.view(torch.int32)], bk.KEYS, C, 1)
    with pytest.raises(ValueError):
        bk.chunk([k, k[:-1]], bk.PAIRS, C, 1)
    with pytest.raises(ValueError):  # more units than elements
        bk.chunk([k], bk.KEYS, C, NP2 // C + 1)
    with pytest.raises(ValueError):  # stable tile over the smem cap
        big = torch.zeros(1 << 15, dtype=torch.int32).view(torch.uint32)
        bk.chunk([big, big.clone(), big.clone()], bk.STABLE, 1 << 15, 1)
    w = torch.zeros(1 << 14, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):  # a W4_BIG chunk over its 2^13 cap
        bk.chunk([w.clone() for _ in range(4)], bk.W4_BIG, 1 << 14, 1)
    with pytest.raises(ValueError, match="register"):  # W3: registers
        bk.fused([w.clone() for _ in range(3)], bk.W3, 1 << 13, 1, 1, 1)
    with pytest.raises(ValueError, match="register"):
        tbit.sort_pairs_w64(w, w, w, chunk=1 << 14, stable=False)
    bk.cross([w.clone() for _ in range(3)], bk.W3, 1 << 13, 1, 0, 1, 1)
    with pytest.raises(ValueError):  # valid must be int32
        bk.chunk([k], bk.KEYS, C, 1, torch.ones(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        bk.spec("cross", C, 2, 1, 2)  # span past the round
    meta = torch.empty(NP2, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):
        bk.chunk([meta], bk.KEYS, C, 1)


def test_smem_caps():
    assert bk.KEYS.smem_cap == 1 << 15
    assert bk.PAIRS.smem_cap == 1 << 14
    assert bk.STABLE.smem_cap == 1 << 14
    assert bk.W3.smem_cap == 1 << 14
    assert bk.W4_BIG.smem_cap == 1 << 13
    # chunks and fused groups: W3 stops below its shared-memory cap
    assert [m.reg_cap for m in bk.MODES] == [1 << 15, 1 << 14, 1 << 14,
                                             1 << 13, 1 << 13]
    # cross spans: registers in the 32-bit carries, shared memory in W3
    # and W4_BIG (a 64-element-wide tile)
    assert [m.cross_cap for m in bk.MODES] == [10, 8, 8, 8, 7]
    for mode in bk.MODES:
        for r in range(1, 20):  # every round of a 2^25 sort, and more
            spans = tbit._cross_spans(r, mode)
            assert sum(s for _, s in spans) == r
            assert all(s <= mode.cross_cap for _, s in spans)
            assert [t for t, _ in spans] == sorted(
                (t for t, _ in spans), reverse=True)


def _cuh_constant(name: str) -> int:
    src = (Path(bk.__file__).parents[1] / "csrc" / "bitonic.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_cross_geometry_mirrors_the_cuda_source():
    """The span cap's inputs are the constants bitonic.cuh builds with:
    kColsVec columns and kColsWordsCompared compared words a thread (the
    32-bit carries' cap is twice the log2 of the span positions that
    leaves) and kLogCrossW, the three-word tile's width."""
    assert _cuh_constant("kColsVec") == bk.COLS_VEC
    assert _cuh_constant("kColsWordsCompared") == bk.COLS_WORDS_COMPARED
    assert _cuh_constant("kLogCrossW") == bk.LOG_CROSS_W
    for mode in bk.MODES:
        rows = bk.COLS_WORDS_COMPARED // (bk.COLS_VEC * mode.words)
        want = (2 * bk.log2(rows) if mode.words < 3 else
                bk.log2(mode.smem_cap) - bk.LOG_CROSS_W)
        assert mode.cross_cap == want


@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_cross_span_over_the_cap_raises(mode):
    """A span at the cap runs; one past it is refused before any launch."""
    cap = mode.cross_cap
    arrs = [torch.zeros(256 << (cap + 1), dtype=torch.int32)
            .view(torch.uint32) for _ in range(mode.n_arrays)]
    bk.cross(arrs, mode, 256, cap, 0, cap, 2)
    with pytest.raises(ValueError, match="cap"):
        bk.cross(arrs, mode, 256, cap + 1, 0, cap + 1, 1)
