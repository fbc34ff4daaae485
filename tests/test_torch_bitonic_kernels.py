"""The port's network kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of `vulkan_radix_sort_tpu_torch.ops.bitonic_kernels`
runs its kernel's plain PyTorch version; the JAX side runs the Pallas kernel
in interpret mode, as `tests/test_bitonic.py` does. Same numpy-seeded
inputs, same chunk size C; tolerance: bitwise equality (all data is
integer). In the stable carry only keys and values are compared: the
tiebreak word's encoding differs (plain index here, packed idx<<7|origin
in the JAX package). The CUDA kernels themselves are held against their
plain versions on the card in `test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.ops import bitonic as jbit
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, MIN_CHUNK)
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk

C = 1 << 10
NP2 = 1 << 12
LANES = 128

MODES = {
    "keys": (bk.KEYS, jbit.MODE_KEYS),
    "pairs": (bk.PAIRS, jbit.MODE_PAIRS),
    "stable": (bk.STABLE, jbit.MODE_PACKED),
}


def _data(mode_name: str, seed: int):
    """(port buffers, JAX arrays, indices of the arrays to compare)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, NP2, dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 2**32, NP2, dtype=np.uint64).astype(np.uint32)
    if mode_name != "keys":  # duplicates, so the second word decides
        k %= np.uint32(7)
        k[::11] = 0xFFFFFFFF
    idx = np.arange(NP2, dtype=np.uint32)
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
@pytest.mark.parametrize("mode_name", ["keys", "pairs", "stable"])
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
@pytest.mark.parametrize("mode_name", ["keys", "pairs", "stable"])
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
    """Every chunk the config admits (MIN_CHUNK to the carry's cap), and
    every fused group (two MIN_CHUNK chunks to the cap), gives a block of
    one warp to 1024 threads that holds it exactly, with a whole number of
    16-byte vectors per thread and array, and every merge stage reachable
    by registers, lanes, or layout B's registers and lanes (csrc/bitonic.cu,
    Regs: log2 of the elements at most 2 log2 E + 10)."""
    fused = kernel == "fused"
    c = 2 * MIN_CHUNK if fused else MIN_CHUNK
    while c <= mode.smem_cap:
        threads, per = bk.block_geometry(kernel, mode, c)
        assert 32 <= threads <= 1024 and threads & (threads - 1) == 0
        assert threads * per == c and per % 4 == 0
        assert bk.log2(c) <= 2 * bk.log2(per) + 10
        c *= 2
    chunk = CHUNK_KEYS if mode is bk.KEYS else CHUNK_CARRY
    if fused:  # the main path's group of four chunks, the carry's cap
        assert bk.block_geometry(kernel, mode, 4 * chunk) == {
            "keys": (1024, 32), "pairs": (1024, 16),
            "stable": (512, 32)}[mode.name]
    else:
        assert bk.block_geometry(kernel, mode, chunk) == (512, 16 //
                                                         mode.words)


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


@pytest.mark.parametrize("mode_name", ["keys", "stable"])
def test_fused_two_rounds_matches_jax(mode_name):
    """K2 over rounds 1..2: one group of 4 chunks holds the whole input."""
    mode, jmode = MODES[mode_name]
    port, jarrs, cmp = _data(mode_name, seed=5)
    bk.fused(port, mode, C, 1, 2, 1)
    out = jbit._run_fused_rounds(jarrs, C, 1, 2, jmode, True)
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


@pytest.mark.parametrize("mode_name", ["keys", "pairs", "stable"])
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


@pytest.mark.parametrize("spans", [[(1, 1), (0, 1)], [(0, 2)]])
@pytest.mark.parametrize("mode_name", ["keys", "pairs"])
def test_cross_spans_match_jax(mode_name, spans):
    """Round 2's two cross stages, as one span or as two launches, equal
    the JAX cross kernel's single pass."""
    mode, jmode = MODES[mode_name]
    port, jarrs, cmp = _data(mode_name, seed=6)
    for t_lo, span in spans:
        bk.cross(port, mode, C, 2, t_lo, span, 1)
    out = jbit._run_cross(jarrs, C, 2, jmode, True)
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))


@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_cross_span_split_is_exact(mode):
    """Splitting a round's cross stages into spans of any size leaves the
    result unchanged (port only; a larger round than the JAX tests run)."""
    rng = np.random.default_rng(7)
    n = 1 << 14
    arrs = [torch.from_numpy(
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) % 97)
        for _ in range(mode.n_arrays)]
    ref = [a.clone() for a in arrs]
    bk.cross(ref, mode, 256, 6, 0, 6, 1)
    for t_lo, span in [(3, 3), (1, 2), (0, 1)]:
        bk.cross(arrs, mode, 256, 6, t_lo, span, 1)
    for a, b in zip(arrs, ref):
        assert torch.equal(a, b)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    bk.reset_launches()
    port, _, _ = _data("keys", seed=8)
    want = [a.clone() for a in port]
    bk.run_plain(bk.spec("chunk", C), want, bk.KEYS, NP2 // C)
    bk.chunk(port, bk.KEYS, C, NP2 // C)
    assert torch.equal(port[0], want[0])
    assert all(v == 0 for v in bk.launches.values())


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
    for mode in bk.MODES:
        for r in range(1, 20):
            spans = tbit._cross_spans(r, mode)
            assert sum(s for _, s in spans) == r
            assert all(bk.CROSS_W << s <= mode.smem_cap for _, s in spans)
            assert [t for t, _ in spans] == sorted(
                (t for t, _ in spans), reverse=True)
