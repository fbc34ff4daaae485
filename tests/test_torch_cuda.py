"""The port on an NVIDIA card: each CUDA kernel against its plain version,
and the sort and the Sorter, network and radix, against numpy oracles.

Every test here is marked `cuda` and skips with a reason on a host without
a card (decided in the fixture, never at import). The file imports neither
JAX nor the JAX package, so it also runs where they are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bitwise equality (all data is integer or compared as bits).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, MIN_CHUNK, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
from vulkan_radix_sort_tpu_torch.parallel import distributed as td
from vulkan_radix_sort_tpu_torch.utils import datagen


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _u32(n, seed, mod=None):
    k = np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if mod is not None:
        k %= np.uint32(mod)
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_cuda_kernels_match_plain(cuda_device, mode):
    """Each CUDA kernel bitwise equal to its plain version on the card,
    with and without a validity mask, including a two-span cross round."""
    rng = np.random.default_rng(9)
    n = 1 << 18
    C = CHUNK_KEYS if mode is bk.KEYS else CHUNK_CARRY
    r = bk.log2(n // C)
    cases = [bk.spec("chunk", C), bk.spec("local", C, r),
             bk.spec("fused", C, 1, 2), bk.spec("cross", C, r, 0, r),
             bk.spec("cross", C, r, 1, r - 1)]
    for launch in cases:
        units = n // launch.unit
        flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
        for valid in (None, flags.to(cuda_device)):
            a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 1000))
                 .to(cuda_device) for _ in range(mode.n_arrays)]
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units, valid)
            bk.run_plain(launch, b, mode, units, valid)
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _chunk_cases():
    """(mode, C) for every chunk the config admits in every carry."""
    cases = []
    for mode in bk.MODES:
        c = MIN_CHUNK
        while c <= mode.smem_cap:
            cases.append(pytest.param(mode, c, id=f"{mode.name}-{c}"))
            c *= 2
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode,C", _chunk_cases())
def test_cuda_register_kernels_every_chunk(cuda_device, mode, C):
    """K1 and K4 bitwise equal to their plain versions at every chunk, whose
    register and thread geometry changes with C, with and without a
    validity mask; the stable carry's riding values under tied tuples stay
    put."""
    rng = np.random.default_rng(C + mode.code)
    n = 1 << 18
    units = n // C
    flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
    for launch in (bk.spec("chunk", C), bk.spec("local", C, 1)):
        for valid in (None, flags.to(cuda_device)):
            a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 50))
                 .to(cuda_device) for _ in range(mode.n_arrays)]
            if mode is bk.STABLE:  # a tail of tied (max, pad) tuples
                a[0].view(torch.int32)[n // 2:] = -1
                a[1].view(torch.int32)[n // 2:] = 0x7FFFFFFF
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units, valid)
            bk.run_plain(launch, b, mode, units, valid)
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _fused_cases():
    """(mode, G) for every group the fused kernel takes: two MIN_CHUNK
    chunks up to the carry's cap."""
    cases = []
    for mode in bk.MODES:
        g = 2 * MIN_CHUNK
        while g <= mode.smem_cap:
            cases.append(pytest.param(mode, g, id=f"{mode.name}-{g}"))
            g *= 2
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode,G", _fused_cases())
def test_cuda_fused_every_group(cuda_device, mode, G):
    """K2 bitwise equal to its plain version at every group size, whose
    register and thread geometry changes with G: groups of 256-chunks and
    of two chunks, from round 1 and from the last round alone, with and
    without a validity mask, the stable carry's riding values under tied
    tuples staying put."""
    rng = np.random.default_rng(G + mode.code)
    n = 1 << 18
    units = n // G
    flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
    launches = []
    for C in sorted({MIN_CHUNK, G // 2}):
        r_hi = bk.log2(G // C)
        launches += [bk.spec("fused", C, r_lo, r_hi)
                     for r_lo in sorted({1, r_hi})]
    for launch in launches:
        for valid in (None, flags.to(cuda_device)):
            a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 50))
                 .to(cuda_device) for _ in range(mode.n_arrays)]
            if mode is bk.STABLE:  # a tail of tied (max, pad) tuples
                a[0].view(torch.int32)[n // 2:] = -1
                a[1].view(torch.int32)[n // 2:] = 0x7FFFFFFF
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units, valid)
            bk.run_plain(launch, b, mode, units, valid)
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [512 << i for i in range(6)])
def test_cuda_block_sort_every_block(cuda_device, block, bits):
    """K7 bitwise equal to its plain version at every block size, whose
    thread geometry changes with the block, at both digit widths: uniform
    keys, five distinct keys, and keys that differ everywhere but in the
    digit (every lane of a warp a peer), keys and kv, at the lowest and
    the highest shift, with a last block closed by sentinel pads."""
    cfg = SortConfig(backend="radix", digit_bits=bits, block=block)
    rng = np.random.default_rng(block + bits)
    n = 1 << 18
    for kind in ("uniform", "few", "one digit"):
        for shift in (0, 32 - bits):
            keys = _u32(n, int(rng.integers(1 << 30)))
            if kind == "few":
                keys = rng.choice(keys[:5], n)
            elif kind == "one digit":
                digit = np.uint32(((1 << bits) - 1) << shift)
                keys = (keys & ~digit) | np.uint32(5 << shift)
            keys[-777:] = 0xFFFFFFFF
            dk = torch.from_numpy(keys).to(cuda_device)
            dv = torch.from_numpy(_u32(n, shift)).to(cuda_device)
            for kv in (False, True):
                vals = dv if kv else None
                want = k7.block_sort_plain(dk, vals, shift=shift, config=cfg,
                                           key_value=kv)
                got = k7.block_sort(dk, vals, shift=shift, config=cfg,
                                    key_value=kv)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), (kind, shift, kv)


@pytest.mark.cuda
def test_cuda_unaligned_buffer_is_refused(cuda_device):
    k = torch.zeros(1 << 12, dtype=torch.int32,
                    device=cuda_device).view(torch.uint32)
    with pytest.raises(ValueError, match="aligned"):
        bk.local([k[1:1 + 2048]], bk.KEYS, 1024, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        bk.fused([k[1:1 + 2048]], bk.KEYS, 256, 1, 3, 1)
    with pytest.raises(ValueError, match="aligned"):
        k7.block_sort(k[1:1 + 2048], shift=0,
                      config=SortConfig(backend="radix", block=512))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, (1 << 20) + 77])
def test_cuda_sort_matches_numpy(cuda_device, n):
    keys, vals = _u32(n, 3, 61), _u32(n, 4)
    keys[::10] = 0xFFFFFFFF
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    np.testing.assert_array_equal(tbit.sort_u32(dk).cpu().numpy(),
                                  np.sort(keys))
    _, gv = tbit.sort_pairs_u32(dk, dv)
    np.testing.assert_array_equal(gv.cpu().numpy(),
                                  vals[np.argsort(keys, kind="stable")])
    _, gv = tbit.sort_pairs_u32(dk, dv, stable=False)
    np.testing.assert_array_equal(gv.cpu().numpy(),
                                  vals[np.lexsort((vals, keys))])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32],
                         ids=str)
def test_cuda_sorter_matches_numpy(cuda_device, dtype):
    n = (1 << 18) + 5
    if dtype == torch.float32:
        k = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    else:
        k = _u32(n, 9, 1 << 9).view(
            np.uint32 if dtype == torch.uint32 else np.int32)
    v = datagen.generate_values(n, seed=10)
    s = vrs.Sorter(n, key_dtype=dtype)
    assert s.backend == "network"
    dk = torch.from_numpy(k).to(cuda_device)
    dv = torch.from_numpy(v).to(cuda_device)
    got = s.sort(dk).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sort(k).view(np.uint32))
    m = n - 999
    _, gv = s.sort_key_value(dk, dv, count=torch.tensor(m,
                                                        device=cuda_device))
    order = np.argsort(k[:m], kind="stable")
    np.testing.assert_array_equal(gv.cpu().numpy()[:m], v[:m][order])
    np.testing.assert_array_equal(gv.cpu().numpy()[m:], v[m:])


@pytest.mark.cuda
@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_radix_kernels_match_plain(cuda_device, bits, key_value):
    """K7 and K8 bitwise equal to their plain versions on the card at every
    shift of a sort, with few distinct digits and a last block closed by
    sentinel pads; each launch is counted."""
    cfg = SortConfig(backend="radix", digit_bits=bits)
    n = 1 << 18
    keys = _u32(n, bits + 10 * key_value, 1 << 12)
    keys[-777:] = 0xFFFFFFFF
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(_u32(n, 5)).to(cuda_device) if key_value else None
    k7.reset_launches()
    k8.reset_launches()
    for p in range(cfg.num_passes):
        kw = dict(shift=p * bits, config=cfg, key_value=key_value)
        got = k7.block_sort(dk, dv, **kw)
        want = k7.block_sort_plain(dk, dv, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        hist = want[-1]
        args = (want[0], hist, radix._spine(hist),
                want[1] if key_value else None)
        got = k8.stream_place(*args, config=cfg, key_value=key_value)
        want = k8.stream_place_plain(*args, config=cfg, key_value=key_value)
        torch.cuda.synchronize()
        for a, b in zip(*((got, want) if key_value else ((got,), (want,)))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert k7.launches["block_sort"] == k8.launches["place"] == \
        cfg.num_passes


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [1000, (1 << 20) + 77])
def test_cuda_radix_sort_matches_numpy(cuda_device, n, bits):
    cfg = SortConfig(backend="radix", digit_bits=bits)
    keys, vals = _u32(n, 3, 61), _u32(n, 4)
    keys[::10] = 0xFFFFFFFF
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    np.testing.assert_array_equal(radix.sort_u32(dk, config=cfg).cpu().numpy(),
                                  np.sort(keys))
    gk, gv = radix.sort_pairs_u32(dk, dv, config=cfg)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])


@pytest.mark.cuda
def test_cuda_radix_stage_times(cuda_device):
    keys = torch.from_numpy(_u32(1 << 20, 8)).to(cuda_device)
    t = radix.stage_times(keys, SortConfig(backend="radix"), iters=2)
    assert all(t["per_pass"][k] > 0 for k in ("upsweep", "spine",
                                               "downsweep"))
    assert t["upsweep"] == 4 * t["per_pass"]["upsweep"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32],
                         ids=str)
def test_cuda_radix_sorter_matches_numpy(cuda_device, dtype):
    """The Sorter with backend='radix': stable either way, count= on the
    device."""
    n = (1 << 18) + 5
    if dtype == torch.float32:
        k = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    else:
        k = _u32(n, 9, 1 << 9).view(
            np.uint32 if dtype == torch.uint32 else np.int32)
    v = datagen.generate_values(n, seed=10)
    s = vrs.Sorter(n, key_dtype=dtype, config=SortConfig(backend="radix"))
    dk = torch.from_numpy(k).to(cuda_device)
    dv = torch.from_numpy(v).to(cuda_device)
    np.testing.assert_array_equal(s.sort(dk).cpu().numpy().view(np.uint32),
                                  np.sort(k).view(np.uint32))
    m = n - 999
    order = np.argsort(k[:m], kind="stable")
    for stable in (True, False):
        _, gv = s.sort_key_value(dk, dv, stable=stable,
                                 count=torch.tensor(m, device=cuda_device))
        np.testing.assert_array_equal(gv.cpu().numpy()[:m], v[:m][order])
        np.testing.assert_array_equal(gv.cpu().numpy()[m:], v[m:])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_cuda_local_gated_matches_plain(cuda_device, mode):
    """K6 bitwise equal to its plain version under a mask with zeros; it
    counts as local_gated, never as a K5 gate launch."""
    rng = np.random.default_rng(12)
    n, C, r = 1 << 20, CHUNK_CARRY, 3
    units = n // C
    valid = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32)).to(
        cuda_device)
    a = [torch.from_numpy(_u32(n, 20 + i, 1000)).to(cuda_device)
         for i in range(mode.n_arrays)]
    b = [x.clone() for x in a]
    bk.reset_launches()
    bk.local_gated(a, mode, C, r, units, valid)
    bk.run_plain(bk.spec("local_gated", C, r), b, mode, units, valid)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert bk.launches["local_gated"] == 1 and bk.launches["gate"] == 0


@pytest.mark.cuda
def test_cuda_merge_slots_match_numpy(cuda_device):
    """The slot merges on the card: 8 slots of 2^16 with empty, full and
    mid-block slots and genuine 0xFFFFFFFF keys, keys and stable kv."""
    rng = np.random.default_rng(13)
    n_slots, slot = 8, 1 << 16
    sizes = rng.integers(0, slot + 1, n_slots)
    sizes[[1, 2, 4, 7]] = [0, slot, 0, slot]
    kbuf = np.full((n_slots, slot), 0xFFFFFFFF, np.uint32)
    vbuf = np.zeros((n_slots, slot), np.uint32)
    runs = []
    for s, size in enumerate(sizes):
        k = _u32(size, 30 + s, 100)
        k[::7] = 0xFFFFFFFF
        kbuf[s, :size] = np.sort(k)
        vbuf[s, :size] = np.arange(size) + s * slot
        runs.append(s * slot + np.arange(size))
    flat = np.concatenate(runs)
    allk, allv = kbuf.reshape(-1)[flat], vbuf.reshape(-1)[flat]
    order = np.argsort(allk, kind="stable")
    dk = torch.from_numpy(kbuf.reshape(-1)).to(cuda_device)
    dv = torch.from_numpy(vbuf.reshape(-1)).to(cuda_device)
    ds = torch.from_numpy(sizes).to(cuda_device)
    got = tbit.merge_slots_u32(dk, ds, slot=slot).cpu().numpy()
    np.testing.assert_array_equal(got[:flat.size], allk[order])
    gk, gv = tbit.merge_slots_pairs(dk, dv, ds, slot=slot)
    np.testing.assert_array_equal(gk.cpu().numpy()[:flat.size], allk[order])
    np.testing.assert_array_equal(gv.cpu().numpy()[:flat.size], allv[order])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_cuda_sort_sharded_single_rank(cuda_device, backend, tmp_path):
    """sort_sharded / sort_pairs_sharded on a world of one rank on the
    card (the NCCL branch's only run on one card), with count=."""
    n = (1 << 20) + 3
    keys, vals = _u32(n, 14, 1 << 12), _u32(n, 15)
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    c = n - 777
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got = td.sort_sharded(dk, count=torch.tensor(c, device=cuda_device))
        gk, gv = td.sort_pairs_sharded(dk, dv, merge_resort=True)
    finally:
        dist.destroy_process_group()
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[:c], np.sort(keys[:c]))
    np.testing.assert_array_equal(got[c:], keys[c:])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])
