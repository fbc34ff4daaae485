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

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
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
