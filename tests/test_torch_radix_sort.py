"""The port's radix backend end to end on the CPU (each kernel's plain
version) against numpy and the JAX package.

The JAX package's radix tests stop at n = 2^13, below its `_MIN_PALLAS_N`
= 2^14, so they never reach its kernels. These tests sort at n >= 2^14,
where the port runs K7 and K8 (`radix.MIN_RADIX_N`), and hold the result
to numpy's stable sort; below 2^14 they hold the port's hand-off to the
reference backend to the JAX package's. Tolerance: bitwise equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu.config import SortConfig as JaxConfig
from vulkan_radix_sort_tpu.ops import radix as jax_radix
from vulkan_radix_sort_tpu_torch.config import RADIX_BLOCK, SortConfig
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

CONFIGS = {  # digit width -> a radix config at that width
    8: SortConfig(backend="radix"),
    4: SortConfig(backend="radix", digit_bits=4, block=1024),
}
M = radix.MIN_RADIX_N
DTYPES = {torch.uint32: np.uint32, torch.int32: np.int32,
          torch.float32: np.float32}


def _u32(n, seed, hi=2**32):
    return np.random.default_rng(seed).integers(
        0, hi, n, dtype=np.uint64).astype(np.uint32)


def _keys(dtype, n, seed):
    if dtype == torch.float32:
        k = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        k[::13] = k[::7][: len(k[::13])]  # duplicates
        k[::101] = -0.0
        return k
    k = _u32(n, seed, 1 << 9)  # many ties, so stability decides
    k[::17] = 0xFFFFFFFF
    return k.view(DTYPES[dtype])


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [M, M + 17, 3 * M])
def test_sort_matches_numpy(n, bits):
    """Keys and stable key-value, on a block multiple and off it, through
    every pass at both digit widths."""
    cfg = CONFIGS[bits]
    keys, vals = _u32(n, n + bits), _u32(n, n + 1)
    keys[1::3] = keys[::3][: len(keys[1::3])]  # ties
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    _eq(radix.sort(tk, config=cfg), np.sort(keys))
    gk, gv = radix.sort(tk, tv, config=cfg)
    order = np.argsort(keys, kind="stable")
    _eq(gk, keys[order])
    _eq(gv, vals[order])
    np.testing.assert_array_equal(tk.numpy(), keys)  # inputs untouched


@pytest.mark.parametrize("n", [1, 1000, M - 1])
def test_small_n_matches_jax(n):
    """Below 2^14 both packages hand the sort to their reference backend."""
    keys, vals = _u32(n, 5), _u32(n, 6)
    jcfg = JaxConfig(block=1024, flush_rows=4, interpret=True,
                     backend="pallas")
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    _eq(radix.sort(tk), np.asarray(jax_radix.sort_u32(
        jnp.asarray(keys), config=jcfg)))
    gk, gv = radix.sort(tk, tv)
    wk, wv = jax_radix.sort_pairs_u32(jnp.asarray(keys), jnp.asarray(vals),
                                      config=jcfg)
    _eq(gk, np.asarray(wk))
    _eq(gv, np.asarray(wv))


@pytest.mark.parametrize("bits", [8, 4])
def test_sentinel_keys_stay_ahead_of_pads(bits):
    """Genuine 0xFFFFFFFF keys in a ragged last block keep their input order
    ahead of the 0xFFFFFFFF pads, so their values survive the slice."""
    n = M + 5
    keys = _u32(n, 7)
    keys[::7] = 0xFFFFFFFF
    keys[-3:] = 0xFFFFFFFF
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = radix.sort(torch.from_numpy(keys), torch.from_numpy(vals),
                        config=CONFIGS[bits])
    order = np.argsort(keys, kind="stable")
    _eq(gk, keys[order])
    _eq(gv, vals[order])


@pytest.mark.parametrize("dist", ["zipf", "few", "constant", "reverse"])
def test_skewed_distributions(dist):
    n = M + 300
    keys = datagen.generate_keys(n, seed=11, distribution=dist)
    vals = datagen.generate_values(n, seed=12)
    gk, gv = radix.sort(torch.from_numpy(keys), torch.from_numpy(vals))
    order = np.argsort(keys, kind="stable")
    _eq(gk, keys[order])
    _eq(gv, vals[order])


@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_sorter_radix_matches_numpy(dtype):
    """The Sorter with backend='radix': sort, sort_key_value with both
    `stable` values (radix answers stable=False with the stable order), and
    count= as an int and as a tensor, for every key dtype."""
    n = M + 300
    keys = _keys(dtype, n, seed=13)
    vals = datagen.generate_values(n, seed=14)
    s = vrs.create_sorter(n, key_dtype=dtype, device="cpu", backend="radix")
    assert s.backend == "radix"
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    _eq(s.sort(tk), np.sort(keys))
    order = np.argsort(keys, kind="stable")
    for stable in (True, False):
        gk, gv = s.sort_key_value(tk, tv, stable=stable)
        _eq(gk, keys[order])
        _eq(gv, vals[order])
    count = n - 999
    o = np.argsort(keys[:count], kind="stable")
    for cnt in (count, torch.tensor(count)):
        want = keys.copy()
        want[:count] = np.sort(keys[:count])
        _eq(s.sort(tk, count=cnt), want)
        for stable in (True, False):
            gk, gv = s.sort_key_value(tk, tv, count=cnt, stable=stable)
            _eq(gk, np.concatenate([keys[:count][o], keys[count:]]))
            _eq(gv, np.concatenate([vals[:count][o], vals[count:]]))


def test_module_functions_route_to_radix():
    n = M + 1
    keys, vals = _u32(n, 15, 1 << 12), _u32(n, 16)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    for backend in ("radix", "pallas"):
        cfg = SortConfig(backend=backend)
        _eq(vrs.sort(tk, config=cfg), np.sort(keys))
        gk, gv = vrs.sort_key_value(tk, tv, config=cfg, stable=False)
        order = np.argsort(keys, kind="stable")
        _eq(gk, keys[order])
        _eq(gv, vals[order])


def test_stage_times_needs_a_card():
    """Stage times are device times: without a card they raise rather
    than time the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        radix.stage_times(torch.from_numpy(_u32(M, 19)), CONFIGS[8])


def test_cpu_sort_counts_no_launch():
    with timing.LaunchTimer() as timer:
        radix.sort(torch.from_numpy(_u32(M, 17)),
                   torch.from_numpy(_u32(M, 18)))
    # K7, the spine and K8 a pass, as plain stand-ins without events
    assert len(timer.records) == 3 * SortConfig().num_passes
    assert all(r["events"] is None for r in timer.records)


@pytest.mark.parametrize("max_n", [1, 4096, 5000, 1 << 20])
def test_storage_requirements_radix(max_n):
    """Two padded key buffers (and two value buffers), plus one pass's
    histogram and run offsets and the spine's two digit rows."""
    s = vrs.Sorter(max_n, device="cpu", config=SortConfig(backend="radix"))
    padded = -(-max_n // RADIX_BLOCK) * RADIX_BLOCK
    tables = 4 * (2 * (padded // RADIX_BLOCK) * 256 + 2 * 256)
    assert s.storage_requirements() == 4 * 2 * padded + tables
    assert s.storage_requirements(True) == 4 * 4 * padded + tables
    s4 = vrs.Sorter(max_n, device="cpu", config=CONFIGS[4])
    assert s4.storage_requirements() > 0
