"""The adaptive fast paths (SortConfig(adaptive=True)) against the JAX
package's.

The cases of `tests/test_adaptive.py`, each held bitwise against the JAX
package's adaptive Sorter on the same numpy-seeded input and against
numpy: `backend="xla"` on the JAX side where every backend gives the same
bits (keys, stable key-value), and `backend="network", interpret=True` at
n <= 2048 for the non-stable key-value order and the adaptive-off case.
The port runs on the CPU (the kernels' plain versions). A
`timing.LaunchTimer` shows which inputs took a fast path: those record no
kernel launch, the rest launch the engine. Tolerance: bitwise equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulkan_radix_sort_tpu as jvrs
from vulkan_radix_sort_tpu.utils.datagen import generate_keys, generate_values
import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch import config as tconfig
from vulkan_radix_sort_tpu_torch.config import SortConfig, config_from_jax
from vulkan_radix_sort_tpu_torch.utils import timing

N = 4096
N_NETWORK = 2048  # JAX network in interpret mode
JAX_XLA = jvrs.SortConfig(backend="xla", adaptive=True)
JAX_NET = jvrs.SortConfig(backend="network", interpret=True, adaptive=True)


def _port(n, backend="network", dtype=torch.uint32, adaptive=True):
    return vrs.Sorter(n, key_dtype=dtype, device="cpu",
                      config=SortConfig(backend=backend, adaptive=adaptive))


def _launches(fn):
    with timing.LaunchTimer() as t:
        out = fn()
    return out, len(t.records)


@pytest.mark.parametrize("backend", ["network", "reference"])
@pytest.mark.parametrize("dist",
                         ["sorted", "reverse", "constant", "uniform", "few"])
def test_adaptive_keys(dist, backend):
    keys = generate_keys(N, seed=3, distribution=dist)
    out, launched = _launches(lambda: _port(N, backend).sort(
        torch.from_numpy(keys)))
    want = np.asarray(jvrs.Sorter(N, config=JAX_XLA).sort(jnp.asarray(keys)))
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(want, np.sort(keys))
    fast = dist in ("sorted", "reverse", "constant")
    if backend == "network":
        assert (launched == 0) == fast, (dist, launched)


@pytest.mark.parametrize("dist", ["sorted", "uniform", "few"])
def test_adaptive_kv_stable(dist):
    keys = generate_keys(N, seed=4, distribution=dist)
    if dist == "sorted":
        # duplicate keys, so that the identity path's stability is
        # load-bearing, not vacuous
        keys = np.sort(keys >> np.uint32(20))
    vals = generate_values(N, seed=5)
    (gk, gv), launched = _launches(lambda: _port(N).sort_key_value(
        torch.from_numpy(keys), torch.from_numpy(vals)))
    wk, wv = jvrs.Sorter(N, config=JAX_XLA).sort_key_value(
        jnp.asarray(keys), jnp.asarray(vals))
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(gk.numpy(), np.asarray(wk))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gk.numpy(), keys[order])
    assert np.array_equal(gv.numpy(), vals[order])
    assert (launched == 0) == (dist == "sorted")


def test_adaptive_kv_reverse_not_flipped():
    # reverse-sorted keys with duplicates: the pairs path takes no flip (it
    # would reverse equal-key ties), the engine answers
    keys = np.sort(generate_keys(N, seed=6) >> np.uint32(20))[::-1].copy()
    vals = generate_values(N, seed=7)
    (gk, gv), launched = _launches(lambda: _port(N).sort_key_value(
        torch.from_numpy(keys), torch.from_numpy(vals)))
    wk, wv = jvrs.Sorter(N, config=JAX_XLA).sort_key_value(
        jnp.asarray(keys), jnp.asarray(vals))
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(gk.numpy(), np.asarray(wk))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gv.numpy(), vals[order])
    assert launched > 0


@pytest.mark.parametrize("dist", ["sorted", "uniform"])
def test_adaptive_kv_nonstable(dist):
    """stable=False against the JAX network's (key, value) order: the
    identity on sorted keys (input order among ties), the engine's
    value-ascending ties otherwise."""
    keys = generate_keys(N_NETWORK, seed=11, distribution=dist) >> np.uint32(
        22)
    vals = generate_values(N_NETWORK, seed=12)
    (gk, gv), launched = _launches(lambda: _port(N_NETWORK).sort_key_value(
        torch.from_numpy(keys), torch.from_numpy(vals), stable=False))
    wk, wv = jvrs.Sorter(N_NETWORK, config=JAX_NET).sort_key_value(
        jnp.asarray(keys), jnp.asarray(vals), stable=False)
    assert np.array_equal(gk.numpy(), np.asarray(wk))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert (launched == 0) == (dist == "sorted")


@pytest.mark.parametrize("dist", ["sorted", "reverse", "uniform"])
def test_adaptive_keys_u64(dist):
    lo = generate_keys(N, seed=8, distribution=dist).astype(np.uint64)
    hi = generate_keys(N, seed=9, distribution=dist).astype(np.uint64)
    keys = (hi << np.uint64(32)) | lo
    if dist == "sorted":
        keys = np.sort(keys)
    elif dist == "reverse":
        keys = np.sort(keys)[::-1].copy()
    out, launched = _launches(lambda: _port(N, dtype=torch.uint64).sort(
        torch.from_numpy(keys)))
    with jax.enable_x64(True):
        want = np.asarray(jvrs.Sorter(N, key_dtype=jnp.uint64,
                                      config=JAX_XLA).sort(jnp.asarray(keys)))
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(want, np.sort(keys))
    assert (launched == 0) == (dist != "uniform")


def test_adaptive_float_sorted():
    # the order-preserving encoding: non-decreasing floats (negatives
    # included) are found sorted in encoded space
    f = np.sort(np.random.default_rng(0).standard_normal(N).astype(
        np.float32))
    out, launched = _launches(lambda: _port(N, dtype=torch.float32).sort(
        torch.from_numpy(f)))
    want = np.asarray(jvrs.Sorter(N, key_dtype=jnp.float32,
                                  config=JAX_XLA).sort(jnp.asarray(f)))
    assert np.array_equal(out.numpy().view(np.uint32), want.view(np.uint32))
    assert launched == 0


def test_adaptive_off_unchanged():
    # adaptive=False runs the engine on a sorted input, bitwise the same
    keys = np.sort(generate_keys(N_NETWORK, seed=10))
    cfg = dataclasses.replace(JAX_NET, adaptive=False)
    out, launched = _launches(lambda: _port(N_NETWORK, adaptive=False).sort(
        torch.from_numpy(keys)))
    want = np.asarray(jvrs.Sorter(N_NETWORK, config=cfg).sort(
        jnp.asarray(keys)))
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(want, keys)
    assert launched > 0


def test_adaptive_skips_count_paths():
    """count= never takes a fast path: the engine runs on sorted keys."""
    keys = np.sort(generate_keys(N, seed=13))
    cnt = N - 100
    out, launched = _launches(lambda: _port(N).sort(torch.from_numpy(keys),
                                                    count=cnt))
    want = np.asarray(jvrs.Sorter(N, config=JAX_XLA).sort(
        jnp.asarray(keys), count=cnt))
    assert np.array_equal(out.numpy(), want)
    assert launched > 0


def test_adaptive_returns_new_tensors():
    """The identity path hands back copies, never the caller's tensors."""
    keys = torch.arange(100, dtype=torch.int32).view(torch.uint32)
    vals = torch.arange(100, dtype=torch.int32).view(torch.uint32)
    s = _port(100)
    out = s.sort(keys)
    k, v = s.sort_key_value(keys, vals)
    for a in (out, k, v):
        assert a.data_ptr() not in (keys.data_ptr(), vals.data_ptr())
    out[0] = 7
    assert keys[0] == 0


def test_adaptive_config(monkeypatch):
    """adaptive=True is accepted and carried across from a JAX config;
    default_config reads VRS_ADAPTIVE once, at its first call."""
    assert config_from_jax(dataclasses.asdict(JAX_XLA)) == SortConfig(
        backend="reference", adaptive=True)
    monkeypatch.setenv("VRS_ADAPTIVE", "1")
    tconfig.default_config.cache_clear()
    try:
        assert tconfig.default_config().adaptive
        monkeypatch.setenv("VRS_ADAPTIVE", "0")
        assert tconfig.default_config().adaptive  # read once
        assert vrs.Sorter(8, device="cpu").config.adaptive
    finally:
        tconfig.default_config.cache_clear()
    monkeypatch.delenv("VRS_ADAPTIVE")
    assert not tconfig.default_config().adaptive
