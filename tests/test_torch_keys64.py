"""The port's 64-bit key sorts against the JAX package's.

uint64, int64 and float64 keys sort as (hi, lo) uint32 words: keys-only
through the (k, v) carry, key-value through W3 (non-stable) and W4_BIG
(stable). The port's `Sorter(device="cpu", backend="network")` runs the
network with each kernel's plain version; the JAX side is its
`Sorter(backend="network", interpret=True)` under `jax.enable_x64()`, as in
`tests/test_keys64.py`, with the same chunk (256) so that the chunk, fused,
cross and local passes all run. Inputs are numpy-seeded, with hi-word
ties, duplicate keys, genuine 2^64 - 1 keys and, for float64, +-0.0,
+-inf and NaNs of both signs. Tolerance: bitwise equality of the bit
patterns; the order is that of the encoded words (IEEE total order for
float64), not np.sort's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulkan_radix_sort_tpu as jvrs
from vulkan_radix_sort_tpu.ops import bitonic as jbit
from vulkan_radix_sort_tpu.ops import bitops as jbitops
import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import SortConfig, config_from_jax
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import bitops, radix
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

CHUNK = 256
N = (1 << 11) + 11
MAX64 = np.uint64(2**64 - 1)

DTYPES = {  # torch dtype -> (jnp dtype, numpy dtype), carried across
    torch.uint64: (jnp.uint64, np.uint64),
    torch.int64: (jnp.int64, np.int64),
    torch.float64: (jnp.float64, np.float64),
}


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64():
        yield


def _keys(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.float64:
        k = rng.standard_normal(n) * 1e300
        k[::13] = k[::7][: len(k[::13])]  # duplicates
        k[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, np.copysign(np.nan, -1)]
        return k
    u = rng.integers(0, 2**64, n, dtype=np.uint64)
    q = n // 4
    u[:q] = (u[:q] & np.uint64(0xFFFFFFFF)) | np.uint64(0xDEADBEEF << 32)
    u[q:2 * q] = rng.choice(u[:8], q)  # whole-key duplicates
    u[::17] = MAX64
    return u.view(DTYPES[dtype][1])


def _pair(dtype, backend="network"):
    port = vrs.Sorter(4096, key_dtype=dtype, device="cpu",
                      config=SortConfig(backend=backend, chunk=CHUNK))
    jcfg = jvrs.SortConfig(backend=backend, chunk=CHUNK, interpret=True)
    if backend == "reference":
        jcfg = jvrs.SortConfig(backend="xla")
    assert config_from_jax(dataclasses.asdict(jcfg)) == port.config or \
        backend == "reference"
    return port, jvrs.Sorter(4096, key_dtype=DTYPES[dtype][0], config=jcfg)


def _eq(got: torch.Tensor, want):
    width = np.uint64 if got.element_size() == 8 else np.uint32
    np.testing.assert_array_equal(got.numpy().view(width),
                                  np.asarray(want).view(width))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_encoders64_match_jax(dtype):
    """encode, split into words, merge and decode, bitwise as the JAX
    package's on every special value."""
    k = _keys(dtype, n=300, seed=1)
    jenc, jdec = jbitops.ENCODERS64[jnp.dtype(DTYPES[dtype][0])]
    enc, dec = bitops.ENCODERS64[dtype]
    u = enc(torch.from_numpy(k))
    ju = jenc(jnp.asarray(k))
    _eq(u, ju)
    hi, lo = bitops.split_u64(u)
    jhi, jlo = jbitops.split_u64(ju)
    _eq(hi, jhi)
    _eq(lo, jlo)
    _eq(bitops.merge_u64(hi, lo), ju)
    _eq(dec(u), jdec(ju))
    _eq(dec(u), k)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_sort64_matches_jax(dtype):
    port, jax_ = _pair(dtype)
    k = _keys(dtype, seed=2)
    _eq(port.sort(torch.from_numpy(k)), jax_.sort(jnp.asarray(k)))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_sort_key_value64_matches_jax(dtype, stable):
    """W4_BIG (stable) and W3 (non-stable: equal keys by ascending value)
    against the JAX package's W4 and W3 sorts."""
    port, jax_ = _pair(dtype)
    k = _keys(dtype, seed=3)
    v = datagen.generate_values(N, seed=4)
    v[::5] = v[0]  # tied (key, value) pairs among the duplicate keys
    gk, gv = port.sort_key_value(torch.from_numpy(k), torch.from_numpy(v),
                                 stable=stable)
    wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v),
                                 stable=stable)
    _eq(gk, wk)
    _eq(gv, wv)


@pytest.mark.parametrize("path", ["keys", "stable", "nonstable"])
def test_count64_matches_jax(path):
    """count= (a tensor) on the keys path and both key-value paths: the
    prefix sorted, the tails untouched, genuine 2^64 - 1 keys inside the
    prefix."""
    port, jax_ = _pair(torch.uint64)
    k = _keys(torch.uint64, seed=5)
    v = datagen.generate_values(N, seed=6)
    count = 1500
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if path == "keys":
        got = port.sort(tk, count=torch.tensor(count))
        _eq(got, jax_.sort(jnp.asarray(k), count=count))
        _eq(got[count:], k[count:])
        return
    stable = path == "stable"
    gk, gv = port.sort_key_value(tk, tv, count=torch.tensor(count),
                                 stable=stable)
    wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v), count=count,
                                 stable=stable)
    _eq(gk, wk)
    _eq(gv, wv)
    _eq(gk[count:], k[count:])
    _eq(gv[count:], v[count:])


@pytest.mark.parametrize("stable", [True, False])
def test_sort_pairs_w64_matches_jax(stable, monkeypatch):
    """`bitonic.sort_pairs_w64` on (hi, lo) words against the JAX
    function, at a ragged n (2^12 + 3: the genuine boundary sits in the
    last round's first group) with the fused rounds turned off, so every
    round runs cross and local under the group-granularity skip rule; and
    again with count= on keys (and, non-stable, values) masked past it,
    as the Sorter masks them: the masked tail's values are tied there and
    their order is not part of the result (the Sorter restores the tail),
    so the prefix is compared."""
    monkeypatch.setattr(tbit, "MAX_FUSED_ELEMS", CHUNK)
    n = (1 << 12) + 3
    u = _keys(torch.uint64, n=n, seed=7)
    hi, lo = [np.array(w) for w in jbitops.split_u64(jnp.asarray(u))]
    v = datagen.generate_values(n, seed=8)
    timer = timing.LaunchTimer()
    for count in (None, n - 700):
        if count is not None:  # the caller's mask: the maximum past count
            hi, lo = hi.copy(), lo.copy()
            hi[count:] = lo[count:] = 0xFFFFFFFF
            if not stable:
                v = v.copy()
                v[count:] = 0xFFFFFFFF
        with timer:
            got = tbit.sort_pairs_w64(*map(torch.from_numpy, (hi, lo, v)),
                                      count, chunk=CHUNK, stable=stable)
        with jax.enable_x64(False):
            want = jbit.sort_pairs_w64.__wrapped__(
                *map(jnp.asarray, (hi, lo, v)), count, chunk=CHUNK,
                interpret=True, stable=stable)
        m = n if count is None else count  # past count: tied, unspecified
        for g, w in zip(got, want):
            _eq(g[:m], np.asarray(w)[:m])
    # plain versions only: every record without events
    assert timer.records
    assert all(r["events"] is None for r in timer.records)


def test_reference_backend64_matches_jax_xla():
    """The reference backend (torch.sort of the sign-flipped int64 view)
    against the JAX package's 'xla' backend: keys, stable key-value, and
    count= on both."""
    port, jax_ = _pair(torch.int64, backend="reference")
    assert (port.backend, port.backend_kv, port.backend_kvns) == (
        "reference",) * 3
    k = _keys(torch.int64, seed=9)
    v = datagen.generate_values(N, seed=10)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    _eq(port.sort(tk), jax_.sort(jnp.asarray(k)))
    _eq(port.sort(tk, count=torch.tensor(900)),
        jax_.sort(jnp.asarray(k), count=900))
    for count in (None, 900):
        cnt = None if count is None else torch.tensor(count)
        gk, gv = port.sort_key_value(tk, tv, count=cnt)
        wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v),
                                     count=count)
        _eq(gk, wk)
        _eq(gv, wv)


def test_module_functions64_match_jax():
    """The one-shot `sort` and `sort_key_value` take the keys' dtype."""
    k = _keys(torch.float64, seed=11)
    v = datagen.generate_values(N, seed=12)
    cfg = SortConfig(backend="network", chunk=CHUNK)
    jcfg = jvrs.SortConfig(backend="network", chunk=CHUNK, interpret=True)
    _eq(vrs.sort(torch.from_numpy(k), config=cfg),
        jvrs.sort(jnp.asarray(k), config=jcfg))
    gk, gv = vrs.sort_key_value(torch.from_numpy(k), torch.from_numpy(v),
                                config=cfg)
    wk, wv = jvrs.sort_key_value(jnp.asarray(k), jnp.asarray(v), config=jcfg)
    _eq(gk, wk)
    _eq(gv, wv)


@pytest.mark.parametrize("max_n", [1, 1000, (1 << 20) + 1])
@pytest.mark.parametrize("key_value", [False, True])
def test_storage_requirements64_match_jax(max_n, key_value):
    for backend in ("network", "reference"):
        port = vrs.Sorter(max_n, key_dtype=torch.uint64, device="cpu",
                          config=SortConfig(backend=backend))
        jax_ = jvrs.Sorter(max_n, key_dtype=jnp.uint64, config=jvrs.SortConfig(
            backend="xla" if backend == "reference" else backend))
        assert port.storage_requirements(key_value) == \
            jax_.storage_requirements(key_value)


def test_radix_refuses_64_bit_keys():
    """What the radix backend (and its alias) refuses of 64-bit keys: an
    end_bit on int64 or float64 keys, which have no unsigned bits to
    order (ValueError); it sorts all three dtypes whole, bitwise as the
    JAX package's reference sort does, and 'auto' on the CPU takes the
    reference backend."""
    for dtype in DTYPES:
        keys = _keys(dtype, radix.MIN_RADIX_N + 5)
        tk = torch.from_numpy(keys)
        want = jvrs.Sorter(keys.size, key_dtype=DTYPES[dtype][0],
                           config=jvrs.SortConfig(backend="xla")).sort(
            jnp.asarray(keys))
        for backend in ("radix", "pallas"):
            s = vrs.Sorter(keys.size, key_dtype=dtype, device="cpu",
                           config=SortConfig(backend=backend))
            assert s.backend == "radix"
            _eq(s.sort(tk), want)
            if dtype != torch.uint64:
                with pytest.raises(ValueError, match="end_bit"):
                    s.sort(tk, end_bit=45)
        s = vrs.Sorter(16, key_dtype=dtype, device="cpu")
        assert (s.backend, s.backend_kv, s.backend_kvns) == (
            "reference",) * 3
