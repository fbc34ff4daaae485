"""The port's reference backend (`ops/reference.py`) against the JAX
package's.

Its one entry, `sort`, is held bitwise: on uint32 keys, alone and with
values, with `count=` and without, against
`vulkan_radix_sort_tpu.ops.reference` on JAX's CPU backend; on uint64
keys against numpy's stable argsort of the encoded words; and uint64,
int64 and float64 keys through the Sorter against the JAX Sorter's 'xla'
backend under `jax.enable_x64()`. The inputs are numpy-seeded and
adversarial: all-equal keys, keys at the sign boundary, genuine maximum
keys inside the `count=` range, count 0, 1, n - 1 and n, int64 min and
max, and float64 +-0.0, +-inf and NaNs of both signs. A profiler case
shows that a sort is one `aten::sort` of the keys' own width and gathers
no keys. Tolerance: bitwise equality of the bit patterns.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vulkan_radix_sort_tpu as jvrs
from vulkan_radix_sort_tpu.ops import reference as jref
import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.ops import reference
from vulkan_radix_sort_tpu_torch.utils import datagen

N = 1000 + 37
MAX32 = np.uint32(0xFFFFFFFF)
MAX64 = np.uint64(2**64 - 1)
SIGN64 = np.uint64(1 << 63)
CASES = ("uniform", "equal", "sign", "max", "few")


def _counts(n):
    return (0, 1, n // 2, n - 1, n)


def _keys32(case, n=N, seed=0) -> np.ndarray:
    """uint32 keys: uniform; all equal; packed around the sign bit
    (0x7FFFFFFF / 0x80000000 and their neighbours, 0, max); uniform with
    every 7th key and a run at the front the maximum; four distinct."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if case == "equal":
        k[:] = k[0]
    elif case == "sign":
        k = rng.choice(np.array([0x7FFFFFFE, 0x7FFFFFFF, 0x80000000,
                                 0x80000001, 0, 0xFFFFFFFF], np.uint32), n)
    elif case == "max":
        k[::7] = MAX32
        k[:5] = MAX32
    elif case == "few":
        k = rng.choice(k[:4], n)
    return k


def _keys64(case, n=N, seed=1) -> np.ndarray:
    """uint64 keys (the encoded words `sort` takes), the same
    cases one width up; `sign` also holds the encodings of int64 min and
    max (0 and 2^64 - 1)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    if case == "equal":
        k[:] = k[0]
    elif case == "sign":
        k = rng.choice(np.array([SIGN64 - np.uint64(2), SIGN64 - np.uint64(1),
                                 SIGN64, SIGN64 + np.uint64(1), 0, MAX64],
                                np.uint64), n)
    elif case == "max":
        k[::7] = MAX64
        k[:5] = MAX64
    elif case == "few":
        k = rng.choice(k[:4], n)
    return k


def _vals(n=N, seed=2) -> np.ndarray:
    return datagen.generate_values(n, seed=seed)


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype.itemsize == want.dtype.itemsize
    width = np.uint64 if want.dtype.itemsize == 8 else np.uint32
    np.testing.assert_array_equal(got.numpy().view(width), want.view(width))


@pytest.mark.parametrize("case", CASES)
def test_sort_keys_and_pairs_match_jax(case):
    k, v = _keys32(case), _vals()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    _eq(reference.sort(tk), jref.sort_keys(jnp.asarray(k)))
    gk, gv = reference.sort(tk, tv)
    wk, wv = jref.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    _eq(gk, wk)
    _eq(gv, wv)


@pytest.mark.parametrize("count", _counts(N))
@pytest.mark.parametrize("case", CASES)
def test_count_forms_match_jax(case, count):
    """Sort only the first `count`; the tail stays untouched, and the
    masked tail stays behind every genuine 0xFFFFFFFF key of the range."""
    k, v = _keys32(case), _vals()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    cnt = torch.tensor(count)
    _eq(reference.sort(tk, count=cnt),
        jref.sort_keys_count(jnp.asarray(k), count))
    gk, gv = reference.sort(tk, tv, count=cnt)
    wk, wv = jref.sort_pairs_count(jnp.asarray(k), jnp.asarray(v), count)
    _eq(gk, wk)
    _eq(gv, wv)


@pytest.mark.parametrize("count", (None,) + _counts(N))
@pytest.mark.parametrize("case", CASES)
def test_64_bit_functions_match_numpy(case, count):
    """`sort` of uint64 keys, alone and with values, against numpy's
    stable argsort of the words; with count=, the first `count` sorted and
    the tails untouched."""
    k, v = _keys64(case), _vals()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    m = N if count is None else count
    o = np.argsort(k[:m], kind="stable")
    wk = np.concatenate([k[:m][o], k[m:]])
    wv = np.concatenate([v[:m][o], v[m:]])
    cnt = None if count is None else torch.tensor(count)
    gk = reference.sort(tk, count=cnt)
    pk, pv = reference.sort(tk, tv, count=cnt)
    _eq(gk, wk)
    _eq(pk, wk)
    _eq(pv, wv)


def _wide_keys(dtype) -> np.ndarray:
    """int64 keys with int64 min and max, -1 and 0 among duplicates; or
    float64 keys with +-0.0, +-inf and NaNs of both signs."""
    rng = np.random.default_rng(3)
    if dtype == torch.float64:
        k = rng.standard_normal(N) * 1e300
        k[::11] = np.resize([0.0, -0.0, np.inf, -np.inf, np.nan,
                             np.copysign(np.nan, -1)], len(k[::11]))
        return k
    k = rng.integers(-2**63, 2**63, N, dtype=np.int64)
    k[::9] = np.iinfo(np.int64).min
    k[1::9] = np.iinfo(np.int64).max
    k[2::9] = -1
    k[3::9] = 0
    return k


@pytest.mark.parametrize("count", (None, 0, 1, N - 1, N))
@pytest.mark.parametrize("dtype", (torch.uint64, torch.int64, torch.float64),
                         ids=str)
def test_sorter64_matches_jax_xla(dtype, count):
    """uint64, int64 and float64 keys through the port's Sorter on the
    reference backend and the JAX Sorter on 'xla' under x64: keys and
    stable kv, with count= or without (float64 in IEEE total order)."""
    k = (_keys64("max") if dtype == torch.uint64 else _wide_keys(dtype))
    v = _vals()
    port = vrs.Sorter(N, key_dtype=dtype, device="cpu",
                      config=SortConfig(backend="reference"))
    cnt = None if count is None else torch.tensor(count)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    gk = port.sort(tk, count=cnt)
    pk, pv = port.sort_key_value(tk, tv, count=cnt)
    with jax.enable_x64():
        jdt = {torch.uint64: jnp.uint64, torch.int64: jnp.int64,
               torch.float64: jnp.float64}[dtype]
        jax_ = jvrs.Sorter(N, key_dtype=jdt,
                           config=jvrs.SortConfig(backend="xla"))
        wk = np.asarray(jax_.sort(jnp.asarray(k), count=count))
        qk, qv = map(np.asarray, jax_.sort_key_value(
            jnp.asarray(k), jnp.asarray(v), count=count))
    _eq(gk, wk)
    _eq(pk, qk)
    _eq(pv, qv)
    if dtype == torch.int64:  # numpy's order is the int64 order
        m = N if count is None else count
        o = np.argsort(k[:m], kind="stable")
        _eq(pk, np.concatenate([k[:m][o], k[m:]]))
        _eq(pv, np.concatenate([v[:m][o], v[m:]]))


def _trace(fn, *args, path):
    """The aten ops fn(*args) runs on the CPU, from torch.profiler's
    exported trace: (name, start, end, input dims, input types)."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn(*args)
    prof.export_chrome_trace(str(path))
    return [(e["name"], e["ts"], e["ts"] + e["dur"],
             e["args"].get("Input Dims") or [],
             e["args"].get("Input type") or [])
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]


GATHERS = {"aten::index", "aten::gather", "aten::take",
           "aten::index_select"}


@pytest.mark.parametrize("width,gathers", [
    ("int", 0), ("int", 1), ("long int", 0), ("long int", 1)],
    ids=["keys32", "kv32", "keys64", "kv64"])
def test_one_sort_no_widening_no_key_gather(width, gathers, tmp_path):
    """torch.profiler on the CPU: `sort` runs exactly one `aten::sort`, of
    the keys at their own width (int32 for uint32 keys, int64 for
    uint64), and one gather in a pair sort, of the int32 values, none in
    a keys sort. A keys sort of uint32 keys: no op outside the sort's own
    body takes an int64 tensor of n elements (no widening; the sort's
    indices go unused)."""
    n = 4096
    k = torch.from_numpy(_keys32("uniform", n) if width == "int"
                         else _keys64("uniform", n))
    args = (k,) if gathers == 0 else (k, torch.from_numpy(_vals(n)))
    ops = _trace(reference.sort, *args, path=tmp_path / "trace.json")
    sorts = [op for op in ops if op[0] == "aten::sort"]
    assert len(sorts) == 1
    _, t0, t1, dims, types = sorts[0]
    assert dims[0] == [n] and types[0] == width
    outside = [op for op in ops if not t0 <= op[1] <= op[2] <= t1]
    taken = [op for op in outside if op[0] in GATHERS]
    assert len(taken) == gathers
    assert all(op[4][0] == "int" and op[3][0] == [n] for op in taken)
    if width == "int" and gathers == 0:
        wide = [op[0] for op in outside if any(
            d == [n] and t == "long int" for d, t in zip(op[3], op[4]))]
        assert wide == []


@pytest.mark.parametrize("key_value", [False, True])
def test_storage_requirements_reference(key_value):
    """The reference backend's estimate for 32-bit keys: the flipped int32
    view, torch.sort's values and int64 indices, the output keys, and
    for key-value the gathered values; no int64 copy of the keys."""
    for max_n in (1, 1000, (1 << 20) + 1):
        s = vrs.Sorter(max_n, device="cpu",
                       config=SortConfig(backend="reference"))
        assert s.storage_requirements(key_value) == max_n * (
            4 + 4 + 8 + 4 + (4 if key_value else 0))
