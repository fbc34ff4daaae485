"""The port's bench harness, CLI and native engine binding, on the CPU.

Held against the JAX package's harness: the same sweep sizes, the same
CSV header and row format, and the same mt19937 stream from the native
engine. The correctness gate passes the port's card backends run on a
CPU device (the kernels' plain versions) and catches broken ones; the
host backends are measured; a card backend is never timed on the CPU.
The device timing calls the sort on the same unsorted input every time,
so an adaptive sorter runs the engine on every timed call (on the CPU
shown by the launch recorder). Tolerance: bitwise equality of sorted
output and exact CSV text.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from vulkan_radix_sort_tpu import native as jnative
from vulkan_radix_sort_tpu.bench import harness as jh
from vulkan_radix_sort_tpu_torch import native
from vulkan_radix_sort_tpu_torch.bench import __main__ as cli
from vulkan_radix_sort_tpu_torch.bench import harness
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

HAS_GXX = shutil.which("g++") is not None


@pytest.mark.parametrize("steps", [1, 2, 4, 7, 128, 1000])
def test_sweep_sizes_match_jax(steps):
    assert harness.sweep_sizes(steps) == jh.sweep_sizes(steps)
    assert harness.sweep_sizes(steps, 1 << 10, 1 << 14) == jh.sweep_sizes(
        steps, 1 << 10, 1 << 14)
    assert (harness.N_MIN, harness.N_MAX, harness.DEFAULT_STEPS) == (
        jh.N_MIN, jh.N_MAX, jh.DEFAULT_STEPS)


def test_csv_matches_jax_schema(tmp_path):
    res = [harness.measure(harness.make_backend("cpu"), 1 << 10, s, iters=2)
           for s in ("keys", "kv", "kvns")]
    ours, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
    harness.write_csv(str(ours), res)
    jh.write_csv(str(theirs), [jh.BenchResult(**dataclasses.asdict(r))
                               for r in res])
    a, b = ours.read_text().splitlines(), theirs.read_text().splitlines()
    assert a[0].startswith("# version: ") and b[0].startswith("# version: ")
    assert a[1:] == b[1:]
    assert a[1] == "backend,n,sort,gpu_ms,cpu_ms,gpu_gitems_s,cpu_gitems_s"
    assert [f.name for f in dataclasses.fields(harness.BenchResult)] == [
        f.name for f in dataclasses.fields(jh.BenchResult)]


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
@pytest.mark.parametrize("name", ["network", "radix", "reference", "xla"])
def test_gate_passes_port_backends_on_cpu(name, n):
    b = harness.make_backend(name, device="cpu")
    assert b.name == ("reference" if name == "xla" else name)
    harness.check_correctness(b, n, nonstable=True)
    harness.check_correctness(b, n, distribution="few", seed=3)


class _BadKeys(harness._SorterBackend):
    def sort(self, keys):
        out = super().sort(keys)
        out[0] ^= 1
        return out


class _BadPairs(harness._SorterBackend):
    def sort_key_value(self, keys, values, stable=True):
        k, v = super().sort_key_value(keys, values, stable)
        if not stable:
            v = v.copy()
            v[0] = v[1]  # breaks the pair multiset, keeps the keys
        return k, v


@pytest.mark.parametrize("bad", [_BadKeys, _BadPairs])
def test_gate_catches_bad_backend(bad):
    with pytest.raises(AssertionError):
        harness.check_correctness(bad("network", device="cpu"), 1 << 10,
                                  nonstable=True)


@pytest.mark.parametrize("name", ["cpu", "torch", "cpp"])
def test_measure_host_backends(name):
    if name == "cpp" and not HAS_GXX:
        pytest.skip("the native engine needs g++")
    b = harness.make_backend(name)
    harness.check_correctness(b, 1 << 12, nonstable=True)
    res = [harness.measure(b, 1 << 12, s, iters=2)
           for s in ("keys", "kv", "kvns")]
    assert [r.sort for r in res] == ["keys", "kv", "kvns"]
    assert all(r.backend == name and r.gpu_ms == r.cpu_ms > 0 for r in res)


@pytest.mark.parametrize("name", ["network", "radix", "reference"])
def test_measure_refuses_cpu_device(name):
    with pytest.raises(RuntimeError, match="CUDA device"):
        harness.measure(harness.make_backend(name, device="cpu"), 1 << 10,
                        "keys", iters=1)


@pytest.mark.parametrize("sort", ["keys", "kv"])
def test_timed_fn_resorts_the_same_input(sort):
    """Every call of the timed function sorts the same unsorted tensors:
    an adaptive sorter runs the engine each time, and the input stays as
    it was."""
    n = 1 << 10
    b = harness.make_backend("network", SortConfig(adaptive=True),
                             device="cpu")
    keys = datagen.generate_keys(n, seed=0)
    values = datagen.generate_keys(n, seed=1) if sort == "kv" else None
    fn, args = b.timed_fn(keys, values)
    before = [a.clone() for a in args]
    for _ in range(3):
        with timing.LaunchTimer() as t:
            fn(*args)
        assert sum(r["names"][0] == "chunk" for r in t.records) == 1
    for a, c in zip(args, before):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert not np.array_equal(np.sort(keys), keys)


def test_timed_fn_indirect_count():
    b = harness.make_backend("network", device="cpu")
    keys = datagen.generate_keys(1000, seed=2)
    fn, args = b.timed_fn(keys, keys, indirect=True, stable=False)
    k, _ = fn(*args)
    assert np.array_equal(k.numpy(), np.sort(keys))


def test_cli_refuses_card_backend_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["network", "--steps", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.print_stage_split("radix", steps=1, iters=1) == {}


@pytest.mark.skipif(not HAS_GXX, reason="the native engine needs g++")
def test_native_engine():
    k = datagen.generate_keys(5000, seed=4, distribution="few")
    v = np.arange(5000, dtype=np.uint32)
    assert np.array_equal(native.sort_u32(k), np.sort(k))
    sk, sv = native.sort_pairs_u32(k, v)
    order = np.argsort(k, kind="stable")
    assert np.array_equal(sk, k[order]) and np.array_equal(sv, v[order])
    buf, vb = k.copy(), v.copy()
    assert native.sort_pairs_u32_inplace(buf, vb)[0] is buf
    assert np.array_equal(buf, k[order]) and np.array_equal(vb, v[order])
    assert native.is_sorted_u32(buf) and not native.is_sorted_u32(k)
    with pytest.raises(TypeError):
        native.sort_u32_inplace(k.astype(np.int64))
    for bits in (32, 20, 0):
        assert np.array_equal(native.generate_uniform(777, seed=5, bits=bits),
                              jnative.generate_uniform(777, seed=5,
                                                       bits=bits))
    assert native.library()._name.startswith(str(native.BUILD_DIR))


@pytest.mark.skipif(not HAS_GXX, reason="the native engine needs g++")
def test_native_build_failure_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(bad, tmp_path / "out")
    assert not list((tmp_path / "out").iterdir())
