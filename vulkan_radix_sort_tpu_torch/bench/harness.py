"""Benchmark harness: sweep, timing, correctness gate, CSV.

Counterpart of `vulkan_radix_sort_tpu/bench/harness.py`, after the
reference benchmark's method (bench/bench.cc):
  - an N sweep from 2^18 to 2^25 in linear steps, keys-only and key-value
    each (bench.cc:15-20,168);
  - a correctness gate at the first size of the sweep: element-wise
    equality with the CPU oracle for keys and key-value (bench.cc:41-64,
    164-166), skippable with no_verify;
  - the CSV schema `backend,n,sort,gpu_ms,cpu_ms,gpu_gitems_s,cpu_gitems_s`
    with a `# version:` comment line (bench.cc:197-203), as the JAX
    package writes it, so `tools/plot_results.py` reads either.

Device backends (`network`, `radix`, `reference`; `xla` is an alias of
`reference`, as `config_from_jax` maps it) run the port's Sorter on a card
by default. `gpu_ms` is device time per sort from CUDA events (`time_fn`):
the sort is called on the same unsorted input every time, so an adaptive
sorter is timed on the input it was given, never on its own sorted output.
`cpu_ms` is the median host wall clock of one sort and a synchronize.
Host backends (`cpu`: numpy, the oracle; `cpp`: the native C++ engine;
`torch`: torch.sort on the host) have no device: both columns hold their
wall clock.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np
import torch

from .. import __version__
from ..config import SortConfig
from ..utils import datagen
from ..utils.timing import time_fn

N_MIN = 1 << 18  # reference bench.cc:17
N_MAX = 1 << 25  # reference bench.cc:18
DEFAULT_STEPS = 128  # reference bench.cc:19-20


@dataclasses.dataclass
class BenchResult:
    backend: str
    n: int
    sort: str  # 'keys' | 'kv' (stable) | 'kvns' (stable=False extension)
    gpu_ms: float  # device time (CUDA events); host backends: wall clock
    cpu_ms: float  # host wall clock of a sort and a synchronize
    gpu_gitems_s: float
    cpu_gitems_s: float


def sweep_sizes(steps: int = DEFAULT_STEPS, n_min: int = N_MIN,
                n_max: int = N_MAX) -> list[int]:
    """Linear N sweep, deduplicated (reference bench.cc:161-163)."""
    if steps <= 1:
        return [n_max]
    xs = [n_min + (n_max - n_min) * i // (steps - 1) for i in range(steps)]
    out: list[int] = []
    for x in xs:
        if not out or x != out[-1]:
            out.append(x)
    return out


def _u32(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32)).to(device)


class _SorterBackend:
    """One of the port's engines through its Sorter, on `device`."""

    def __init__(self, backend: str, config: SortConfig | None = None,
                 device="cuda"):
        backend = "reference" if backend == "xla" else backend
        self.name = backend
        self._cfg = dataclasses.replace(config or SortConfig(),
                                        backend=backend)
        self.device = torch.device(device)

    def _sorter(self, n: int):
        from ..models.sorter import Sorter

        return Sorter(max(1, n), config=self._cfg, device=self.device)

    def sort(self, keys: np.ndarray) -> np.ndarray:
        s = self._sorter(keys.shape[0])
        return s.sort(_u32(keys, self.device)).cpu().numpy()

    def sort_key_value(self, keys, values, stable: bool = True):
        s = self._sorter(keys.shape[0])
        k, v = s.sort_key_value(_u32(keys, self.device),
                                _u32(values, self.device), stable=stable)
        return k.cpu().numpy(), v.cpu().numpy()

    def timed_fn(self, keys: np.ndarray, values: np.ndarray | None,
                 indirect: bool = False, stable: bool = True):
        """(fn, args): one sort of these inputs per call of fn(*args),
        always on the same (unsorted) device tensors. indirect=True goes
        through the dynamic-count path with count = n, as the reference's
        key-value bench drives its indirect API
        (vulkan_benchmark.cc:386-388)."""
        n = keys.shape[0]
        s = self._sorter(n)
        count = torch.tensor(n, device=self.device) if indirect else None
        k = _u32(keys, self.device)
        if values is None:
            return (lambda k: s.sort(k, count=count)), (k,)
        v = _u32(values, self.device)
        return (lambda k, v: s.sort_key_value(k, v, count=count,
                                              stable=stable)), (k, v)


class _CpuBackend:
    """NumPy oracle, the reference's CPU backend (bench/cpu_benchmark.cc):
    np.sort for keys, stable argsort and a gather for key-value."""

    name = "cpu"

    def sort(self, keys):
        return np.sort(keys)

    def sort_key_value(self, keys, values, stable: bool = True):
        # a stable order is also a valid answer to stable=False
        order = np.argsort(keys, kind="stable")
        return keys[order], values[order]

    def timed_fn(self, keys, values):
        if values is None:
            return (lambda k: np.sort(k)), (keys,)
        return (lambda k, v: (lambda o: (k[o], v[o]))(
            np.argsort(k, kind="stable"))), (keys, values)


class _CppBackend(_CpuBackend):
    """The native C++ LSD radix engine (`native`, ctypes)."""

    name = "cpp"

    def __init__(self):
        from .. import native

        if not native.available():
            raise RuntimeError("the native engine needs g++ and "
                               "native/vrs_native.cpp")
        self._native = native

    def sort(self, keys):
        return self._native.sort_u32(keys)

    def sort_key_value(self, keys, values, stable: bool = True):
        # the LSD radix sort is stable, a valid answer to stable=False too
        return self._native.sort_pairs_u32(keys, values)

    def timed_fn(self, keys, values):
        # working copies made outside the clock, as the reference's CPU
        # timing (bench/cpu_benchmark.cc:22-25). An LSD radix sort does the
        # same work whatever the input's order, so later runs re-sorting
        # the sorted buffer cost what the first did.
        kb = np.array(keys, dtype=np.uint32)
        if values is None:
            return self._native.sort_u32_inplace, (kb,)
        vb = np.array(values, dtype=np.uint32)
        return self._native.sort_pairs_u32_inplace, (kb, vb)


class _TorchBackend(_CpuBackend):
    """torch.sort on the host, a second host competitor beside the native
    engine (as the reference benches CUB and Fuchsia beside its own sort,
    bench/benchmark_factory.cc:14-25). Keys and values round-trip through
    int64 outside the timed region; only torch.sort (and the gather) is
    timed."""

    name = "torch"

    def sort(self, keys):
        t = torch.from_numpy(keys.astype(np.int64))
        return torch.sort(t).values.numpy().astype(np.uint32)

    def sort_key_value(self, keys, values, stable: bool = True):
        k = torch.from_numpy(keys.astype(np.int64))
        v = torch.from_numpy(values.astype(np.int64))
        s, idx = torch.sort(k, stable=True)
        return s.numpy().astype(np.uint32), v[idx].numpy().astype(np.uint32)

    def timed_fn(self, keys, values):
        k = torch.from_numpy(keys.astype(np.int64))
        if values is None:
            return (lambda t: torch.sort(t)), (k,)
        v = torch.from_numpy(values.astype(np.int64))

        def f(kt, vt):
            s, idx = torch.sort(kt, stable=True)
            return s, vt[idx]
        return f, (k, v)


DEVICE_BACKENDS = ("network", "radix", "reference", "xla")
BACKENDS = DEVICE_BACKENDS + ("cpu", "cpp", "torch")


def make_backend(name: str, config: SortConfig | None = None,
                 device="cuda"):
    """A backend by name; the device backends sort on `device`."""
    if name == "cpu":
        return _CpuBackend()
    if name == "cpp":
        return _CppBackend()
    if name == "torch":
        return _TorchBackend()
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; options: {BACKENDS}")
    return _SorterBackend(name, config, device)


def check_correctness(backend, n: int, seed: int = 0,
                      distribution: str = "uniform",
                      nonstable: bool = False) -> None:
    """Oracle diff at one size, keys and kv (reference bench.cc:41-64).

    nonstable=True also gates the stable=False pair path: keys must match
    the oracle exactly and the (key, value) pair multiset must be kept
    (any order among equal keys is a valid non-stable answer).
    """
    cpu = _CpuBackend()
    keys = datagen.generate_keys(n, seed=seed, distribution=distribution)
    got = backend.sort(keys)
    want = cpu.sort(keys)
    if not np.array_equal(got, want):
        i = int(np.argmax(got != want))
        raise AssertionError(
            f"keys mismatch at n={n} index {i}: {got[i]:#x} != {want[i]:#x}")
    values = np.arange(n, dtype=np.uint32)
    gk, gv = backend.sort_key_value(keys, values)
    wk, wv = cpu.sort_key_value(keys, values)
    if not (np.array_equal(gk, wk) and np.array_equal(gv, wv)):
        raise AssertionError(f"key-value mismatch at n={n}")
    if nonstable:
        gk, gv = backend.sort_key_value(keys, values, stable=False)
        if not np.array_equal(gk, wk):
            raise AssertionError(f"kvns keys mismatch at n={n}")
        got_pairs = np.sort(gk.astype(np.uint64) << 32 | gv)
        want_pairs = np.sort(keys.astype(np.uint64) << 32
                             | values.astype(np.uint64))
        if not np.array_equal(got_pairs, want_pairs):
            raise AssertionError(f"kvns pair multiset mismatch at n={n}")


def _wall(fn, args, iters: int, device=None) -> float:
    """Median host seconds of one call (and, on a device, a
    synchronize)."""
    ts = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn(*args)
        if device is not None:
            torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def measure(backend, n: int, sort: str, *, iters: int = 10, seed: int = 0,
            distribution: str = "uniform", indirect: bool = False
            ) -> BenchResult:
    """Seconds per sort at n (reference bench.cc:66-101), as a BenchResult.

    sort: 'keys', 'kv' (stable, the reference contract) or 'kvns'
    (stable=False; the stable backends just run their pair sort). Host
    backends: the median of `iters` wall-clock runs. Device backends
    (on a card only; a backend on the CPU raises): device time from
    `time_fn`, every call on the same unsorted input, and the median wall
    clock of a sort and a synchronize.
    """
    keys = datagen.generate_keys(n, seed=seed, distribution=distribution)
    values = (datagen.generate_keys(n, seed=seed + 1)
              if sort in ("kv", "kvns") else None)
    if isinstance(backend, _CpuBackend):
        fn, args = backend.timed_fn(keys, values)
        cpu_s = gpu_s = _wall(fn, args, iters)
    else:
        if backend.device.type != "cuda":
            raise RuntimeError(f"measure times the {backend.name} backend on "
                               f"a CUDA device, not on {backend.device}")
        fn, args = backend.timed_fn(keys, values, indirect=indirect,
                                    stable=sort != "kvns")
        gpu_s = time_fn(fn, *args, iters=iters, warmup=1)
        cpu_s = _wall(fn, args, iters, backend.device)
    return BenchResult(
        backend=backend.name, n=n, sort=sort,
        gpu_ms=gpu_s * 1e3, cpu_ms=cpu_s * 1e3,
        gpu_gitems_s=n / gpu_s / 1e9, cpu_gitems_s=n / cpu_s / 1e9,
    )


def run_sweep(backend_name: str, *, steps: int = DEFAULT_STEPS,
              iters: int = 10, no_verify: bool = False,
              distribution: str = "uniform",
              config: SortConfig | None = None,
              indirect: bool = False,
              nonstable: bool = False,
              n_min: int = N_MIN, n_max: int = N_MAX,
              progress: Callable[[BenchResult], None] | None = None,
              device="cuda") -> list[BenchResult]:
    """Sweep over N for keys and kv (reference bench.cc:151-189);
    nonstable=True adds a 'kvns' (stable=False) series."""
    backend = make_backend(backend_name, config, device)
    sizes = sweep_sizes(steps, n_min=n_min, n_max=n_max)
    if not no_verify:
        check_correctness(backend, sizes[0], distribution=distribution,
                          nonstable=nonstable)
    results = []
    sorts = ("keys", "kv") + (("kvns",) if nonstable else ())
    for n in sizes:
        for sort in sorts:
            r = measure(backend, n, sort, iters=iters,
                        distribution=distribution,
                        indirect=indirect and not isinstance(backend,
                                                             _CpuBackend))
            results.append(r)
            if progress:
                progress(r)
    return results


def write_csv(path: str, results: list[BenchResult]) -> None:
    """Reference CSV schema and version line (bench.cc:197-203)."""
    with open(path, "w") as f:
        f.write(f"# version: {__version__}\n")
        f.write("backend,n,sort,gpu_ms,cpu_ms,gpu_gitems_s,cpu_gitems_s\n")
        for r in results:
            f.write(f"{r.backend},{r.n},{r.sort},{r.gpu_ms:.6f},"
                    f"{r.cpu_ms:.6f},{r.gpu_gitems_s:.6f},"
                    f"{r.cpu_gitems_s:.6f}\n")
