#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each of which fails the run (nonzero exit) if it fails:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc compiles csrc/ for sm_90a; the -Xptxas -v report shows
     each kernel's registers, shared memory and spills;
  3. kernel vs plain: each kernel (chunk, fused, cross, local, and the
     validity gate) against its plain PyTorch version on the same seeded
     input, keys, pairs and stable carries, at 2^20 elements (with extra
     geometries: clipped grids, a round split into several cross spans)
     and at the main path's 2^25 shapes; bitwise equal;
  4. main path: the public entry points (vrs.sort, Sorter.sort,
     Sorter.sort_key_value) at n = 2^25 and the other shapes below, each
     bitwise equal to a numpy oracle; the kernels' launch counters are
     zeroed just before and read just after, and every kernel must have
     launched;
  5. times on the card with CUDA events: end to end with torch.sort as the
     yardstick, and per kernel with its bound and its plain version.
Then the `kernels` JSON line, the card's name and power limit as
nvidia-smi gives them, and last the {"ok": true, ...} result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import torch

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch import _build
from vulkan_radix_sort_tpu_torch.config import CHUNK_CARRY, CHUNK_KEYS
from vulkan_radix_sort_tpu_torch.ops import bitonic, bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.utils import datagen
from vulkan_radix_sort_tpu_torch.utils.timing import time_fn

N = 1 << 25          # the reference's headline size
N_RAGGED = (1 << 24) + 4096
N_CHECK = 1 << 20    # kernel-vs-plain size
SEED = 0
TIMED_RUNS = 3

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet); int32 132 SMs x 64
# INT32 lanes x 1.98 GHz boost = 16.7 Top/s (Hopper architecture white
# paper: 16 INT32 units in each of an SM's four partitions).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per compare-exchange. keys: one min and one max (the
# direction only picks the slot each lands in). Two-word carries: one
# compare per compared word and one select per word the pair writes.
OPS_PER_CE = {"keys": 2, "pairs": 2 + 4, "stable": 2 + 6}

KERNELS = {  # counter name -> (label, the TPU kernel it replaces)
    "chunk": ("K1 chunk", "vulkan_radix_sort_tpu/ops/bitonic.py:934"),
    "fused": ("K2 fused rounds", "vulkan_radix_sort_tpu/ops/bitonic.py:723"),
    "cross": ("K3 cross", "vulkan_radix_sort_tpu/ops/bitonic.py:948"),
    "local": ("K4 local", "vulkan_radix_sort_tpu/ops/bitonic.py:993"),
    "gate": ("K5 validity gate", "vulkan_radix_sort_tpu/ops/bitonic.py:746"),
}
SOURCE = "vulkan_radix_sort_tpu_torch/csrc/bitonic.cu"


def log(*a):
    print(*a, flush=True)


def to_dev(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- phase 2: build ----------------------------------------------------------

def build() -> None:
    path, report = _build.build()
    log(f"[build] {path.name}")
    for line in report.splitlines():
        m = re.search(r"\d([a-z]+_kernel)ILi(\d)ELi(\d)E", line)
        if m:
            if "Function properties" in line:
                log(f"[ptxas] {m[1]}<{m[2]},{m[3]}>")
        elif "Used" in line or "spill" in line:
            log("[ptxas]  ", line.split(":", 1)[-1].strip())
    _build.library()


# -- phase 3: kernel vs plain ------------------------------------------------

def _inputs(mode, n: int, gen, device) -> list[torch.Tensor]:
    """Seeded buffers; two-word carries get few distinct keys, so the
    second word decides."""
    lo, hi = (0, 13) if mode.words == 2 else (-(1 << 31), 1 << 31)
    k = torch.randint(lo, hi, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    rest = [torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                          device=device, dtype=torch.int32)
            for _ in range(mode.n_arrays - 1)]
    return [x.view(torch.uint32) for x in [k] + rest]


def kernel_cases(mode, n: int, extra: bool):
    """(kernel, spec args, units) as the main path launches them at n
    elements with the path's chunks; with `extra`, also clipped grids, a
    single-span earlier round and a round split into more than one span."""
    C = CHUNK_KEYS if mode is bk.KEYS else CHUNK_CARRY
    r = bk.log2(n // C)
    r_hi = bitonic._fused_rounds(C, r, mode)
    cases = [("chunk", (C,), n // C),
             ("fused", (C, 1, r_hi), n // (C << r_hi)),
             ("local", (C, r), n // C)]
    spans = bitonic._cross_spans(r, mode)
    if extra:
        spans += [(r // 2, r - r // 2), (0, r // 2)]
        cases += [("chunk", (C,), n // C - 3),
                  ("local", (C, 2), (n // (C << 2) - 1) << 2),
                  ("cross", (C, r - 1, 0, r - 1), n // (C << (r - 1)))]
    cases += [("cross", (C, r, t_lo, s), n // (C << r)) for t_lo, s in spans]
    return cases


def check_kernels(sizes=((N_CHECK, True), (N, False)),
                  device="cuda") -> dict[str, int]:
    """Each kernel against its plain version on the same seeded inputs,
    with and without a validity mask that has zeros: at 2^20 with extra
    geometries, and at the main path's own shapes (2^25). Returns max
    |err| per kernel."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    err = {name: 0 for name in KERNELS}
    for n, extra in sizes:
        for mode in bk.MODES:
            for kernel, args, units in kernel_cases(mode, n, extra):
                launch = bk.spec(kernel, *args)
                for gated in (False, True):
                    valid = None
                    if gated:
                        valid = torch.randint(0, 2, (units,), generator=gen,
                                              device=device, dtype=torch.int32)
                        valid[0] = 0
                    a = _inputs(mode, n, gen, device)
                    b = [x.clone() for x in a]
                    bk.run(launch, a, mode, units, valid)
                    bk.run_plain(launch, b, mode, units, valid)
                    sync(device)
                    e = max(int((x.view(torch.int32).long()
                                 - y.view(torch.int32).long()).abs().max())
                            for x, y in zip(a, b))
                    key = "gate" if gated else kernel
                    err[key] = max(err[key], e)
                    log(f"[kernel] n={n} {kernel} {mode.name} {args} "
                        f"units={units} gated={gated} max_abs_err={e}")
                    if e != 0:
                        raise AssertionError(
                            f"{kernel} {mode.name} {args}: the kernel "
                            "differs from its plain version")
                    del a, b
    return err


# -- phase 4: main path ------------------------------------------------------

def _expect(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    g = got.cpu().numpy()
    if g.shape != want.shape or not np.array_equal(
            g.view(np.uint32), want.view(np.uint32)):
        raise AssertionError(f"{what}: differs from the numpy oracle")
    log(f"[main] {what}: ok")


def _stable_oracle(k: np.ndarray, v: np.ndarray):
    o = np.argsort(k, kind="stable")
    return k[o], v[o]


def _pairs_oracle(k: np.ndarray, v: np.ndarray):
    """np.lexsort((v, k)) order, as one uint64 sort."""
    c = np.sort((k.astype(np.uint64) << np.uint64(32)) | v)
    return (c >> np.uint64(32)).astype(np.uint32), c.astype(np.uint32)


def main_path(n: int = N, n_ragged: int = N_RAGGED, device="cuda") -> None:
    """The port's entry points at full size; each result against numpy."""
    keys = datagen.generate_keys(n, seed=SEED)
    vals = datagen.generate_values(n, seed=SEED + 1)
    dk, dv = to_dev(keys, device), to_dev(vals, device)
    sorter = vrs.Sorter(n, device=device)

    _expect(vrs.sort(dk), np.sort(keys), "keys uniform")
    gk, gv = sorter.sort_key_value(dk, dv)
    wk, wv = _stable_oracle(keys, vals)
    _expect(gk, wk, "stable kv uniform, keys")
    _expect(gv, wv, "stable kv uniform, values")
    gk, gv = vrs.sort_key_value(dk, dv, stable=False)
    wk, wv = _pairs_oracle(keys, vals)
    _expect(gk, wk, "non-stable kv uniform, keys")
    _expect(gv, wv, "non-stable kv uniform, values")

    # ragged: the grid clip and the group-granularity skip rule matter
    m = n_ragged
    _expect(sorter.sort(dk[:m]), np.sort(keys[:m]), "keys ragged")
    gk, gv = sorter.sort_key_value(dk[:m], dv[:m])
    wk, wv = _stable_oracle(keys[:m], vals[:m])
    _expect(gk, wk, "stable kv ragged, keys")
    _expect(gv, wv, "stable kv ragged, values")

    # genuine 0xFFFFFFFF keys, and count= as a device tensor
    mk = keys.copy()
    mk[::97] = 0xFFFFFFFF
    dmk = to_dev(mk, device)
    gk, gv = sorter.sort_key_value(dmk, dv)
    wk, wv = _stable_oracle(mk, vals)
    _expect(gk, wk, "stable kv with 0xFFFFFFFF keys, keys")
    _expect(gv, wv, "stable kv with 0xFFFFFFFF keys, values")
    count = n - n // 11 - 12345
    cnt = torch.tensor(count, device=device)
    want = mk.copy()
    want[:count] = np.sort(mk[:count])
    _expect(sorter.sort(dmk, count=cnt), want, "keys count=")
    for stable in (True, False):
        what = f"{'stable' if stable else 'non-stable'} kv count="
        gk, gv = sorter.sort_key_value(dmk, dv, count=cnt, stable=stable)
        oracle = _stable_oracle if stable else _pairs_oracle
        wk, wv = oracle(mk[:count], vals[:count])
        _expect(gk, np.concatenate([wk, mk[count:]]), f"{what}, keys")
        _expect(gv, np.concatenate([wv, vals[count:]]), f"{what}, values")
    del dmk

    for dist in ("zipf", "few"):
        k2 = datagen.generate_keys(n, seed=SEED + 2, distribution=dist)
        dk2 = to_dev(k2, device)
        _expect(sorter.sort(dk2), np.sort(k2), f"keys {dist}")
        gk, gv = sorter.sort_key_value(dk2, dv)
        wk, wv = _stable_oracle(k2, vals)
        _expect(gk, wk, f"stable kv {dist}, keys")
        _expect(gv, wv, f"stable kv {dist}, values")

    ki = keys.view(np.int32)
    _expect(vrs.sort(to_dev(ki, device)), np.sort(ki), "int32 keys")
    kf = np.random.default_rng(SEED + 3).standard_normal(n, dtype=np.float32)
    _expect(vrs.sort(to_dev(kf, device)), np.sort(kf), "float32 keys")


# -- phase 5: times ----------------------------------------------------------

class KernelTimer:
    """Brackets every kernel launch with CUDA events, by wrapping
    bitonic_kernels.run, and keeps what the bound and the plain replay
    need. `tag` names the sort the launches belong to."""

    def __init__(self):
        self.records = []
        self.tag = ""
        self._run = bk.run

    def __enter__(self):
        def timed(launch, arrs, mode, nunits, valid=None):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            self._run(launch, arrs, mode, nunits, valid)
            e.record()
            self.records.append(dict(
                tag=self.tag, launch=launch, mode=mode, numel=arrs[0].numel(),
                nunits=nunits, valid=None if valid is None else valid.clone(),
                events=(s, e)))
        bk.run = timed
        return self

    def __exit__(self, *exc):
        bk.run = self._run


def bound_ms(launch, mode, nunits, valid) -> tuple[float, str]:
    """Least time for the launch's work: HBM bytes (each element of the
    units it runs read and written once) or int32 operations."""
    units = nunits if valid is None else int(valid[:nunits].sum())
    elems = units * launch.unit
    nbytes = 2 * elems * 4 * mode.n_arrays
    ops = len(launch.stages) * (elems // 2) * OPS_PER_CE[mode.name]
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


def plain_ms(rec) -> float:
    mode = rec["mode"]
    arrs = [torch.zeros(rec["numel"], dtype=torch.int32, device="cuda")
            .view(torch.uint32) for _ in range(mode.n_arrays)]
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    bk.run_plain(rec["launch"], arrs, mode, rec["nunits"], rec["valid"])
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def path_sorts(n: int = N):
    """The main path's sorts at n, as closures for timing."""
    keys = to_dev(datagen.generate_keys(n, seed=SEED), "cuda")
    vals = to_dev(datagen.generate_values(n, seed=SEED + 1), "cuda")
    sorter = vrs.Sorter(n)
    cnt = torch.tensor(n - n // 11 - 12345, device="cuda")
    sorts = {
        "keys": lambda: sorter.sort(keys),
        "stable_kv": lambda: sorter.sort_key_value(keys, vals),
        "nonstable_kv": lambda: sorter.sort_key_value(keys, vals,
                                                      stable=False),
        "keys_count": lambda: sorter.sort(keys, count=cnt),
        "stable_kv_count": lambda: sorter.sort_key_value(keys, vals,
                                                         count=cnt),
    }
    return sorts, keys, vals


def e2e_times(sorts, keys, vals, card: str) -> dict:
    e2e = {"card": card, "n": N}
    for name, fn in sorts.items():
        s = time_fn(fn, iters=10, repeats=5)
        e2e[f"{name}_ms"] = s * 1e3
        e2e[f"{name}_gitems_per_s"] = N / s / 1e9
    # Yardsticks only: the port never calls torch.sort on its network
    # path. torch.sort has no CUDA kernel for uint32, so it sorts the
    # int32 bit patterns with the sign bit flipped (same order, same bytes).
    flipped = keys.view(torch.int32) ^ -(1 << 31)
    v32 = vals.view(torch.int32)
    e2e["library_keys_ms"] = time_fn(lambda: torch.sort(flipped)) * 1e3

    def lib_kv():
        sk, perm = torch.sort(flipped, stable=True)
        return sk, v32[perm]
    e2e["library_stable_kv_ms"] = time_fn(lib_kv) * 1e3
    log("[e2e]", json.dumps(e2e))
    return e2e


def kernel_times(sorts) -> dict:
    """Per kernel over TIMED_RUNS runs of the path's sorts: launch time,
    bound and, for one run, the plain version's time at the same shapes."""
    for fn in sorts.values():  # warm
        fn()
    torch.cuda.synchronize()
    per_sort = {}  # launches of one sort, from the kernels' counters
    with KernelTimer() as timer:
        for _ in range(TIMED_RUNS):
            for tag, fn in sorts.items():
                timer.tag = tag
                bk.reset_launches()
                fn()
                per_sort[tag] = dict(bk.launches)
    torch.cuda.synchronize()
    per = {k: dict(n=0, ms=0.0, bound=0.0, by={}, plain=0.0, nplain=0)
           for k in KERNELS}
    by_tag = {}
    one_run = len(timer.records) // TIMED_RUNS
    for i, rec in enumerate(timer.records):
        ms = rec["events"][0].elapsed_time(rec["events"][1])
        b, by = bound_ms(rec["launch"], rec["mode"], rec["nunits"],
                         rec["valid"])
        pm = plain_ms(rec) if i < one_run else None
        names = [rec["launch"].kernel] + (
            ["gate"] if rec["valid"] is not None else [])
        for k in names:
            for acc in (per[k], by_tag.setdefault((rec["tag"], k), dict(
                    n=0, ms=0.0, bound=0.0, by={}, plain=0.0, nplain=0))):
                acc["n"] += 1
                acc["ms"] += ms
                acc["bound"] += b
                acc["by"][by] = acc["by"].get(by, 0.0) + b
                if pm is not None:
                    acc["plain"] += pm
                    acc["nplain"] += 1
    for (tag, k), a in by_tag.items():
        log(f"[kernel-time] {tag} {k}: launches/sort={per_sort[tag][k]} "
            f"ms/launch={a['ms'] / a['n']:.4f} "
            f"bound_ms/launch={a['bound'] / a['n']:.4f} "
            f"({max(a['by'], key=a['by'].get)}) "
            f"plain_ms/launch={a['plain'] / max(a['nplain'], 1):.3f}")
    return per


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on an NVIDIA card", file=sys.stderr)
        return 2
    card = nvidia_smi()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[card] {name} x{count}; nvidia-smi: {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    build()
    err = check_kernels()

    bk.reset_launches()
    main_path()
    torch.cuda.synchronize()
    launches = dict(bk.launches)
    log("[launches]", json.dumps(launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"not launched on the main path: {missing}")

    sorts, keys, vals = path_sorts()
    e2e_times(sorts, keys, vals, card)
    per = kernel_times(sorts)
    rows = []
    for key, (label, replaces) in KERNELS.items():
        p = per[key]
        rows.append({
            "name": label, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err[key], "ms": p["ms"] / p["n"],
            "plain_ms": p["plain"] / p["nplain"],
            "bound_ms": p["bound"] / p["n"],
            "bound_by": max(p["by"], key=p["by"].get),
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
