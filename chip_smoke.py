#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each of which fails the run (nonzero exit) if it fails:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc compiles csrc/ for sm_90a; the -Xptxas -v report shows
     each kernel's registers, shared memory and spills;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     same seeded input, bitwise equal. The network's (chunk, fused, cross,
     local, and the validity gate) in keys, pairs and stable carries, at
     2^20 elements (with extra geometries: clipped grids, a round split
     into several cross spans) and at the main path's 2^25 shapes. The
     radix backend's (block sort K7, placement K8) at 2^20 at both digit
     widths, uniform and few-distinct digits, and at the main path's 2^25
     shapes, keys and key-value, every shift of a sort, with a ragged last
     block of sentinel pads;
  4. main path, once per backend (the network through 'auto', then
     'radix'): the public entry points (vrs.sort, Sorter.sort,
     Sorter.sort_key_value) at n = 2^25 and the other shapes below, each
     bitwise equal to a numpy oracle computed once for both; the kernels'
     launch counters are zeroed just before each backend's run and read
     just after, and every kernel of that backend must have launched (each
     radix sort launches K7 and K8 exactly num_passes times);
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
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, KEY_SENTINEL, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import bitonic, bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
from vulkan_radix_sort_tpu_torch.utils import datagen
from vulkan_radix_sort_tpu_torch.utils.timing import time_fn

N = 1 << 25          # the reference's headline size
N_RAGGED = (1 << 24) + 4096
N_CHECK = 1 << 20    # kernel-vs-plain size
SEED = 0
TIMED_RUNS = 3
RADIX = SortConfig(backend="radix")
RAGGED_TAIL = 1000   # sentinel pads closing the last block of a K7/K8 check

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet); int32 132 SMs x 64
# INT32 lanes x 1.98 GHz boost = 16.7 Top/s (Hopper architecture white
# paper: 16 INT32 units in each of an SM's four partitions).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per compare-exchange. keys: one min and one max (the
# direction only picks the slot each lands in). Two-word carries: one
# compare per compared word and one select per word the pair writes.
OPS_PER_CE = {"keys": 2, "pairs": 2 + 4, "stable": 2 + 6}
# integer operations per key of a radix kernel. Block sort: the digit (a
# shift and a mask), its count, and the add of its rank to its digit's
# base. Placement: the add of the run's offset and the subtraction of the
# run's start.
OPS_PER_KEY = {"block_sort": 4, "place": 2}

BITONIC_CU = "vulkan_radix_sort_tpu_torch/csrc/bitonic.cu"
RADIX_CU = "vulkan_radix_sort_tpu_torch/csrc/radix.cu"
KERNELS = {  # counter name -> (label, source, the TPU kernel it replaces)
    "chunk": ("K1 chunk", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:934"),
    "fused": ("K2 fused rounds", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:723"),
    "cross": ("K3 cross", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:948"),
    "local": ("K4 local", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:993"),
    "gate": ("K5 validity gate", BITONIC_CU,
             "vulkan_radix_sort_tpu/ops/bitonic.py:746"),
    "block_sort": ("K7 radix block sort", RADIX_CU,
                   "vulkan_radix_sort_tpu/ops/block_sort.py:154"),
    "place": ("K8 radix placement", RADIX_CU,
              "vulkan_radix_sort_tpu/ops/stream_place.py:228"),
}
RADIX_KERNELS = ("block_sort", "place")
NETWORK_KERNELS = tuple(k for k in KERNELS if k not in RADIX_KERNELS)


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


def reset_launches() -> None:
    for mod in (bk, k7, k8):
        mod.reset_launches()


def launch_counts() -> dict[str, int]:
    return {**bk.launches, **k7.launches, **k8.launches}


# -- phase 2: build ----------------------------------------------------------

def build() -> None:
    path, report = _build.build()
    log(f"[build] {path.name}")
    for line in report.splitlines():
        m = re.search(r"\d([a-z_]+_kernel)I((?:L[ib]\d+E)+)E", line)
        if m:
            if "Function properties" in line:
                args = ",".join(re.findall(r"L[ib](\d+)E", m[2]))
                log(f"[ptxas] {m[1]}<{args}>")
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


def _max_abs_err(got, want) -> int:
    return max(int((x.view(torch.int32).long()
                    - y.view(torch.int32).long()).abs().max())
               for x, y in zip(got, want))


def _radix_inputs(n: int, hi: int | None, gen, device):
    """Seeded keys (below `hi`, if given, for few distinct digits) whose
    last RAGGED_TAIL slots are sentinel pads, as `radix.sort_u32` pads a
    ragged last block; and seeded values, 0 under the pads."""
    lo, top = (0, hi) if hi else (-(1 << 31), 1 << 31)
    k = torch.randint(lo, top, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    v = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                      device=device, dtype=torch.int32)
    k[-RAGGED_TAIL:] = KEY_SENTINEL - (1 << 32)
    v[-RAGGED_TAIL:] = 0
    return k.view(torch.uint32), v.view(torch.uint32)


def check_radix_kernels(sizes=((N_CHECK, True), (N, False)),
                        device="cuda") -> dict[str, int]:
    """K7 and K8 against their plain versions on the same seeded inputs,
    keys and key-value, at every shift of a sort: at 2^20 at both digit
    widths with uniform and few-distinct keys, and at the main path's 2^25
    shapes. K8 takes K7's plain output, so its runs are real. Returns max
    |err| per kernel."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    err = {name: 0 for name in RADIX_KERNELS}
    for n, extra in sizes:
        for bits in ((4, 8) if extra else (RADIX.digit_bits,)):
            cfg = SortConfig(backend="radix", digit_bits=bits)
            for hi in ((None, 16) if extra else (None,)):
                for kv in (False, True):
                    for p in range(cfg.num_passes):
                        keys, vals = _radix_inputs(n, hi, gen, device)
                        vals = vals if kv else None
                        kw = dict(shift=p * bits, config=cfg, key_value=kv)
                        got7 = k7.block_sort(keys, vals, **kw)
                        want7 = k7.block_sort_plain(keys, vals, **kw)
                        y, hist = want7[0], want7[-1]
                        args8 = (y, hist, radix._spine(hist),
                                 want7[1] if kv else None)
                        kw8 = dict(config=cfg, key_value=kv)
                        got8 = k8.stream_place(*args8, **kw8)
                        want8 = k8.stream_place_plain(*args8, **kw8)
                        if not kv:
                            got8, want8 = (got8,), (want8,)
                        sync(device)
                        for name, got, want in (("block_sort", got7, want7),
                                                ("place", got8, want8)):
                            e = _max_abs_err(got, want)
                            err[name] = max(err[name], e)
                            log(f"[kernel] n={n} {name} bits={bits} "
                                f"{'kv' if kv else 'keys'} shift={p * bits} "
                                f"keys<{hi or 2 ** 32} max_abs_err={e}")
                            if e != 0:
                                raise AssertionError(
                                    f"{name} bits={bits} shift={p * bits}: "
                                    "the kernel differs from its plain "
                                    "version")
                        del keys, vals, got7, want7, got8, want8, args8
    return err


def check_kernels(sizes=((N_CHECK, True), (N, False)),
                  device="cuda") -> dict[str, int]:
    """Each network kernel against its plain version on the same seeded
    inputs, with and without a validity mask that has zeros: at 2^20 with
    extra geometries, and at the main path's own shapes (2^25); then the
    radix kernels (`check_radix_kernels`). Returns max |err| per kernel."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    err = {name: 0 for name in NETWORK_KERNELS}
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
                    e = _max_abs_err(a, b)
                    key = "gate" if gated else kernel
                    err[key] = max(err[key], e)
                    log(f"[kernel] n={n} {kernel} {mode.name} {args} "
                        f"units={units} gated={gated} max_abs_err={e}")
                    if e != 0:
                        raise AssertionError(
                            f"{kernel} {mode.name} {args}: the kernel "
                            "differs from its plain version")
                    del a, b
    err.update(check_radix_kernels(sizes, device))
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


def main_path(n: int = N, n_ragged: int = N_RAGGED, device="cuda",
              config: SortConfig | None = None,
              oracles: dict | None = None) -> None:
    """The port's entry points at full size with `config` (None: 'auto',
    the network on a card); each result against a numpy oracle. `oracles`
    caches each oracle, so a second backend's run reuses the first's.

    The radix backend is stable either way, so its stable=False answers
    are held to the stable oracle; and each of its sorts must launch K7
    and K8 exactly num_passes times and no network kernel."""
    oracles = {} if oracles is None else oracles

    def want(key, fn):
        if key not in oracles:
            oracles[key] = fn()
        return oracles[key]

    is_radix = config is not None and config.backend == "radix"
    tag = "radix " if is_radix else ""
    on_card = torch.device(device).type == "cuda"

    def run(fn, *args, **kw):
        before = launch_counts()
        out = fn(*args, **kw)
        if is_radix and on_card:
            after = launch_counts()
            got = {k: after[k] - before[k] for k in after}
            need = {k: config.num_passes if k in RADIX_KERNELS else 0
                    for k in after}
            if got != need:
                raise AssertionError(f"a radix sort launched {got}, not "
                                     f"{need}")
        return out

    ns_oracle, ns = ((_stable_oracle, "stable") if is_radix
                     else (_pairs_oracle, "pairs"))
    keys = want("keys", lambda: datagen.generate_keys(n, seed=SEED))
    vals = want("vals", lambda: datagen.generate_values(n, seed=SEED + 1))
    dk, dv = to_dev(keys, device), to_dev(vals, device)
    sorter = vrs.Sorter(n, device=device, config=config)

    _expect(run(vrs.sort, dk, config=config),
            want("sort", lambda: np.sort(keys)), f"{tag}keys uniform")
    gk, gv = run(sorter.sort_key_value, dk, dv)
    wk, wv = want("stable", lambda: _stable_oracle(keys, vals))
    _expect(gk, wk, f"{tag}stable kv uniform, keys")
    _expect(gv, wv, f"{tag}stable kv uniform, values")
    gk, gv = run(vrs.sort_key_value, dk, dv, config=config, stable=False)
    wk, wv = want(ns, lambda: ns_oracle(keys, vals))
    _expect(gk, wk, f"{tag}non-stable kv uniform, keys")
    _expect(gv, wv, f"{tag}non-stable kv uniform, values")

    # ragged: the grid clip and the group-granularity skip rule matter
    m = n_ragged
    _expect(run(sorter.sort, dk[:m]),
            want("sort ragged", lambda: np.sort(keys[:m])),
            f"{tag}keys ragged")
    gk, gv = run(sorter.sort_key_value, dk[:m], dv[:m])
    wk, wv = want("stable ragged",
                  lambda: _stable_oracle(keys[:m], vals[:m]))
    _expect(gk, wk, f"{tag}stable kv ragged, keys")
    _expect(gv, wv, f"{tag}stable kv ragged, values")

    # genuine 0xFFFFFFFF keys, and count= as a device tensor
    def with_max_keys():
        mk = keys.copy()
        mk[::97] = 0xFFFFFFFF
        return mk
    mk = want("max keys", with_max_keys)
    dmk = to_dev(mk, device)
    gk, gv = run(sorter.sort_key_value, dmk, dv)
    wk, wv = want("stable max", lambda: _stable_oracle(mk, vals))
    _expect(gk, wk, f"{tag}stable kv with 0xFFFFFFFF keys, keys")
    _expect(gv, wv, f"{tag}stable kv with 0xFFFFFFFF keys, values")
    count = n - n // 11 - 12345
    cnt = torch.tensor(count, device=device)

    def prefix_sorted():
        w = mk.copy()
        w[:count] = np.sort(mk[:count])
        return w
    _expect(run(sorter.sort, dmk, count=cnt), want("sort count",
                                                   prefix_sorted),
            f"{tag}keys count=")
    for stable in (True, False):
        what = f"{tag}{'stable' if stable else 'non-stable'} kv count="
        gk, gv = run(sorter.sort_key_value, dmk, dv, count=cnt,
                     stable=stable)
        kind, oracle = (("stable", _stable_oracle) if stable
                        else (ns, ns_oracle))
        wk, wv = want(f"{kind} count",
                      lambda: oracle(mk[:count], vals[:count]))
        _expect(gk, np.concatenate([wk, mk[count:]]), f"{what}, keys")
        _expect(gv, np.concatenate([wv, vals[count:]]), f"{what}, values")
    del dmk

    for dist in ("zipf", "few"):
        k2 = want(dist, lambda: datagen.generate_keys(n, seed=SEED + 2,
                                                       distribution=dist))
        dk2 = to_dev(k2, device)
        _expect(run(sorter.sort, dk2), want(f"sort {dist}",
                                            lambda: np.sort(k2)),
                f"{tag}keys {dist}")
        gk, gv = run(sorter.sort_key_value, dk2, dv)
        wk, wv = want(f"stable {dist}", lambda: _stable_oracle(k2, vals))
        _expect(gk, wk, f"{tag}stable kv {dist}, keys")
        _expect(gv, wv, f"{tag}stable kv {dist}, values")

    ki = keys.view(np.int32)
    _expect(run(vrs.sort, to_dev(ki, device), config=config),
            want("sort int32", lambda: np.sort(ki)), f"{tag}int32 keys")
    kf = want("float32", lambda: np.random.default_rng(
        SEED + 3).standard_normal(n, dtype=np.float32))
    _expect(run(vrs.sort, to_dev(kf, device), config=config),
            want("sort float32", lambda: np.sort(kf)), f"{tag}float32 keys")


# -- phase 5: times ----------------------------------------------------------

class KernelTimer:
    """Brackets every kernel launch with CUDA events and keeps what the
    bound and the plain replay need: the network's launches by wrapping
    bitonic_kernels.run, K7's and K8's by wrapping the launch functions of
    their modules (so K8's bracket holds the kernel alone, not the torch
    offset table before it). `tag` names the sort the launches belong
    to."""

    def __init__(self):
        self.records = []
        self.tag = ""
        self._saved = [(bk, "run", bk.run), (k7, "_launch", k7._launch),
                       (k8, "_launch", k8._launch)]

    def _bracket(self, launch, rec):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = launch()
        e.record()
        self.records.append(dict(rec, tag=self.tag, events=(s, e)))
        return out

    def __enter__(self):
        run, launch7, launch8 = (f for _, _, f in self._saved)

        def timed_run(launch, arrs, mode, nunits, valid=None):
            names = [launch.kernel] + (["gate"] if valid is not None else [])
            return self._bracket(
                lambda: run(launch, arrs, mode, nunits, valid),
                dict(names=names, launch=launch, mode=mode,
                     numel=arrs[0].numel(), nunits=nunits,
                     valid=None if valid is None else valid.clone()))

        def timed7(keys, values, shift, config, key_value):
            return self._bracket(
                lambda: launch7(keys, values, shift, config, key_value),
                dict(names=["block_sort"], numel=keys.numel(), shift=shift,
                     config=config, key_value=key_value))

        def timed8(y, hist, offsets, values, config, key_value):
            return self._bracket(
                lambda: launch8(y, hist, offsets, values, config, key_value),
                dict(names=["place"], numel=y.numel(), config=config,
                     key_value=key_value))

        bk.run, k7._launch, k8._launch = timed_run, timed7, timed8
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


def bound_ms(rec) -> tuple[float, str]:
    """Least time for a launch's work: HBM bytes (each input read and each
    output written once) or int32 operations, whichever is larger. Network:
    every element of the units it runs. K7: keys (and values) in and out
    plus the histogram out. K8: keys (and values), the histogram and the
    run offsets in, keys (and values) out."""
    if rec["names"][0] in RADIX_KERNELS:
        name, n, cfg = rec["names"][0], rec["numel"], rec["config"]
        arrays = 2 if rec["key_value"] else 1
        tables = (1 if name == "block_sort" else 2) * 4 * (
            n // cfg.block) * cfg.radix
        return _bound(2 * n * 4 * arrays + tables, n * OPS_PER_KEY[name])
    launch, mode, valid = rec["launch"], rec["mode"], rec["valid"]
    units = rec["nunits"] if valid is None else int(
        valid[:rec["nunits"]].sum())
    elems = units * launch.unit
    return _bound(2 * elems * 4 * mode.n_arrays,
                  len(launch.stages) * (elems // 2) * OPS_PER_CE[mode.name])


def _u32_zeros(n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device="cuda").view(torch.uint32)


def plain_ms(rec) -> float:
    """One run of the launch's plain version at the launch's shapes (on
    zeros for the network; for K8, on K7's output for seeded keys, so its
    runs are real)."""
    n = rec["numel"]
    if rec["names"][0] in RADIX_KERNELS:
        cfg, kv = rec["config"], rec["key_value"]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        keys, vals = _radix_inputs(n, None, gen, "cuda")
        vals = vals if kv else None
        if rec["names"][0] == "block_sort":
            def plain():
                k7.block_sort_plain(keys, vals, shift=rec["shift"],
                                    config=cfg, key_value=kv)
        else:
            out = k7.block_sort(keys, vals, shift=0, config=cfg,
                                key_value=kv)
            g = radix._spine(out[-1])

            def plain():
                k8.stream_place_plain(out[0], out[-1], g,
                                      out[1] if kv else None, config=cfg,
                                      key_value=kv)
    else:
        mode = rec["mode"]
        arrs = [_u32_zeros(n) for _ in range(mode.n_arrays)]

        def plain():
            bk.run_plain(rec["launch"], arrs, mode, rec["nunits"],
                         rec["valid"])
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    plain()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def path_sorts(n: int = N):
    """The main path's sorts at n, as closures for timing: the network's
    five, and the radix backend's keys, stable kv and keys count=."""
    keys = to_dev(datagen.generate_keys(n, seed=SEED), "cuda")
    vals = to_dev(datagen.generate_values(n, seed=SEED + 1), "cuda")
    sorter = vrs.Sorter(n)
    rsorter = vrs.Sorter(n, config=RADIX)
    cnt = torch.tensor(n - n // 11 - 12345, device="cuda")
    sorts = {
        "keys": lambda: sorter.sort(keys),
        "stable_kv": lambda: sorter.sort_key_value(keys, vals),
        "nonstable_kv": lambda: sorter.sort_key_value(keys, vals,
                                                      stable=False),
        "keys_count": lambda: sorter.sort(keys, count=cnt),
        "stable_kv_count": lambda: sorter.sort_key_value(keys, vals,
                                                         count=cnt),
        "radix_keys": lambda: rsorter.sort(keys),
        "radix_stable_kv": lambda: rsorter.sort_key_value(keys, vals),
        "radix_keys_count": lambda: rsorter.sort(keys, count=cnt),
    }
    return sorts, keys, vals


def e2e_times(sorts, keys, vals, card: str) -> dict:
    e2e = {"card": card, "n": N}
    for name, fn in sorts.items():
        s = time_fn(fn, iters=10, repeats=5)
        e2e[f"{name}_ms"] = s * 1e3
        e2e[f"{name}_gitems_per_s"] = N / s / 1e9
    # Yardsticks only: the port never calls torch.sort on its kernel
    # paths. torch.sort has no CUDA kernel for uint32, so it sorts the
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
                reset_launches()
                fn()
                per_sort[tag] = launch_counts()
    torch.cuda.synchronize()

    def acc():
        return dict(n=0, ms=0.0, bound=0.0, by={}, plain=0.0, nplain=0)
    per = {k: acc() for k in KERNELS}
    by_tag = {}
    one_run = len(timer.records) // TIMED_RUNS
    for i, rec in enumerate(timer.records):
        ms = rec["events"][0].elapsed_time(rec["events"][1])
        b, by = bound_ms(rec)
        pm = plain_ms(rec) if i < one_run else None
        for k in rec["names"]:
            for a in (per[k], by_tag.setdefault((rec["tag"], k), acc())):
                a["n"] += 1
                a["ms"] += ms
                a["bound"] += b
                a["by"][by] = a["by"].get(by, 0.0) + b
                if pm is not None:
                    a["plain"] += pm
                    a["nplain"] += 1
    for (tag, k), a in by_tag.items():
        log(f"[kernel-time] {tag} {k}: launches/sort={per_sort[tag][k]} "
            f"ms/launch={a['ms'] / a['n']:.4f} "
            f"bound_ms/launch={a['bound'] / a['n']:.4f} "
            f"({max(a['by'], key=a['by'].get)}) "
            f"plain_ms/launch={a['plain'] / max(a['nplain'], 1):.3f}")
    return per


def _path_launches(config: SortConfig | None, kernels, oracles) -> dict:
    """Drive one backend's main path with the counters zeroed just before
    and read just after; every kernel of `kernels` must have launched."""
    reset_launches()
    main_path(config=config, oracles=oracles)
    torch.cuda.synchronize()
    launches = launch_counts()
    log("[launches]", "radix" if config else "network", json.dumps(launches))
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"not launched on the main path: {missing}")
    return {k: launches[k] for k in kernels}


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

    oracles = {}
    launches = _path_launches(None, NETWORK_KERNELS, oracles)
    launches.update(_path_launches(RADIX, RADIX_KERNELS, oracles))
    del oracles

    sorts, keys, vals = path_sorts()
    e2e_times(sorts, keys, vals, card)
    per = kernel_times(sorts)
    rows = []
    for key, (label, source, replaces) in KERNELS.items():
        p = per[key]
        rows.append({
            "name": label, "route": "cuda", "source": source,
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
