#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each of which fails the run (nonzero exit) if it fails:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc compiles csrc/ for sm_90a, one process per source; the
     -Xptxas -v report shows each kernel's registers, shared memory and
     spills; any spill fails the run, and so does a report that does not
     name every instantiation (INSTANTIATIONS);
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     same seeded input, bitwise equal. The network's (chunk, fused, cross,
     local, and the validity gate) in keys, pairs and stable carries, at
     2^20 elements (with extra geometries: clipped grids, a round split
     into several cross spans, the chunk and local kernels at every chunk
     from 256 to the carry's cap, the fused kernel at every group from 512
     to the cap) and at the main path's 2^25 shapes. The radix backend's
     (block sort K7, placement K8) at 2^20 at every block from 512 to
     16384 and both digit widths, with uniform keys, few distinct digits
     and one key only, and at the main path's 2^25 shapes, keys and
     key-value, with a ragged last block of sentinel pads;
  4. main path, once per backend (the network through 'auto', then
     'radix'): the public entry points (vrs.sort, Sorter.sort,
     Sorter.sort_key_value) at n = 2^25 and the other shapes below, each
     bitwise equal to a numpy oracle computed once for both; the kernels'
     launch counters are zeroed just before each backend's run and read
     just after, and every kernel of that backend must have launched (each
     radix sort launches K7 and K8 exactly num_passes times);
  5. times on the card with CUDA events: end to end with torch.sort as the
     yardstick, and per kernel with its bound and its plain version;
  6. slot merges: a slot buffer of 4 slots x 2^24 (slack-2 fill with the
     sizes of a uniform 4-rank exchange, one empty slot, one full slot,
     genuine 0xFFFFFFFF keys), keys and stable carries: every launch of
     the gated local kernel (K6) in the merge bitwise equal to its plain
     version, and merge_slots_u32 / merge_slots_pairs (prearranged both
     ways) bitwise equal to numpy;
  7. the distributed path: a world of 4 gloo ranks sharing cuda:0 with
     2^25 keys each (2^27 in all) sorts through sort_sharded /
     sort_pairs_sharded (keys, stable kv uniform and few-distinct, ragged
     n with count=, constant keys that must take the fallback), each
     bitwise equal to a numpy oracle computed once here; each rank zeroes
     its launch counters just before each sort and reads them just after:
     the merge runs must launch cross and the gated local kernel, the
     fallback none of the latter. Wall time per phase of the world;
  8. merge times, alone in this process on rank 0's received slot
     buffers: the merge gated by the slot sizes, the same merge ungated,
     and the full network re-sort the fallback runs, keys and stable kv;
     and K6 per launch against the ungated local pass.
Then the `kernels` JSON line, the card's name and power limit as
nvidia-smi gives them, and last the {"ok": true, ...} result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch import _build
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, KEY_SENTINEL, MAX_RADIX_BLOCK, MIN_CHUNK,
    RADIX_THREADS, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import bitonic, bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
from vulkan_radix_sort_tpu_torch.parallel import distributed as td
from vulkan_radix_sort_tpu_torch.utils import datagen
from vulkan_radix_sort_tpu_torch.utils.timing import time_fn

N = 1 << 25          # the reference's headline size
N_RAGGED = (1 << 24) + 4096
N_CHECK = 1 << 20    # kernel-vs-plain size
SEED = 0
TIMED_RUNS = 3
RADIX = SortConfig(backend="radix")
RAGGED_TAIL = 1000   # sentinel pads closing the last block of a K7/K8 check
WORLD = 4            # ranks of the distributed path, all on cuda:0
N_RANK = 1 << 25     # keys per rank (2^27 in all)
SLOTS, SLOT = 4, 1 << 24  # the slot buffer of 4 ranks x 2^25: slack 2

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
FUSED_CU = "vulkan_radix_sort_tpu_torch/csrc/fused.cu"
RADIX_CU = "vulkan_radix_sort_tpu_torch/csrc/radix.cu"
REGS = "redesigned: registers, warp shuffles, a transpose pair per phase"
KERNELS = {  # counter name -> (label, source, TPU kernel replaced, status)
    "chunk": ("K1 chunk", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:934", REGS),
    "fused": ("K2 fused rounds", FUSED_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:723",
              REGS + " (K1's last phases on a group)"),
    "cross": ("K3 cross", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:948",
              "first design: shared-memory tile, a barrier per stage"),
    "local": ("K4 local", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:993", REGS),
    "gate": ("K5 validity gate", BITONIC_CU,
             "vulkan_radix_sort_tpu/ops/bitonic.py:746",
             "the valid flags of K1-K4"),
    "local_gated": ("K6 gated local (slot merge)", BITONIC_CU,
                    "vulkan_radix_sort_tpu/ops/bitonic.py:793",
                    "K4 under the slot merge's block mask"),
    "block_sort": ("K7 radix block sort", RADIX_CU,
                   "vulkan_radix_sort_tpu/ops/block_sort.py:154",
                   "redesigned: match-based block rank in registers, "
                   "16-byte copies, one scatter"),
    "place": ("K8 radix placement", RADIX_CU,
              "vulkan_radix_sort_tpu/ops/stream_place.py:228",
              "first design: each key written at its run's offset"),
}
RADIX_KERNELS = ("block_sort", "place")
MERGE_KERNELS = ("local_gated",)
NETWORK_KERNELS = tuple(k for k in KERNELS
                        if k not in RADIX_KERNELS + MERGE_KERNELS)


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

# Instantiations each kernel template has in csrc/: the report must name
# every one, so that the spill check covers them all. chunk and local: C
# from 2^8 to the cap, 8 for keys and 7 for each two-word carry; fused: G
# from 2^9 to the cap, 7 + 6 + 6; block sort: keys or kv, 4 to 32 keys a
# thread, 4- or 8-bit digits.
INSTANTIATIONS = {"chunk_kernel": 22, "local_kernel": 22, "cross_kernel": 3,
                  "fused_kernel": 19, "block_sort_kernel": 16,
                  "place_kernel": 2}


def build() -> None:
    """Build the kernels and print the report; fail if any kernel spills
    registers to local memory, or if the report does not name every
    instantiation."""
    t0 = time.perf_counter()
    path, report = _build.build()
    log(f"[build] {path.name} {time.perf_counter() - t0:.1f} s")
    name, spills, names = None, [], {}
    for line in report.splitlines():
        m = re.search(r"\d([a-z_]+_kernel)I((?:L[ib]\d+E)+)E", line)
        if m:
            if "Function properties" in line:
                args = ",".join(re.findall(r"L[ib](\d+)E", m[2]))
                name = f"{m[1]}<{args}>"
                names.setdefault(m[1], set()).add(name)
                log(f"[ptxas] {name}")
        elif "Used" in line or "spill" in line:
            log("[ptxas]  ", line.split(":", 1)[-1].strip())
            if re.search(r"[1-9]\d* bytes spill", line):
                spills.append(name)
    counts = {k: len(v) for k, v in names.items()}
    log("[ptxas] instantiations:", json.dumps(counts))
    if spills:
        raise AssertionError(f"register spills in {spills}")
    if counts != INSTANTIATIONS:
        raise AssertionError(f"the report names {counts}, not "
                             f"{INSTANTIATIONS}")
    _build.library()


# -- phase 3: kernel vs plain ------------------------------------------------

def _inputs(mode, n: int, gen, device) -> list[torch.Tensor]:
    """Seeded buffers; two-word carries get few distinct keys, so the
    second word decides. The stable carry's last eighth is tied (max key,
    pad tiebreak) tuples with distinct riding values, as a count= tail
    holds them: a kernel must leave each riding value where it is."""
    lo, hi = (0, 13) if mode.words == 2 else (-(1 << 31), 1 << 31)
    k = torch.randint(lo, hi, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    rest = [torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                          device=device, dtype=torch.int32)
            for _ in range(mode.n_arrays - 1)]
    if mode.ride:
        k[-n // 8:] = -1
        rest[0][-n // 8:] = bitonic.STABLE_PAD_IDX
    return [x.view(torch.uint32) for x in [k] + rest]


def kernel_cases(mode, n: int, extra: bool):
    """(kernel, spec args, units) as the main path launches them at n
    elements with the path's chunks; with `extra`, also clipped grids, a
    single-span earlier round, a round split into more than one span, the
    chunk and local kernels at every chunk from MIN_CHUNK to the carry's
    shared-memory cap, and the fused kernel at every group from two
    MIN_CHUNK chunks to the cap (groups of MIN_CHUNK chunks and of two
    chunks, from round 1 and from the last round alone)."""
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
    if extra:  # the register kernels' geometry changes with C and G
        C = MIN_CHUNK
        while C <= mode.smem_cap:
            cases += [("chunk", (C,), n // C), ("local", (C, 1), n // C)]
            C *= 2
        G = 2 * MIN_CHUNK
        while G <= mode.smem_cap:
            for C in sorted({MIN_CHUNK, G // 2}):
                top = bk.log2(G // C)
                cases += [("fused", (C, r_lo, top), n // G)
                          for r_lo in sorted({1, top})]
            G *= 2
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


def _radix_cases(extra: bool):
    """(block, bits, key bound, shifts) of the K7/K8 checks: the main
    path's geometry at every shift; with `extra`, every block from
    RADIX_THREADS to MAX_RADIX_BLOCK (K7's threads and keys a thread
    change with it) at both digit widths, with uniform keys, few distinct
    digits (keys < 16) and one key only (every lane a peer), at every
    shift at the default block and at the lowest and highest elsewhere."""
    if not extra:
        return [(RADIX.block, RADIX.digit_bits, None,
                 range(0, 32, RADIX.digit_bits))]
    cases = []
    block = RADIX_THREADS
    while block <= MAX_RADIX_BLOCK:
        for bits in (4, 8):
            shifts = (range(0, 32, bits) if block == RADIX.block
                      else (0, 32 - bits))
            cases += [(block, bits, hi, shifts) for hi in (None, 16, 1)]
        block *= 2
    return cases


def check_radix_kernels(sizes=((N_CHECK, True), (N, False)),
                        device="cuda") -> dict[str, int]:
    """K7 and K8 against their plain versions on the same seeded inputs,
    keys and key-value (`_radix_cases`): at 2^20 at every block and both
    digit widths, and at the main path's 2^25 shapes. K8 takes K7's plain
    output, so its runs are real. Returns max |err| per kernel."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    err = {name: 0 for name in RADIX_KERNELS}
    for n, extra in sizes:
        for block, bits, hi, shifts in _radix_cases(extra):
            cfg = SortConfig(backend="radix", digit_bits=bits, block=block)
            if n % block:
                continue
            for kv in (False, True):
                for shift in shifts:
                    keys, vals = _radix_inputs(n, hi, gen, device)
                    vals = vals if kv else None
                    kw = dict(shift=shift, config=cfg, key_value=kv)
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
                    threads, per = k7.sort_geometry(block)
                    for name, got, want in (("block_sort", got7, want7),
                                            ("place", got8, want8)):
                        e = _max_abs_err(got, want)
                        err[name] = max(err[name], e)
                        geo = (f" threads={threads} keys/thread={per}"
                               if name == "block_sort" else "")
                        log(f"[kernel] n={n} {name} block={block}{geo} "
                            f"bits={bits} {'kv' if kv else 'keys'} "
                            f"shift={shift} keys<{hi or 2 ** 32} "
                            f"max_abs_err={e}")
                        if e != 0:
                            raise AssertionError(
                                f"{name} block={block} bits={bits} "
                                f"shift={shift}: the kernel differs from "
                                "its plain version")
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
                    geo = ""
                    if kernel in bk.REG_KERNELS:
                        th, per = bk.block_geometry(kernel, mode,
                                                    launch.unit)
                        geo = f" threads={th} E={per}"
                    log(f"[kernel] n={n} {kernel} {mode.name} {args} "
                        f"units={units}{geo} gated={gated} max_abs_err={e}")
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


def _stable_order(k: np.ndarray) -> np.ndarray:
    """np.argsort(k, kind="stable"), as one uint64 sort of (key, index)."""
    c = np.sort((k.astype(np.uint64) << np.uint64(32))
                | np.arange(k.size, dtype=np.uint64))
    return (c & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _stable_oracle(k: np.ndarray, v: np.ndarray):
    o = _stable_order(k)
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
            names = bk.counters(launch, valid)
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


LIBRARY_KERNELS = ("chunk", "fused")


def library_ms(rec) -> float:
    """One torch.sort call that computes what a chunk (K1) or fused (K2)
    launch computes, at its shapes: a sort along dim 1 of the live
    units as rows of `unit` elements, on seeded int32 keys (the
    sign-flipped view of uint32 keys: same order, same bytes). The stable
    carry adds stable=True and the gather of the values; the pairs carry
    sorts (k << 32 | v) as one int64. A yardstick only: the port never
    calls it."""
    launch, mode, valid = rec["launch"], rec["mode"], rec["valid"]
    units = rec["nunits"] if valid is None else int(
        valid[:rec["nunits"]].sum())
    shape = (units, launch.unit)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def rand(dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device="cuda", dtype=dtype)
    if mode is bk.STABLE:
        k, v = rand(torch.int32), rand(torch.int32)

        def fn():
            sk, perm = torch.sort(k, dim=1, stable=True)
            return sk, torch.gather(v, 1, perm)
    else:
        k = rand(torch.int32 if mode is bk.KEYS else torch.int64)

        def fn():
            return torch.sort(k, dim=1)
    return time_fn(fn) * 1e3


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


def kernel_times(sorts) -> tuple[dict, list]:
    """Per kernel over TIMED_RUNS runs of the path's sorts: launch time,
    bound and, for one run, the plain version's time at the same shapes.
    Returns the sums per kernel and every launch's record."""
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
        return dict(n=0, ms=0.0, bound=0.0, by={}, plain=0.0, nplain=0,
                    lib=0.0, nlib=0)
    per = {k: acc() for k in KERNELS}
    by_tag = {}
    one_run = len(timer.records) // TIMED_RUNS
    for i, rec in enumerate(timer.records):
        ms = rec["events"][0].elapsed_time(rec["events"][1])
        b, by = bound_ms(rec)
        pm = plain_ms(rec) if i < one_run else None
        lm = (library_ms(rec) if i < one_run
              and rec["names"][0] in LIBRARY_KERNELS else None)
        for k in rec["names"]:
            for a in (per[k], by_tag.setdefault((rec["tag"], k), acc())):
                a["n"] += 1
                a["ms"] += ms
                a["bound"] += b
                a["by"][by] = a["by"].get(by, 0.0) + b
                if pm is not None:
                    a["plain"] += pm
                    a["nplain"] += 1
                if lm is not None and k in LIBRARY_KERNELS:
                    a["lib"] += lm
                    a["nlib"] += 1
    for (tag, k), a in by_tag.items():
        lib = (f" library_ms/launch={a['lib'] / a['nlib']:.4f}"
               if a["nlib"] else "")
        log(f"[kernel-time] {tag} {k}: launches/sort={per_sort[tag][k]} "
            f"ms/launch={a['ms'] / a['n']:.4f} "
            f"bound_ms/launch={a['bound'] / a['n']:.4f} "
            f"({max(a['by'], key=a['by'].get)}) "
            f"plain_ms/launch={a['plain'] / max(a['nplain'], 1):.3f}{lib}")
    return per, timer.records


# -- phase 6: slot merges (K6) -----------------------------------------------

def slot_runs(slot: int = SLOT, seed: int = SEED + 20):
    """Four sorted runs and their values for a slot buffer: the sizes of a
    uniform 4-rank exchange (about half a slot, cut mid-block) in slots 0
    and 3 (both parities), slot 1 empty and slot 2 full. One key in 64 is a
    genuine 0xFFFFFFFF, which meets the fills; values are the slot-major
    running index."""
    rng = np.random.default_rng(seed)
    sizes = [slot // 2 + slot // 97, 0, slot, slot // 2 - slot // 61]
    runs, vals, base = [], [], 0
    for size in sizes:
        k = rng.integers(0, 2**32, size, dtype=np.uint64).astype(np.uint32)
        k[rng.random(size) < 1 / 64] = KEY_SENTINEL
        runs.append(np.sort(k))
        vals.append(np.arange(base, base + size, dtype=np.uint32))
        base += size
    return runs, vals, sizes


def slot_buffer(runs, slot: int, fill: int, prearranged: bool) -> np.ndarray:
    """Each run in its slot: ascending in the slot's prefix or, with
    prearranged, descending in the suffix of an odd slot."""
    buf = np.full((len(runs), slot), fill, np.uint32)
    for s, run in enumerate(runs):
        if prearranged and s & 1:
            buf[s, slot - run.size:] = run[::-1]
        else:
            buf[s, :run.size] = run
    return buf.reshape(-1)


def check_slot_merges(slot: int = SLOT, device="cuda") -> int:
    """merge_slots_u32 and merge_slots_pairs (stable) on a full-width slot
    buffer, prearranged both ways, bitwise against numpy; every gated local
    (K6) launch in them is held against its plain version on a copy of its
    input. Returns K6's max |err|."""
    runs, vals, sizes = slot_runs(slot)
    allk, allv = np.concatenate(runs), np.concatenate(vals)
    order = _stable_order(allk)
    want_k, want_v, total = allk[order], allv[order], allk.size
    sizes_t = torch.tensor(sizes, device=device)
    err, checked = 0, 0
    real_run = bk.run

    def checked_run(launch, arrs, mode, nunits, valid=None):
        nonlocal err, checked
        if launch.kernel != "local_gated":
            return real_run(launch, arrs, mode, nunits, valid)
        want = [a.clone() for a in arrs]
        real_run(launch, arrs, mode, nunits, valid)
        bk.run_plain(launch, want, mode, nunits, valid)
        sync(device)
        e = _max_abs_err(arrs, want)
        log(f"[kernel] n={arrs[0].numel()} local_gated {mode.name} "
            f"r={launch.cargs[1]} live={int(valid[:nunits].sum())}/{nunits} "
            f"max_abs_err={e}")
        if e != 0:
            raise AssertionError(f"local_gated {mode.name} {launch.cargs}: "
                                 "the kernel differs from its plain version")
        err, checked = max(err, e), checked + 1

    bk.run = checked_run
    try:
        for pre in (True, False):
            kb = to_dev(slot_buffer(runs, slot, KEY_SENTINEL, pre), device)
            vb = to_dev(slot_buffer(vals, slot, 0, pre), device)
            what = f"slot merge {SLOTS}x{slot} prearranged={pre}"
            _expect(bitonic.merge_slots_u32(kb, sizes_t, slot=slot,
                                            prearranged=pre)[:total],
                    want_k, f"{what} keys")
            gk, gv = bitonic.merge_slots_pairs(kb, vb, sizes_t, slot=slot,
                                               prearranged=pre)
            _expect(gk[:total], want_k, f"{what} stable kv, keys")
            _expect(gv[:total], want_v, f"{what} stable kv, values")
            del kb, vb, gk, gv
    finally:
        bk.run = real_run
    if checked == 0:
        raise AssertionError("the slot merges launched no gated local")
    return err


# -- phase 7: the distributed path -------------------------------------------

# the cases whose received slot buffers rank 0 hands back for phase 8
CAPTURE = {"keys uniform": "keys", "stable kv uniform": "stable_kv"}
WORLD_LABEL = (f"{WORLD} ranks sharing one H100, exchange through gloo on "
               "the host: not a cluster number")


def dist_cases(n: int) -> dict:
    """name -> (key distribution, key-value, global n, count=, merge
    expected). Ragged n leaves the last rank's shard short; its padding and
    the count= mask all go to the last destination's slot."""
    ragged = n - 1000
    return {
        "keys uniform": ("uniform", False, n, None, True),
        "stable kv uniform": ("uniform", True, n, None, True),
        "stable kv few": ("few", True, n, None, True),
        "keys ragged count=": ("uniform", False, ragged, ragged - n // 128,
                               True),
        "keys constant, fallback": ("constant", False, n, None, False),
    }


def dist_rank(rank: int, world: int, tmp: str, n: int, device: str,
              use_kernels) -> None:
    """One rank: its shard of each case through the public entry points,
    the launch counters zeroed just before each sort and read just after;
    outputs, counts and phase times go to `tmp`. Rank 0 also keeps the slot
    buffers the merge of each CAPTURE case received."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    vals = np.load(f"{tmp}/vals.npy", mmap_mode="r")
    captured = {}
    real_finish = td.merge_finish

    def capture(bufs, sizes, S, m, config=None):
        captured.update(bufs=bufs, sizes=sizes, S=S, m=m)
        return real_finish(bufs, sizes, S, m, config)

    td.merge_finish = capture
    report = {}
    for i, (name, (dist, kv, nn, count, _)) in enumerate(
            dist_cases(n).items()):
        keys = np.load(f"{tmp}/keys_{dist}.npy", mmap_mode="r")
        m = -(-nn // world)
        lo, hi = min(rank * m, nn), min((rank + 1) * m, nn)
        dk = to_dev(np.array(keys[lo:hi]), dev)
        dv = to_dev(np.array(vals[lo:hi]), dev) if kv else None
        captured.clear()
        phases = {}
        sync(dev)
        reset_launches()
        t = time.perf_counter()
        if kv:
            gk, gv = td.sort_pairs_sharded(dk, dv, count=count,
                                           use_kernels=use_kernels,
                                           phase_times=phases)
        else:
            gk = td.sort_sharded(dk, count=count, use_kernels=use_kernels,
                                 phase_times=phases)
        sync(dev)
        report[name] = dict(launches=launch_counts(), phases=phases,
                            wall_s=time.perf_counter() - t)
        np.save(f"{tmp}/out{i}_{rank}_k.npy", gk.cpu().numpy())
        if kv:
            np.save(f"{tmp}/out{i}_{rank}_v.npy", gv.cpu().numpy())
        if rank == 0 and name in CAPTURE and captured:
            tag = CAPTURE[name]
            for j, b in enumerate(captured["bufs"]):
                np.save(f"{tmp}/slot_{tag}_{j}.npy", b.cpu().numpy())
            np.save(f"{tmp}/slot_{tag}_sizes.npy",
                    captured["sizes"].cpu().numpy())
            report[name]["slot"] = [captured["S"], captured["m"]]
        del dk, dv, gk
    with open(f"{tmp}/report{rank}.json", "w") as f:
        json.dump(report, f)


def dist_phase(n_rank: int = N_RANK, world: int = WORLD, device="cuda:0",
               use_kernels=None):
    """A world of `world` gloo ranks, all on `device`, through each case of
    `dist_cases`, each answer bitwise against a numpy oracle made here;
    every merge case must launch cross and the gated local kernel (and
    chunk once per rank), the fallback chunk twice per rank and no gated
    local. Returns the launches of all cases summed over the ranks, and
    rank 0's received slot buffers: tag -> (buffers, sizes, S, m)."""
    n = n_rank * world
    cases = dist_cases(n)
    data = {d: datagen.generate_keys(n, seed=SEED + 10, distribution=d)
            for d in ("uniform", "few", "constant")}
    vals = datagen.generate_values(n, seed=SEED + 11)
    total = dict.fromkeys(launch_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for d, a in data.items():
            np.save(f"{tmp}/keys_{d}.npy", a)
        np.save(f"{tmp}/vals.npy", vals)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t = time.perf_counter()
        td.spawn_world(dist_rank, world, tmp, n, str(device), use_kernels,
                       init_file=f"{tmp}/store")
        log(f"[dist] {world} gloo ranks on {device}, {n_rank} keys each: "
            f"world done in {time.perf_counter() - t:.1f} s")
        reports = []
        for r in range(world):
            with open(f"{tmp}/report{r}.json") as f:
                reports.append(json.load(f))
        for i, (name, (dist, kv, nn, count, merge)) in enumerate(
                cases.items()):
            keys = data[dist][:nn]
            live = keys if count is None else keys[:count]
            order = _stable_order(live)
            wk = np.concatenate([live[order], keys[live.size:]])
            got = [np.concatenate([np.load(f"{tmp}/out{i}_{r}_{x}.npy")
                                   for r in range(world)])
                   for x in (("k", "v") if kv else ("k",))]
            _expect(torch.from_numpy(got[0]), wk, f"dist {name}, keys")
            if kv:
                wv = np.concatenate([vals[:live.size][order],
                                     vals[live.size:nn]])
                _expect(torch.from_numpy(got[1]), wv, f"dist {name}, values")
            counts = {k: sum(rep[name]["launches"][k] for rep in reports)
                      for k in total}
            for k in total:
                total[k] += counts[k]
            log(f"[launches] dist {name}", json.dumps(counts))
            ok = (counts["local_gated"] > 0 and counts["cross"] > 0
                  and counts["chunk"] == world) if merge else (
                counts["local_gated"] == 0 and counts["chunk"] == 2 * world)
            if not ok:
                raise AssertionError(
                    f"dist {name}: launches {counts} are not those of the "
                    f"{'merge' if merge else 'fallback'} path")
            worst = {}
            for rep in reports:
                for k, v in rep[name]["phases"].items():
                    worst[k] = max(worst.get(k, 0.0), v)
            log(f"[dist-time] {name} ({WORLD_LABEL}):", json.dumps({
                "rank0_wall_s": reports[0][name]["wall_s"],
                "rank0_phase_s": reports[0][name]["phases"],
                "max_over_ranks_phase_s": worst}))
        slot_bufs = {}
        for name, tag in CAPTURE.items():
            S, m = reports[0][name]["slot"]
            nb = 2 if cases[name][1] else 1
            slot_bufs[tag] = (
                [np.load(f"{tmp}/slot_{tag}_{j}.npy") for j in range(nb)],
                np.load(f"{tmp}/slot_{tag}_sizes.npy"), S, m)
    log("[launches] dist", json.dumps(total))
    return total, slot_bufs


# -- phase 8: merge times ----------------------------------------------------

def _genuine(bufs, sizes, S: int):
    """The packed arrivals again: each slot's genuine run, ascending, in
    slot order (what the fallback's full re-sort is given)."""
    out = []
    for b in bufs:
        parts = []
        for s, size in enumerate(sizes):
            seg = b[s * S:(s + 1) * S]
            parts.append(seg[S - size:][::-1] if s & 1 else seg[:size])
        out.append(np.ascontiguousarray(np.concatenate(parts)))
    return out


def _merge_pairs_ungated(kb, vb, sizes, S: int):
    """merge_slots_pairs (stable, prearranged) with no fill gating: the
    same carry through every block of every round."""
    arrs, mode, C, r_start, _ = bitonic._slot_pairs(
        kb, vb, sizes, S, CHUNK_CARRY, True, True)
    bitonic._merge_rounds(arrs, mode, kb.numel(), C, r_start)
    return arrs[0], arrs[-1]


def merge_times(slot_bufs, card: str) -> dict:
    """On rank 0's received slot buffers, alone in this process: (a) the
    merge gated by the slot sizes, (b) the same merge ungated, (c) the full
    network re-sort of the same genuine elements (the fallback's), for keys
    and stable kv; (b) and (c) are first checked against (a). Then per
    launch: the gated local (K6) against the ungated local pass of the
    same round and the gated blocks' live share. Returns kernel_times'
    sums for the merges."""
    sorts, times = {}, {"card": card}
    for tag, (bufs, sizes, S, m) in slot_bufs.items():
        dev = [to_dev(b, "cuda") for b in bufs]
        sz = to_dev(sizes.astype(np.int64), "cuda")
        packed = [to_dev(p, "cuda") for p in _genuine(bufs, sizes, S)]
        if tag == "keys":
            kb, = dev
            fns = {"gated": lambda kb=kb, sz=sz, S=S: (
                       bitonic.merge_slots_u32(kb, sz, slot=S,
                                               prearranged=True),),
                   "ungated": lambda kb=kb, S=S: (
                       bitonic.merge_slots_u32(kb, None, slot=S,
                                               prearranged=True),),
                   "full": lambda pk=packed[0]: (
                       td._local_sort(pk, None, None, True),)}
        else:
            kb, vb = dev
            fns = {"gated": lambda kb=kb, vb=vb, sz=sz, S=S:
                   bitonic.merge_slots_pairs(kb, vb, sz, slot=S,
                                             prearranged=True),
                   "ungated": lambda kb=kb, vb=vb, sz=sz, S=S:
                   _merge_pairs_ungated(kb, vb, sz, S),
                   "full": lambda pk=packed[0], pv=packed[1]:
                   td._local_sort(pk, pv, None, True)}
        want = [x[:m].cpu() for x in fns["gated"]()]
        for variant in ("ungated", "full"):
            got = [x[:m].cpu() for x in fns[variant]()]
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want)):
                raise AssertionError(f"merge {tag} {variant} differs from "
                                     "the gated merge")
        times[tag] = {f"{v}_ms": time_fn(f) * 1e3 for v, f in fns.items()}
        times[tag].update(n_slots=len(sizes), slot=S, genuine=m)
        sorts[f"merge_{tag}"] = fns["gated"]
        sorts[f"merge_{tag}_ungated"] = fns["ungated"]
    log("[merge-time]", json.dumps(times))
    per, records = kernel_times(sorts)
    rounds = {}
    for rec in records:
        kind = rec["names"][0]
        if kind in ("local", "local_gated"):
            e = rounds.setdefault(
                (rec["tag"].removesuffix("_ungated"), rec["launch"].cargs[1]),
                {"local": [], "local_gated": [], "live": 0.0})
            e[kind].append(rec["events"][0].elapsed_time(rec["events"][1]))
            if kind == "local_gated":
                e["live"] = float(rec["valid"][:rec["nunits"]].sum()) / \
                    rec["nunits"]
    for (tag, r), e in rounds.items():
        g = sum(e["local_gated"]) / len(e["local_gated"])
        u = sum(e["local"]) / len(e["local"])
        log(f"[merge-time] {tag} round {r}: local_gated {g:.4f} ms at live "
            f"share {e['live']:.3f}; ungated local {u:.4f} ms; live share x "
            f"ungated {e['live'] * u:.4f} ms; ratio "
            f"{g / (e['live'] * u):.3f}")
    gated_block_cost(slot_bufs, records)
    return per


def gated_block_cost(slot_bufs, records) -> None:
    """What gated thread blocks cost, with launches back to back (no host
    gap between them): the first K6 launch of each merge with its mask, K4
    over as many blocks as that mask has live ones, and K4 over every
    block, on the merge's own carry arrays."""
    for tag, (bufs, sizes, S, _) in slot_bufs.items():
        rec = next(r for r in records if r["tag"] == f"merge_{tag}"
                   and r["names"][0] == "local_gated")
        kb = to_dev(bufs[0], "cuda")
        if tag == "keys":
            arrs = [kb]
        else:
            arrs = bitonic._slot_pairs(
                kb, to_dev(bufs[1], "cuda"),
                to_dev(sizes.astype(np.int64), "cuda"), S, CHUNK_CARRY,
                True, True)[0]
        launch, mode, units = rec["launch"], rec["mode"], rec["nunits"]
        valid = rec["valid"]
        live = int(valid[:units].sum())
        local = bk.spec("local", launch.unit, launch.cargs[1])
        t = {"gated_ms": time_fn(bk.run, launch, arrs, mode, units, valid),
             "live_blocks_ungated_ms": time_fn(bk.run, local, arrs, mode,
                                               live),
             "all_blocks_ungated_ms": time_fn(bk.run, local, arrs, mode,
                                              units)}
        t = {k: v * 1e3 for k, v in t.items()}
        t.update(live_blocks=live, blocks=units, mode=mode.name)
        log(f"[merge-time] K6 back to back, {tag}:", json.dumps(t))


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
    per, _ = kernel_times(sorts)
    del sorts, keys, vals

    err["local_gated"] = check_slot_merges()
    dist_launches, slot_bufs = dist_phase()
    launches["local_gated"] = dist_launches["local_gated"]
    per["local_gated"] = merge_times(slot_bufs, card)["local_gated"]
    rows = []
    for key, (label, source, replaces, status) in KERNELS.items():
        p = per[key]
        rows.append({
            "name": label, "route": "cuda", "source": source,
            "replaces": replaces, "status": status,
            "launches": launches[key],
            "max_abs_err": err[key], "ms": p["ms"] / p["n"],
            "plain_ms": p["plain"] / p["nplain"],
            "bound_ms": p["bound"] / p["n"],
            "bound_by": max(p["by"], key=p["by"].get),
            "library_ms": p["lib"] / p["nlib"] if p["nlib"] else None,
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
