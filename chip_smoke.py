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
     local, and the validity gate) in the keys, pairs and stable carries
     and the 64-bit key carries w3 and w4_big, at 2^20 elements (with extra
     geometries: clipped grids, a round split into several cross spans,
     the cross kernel at every span up to the carry's cap (10 for keys,
     7 for w4_big, else 8), the chunk and local kernels at every chunk
     from 256 to the carry's register cap, the fused kernel at every
     group from 512 to the cap)
     and at the main path's 2^25 shapes. The radix backend's
     (block sort K7, the spine, placement K8 with the pass's shift and
     the spine kernel's offsets) at 2^20 at every block from 512 to
     16384 and both digit widths, with uniform keys, few distinct digits,
     two digits at every shift and one key only, then at 301 default
     blocks (no multiple of K7's resident grid) and at the main path's
     2^25 shapes on uniform keys and two digits, keys and key-value, with
     a ragged last block of sentinel pads;
  4. main path, once per backend ('network', 'radix', 'reference', then
     'auto', which picks a backend per kind of sort from the sorter's n):
     the public entry points (vrs.sort, Sorter.sort, Sorter.sort_key_value)
     at n = 2^25 and the other shapes below, each bitwise equal to a numpy
     oracle computed once for all four; each sort's launches, read from
     a launch recorder, must be those of its kind's backend (radix: K7,
     the spine and K8 exactly num_passes times; network: network kernels
     only; reference: none); the kernels' launch counters are zeroed just
     before each backend's run and read just after, and every kernel of
     that backend must have launched; then the 64-bit path (uint64, int64
     and float64 keys) through the same entry points at 2^25, on the
     network with its launches counted per carry (chunk, fused, cross,
     local and the gate must launch in both w3 and w4_big), and through
     'auto' (the '[launches] auto' line: the kernels of every backend
     'auto' picked, 32- and 64-bit, and no other);
  5. times on the card with CUDA events, of sorts that name their
     backend: end to end (network, radix and the reference backend) with
     torch.sort of the sign-flipped signed view as the yardstick, and per
     kernel
     with its bound and its plain version; for the 64-bit sorts per
     kernel and carry;
  6. slot merges: a slot buffer of 4 slots x 2^24 (slack-2 fill with the
     sizes of a uniform 4-rank exchange, one empty slot, one full slot,
     genuine 0xFFFFFFFF keys), keys and stable carries: every launch of
     the gated local kernel (K6) in the merge bitwise equal to its plain
     version, and merge_slots_u32 / merge_slots_pairs (prearranged both
     ways) bitwise equal to numpy; then the overlap path's keys half merge
     of two 2^25-key halves with fill tails (np2 = 2^26, carry chunk):
     every K3 and K4 launch bitwise equal to its plain version, the
     merged keys to numpy;
  7. the distributed path: a world of 4 gloo ranks sharing cuda:0 with
     2^25 keys each (2^27 in all) sorts through sort_sharded /
     sort_pairs_sharded (keys, stable kv uniform and few-distinct, ragged
     n with count=, constant keys that must take the fallback), each
     bitwise equal to a numpy oracle computed once here; each rank zeroes
     its launch counters just before each sort and reads them just after:
     the merge runs must launch cross and the gated local kernel, the
     fallback none of the latter. Wall time per phase of the world;
 7b. overlap, the 2-D tier and the reports: a second world of 4 gloo
     ranks on cuda:0 at 2^25 keys each: overlap=True on the 1-D world
     (keys uniform and stable kv few-distinct; then with merge_resort=True,
     keys and stable kv), then on make_mesh_2d(2, 2) keys uniform, stable
     kv few-distinct, ragged keys with count=, constant keys (the slot
     fallback), overlap=True keys and stable kv, and dcn_slack=1 on skewed
     keys, which must raise ValueError on every rank; each answer bitwise
     against numpy, each case's launches checked (chunk once per local
     sort; the gated local kernel iff a slot merge runs, as each case
     states or, for stable kv few-distinct, as numpy's size matrix says;
     the keys half merge's K3 and K4 beyond the local sorts'); then
     phase_report (with and without overlap), dcn_report on the 2 x 2
     mesh and scaling_report over 1, 2 and 4 ranks, printed as
     `[scaling]` lines (4 ranks sharing one card: no scaling figure);
  8. merge times, alone in this process on rank 0's received slot
     buffers: the merge gated by the slot sizes, the same merge ungated,
     and the full network re-sort the fallback runs, keys and stable kv;
     and K6 per launch against the ungated local pass.
  9. stages: Sorter.sort_timed / sort_key_value_timed at 2^25 (network
     keys, stable and non-stable kv, uint64 keys; radix keys): each
     network sort's recorded launches must equal one sort's launch
     counters, and its stage sum must lie within [0.8, 1.05] of its
     total;
 10. adaptive: SortConfig(adaptive=True) network sorts at 2^25 on
     sorted, reverse, constant and uniform keys and stable kv on sorted
     and reverse keys, each against numpy; the fast paths must launch no
     network kernel, the others must, and a timed adaptive sort of
     uniform keys must launch the kernels on every call; the detection's
     own cost against a full sort;
 11. sweep: the bench harness's `measure` for the network, radix and
     reference backends at 2^14 to 2^25 (keys, kv, kvns), each after
     its correctness gate, one point of the native C++ engine, and the
     sizes from which network and radix beat the reference backend;
     `[sweep64]`, the same for uint64 keys, network against reference
     (radix refuses them); `[auto]`, for each key width and sort kind at
     every swept size, the backend Sorter(n) picks and its ms beside the
     fastest backend of the sweep, and the engine and cut this run
     measured beside the constants of models/sorter.py (report only);
 12. profile: one profiling.trace around network keys sorts at 2^25:
     device time by kernel name (K1-K4) and the device's busy share of
     the traced window; then one around a radix keys sort at 2^25, whose
     device work from its first K7 to its last K8 must be K7, the spine
     and K8 once a pass and nothing else.
Then the `kernels` JSON line (each network row with its 64-bit carries'
figures under "w3" and "w4_big"; K7 and K8 with their keys and kv
figures under "keys" and "kv", K8 with the spine's under "spine";
`launches` counts the launches on the
path of the kernel's backend, `auto_launches` those on the 'auto'
path), the card's name and power limit as nvidia-smi gives them, and
last the {"ok": true, ...} result line.
"""

from __future__ import annotations

import json
import os
import re
import statistics
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
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
from vulkan_radix_sort_tpu_torch.parallel import distributed as td
from vulkan_radix_sort_tpu_torch.parallel import scaling
from vulkan_radix_sort_tpu_torch.bench import harness
from vulkan_radix_sort_tpu_torch.models import sorter as sorter_mod
from vulkan_radix_sort_tpu_torch.utils import datagen, profiling, timing
from vulkan_radix_sort_tpu_torch.utils.timing import time_fn

N = 1 << 25          # the reference's headline size
N_RAGGED = (1 << 24) + 4096
N_CHECK = 1 << 20    # kernel-vs-plain size
SEED = 0
TIMED_RUNS = 3
NETWORK = SortConfig(backend="network")
RADIX = SortConfig(backend="radix")
REFERENCE = SortConfig(backend="reference")
RAGGED_TAIL = 1000   # sentinel pads closing the last block of a K7/K8 check
TWO_DIGITS = -2      # `_radix_inputs`: keys of two digits at every shift
# 301 blocks of the default 16384 keys: no multiple of K7's resident grid
# (132 SMs on an H100), so thread blocks walk 2 or 3 blocks each
N_ODD = 301 * (1 << 14)
WORLD = 4            # ranks of the distributed path, all on cuda:0
N_RANK = 1 << 25     # keys per rank (2^27 in all)
SLOTS, SLOT = 4, 1 << 24  # the slot buffer of 4 ranks x 2^25: slack 2

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet); int32 132 SMs x 64
# INT32 lanes x 1.98 GHz boost = 16.7 Top/s (Hopper architecture white
# paper: 16 INT32 units in each of an SM's four partitions).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per compare-exchange. keys: one min and one max (the
# direction only picks the slot each lands in). Carries of two and three
# words: one compare per compared word and one select per word the pair
# writes.
OPS_PER_CE = {"keys": 2, "pairs": 2 + 4, "stable": 2 + 6, "w3": 3 + 6,
              "w4_big": 3 + 8}
# integer operations per key of a radix kernel. Block sort: the digit (a
# shift and a mask), its count, and the add of its rank to its digit's
# base. Placement: the digit (a shift and a mask) and the add of its
# delta. Spine, per histogram entry: the add to the column's running sum
# in each of its two reads, and the add of the base.
OPS_PER_KEY = {"block_sort": 4, "place": 3}
OPS_PER_SPINE_ENTRY = 3

BITONIC_CU = "vulkan_radix_sort_tpu_torch/csrc/bitonic.cu"
FUSED_CU = "vulkan_radix_sort_tpu_torch/csrc/fused.cu"
RADIX_CU = "vulkan_radix_sort_tpu_torch/csrc/radix.cu"
W64_CU = "vulkan_radix_sort_tpu_torch/csrc/network_w64.cu"
WIDE_CUH = "vulkan_radix_sort_tpu_torch/csrc/wide.cuh"  # their K1 and K2
REGS = "redesigned: registers, warp shuffles, a transpose pair per phase"
KERNELS = {  # counter name -> (label, source, TPU kernel replaced, status)
    "chunk": ("K1 chunk", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:934",
              f"keys, pairs, stable: {REGS}; w3, w4_big: redesigned "
              "(csrc/wide.cuh): w3 a merge sort (16 elements a thread in "
              "registers, then merge-path levels through shared memory), "
              "w4_big the network at 16 elements a thread, far stages in "
              "registers after a transpose, run-time loops over one copy of "
              "each stage; both with a borrow-chain compare"),
    "fused": ("K2 fused rounds", FUSED_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:723",
              f"keys, pairs, stable, w4_big: {REGS} (K1's last phases on a "
              "group); w3: redesigned (csrc/wide.cuh), w4_big's K1 "
              "network in persistent blocks that stage the next group in "
              "shared memory (cp.async) while they sort the current one"),
    "cross": ("K3 cross", BITONIC_CU,
              "vulkan_radix_sort_tpu/ops/bitonic.py:948",
              "redesigned for keys, pairs, stable: register columns "
              "(8-byte vectors, 32 or 16 span positions a thread), one "
              "transpose (one barrier) for deeper spans; w3, w4_big: "
              "first design, shared-memory tile, a barrier per stage"),
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
                   "redesigned twice: resident blocks that walk the "
                   "blocks, keys loaded ahead and sorted blocks stored by "
                   "the bulk copy engine (TMA), ranks from shared match "
                   "words (atomic OR) and one count add a digit group"),
    "place": ("K8 radix placement", RADIX_CU,
              "vulkan_radix_sort_tpu/ops/stream_place.py:228",
              "redesigned: digit from the key, one shared delta lookup a "
              "key, 512-key tiles with every load issued first; the spine "
              "one cluster launch"),
}
# the radix kernels in launch order; the spine is K8's column accumulation
# (the TPU kernel's own), so the K8 row carries it
RADIX_KERNELS = ("block_sort", "spine", "place")
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
# from 2^8 to the register cap, 8 for keys, 7 for each two-word carry and
# 6 for each three-word one, whose chunks take csrc/wide.cuh's kernels (the
# merge sort in w3, the network up to 2^12 in w4_big; chunk_kernel at 2^13);
# fused: G from 2^9 to the cap, 7 + 6 + 6 + 5 (w4_big), and 5 of
# fused_wide_kernel (w3); cross: the register-column kernel at every span from 1 to the
# cap, 10 for keys and 8 for pairs and stable, the shared-memory one in
# w3 and w4_big; block sort: keys or kv, 4 to 32 keys a thread, 4- or
# 8-bit digits; placement: keys or kv; spine: one cluster size.
INSTANTIATIONS = {"chunk_kernel": 23, "chunk_merge_kernel": 6,
                  "chunk_wide_kernel": 5, "local_kernel": 34,
                  "cross_kernel": 2, "cross_cols_kernel": 26,
                  "fused_kernel": 24, "fused_wide_kernel": 5,
                  "block_sort_kernel": 16, "place_kernel": 2,
                  "spine_kernel": 1}


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

def _inputs(mode, n: int, gen, device, tail: int | None = None
            ) -> list[torch.Tensor]:
    """Seeded buffers; every compared word but the last takes few distinct
    values, so the next word decides. The stable carries hold tied (max
    key, pad tiebreak) tuples with distinct riding values from `tail` on
    (by default the last eighth), as a count= tail holds them: a kernel
    must leave each riding value where the network puts it."""
    def rand(lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    arrs = [rand(0, 13) for _ in range(mode.words - 1)]
    arrs += [rand() for _ in range(mode.ride + 1)]
    if mode.ride:
        start = n - n // 8 if tail is None else tail
        for a in arrs[:mode.words - 1]:
            a[start:] = -1
        arrs[mode.words - 1][start:] = bitonic.STABLE_PAD_IDX
    return [x.view(torch.uint32) for x in arrs]


def straddling_tail(n: int) -> int:
    """Where a stable carry's tied tail starts mid-chunk, as a count= that
    is no multiple of the chunk leaves it."""
    return n - n // 8 - CHUNK_CARRY // 2 - 3


def kernel_cases(mode, n: int, extra: bool):
    """(kernel, spec args, units) as the main path launches them at n
    elements with the path's chunks; with `extra`, also clipped grids, a
    single-span earlier round, a round split into more than one span, the
    cross kernel at every span from 1 to the carry's cap, or to the
    largest round n holds (the round's lowest and highest stages,
    MIN_CHUNK chunks, a clipped grid), the chunk and local kernels at
    every chunk from MIN_CHUNK to the carry's
    register cap, and the fused kernel at every group from two MIN_CHUNK
    chunks to the cap (groups of MIN_CHUNK chunks and of two chunks, from
    round 1 and from the last round alone)."""
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
    if extra:  # the cross kernel's geometry changes with the span
        top = min(mode.cross_cap, bk.log2(n // MIN_CHUNK))
        units = max(n // (MIN_CHUNK << top) - 1, 1)
        cases += [("cross", (MIN_CHUNK, top, t_lo, s), units)
                  for s in range(1, top + 1)
                  for t_lo in sorted({0, top - s})]
    if extra:  # the register kernels' geometry changes with C and G
        C = MIN_CHUNK
        while C <= mode.reg_cap:
            cases += [("chunk", (C,), n // C), ("local", (C, 1), n // C)]
            C *= 2
        G = 2 * MIN_CHUNK
        while G <= mode.reg_cap:
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
    """Seeded keys (below `hi`, if given, for few distinct digits; with
    `hi` = TWO_DIGITS, every byte 0x2a or 0x2b, so that about 16 lanes of
    a slot share each digit) whose last RAGGED_TAIL slots are sentinel
    pads, as `radix.sort_u32` pads a ragged last block; and seeded values,
    0 under the pads."""
    lo, top = (0, hi) if hi and hi > 0 else (-(1 << 31), 1 << 31)
    k = torch.randint(lo, top, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    if hi == TWO_DIGITS:
        k = 0x2A2A2A2A + (k & 0x01010101)
    v = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                      device=device, dtype=torch.int32)
    k[-RAGGED_TAIL:] = KEY_SENTINEL - (1 << 32)
    v[-RAGGED_TAIL:] = 0
    return k.view(torch.uint32), v.view(torch.uint32)


def _radix_cases(extra: bool):
    """(block, bits, key bound, shifts) of the K7/K8 checks: the main
    path's geometry at every shift, on uniform keys and on keys of two
    digits; with `extra`, every block from RADIX_THREADS to
    MAX_RADIX_BLOCK (K7's threads and keys a thread change with it) at
    both digit widths, with uniform keys, few distinct digits (keys < 16),
    two digits at every shift (about 16 peers a lane) and one key only
    (every lane a peer), at every shift at the default block and at the
    lowest and highest elsewhere."""
    if not extra:
        return [(RADIX.block, RADIX.digit_bits, hi,
                 range(0, 32, RADIX.digit_bits)) for hi in (None, TWO_DIGITS)]
    cases = []
    block = RADIX_THREADS
    while block <= MAX_RADIX_BLOCK:
        for bits in (4, 8):
            shifts = (range(0, 32, bits) if block == RADIX.block
                      else (0, 32 - bits))
            cases += [(block, bits, hi, shifts)
                      for hi in (None, 16, TWO_DIGITS, 1)]
        block *= 2
    return cases


def _keys_label(hi: int | None) -> str:
    return "keys=two-digits" if hi == TWO_DIGITS else f"keys<{hi or 2**32}"


RADIX_CHECK_SIZES = ((N_CHECK, True), (N_ODD, False), (N, False))


def check_radix_kernels(sizes=RADIX_CHECK_SIZES,
                        device="cuda") -> dict[str, int]:
    """K7, the spine and K8 against their plain versions on the same
    seeded inputs, keys and key-value (`_radix_cases`): at 2^20 at every
    block and both digit widths, at 301 default blocks (K7's resident
    thread blocks walk 2 or 3 blocks each) and at the main path's 2^25
    shapes (15 or 16 each). The
    spine and K8 take K7's plain output, so their runs are real; K8 takes
    the pass's shift and the spine kernel's offsets, as a radix pass
    launches it. Returns max |err| per kernel."""
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
                    got_sp = k8.spine(hist)
                    want_sp = k8.spine_plain(hist)
                    args8 = (y, hist, want_sp[0], want7[1] if kv else None)
                    kw8 = dict(config=cfg, key_value=kv)
                    got8 = k8.stream_place(*args8, **kw8, shift=shift,
                                           offsets=got_sp[1])
                    want8 = k8.stream_place_plain(*args8, **kw8)
                    if not kv:
                        got8, want8 = (got8,), (want8,)
                    sync(device)
                    threads, per = k7.sort_geometry(block)
                    for name, got, want in (("block_sort", got7, want7),
                                            ("spine", got_sp, want_sp),
                                            ("place", got8, want8)):
                        e = _max_abs_err(got, want)
                        err[name] = max(err[name], e)
                        geo = (f" threads={threads} keys/thread={per}"
                               if name == "block_sort" else "")
                        log(f"[kernel] n={n} {name} block={block}{geo} "
                            f"bits={bits} {'kv' if kv else 'keys'} "
                            f"shift={shift} "
                            f"{_keys_label(hi)} "
                            f"max_abs_err={e}")
                        if e != 0:
                            raise AssertionError(
                                f"{name} block={block} bits={bits} "
                                f"shift={shift}: the kernel differs from "
                                "its plain version")
                    del keys, vals, got7, want7, got_sp, want_sp, got8, \
                        want8, args8
    return err


def check_kernels(sizes=((N_CHECK, True), (N, False)), device="cuda",
                  by_mode: dict | None = None,
                  radix_sizes=RADIX_CHECK_SIZES) -> dict[str, int]:
    """Each network kernel against its plain version on the same seeded
    inputs, with and without a validity mask that has zeros, in every
    carry: at 2^20 with extra geometries, and at the main path's own
    shapes (2^25); then the radix kernels at `radix_sizes`
    (`check_radix_kernels`). Returns
    max |err| per kernel; `by_mode` gets it per (kernel, carry) too."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    err = {name: 0 for name in NETWORK_KERNELS}
    by_mode = {} if by_mode is None else by_mode
    for n, extra in sizes:
        for mode in bk.MODES:
            cases = [(c, None) for c in kernel_cases(mode, n, extra)]
            if extra and mode.ride:  # the main path's launches, the tied
                # tail starting mid-chunk
                cases += [(c, straddling_tail(n))
                          for c in kernel_cases(mode, n, False)]
            for (kernel, args, units), tail in cases:
                launch = bk.spec(kernel, *args)
                for gated in (False, True):
                    valid = None
                    if gated:
                        valid = torch.randint(0, 2, (units,), generator=gen,
                                              device=device, dtype=torch.int32)
                        valid[0] = 0
                    a = _inputs(mode, n, gen, device, tail)
                    b = [x.clone() for x in a]
                    bk.run(launch, a, mode, units, valid)
                    bk.run_plain(launch, b, mode, units, valid)
                    sync(device)
                    e = _max_abs_err(a, b)
                    key = "gate" if gated else kernel
                    err[key] = max(err[key], e)
                    by_mode[key, mode.name] = max(
                        by_mode.get((key, mode.name), 0), e)
                    geo = ""
                    if kernel in bk.REG_KERNELS:
                        th, per = bk.block_geometry(kernel, mode,
                                                    launch.unit)
                        geo = f" threads={th} E={per}"
                    if tail is not None:
                        geo += f" tail={tail}"
                    log(f"[kernel] n={n} {kernel} {mode.name} {args} "
                        f"units={units}{geo} gated={gated} max_abs_err={e}")
                    if e != 0:
                        raise AssertionError(
                            f"{kernel} {mode.name} {args}: the kernel "
                            "differs from its plain version")
                    del a, b
    err.update(check_radix_kernels(radix_sizes, device))
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


def _recorded(timer: timing.LaunchTimer) -> dict[str, int]:
    """Launches by counter name in a LaunchTimer's records (on the CPU,
    the plain versions that stand in for the kernels)."""
    got = {}
    for rec in timer.records:
        for k in rec["names"]:
            got[k] = got.get(k, 0) + 1
    return got


def check_backend_launches(backend: str, got: dict[str, int],
                           config: SortConfig, what: str) -> None:
    """One sort's launches against the backend that ran it: radix launches
    K7, the spine and K8 exactly num_passes times each and no network
    kernel; the
    network launches network kernels and no radix kernel; the reference
    backend launches no kernel."""
    net = sum(got.get(k, 0) for k in NETWORK_KERNELS + MERGE_KERNELS)
    rad = {k: got.get(k, 0) for k in RADIX_KERNELS}
    ok = {"radix": net == 0 and set(rad.values()) == {config.num_passes},
          "network": net > 0 and not any(rad.values()),
          "reference": not any(got.values())}[backend]
    if not ok:
        raise AssertionError(f"{what}: the {backend} backend launched {got}")


def kind_backends(sorter) -> dict[str, str]:
    return {"keys": sorter.backend, "kv": sorter.backend_kv,
            "kvns": sorter.backend_kvns}


def held_runs(sorter, tag: str):
    """run(kind, fn, ...) and run_kv(fn, ..., stable=...): call fn inside
    a launch recorder and hold its launches to the sorter's backend of
    that kind (`check_backend_launches`)."""
    backends = kind_backends(sorter)

    def run(kind, fn, *args, **kw):
        with timing.LaunchTimer() as timer:
            out = fn(*args, **kw)
        check_backend_launches(backends[kind], _recorded(timer),
                               sorter.config, f"{tag}{kind} sort")
        return out

    def run_kv(fn, *args, stable=True, **kw):
        return run("kv" if stable else "kvns", fn, *args, stable=stable,
                   **kw)
    return run, run_kv


def main_path(n: int = N, n_ragged: int = N_RAGGED, device="cuda",
              config: SortConfig | None = None,
              oracles: dict | None = None) -> dict[str, str]:
    """The port's entry points at full size with `config`: NETWORK, RADIX,
    or None for 'auto', which picks a backend per kind of sort (keys,
    stable kv, non-stable kv) from the sorter's n. Each result against a
    numpy oracle; `oracles` caches each oracle, so a later backend's run
    reuses the first's. Every sort's launches are read from a launch
    recorder and held to its kind's backend (`check_backend_launches`).

    The radix and reference backends are stable either way, so their
    stable=False answers are held to the stable oracle, the network's to
    the (key, value) order. Returns the backend of each kind."""
    oracles = {} if oracles is None else oracles

    def want(key, fn):
        if key not in oracles:
            oracles[key] = fn()
        return oracles[key]

    sorter = vrs.Sorter(n, device=device, config=config)
    # vrs.sort and vrs.sort_key_value build a sorter of the same n and
    # config: the same backends
    backends = kind_backends(sorter)
    tag = ("auto " if config is None else
           "" if config.backend == "network" else f"{config.backend} ")
    log(f"[main] {tag or 'network '}backends at n={n}:",
        json.dumps(backends))
    run, run_kv = held_runs(sorter, tag)

    nonstable_network = backends["kvns"] == "network"
    ns_oracle, ns = ((_pairs_oracle, "pairs") if nonstable_network
                     else (_stable_oracle, "stable"))
    keys = want("keys", lambda: datagen.generate_keys(n, seed=SEED))
    vals = want("vals", lambda: datagen.generate_values(n, seed=SEED + 1))
    dk, dv = to_dev(keys, device), to_dev(vals, device)

    _expect(run("keys", vrs.sort, dk, config=config),
            want("sort", lambda: np.sort(keys)), f"{tag}keys uniform")
    gk, gv = run_kv(sorter.sort_key_value, dk, dv)
    wk, wv = want("stable", lambda: _stable_oracle(keys, vals))
    _expect(gk, wk, f"{tag}stable kv uniform, keys")
    _expect(gv, wv, f"{tag}stable kv uniform, values")
    gk, gv = run_kv(vrs.sort_key_value, dk, dv, config=config, stable=False)
    wk, wv = want(ns, lambda: ns_oracle(keys, vals))
    _expect(gk, wk, f"{tag}non-stable kv uniform, keys")
    _expect(gv, wv, f"{tag}non-stable kv uniform, values")

    # ragged: the grid clip and the group-granularity skip rule matter
    m = n_ragged
    _expect(run("keys", sorter.sort, dk[:m]),
            want("sort ragged", lambda: np.sort(keys[:m])),
            f"{tag}keys ragged")
    gk, gv = run_kv(sorter.sort_key_value, dk[:m], dv[:m])
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
    gk, gv = run_kv(sorter.sort_key_value, dmk, dv)
    wk, wv = want("stable max", lambda: _stable_oracle(mk, vals))
    _expect(gk, wk, f"{tag}stable kv with 0xFFFFFFFF keys, keys")
    _expect(gv, wv, f"{tag}stable kv with 0xFFFFFFFF keys, values")
    count = n - n // 11 - 12345
    cnt = torch.tensor(count, device=device)

    def prefix_sorted():
        w = mk.copy()
        w[:count] = np.sort(mk[:count])
        return w
    _expect(run("keys", sorter.sort, dmk, count=cnt),
            want("sort count", prefix_sorted), f"{tag}keys count=")
    for stable in (True, False):
        what = f"{tag}{'stable' if stable else 'non-stable'} kv count="
        gk, gv = run_kv(sorter.sort_key_value, dmk, dv, count=cnt,
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
        _expect(run("keys", sorter.sort, dk2),
                want(f"sort {dist}", lambda: np.sort(k2)),
                f"{tag}keys {dist}")
        gk, gv = run_kv(sorter.sort_key_value, dk2, dv)
        wk, wv = want(f"stable {dist}", lambda: _stable_oracle(k2, vals))
        _expect(gk, wk, f"{tag}stable kv {dist}, keys")
        _expect(gv, wv, f"{tag}stable kv {dist}, values")

    ki = keys.view(np.int32)
    _expect(run("keys", vrs.sort, to_dev(ki, device), config=config),
            want("sort int32", lambda: np.sort(ki)), f"{tag}int32 keys")
    kf = want("float32", lambda: np.random.default_rng(
        SEED + 3).standard_normal(n, dtype=np.float32))
    _expect(run("keys", vrs.sort, to_dev(kf, device), config=config),
            want("sort float32", lambda: np.sort(kf)), f"{tag}float32 keys")
    return backends


# the 64-bit path ------------------------------------------------------------

SIGN64 = np.uint64(1 << 63)
MAX64 = np.uint64(2**64 - 1)


def encode64(k: np.ndarray) -> np.ndarray:
    """numpy: the order-preserving uint64 encoding of uint64, int64 and
    float64 keys (float64: IEEE total order, NaNs of either sign outside
    the infinities), as the port's encoders compute it."""
    b = k.view(np.uint64)
    if k.dtype == np.int64:
        return b ^ SIGN64
    if k.dtype == np.float64:
        return b ^ np.where(b >> np.uint64(63) == 1, MAX64, SIGN64)
    return b


def keys64(n: int, seed: int = SEED + 30) -> np.ndarray:
    """Seeded uint64 keys: uniform, but a quarter with one high word (the
    low word decides), a quarter drawn from 1000 keys (ties: the index or
    the value decides), and every 97th the maximum 2^64 - 1."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    k[::4] = (k[::4] & np.uint64(0xFFFFFFFF)) | np.uint64(0xDEADBEEF << 32)
    k[1::4] = rng.choice(k[2:2002:2], k[1::4].size)
    k[::97] = MAX64
    return k


def floats64(n: int, seed: int = SEED + 31) -> np.ndarray:
    k = np.random.default_rng(seed).standard_normal(n)
    k[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, np.copysign(np.nan, -1)]
    k[6::1001] = -0.0
    return k


def _expect64(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    """Bitwise: 64-bit keys through their uint64 bit patterns."""
    g = got.cpu().numpy()
    if g.shape != want.shape or not np.array_equal(g.view(np.uint64),
                                                   want.view(np.uint64)):
        raise AssertionError(f"{what}: differs from the numpy oracle")
    log(f"[main] {what}: ok")


def main_path64(n: int = N, n_ragged: int = N_RAGGED, device="cuda",
                config: SortConfig | None = None,
                oracles: dict | None = None) -> dict[str, str]:
    """64-bit keys through the port's entry points at full size with
    `config` (NETWORK, or None for 'auto'), each result against a numpy
    oracle (the sort of the encoded words): uint64 keys-only (on the
    network the (k, v) carry on (hi, lo)), stable key-value (w4_big) and
    non-stable (w3: equal keys by ascending value; the reference backend's
    answer is the stable one), a ragged n, count= as a device tensor on
    keys and both key-value modes, and int64 and float64 keys. Every
    sort's launches are held to its kind's backend. Returns the backend of
    each kind."""
    oracles = {} if oracles is None else oracles

    def want(key, fn):
        if key not in oracles:
            oracles[key] = fn()
        return oracles[key]

    sorter = vrs.Sorter(n, key_dtype=torch.uint64, device=device,
                        config=config)
    backends = kind_backends(sorter)
    tag = "auto " if config is None else ""
    log(f"[main] {tag or 'network '}u64 backends at n={n}:",
        json.dumps(backends))
    run, run_kv = held_runs(sorter, f"{tag}u64 ")

    def order(k, v, stable):
        if stable or backends["kvns"] != "network":
            return np.argsort(k, kind="stable")
        return np.lexsort((v, k))

    keys = want("keys64", lambda: keys64(n))
    vals = want("vals", lambda: datagen.generate_values(n, seed=SEED + 1))
    dk, dv = to_dev(keys, device), to_dev(vals, device)

    _expect64(run("keys", vrs.sort, dk, config=config),
              want("sort64", lambda: np.sort(keys)), f"{tag}u64 keys")
    o = want("stable64", lambda: order(keys, vals, True))
    gk, gv = run_kv(sorter.sort_key_value, dk, dv)
    _expect64(gk, keys[o], f"{tag}u64 stable kv, keys")
    _expect(gv, vals[o], f"{tag}u64 stable kv, values")
    o = (want("pairs64", lambda: order(keys, vals, False))
         if backends["kvns"] == "network" else o)
    gk, gv = run_kv(vrs.sort_key_value, dk, dv, config=config, stable=False)
    _expect64(gk, keys[o], f"{tag}u64 non-stable kv, keys")
    _expect(gv, vals[o], f"{tag}u64 non-stable kv, values")

    m = n_ragged
    _expect64(run("keys", sorter.sort, dk[:m]),
              want("sort64 ragged", lambda: np.sort(keys[:m])),
              f"{tag}u64 keys ragged")
    o = want("stable64 ragged", lambda: order(keys[:m], vals[:m], True))
    gk, gv = run_kv(sorter.sort_key_value, dk[:m], dv[:m])
    _expect64(gk, keys[:m][o], f"{tag}u64 stable kv ragged, keys")
    _expect(gv, vals[:m][o], f"{tag}u64 stable kv ragged, values")

    count = n - n // 11 - 12345
    cnt = torch.tensor(count, device=device)
    pk, pv = keys[:count], vals[:count]
    _expect64(run("keys", sorter.sort, dk, count=cnt),
              np.concatenate([want("sort64 count", lambda: np.sort(pk)),
                              keys[count:]]), f"{tag}u64 keys count=")
    for stable in (True, False):
        what = f"{tag}u64 {'stable' if stable else 'non-stable'} kv count="
        nonstable = not stable and backends["kvns"] == "network"
        o = want(f"{'pairs' if nonstable else 'stable'}64 count",
                 lambda: order(pk, pv, stable))
        gk, gv = run_kv(sorter.sort_key_value, dk, dv, count=cnt,
                        stable=stable)
        _expect64(gk, np.concatenate([pk[o], keys[count:]]), f"{what}, keys")
        _expect(gv, np.concatenate([pv[o], vals[count:]]),
                f"{what}, values")
    del dk, dv, gk, gv

    ki = keys.view(np.int64)
    _expect64(run("keys", vrs.sort, to_dev(ki, device), config=config),
              want("sort int64", lambda: np.sort(ki)), f"{tag}int64 keys")
    kf = want("floats64", lambda: floats64(n))
    uf = encode64(kf)
    got = run("keys", vrs.sort, to_dev(kf, device), config=config)
    _expect64(torch.from_numpy(encode64(got.cpu().numpy())),
              want("sort float64", lambda: np.sort(uf)),
              f"{tag}float64 keys (IEEE total order)")
    o = want("stable float64", lambda: np.argsort(uf, kind="stable"))
    gk, gv = run_kv(vrs.sort_key_value, to_dev(kf, device),
                    to_dev(vals, device), config=config)
    _expect64(gk, kf[o], f"{tag}float64 stable kv, keys")
    _expect(gv, vals[o], f"{tag}float64 stable kv, values")
    return backends


W64_CARRIES = ("w3", "w4_big")
W64_KERNELS = ("chunk", "fused", "cross", "local", "gate")


def _path_launches64(oracles) -> dict:
    """Drive the 64-bit path with the counters zeroed just before and read
    just after; each of K1-K5 must have launched in both w3 and w4_big.
    Returns the launches per carry and kernel: the launch recorder's
    records attributed to their carries, which must add up to the
    counters."""
    reset_launches()
    with timing.LaunchTimer() as timer:
        main_path64(config=NETWORK, oracles=oracles)
        torch.cuda.synchronize()
    counts = {}
    for rec in timer.records:
        carry = rec["mode"].name if "mode" in rec else "radix"
        c = counts.setdefault(carry, dict.fromkeys(launch_counts(), 0))
        for k in rec["names"]:
            c[k] += 1
    log("[launches] w64", json.dumps(counts))
    summed = {k: sum(c[k] for c in counts.values()) for k in launch_counts()}
    if summed != launch_counts():
        raise AssertionError(f"carries {summed} against counters "
                             f"{launch_counts()}")
    missing = [(c, k) for c in W64_CARRIES for k in W64_KERNELS
               if counts.get(c, {}).get(k, 0) == 0]
    if missing:
        raise AssertionError(f"not launched on the 64-bit path: {missing}")
    return counts


# -- phase 5: times ----------------------------------------------------------

def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


def bound_ms(rec) -> tuple[float, str]:
    """Least time for a launch's work: HBM bytes (each input read and each
    output written once) or int32 operations, whichever is larger. Network:
    every element of the units it runs, through its stages (W3's chunk
    kernel, a merge sort: `merge_ops`). K7: keys (and values) in and out
    plus the histogram out. Spine: the histogram in, the run offsets and
    g out. K8: keys (and values), the histogram and the run offsets in,
    keys (and values) out."""
    if rec["names"][0] == "spine":
        entries = rec["nblocks"] * rec["radix"]
        return _bound(4 * (2 * entries + rec["radix"]),
                      entries * OPS_PER_SPINE_ENTRY)
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
    ops = len(launch.stages) * (elems // 2) * OPS_PER_CE[mode.name]
    if (launch.kernel, mode) == ("chunk", bk.W3):
        ops = merge_ops(launch.unit) * elems
    return _bound(2 * elems * 4 * mode.n_arrays, ops)


def merge_ops(C: int) -> float:
    """int32 operations an element of W3's chunk kernel, a merge sort
    (csrc/wide.cuh): the network on a thread's E registers, then one
    compare (a compare per word) and a select per word for each element at
    each of log2(C / E) merge levels."""
    threads, e = bk.block_geometry("chunk", bk.W3, C)
    le = bk.log2(e)
    return (le * (le + 1) // 2 * OPS_PER_CE["w3"] / 2
            + bk.log2(C // e) * OPS_PER_CE["w3"])


def _u32_zeros(n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device="cuda").view(torch.uint32)


def plain_ms(rec) -> float:
    """One run of the launch's plain version at the launch's shapes (on
    zeros for the network; for the spine and K8, on K7's output for seeded
    keys, so its runs are real)."""
    n = rec.get("numel")
    if rec["names"][0] == "spine":
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        cfg = SortConfig(backend="radix",
                         digit_bits=rec["radix"].bit_length() - 1)
        keys, _ = _radix_inputs(rec["nblocks"] * cfg.block, None, gen,
                                "cuda")
        hist = k7.block_sort(keys, shift=0, config=cfg)[-1]

        def plain():
            k8.spine_plain(hist)
    elif rec["names"][0] in RADIX_KERNELS:
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
            g = k8.digit_offsets(out[-1])

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
    carries add stable=True and the gather of the values (w4_big sorts
    int64 keys, its (hi, lo) words as one); the pairs carry sorts
    (k << 32 | v) as one int64. None for w3: no single call sorts
    (hi, lo, v). A yardstick only: the port never calls it."""
    launch, mode, valid = rec["launch"], rec["mode"], rec["valid"]
    units = rec["nunits"] if valid is None else int(
        valid[:rec["nunits"]].sum())
    shape = (units, launch.unit)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def rand(dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device="cuda", dtype=dtype)
    if mode is bk.W3:
        return None
    if mode.ride:
        k = rand(torch.int32 if mode is bk.STABLE else torch.int64)
        v = rand(torch.int32)

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
    five, and the radix and reference backends' keys, stable kv and keys
    count=."""
    keys = to_dev(datagen.generate_keys(n, seed=SEED), "cuda")
    vals = to_dev(datagen.generate_values(n, seed=SEED + 1), "cuda")
    sorter = vrs.Sorter(n, config=NETWORK)
    rsorter = vrs.Sorter(n, config=RADIX)
    ref = vrs.Sorter(n, config=REFERENCE)
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
        "reference_keys": lambda: ref.sort(keys),
        "reference_stable_kv": lambda: ref.sort_key_value(keys, vals),
        "reference_keys_count": lambda: ref.sort(keys, count=cnt),
    }
    return sorts, keys, vals


def path_sorts64(n: int = N):
    """The 64-bit path's sorts at n on uniform uint64 keys, as closures
    for timing: the network's keys, stable and non-stable kv, each also
    with count=, and the reference backend's keys and stable kv."""
    rng = np.random.default_rng(SEED + 32)
    keys = to_dev(rng.integers(0, 2**64, n, dtype=np.uint64), "cuda")
    vals = to_dev(datagen.generate_values(n, seed=SEED + 1), "cuda")
    sorter = vrs.Sorter(n, key_dtype=torch.uint64, config=NETWORK)
    ref = vrs.Sorter(n, key_dtype=torch.uint64, config=REFERENCE)
    cnt = torch.tensor(n - n // 11 - 12345, device="cuda")
    sorts = {
        "u64_keys": lambda: sorter.sort(keys),
        "u64_stable_kv": lambda: sorter.sort_key_value(keys, vals),
        "u64_nonstable_kv": lambda: sorter.sort_key_value(keys, vals,
                                                          stable=False),
        "u64_keys_count": lambda: sorter.sort(keys, count=cnt),
        "u64_stable_kv_count": lambda: sorter.sort_key_value(keys, vals,
                                                             count=cnt),
        "u64_nonstable_kv_count": lambda: sorter.sort_key_value(
            keys, vals, count=cnt, stable=False),
        "u64_reference_keys": lambda: ref.sort(keys),
        "u64_reference_stable_kv": lambda: ref.sort_key_value(keys, vals),
    }
    return sorts, keys, vals


def e2e_times(sorts, keys, vals, card: str, lib: str = "library") -> dict:
    e2e = {"card": card, "n": N}
    for name, fn in sorts.items():
        s = time_fn(fn, iters=10, repeats=5)
        e2e[f"{name}_ms"] = s * 1e3
        e2e[f"{name}_gitems_per_s"] = N / s / 1e9
    # Yardsticks: the port calls torch.sort on no kernel path; its
    # reference backend is this same sort (ops/reference.py). torch.sort
    # has no CUDA kernel for uint32 (or uint64), so it sorts the int32
    # (int64) bit patterns with the sign bit flipped (same order, same
    # bytes).
    bits = 8 * keys.element_size()
    signed = torch.int32 if bits == 32 else torch.int64
    flipped = keys.view(signed) ^ -(1 << (bits - 1))
    v32 = vals.view(torch.int32)
    e2e[f"{lib}_keys_ms"] = time_fn(lambda: torch.sort(flipped)) * 1e3

    def lib_kv():
        sk, perm = torch.sort(flipped, stable=True)
        return sk, v32[perm]
    e2e[f"{lib}_stable_kv_ms"] = time_fn(lib_kv) * 1e3
    log("[e2e]", json.dumps(e2e))
    return e2e


def kernel_times(sorts, by_mode: bool = False) -> tuple[dict, list]:
    """Per kernel over TIMED_RUNS runs of the path's sorts: launch time,
    bound and, for one run, the plain version's time at the same shapes.
    Returns the sums per kernel (per (kernel, carry) with `by_mode`; else
    the network kernels also per (kernel, carry), K7 and K8 per (kernel,
    "keys" | "kv")) and every launch's record."""
    for fn in sorts.values():  # warm
        fn()
    torch.cuda.synchronize()
    per_sort = {}  # launches of one sort, from the kernels' counters
    with timing.LaunchTimer() as timer:
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
    per = {} if by_mode else {k: acc() for k in KERNELS}
    by_tag = {}
    one_run = len(timer.records) // TIMED_RUNS
    for i, rec in enumerate(timer.records):
        ms = rec["events"][0].elapsed_time(rec["events"][1])
        b, by = bound_ms(rec)
        pm = plain_ms(rec) if i < one_run else None
        lm = (library_ms(rec) if i < one_run
              and rec["names"][0] in LIBRARY_KERNELS else None)
        carry = rec["mode"].name if "mode" in rec else ""
        for k in rec["names"]:
            slots = [(k, carry) if by_mode else k]
            if "key_value" in rec and not by_mode:
                slots.append((k, "kv" if rec["key_value"] else "keys"))
            elif carry and not by_mode:
                slots.append((k, carry))
            for a in (*(per.setdefault(x, acc()) for x in slots),
                      by_tag.setdefault((rec["tag"], k, carry), acc())):
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
    for (tag, k, carry), a in by_tag.items():
        lib = (f" library_ms/launch={a['lib'] / a['nlib']:.4f}"
               if a["nlib"] else "")
        label = f"{tag} {carry}" if by_mode else tag
        log(f"[kernel-time] {label} {k}: launches/sort={per_sort[tag][k]} "
            f"ms/launch={a['ms'] / a['n']:.4f} "
            f"bound_ms/launch={a['bound'] / a['n']:.4f} "
            f"({max(a['by'], key=a['by'].get)}) "
            f"share={a['bound'] / a['ms']:.3f} "
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


def _held_run(kernels, device, tally: dict, errs: dict):
    """A stand-in for `bk.run`: each launch of one of `kernels` runs its
    plain version too, on a copy of its inputs, and must give the same
    bits; tally[kernel] counts the launches so held, errs[kernel] keeps
    their max |err|. Other launches run as they are."""
    real_run = bk.run

    def run(launch, arrs, mode, nunits, valid=None):
        if launch.kernel not in kernels:
            return real_run(launch, arrs, mode, nunits, valid)
        want = [a.clone() for a in arrs]
        real_run(launch, arrs, mode, nunits, valid)
        bk.run_plain(launch, want, mode, nunits, valid)
        sync(device)
        e = _max_abs_err(arrs, want)
        live = ("" if valid is None else
                f" live={int(valid[:nunits].sum())}/{nunits}")
        log(f"[kernel] n={arrs[0].numel()} {launch.kernel} {mode.name} "
            f"cargs={launch.cargs}{live} max_abs_err={e}")
        if e != 0:
            raise AssertionError(f"{launch.kernel} {mode.name} "
                                 f"{launch.cargs}: the kernel differs from "
                                 "its plain version")
        tally[launch.kernel] = tally.get(launch.kernel, 0) + 1
        errs[launch.kernel] = max(errs.get(launch.kernel, 0), e)

    return run


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
    held, errs, real_run = {}, {}, bk.run
    bk.run = _held_run(MERGE_KERNELS, device, held, errs)
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
    if not held:
        raise AssertionError("the slot merges launched no gated local")
    return errs["local_gated"]


def check_halves_merge(m: int = N_RANK, device="cuda") -> None:
    """The keys half merge of the overlap path (`_bitonic_merge_halves`)
    at the shape phase 7b gives it: two ascending m-key halves with fill
    tails (A's genuine prefix a little over m/2, B's the rest, genuine
    0xFFFFFFFF keys among them), merged at np2 = 2m on the carry chunk.
    Every K3 and K4 launch is held against its plain version on a copy of
    its input, and the m keys out against numpy."""
    rng = np.random.default_rng(SEED + 40)
    rA = m // 2 + m // 97
    keys = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    keys[rng.random(m) < 1 / 64] = KEY_SENTINEL
    halves = [np.concatenate([np.sort(part), np.full(m - part.size,
                                                     KEY_SENTINEL, np.uint32)])
              for part in (keys[:rA], keys[rA:])]
    sA, sB = (to_dev(h, device) for h in halves)
    held, errs, real_run = {}, {}, bk.run
    bk.run = _held_run(("cross", "local"), device, held, errs)
    try:
        got = td._bitonic_merge_halves(sA, sB)
    finally:
        bk.run = real_run
    _expect(got, np.sort(keys), f"half merge of two {m}-key halves")
    want = {k: v for k, v in _halves_launches(m).items() if v}
    if held != want:
        raise AssertionError(f"the half merge held launches {held}, not "
                             f"{want}")
    log(f"[main] half merge of two {m}-key halves (np2={2 * m}, chunk "
        f"{min(CHUNK_CARRY, 2 * m)}): launches {json.dumps(held)} held "
        f"against their plain versions, max_abs_err={max(errs.values())}, "
        "ok")


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


# -- phase 7b: overlap, the 2-D tier and the scaling reports -----------------

WORLD2_LABEL = f"{WORLD} ranks sharing one H100, gloo"


def dist2_cases(n: int, world: int = WORLD) -> dict:
    """name -> case: `mesh` (on the 2 x world/2 mesh, else the 1-D world),
    key distribution, kv, global n and count=, the call's options, and
    what its launches must show: `sorts`, local sorts a rank runs (K1
    launches; None: one where the slots fit, else two), `merge` (the gated
    local kernel runs; None: where the slots fit, read from the host's own
    size matrix, `_slots_fit`), `halves` (the keys half merge's K3 and K4
    run beyond the local sorts), `error` (a ValueError naming it, on every
    rank)."""
    ragged = n - 1000
    mesh = dict(mesh=True)
    return {
        "1-D overlap keys uniform": dict(
            dist="uniform", overlap=True, merge_resort=False, sorts=3,
            merge=False, halves=True),
        "1-D overlap stable kv few": dict(
            dist="few", kv=True, overlap=True, merge_resort=False, sorts=3,
            merge=False),
        "1-D overlap+merge keys uniform": dict(
            dist="uniform", overlap=True, merge_resort=True, sorts=1,
            merge=True, halves=True),
        "1-D overlap+merge stable kv uniform": dict(
            dist="uniform", kv=True, overlap=True, merge_resort=True,
            sorts=1, merge=True),
        "2-D keys uniform": dict(mesh, dist="uniform", sorts=1, merge=True),
        "2-D stable kv few": dict(mesh, dist="few", kv=True, sorts=None,
                                  merge=None),
        "2-D keys ragged count=": dict(
            mesh, dist="uniform", n=ragged, count=ragged - n // 128,
            sorts=1, merge=True),
        "2-D keys constant, fallback": dict(mesh, dist="constant", sorts=2,
                                            merge=False),
        "2-D overlap keys uniform": dict(mesh, dist="uniform", overlap=True,
                                         sorts=3, merge=False, halves=True),
        "2-D overlap stable kv uniform": dict(mesh, dist="uniform", kv=True,
                                              overlap=True, sorts=3,
                                              merge=False),
        "2-D dcn_slack=1 on skewed keys": dict(mesh, dist="skew",
                                               dcn_slack=1,
                                               error="dcn_slack"),
    }


def skewed_keys(n: int, world: int, seed: int = SEED + 12) -> np.ndarray:
    """Keys whose hop-A staging overflows dcn_slack=1 on the 2 x world/2
    mesh: the ranks of ici index 0 (0 and world/2) hold small keys, every
    other rank 0xF0000000, so both hosts' index-0 ranks send their whole
    shards to one staging rank of host 0 (2m > 1 x m)."""
    m = n // world
    keys = np.full(n, 0xF0000000, np.uint32)
    small = datagen.generate_keys(2 * m, seed=seed) % np.uint32(1000)
    keys[:m], keys[world // 2 * m:(world // 2 + 1) * m] = small[:m], small[m:]
    return keys


def dist2_rank(rank: int, world: int, tmp: str, n: int, device: str,
               use_kernels, iters: int) -> None:
    """One rank of phase 7b: each case of `dist2_cases` through the public
    entry points with the launch counters zeroed just before the sort and
    read just after; then the three reports. Outputs and reports go to
    `tmp`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = td.make_mesh_2d(2, world // 2)
    vals = np.load(f"{tmp}/vals.npy", mmap_mode="r")
    report = {}
    for i, (name, case) in enumerate(dist2_cases(n, world).items()):
        nn = case.get("n", n)
        keys = np.load(f"{tmp}/keys_{case['dist']}.npy", mmap_mode="r")
        m = -(-nn // world)
        lo, hi = min(rank * m, nn), min((rank + 1) * m, nn)
        dk = to_dev(np.array(keys[lo:hi]), dev)
        dv = to_dev(np.array(vals[lo:hi]), dev) if case.get("kv") else None
        kw = dict(group=mesh if case.get("mesh") else None,
                  count=case.get("count"), use_kernels=use_kernels,
                  overlap=case.get("overlap", False),
                  merge_resort=case.get("merge_resort"),
                  dcn_slack=case.get("dcn_slack"), phase_times={})
        rep = {}
        sync(dev)
        reset_launches()
        t = time.perf_counter()
        try:
            with timing.LaunchTimer() as timer:
                if dv is not None:
                    gk, gv = td.sort_pairs_sharded(dk, dv, **kw)
                else:
                    gk = td.sort_sharded(dk, **kw)
                sync(dev)
            rep["wall_s"] = time.perf_counter() - t
            np.save(f"{tmp}/out{i}_{rank}_k.npy", gk.cpu().numpy())
            if dv is not None:
                np.save(f"{tmp}/out{i}_{rank}_v.npy", gv.cpu().numpy())
        except ValueError as e:
            rep["error"] = str(e)
        counts = launch_counts()
        if dev.type == "cpu":  # a rehearsal: plain versions count nothing
            counts = dict.fromkeys(counts, 0)
            for rec in timer.records:
                for k in rec["names"]:
                    counts[k] += 1
        report[name] = dict(rep, launches=counts, phases=kw["phase_times"])
    kw = dict(use_kernels=use_kernels, iters=iters, device=device)
    reports = {"phase_report": scaling.phase_report(None, n, **kw),
               "phase_report overlap": scaling.phase_report(
                   None, n, overlap=True, **kw),
               "dcn_report": scaling.dcn_report(mesh, n, **kw),
               "scaling_report": scaling.scaling_report(
                   n // world, [1, 2, world], **kw)}
    with open(f"{tmp}/report{rank}.json", "w") as f:
        json.dump({"cases": report, "reports": reports}, f)


def _oracle(data, cache, dist: str, nn: int, count, kv: bool):
    """Keys (and values) the sort of case (dist, nn, count, kv) must give:
    the live prefix sorted (stably, for kv), the tail untouched."""
    key = (dist, nn, count, kv)
    if key not in cache:
        keys = data[dist][:nn]
        live = keys if count is None else keys[:count]
        if kv:
            o = _stable_order(live)
            vals = data["vals"]
            cache[key] = (np.concatenate([live[o], keys[live.size:]]),
                          np.concatenate([vals[:live.size][o],
                                          vals[live.size:nn]]))
        else:
            cache[key] = (np.concatenate([np.sort(live), keys[live.size:]]),)
    return cache[key]


def _slots_fit(keys: np.ndarray, world: int) -> bool:
    """Whether the exchange of `keys` (n a multiple of `world`, sharded
    evenly) fits the merge re-sort's slots: no block of its size matrix
    above `slot_size`. The matrix as the port cuts it: rank d receives
    the positions [d*m, (d+1)*m) of the stable sorted order."""
    m = keys.size // world
    src = _stable_order(keys) // m
    blocks = np.bincount(src * world + np.arange(keys.size) // m,
                         minlength=world * world)
    return int(blocks.max()) <= td.slot_size(m, world)


def _halves_launches(m: int) -> dict[str, int]:
    """Launches of one keys half merge of two m-key halves
    (`_bitonic_merge_halves` at the default carry chunk)."""
    np2 = bitonic._next_pow2(2 * m)
    C = min(CHUNK_CARRY, np2)
    return {"cross": len(bitonic._cross_spans(bk.log2(np2 // C), bk.KEYS)),
            "local": 1}


def dist2_phase(n_rank: int = N_RANK, world: int = WORLD, device="cuda:0",
                use_kernels=None, iters: int = 3) -> None:
    """Phase 7b: a world of `world` gloo ranks on `device` through each
    case of `dist2_cases` (overlap=True on the 1-D world, with and without
    the merge re-sort; the 2 x world/2 mesh with and without overlap),
    each answer bitwise against a numpy oracle and each case's launches
    checked; then the three reports (`parallel/scaling.py`), printed. The
    per-sort launches of a local keys sort of one shard are measured here
    first, apart from the cases."""
    n = n_rank * world
    cases = dist2_cases(n, world)
    data = {d: datagen.generate_keys(n, seed=SEED + 10, distribution=d)
            for d in ("uniform", "few", "constant")}
    data["skew"] = skewed_keys(n, world)
    data["vals"] = datagen.generate_values(n, seed=SEED + 11)
    reset_launches()
    bitonic.sort_u32(to_dev(data["uniform"][:n_rank], device))
    sync(device)
    per_sort = launch_counts()
    halves = _halves_launches(n_rank)
    with tempfile.TemporaryDirectory() as tmp:
        for d, a in data.items():
            np.save(f"{tmp}/{'vals' if d == 'vals' else 'keys_' + d}.npy", a)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t = time.perf_counter()
        td.spawn_world(dist2_rank, world, tmp, n, str(device), use_kernels,
                       iters, init_file=f"{tmp}/store")
        log(f"[dist2d] {world} gloo ranks on {device}, {n_rank} keys each, "
            f"mesh 2 x {world // 2}: world done in "
            f"{time.perf_counter() - t:.1f} s")
        reps = []
        for r in range(world):
            with open(f"{tmp}/report{r}.json") as f:
                reps.append(json.load(f))
        cache = {}
        for i, (name, case) in enumerate(cases.items()):
            runs = [rep["cases"][name] for rep in reps]
            if "error" in case:
                if not all(case["error"] in run.get("error", "")
                           for run in runs):
                    raise AssertionError(f"{name}: not refused on every "
                                         f"rank: {runs}")
                log(f"[main] {name}: ValueError on every rank, ok")
                continue
            errors = [run["error"] for run in runs if "error" in run]
            if errors:
                raise AssertionError(f"{name}: {errors[0]}")
            kv = case.get("kv", False)
            want = _oracle(data, cache, case["dist"], case.get("n", n),
                           case.get("count"), kv)
            for x, w in zip("kv", want):
                got = np.concatenate([np.load(f"{tmp}/out{i}_{r}_{x}.npy")
                                      for r in range(world)])
                _expect(torch.from_numpy(got), w,
                        f"{name}, {'keys' if x == 'k' else 'values'}")
            counts = {k: sum(run["launches"][k] for run in runs)
                      for k in per_sort}
            merge = case["merge"]
            if merge is None:
                merge = _slots_fit(data[case["dist"]][:case.get("n", n)],
                                   world)
            sorts = world * (case["sorts"] or (1 if merge else 2))
            log(f"[launches] {'overlap' if case.get('overlap') else 'dist2d'}"
                f" {name}", json.dumps(counts))
            bad = []
            if counts["chunk"] != sorts:  # one K1 launch a local sort
                bad.append(f"chunk {counts['chunk']}, not {sorts} local "
                           "sorts")
            if (counts["local_gated"] > 0) != merge:
                bad.append(f"local_gated {counts['local_gated']} where the "
                           f"slot merge {'runs' if merge else 'does not'}")
            if case.get("halves"):
                # the half merge: K3 and K4 beyond the local sorts' (and,
                # with the slot merges, K4 beyond; their K3 adds more)
                extra = {k: counts[k] - sorts * per_sort[k]
                         for k in ("cross", "local")}
                need = {k: world * v for k, v in halves.items()}
                if extra["local"] != need["local"] or (
                        extra["cross"] < need["cross"]) or (
                        not merge and extra["cross"] != need["cross"]):
                    bad.append(f"cross/local beyond the local sorts "
                               f"{extra}, not {need}")
            if bad:
                raise AssertionError(f"{name}: " + "; ".join(bad))
            tag = "[overlap]" if case.get("overlap") else "[dist2d]"
            log(f"{tag} {name} ({WORLD2_LABEL}):", json.dumps({
                "rank0_wall_s": runs[0]["wall_s"],
                "max_over_ranks_wall_s": max(r["wall_s"] for r in runs),
                "rank0_phase_s": runs[0]["phases"]}))
        for what, rep in reps[0]["reports"].items():
            if any(r["reports"][what] != rep for r in reps[1:]):
                raise AssertionError(f"{what} differs between ranks")
            for row in rep if isinstance(rep, list) else [rep]:
                log(f"[scaling] {what} ({WORLD2_LABEL}):", json.dumps(row))


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


# -- phase 9: per-stage times -------------------------------------------------

STAGE_ITERS = 5
NET_LAUNCHES = ("chunk", "fused", "cross", "local")  # K5 counts no launch


def stages_phase(n: int = N) -> dict:
    """Sorter.sort_timed / sort_key_value_timed on the network (keys,
    stable and non-stable kv, uint64 keys) and the radix backend (keys).
    Each network sort's recorded launches must equal one sort's launch
    counters, and its three stage sums must lie within [0.8, 1.05] of its
    total."""
    keys = to_dev(datagen.generate_keys(n, seed=SEED), "cuda")
    vals = to_dev(datagen.generate_values(n, seed=SEED + 1), "cuda")
    k64 = to_dev(np.random.default_rng(SEED + 32).integers(
        0, 2**64, n, dtype=np.uint64), "cuda")
    net, rad = vrs.Sorter(n, config=NETWORK), vrs.Sorter(n, config=RADIX)
    net64 = vrs.Sorter(n, key_dtype=torch.uint64, config=NETWORK)
    cases = {
        "keys": (lambda i: net.sort_timed(keys, iters=i),
                 lambda: net.sort(keys)),
        "stable_kv": (lambda i: net.sort_key_value_timed(keys, vals, iters=i),
                      lambda: net.sort_key_value(keys, vals)),
        "nonstable_kv": (lambda i: net.sort_key_value_timed(
            keys, vals, stable=False, iters=i),
            lambda: net.sort_key_value(keys, vals, stable=False)),
        "u64_keys": (lambda i: net64.sort_timed(k64, iters=i),
                     lambda: net64.sort(k64)),
        "radix_keys": (lambda i: rad.sort_timed(keys, iters=i),
                       lambda: rad.sort(keys)),
    }
    out = {}
    for name, (timed, once) in cases.items():
        t = timed(STAGE_ITERS)
        reset_launches()
        once()
        torch.cuda.synchronize()
        counts = launch_counts()
        stages = t.upsweep_ns + t.spine_ns + t.downsweep_ns
        row = {"upsweep_ms": t.upsweep_ns / 1e6, "spine_ms": t.spine_ns / 1e6,
               "downsweep_ms": t.downsweep_ns / 1e6,
               "stage_sum_ms": stages / 1e6, "total_ms": t.total_ns / 1e6,
               "cpu_ms": t.cpu_ns / 1e6,
               "stage_sum_over_total": stages / t.total_ns}
        if name.startswith("radix"):
            row["launches_per_sort"] = {k: counts[k] for k in RADIX_KERNELS}
            if any(counts[k] != RADIX.num_passes for k in RADIX_KERNELS):
                raise AssertionError(f"[stages] {name}: {counts}")
        else:
            one_sort = sum(counts[k] for k in NET_LAUNCHES)
            row.update(mode=t.extra["mode"], rounds=t.extra["rounds"],
                       recorded_launches=len(t.extra["kernels"]),
                       launches_per_sort=one_sort)
            if len(t.extra["kernels"]) != one_sort:
                raise AssertionError(
                    f"[stages] {name}: {len(t.extra['kernels'])} recorded "
                    f"launches, {one_sort} counted in one sort")
            if not 0.8 <= stages / t.total_ns <= 1.05:
                raise AssertionError(f"[stages] {name}: stage sum "
                                     f"{stages / 1e6:.3f} ms against total "
                                     f"{t.total_ns / 1e6:.3f} ms")
        log(f"[stages] {name}", json.dumps(row))
        out[name] = row
    return out


# -- phase 10: adaptive fast paths ---------------------------------------------

def _net_launches() -> int:
    return sum(launch_counts()[k] for k in NET_LAUNCHES)


def adaptive_phase(n: int = N, card: str = "") -> dict:
    """SortConfig(adaptive=True) on the network at n: keys on sorted,
    reverse, constant and uniform inputs, stable kv on sorted and reverse
    keys with duplicates; each against numpy. The fast paths (keys
    sorted / reverse / constant, kv sorted) must launch no network kernel,
    the others must; a timed adaptive sort of uniform keys must launch the
    kernels on every timed call. Also the cost of the detection alone
    (its pass and the host read) against a full network sort."""
    s = vrs.Sorter(n, config=SortConfig(backend="network", adaptive=True))
    out = {"card": card, "n": n}
    uniform = None
    for dist in ("sorted", "reverse", "constant", "uniform"):
        k_np = datagen.generate_keys(n, seed=SEED + 40, distribution=dist)
        k = to_dev(k_np, "cuda")
        reset_launches()
        got = s.sort(k)
        torch.cuda.synchronize()
        launched = _net_launches()
        _expect(got, np.sort(k_np), f"adaptive keys {dist}")
        fast = dist != "uniform"
        if (launched == 0) != fast:
            raise AssertionError(f"adaptive keys {dist}: {launched} network "
                                 "launches")
        ms = time_fn(lambda: s.sort(k)) * 1e3
        out[f"keys_{dist}"] = {"launches": launched, "ms": ms}
        log(f"[adaptive] keys {dist}: launches={launched} ms={ms:.4f}")
        if dist == "uniform":
            uniform = k
    vals = datagen.generate_values(n, seed=SEED + 41)
    dup = np.sort(datagen.generate_keys(n, seed=SEED + 42) >> np.uint32(20))
    for dist, k_np in (("sorted", dup), ("reverse", dup[::-1].copy())):
        k, v = to_dev(k_np, "cuda"), to_dev(vals, "cuda")
        reset_launches()
        gk, gv = s.sort_key_value(k, v)
        torch.cuda.synchronize()
        launched = _net_launches()
        wk, wv = _stable_oracle(k_np, vals)
        _expect(gk, wk, f"adaptive stable kv {dist}, keys")
        _expect(gv, wv, f"adaptive stable kv {dist}, values")
        if (launched == 0) != (dist == "sorted"):
            raise AssertionError(f"adaptive kv {dist}: {launched} network "
                                 "launches")
        ms = time_fn(lambda: s.sort_key_value(k, v)) * 1e3
        out[f"stable_kv_{dist}"] = {"launches": launched, "ms": ms}
        log(f"[adaptive] stable kv {dist}: launches={launched} ms={ms:.4f}")
    # time_fn calls the sort on the same unsorted keys each time: every
    # call (warm-up and timed) must run the engine
    reset_launches()
    warmup, iters, repeats = 1, 3, 2
    time_fn(lambda: s.sort(uniform), iters=iters, repeats=repeats,
            warmup=warmup)
    calls = warmup + iters * repeats
    chunks = launch_counts()["chunk"]
    if chunks != calls:
        raise AssertionError(f"timed adaptive sort: {chunks} chunk launches "
                             f"in {calls} calls")
    log(f"[adaptive] timed uniform: {calls} calls, {chunks} chunk launches")
    u = uniform  # uint32 keys encode to themselves
    detect = time_fn(lambda: sorter_mod._adaptive_sort(u, lambda x: x))
    t0 = time.perf_counter()
    for _ in range(10):
        sorter_mod._adaptive_sort(u, lambda x: x)
    host = (time.perf_counter() - t0) / 10
    full = time_fn(lambda: vrs.Sorter(n, config=NETWORK).sort(uniform))
    out.update(detect_ms=detect * 1e3, detect_host_ms=host * 1e3,
               full_sort_ms=full * 1e3, detect_over_sort=detect / full)
    log("[adaptive]", json.dumps(out))
    return out


# -- phase 11: the harness's sweep ---------------------------------------------

SWEEP_SIZES = tuple(1 << p for p in range(14, 26))
SWEEP_SORTS = ("keys", "kv", "kvns")
SWEEP_ITERS = 5


def crossover(mine: dict, ref: dict) -> int | None:
    """Smallest swept n from which `mine` is faster than `ref` at every
    larger size (None: not at the largest)."""
    at = None
    for n in sorted(mine, reverse=True):
        if mine[n] >= ref[n]:
            break
        at = n
    return at


def crossovers(ms: dict, engines) -> dict:
    """For each engine and sort kind, `crossover` against the reference
    backend over the sizes of `ms` ((backend, sort, n) -> ms)."""
    sizes = {n for _, _, n in ms}
    return {f"{name}_{sort}": crossover(
        {n: ms[name, sort, n] for n in sizes},
        {n: ms["reference", sort, n] for n in sizes})
        for name in engines for sort in SWEEP_SORTS}


def sweep_phase(card: str) -> dict:
    """harness.measure for the three card backends at powers of two from
    2^14 to 2^25, keys, kv and kvns, each backend after its correctness
    gate (nonstable included); one cpp point; the sizes from which the
    network and radix beat the reference (torch.sort) backend. Returns
    the device ms by (backend, sort, n)."""
    ms = {}
    for name in ("network", "radix", "reference"):
        b = harness.make_backend(name)
        harness.check_correctness(b, 1 << 16, nonstable=True)
        rows = []
        for n in SWEEP_SIZES:
            for sort in SWEEP_SORTS:
                r = harness.measure(b, n, sort, iters=SWEEP_ITERS)
                ms[name, sort, n] = r.gpu_ms
                rows.append({"n": n, "sort": sort, "gpu_ms": r.gpu_ms,
                             "cpu_ms": r.cpu_ms,
                             "gitems_s": r.gpu_gitems_s})
        log("[sweep]", json.dumps({"backend": name, "card": card,
                                   "gate": "ok", "results": rows}))
    cpp = harness.make_backend("cpp")
    harness.check_correctness(cpp, 1 << 16)
    rows = [{"n": r.n, "sort": r.sort, "ms": r.gpu_ms,
             "gitems_s": r.gpu_gitems_s}
            for r in (harness.measure(cpp, 1 << 20, sort, iters=3)
                      for sort in ("keys", "kv"))]
    log("[sweep]", json.dumps({"backend": "cpp", "host": True,
                               "results": rows}))
    log("[sweep] crossover vs reference",
        json.dumps(crossovers(ms, ("network", "radix"))))
    return ms


# -- phase 11b: the 64-bit sweep ----------------------------------------------

SWEEP64_BACKENDS = ("network", "reference")  # radix refuses 64-bit keys


def sweep64_inputs(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded uniform uint64 keys and uint32 values; the sweep sorts
    prefixes of them."""
    rng = np.random.default_rng(SEED + 33)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    vals = datagen.generate_values(n, seed=SEED + 34)
    return to_dev(keys, device), to_dev(vals, device)


def sort_calls(sorter, keys, vals) -> dict:
    """Sort kind -> a closure that sorts these tensors with `sorter`, on
    the same unsorted input every call."""
    return {"keys": lambda: sorter.sort(keys),
            "kv": lambda: sorter.sort_key_value(keys, vals),
            "kvns": lambda: sorter.sort_key_value(keys, vals, stable=False)}


def sort_ms(fn) -> float:
    """Device ms of one call, as harness.measure times a card backend."""
    return time_fn(fn, iters=SWEEP_ITERS, warmup=1) * 1e3


def gate64(backend: str, n: int, device="cuda") -> None:
    """The correctness gate of a 64-bit sweep backend, as the harness's:
    a uint64 sorter on `backend` at n against numpy, keys and stable kv
    exact, stable=False with exact keys and the (key, value) multiset
    kept."""
    keys, vals = sweep64_inputs(n, device)
    k_np, v_np = keys.cpu().numpy(), vals.cpu().numpy()
    s = vrs.Sorter(n, key_dtype=torch.uint64, device=device,
                   config=SortConfig(backend=backend))
    got = {kind: fn() for kind, fn in sort_calls(s, keys, vals).items()}
    o = np.argsort(k_np, kind="stable")
    _expect64(got["keys"], k_np[o], f"sweep64 {backend} gate keys")
    _expect64(got["kv"][0], k_np[o], f"sweep64 {backend} gate kv, keys")
    _expect(got["kv"][1], v_np[o], f"sweep64 {backend} gate kv, values")
    gk, gv = (x.cpu().numpy() for x in got["kvns"])
    _expect64(torch.from_numpy(gk), k_np[o],
              f"sweep64 {backend} gate kvns, keys")
    want, have = np.lexsort((v_np, k_np)), np.lexsort((gv, gk))
    _expect(torch.from_numpy(gv[have]), v_np[want],
            f"sweep64 {backend} gate kvns, (key, value) multiset")


def sweep64_phase(card: str, sizes=SWEEP_SIZES) -> dict:
    """uint64 keys: the network against the reference backend for keys,
    kv and kvns at powers of two from 2^14 to 2^25, each backend after its
    gate; device time with CUDA events on the same unsorted input every
    call; the sizes from which the network beats the reference. Returns
    the device ms by (backend, sort, n)."""
    keys, vals = sweep64_inputs(max(sizes), "cuda")
    ms = {}
    for name in SWEEP64_BACKENDS:
        gate64(name, 1 << 16)
        rows = []
        for n in sizes:
            s = vrs.Sorter(n, key_dtype=torch.uint64,
                           config=SortConfig(backend=name))
            for sort, fn in sort_calls(s, keys[:n], vals[:n]).items():
                t = ms[name, sort, n] = sort_ms(fn)
                rows.append({"n": n, "sort": sort, "gpu_ms": t,
                             "gitems_s": n / t / 1e6})
        log("[sweep64]", json.dumps({"backend": name, "card": card,
                                     "keys": "uint64", "gate": "ok",
                                     "results": rows}))
    log("[sweep64] crossover vs reference",
        json.dumps(crossovers(ms, ("network",))))
    return ms


def median_sweeps(card: str, repeats: int = 3) -> tuple[dict, dict]:
    """`sweep_phase` and `sweep64_phase` `repeats` times in turns; the
    median of each (backend, sort, n) point, logged with its runs'
    least and most as `[sweep-median]` lines (uint32, then uint64) with
    the crossovers of the medians. Returns the two median tables, which
    `auto_phase` takes in place of one sweep's."""
    runs = [(sweep_phase(card), sweep64_phase(card)) for _ in range(repeats)]
    out = []
    for i, (keys, engines) in enumerate((("uint32", ("network", "radix")),
                                         ("uint64", ("network",)))):
        tables = [r[i] for r in runs]
        med = {p: statistics.median(t[p] for t in tables) for p in tables[0]}
        rows = [{"backend": b, "sort": s, "n": n, "ms": med[b, s, n],
                 "lo": min(t[b, s, n] for t in tables),
                 "hi": max(t[b, s, n] for t in tables)}
                for b, s, n in sorted(med)]
        log("[sweep-median]", json.dumps({
            "card": card, "keys": keys, "repeats": repeats,
            "crossover": crossovers(med, engines), "results": rows}))
        out.append(med)
    return out[0], out[1]


# -- phase 11c: what 'auto' picks ---------------------------------------------

# the kernel backends that sort each width, the candidates for its engine
ENGINES = {False: ("network", "radix"), True: ("network",)}


def auto_report(wide: bool, ms: dict, auto: dict, sizes=SWEEP_SIZES) -> dict:
    """For each sort kind of one key width: at each swept size the backend
    'auto' picked and its ms (`auto`: (sort, n) -> (backend, ms)), and the
    fastest backend of the same run's sweep (`ms`: (backend, sort, n) ->
    ms) with its ms; the engine and cut this run measured (the candidate
    fastest at the largest size, and its crossover against the reference)
    beside the constants of models/sorter.py."""
    out = {}
    top = max(sizes)
    for sort in SWEEP_SORTS:
        engine = min(ENGINES[wide], key=lambda b: ms[b, sort, top])
        cut = crossover({n: ms[engine, sort, n] for n in sizes},
                        {n: ms["reference", sort, n] for n in sizes})
        const_engine, const_cut = sorter_mod.AUTO[sort, wide]
        rows = []
        for n in sizes:
            best = min((b for b, s, m in ms if s == sort and m == n),
                       key=lambda b: ms[b, sort, n])
            picked, t = auto[sort, n]
            rows.append({"n": n, "picked": picked, "ms": t, "best": best,
                         "best_ms": ms[best, sort, n]})
        out[sort] = {"engine_measured": engine, "cut_measured": cut,
                     "engine_constant": const_engine,
                     "cut_constant": const_cut, "sizes": rows}
    return out


def auto_phase(card: str, ms32: dict, ms64: dict, sizes=SWEEP_SIZES) -> dict:
    """Sorter(n) with 'auto' at every swept size, 32- and 64-bit keys: the
    backend each kind picks and its device ms (the 32-bit sweep's inputs,
    and the 64-bit sweep's), reported by `auto_report` against the same
    run's sweeps. Report only: no time gates it."""
    k64, v64 = sweep64_inputs(max(sizes), "cuda")
    out = {}
    for wide, ms in ((False, ms32), (True, ms64)):
        auto = {}
        for n in sizes:
            if wide:
                k, v = k64[:n], v64[:n]
            else:  # harness.measure's inputs
                k = to_dev(datagen.generate_keys(n, seed=0), "cuda")
                v = to_dev(datagen.generate_keys(n, seed=1), "cuda")
            s = vrs.Sorter(n, key_dtype=torch.uint64 if wide
                           else torch.uint32)
            picks = kind_backends(s)
            for sort, fn in sort_calls(s, k, v).items():
                auto[sort, n] = (picks[sort], sort_ms(fn))
        width = "u64" if wide else "u32"
        report = auto_report(wide, ms, auto, sizes)
        for sort, r in report.items():
            log(f"[auto] {width} {sort}", json.dumps({"card": card, **r}))
        out[width] = report
    return out


# -- phase 12: a profiler trace ------------------------------------------------

PROFILE_SORTS = 5
KERNEL_LABELS = {"chunk_kernel": "K1", "fused_kernel": "K2",
                 "cross_cols_kernel": "K3", "cross_kernel": "K3",
                 "local_kernel": "K4"}


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(n: int = N) -> dict:
    """One profiling.trace around PROFILE_SORTS network keys sorts at n:
    device time by kernel name, mapped to K1-K4 (K5 is the valid pointer
    of those kernels and shares their names), and the device's busy share
    of the traced window (the union of device activity over the window
    of the sorts)."""
    keys = to_dev(datagen.generate_keys(n, seed=SEED), "cuda")
    s = vrs.Sorter(n, config=NETWORK)
    s.sort(keys)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as prof:
            with torch.profiler.record_function("vrs_window"):
                for _ in range(PROFILE_SORTS):
                    s.sort(keys)
                torch.cuda.synchronize()
        files = os.listdir(d)
    if not files:
        raise AssertionError("profiling.trace wrote no trace")
    events = prof.events()
    window = [e for e in events if e.name == "vrs_window"]
    # device activity: kernels, copies and fills; not the device-side
    # span the profiler draws for a record_function range
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name != "vrs_window"]
    if not window or not dev:
        raise AssertionError("the trace has no window or no device events")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in dev if e.time_range.end > w0 and e.time_range.start < w1]
    by_name = {}
    for e in dev:
        label = next((k for name, k in KERNEL_LABELS.items()
                      if name in e.name), "other")
        a = by_name.setdefault(label, {"launches": 0, "ms": 0.0})
        a["launches"] += 1
        a["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    missing = [k for k in KERNEL_LABELS.values() if k not in by_name]
    if missing:
        raise AssertionError(f"the trace names no kernel of {missing}")
    busy = _union_us(spans)
    d0 = min(e.time_range.start for e in dev)
    d1 = max(e.time_range.end for e in dev)
    out = {"sorts": PROFILE_SORTS, "n": n, "window_ms": (w1 - w0) / 1e3,
           "busy_share": busy / (w1 - w0),
           "busy_share_first_to_last_device_event": busy / (d1 - d0),
           "kernels": by_name, "trace_files": files}
    log("[profile]", json.dumps(out))
    return out


RADIX_KERNEL_NAMES = {"block_sort_kernel": "K7", "spine_kernel": "spine",
                      "place_kernel": "K8"}


def radix_profile_phase(n: int = N) -> dict:
    """One profiling.trace around one radix keys sort at n: the device
    activity from its first K7 to its last K8 must be K7, the spine and K8
    once a pass, in that order, and nothing else (no torch op between the
    kernels). Prints one pass's kernels with their device us."""
    keys = to_dev(datagen.generate_keys(n, seed=SEED), "cuda")
    s = vrs.Sorter(n, config=RADIX)
    s.sort(keys)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as prof:
            s.sort(keys)
            torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    labels = [next((k for name, k in RADIX_KERNEL_NAMES.items()
                    if name in e.name), e.name) for e in dev]
    ends = [i for i, x in enumerate(labels) if x in ("K7", "K8")]
    window = labels[ends[0]:ends[-1] + 1] if ends else []
    want = list(RADIX_KERNEL_NAMES.values()) * RADIX.num_passes
    one_pass = [{"kernel": x, "us": (e.time_range.end - e.time_range.start)}
                for x, e in zip(labels[ends[0]:ends[0] + 3],
                                dev[ends[0]:ends[0] + 3])] if ends else []
    out = {"n": n, "passes": RADIX.num_passes, "one_pass": one_pass,
           "device_events_in_window": len(window),
           "outside_window": [x for i, x in enumerate(labels)
                              if not ends or not ends[0] <= i <= ends[-1]]}
    log("[profile] radix", json.dumps(out))
    if window != want:
        raise AssertionError(f"a radix sort's device work from its first K7 "
                             f"to its last K8 is {window}, not {want}")
    return out


def _path_launches(config: SortConfig, kernels, oracles) -> dict:
    """Drive one backend's main path with the counters zeroed just before
    and read just after; every kernel of `kernels` must have launched."""
    reset_launches()
    main_path(config=config, oracles=oracles)
    torch.cuda.synchronize()
    launches = launch_counts()
    log("[launches]", config.backend, json.dumps(launches))
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"not launched on the main path: {missing}")
    return {k: launches[k] for k in kernels}


BACKEND_KERNELS = {"network": NETWORK_KERNELS, "radix": RADIX_KERNELS,
                   "reference": ()}


def _auto_launches(oracles) -> dict:
    """Drive the 'auto' main path, 32- and 64-bit, with the counters zeroed
    just before and read just after: every kernel of each backend 'auto'
    picked must have launched, and no kernel of a backend it did not pick
    (each sort's launches are also held to its kind's backend inside the
    path). Returns the launches per kernel."""
    reset_launches()
    picked = {"u32": main_path(oracles=oracles),
              "u64": main_path64(oracles=oracles)}
    torch.cuda.synchronize()
    launches = launch_counts()
    log("[launches] auto", json.dumps({"backends": picked, **launches}))
    used = {k for p in picked.values() for b in p.values()
            for k in BACKEND_KERNELS[b]}
    wrong = {k: v for k, v in launches.items() if (k in used) != (v > 0)}
    if wrong:
        raise AssertionError(f"the auto path launched {launches} for the "
                             f"backends {picked}")
    return launches


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
    err_carry = {}
    err = check_kernels(by_mode=err_carry)

    oracles = {}
    launches = _path_launches(NETWORK, NETWORK_KERNELS, oracles)
    launches.update(_path_launches(RADIX, RADIX_KERNELS, oracles))
    _path_launches(REFERENCE, BACKEND_KERNELS["reference"], oracles)
    carries = _path_launches64(oracles)
    auto_launches = _auto_launches(oracles)
    del oracles

    sorts, keys, vals = path_sorts()
    e2e_times(sorts, keys, vals, card)
    per, _ = kernel_times(sorts)
    sorts, keys, vals = path_sorts64()
    e2e_times(sorts, keys, vals, card, lib="library_u64")
    per64, _ = kernel_times(sorts, by_mode=True)
    del sorts, keys, vals

    err["local_gated"] = check_slot_merges()
    check_halves_merge()
    dist_launches, slot_bufs = dist_phase()
    launches["local_gated"] = dist_launches["local_gated"]
    dist2_phase()
    per["local_gated"] = merge_times(slot_bufs, card)["local_gated"]
    del slot_bufs

    stages_phase()
    adaptive_phase(card=card)
    auto_phase(card, sweep_phase(card), sweep64_phase(card))
    profile_phase()
    radix_profile_phase()

    def figures(p):
        return {"ms": p["ms"] / p["n"], "plain_ms": p["plain"] / p["nplain"],
                "bound_ms": p["bound"] / p["n"],
                "bound_by": max(p["by"], key=p["by"].get),
                "library_ms": p["lib"] / p["nlib"] if p["nlib"] else None}

    rows = []
    for key, (label, source, replaces, status) in KERNELS.items():
        row = {"name": label, "route": "cuda", "source": source,
               "replaces": replaces, "status": status,
               "launches": launches[key], "max_abs_err": err[key],
               "auto_launches": auto_launches[key],
               **figures(per[key])}
        # the 64-bit carries: launches on the 64-bit path, times over its
        # sorts (path_sorts64)
        for c in W64_CARRIES:
            src = (WIDE_CUH if key == "chunk" or (key, c) == ("fused", "w3")
                   else W64_CU)
            row[c] = ({"source": src, "launches": carries[c][key],
                       "max_abs_err": err_carry[key, c],
                       **figures(per64[key, c])}
                      if key in W64_KERNELS else None)
        if key in ("chunk", "cross"):  # by 32-bit carry; launches in one
            # run of the timed sorts (path_sorts), bound share = bound / ms
            row["carries"] = {
                c: {**figures(per[key, c]),
                    "launches": per[key, c]["n"] // TIMED_RUNS,
                    "bound_share": per[key, c]["bound"] / per[key, c]["ms"]}
                for c in ("keys", "pairs", "stable")}
        if key in ("block_sort", "place"):  # the radix sorts by kind
            for kind in ("keys", "kv"):
                row[kind] = {**figures(per[key, kind]),
                             "bound_share": per[key, kind]["bound"]
                             / per[key, kind]["ms"]}
        if key == "place":  # K8's column accumulation, a launch of its own
            row["spine"] = {"source": RADIX_CU, "launches": launches["spine"],
                            "auto_launches": auto_launches["spine"],
                            "max_abs_err": err["spine"],
                            **figures(per["spine"])}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
