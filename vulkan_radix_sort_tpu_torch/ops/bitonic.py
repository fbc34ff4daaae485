"""Bitonic sort network: the host driver over the four Hopper kernels.

Counterpart of the single-chip sort path of
`vulkan_radix_sort_tpu/ops/bitonic.py` (`_plan`, `_pad_pow2` as
`bitops.pad_u32`, `_stable_idx`, `_sort_padded`, `sort_u32`,
`sort_pairs_u32`). The network is the same:

  1. chunk (K1): sort each C-element chunk in shared memory, even chunks
     ascending and odd ones descending;
  2. merge rounds r = 1..log2(np2/C), each building sorted runs of C*2^r:
     a. fused (K2): the first rounds together, while a group of 2^r chunks
        fits one block's shared memory;
     b. then per round, cross (K3) for the stages at distances >= C (split
        into spans of stages that fit shared memory) and local (K4) for the
        stages at distances < C.

What changed for Hopper: the fused group is bounded by shared memory
(232,448 bytes a block) instead of VMEM, and the stage budgets that capped
Mosaic compile time (`_phase_groups`, `MAX_GROUP_STAGES*`, `FUSE_COST_CAP`)
are gone, since nvcc compiles every kernel once for every shape. The skip
rules are kept exactly: the grid covers only the genuine prefix, and after
the chunk phase local passes are clipped at the round's 2^r-chunk group
granularity, never per chunk (see `_sort_padded`).

Carries: keys (k); stable key-value (k, idx, v) with the original index as
the tiebreak; non-stable key-value (k, v) compared lexicographically, so
equal keys come out by ascending value.
"""

from __future__ import annotations

import torch

from ..config import CHUNK_CARRY, CHUNK_KEYS, MIN_CHUNK, cdiv
from . import bitonic_kernels as bk
from .bitonic_kernels import KEYS, PAIRS, STABLE, CROSS_W, log2
from .bitops import check_u32, pad_u32

# Elements a fused-rounds group may hold, on top of each carry's
# shared-memory cap. Tests lower it to pin the unfused cross + local path.
MAX_FUSED_ELEMS = 1 << 15

# pad tiebreak of the stable carry: above every genuine index and constant,
# so pad regions are all-tied and every stage maps them to themselves
STABLE_PAD_IDX = 0x7FFFFFFF


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _plan(n: int, chunk: int) -> tuple[int, int]:
    """Padded size and chunk size for an n-element sort."""
    if chunk < MIN_CHUNK or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two >= {MIN_CHUNK}")
    np2 = _next_pow2(max(n, MIN_CHUNK))
    return np2, min(chunk, np2)


def _stable_idx(n: int, np2: int, device, count=None) -> torch.Tensor:
    """Tiebreak of the stable carry: the original index for live entries,
    the constant STABLE_PAD_IDX for padding and, with `count`, for every
    entry at or past it (making the masked tail constant too, so the
    validity gate may skip it). `count` stays on the device."""
    iot = torch.arange(np2, device=device)
    live = iot < n
    if count is not None:
        live &= iot < count
    return torch.where(live, iot, STABLE_PAD_IDX).to(torch.int32).view(
        torch.uint32)


def _fused_rounds(C: int, nrounds: int, mode) -> int:
    """Last merge round of the fused group (0: no fused rounds)."""
    cap = min(MAX_FUSED_ELEMS, mode.smem_cap)
    r_hi = 0
    while r_hi < nrounds and C << (r_hi + 1) <= cap:
        r_hi += 1
    return r_hi


def _cross_spans(r: int, mode) -> list[tuple[int, int]]:
    """Round r's r cross stages (t = r-1 .. 0) as (t_lo, span) runs, high
    first, each of whose tiles (CROSS_W << span elements) fits shared
    memory; spans are balanced so tiles stay as small as the split allows."""
    smax = log2(mode.smem_cap) - log2(CROSS_W)
    k = cdiv(r, smax)
    sizes = [r // k + (1 if i < r % k else 0) for i in range(k)]
    spans, t_hi = [], r
    for s in sizes:
        spans.append((t_hi - s, s))
        t_hi -= s
    return spans


def _unit_valid(np2: int, unit: int, count, device):
    """Per-unit flags: 1 iff the unit starts before `count` (on device)."""
    if count is None:
        return None
    starts = torch.arange(np2 // unit, device=device) * unit
    return (starts < count).to(torch.int32)


def _sort_padded(arrs, mode, np2: int, C: int, n: int, count=None) -> None:
    """Full network over the padded buffers, in place.

    The grid covers only the genuine prefix: units wholly past the first n
    elements are pure padding, which every stage maps to itself, and are
    never launched. `count` (a 0-d tensor on the buffers' device) further
    gates units wholly past the live prefix, which the caller has made
    constant (max key, max tiebreak): the analog of the reference's
    indirect-dispatch early exit (upsweep.slang:20-22).

    Skip granularity: once round r's cross stages run on the group that
    holds the genuine boundary, a descending boundary group moves genuine
    elements into its trailing chunks, past a per-chunk prefix clip. So
    after the chunk phase every skip decision is made per 2^r-chunk group,
    never per chunk; genuine data stays inside [0, group-ceil(boundary)).
    """
    dev = arrs[0].device
    lc = log2(C)
    nrounds = log2(np2 // C)

    def groups(r):  # round-r groups holding genuine data
        return cdiv(n, C << r)

    bk.chunk(arrs, mode, C, cdiv(n, C), _unit_valid(np2, C, count, dev))
    r_hi = _fused_rounds(C, nrounds, mode)
    if r_hi:
        bk.fused(arrs, mode, C, 1, r_hi, groups(r_hi),
                 _unit_valid(np2, C << r_hi, count, dev))
    for r in range(r_hi + 1, nrounds + 1):
        cross_valid = _unit_valid(np2, C << r, count, dev)
        for t_lo, span in _cross_spans(r, mode):
            bk.cross(arrs, mode, C, r, t_lo, span, groups(r), cross_valid)
        # local: per chunk, but clipped and gated at round-r granularity
        local_valid = None
        if count is not None:
            gstart = (torch.arange(np2 // C, device=dev) >> r << r) * C
            local_valid = (gstart < count).to(torch.int32)
        bk.local(arrs, mode, C, r, groups(r) << r, local_valid)


def count_tensor(count, device: torch.device) -> torch.Tensor | None:
    """`count` (None, an int or a tensor on `device`) as a 0-d int64
    tensor on `device`; a tensor given by the caller is never read on the
    host and never moved."""
    if count is None:
        return None
    if isinstance(count, torch.Tensor):
        if count.device != device:
            raise ValueError(f"count lives on {count.device}, the keys "
                             f"on {device}")
        return count.reshape(()).to(torch.int64)
    return torch.tensor(int(count), dtype=torch.int64, device=device)


def _checked_chunk(chunk: int, mode) -> int:
    if chunk > mode.smem_cap:
        raise ValueError(f"chunk {chunk} exceeds the {mode.smem_cap}-element "
                         f"shared-memory cap of the {mode.name} carry")
    return chunk


def sort_u32(keys: torch.Tensor, count=None, *, chunk: int | None = None):
    """Ascending sort of uint32 keys through the bitonic network.

    `count` (int or 0-d tensor on the keys' device) gates units wholly past
    the live prefix to a no-op. The caller must have masked keys[count:] to
    0xFFFFFFFF already (the sorter's indirect path does); the gate only
    skips work. Returns a new tensor; `keys` is not modified.
    """
    check_u32(keys)
    n = keys.numel()
    np2, C = _plan(n, _checked_chunk(chunk or CHUNK_KEYS, KEYS))
    buf = pad_u32(keys, np2, 0xFFFFFFFF)
    if n:
        _sort_padded([buf], KEYS, np2, C, n, count_tensor(count, keys.device))
    return buf[:n]


def sort_pairs_u32(keys: torch.Tensor, values: torch.Tensor, count=None, *,
                   chunk: int | None = None, stable: bool = True):
    """Key-value sort; values ride as a separate uint32 buffer.

    stable=True breaks ties on the original index, so the output equals
    the stable sort by key. stable=False compares (key, value)
    lexicographically, carrying one array fewer: equal keys come out by
    ascending value. `count` as in `sort_u32`; with stable=False the caller
    masks values[count:] to 0xFFFFFFFF too.
    """
    check_u32(keys, values)
    n = keys.numel()
    mode = STABLE if stable else PAIRS
    np2, C = _plan(n, _checked_chunk(chunk or CHUNK_CARRY, mode))
    cnt = count_tensor(count, keys.device)
    k = pad_u32(keys, np2, 0xFFFFFFFF)
    if stable:
        arrs = [k, _stable_idx(n, np2, keys.device, cnt),
                pad_u32(values, np2, 0)]
    else:
        arrs = [k, pad_u32(values, np2, 0xFFFFFFFF)]
    if n:
        _sort_padded(arrs, mode, np2, C, n, cnt)
    return arrs[0][:n], arrs[-1][:n]
