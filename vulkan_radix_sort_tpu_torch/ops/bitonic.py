"""Bitonic sort network: the host driver over the four Hopper kernels.

Counterpart of the single-chip sort path of
`vulkan_radix_sort_tpu/ops/bitonic.py` (`_plan`, `_pad_pow2` as
`bitops.pad_u32`, `_stable_idx`, `_sort_padded`, `sort_u32`,
`sort_pairs_u32`, `sort_pairs_w64`). The network is the same:

  1. chunk (K1): sort each C-element chunk in shared memory, even chunks
     ascending and odd ones descending;
  2. merge rounds r = 1..log2(np2/C), each building sorted runs of C*2^r:
     a. fused (K2): the first rounds together, while a group of 2^r chunks
        fits one block's shared memory;
     b. then per round, cross (K3) for the stages at distances >= C (split
        into spans of at most the carry's `Mode.cross_cap` stages) and
        local (K4) for the stages at distances < C.

What changed for Hopper: the fused group is bounded by shared memory
(232,448 bytes a block) instead of VMEM, and the stage budgets that capped
Mosaic compile time (`_phase_groups`, `MAX_GROUP_STAGES*`, `FUSE_COST_CAP`)
are gone, since nvcc compiles every kernel once for every shape. The skip
rules are kept exactly: the grid covers only the genuine prefix, and after
the chunk phase local passes are clipped at the round's 2^r-chunk group
granularity, never per chunk (see `_sort_padded`).

`sort` is the backend's one entry, the Sorter's contract: it owns
`count=` (the keys past the count masked to the maximum, the tail
selected back), 64-bit keys (split into (hi, lo) words and merged) and
`end_bit` (the masked keys and their positions through a pair carry,
then a gather), and drives the carries below.

`stage_times*` time each launch of the real `_sort_padded` with CUDA
events (`utils.timing.LaunchTimer`): the per-stage split of
`Sorter.sort_timed` and the bench's `--stages`.

Carries: keys (k); stable key-value (k, idx, v) with the original index as
the tiebreak; non-stable key-value (k, v) compared lexicographically, so
equal keys come out by ascending value. 64-bit keys come as (hi, lo) words:
keys-only through the (k, v) carry, key-value through W3 (hi, lo, v) or,
stable, W4_BIG (hi, lo, idx, v).
"""

from __future__ import annotations

import torch

from ..config import (CHUNK_CARRY, CHUNK_KEYS, MIN_CHUNK, SortConfig, cdiv,
                      default_config)
from . import bitonic_kernels as bk
from .bitonic_kernels import KEYS, PAIRS, STABLE, W3, W4_BIG, log2
from .bitops import (check_u32, count_tensor, low_bits, mask_past, merge_u64,
                     pad_u32, select, signed_dtype, split_u64, widen_u32)
from ..utils import timing

# Elements a fused-rounds group may hold, on top of each carry's
# shared-memory cap. Tests lower it to pin the unfused cross + local path.
MAX_FUSED_ELEMS = 1 << 15

# pad tiebreak of the stable carries: above every genuine index and
# constant, so pad regions are all-tied and every stage maps them to
# themselves
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
    cap = min(MAX_FUSED_ELEMS, mode.reg_cap)
    r_hi = 0
    while r_hi < nrounds and C << (r_hi + 1) <= cap:
        r_hi += 1
    return r_hi


def _cross_spans(r: int, mode) -> list[tuple[int, int]]:
    """Round r's r cross stages (t = r-1 .. 0) as (t_lo, span) runs, high
    first, each within the carry's span cap (`Mode.cross_cap`); spans are
    balanced so tiles stay as small as the split allows."""
    k = cdiv(r, mode.cross_cap)
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


def _checked_chunk(chunk: int, mode) -> int:
    if chunk > mode.reg_cap:
        why = ("shared-memory" if mode.reg_cap == mode.smem_cap else
               "register (its larger chunks spill registers)")
        raise ValueError(f"chunk {chunk} exceeds the {mode.reg_cap}-element "
                         f"{why} cap of the {mode.name} carry")
    return chunk


def sort_u32(keys: torch.Tensor, count=None, *, chunk: int | None = None):
    """Ascending sort of uint32 keys through the bitonic network.

    `count` (int or 0-d tensor on the keys' device) gates units wholly past
    the live prefix to a no-op. The caller must have masked keys[count:] to
    0xFFFFFFFF already (`sort` does); the gate only skips work. Returns a
    new tensor; `keys` is not modified.
    """
    arrs, mode, np2, C, n, cnt = _keys_carry(keys, count, chunk)
    if n:
        _sort_padded(arrs, mode, np2, C, n, cnt)
    return arrs[0][:n]


def _keys_carry(keys, count, chunk):
    """The padded buffers of a keys sort: (arrs, mode, np2, C, n, count)."""
    check_u32(keys)
    n = keys.numel()
    np2, C = _plan(n, _checked_chunk(chunk or CHUNK_KEYS, KEYS))
    return ([pad_u32(keys, np2, 0xFFFFFFFF)], KEYS, np2, C, n,
            count_tensor(count, keys.device))


def sort_pairs_u32(keys: torch.Tensor, values: torch.Tensor, count=None, *,
                   chunk: int | None = None, stable: bool = True):
    """Key-value sort; values ride as a separate uint32 buffer.

    stable=True breaks ties on the original index, so the output equals
    the stable sort by key. stable=False compares (key, value)
    lexicographically, carrying one array fewer: equal keys come out by
    ascending value. `count` as in `sort_u32`; with stable=False the caller
    masks values[count:] to 0xFFFFFFFF too.
    """
    arrs, mode, np2, C, n, cnt = _pairs_carry(keys, values, count, chunk,
                                              stable)
    if n:
        _sort_padded(arrs, mode, np2, C, n, cnt)
    return arrs[0][:n], arrs[-1][:n]


def _pairs_carry(keys, values, count, chunk, stable):
    """The padded buffers of a 32-bit key-value sort: (arrs, mode, np2, C,
    n, count)."""
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
    return arrs, mode, np2, C, n, cnt


def sort_pairs_w64(hi: torch.Tensor, lo: torch.Tensor, values: torch.Tensor,
                   count=None, *, chunk: int | None = None,
                   stable: bool = True):
    """Key-value sort of 64-bit keys given as (hi, lo) uint32 words.

    The key order is (hi, lo) lexicographic, i.e. unsigned 64-bit order;
    the caller applies any order-preserving encoding before the split.
    stable=True runs W4_BIG at every n: (hi, lo, original index) compared,
    values riding, pads (max, max, STABLE_PAD_IDX). The JAX package's
    packed-lazy MODE_W4 is a Mosaic lane trick; a stable order is unique,
    so the result is bitwise the same. stable=False runs W3: (hi, lo,
    value) compared, value pads 0xFFFFFFFF, so equal keys come out by
    ascending value. `count` as in `sort_pairs_u32`: the caller has masked
    the keys past it to the maximum (and, with stable=False, the values).
    Returns new (hi, lo, values) tensors.
    """
    arrs, mode, np2, C, n, cnt = _w64_carry(hi, lo, values, count, chunk,
                                            stable)
    if n:
        _sort_padded(arrs, mode, np2, C, n, cnt)
    return arrs[0][:n], arrs[1][:n], arrs[-1][:n]


def _w64_carry(hi, lo, values, count, chunk, stable):
    """The padded buffers of a 64-bit key-value sort: (arrs, mode, np2, C,
    n, count)."""
    check_u32(hi, lo, values)
    n = hi.numel()
    mode = W4_BIG if stable else W3
    np2, C = _plan(n, _checked_chunk(chunk or CHUNK_CARRY, mode))
    cnt = count_tensor(count, hi.device)
    arrs = [pad_u32(hi, np2, 0xFFFFFFFF), pad_u32(lo, np2, 0xFFFFFFFF)]
    if stable:
        arrs += [_stable_idx(n, np2, hi.device, cnt), pad_u32(values, np2, 0)]
    else:
        arrs.append(pad_u32(values, np2, 0xFFFFFFFF))
    return arrs, mode, np2, C, n, cnt


# -- the front end: count=, end_bit and the key width -------------------------

def _carry(keys, values, count, chunk: int, stable: bool):
    """keys (uint32 or uint64) and values (uint32, or None) through the
    carry of their width and kind: uint32 keys alone or with values, in
    `sort_u32` or `sort_pairs_u32`; uint64 keys as (hi, lo) words, alone
    in the non-stable (k, v) carry, whose order is theirs, or with values
    in `sort_pairs_w64` (W4_BIG, or W3 with stable=False). Returns (keys,
    values or None)."""
    if keys.dtype != torch.uint64:
        if values is None:
            return sort_u32(keys, count, chunk=chunk), None
        return sort_pairs_u32(keys, values, count, chunk=chunk, stable=stable)
    if values is None:
        hi, lo = sort_pairs_u32(*split_u64(keys), count, chunk=chunk,
                                stable=False)
        return merge_u64(hi, lo), None
    hi, lo, values = sort_pairs_w64(*split_u64(keys), values, count,
                                    chunk=chunk, stable=stable)
    return merge_u64(hi, lo), values


def sort(keys: torch.Tensor, values: torch.Tensor | None = None, *,
         count=None, end_bit: int | None = None, stable: bool = True,
         config: SortConfig | None = None):
    """Ascending sort of 1-D uint32 or uint64 keys (and uint32 values)
    through the network: the backend's one entry (`Sorter`'s contract).
    Returns new tensors, keys or (keys, values). The chunk is the config's
    `chunk_keys` for uint32 keys alone, else its `chunk_carry`.

    `count` (an int or a 0-d tensor on the keys' device, never read on the
    host): the keys at or past it are masked to the maximum
    (`bitops.mask_past`), and with stable=False the values too, making the
    masked tail the lexicographic maximum; the carry gates the units wholly
    past the count, and the tail is selected back. A genuine maximum key
    (with stable=False, key and value) in the prefix is bitwise
    interchangeable with a masked one, so the prefix is exact. `end_bit`
    (1 to the width - 1): the keys masked to bits [0, end_bit), the
    maximum past the count, and their positions go through the non-stable
    pair carry, whose (key, position) order is the stable one since the
    positions are distinct; the whole keys and the values are gathered by
    the sorted positions, and the tail comes back in place. Such a call is
    stable whatever `stable` says."""
    config = config or default_config()
    chunk = (config.chunk_keys if values is None and end_bit is None
             and keys.dtype != torch.uint64 else config.chunk_carry)
    cnt = count_tensor(count, keys.device)
    if end_bit is not None:
        return _sort_low_bits(keys, values, cnt, end_bit, chunk)
    if cnt is None:
        k, v = _carry(keys, values, None, chunk, stable)
        return k if values is None else (k, v)
    with timing.span("vrs.count_mask"):
        if values is None or stable:
            live, k = mask_past(cnt, keys)
            v = values
        else:  # the values masked too: the tail the lexicographic maximum
            live, k, v = mask_past(cnt, keys, values)
    k, v = _carry(k, v, cnt, chunk, stable)
    with timing.span("vrs.count_mask"):
        k = select(live, k, keys)
        return k if values is None else (k, select(live, v, values))


def _sort_low_bits(keys, values, count, end_bit: int, chunk: int):
    """`sort` by bits [0, end_bit): (masked key, position) through the
    non-stable pair carry, then the gather."""
    masked = low_bits(keys, end_bit)
    if count is not None:
        with timing.span("vrs.count_mask"):
            masked = mask_past(count, masked)[1]
    pos = torch.arange(keys.numel(), dtype=torch.int32,
                       device=keys.device).view(torch.uint32)
    order = widen_u32(_carry(masked, pos, None, chunk, stable=False)[1])
    k = keys.view(signed_dtype(keys))[order].view(keys.dtype)
    return k if values is None else (
        k, values.view(torch.int32)[order].view(torch.uint32))


# -- per-stage timing ---------------------------------------------------------

# `stage_times*` report the carry that ran as `mode`, a name of the port's
# carries. The JAX package's mode names map onto them so: keys -> keys;
# packed and stable (its two stable kv carries) -> stable; pairs
# (non-stable kv, and 64-bit keys) -> pairs; w3 -> w3; w4 and w4_big (its
# two stable 64-bit kv carries) -> w4_big.
JAX_MODES = {"keys": "keys", "packed": "stable", "stable": "stable",
             "pairs": "pairs", "w3": "w3", "w4": "w4_big",
             "w4_big": "w4_big"}


def _kernel_name(launch: bk.Launch) -> str:
    a = launch.cargs  # (lc,), (lc, r), (lc, r_lo, r_hi), (lc, r, t_lo, span)
    if launch.kernel == "chunk":
        return f"chunk[p1-{a[0]}]"
    if launch.kernel == "fused":
        return f"fused[r{a[1]}-{a[2]}]"
    if launch.kernel == "cross":
        return f"cross[r{a[1]} t{a[2]}-{a[2] + a[3] - 1}]"
    return f"{launch.kernel}[r{a[1]}]"


def _stage_times(arrs, mode, np2: int, C: int, n: int, iters: int) -> dict:
    """Seconds per launch of the real `_sort_padded` on the padded buffers
    `arrs`: the mean over `iters` sorts of fresh copies, each launch
    bracketed by CUDA events (`timing.LaunchTimer`), after one sort
    untimed. A fused launch runs both cross and local stages; its time
    is split between the two by stage count, as in the JAX package. On
    CPU buffers the launches run their plain versions once and every
    time is None: the launch plan without a clock."""
    cuda = arrs[0].device.type == "cuda"
    runs = max(1, iters) if cuda else 1
    # the copies go into buffers allocated once: an allocation inside the
    # timed sorts may wait on the card and open a gap inside a bracket
    work = [torch.empty_like(a) for a in arrs]

    def sort():
        for w, a in zip(work, arrs):
            w.copy_(a)
        _sort_padded(work, mode, np2, C, n)
    if cuda:  # builds the kernels, and no bracket waits on the host
        sort()
    with timing.LaunchTimer() as timer:
        for _ in range(runs):
            sort()
    secs = timer.seconds()
    per = len(secs) // runs
    lc = log2(C)
    totals = dict.fromkeys(("chunk", "cross", "local"), 0.0 if cuda else None)
    kernels = []
    for i, rec in enumerate(timer.records[:per]):
        launch = rec["launch"]
        t = sum(secs[i::per]) / runs if cuda else None
        kernels.append((_kernel_name(launch), t))
        if not cuda:
            continue
        if launch.kernel == "fused":
            r_lo, r_hi = launch.cargs[1:]
            cross = sum(range(r_lo, r_hi + 1))
            local = (r_hi - r_lo + 1) * lc
            totals["cross"] += t * cross / (cross + local)
            totals["local"] += t * local / (cross + local)
        else:
            totals[launch.kernel] += t
    return {**totals, "rounds": log2(np2 // C), "mode": mode.name,
            "kernels": kernels}


def stage_times(keys: torch.Tensor, chunk: int | None = None,
                iters: int = 10) -> dict:
    """Per-stage seconds of a keys sort: the analog of the reference's
    timestamps (h.in:39-50), as `vulkan_radix_sort_tpu.ops.bitonic.
    stage_times` returns them: `chunk` (K1), `cross` (K3, and K2's share),
    `local` (K4, and K2's share), `rounds` (merge rounds), `mode` (the
    carry, see JAX_MODES) and `kernels`, one (name, seconds) per launch of
    one sort in launch order. Times are taken on the card only; see
    `_stage_times` for CPU tensors."""
    arrs, mode, np2, C, n, _ = _keys_carry(keys, None, chunk)
    return _stage_times(arrs, mode, np2, C, n, iters)


def stage_times_pairs(keys: torch.Tensor, values: torch.Tensor,
                      chunk: int | None = None, iters: int = 10,
                      stable: bool = True) -> dict:
    """`stage_times` of a 32-bit key-value sort: the stable carry, or with
    stable=False the pairs carry."""
    arrs, mode, np2, C, n, _ = _pairs_carry(keys, values, None, chunk,
                                            stable)
    return _stage_times(arrs, mode, np2, C, n, iters)


def stage_times_w64(hi: torch.Tensor, lo: torch.Tensor, values=None,
                    chunk: int | None = None, iters: int = 10,
                    stable: bool = True) -> dict:
    """`stage_times` of a 64-bit sort given as (hi, lo) words: with
    values=None the keys-only sort (the pairs carry over the words),
    otherwise key-value in W4_BIG (stable) or W3."""
    if values is None:
        return stage_times_pairs(hi, lo, chunk, iters, stable=False)
    arrs, mode, np2, C, n, _ = _w64_carry(hi, lo, values, None, chunk,
                                          stable)
    return _stage_times(arrs, mode, np2, C, n, iters)


# -- slot merge: finish a sort whose input is already sorted runs ------------

def _reverse_odd_slots(x: torch.Tensor, n_slots: int, slot: int):
    """A copy of x with every odd slot reversed: all-ascending sorted slots
    become the alternating directions the merge rounds expect."""
    out = x.view(torch.int32).clone().view(n_slots, slot)
    out[1::2] = out[1::2].flip(1)
    return out.view(-1).view(torch.uint32)


def _slot_geometry(n: int, slot: int, chunk: int, mode) -> tuple[int, int,
                                                                  int]:
    """(n_slots, C, first merge round) of a slot merge."""
    n_slots = n // slot
    if slot < MIN_CHUNK or slot & (slot - 1):
        raise ValueError(f"slot must be a power of two >= {MIN_CHUNK}")
    if n != n_slots * slot or n_slots & (n_slots - 1):
        raise ValueError(f"{n} elements are not a power-of-two number of "
                         f"{slot}-element slots")
    _plan(slot, _checked_chunk(chunk, mode))  # checks the chunk
    C = min(slot, chunk)
    return n_slots, C, log2(slot // C) + 1


def _slot_sizes(sizes, n_slots: int, device) -> torch.Tensor | None:
    """Per-slot genuine counts as an int64 tensor on `device`: from a
    tensor already there (never moved) or from a sequence of ints."""
    if sizes is None:
        return None
    if isinstance(sizes, torch.Tensor):
        if sizes.device != device:
            raise ValueError(f"sizes live on {sizes.device}, the buffers on "
                             f"{device}")
        t = sizes.reshape(-1).to(torch.int64)
    else:
        t = torch.tensor(list(sizes), dtype=torch.int64, device=device)
    if t.numel() != n_slots:
        raise ValueError(f"{t.numel()} sizes for {n_slots} slots")
    return t


def _merge_rounds(arrs, mode, np2: int, C: int, r_start: int,
                  slot: int | None = None, sizes=None) -> None:
    """Merge rounds r_start..log2(np2/C) in place: the tail of the network
    for buffers whose 2^(r_start-1)*C-element blocks are already sorted in
    alternating directions (even blocks ascending).

    Without `sizes` every round runs cross (K3) and local (K4) over the
    whole buffer. With per-slot genuine `sizes` (int64, on the buffers'
    device), each C-block's genuine count is tracked through the rounds and
    pure-fill regions are gated, as in the JAX package:
    - at first an ascending slot's genuine elements are its prefix and a
      descending (odd) slot's its suffix;
    - round r's cross stages run on each 2^r-block group holding any
      genuine element (K5 mask, `gcnt > 0`). They leave each group's
      elements in block order up to the group's direction, so its fills
      (the lexicographic maximum) fill its trailing blocks (ascending) or
      its leading ones (descending): each block's count is a clip of the
      conserved group count, in the group's direction;
    - the local pass then runs only on blocks with a genuine element
      (K6, `local_gated`). Fills never leave their blocks' clip; a
      per-block slip would lose data (ROADMAP queue 3, skip granularity).
    """
    nblocks = np2 // C
    nrounds = log2(nblocks)
    counts = None
    if sizes is not None:
        b = torch.arange(nblocks, device=arrs[0].device)
        bps = slot // C  # C-blocks per slot
        off = (b % bps) * C
        g = sizes[b // bps]
        odd_slot = ((b // bps) & 1) == 1
        counts = torch.where(odd_slot, (off + C - (slot - g)).clamp(0, C),
                             (g - off).clamp(0, C))
    for r in range(r_start, nrounds + 1):
        ngroups = nblocks >> r
        cross_valid = None
        if counts is not None:
            gb = 1 << r  # blocks per group this round
            gcnt = counts.view(ngroups, gb).sum(1)  # conserved per group
            cross_valid = (gcnt > 0).to(torch.int32)
        for t_lo, span in _cross_spans(r, mode):
            bk.cross(arrs, mode, C, r, t_lo, span, ngroups, cross_valid)
        if counts is None:
            bk.local(arrs, mode, C, r, nblocks)
            continue
        pos = b % gb
        grep = gcnt.repeat_interleave(gb)
        g_odd = ((b >> r) & 1) == 1  # the round's direction: group parity
        counts = torch.where(g_odd, (grep - (gb - 1 - pos) * C).clamp(0, C),
                             (grep - pos * C).clamp(0, C))
        bk.local_gated(arrs, mode, C, r, nblocks,
                       (counts > 0).to(torch.int32))


def merge_slots_u32(keys: torch.Tensor, sizes=None, *, slot: int,
                    chunk: int = CHUNK_CARRY, prearranged: bool = False):
    """Sort a (n_slots * slot,) buffer whose aligned `slot`-element segments
    are each sorted ascending with 0xFFFFFFFF fill tails, with the
    network's log2(n_slots) merge rounds only. The distributed re-sort:
    after the exchange a rank holds one sorted run per source. Fills sort
    to the global tail; callers slice the genuine prefix.

    `sizes` (per-slot genuine prefix lengths: an integer tensor on the
    keys' device, or ints) turns on pure-fill gating (`_merge_rounds`).
    prearranged=True promises that odd slots already hold their run
    descending in the slot suffix, so no reversal pass runs. Returns a new
    tensor; `keys` is not modified. `chunk` defaults to the carry chunk,
    as the distributed sort runs both kinds of slot merge.
    """
    check_u32(keys)
    n = keys.numel()
    n_slots, C, r_start = _slot_geometry(n, slot, chunk, KEYS)
    k = keys.clone() if prearranged else _reverse_odd_slots(keys, n_slots,
                                                            slot)
    _merge_rounds([k], KEYS, n, C, r_start, slot,
                  _slot_sizes(sizes, n_slots, keys.device))
    return k


def _slot_pairs(keys, values, sizes, slot, chunk, stable, prearranged):
    """The carry of a key-value slot merge in merge orientation:
    (arrays, mode, C, first round, sizes)."""
    check_u32(keys, values)
    n = keys.numel()
    mode = STABLE if stable else PAIRS
    n_slots, C, r_start = _slot_geometry(n, slot, chunk, mode)
    dev = keys.device
    sz = _slot_sizes(sizes, n_slots, dev)
    if sz is None:
        raise ValueError("a key-value slot merge needs the slot sizes")

    def arrange(a):
        return a.clone() if prearranged else _reverse_odd_slots(a, n_slots,
                                                                slot)
    if not stable:
        return [arrange(keys), arrange(values)], mode, C, r_start, sz
    # the tiebreak: slot-major flat position = (source rank, intra-source
    # order) for the distributed re-sort; fills carry STABLE_PAD_IDX. The
    # bound is strict: slot buffers always hold fills, so no genuine
    # position may equal the pad tiebreak.
    if n > STABLE_PAD_IDX:
        raise ValueError(f"a stable slot merge holds at most "
                         f"{STABLE_PAD_IDX} elements")
    pos = torch.arange(slot, dtype=torch.int32, device=dev).expand(n_slots,
                                                                   slot)
    odd = (torch.arange(n_slots, device=dev) & 1).bool()[:, None]
    if prearranged:  # buffer orientation: odd slots hold position slot-1-j
        pos = torch.where(odd, slot - 1 - pos, pos)
    flat = torch.arange(n_slots, dtype=torch.int32, device=dev)[:, None] * \
        slot + pos
    aux = torch.where(pos < sz[:, None], flat, STABLE_PAD_IDX).to(
        torch.int32).view(-1).view(torch.uint32)
    if not prearranged:
        aux = _reverse_odd_slots(aux, n_slots, slot)
    return [arrange(keys), aux, arrange(values)], mode, C, r_start, sz


def merge_slots_pairs(keys: torch.Tensor, values: torch.Tensor, sizes, *,
                      slot: int, chunk: int = CHUNK_CARRY, stable: bool = True,
                      prearranged: bool = False):
    """Key-value slot merge; `sizes` gives each slot's genuine prefix
    length (required: it builds the stable tiebreak and gates fills).

    stable=True breaks ties between equal keys by slot-major flat position,
    i.e. (slot, position in slot): for the distributed re-sort exactly
    (source rank, intra-source order), the global stability contract.
    Fill tiebreaks are STABLE_PAD_IDX, so fills sort strictly after every
    genuine pair, genuine 0xFFFFFFFF keys included; values fill with
    anything. stable=False compares (key, value) and expects value fills of
    0xFFFFFFFF. prearranged=True as in `merge_slots_u32`; the tiebreak is
    then built in buffer orientation (an odd slot's position j holds
    intra-source position slot-1-j), so it stays (source rank, intra-source
    order). Returns new (keys, values) tensors.
    """
    arrs, mode, C, r_start, sz = _slot_pairs(keys, values, sizes, slot,
                                             chunk, stable, prearranged)
    _merge_rounds(arrs, mode, keys.numel(), C, r_start, slot, sz)
    return arrs[0], arrs[-1]
