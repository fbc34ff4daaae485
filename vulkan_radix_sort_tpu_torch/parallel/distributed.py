"""Distributed sort on torch.distributed: the 1-D and the 2-D dcn/ici paths.

Counterpart of `vulkan_radix_sort_tpu/parallel/distributed.py` (a
jax.sharding.Mesh there, a process group or a `Mesh2D` here). Every rank
calls `sort_sharded` / `sort_pairs_sharded` on its own contiguous shard and
gets back its shard of the globally sorted output. Shards follow the JAX
layout: with D ranks and n elements in all, m = ceil(n / D) and rank d
holds global [d*m, min((d+1)*m, n)), so a later rank's shard may be short
or empty. The JAX package pads the global tail with sentinels
(`_pad_to_mesh`); here each rank pads its own shard to m, which gives the
same padded array.

Algorithm (exact, stable, skew-proof), as in the JAX package:
  1. every rank sorts its shard (the network when kernels are used, else
     the torch.sort reference);
  2. exact splitter keys from 4 byte rounds over all_reduce'd (D-1, 256)
     candidate counts;
  3. keys equal to a splitter are split by count in (rank, position) order,
     so the output stays stable and every output shard exactly m long;
  4. the exchange: `all_to_all_single` with the plan's split sizes (values
     ride a second one), arrivals packed in source rank order;
  5. the re-sort. With the merge re-sort each source's run goes into a slot
     of its own and only the network's log2(D) merge rounds run
     (`bitonic.merge_slots_*`, whose local passes are K6); otherwise the
     packed arrivals are sorted again in full.

Overlap (`overlap=True`): the exchange is split by source half, sources
[0, D/2) then [D/2, D) (on a 2-D mesh by host half). Each half's arrivals
are compacted into a genuine prefix, sorted (or slot-merged) on their own,
and the halves are combined: keys by the top round of a bitonic merge
(`_bitonic_merge_halves`, K3 and K4), key-value by a stable merge of the
genuine prefixes (`_stable_merge_valid`). The second half's collective is
started with `async_op=True` and waited on only after the first half's
sort has been launched, so the card sorts while the collective moves data.
Its buffers are neither read nor let go before `wait()`.

The 2-D tier (`make_mesh_2d`): flat rank r = h*C + i on host h, ici index
i. The exact flat plan is unchanged, but the exchange runs in two hops:
hop A sends, over the rank's dcn group, one contiguous block per
destination host to the rank with the same ici index there (H-1 slow-tier
messages per rank instead of D-1), into a staging buffer of dcn_slack x m;
hop B fans each staged block out over the ici group, one collective per
source host, so the arrivals stay in flat source rank order and the stable
re-sort stays stable. The merge re-sort then places them into per-flat-
source slots exactly as on the 1-D path.

Host and device. `all_to_all_single` takes its split sizes as Python ints,
so the (D, D) size matrix comes to the host once per sort (one all_gather;
one more gathers the shard lengths). Every decision the JAX package makes
after its exchange from a flag it returns is made here from that matrix
before any exchange: the slot fit (every source-to-destination run fits
its slot) and the staging fit (the fullest hop-A staging buffer). So
dcn_slack=None picks the smallest sufficient slack at once instead of
retrying with a doubled one, no hop runs with zeroed sizes, and every rank
reaches the same verdict. The JAX package's branches for traced operands
(a sort under an outer jit) have no counterpart: eager torch has none.
Tensors stay on the keys' device; nothing is moved to the CPU. NCCL needs
CUDA tensors (rank r on cuda:(r % device_count) is the usual layout);
gloo takes CPU and CUDA tensors alike (it stages CUDA tensors through the
host itself), which is how several ranks share one card: NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import datetime
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import MIN_CHUNK, SortConfig, cdiv, default_config
from ..ops import bitonic, reference
from ..ops.bitonic_kernels import KEYS, log2
from ..ops.bitops import (check_u32, count_tensor, max_like_u32, pad_u32,
                          select_u32, widen_u32)

_SENTINEL_I32 = -1  # 0xFFFFFFFF as an int32 bit pattern
_FILLS = (_SENTINEL_I32, 0)  # key and value fill, as int32 bit patterns


class Mesh2D(NamedTuple):
    """A 2-D ("dcn", "ici") sort mesh over the ranks of `group` (None: the
    default group): flat rank r is host h = r // C, ici index i = r % C.
    `ici` is this rank's host (its C consecutive flat ranks), `dcn` the
    ranks with its ici index on every host."""

    group: object
    ici: object
    dcn: object
    H: int
    C: int


def make_mesh_2d(n_hosts: int, chips_per_host: int | None = None,
                 group=None) -> Mesh2D | None:
    """The 2-D ("dcn", "ici") mesh of `group`'s ranks (default: the
    default group): n_hosts hosts of chips_per_host ranks each (default:
    the group's size over n_hosts; H*C must be the group's size). Pass it
    to `sort_sharded` / `sort_pairs_sharded` as `group=`.

    Every rank of the default group calls this, in the same order as every
    other `dist.new_group` call (the rule of new_group, which this calls
    once per host and once per ici index), whether or not it is in
    `group`; a rank outside `group` gets None."""
    world = dist.get_world_size()
    if group is None:
        flat = list(range(world))
    else:  # learn the group's ranks on every rank, members or not
        mine = [None] * world
        dist.all_gather_object(mine, dist.get_rank(group))
        flat = [r for k, r in sorted((k, r) for r, k in enumerate(mine)
                                     if k >= 0)]
    H = n_hosts
    C = len(flat) // H if chips_per_host is None else chips_per_host
    if H < 1 or C < 1 or H * C != len(flat):
        raise ValueError(f"a {H} x {C} mesh does not cover the group's "
                         f"{len(flat)} ranks")
    me = dist.get_rank()
    ici = dcn = None
    for h in range(H):
        ranks = flat[h * C:(h + 1) * C]
        sub = dist.new_group(ranks)
        if me in ranks:
            ici = sub
    for i in range(C):
        ranks = flat[i::C]
        sub = dist.new_group(ranks)
        if me in ranks:
            dcn = sub
    if me not in flat:
        return None
    return Mesh2D(group, ici, dcn, H, C)


def spawn_world(fn, world_size: int, *args, init_file: str,
                backend: str = "gloo", timeout_s: float = 600.0) -> None:
    """Run fn(rank, world_size, *args) in `world_size` new processes (start
    method spawn), each a rank of a process group initialised through the
    file store `init_file` (an absent file in a directory of the caller's,
    so that concurrent worlds never contend for a port). Raises if any rank
    fails; the others are then stopped."""
    mp.spawn(_rank_main, args=(fn, world_size, backend, init_file, timeout_s,
                               args), nprocs=world_size, join=True)


def _rank_main(rank, fn, world_size, backend, init_file, timeout_s, args):
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


class _Group:
    """A process group, this rank's place in it and its collectives."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if dist.get_backend(group) == "nccl" and device.type != "cuda":
            raise ValueError(f"NCCL exchanges CUDA tensors; the keys lie on "
                             f"{device}")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def all_to_all(self, x: torch.Tensor, send: list[int], recv: list[int],
                   out: torch.Tensor, async_op: bool = False):
        """Ragged exchange of uint32 x: send[d] consecutive elements of x,
        from its start, to rank d; the arrivals land packed in source rank
        order in the prefix of `out`. With async_op, returns the pending
        work, which the caller waits on before it reads `out` or lets `x`
        or `out` go."""
        return dist.all_to_all_single(
            out[:sum(recv)].view(torch.int32),
            x[:sum(send)].view(torch.int32), recv, send, group=self.group,
            async_op=async_op)


class _Phases:
    """Wall seconds per phase into `out` (after a device synchronise at each
    boundary), or nothing when `out` is None."""

    def __init__(self, out: dict | None, device: torch.device):
        self.out, self.device = out, device
        self.t = self._now() if out is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.out is not None:
            t = self._now()
            self.out[name] = self.out.get(name, 0.0) + t - self.t
            self.t = t


def _default_use_kernels(keys: torch.Tensor, config) -> bool:
    return keys.device.type == "cuda" and (
        config is None or config.backend != "reference")


def _local_sort(keys, values=None, config: SortConfig | None = None,
                use_kernels: bool = False):
    """Stable local sort: the network at the config's per-kind chunk, or
    the torch.sort reference."""
    return (bitonic if use_kernels else reference).sort(keys, values,
                                                         config=config)


def _sort_arrs(arrs, config, use_kernels):
    """`_local_sort` of (keys,) or (keys, values), as a list."""
    if len(arrs) == 1:
        return [_local_sort(arrs[0], None, config, use_kernels)]
    return list(_local_sort(arrs[0], arrs[1], config, use_kernels))


def _find_splitters(wks: torch.Tensor, targets: torch.Tensor,
                    g: _Group) -> torch.Tensor:
    """Exact global splitter keys: the value of the sorted-order element at
    each global position in `targets`. `wks` is the sorted shard widened to
    int64 (where uint32 compares and the (nb, 256) candidate bounds fit).
    Four rounds of 8-bit refinement; each all_reduces 256 candidate counts
    per boundary."""
    nb = targets.numel()
    prefix = torch.zeros(nb, dtype=torch.int64, device=wks.device)
    byte_vals = torch.arange(256, dtype=torch.int64, device=wks.device)
    for r in (24, 16, 8, 0):
        # upper bound of each candidate range: prefix | b<<r | low ones
        cand_hi = prefix[:, None] | (byte_vals << r) | ((1 << r) - 1)
        local_le = torch.searchsorted(wks, cand_hi.reshape(-1), right=True)
        global_le = g.all_reduce(local_le).view(nb, 256)
        # the smallest byte whose cumulative count passes the target
        take = (global_le > targets[:, None]).to(torch.int32)
        prefix |= take.argmax(1) << r  # first True
    return prefix


def _cut_positions(wks, splitters, targets, g: _Group) -> torch.Tensor:
    """Local cut positions so that global range d is [targets[d-1],
    targets[d]). Keys equal to a splitter are split by count in (rank,
    position) order: the stability and even-shard guarantee for degenerate
    distributions."""
    n_less = torch.searchsorted(wks, splitters)
    n_eq = torch.searchsorted(wks, splitters, right=True) - n_less
    both = g.all_gather(torch.stack([n_less, n_eq]))  # (D, 2, nb)
    less_tot = both[:, 0].sum(0)
    eq_before = both[:g.rank, 1].sum(0)
    take_eq = torch.minimum((targets - less_tot - eq_before).clamp(min=0),
                            n_eq)
    return n_less + take_eq


def _exchange_plan(ks: torch.Tensor, m: int, g: _Group) -> list[list[int]]:
    """The (D src, D dst) size matrix of the exchange, on the host: row d
    is what rank d sends to each rank, in consecutive ranges of its sorted
    shard."""
    wks = widen_u32(ks)
    targets = torch.arange(1, g.size, device=ks.device) * m
    cuts = _cut_positions(wks, _find_splitters(wks, targets, g), targets, g)
    bounds = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), m)])
    return g.all_gather(bounds.diff()).tolist()


def _from_sources(sizes: list[list[int]], lo: int, hi: int):
    """The size matrix of the exchange restricted to sources [lo, hi): the
    other sources' rows zeroed."""
    return [row if lo <= s < hi else [0] * len(row)
            for s, row in enumerate(sizes)]


def _exchange(arrs, sizes: list[list[int]], g: _Group, mesh: Mesh2D | None,
              m: int, slack: int, outs, async_op: bool = False):
    """Move each of `arrs` (this rank's sorted shard buffers) by the size
    matrix `sizes`; the arrivals land packed in flat source rank order in
    the prefix of the matching buffer of `outs`. Over the flat group, or in
    two hops over `mesh`'s dcn and ici groups (staging buffers of
    slack * m). With async_op the first collective is only started.
    Returns a function that waits for it and finishes the exchange."""
    if mesh is None:
        me = g.rank
        recv = [row[me] for row in sizes]
        works = [g.all_to_all(x, sizes[me], recv, out, async_op)
                 for x, out in zip(arrs, outs)]
        return lambda: [w.wait() for w in works if w is not None]
    return _staged_exchange(arrs, sizes, g, mesh, m, slack, outs, async_op)


def _staged_exchange(arrs, sizes, g: _Group, mesh: Mesh2D, m: int,
                     slack: int, outs, async_op: bool):
    """The two hops of the 2-D tier (module docstring), planned from the
    host size matrix alone. Hop A: this rank (h, i) sends the rank (h', i)
    of each host h' its ranges for host h' (contiguous in its sorted
    shard), and receives one block per source host, in host order, into
    a staging buffer of slack * m. Hop B, once per source host hs: block
    hs holds source (hs, i)'s segments for this host's ranks j in order;
    segment j goes to rank (h, j), which receives them in ici order, so
    after the H rounds its buffer holds the arrivals in flat source order
    hs*C + i'. A round no rank of this host sends in is skipped."""
    H, C = mesh.H, mesh.C
    h, i = divmod(g.rank, C)
    dev = arrs[0].device
    s4 = np.asarray(sizes, dtype=np.int64).reshape(H, C, H, C)
    dcn, ici = _Group(mesh.dcn, dev), _Group(mesh.ici, dev)
    send_a = s4[h, i].sum(1).tolist()     # to host h' (its rank i)
    recv_a = s4[:, i, h].sum(1).tolist()  # from host hs (its rank i)
    stages = [torch.empty(slack * m, dtype=torch.uint32, device=dev)
              for _ in arrs]
    works = [dcn.all_to_all(x, send_a, recv_a, st, async_op)
             for x, st in zip(arrs, stages)]

    def finish():
        for w in works:
            if w is not None:
                w.wait()
        for st, out in zip(stages, outs):
            a = b = 0
            for hs in range(H):
                send_b = s4[hs, i, h].tolist()     # segment j -> rank j
                recv_b = s4[hs, :, h, i].tolist()  # from (hs, i') via i'
                if s4[hs, :, h].any():
                    ici.all_to_all(st[a:], send_b, recv_b, out[b:])
                a += sum(send_b)
                b += sum(recv_b)
    return finish


def _staging_need(sizes, H: int, C: int) -> int:
    """Elements the fullest hop-A staging buffer receives: rank (h', i)
    gets, from the rank with ici index i on every host, all it sends to
    host h'."""
    s4 = np.asarray(sizes, dtype=np.int64).reshape(H, C, H, C)
    return int(s4.sum(axis=(0, 3)).max())


def _pick_slack(need: int, m: int, H: int, C: int,
                dcn_slack: int | None) -> int:
    """The hop-A staging slack: an explicit dcn_slack, which must hold
    `need` elements in dcn_slack * m; or (None) the first of min(2, cap),
    doubling up to cap = min(H, C), that does. The cap always does: a
    staging rank receives from H sources of m elements each, all bound for
    C ranks of m elements each."""
    cap = min(H, C)
    if dcn_slack is not None:
        if need > dcn_slack * m:
            raise ValueError(
                f"dcn_slack={dcn_slack} staging buffer overflowed for this "
                f"key distribution ({need} > {dcn_slack} x {m}); pass "
                f"dcn_slack=None (adaptive) or a larger value (min(H, C)="
                f"{cap} always suffices)")
        return dcn_slack
    slack = min(2, cap)
    while slack < cap and need > slack * m:
        slack = min(cap, 2 * slack)
    return slack


def slot_size(m: int, world: int) -> int:
    """Slot of the merge re-sort: twice a source's even share of a shard,
    a power of two of at least MIN_CHUNK (the JAX package's 2*LANES)."""
    return max(MIN_CHUNK, bitonic._next_pow2(cdiv(2 * m, world)))


def _slot_dest(recv: list[int], S: int, device) -> torch.Tensor:
    """Slot-buffer position of each packed arrival. Source s's run goes to
    slot s: ascending in the slot's prefix when s is even, descending into
    its suffix when s is odd, so the merge runs prearranged. The reversal
    happens here, at placement, so no source sends a mirrored range and the
    JAX package's clamps of zero-size mirrored offsets have no counterpart."""
    r = torch.tensor(recv, dtype=torch.int64, device=device)
    total = sum(recv)
    src = torch.repeat_interleave(torch.arange(len(recv), device=device), r,
                                  output_size=total)
    p = torch.arange(total, device=device) - (r.cumsum(0) - r)[src]
    return src * S + torch.where((src & 1) == 1, S - 1 - p, p)


def _slotted(x: torch.Tensor, dest: torch.Tensor, size: int, fill: int):
    buf = torch.full((size,), fill, dtype=torch.int32, device=x.device)
    buf[dest] = x.view(torch.int32)
    return buf.view(torch.uint32)


def slot_arrivals(got, recv: list[int], S: int):
    """The slot buffers of the merge re-sort from the packed arrivals `got`
    (keys, and values if any) and the per-source counts `recv`: one slot of
    S per source (next_pow2(D) slots), key fill 0xFFFFFFFF, value fill 0.
    Returns (buffers, per-slot genuine sizes on the device)."""
    dev = got[0].device
    n_slots = bitonic._next_pow2(len(recv))
    dest = _slot_dest(recv, S, dev)
    sizes = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    sizes[:len(recv)] = torch.tensor(recv, device=dev)
    bufs = [_slotted(x, dest, n_slots * S, fill)
            for x, fill in zip(got, _FILLS)]
    return bufs, sizes


def merge_finish(bufs, sizes, S: int, m: int, config=None):
    """Merge-rounds-only re-sort of the slot buffers; the first m elements
    (every genuine arrival) as (keys, values or None). Slot merges run at
    the carry chunk for both kinds, as in the JAX package."""
    cfg = config if config is not None else default_config()
    if len(bufs) == 1:
        ko = bitonic.merge_slots_u32(bufs[0], sizes, slot=S,
                                     chunk=cfg.chunk_carry, prearranged=True)
        return ko[:m], None
    ko, vo = bitonic.merge_slots_pairs(bufs[0], bufs[1], sizes, slot=S,
                                       chunk=cfg.chunk_carry,
                                       prearranged=True)
    return ko[:m], vo[:m]


def _stable_merge_valid(kA, vA, rA: int, kB, vB):
    """Stable merge of two sorted (m,) halves whose genuine elements are
    the first rA / m - rA entries (the rest is fill), A before B on equal
    keys. Returns the m genuine (keys, values) in stable sorted order.

    Each genuine element goes to its classic merge rank: A[i] to i + |B <
    A[i]|, B[j] to j + |genuine A <= B[j]|. Keys compare widened to int64
    (torch has no uint32 comparisons). Fill keys are 0xFFFFFFFF, so the
    strict count never counts them; the <= count is clamped to rA, which is
    exact, since only a genuine 0xFFFFFFFF key reaches past A's genuine
    prefix and all rA genuine keys are <= it. Fill entries go to a dump
    slot m, never read."""
    m = kA.numel()
    i = torch.arange(m, device=kA.device)
    wA, wB = widen_u32(kA), widen_u32(kB)
    posA = torch.where(i < rA, i + torch.searchsorted(wB, wA), m)
    a_leq = torch.searchsorted(wA, wB, right=True).clamp(max=rA)
    posB = torch.where(i < m - rA, i + a_leq, m)
    outs = []
    for a, b, fill in ((kA, kB, _SENTINEL_I32), (vA, vB, 0)):
        o = torch.full((m + 1,), fill, dtype=torch.int32, device=kA.device)
        o[posA] = a.view(torch.int32)
        o[posB] = b.view(torch.int32)
        outs.append(o[:m].view(torch.uint32))
    return outs


def _bitonic_merge_halves(sA, sB, config=None):
    """The m smallest of two ascending (m,) halves with fill tails, by one
    bitonic cleanup: [A | 0xFFFFFFFF pad | flip(B)] is bitonic (the pad is
    the maximum, at the peak), and a cleanup of np2 = next_pow2(2m) is the
    top merge round of the network, round log2(np2 / C): its cross stages
    (K3; none when np2 == C) and its local pass (K4), one group, so
    ascending. C is the carry chunk, as for the slot merges."""
    cfg = config if config is not None else default_config()
    m = sA.numel()
    np2 = bitonic._next_pow2(2 * m)
    arr = pad_u32(sA, np2, 0xFFFFFFFF)
    arr[np2 - m:].copy_(sB.view(torch.int32).flip(0).view(torch.uint32))
    C = min(cfg.chunk_carry, np2)
    bitonic._merge_rounds([arr], KEYS, np2, C, log2(np2 // C))
    return arr[:m]


def _merge_keys_halves(sA, sB, config, use_kernels: bool):
    """Keys of the merged halves: `_bitonic_merge_halves` when the kernels
    are used and 2m reaches the smallest chunk (MIN_CHUNK), else a sort of
    both. Keys only, so the bits are the same either way."""
    m = sA.numel()
    if use_kernels and 2 * m >= MIN_CHUNK:
        return _bitonic_merge_halves(sA, sB, config)
    return reference.sort(torch.cat([sA, sB]))[:m]


def _overlap(arrs, sizes, split: int, g: _Group, mesh, m: int, slack: int,
             S: int | None, config, use_kernels: bool):
    """The source-split exchange: sources [0, split), then [split, D), each
    half's arrivals compacted into a genuine prefix and sorted (S None), or
    slot-merged in slots of S compacted per half (source lo + s owns slot
    s of half [lo, hi)); then the halves are merged. The second half's
    exchange is started before the first half's sort is launched and
    waited on after it."""
    me = g.rank
    pending = []
    for lo, hi in ((0, split), (split, g.size)):
        half = _from_sources(sizes, lo, hi)
        recv = [row[me] for row in half[lo:hi]]
        size = m if S is None else sum(recv)
        outs = [torch.full((size,), fill, dtype=torch.int32,
                           device=arrs[0].device).view(torch.uint32)
                for fill, _ in zip(_FILLS, arrs)]
        pending.append((_exchange(arrs, half, g, mesh, m, slack, outs,
                                  async_op=True), outs, recv))
    done = []
    for finish, outs, recv in pending:
        finish()
        if S is None:
            done.append(_sort_arrs(outs, config, use_kernels))
            continue
        bufs, slot_sizes = slot_arrivals(outs, recv, S)
        ko, vo = merge_finish(bufs, slot_sizes, S, m, config)
        done.append([pad_u32(x, m, fill)
                     for x, fill in zip((ko, vo), _FILLS) if x is not None])
    (kA, *vA), (kB, *vB) = done
    if vA:
        return _stable_merge_valid(kA, vA[0], sum(pending[0][2]), kB, vB[0])
    return _merge_keys_halves(kA, kB, config, use_kernels), None


def _shard_layout(n_local: int, g: _Group, device) -> tuple[int, int]:
    """(n, m) from every rank's shard length; raises unless rank d holds
    [d*m, min((d+1)*m, n))."""
    lens = g.all_gather(torch.tensor([n_local], device=device)).view(
        -1).tolist()
    n = sum(lens)
    m = cdiv(n, g.size)
    want = [min(max(n - d * m, 0), m) for d in range(g.size)]
    if lens != want:
        raise ValueError(f"shard lengths {lens}: rank d must hold global "
                         f"[d*m, min((d+1)*m, n)) with m = ceil(n/D), i.e. "
                         f"{want}")
    return n, m


def _sort_impl(keys, values, *, group, config, count, use_kernels, overlap,
               merge_resort, dcn_slack, phase_times):
    kv = values is not None
    check_u32(*((keys, values) if kv else (keys,)))
    dev = keys.device
    if use_kernels is None:
        use_kernels = _default_use_kernels(keys, config)
    if merge_resort and not use_kernels:
        raise ValueError("merge_resort=True requires the kernels "
                         "(use_kernels)")
    mesh = group if isinstance(group, Mesh2D) else None
    hier = mesh is not None and min(mesh.H, mesh.C) > 1
    if merge_resort and overlap and hier:
        raise ValueError("merge_resort=True with overlap=True is supported "
                         "on 1-D groups only (the 2-D overlap keeps the "
                         "packed half-exchange)")
    g = _Group(mesh.group if mesh is not None else group, dev)
    phase = _Phases(phase_times, dev)
    n_local = keys.numel()
    n, m = _shard_layout(n_local, g, dev)
    if n == 0:
        return keys.clone(), values.clone() if kv else None
    phase("layout")

    # count= masks the global suffix with sentinels; each rank pads its
    # shard to m, as the JAX package pads the global tail
    live = None
    mk = keys
    if count is not None:
        live = (torch.arange(n_local, device=dev) + g.rank * m
                < count_tensor(count, dev))
        mk = select_u32(live, keys, max_like_u32(keys))
    arrs = [pad_u32(mk, m, 0xFFFFFFFF)]
    if kv:
        arrs.append(pad_u32(values, m, 0))
    phase("mask_pad")

    # 1. local stable sort
    arrs = _sort_arrs(arrs, config, use_kernels)
    phase("local_sort")

    # 2-3. exact balanced cuts -> the size matrix, on the host; every
    # verdict below is read from it before any exchange
    sizes = _exchange_plan(arrs[0], m, g)
    D = g.size
    split = (mesh.H // 2) * mesh.C if hier else D // 2
    slack = 1
    if hier:
        halves = ([_from_sources(sizes, 0, split),
                   _from_sources(sizes, split, D)] if overlap else [sizes])
        need = max(_staging_need(s, mesh.H, mesh.C) for s in halves)
        slack = _pick_slack(need, m, mesh.H, mesh.C, dcn_slack)
    use_merge = bool(merge_resort) or (
        merge_resort is None and use_kernels and D > 1
        and not (hier and overlap))
    S = slot_size(m, D)
    if use_merge and max(map(max, sizes)) > S:
        if merge_resort:
            raise ValueError(
                "merge_resort slot staging (2x even-share) overflowed for "
                "this key distribution; pass merge_resort=None (auto "
                "fallback) or False")
        use_merge = False
    route = mesh if hier else None
    phase("plan")

    if overlap and split >= 1:
        # 4'. two half-exchanges, their sorts or merges, the half merge
        ko, vo = _overlap(arrs, sizes, split, g, route, m, slack,
                          S if use_merge else None, config, use_kernels)
        phase("overlap")
    else:
        # 4. the exchange, arrivals packed in flat source rank order
        got = [torch.empty(m, dtype=torch.uint32, device=dev) for _ in arrs]
        _exchange(arrs, sizes, g, route, m, slack, got)()
        phase("exchange")

        # 5. re-sort: merge rounds over the slots, or a full local sort
        if use_merge:
            bufs, slot_sizes = slot_arrivals(
                got, [row[g.rank] for row in sizes], S)
            phase("place")
            ko, vo = merge_finish(bufs, slot_sizes, S, m, config)
        else:
            ko, *rest = _sort_arrs(got, config, use_kernels)
            vo = rest[0] if kv else None
        phase("resort")

    ko = ko[:n_local]
    if live is not None:
        ko = select_u32(live, ko, keys)
    if kv:
        vo = vo[:n_local]
        if live is not None:
            vo = select_u32(live, vo, values)
    phase("restore")
    return ko, vo


def sort_sharded(keys: torch.Tensor, group=None,
                 config: SortConfig | None = None, count=None,
                 use_kernels: bool | None = None, overlap: bool = False,
                 dcn_slack: int | None = None,
                 merge_resort: bool | None = None,
                 phase_times: dict | None = None) -> torch.Tensor:
    """Sort uint32 keys held across the ranks of `group` (default: the
    default process group; or a `Mesh2D`); every rank calls this with its
    own shard and gets back its shard of the globally sorted keys (same
    length).

    count= (an int, or a 0-d tensor on the keys' device; the same on every
    rank) sorts only the global prefix and leaves the suffix untouched: the
    distributed analog of vrdxCmdSortIndirect. use_kernels=None uses the
    network's CUDA kernels when the keys lie on a card (the counterpart of
    the JAX package's use_pallas), the torch.sort reference otherwise;
    True on CPU tensors runs the kernels' plain versions.

    overlap=True source-splits the exchange (by rank half; by host half on
    a 2-D mesh) so that the second half's collective runs while the first
    half is sorted (module docstring); a world of one rank has nothing to
    split and sorts as without it.

    A 2-D mesh (`make_mesh_2d`) with at least two hosts of at least two
    ranks routes the exchange in two hops, one slow-tier (dcn) message per
    destination host; dcn_slack sizes the hop-A staging buffer in shards
    (None: the smallest sufficient of min(2, min(H, C)) doubled up to
    min(H, C); an explicit value that does not suffice raises ValueError).
    Other meshes, and dcn_slack on a 1-D group, sort as 1-D.

    merge_resort (None = on when kernels are used, there is more than one
    rank and the sort is not a 2-D overlap) receives the exchange into
    per-source slots and re-sorts with the network's merge rounds only,
    falling back to the packed exchange and a full re-sort when a source's
    run would overflow its slot (heavily skewed exchanges); True raises
    instead, and raises with overlap=True on a 2-D mesh. phase_times, when
    a dict, gets each phase's wall seconds added to it.
    """
    return _sort_impl(keys, None, group=group, config=config, count=count,
                      use_kernels=use_kernels, overlap=overlap,
                      merge_resort=merge_resort, dcn_slack=dcn_slack,
                      phase_times=phase_times)[0]


def sort_pairs_sharded(keys: torch.Tensor, values: torch.Tensor, group=None,
                       config: SortConfig | None = None, count=None,
                       use_kernels: bool | None = None,
                       overlap: bool = False, dcn_slack: int | None = None,
                       merge_resort: bool | None = None,
                       phase_times: dict | None = None):
    """Stable distributed key-value sort; values ride a second exchange.
    Arguments as in `sort_sharded`. count= sorts the global prefix of pairs
    and leaves both tails untouched: masked entries form a global suffix in
    (rank, position) order, so the stable pipeline keeps them behind every
    genuine equal key. With the merge re-sort the tiebreak is (slot,
    position in slot) = (source rank, intra-source order); on a 2-D mesh
    hop B keeps flat source rank order; with overlap each half's arrivals
    are a genuine prefix that its stable sort keeps ahead of the fill, and
    the half merge puts the lower sources first on equal keys: the same
    stability contract every way. Returns this rank's (keys, values)."""
    return _sort_impl(keys, values, group=group, config=config, count=count,
                      use_kernels=use_kernels, overlap=overlap,
                      merge_resort=merge_resort, dcn_slack=dcn_slack,
                      phase_times=phase_times)
