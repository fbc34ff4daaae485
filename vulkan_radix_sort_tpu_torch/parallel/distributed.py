"""Distributed sort on torch.distributed: the 1-D path.

Counterpart of the 1-D path of `vulkan_radix_sort_tpu/parallel/distributed.py`
(a jax.sharding.Mesh there, a process group here). Every rank calls
`sort_sharded` / `sort_pairs_sharded` on its own contiguous shard and gets
back its shard of the globally sorted output. Shards follow the JAX layout:
with D ranks and n elements in all, m = ceil(n / D) and rank d holds global
[d*m, min((d+1)*m, n)), so a later rank's shard may be short or empty. The
JAX package pads the global tail with sentinels (`_pad_to_mesh`); here each
rank pads its own shard to m, which gives the same padded array.

Algorithm (exact, stable, skew-proof), as in the JAX package:
  1. every rank sorts its shard (the network when kernels are used, else
     the torch.sort reference);
  2. exact splitter keys from 4 byte rounds over all_reduce'd (D-1, 256)
     candidate counts;
  3. keys equal to a splitter are split by count in (rank, position) order,
     so the output stays stable and every output shard exactly m long;
  4. the exchange: `all_to_all_single` with the plan's split sizes (values
     ride a second one);
  5. the re-sort. With the merge re-sort each source's run goes into a slot
     of its own and only the network's log2(D) merge rounds run
     (`bitonic.merge_slots_*`, whose local passes are K6); otherwise the
     packed arrivals are sorted again in full.

Host and device. `all_to_all_single` takes its split sizes as Python ints,
so the (D, D) size matrix comes to the host once per sort (one all_gather;
one more gathers the shard lengths). The slot-fit verdict (every
source-to-destination run fits its slot) is read from that matrix before
the exchange rather than after it as in the JAX package: every rank reaches
the same verdict and the answer is the same. Tensors stay on the keys'
device; nothing is moved to the CPU. NCCL needs CUDA tensors (rank r on
cuda:(r % device_count) is the usual layout); gloo takes CPU and CUDA
tensors alike (it stages CUDA tensors through the host itself), which is
how several ranks share one card: NCCL refuses two ranks on one device.

Not in this slice, each raising NotImplementedError: `overlap=True` (the
source-split exchange), the 2-D dcn/ici tier (`make_mesh_2d`), and the
reports of `parallel/scaling.py`.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import MIN_CHUNK, SortConfig, cdiv, default_config
from ..ops import bitonic, reference
from ..ops.bitonic import count_tensor
from ..ops.bitops import (check_u32, max_like_u32, pad_u32, select_u32,
                          widen_u32)

_SENTINEL_I32 = -1  # 0xFFFFFFFF as an int32 bit pattern


def make_mesh_2d(*args, **kwargs):
    """The 2-D ("dcn", "ici") tier of the JAX package: not ported yet."""
    raise NotImplementedError("the 2-D dcn/ici tier is not ported yet")


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

    def all_to_all(self, x: torch.Tensor, send: list[int],
                   recv: list[int]) -> torch.Tensor:
        """Ragged exchange of uint32 x: send[d] consecutive elements to rank
        d; arrivals packed in source rank order."""
        out = torch.empty(sum(recv), dtype=torch.int32, device=x.device)
        dist.all_to_all_single(out, x.view(torch.int32), recv, send,
                               group=self.group)
        return out.view(torch.uint32)


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
    cfg = config if config is not None else default_config()
    if values is None:
        if use_kernels:
            return bitonic.sort_u32(keys, chunk=cfg.chunk_keys)
        return reference.sort_keys(keys)
    if use_kernels:
        return bitonic.sort_pairs_u32(keys, values, chunk=cfg.chunk_carry)
    return reference.sort_pairs(keys, values)


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
            for x, fill in zip(got, (_SENTINEL_I32, 0))]
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
               merge_resort, phase_times):
    if overlap:
        raise NotImplementedError(
            "overlap=True (the source-split exchange) is not ported yet")
    kv = values is not None
    check_u32(*((keys, values) if kv else (keys,)))
    dev = keys.device
    if use_kernels is None:
        use_kernels = _default_use_kernels(keys, config)
    if merge_resort and not use_kernels:
        raise ValueError("merge_resort=True requires the kernels "
                         "(use_kernels)")
    g = _Group(group, dev)
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
    ks = pad_u32(mk, m, 0xFFFFFFFF)
    vs = pad_u32(values, m, 0) if kv else None
    phase("mask_pad")

    # 1. local stable sort
    ks, vs = _local_sort(ks, vs, config, use_kernels) if kv else (
        _local_sort(ks, None, config, use_kernels), None)
    phase("local_sort")

    # 2-3. exact balanced cuts -> the size matrix, on the host
    sizes_all = _exchange_plan(ks, m, g)
    send = sizes_all[g.rank]
    recv = [row[g.rank] for row in sizes_all]
    use_merge = bool(merge_resort) or (
        merge_resort is None and use_kernels and g.size > 1)
    S = slot_size(m, g.size)
    if use_merge and max(map(max, sizes_all)) > S:
        if merge_resort:
            raise ValueError(
                "merge_resort slot staging (2x even-share) overflowed for "
                "this key distribution; pass merge_resort=None (auto "
                "fallback) or False")
        use_merge = False
    phase("plan")

    # 4. the exchange, arrivals packed in source rank order
    got = [g.all_to_all(x, send, recv) for x in ((ks, vs) if kv else (ks,))]
    phase("exchange")

    # 5. re-sort: merge rounds over the slots, or a full local sort
    if use_merge:
        bufs, sizes = slot_arrivals(got, recv, S)
        phase("place")
        ko, vo = merge_finish(bufs, sizes, S, m, config)
    elif kv:
        ko, vo = _local_sort(got[0], got[1], config, use_kernels)
    else:
        ko, vo = _local_sort(got[0], None, config, use_kernels), None
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
                 merge_resort: bool | None = None,
                 phase_times: dict | None = None) -> torch.Tensor:
    """Sort uint32 keys held across the ranks of `group` (default: the
    default process group); every rank calls this with its own shard and
    gets back its shard of the globally sorted keys (same length).

    count= (an int, or a 0-d tensor on the keys' device; the same on every
    rank) sorts only the global prefix and leaves the suffix untouched: the
    distributed analog of vrdxCmdSortIndirect. use_kernels=None uses the
    network's CUDA kernels when the keys lie on a card (the counterpart of
    the JAX package's use_pallas), the torch.sort reference otherwise;
    True on CPU tensors runs the kernels' plain versions.

    merge_resort (None = on when kernels are used and there is more than
    one rank) receives the exchange into per-source slots and re-sorts with
    the network's merge rounds only, falling back to the packed exchange and
    a full re-sort when a source's run would overflow its slot (heavily
    skewed exchanges); True raises instead. phase_times, when a dict, gets
    each phase's wall seconds added to it.
    """
    return _sort_impl(keys, None, group=group, config=config, count=count,
                      use_kernels=use_kernels, overlap=overlap,
                      merge_resort=merge_resort, phase_times=phase_times)[0]


def sort_pairs_sharded(keys: torch.Tensor, values: torch.Tensor, group=None,
                       config: SortConfig | None = None, count=None,
                       use_kernels: bool | None = None,
                       overlap: bool = False,
                       merge_resort: bool | None = None,
                       phase_times: dict | None = None):
    """Stable distributed key-value sort; values ride a second exchange.
    Arguments as in `sort_sharded`. count= sorts the global prefix of pairs
    and leaves both tails untouched: masked entries form a global suffix in
    (rank, position) order, so the stable pipeline keeps them behind every
    genuine equal key. With the merge re-sort the tiebreak is (slot,
    position in slot) = (source rank, intra-source order), the same
    stability contract. Returns this rank's (keys, values)."""
    return _sort_impl(keys, values, group=group, config=config, count=count,
                      use_kernels=use_kernels, overlap=overlap,
                      merge_resort=merge_resort, phase_times=phase_times)
