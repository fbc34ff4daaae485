"""Scaling and overlap reports of the distributed sort.

Counterpart of `vulkan_radix_sort_tpu/parallel/scaling.py`: `phase_report`
(a 1-D group), `dcn_report` (a `Mesh2D`) and `scaling_report` (weak
scaling over the first d ranks of the default group). Phases:
  local_sort  the sort of the input shard,
  exchange    the splitter search and the exchange (both hops on 2-D),
  resort      the sort of the received keys,
  full        one `sort_sharded` with the full re-sort (the pipeline the
              three phases make up), and with merge_resort=True as
              `full_merge_s` where the kernels run and the slots fit.
`overlap_hidden_s` = (sum of the phases) - full: what the pipeline hides
by overlapping, or (negative) what it costs beyond its parts.

Each time is the mean over `iters` calls after one untimed call, started
after a barrier, taken with CUDA events on a card (`utils.timing.time_fn`)
and with the host clock on the CPU; the report gives the slowest rank's.
The JAX package chained each phase in a `fori_loop` (`marginal_time`) to
divide out a remote TPU's dispatch latency and timed the exchange as
(exchange then re-sort) minus re-sort to keep the chain's input sorted;
here each phase is called directly, on the same input each time. A time
taken with the CPU's clock is no device figure.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import SortConfig
from ..utils import datagen, timing
from . import distributed as D


def _seconds(fn, iters: int, g, dev: torch.device) -> float:
    """Seconds per call of fn() on the slowest rank of `g`."""
    fn()  # builds the kernels; no timed call pays for that
    dist.barrier(group=g.group)
    if dev.type == "cuda":
        t = timing.time_fn(fn, iters=iters, repeats=1, warmup=0)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) / iters
    box = torch.tensor([t], dtype=torch.float64, device=dev)
    dist.all_reduce(box, op=dist.ReduceOp.MAX, group=g.group)
    return float(box.item())


def _setup(group, n: int, seed: int, device, use_kernels, config):
    """This rank's part of a report of n seeded uniform keys over the
    flat `group`: (the group, shard size m, the shard, the shard sorted,
    the exchange's size matrix, use_kernels resolved)."""
    dev = torch.device(device)
    g = D._Group(group, dev)
    if n % g.size:
        raise ValueError(f"use a multiple of the {g.size} ranks for n, got "
                         f"{n}")
    m = n // g.size
    keys = datagen.generate_keys(n, seed=seed)[g.rank * m:(g.rank + 1) * m]
    keys = torch.from_numpy(keys).to(dev)
    if use_kernels is None:
        use_kernels = D._default_use_kernels(keys, config)
    ks = D._local_sort(keys, None, config, use_kernels)
    return g, m, keys, ks, D._exchange_plan(ks, m, g), use_kernels


def _phases(keys, ks, sizes, group, g, mesh, m: int, slack: int, config,
            use_kernels, iters: int, full_kw: dict) -> dict:
    """The four phase times, the exchange over `mesh` if any (`ks` the
    sorted shard, `sizes` its size matrix); and `full_merge_s` where the
    kernels run, there is more than one rank, no overlap, and the slots
    fit."""
    dev = keys.device

    def exchange():
        sizes = D._exchange_plan(ks, m, g)
        out = torch.empty(m, dtype=torch.uint32, device=dev)
        D._exchange([ks], sizes, g, mesh, m, slack, [out])()
        return out

    got = exchange()

    def full(**kw):
        return D.sort_sharded(keys, group, config, use_kernels=use_kernels,
                              **full_kw, **kw)

    rep = {"local_sort_s": _seconds(
               lambda: D._local_sort(keys, None, config, use_kernels),
               iters, g, dev),
           "exchange_s": _seconds(exchange, iters, g, dev),
           "resort_s": _seconds(
               lambda: D._local_sort(got, None, config, use_kernels),
               iters, g, dev),
           "full_s": _seconds(lambda: full(merge_resort=False), iters, g,
                              dev)}
    if (use_kernels and g.size > 1 and not full_kw.get("overlap")
            and max(map(max, sizes)) <= D.slot_size(m, g.size)):
        rep["full_merge_s"] = _seconds(lambda: full(merge_resort=True),
                                       iters, g, dev)
    return rep


def phase_report(group, n: int, config: SortConfig | None = None,
                 use_kernels: bool | None = None, overlap: bool = False,
                 seed: int = 0, iters: int = 3, device="cuda") -> dict:
    """Per-phase seconds of the distributed sort of n seeded uniform keys
    (`datagen.generate_keys(n, seed)`, sharded evenly) over the 1-D
    `group`; every rank of it calls this and gets the same report. full_s
    runs with `overlap`, and `full_merge_s` (the merge re-sort) is timed
    without overlap where the kernels run and the slots fit. Keys as in
    the JAX package's, with use_kernels in place of use_pallas."""
    if isinstance(group, D.Mesh2D):
        raise ValueError("phase_report measures 1-D groups; use dcn_report "
                         "for a 2-D mesh")
    g, m, keys, ks, sizes, use_kernels = _setup(group, n, seed, device,
                                                use_kernels, config)
    rep = _phases(keys, ks, sizes, group, g, None, m, 1, config,
                  use_kernels, iters, {"overlap": overlap})
    parts = rep["local_sort_s"] + rep["exchange_s"] + rep["resort_s"]
    return {"n": n, "devices": g.size, **rep,
            "overlap_hidden_s": parts - rep["full_s"],
            "exchange_fraction": rep["exchange_s"] / parts if parts > 0
            else 0.0,
            "overlap_mode": overlap, "use_kernels": use_kernels}


def dcn_report(mesh2d: D.Mesh2D, n: int, config: SortConfig | None = None,
               use_kernels: bool | None = None, dcn_slack: int = 2,
               seed: int = 0, iters: int = 3, device="cuda") -> dict:
    """Phase seconds and per-tier traffic of the two-hop exchange on a 2-D
    mesh, n seeded uniform keys, staging at `dcn_slack` shards; every rank
    of the mesh calls this and gets the same report.

    Bytes come from the run's own size matrix: `dcn_bytes` are what moves
    between hosts (the flat plan's cross-host bytes: the two hops change
    the slow tier's message count, H-1 a rank in place of (H-1)*C, not its
    bytes), `hop_b_ici_bytes` what hop B forwards, every key once. Raises
    if the plan overflows dcn_slack (as the JAX report does: its timed
    program would move nothing)."""
    g, m, keys, ks, sizes, use_kernels = _setup(mesh2d.group, n, seed,
                                                device, use_kernels, config)
    H, C = mesh2d.H, mesh2d.C
    if D._staging_need(sizes, H, C) > dcn_slack * m:
        raise ValueError(f"dcn_slack={dcn_slack} staging overflows for this "
                         "distribution; rerun dcn_report with a larger "
                         "dcn_slack")
    rep = _phases(keys, ks, sizes, mesh2d, g, mesh2d, m, dcn_slack, config,
                  use_kernels, iters, {"dcn_slack": dcn_slack})
    s4 = np.asarray(sizes, dtype=np.int64).reshape(H, C, H, C)
    within = sum(int(s4[h, :, h].sum()) for h in range(H))
    parts = rep["local_sort_s"] + rep["exchange_s"] + rep["resort_s"]
    return {"n": n, "mesh": (H, C), **rep,
            "exchange_fraction": rep["exchange_s"] / parts if parts > 0
            else 0.0,
            "dcn_bytes": 4 * (int(s4.sum()) - within),
            "hop_b_ici_bytes": 4 * int(s4.sum()),
            "dcn_messages_per_chip": H - 1,
            "flat_dcn_messages_per_chip": (H - 1) * C,
            "dcn_slack": dcn_slack, "use_kernels": use_kernels}


def scaling_report(m_per_device: int, device_counts=None,
                   config: SortConfig | None = None,
                   use_kernels: bool | None = None, iters: int = 3,
                   device="cuda") -> list:
    """Weak scaling: `phase_report` at m_per_device keys a rank over the
    first d ranks of the default group for each d of device_counts
    (default: 1, 2, 4, 8, 16 up to the world size), with weak_efficiency =
    t(1) / t(d) of full_s (1.0 = perfect weak scaling). Every rank of the
    default group calls this (each d makes a `dist.new_group`) and gets
    the same rows."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16) if d <= world]
    rows = []
    for d in device_counts:
        sub = dist.new_group(list(range(d)))
        box = [None]
        if dist.get_rank() < d:
            box[0] = phase_report(sub, m_per_device * d, config=config,
                                  use_kernels=use_kernels, iters=iters,
                                  device=device)
        dist.broadcast_object_list(box, src=0)  # rank 0 is in every group
        rows.append(box[0])
    t1 = rows[0]["full_s"]
    for rep in rows:
        rep["weak_efficiency"] = t1 / rep["full_s"] if rep["full_s"] > 0 \
            else 0.0
    return rows
