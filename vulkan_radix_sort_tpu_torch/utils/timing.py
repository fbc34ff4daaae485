"""Timing on the card with CUDA events, and a recorder of kernel launches.

Counterpart of `vulkan_radix_sort_tpu/utils/timing.py`. The JAX package
chained its function inside a `fori_loop` to divide out a remote TPU's
dispatch latency; on a local card CUDA events bracket the device work
directly. A time is only ever taken on a card: with none present
`time_fn` raises rather than time the CPU.

`LaunchTimer` records every kernel launch made while it is active. The
kernels' wrappers (`bitonic_kernels.run`, `block_sort.block_sort`,
`stream_place.spine`, `stream_place.stream_place`) call `launch` around
each launch, or for CPU buffers around the plain version that stands in
for it; `launch` records it in every active LaunchTimer: its counter
names, the arguments that size its work, and on a CUDA device a pair of
CUDA events on the device's current stream around it. On the CPU a record has no events, so
the launch plan can be checked without a card.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

import torch


@dataclass
class StageTimes:
    """Per-stage nanosecond totals, mirror of Results in
    bench/benchmark_base.h:10-28."""

    total_ns: float = 0.0
    cpu_ns: float = 0.0
    upsweep_ns: float = 0.0
    spine_ns: float = 0.0
    downsweep_ns: float = 0.0
    extra: dict = field(default_factory=dict)


def time_fn(fn, *args, iters: int = 10, repeats: int = 5,
            warmup: int = 2) -> float:
    """Median seconds per call of fn(*args) on the current CUDA device.

    Warms up, then for each of `repeats` samples launches fn `iters` times
    between two CUDA events and synchronizes once; returns the median
    sample divided by `iters`. fn gets the same arguments on every call.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures device time and needs a CUDA "
                           "device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(samples)


# The active LaunchTimers, innermost last. Empty unless a caller has
# entered one, which is all `launch` tests on the kernels' paths.
_ACTIVE: list[LaunchTimer] = []


class LaunchTimer:
    """Context manager that records every kernel launch made inside it.

    `records` holds one dict per launch, in launch order: `names` (the
    launch counters it adds to, e.g. ["cross"] or ["chunk", "gate"]),
    `tag` (this timer's `tag` at the launch, for callers that group
    launches by sort), `events` (a (start, end) pair of CUDA events, or
    None on the CPU) and the keywords the wrapper passed (`launch`,
    `mode`, `numel`, `nunits`, `valid` for the network kernels; `numel`,
    `shift`, `config`, `key_value` for K7 and K8; `nblocks`, `radix` for
    the spine), held by reference.
    """

    def __init__(self):
        self.records: list[dict] = []
        self.tag = ""

    def __enter__(self) -> LaunchTimer:
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def seconds(self) -> list[float | None]:
        """Device seconds of each record (None for a CPU launch); waits
        for the last launch to finish."""
        timed = [r["events"] for r in self.records if r["events"]]
        if timed:
            timed[-1][1].synchronize()
        return [None if r["events"] is None
                else r["events"][0].elapsed_time(r["events"][1]) / 1e3
                for r in self.records]


def launch(run, names: list[str], device: torch.device, **info):
    """Call `run()`, one kernel launch (or, for CPU buffers, its plain
    version), and record it in every active LaunchTimer: with a CUDA event
    on each side on a CUDA device, without on the CPU."""
    if not _ACTIVE:
        return run()
    events = stream = None
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(stream)
    out = run()
    if events:
        events[1].record(stream)
    for timer in _ACTIVE:
        timer.records.append(dict(info, names=names, tag=timer.tag,
                                  events=events))
    return out
