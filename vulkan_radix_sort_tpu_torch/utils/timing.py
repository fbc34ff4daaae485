"""Timing on the card with CUDA events.

Counterpart of `vulkan_radix_sort_tpu/utils/timing.py`. The JAX package
chained its function inside a `fori_loop` to divide out a remote TPU's
dispatch latency; on a local card CUDA events bracket the device work
directly. A time is only ever taken on a card: with none present these
functions raise rather than time the CPU.
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
    sample divided by `iters`.
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
