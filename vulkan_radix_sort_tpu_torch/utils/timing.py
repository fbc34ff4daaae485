"""Timing on the card with CUDA events, and a recorder of kernel launches,
spans and counts.

Counterpart of `vulkan_radix_sort_tpu/utils/timing.py`. The JAX package
chained its function inside a `fori_loop` to divide out a remote TPU's
dispatch latency; on a local card CUDA events bracket the device work
directly. A time is only ever taken on a card: with none present
`time_fn` raises rather than time the CPU.

`LaunchTimer` records every kernel launch, span and count made while it is
active. The kernels' wrappers (`bitonic_kernels.run`,
`block_sort.block_sort`, `stream_place.spine`, `stream_place.stream_place`,
`radix.restore_tail`, ...) call `launch` around each launch,
or for CPU buffers around the plain version that stands in for it;
`launch` records it in every active LaunchTimer: its counter names, the
arguments that size its work, the innermost open span, and on a CUDA
device a pair of CUDA events on the device's current stream around it.
On the CPU a record has no events, so the launch plan can be checked
without a card: a record with events is a kernel launch, one without a
plain stand-in.

`span` bounds a stretch of the program's own work (the entry points, the
`count=` masks) on the host's clock, and `count` counts an event (the
backend that served a call, a radix sort's passes and first-pass load). With no LaunchTimer active and the torch
profiler off, `span` hands back one shared null context and `count`
returns at once: they cost a test or two, no torch call. While the torch
profiler runs, every span is also a host range of that name on the
profiler's timeline, with the kernels it enqueued beneath it, so a trace
puts the device's idle time down to the span the host was in.
"""

from __future__ import annotations

import itertools
import statistics
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler


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
# entered one, which is all `launch` and `count` test on the program's
# paths.
_ACTIVE: list[LaunchTimer] = []
# The spans open while a LaunchTimer is active, innermost last.
_OPEN: list[dict] = []
_IDS = itertools.count()
# A host range on the torch profiler's timeline: well under a microsecond
# when the profiler records no host events, which Python cannot ask it.
_RANGE = torch._C._profiler._RecordFunctionFast


class _Null:
    """The shared null span: the cheapest context manager Python has."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, typ, value, tb) -> None:
        return None


_NULL = _Null()


class LaunchTimer:
    """Context manager that records every kernel launch, span and count
    made inside it.

    `records` holds one dict per launch, in launch order: `names` (the
    launch counters it adds to, e.g. ["cross"] or ["chunk", "gate"]),
    `tag` (this timer's `tag` at the launch, for callers that group
    launches by sort), `events` (a (start, end) pair of CUDA events, or
    None on the CPU), `span` and `root` (the ids of the innermost open
    span and of the outermost, or None) and the keywords the wrapper
    passed (`launch`, `mode`, `numel`, `nunits`, `valid` for the network
    kernels; `numel`, `shift`, `config`, `key_value` for K7 and K8;
    `nblocks`, `radix` for the spine), held by reference.

    `spans` holds one dict per span opened inside it, in opening order:
    `name`, `id`, `parent` (the enclosing span's id, or None), `root` (the
    outermost enclosing span's id, its own for an entry point: every span
    and launch of one call shares it), `start_ns` and `end_ns` (host
    `perf_counter_ns`) and the span's keywords.
    `counts` maps each name given to `count` to its total.
    """

    def __init__(self):
        self.records: list[dict] = []
        self.spans: list[dict] = []
        self.counts: dict[str, int] = {}
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
    inner = _OPEN[-1] if _OPEN else None
    for timer in _ACTIVE:
        timer.records.append(dict(
            info, names=names, tag=timer.tag, events=events,
            span=inner and inner["id"], root=inner and inner["root"]))
    return out


class _Span:
    """One span: a host range on the profiler's timeline while it runs,
    an entry in every active LaunchTimer's `spans` while one is active."""

    __slots__ = ("name", "info", "entry", "range")

    def __init__(self, name: str, info: dict):
        self.name, self.info = name, info
        self.entry = self.range = None

    def __enter__(self) -> dict | None:
        if _profiler._is_profiler_enabled:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        if not _ACTIVE:
            return None
        parent = _OPEN[-1] if _OPEN else None
        sid = next(_IDS)
        self.entry = dict(
            self.info, name=self.name, id=sid,
            parent=parent and parent["id"],
            root=parent["root"] if parent else sid,
            start_ns=time.perf_counter_ns(), end_ns=None)
        for timer in _ACTIVE:
            timer.spans.append(self.entry)
        _OPEN.append(self.entry)
        return self.entry

    def __exit__(self, *exc) -> None:
        if self.entry is not None:
            self.entry["end_ns"] = time.perf_counter_ns()
            _OPEN.pop()  # spans nest: this one is innermost
        if self.range is not None:
            self.range.__exit__(*exc)


def span(name: str, **info):
    """A context manager that bounds one stretch of the program's work as
    the span `name` with the keywords `info` (see `LaunchTimer.spans`).
    With no LaunchTimer active and the torch profiler off it is one shared
    null context."""
    if not _ACTIVE and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, info)


def count(name: str, k: int = 1) -> None:
    """Add k to the count `name` of every active LaunchTimer."""
    for timer in _ACTIVE:
        timer.counts[name] = timer.counts.get(name, 0) + k
