"""Profiling: a device trace, and a per-stage report of one sort.

Counterpart of `vulkan_radix_sort_tpu/utils/profiling.py`. The reference
instruments each sort with GPU timestamps decoded into per-stage sums
(src/vk_radix_sort.h.in:39-50, bench/vulkan_benchmark.cc:318-337). Here:

  * `trace(log_dir)`: a context manager around `torch.profiler` (CPU
    activity, and CUDA activity where a card is present) that writes a
    Chrome trace into `log_dir`: the per-kernel device timeline. Kernels
    appear under the names CUPTI reports: the mangled names of the
    template instantiations in `csrc/`, each containing its kernel's name
    (`chunk_kernel`, `fused_kernel`, `cross_kernel`, ...).
  * `stage_report(keys, config)`: `Sorter.sort_timed`'s per-stage times,
    formatted like the reference bench's per-stage lines
    (bench/bench.cc:178-186). On the card only.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write `trace_<pid>.json` (Chrome trace
    format) into `log_dir`. Yields the `torch.profiler.profile`, whose
    `key_averages()` and `events()` the caller may read after the
    block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def stage_report(keys: torch.Tensor, config=None, iters: int = 5) -> str:
    """Human-readable per-stage breakdown of one sort of `keys` on their
    device (a card), reference-style, headed by the backend that ran: the
    sorter's keys backend, which 'auto' picks by the keys' n."""
    from ..models.sorter import Sorter

    s = Sorter(keys.numel(), key_dtype=keys.dtype, config=config,
               device=keys.device)
    t = s.sort_timed(keys, iters=iters)
    total = max(t.total_ns, 1.0)
    lines = [f"backend={s.backend} n={keys.numel()} total "
             f"{t.total_ns / 1e6:9.3f} ms"]
    names = (("chunk", "cross", "local") if s.backend == "network"
             else ("upsweep", "spine", "downsweep"))
    for name, ns in zip(names, (t.upsweep_ns, t.spine_ns, t.downsweep_ns)):
        if ns:
            lines.append(f"  {name:<10} {ns / 1e6:9.3f} ms  "
                         f"({100.0 * ns / total:5.1f}%)")
    return "\n".join(lines)
