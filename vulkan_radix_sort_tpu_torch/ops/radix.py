"""LSD radix sort: the host code over the block sort (K7), the spine and
the placement (K8).

Counterpart of `vulkan_radix_sort_tpu/ops/radix.py`, and of the
reference's gpuSort (h.in:344-507): `num_passes` passes over `digit_bits`
digits, least significant first, each three launches with no torch op
between them:

    block_sort (K7) -> spine -> stream_place (K8)

as the reference's upsweep -> spine -> downsweep. PyTorch runs the three on
one stream, in order, so no barrier is written out. K8 writes each pass
into a new buffer; the pass loop drops its input first, so the caching
allocator hands K8 that memory back and two key (and value) buffers
ping-pong, as in the reference (h.in:400-502).

Keys are padded to a block multiple with the sentinel 0xFFFFFFFF (values
with 0), the reference's own trick (upsweep.slang:32): every pass is
stable, and the pads sit after every genuine key in input order, so they
stay behind genuine 0xFFFFFFFF keys and are sliced off at the end. The
JAX package pads to 8 blocks for a TPU SMEM tile rule; the port needs no
such rule.
"""

from __future__ import annotations

import torch

from ..config import KEY_SENTINEL, SortConfig, default_config, round_up
from . import block_sort as k7
from . import reference
from . import stream_place as k8
from ..utils import timing
from ..utils.timing import time_fn
from .bitops import check_u32, pad_u32

# Below this size the reference backend sorts instead, as the JAX package
# hands n < _MIN_PALLAS_N to lax.sort (its radix.py:31,58-59).
MIN_RADIX_N = 1 << 14


def sort_u32(keys: torch.Tensor, *, config: SortConfig | None = None):
    """Ascending sort of uint32 keys through the radix kernels. Returns a
    new tensor; `keys` is not modified."""
    config = config or default_config()
    check_u32(keys)
    n = keys.numel()
    if n < MIN_RADIX_N:
        return reference.sort_keys(keys)
    with timing.span("vrs.pad"):
        x = pad_u32(keys, round_up(n, config.block), KEY_SENTINEL)
    for p in range(config.num_passes):
        shift = p * config.digit_bits
        y, hist = k7.block_sort(x, shift=shift, config=config)
        del x  # its memory takes K8's output: the ping-pong
        g, offsets = k8.spine(hist)
        x = k8.stream_place(y, hist, g, config=config, shift=shift,
                            offsets=offsets)
    return x[:n]


def sort_pairs_u32(keys: torch.Tensor, values: torch.Tensor, *,
                   config: SortConfig | None = None):
    """Stable key-value sort; values ride as a separate uint32 buffer per
    pass (the reference's key-value layout, README.md:60)."""
    config = config or default_config()
    check_u32(keys, values)
    n = keys.numel()
    if n < MIN_RADIX_N:
        return reference.sort_pairs(keys, values)
    size = round_up(n, config.block)
    with timing.span("vrs.pad"):
        x, v = pad_u32(keys, size, KEY_SENTINEL), pad_u32(values, size, 0)
    for p in range(config.num_passes):
        shift = p * config.digit_bits
        y, yv, hist = k7.block_sort(x, v, shift=shift, config=config,
                                    key_value=True)
        del x, v
        g, offsets = k8.spine(hist)
        x, v = k8.stream_place(y, hist, g, yv, config=config,
                               key_value=True, shift=shift, offsets=offsets)
    return x[:n], v[:n]


def stage_times(keys: torch.Tensor, config: SortConfig,
                iters: int = 10) -> dict:
    """Seconds per stage of one keys pass, and of all passes: the block
    sort (upsweep), the spine kernel, and the placement kernel alone
    (downsweep). The analog of the reference's timestamps (h.in:39-50). On
    the card only: `time_fn` raises without one."""
    check_u32(keys)
    size = round_up(max(keys.numel(), config.block), config.block)
    x = pad_u32(keys, size, KEY_SENTINEL)
    y, hist = k7.block_sort(x, shift=0, config=config)
    g, offsets = k8.spine(hist)
    t_up = time_fn(lambda: k7.block_sort(x, shift=0, config=config),
                   iters=iters)
    t_sp = time_fn(lambda: k8.spine(hist), iters=iters)
    t_down = time_fn(lambda: k8.stream_place(y, hist, g, config=config,
                                             shift=0, offsets=offsets),
                     iters=iters)
    npass = config.num_passes
    return {
        "upsweep": t_up * npass,
        "spine": t_sp * npass,
        "downsweep": t_down * npass,
        "per_pass": {"upsweep": t_up, "spine": t_sp, "downsweep": t_down},
    }
