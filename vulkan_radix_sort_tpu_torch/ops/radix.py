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

With `count` (the reference's indirect sorts) the pad is one kernel,
`mask_pad`, that also writes the keys at or past the count as the
sentinel, so the masked tail sorts behind every genuine key in input
order, like the pads. The values are not masked: after the last pass the
tail's slots [count, n) hold its values in input order already, and one
more kernel, `restore_tail`, writes its keys back in place. The count is
a 0-d int64 tensor that only the kernels read, never the host.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import KEY_SENTINEL, SortConfig, default_config, round_up
from . import block_sort as k7
from . import reference
from . import stream_place as k8
from ..utils import timing
from ..utils.timing import time_fn
from .bitops import (check_u32, count_tensor, in_range, max_like_u32,
                     pad_u32, select_u32)

# Below this size the reference backend sorts instead, as the JAX package
# hands n < _MIN_PALLAS_N to lax.sort (its radix.py:31,58-59).
MIN_RADIX_N = 1 << 14


def _dense(a: torch.Tensor) -> torch.Tensor:
    """A caller's 1-D uint32 view as contiguous words (itself if it is)."""
    if a.is_contiguous():
        return a
    return a.view(torch.int32).contiguous().view(torch.uint32)


def mask_pad_plain(keys, values, count: torch.Tensor, size: int):
    """The plain version, on any device: keys selected where `arange(n) <
    count`, the sentinel elsewhere, and both padded by `pad_u32`."""
    live = in_range(keys, count)
    x = pad_u32(select_u32(live, keys, max_like_u32(keys)), size,
                KEY_SENTINEL)
    return x if values is None else (x, pad_u32(values, size, 0))


def _empty_u32(size: int, device) -> torch.Tensor:
    return torch.empty(size, dtype=torch.int32, device=device).view(
        torch.uint32)


def _mask_pad_launch(keys, values, count: torch.Tensor, size: int):
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    kv = values is not None
    keys = _dense(keys)
    values = _dense(values) if kv else None
    x = _empty_u32(size, dev)
    v = _empty_u32(size, dev) if kv else None
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vrs_mask_pad(int(kv), count.data_ptr(), keys.numel(), size,
                               keys.data_ptr(),
                               values.data_ptr() if kv else None,
                               x.data_ptr(), v.data_ptr() if kv else None,
                               stream)
    _build.check(err, "vrs_mask_pad")
    return (x, v) if kv else x


def mask_pad(keys, values, count: torch.Tensor, size: int):
    """New `size`-word buffers for the passes: keys[i] for i < count and
    the sentinel up to `size` (and values[i] for i < n, then 0). `count`
    is a 0-d int64 tensor on the keys' device, clamped to [0, n]. One
    kernel launch on the card; the plain version on the CPU."""
    body = mask_pad_plain if keys.device.type == "cpu" else _mask_pad_launch
    return timing.launch(lambda: body(keys, values, count, size),
                         ["mask_pad"], keys.device, numel=size,
                         n=keys.numel(), key_value=values is not None)


def restore_tail_plain(x, keys, count: torch.Tensor) -> torch.Tensor:
    """The plain version, on any device: x's first n keys, those at or
    past `count` taken from `keys`."""
    return select_u32(in_range(keys, count), x[:keys.numel()],
                      keys)


def _restore_tail_launch(x, keys, count: torch.Tensor) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    keys = _dense(keys)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vrs_restore_tail(count.data_ptr(), keys.numel(),
                                   keys.data_ptr(), x.data_ptr(), stream)
    _build.check(err, "vrs_restore_tail")
    return x[:keys.numel()]


def restore_tail(x, keys, count: torch.Tensor) -> torch.Tensor:
    """x[:n] of a sorted count= buffer, its slots [count, n) given back
    their keys: in place in x by one kernel launch on the card; the plain
    version on the CPU."""
    body = (restore_tail_plain if x.device.type == "cpu"
            else _restore_tail_launch)
    return timing.launch(lambda: body(x, keys, count), ["restore_tail"],
                         x.device, numel=keys.numel())


def _pad(keys, values, count, size: int):
    """The passes' first buffers: the plain pad, or with a count the
    mask-pad kernel."""
    if count is None:
        with timing.span("vrs.pad"):
            x = pad_u32(keys, size, KEY_SENTINEL)
            return x if values is None else (x, pad_u32(values, size, 0))
    with timing.span("vrs.count_mask"):
        return mask_pad(keys, values, count, size)


def _tail(x, keys, count):
    """The sorted keys, x[:n], with the masked tail given back."""
    if count is None:
        return x[:keys.numel()]
    with timing.span("vrs.count_mask"):
        return restore_tail(x, keys, count)


def sort_u32(keys: torch.Tensor, *, count=None,
             config: SortConfig | None = None):
    """Ascending sort of uint32 keys through the radix kernels. Returns a
    new tensor; `keys` is not modified. With `count` (an int or a 0-d
    tensor on the keys' device) only the first `count` keys are sorted
    and the rest come back in place."""
    config = config or default_config()
    check_u32(keys)
    n = keys.numel()
    cnt = count_tensor(count, keys.device)
    if n < MIN_RADIX_N:
        return (reference.sort_keys(keys) if cnt is None
                else reference.sort_keys_count(keys, cnt))
    x = _pad(keys, None, cnt, round_up(n, config.block))
    for p in range(config.num_passes):
        shift = p * config.digit_bits
        y, hist = k7.block_sort(x, shift=shift, config=config)
        del x  # its memory takes K8's output: the ping-pong
        g, offsets = k8.spine(hist)
        x = k8.stream_place(y, hist, g, config=config, shift=shift,
                            offsets=offsets)
    return _tail(x, keys, cnt)


def sort_pairs_u32(keys: torch.Tensor, values: torch.Tensor, *, count=None,
                   config: SortConfig | None = None):
    """Stable key-value sort; values ride as a separate uint32 buffer per
    pass (the reference's key-value layout, README.md:60). `count` as in
    `sort_u32`: the pairs at or past it come back in place."""
    config = config or default_config()
    check_u32(keys, values)
    n = keys.numel()
    cnt = count_tensor(count, keys.device)
    if n < MIN_RADIX_N:
        return (reference.sort_pairs(keys, values) if cnt is None
                else reference.sort_pairs_count(keys, values, cnt))
    x, v = _pad(keys, values, cnt, round_up(n, config.block))
    for p in range(config.num_passes):
        shift = p * config.digit_bits
        y, yv, hist = k7.block_sort(x, v, shift=shift, config=config,
                                    key_value=True)
        del x, v
        g, offsets = k8.spine(hist)
        x, v = k8.stream_place(y, hist, g, yv, config=config,
                               key_value=True, shift=shift, offsets=offsets)
    return _tail(x, keys, cnt), v[:n]


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
