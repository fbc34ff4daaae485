"""K7, the radix block sort: its CUDA kernel's wrapper and its plain version.

Counterpart of `vulkan_radix_sort_tpu/ops/block_sort.py` (`block_sort`,
the Pallas kernel `_block_sort_body`). For each `config.block`-key block
it computes a **stable** local sort of the keys (and of the values, moved
alike) by the digit `(key >> shift) & (radix - 1)`, and the block's
`radix`-bin digit histogram: the reference's upsweep plus the local half
of its downsweep.

Layout differs from the JAX package's only where the TPU forced it: keys
and values are flat uint32 tensors, not (rows, 128) tiles, and the
histogram is `(nblocks, radix)` int32, not `(nblocks, 128)` lane-padded
rows. The kernel (`block_sort_kernel` in `csrc/radix.cu`) says what bounds
it on an H100 and how it keeps the ranks stable: thread blocks that stay
resident (`sort_grid`) walk the blocks, and the bulk copy engine loads
the next blocks' keys into spare buffers (`sort_stages`, `sort_smem`)
and stores each sorted block, so its buffers must be 16-byte aligned
(`check_aligned`). A sort's first pass (`size=`) is the exception: it
reads the caller's keys and values where they lie, of any length up to
the pass's padded size and any alignment, and loads the keys at or past
the count and the slots past n as the sentinel (upstream's upsweep does
the same, upsweep.slang:32), so no padded copy is made; its plain version
pads first (`mask_pad_plain`).

`block_sort` runs the plain version when the keys lie on the CPU, and
otherwise launches the kernel or raises; an active
`utils.timing.LaunchTimer` records each launch. `block_sort_plain` is the
plain version on any device: the CPU tests use it, and `chip_smoke.py`
holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import timing
from ..config import KEY_SENTINEL, RADIX_THREADS, SortConfig
from .bitops import (check_aligned, in_range, max_like_u32, pad_u32,
                     select_u32, widen_u32)

VECTOR_KEYS = 4  # fewest keys a K7 thread holds: 16 bytes


def sort_geometry(block: int) -> tuple[int, int]:
    """(threads, keys per thread) of a K7 block: one thread per 4 keys up
    to RADIX_THREADS threads (sort_threads in csrc/radix.cu)."""
    threads = min(block // VECTOR_KEYS, RADIX_THREADS)
    return threads, block // threads


def sort_stages(key_value: bool) -> int:
    """Key buffers of a K7 block (sort_stages in csrc/radix.cu): the block
    it sorts and the next two, or the next one for key-value, whose values
    take the third buffer's room."""
    return 2 if key_value else 3


def sort_smem(block: int, bits: int, key_value: bool) -> int:
    """Bytes of shared memory of a K7 block (sort_smem in csrc/radix.cu):
    the key buffers, a value buffer, the (digit, warp) count table with an
    odd row stride, 32 ints of scan scratch, a match word per digit and
    warp, and 8 words for the key buffers' load barriers."""
    warps = sort_geometry(block)[0] // 32
    return 4 * (block * (sort_stages(key_value) + key_value)
                + (1 << bits) * (2 * warps + 1) + 32 + 8)


def sort_grid(nblocks: int, sms: int, resident: int) -> int:
    """Thread blocks of a K7 launch (sort_grid in csrc/radix.cu): as many
    as the card holds at once, `sms` multiprocessors with `resident` blocks
    each, and no more than there are blocks; each walks blocks
    blockIdx.x, blockIdx.x + grid, ..."""
    return min(nblocks, sms * max(resident, 1))


def _check(keys, values, shift: int, config: SortConfig, key_value: bool,
           size: int | None, count) -> int:
    """Raise on inputs the pass does not take; return its slots (`size`
    for a first pass, else the keys')."""
    arrs = (keys, values) if key_value else (keys,)
    for a in arrs:
        if a is None or a.dtype != torch.uint32 or a.dim() != 1 \
                or not a.is_contiguous():
            raise TypeError("keys (and values) must be contiguous 1-D "
                            "uint32 tensors")
        if a.device != keys.device or a.numel() != keys.numel():
            raise ValueError("keys and values must share device and length")
    slots = keys.numel() if size is None else size
    if slots % config.block or slots < keys.numel():
        raise ValueError(f"{slots} slots for {keys.numel()} keys are not a "
                         f"multiple of the block ({config.block})")
    if count is not None and (size is None or count.dtype != torch.int64
                              or count.dim() or count.device != keys.device):
        raise ValueError("a count is a first pass's 0-d int64 tensor on "
                         "the keys' device")
    if not 0 <= shift < 32:
        raise ValueError(f"shift {shift} is outside [0, 32)")
    return slots


def mask_pad_plain(keys, values, count, size: int):
    """The buffers a first pass sorts, made by torch ops on any device:
    keys selected where `arange(n) < count` (every key for a count of
    None), the sentinel elsewhere, and both padded by `pad_u32` to `size`,
    the values with 0. Returns keys, or (keys, values)."""
    if count is not None:
        keys = select_u32(in_range(keys, count), keys, max_like_u32(keys))
    x = pad_u32(keys, size, KEY_SENTINEL)
    return x if values is None else (x, pad_u32(values, size, 0))


def _plain(keys, values, shift: int, config: SortConfig, key_value: bool,
           size, count):
    if size is not None:  # a first pass: the buffers it loads
        padded = mask_pad_plain(keys, values if key_value else None, count,
                                size)
        keys, values = padded if key_value else (padded, None)
    n, radix = keys.numel(), config.radix
    digit = (widen_u32(keys) >> shift) & (radix - 1)
    bucket = torch.arange(n, device=keys.device) // config.block * radix \
        + digit
    order = torch.sort(bucket, stable=True).indices
    hist = torch.bincount(bucket, minlength=n // config.block * radix)
    hist = hist.to(torch.int32).view(-1, radix)
    y = keys.view(torch.int32)[order].view(torch.uint32)
    if not key_value:
        return y, hist
    return y, values.view(torch.int32)[order].view(torch.uint32), hist


def block_sort_plain(keys, values=None, *, shift: int, config: SortConfig,
                     key_value: bool = False, size: int | None = None,
                     count=None):
    """The plain version, on any device: one stable torch.sort over
    (block, digit); a first pass (`size`) sorts `mask_pad_plain`'s
    buffers."""
    _check(keys, values, shift, config, key_value, size, count)
    return _plain(keys, values, shift, config, key_value, size, count)


def _launch(keys, values, shift: int, config: SortConfig, key_value: bool,
            size, count):
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    slots = keys.numel() if size is None else size
    nblocks = slots // config.block
    y = torch.empty(slots, dtype=torch.int32, device=dev).view(torch.uint32)
    yv = torch.empty_like(y) if key_value else None
    hist = torch.empty((nblocks, config.radix), dtype=torch.int32,
                       device=dev)
    if nblocks:
        lib = _build.library()
        vals = values.data_ptr() if key_value else None
        outs = (y.data_ptr(), yv.data_ptr() if key_value else None,
                hist.data_ptr(), nblocks, config.block, shift,
                config.digit_bits)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if size is None:
                check_aligned((keys, values) if key_value else (keys,))
                err = lib.vrs_block_sort(int(key_value), keys.data_ptr(),
                                         vals, *outs, stream)
            else:
                err = lib.vrs_block_sort_first(
                    int(key_value), None if count is None
                    else count.data_ptr(), keys.numel(), keys.data_ptr(),
                    vals, *outs, stream)
        _build.check(err, "vrs_block_sort")
    return (y, yv, hist) if key_value else (y, hist)


def block_sort(keys, values=None, *, shift: int, config: SortConfig,
               key_value: bool = False, size: int | None = None,
               count=None):
    """Sort each `config.block`-key block stably by the digit at `shift`.

    keys (and values with key_value): flat uint32, a multiple of the block
    long. Returns (sorted keys, hist) or (sorted keys, sorted values,
    hist), hist being (nblocks, radix) int32 digit counts per block.

    With `size`, a sort's first pass: keys (and values) are the caller's
    n <= size words, at any alignment, read where they lie, and the pass
    sorts the `size` slots that `mask_pad_plain` would make of them (keys
    at or past `count`, a 0-d int64 tensor on the keys' device clamped to
    [0, n] and read on the card only, or past n without one, as the
    sentinel; values past n as 0), with no copy. Its launch record adds
    `first="masked"` and n.
    """
    slots = _check(keys, values, shift, config, key_value, size, count)
    body = _plain if keys.device.type == "cpu" else _launch

    def run():
        return body(keys, values, shift, config, key_value, size, count)
    if not slots:
        return run()
    first = {} if size is None else {"first": "masked", "n": keys.numel()}
    return timing.launch(run, ["block_sort"], keys.device, numel=slots,
                         shift=shift, config=config, key_value=key_value,
                         **first)
