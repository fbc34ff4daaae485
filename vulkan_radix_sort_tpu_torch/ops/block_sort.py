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
(`check_aligned`).

`block_sort` runs the plain version when the keys lie on the CPU, and
otherwise launches the kernel or raises; it counts each launch in
`launches`. `block_sort_plain` is the plain version on any device: the CPU
tests use it, and `chip_smoke.py` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import timing
from ..config import RADIX_THREADS, SortConfig
from .bitops import check_aligned, widen_u32

# Launches of the CUDA kernel since the last reset.
launches = {"block_sort": 0}

VECTOR_KEYS = 4  # fewest keys a K7 thread holds: 16 bytes


def reset_launches() -> None:
    launches["block_sort"] = 0


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


def _check(keys, values, shift: int, config: SortConfig, key_value: bool):
    arrs = (keys, values) if key_value else (keys,)
    for a in arrs:
        if a is None or a.dtype != torch.uint32 or a.dim() != 1 \
                or not a.is_contiguous():
            raise TypeError("keys (and values) must be contiguous 1-D "
                            "uint32 tensors")
        if a.device != keys.device or a.numel() != keys.numel():
            raise ValueError("keys and values must share device and length")
    if keys.numel() % config.block:
        raise ValueError(f"{keys.numel()} keys are not a multiple of the "
                         f"block ({config.block})")
    if not 0 <= shift < 32:
        raise ValueError(f"shift {shift} is outside [0, 32)")


def _plain(keys, values, shift: int, config: SortConfig, key_value: bool):
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
                     key_value: bool = False):
    """The plain version, on any device: one stable torch.sort over
    (block, digit)."""
    _check(keys, values, shift, config, key_value)
    return _plain(keys, values, shift, config, key_value)


def _launch(keys, values, shift: int, config: SortConfig, key_value: bool):
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    nblocks = keys.numel() // config.block
    y = torch.empty_like(keys)
    yv = torch.empty_like(values) if key_value else None
    hist = torch.empty((nblocks, config.radix), dtype=torch.int32,
                       device=dev)
    if nblocks:
        check_aligned((keys, values) if key_value else (keys,))
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vrs_block_sort(
                int(key_value), keys.data_ptr(),
                values.data_ptr() if key_value else None, y.data_ptr(),
                yv.data_ptr() if key_value else None, hist.data_ptr(),
                nblocks, config.block, shift, config.digit_bits, stream)
        _build.check(err, "vrs_block_sort")
        launches["block_sort"] += 1
    return (y, yv, hist) if key_value else (y, hist)


def block_sort(keys, values=None, *, shift: int, config: SortConfig,
               key_value: bool = False):
    """Sort each `config.block`-key block stably by the digit at `shift`.

    keys (and values with key_value): flat uint32, a multiple of the block
    long. Returns (sorted keys, hist) or (sorted keys, sorted values,
    hist), hist being (nblocks, radix) int32 digit counts per block.
    """
    _check(keys, values, shift, config, key_value)
    body = _plain if keys.device.type == "cpu" else _launch

    def run():
        return body(keys, values, shift, config, key_value)
    if not keys.numel():
        return run()
    return timing.launch(run, ["block_sort"], keys.device,
                         numel=keys.numel(), shift=shift, config=config,
                         key_value=key_value)
