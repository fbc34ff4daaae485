"""K8, the radix placement: a wrapper over its CUDA kernel and a plain version.

Counterpart of `vulkan_radix_sort_tpu/ops/stream_place.py` (`stream_place`,
the Pallas kernel `_stream_place_body`): it scatters the block-sorted keys
(and values) of one pass stably into global digit order, the global half
of the reference's downsweep.

What changed from the TPU: the Pallas kernel walks the blocks in order on
one core and keeps per-digit append streams, so it needs only the global
exclusive digit offsets `g_row`. Hopper blocks run in parallel and in no
order, so every (block p, digit b) run gets its own output offset: the
reference spine's column-wise exclusive scan over the blocks' histograms
plus `g_row` (`block_offsets`, in torch). The kernel (`place_kernel` in
`csrc/radix.cu`) then writes element i of run (p, b) to
`offsets[p, b] + (i - start of the run)`, into a new buffer: never in
place over its input.

`stream_place` runs the plain version when `y` lies on the CPU, and
otherwise launches the kernel or raises; it counts each launch in
`launches`. `stream_place_plain` is the plain version on any device.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import timing
from ..config import SortConfig

# Launches of the CUDA kernel since the last reset.
launches = {"place": 0}


def reset_launches() -> None:
    launches["place"] = 0


def block_offsets(hist: torch.Tensor, g_row: torch.Tensor) -> torch.Tensor:
    """(nblocks, radix) int32 output offset of every (block, digit) run:
    the exclusive scan of `hist` down the blocks plus the global exclusive
    digit offsets `g_row` (radix,).

    The scan runs along the last dimension of the transposed table: on an
    H100, torch's scan down dim 0 of a (8192, 256) table takes 1.25 ms, and
    along the rows of its transpose 0.06 ms."""
    down = torch.cumsum(hist.t(), 1, dtype=torch.int32).t()
    return (down - hist + g_row).contiguous()


def _check(y, hist, g_row, values, config: SortConfig, key_value: bool):
    arrs = (y, values) if key_value else (y,)
    for a in arrs:
        if a is None or a.dtype != torch.uint32 or a.dim() != 1 \
                or not a.is_contiguous():
            raise TypeError("y (and values) must be contiguous 1-D uint32 "
                            "tensors")
        if a.device != y.device or a.numel() != y.numel():
            raise ValueError("y and values must share device and length")
    if y.numel() % config.block:
        raise ValueError(f"{y.numel()} keys are not a multiple of the block "
                         f"({config.block})")
    shapes = ((hist, (y.numel() // config.block, config.radix)),
              (g_row, (config.radix,)))
    for t, shape in shapes:
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"expected a contiguous int32 {shape} tensor "
                             f"on {y.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _plain(y, hist, g_row, values, key_value: bool):
    n = y.numel()
    dev = y.device
    counts = hist.reshape(-1).to(torch.int64)
    run = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts, output_size=n)
    start = torch.cumsum(counts, 0) - counts  # each run's first index in y
    dst = block_offsets(hist, g_row).reshape(-1).to(torch.int64)[run] \
        + torch.arange(n, device=dev) - start[run]
    outs = []
    for a in (y, values) if key_value else (y,):
        out = torch.empty_like(a)
        out.view(torch.int32)[dst] = a.view(torch.int32)
        outs.append(out)
    return tuple(outs) if key_value else outs[0]


def stream_place_plain(y, hist, g_row, values=None, *, config: SortConfig,
                       key_value: bool = False):
    """The plain version, on any device: one index_put of every element at
    its run's offset plus its place in the run."""
    _check(y, hist, g_row, values, config, key_value)
    return _plain(y, hist, g_row, values, key_value)


def _launch(y, hist, offsets, values, config: SortConfig, key_value: bool):
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    nblocks = y.numel() // config.block
    out = torch.empty_like(y)
    outv = torch.empty_like(values) if key_value else None
    if nblocks:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vrs_place(
                int(key_value), y.data_ptr(),
                values.data_ptr() if key_value else None, hist.data_ptr(),
                offsets.data_ptr(), out.data_ptr(),
                outv.data_ptr() if key_value else None, nblocks,
                config.block, config.digit_bits, stream)
        _build.check(err, "vrs_place")
        launches["place"] += 1
    return (out, outv) if key_value else out


def stream_place(y, hist, g_row, values=None, *, config: SortConfig,
                 key_value: bool = False):
    """Place block-sorted keys (and values) stably in global digit order.

    y (and values with key_value): flat uint32 output of `block_sort`;
    hist: its (nblocks, radix) int32 digit counts; g_row: (radix,) int32
    global exclusive digit offsets (`radix._spine`). Returns the placed
    keys, or (keys, values), in new buffers.
    """
    _check(y, hist, g_row, values, config, key_value)
    if y.device.type == "cpu":
        def run():
            return _plain(y, hist, g_row, values, key_value)
    else:
        offsets = block_offsets(hist, g_row)  # outside the launch's record

        def run():
            return _launch(y, hist, offsets, values, config, key_value)
    if not y.numel():
        return run()
    return timing.launch(run, ["place"], y.device, numel=y.numel(),
                         config=config, key_value=key_value)
