"""K8, the radix placement, and the spine before it: wrappers over their
CUDA kernels and their plain versions.

Counterpart of `vulkan_radix_sort_tpu/ops/stream_place.py` (`stream_place`,
the Pallas kernel `_stream_place_body`) and of the JAX radix pass's
`_spine`: they scatter the block-sorted keys (and values) of one pass
stably into global digit order, the global half of the reference's
downsweep.

What changed from the TPU: the Pallas kernel walks the blocks in order on
one core and keeps per-digit append streams, accumulating each digit's
position as it goes, so it needs only the global exclusive digit offsets
`g_row`. Hopper blocks run in parallel and in no order, so every
(block p, digit d) run gets its own output offset from the spine: the
column-wise exclusive scan of the blocks' histograms plus `g_row`. `spine`
computes both in one kernel launch (`spine_kernel` in `csrc/radix.cu`), so
a radix pass on the card is three launches with no torch op between
them: K7, the spine, K8. K8 (`place_kernel`) takes each key's digit from
the key itself at the pass's `shift` and writes key i of block p to
`offsets[p, d] - (start of d's run in the block) + i`, into a new buffer:
never in place over its input.

`spine` and `stream_place` run the plain versions when their input lies
on the CPU, and otherwise launch their kernel or raise; an active
`utils.timing.LaunchTimer` records each launch. `spine_plain`
(`digit_offsets` and `block_offsets`) and `stream_place_plain` are the
plain versions on any device; the plain placement finds each element's
run from the histogram and needs no shift.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import timing
from ..config import SortConfig

def digit_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Global exclusive digit offsets (radix,) int32 from the (nblocks,
    radix) histograms: the second half of the reference spine
    (spine.slang:62-83)."""
    tot = hist.sum(0, dtype=torch.int32)
    return torch.cumsum(tot, 0, dtype=torch.int32) - tot


def block_offsets(hist: torch.Tensor, g_row: torch.Tensor) -> torch.Tensor:
    """(nblocks, radix) int32 output offset of every (block, digit) run:
    the exclusive scan of `hist` down the blocks (the first half of the
    reference spine, spine.slang:32-60) plus the global exclusive digit
    offsets `g_row` (radix,).

    The scan runs along the last dimension of the transposed table: on an
    H100, torch's scan down dim 0 of a (8192, 256) table takes 1.25 ms, and
    along the rows of its transpose 0.06 ms."""
    down = torch.cumsum(hist.t(), 1, dtype=torch.int32).t()
    return (down - hist + g_row).contiguous()


def spine_plain(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The spine's plain version, on any device: (g_row, offsets)."""
    _check_hist(hist)
    g_row = digit_offsets(hist)
    return g_row, block_offsets(hist, g_row)


def _check_hist(hist: torch.Tensor) -> None:
    if hist.dtype != torch.int32 or hist.dim() != 2 \
            or hist.shape[1] not in (16, 256) or not hist.is_contiguous():
        raise ValueError(f"expected a contiguous int32 (nblocks, 16 or 256) "
                         f"histogram, got {hist.dtype} {tuple(hist.shape)}")


def _spine_launch(hist: torch.Tensor):
    dev = hist.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    nblocks, radix = hist.shape
    g_row = torch.empty(radix, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(hist)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vrs_spine(hist.data_ptr(), g_row.data_ptr(),
                            offsets.data_ptr(), nblocks,
                            radix.bit_length() - 1, stream)
    _build.check(err, "vrs_spine")
    return g_row, offsets


def spine(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(g_row, offsets) of one pass from K7's (nblocks, radix) int32
    histograms: g_row (radix,) the global exclusive digit offsets, offsets
    (nblocks, radix) each (block, digit) run's output offset. One kernel
    launch on the card; the plain version on the CPU."""
    _check_hist(hist)
    if hist.device.type == "cpu":
        def run():
            return spine_plain(hist)
    else:
        def run():
            return _spine_launch(hist)
    return timing.launch(run, ["spine"], hist.device, nblocks=hist.shape[0],
                         radix=hist.shape[1])


def _check(y, hist, g_row, values, offsets, config: SortConfig,
           key_value: bool):
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
    table = (y.numel() // config.block, config.radix)
    shapes = ((hist, table), (g_row, (config.radix,)))
    if offsets is not None:
        shapes += ((offsets, table),)
    for t, shape in shapes:
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"expected a contiguous int32 {shape} tensor "
                             f"on {y.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _plain(y, hist, g_row, values, offsets, key_value: bool):
    n = y.numel()
    dev = y.device
    if offsets is None:
        offsets = block_offsets(hist, g_row)
    counts = hist.reshape(-1).to(torch.int64)
    run = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts, output_size=n)
    start = torch.cumsum(counts, 0) - counts  # each run's first index in y
    dst = offsets.reshape(-1).to(torch.int64)[run] \
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
    its run's offset plus its place in the run (the run found from the
    histogram)."""
    _check(y, hist, g_row, values, None, config, key_value)
    return _plain(y, hist, g_row, values, None, key_value)


def _launch(y, hist, offsets, values, shift: int, config: SortConfig,
            key_value: bool):
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
                config.block, shift, config.digit_bits, stream)
        _build.check(err, "vrs_place")
    return (out, outv) if key_value else out


def stream_place(y, hist, g_row, values=None, *, config: SortConfig,
                 key_value: bool = False, shift: int | None = None,
                 offsets=None):
    """Place block-sorted keys (and values) stably in global digit order.

    y (and values with key_value): flat uint32 output of `block_sort`;
    hist: its (nblocks, radix) int32 digit counts; g_row: (radix,) int32
    global exclusive digit offsets of hist (`spine` or `digit_offsets`);
    shift: the pass's digit shift, which the kernel needs (it takes each
    key's digit from the key) and the plain version ignores; offsets: the
    (nblocks, radix) run offsets from `spine`. Without them, the plain
    version computes them from hist and g_row, and on the card the spine
    kernel computes them from hist (one more launch, counted as "spine").
    Returns the placed keys, or (keys, values), in new buffers.
    """
    _check(y, hist, g_row, values, offsets, config, key_value)
    if y.device.type == "cpu":
        def run():
            return _plain(y, hist, g_row, values, offsets, key_value)
    else:
        if shift is None or not 0 <= shift < 32:
            raise ValueError(f"the placement kernel takes each key's digit "
                             f"at the pass's shift in [0, 32), got {shift}")
        if offsets is None:  # the spine kernel's, its own launch
            offsets = spine(hist)[1]

        def run():
            return _launch(y, hist, offsets, values, shift, config,
                           key_value)
    if not y.numel():
        return run()
    return timing.launch(run, ["place"], y.device, numel=y.numel(),
                         shift=shift, config=config, key_value=key_value)
