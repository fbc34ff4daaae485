"""LSD radix sort: the host code over the block sort (K7), the spine and
the placement (K8).

Counterpart of `vulkan_radix_sort_tpu/ops/radix.py`, and of the
reference's gpuSort (h.in:344-507): passes over `digit_bits` digits,
least significant first, each three launches with no torch op between
them:

    block_sort (K7) -> spine -> stream_place (K8)

as the reference's upsweep -> spine -> downsweep. PyTorch runs the three on
one stream, in order, so no barrier is written out. One loop, `_passes`,
runs the passes of every sort. K8 writes each pass into a new buffer; the
loop drops the pass's input once K7 has read it and K7's output once K8
has, so the caching allocator hands K8 the input's memory and the next K7
the last K7's: two key (and value) buffers ping-pong, as in the reference
(h.in:400-502). A sort by the low `end_bit` bits (CUB's end_bit; every
bit by default) runs ceil(end_bit / digit_bits) passes, and the keys come
back whole.

The passes run over n rounded up to a block multiple, the slots past n
padded with the sentinel 0xFFFFFFFF (values with 0), the reference's own
trick (upsweep.slang:32): every pass is stable, and the pads sit after
every genuine key in input order, so they stay behind genuine 0xFFFFFFFF
keys and are sliced off at the end. The pad is never copied: the first
pass's K7 reads the caller's keys and values where they lie and loads the
slots past n as the pads (`block_sort`'s `size=`). Where the host sees that
no block needs it (no count, n a block multiple, 16-byte aligned inputs),
the first pass is any pass's K7 on the caller's buffers; either way the
sort counts `vrs.radix.first_pass.bulk` or `.masked` once. The JAX package
pads to 8 blocks for a TPU SMEM tile rule; the port needs no such rule.

With `count` (the reference's indirect sorts) the first pass also loads
the keys at or past the count as the sentinel, so the masked tail sorts
behind every genuine key in input order, like the pads. The values are
not masked: after the last pass the tail's slots [count, n) hold its
values in input order already, and one more kernel, `restore_tail`,
writes its keys back in place. The count is a 0-d int64 tensor that only
the kernels read, never the host.

64-bit keys, and 32-bit keys sorted by an
`end_bit` that is no multiple of the digit, take the (word, position)
path, `_sort_words`, on the same kv carries of K7 and K8, which never see
a whole key or a mask. `split_pad` writes the low words, masked to bits
[0, end_bit) and padded with the sentinel (past the count too, as the
first pass loads them), the positions 0..size-1, for key-value sorts each
whole key with its value in one record, and past 32 bits the high words,
masked to bits [32, end_bit) and all ones past the count and in the pads,
in 16 bits up to bit 48 (an array the L2 mostly holds), else in 32. The
kv carry sorts (low word, position) over the low word's digits; past 32
bits `gather` fetches each sorted position's high word and the kv carry
sorts (high word, position) over the rest; last, `gather` writes the
whole keys and the values at the sorted positions. A gather's cost is
its random loads, about a millisecond for 2^25 of them on an H100
whatever their width up to 16 bytes, less from an array the L2 holds: so
the records, which give a key and its value in one, and the 16-bit high
words. The passes are stable and the sentinels sort last in input order,
so equal keys keep their order, the pads end up past n and a `count=`
tail at its own positions: it comes back in place with no kernel of its
own.
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
from .bitops import (VECTOR_BYTES, check_u32, count_tensor, in_range,
                     low_bits, max_like_u32, merge_u64, pad_u32, select_u32,
                     split_u64, widen_u32)

# Below this size the reference backend sorts instead (`reference.sort`),
# as the JAX package hands n < _MIN_PALLAS_N to lax.sort (its
# radix.py:31,58-59).
MIN_RADIX_N = 1 << 14


def _dense(a: torch.Tensor) -> torch.Tensor:
    """A caller's 1-D uint32 or uint64 view as contiguous words (itself if
    it is)."""
    if a.is_contiguous():
        return a
    signed = torch.int64 if a.dtype == torch.uint64 else torch.int32
    return a.view(signed).contiguous().view(a.dtype)


def num_passes(end_bit: int, config: SortConfig) -> int:
    """Passes of a sort by bits [0, end_bit): one a digit."""
    return -(-end_bit // config.digit_bits)


def _end_bit(end_bit: int | None, width: int) -> int:
    """`end_bit` checked against the key width; the width for None."""
    if end_bit is None:
        return width
    if not 1 <= end_bit <= width:
        raise ValueError(f"end_bit {end_bit} outside 1..{width}")
    return end_bit


def _shifts(end_bit: int, config: SortConfig) -> range:
    return range(0, end_bit, config.digit_bits)


def _word_mask(bits: int) -> int:
    """The mask of a word's bits [0, bits), as the int32 with its bit
    pattern (the kernels' C interface takes it as an int)."""
    mask = (1 << min(bits, 32)) - 1
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def _empty_u32(size: int, device) -> torch.Tensor:
    return torch.empty(size, dtype=torch.int32, device=device).view(
        torch.uint32)


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


def _first_pass(keys, values, count, size: int) -> tuple[list, dict]:
    """The first pass's buffers, [keys] or [keys, values], the caller's
    own (dense), and the K7 arguments that load them: none where every
    block is bulk-loaded as in any pass (no count, n = size, 16-byte
    aligned buffers), else the padded size and the count, for the masked
    load (`block_sort`). Counts `vrs.radix.first_pass.bulk` or
    `.masked`."""
    bufs = [_dense(keys)] if values is None else [_dense(keys),
                                                  _dense(values)]
    bulk = count is None and keys.numel() == size and not any(
        a.data_ptr() % VECTOR_BYTES for a in bufs)
    timing.count("vrs.radix.first_pass." + ("bulk" if bulk else "masked"))
    return bufs, {} if bulk else {"size": size, "count": count}


def _tail(x, keys, count):
    """The sorted keys, x[:n], with the masked tail given back."""
    if count is None:
        return x[:keys.numel()]
    with timing.span("vrs.count_mask"):
        return restore_tail(x, keys, count)


def _records(keys, values, size: int) -> torch.Tensor:
    """(key, value) records of `size` slots, zeros past n, as flat uint32
    words: (low word, high word, value, 0) for uint64 keys, (key, value)
    for uint32 ones."""
    n = keys.numel()
    k = keys.view(torch.int64 if keys.dtype == torch.uint64
                  else torch.int32).contiguous()
    words = (k.view(torch.int32).view(n, -1) if keys.dtype == torch.uint64
             else k.view(n, 1))
    cols = words.shape[1] + 1 + (words.shape[1] == 2)
    rec = torch.zeros((size, cols), dtype=torch.int32, device=keys.device)
    rec[:n, :words.shape[1]] = words
    rec[:n, words.shape[1]] = values.view(torch.int32)
    return rec.view(-1).view(torch.uint32)


def hi_bytes(end_bit: int, wide: bool) -> int:
    """Bytes of each high word split_pad writes for the high-word gather:
    for 64-bit keys by an end bit past 32, 2 up to bit 48 (an array the L2
    mostly holds), else 4; 0 (no high words) otherwise."""
    if not wide or end_bit <= 32:
        return 0
    return 2 if end_bit <= 48 else 4


def split_pad_plain(keys, values, count, size: int, end_bit: int):
    """The plain version, on any device: the low words of uint64 keys (the
    words of uint32 keys) masked to bits [0, end_bit), those at or past
    `count` (if given) the sentinel, padded with it to `size`; the
    positions 0..size-1 as uint32; with values the records (`_records`),
    else None; for uint64 keys by an end bit past 32 their high words
    masked to bits [32, end_bit), all ones at or past the count and in the
    pads, as int16 up to bit 48 and uint32 above it, else None."""
    wide = keys.dtype == torch.uint64
    live = None if count is None else in_range(keys, count)

    def word(w, bits):
        w = low_bits(w, bits)
        if live is not None:
            w = select_u32(live, w, max_like_u32(w))
        return pad_u32(w, size, KEY_SENTINEL)
    hi_w, lo_w = split_u64(keys) if wide else (None, keys)
    pos = torch.arange(size, dtype=torch.int32, device=keys.device)
    rec = None if values is None else _records(keys, values, size)
    hi = None
    nbytes = hi_bytes(end_bit, wide)
    if nbytes:
        hi = word(hi_w, end_bit - 32)
        if nbytes == 2:
            hi = hi.view(torch.int32).to(torch.int16)
    return word(lo_w, end_bit), pos.view(torch.uint32), rec, hi


def _split_pad_launch(keys, values, count, size: int, end_bit: int):
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    wide, kv = keys.dtype == torch.uint64, values is not None
    nbytes = hi_bytes(end_bit, wide)
    keys = _dense(keys)
    values = _dense(values) if kv else None
    lo, pos = _empty_u32(size, dev), _empty_u32(size, dev)
    rec = _empty_u32(size * (4 if wide else 2), dev) if kv else None
    hi = (None if not nbytes else _empty_u32(size, dev) if nbytes == 4
          else torch.empty(size, dtype=torch.int16, device=dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vrs_split_pad(
            int(wide), None if count is None else count.data_ptr(),
            keys.numel(), size, keys.data_ptr(),
            values.data_ptr() if kv else None, _word_mask(end_bit),
            _word_mask(end_bit - 32) if nbytes else 0, nbytes,
            lo.data_ptr(), pos.data_ptr(), rec.data_ptr() if kv else None,
            None if hi is None else hi.data_ptr(), stream)
    _build.check(err, "vrs_split_pad")
    return lo, pos, rec, hi


def split_pad(keys, values, count, size: int, end_bit: int):
    """(low words, positions, records, high words), new buffers of `size`
    slots for the (word, position) path: the low words of uint64 keys (or
    uint32 keys) masked to bits [0, end_bit), the sentinel at or past
    `count` (a 0-d int64 tensor on the keys' device, clamped to [0, n], or
    None for n) and up to `size`; positions 0..size-1; with `values`, each
    whole key and its value in one record (16 bytes for uint64 keys, 8 for
    uint32), so that the output's gather reads both with one random load,
    else None; for uint64 keys by an end bit past 32, their high words
    masked to bits [32, end_bit) and all ones at or past the count, in
    `hi_bytes` bytes, for the high words' gather, else None. One kernel
    launch on the card; the plain version on the CPU."""
    body = (split_pad_plain if keys.device.type == "cpu"
            else _split_pad_launch)
    return timing.launch(lambda: body(keys, values, count, size, end_bit),
                         ["split_pad"], keys.device, numel=size,
                         n=keys.numel(), key_bytes=keys.element_size(),
                         key_value=values is not None,
                         hi_bytes=hi_bytes(end_bit,
                                           keys.dtype == torch.uint64))


def _record_words(rec, keys) -> torch.Tensor:
    """The records as (slots, words a record) int32."""
    return rec.view(torch.int32).view(-1, 4 if keys.dtype == torch.uint64
                                      else 2)


def gather_hi_plain(pos, hi) -> torch.Tensor:
    """The plain version, on any device: split_pad's high word at each
    position of `pos`, as uint32."""
    p = widen_u32(pos)
    if hi.dtype == torch.int16:
        return (hi[p].to(torch.int32) & 0xFFFF).view(torch.uint32)
    return hi.view(torch.int32)[p].view(torch.uint32)


def gather_out_plain(pos, keys, rec=None):
    """The plain version, on any device: for the first n positions, the
    keys there, and with records the keys and values from them."""
    n = keys.numel()
    p = widen_u32(pos[:n])
    wide = keys.dtype == torch.uint64
    if rec is None:
        return keys.view(torch.int64 if wide else torch.int32)[p].view(
            keys.dtype)
    r = _record_words(rec, keys)[p]
    k = merge_u64(r[:, 1], r[:, 0]) if wide else r[:, 0].view(torch.uint32)
    return k.contiguous(), r[:, -2 if wide else 1].contiguous().view(
        torch.uint32)


def _gather_launch(pos, src, src_bytes: int, out, out_v=None):
    """gather_kernel: out[j] (and out_v[j], from records) from `src`, of
    `src_bytes` an item, at pos[j] for j < out.numel()."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    m = out.numel()
    if pos.numel() < m:
        raise ValueError(f"{pos.numel()} positions for {m} outputs")
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vrs_gather(src_bytes, m, pos.data_ptr(), src.data_ptr(),
                             out.data_ptr(),
                             None if out_v is None else out_v.data_ptr(),
                             stream)
    _build.check(err, "vrs_gather")
    return out if out_v is None else (out, out_v)


def gather_hi(pos, hi) -> torch.Tensor:
    """The high-word passes' keys: for each sorted position of `pos` (the
    padded size), split_pad's high word there (`hi`, 16 or 32 bits), as
    uint32. One kernel launch on the card (`gather`, `what` "hi"); the
    plain version on the CPU."""
    if pos.device.type == "cpu":
        def run():
            return gather_hi_plain(pos, hi)
    else:
        def run():
            return _gather_launch(pos, hi, hi.element_size(),
                                  _empty_u32(pos.numel(), pos.device))
    return timing.launch(run, ["gather"], pos.device, numel=pos.numel(),
                         what="hi", hi_bytes=hi.element_size())


def gather_out(pos, keys, rec=None):
    """The sort's output, in new buffers: the whole keys (uint32 or
    uint64) at the first n sorted positions of `pos`, and with the
    records (key, value) from them. One kernel launch on the card
    (`gather`, `what` "out"); the plain version on the CPU."""
    if pos.device.type == "cpu":
        def run():
            return gather_out_plain(pos, keys, rec)
    else:
        def run():
            n, dev = keys.numel(), pos.device
            out = torch.empty(n, dtype=keys.dtype, device=dev)
            if rec is None:
                return _gather_launch(pos, _dense(keys), keys.element_size(),
                                      out)
            return _gather_launch(pos, rec, 2 * keys.element_size(), out,
                                  _empty_u32(n, dev))
    return timing.launch(run, ["gather"], pos.device, numel=keys.numel(),
                         what="out", key_value=rec is not None,
                         key_bytes=keys.element_size())


def _passes(bufs: list, shifts, config: SortConfig,
            first: dict | None = None) -> tuple:
    """One K7 -> spine -> K8 pass a shift over `bufs`, [keys] or [keys,
    values] (uint32, a block multiple long, or with `first` the first
    pass's K7 arguments, `_first_pass`), each counted as
    `vrs.radix.pass`. The loop owns the buffers: it takes them out of the
    list, which the caller keeps no other reference to, and drops each
    pass's input once K7 has read it and K7's output and the pass's
    tables once K8 has (the ping-pong: two buffers of each and one
    histogram and offset table live at a time; the allocator orders the
    frees by stream). Returns the last pass's output, (keys,) or (keys,
    values)."""
    kv = len(bufs) == 2
    for shift in shifts:
        timing.count("vrs.radix.pass")
        *ys, hist = k7.block_sort(*bufs, shift=shift, config=config,
                                  key_value=kv, **(first or {}))
        first = None
        bufs.clear()
        g, offsets = k8.spine(hist)
        out = k8.stream_place(ys[0], hist, g, ys[1] if kv else None,
                              config=config, key_value=kv, shift=shift,
                              offsets=offsets)
        del ys, hist, g, offsets
        bufs.extend(out if kv else (out,))
        del out
    out = tuple(bufs)
    bufs.clear()
    return out


def _sort_words(keys, values, count, end_bit: int, config: SortConfig):
    """The (word, position) path (module docstring): the sorted keys, and
    values if given, of n >= MIN_RADIX_N uint64 keys, or uint32 keys whose
    `end_bit` is no multiple of the digit, by bits [0, end_bit)."""
    size = round_up(keys.numel(), config.block)
    with timing.span("vrs.u64.split"):
        lo, pos, rec, hi = split_pad(keys, values, count, size, end_bit)
        bufs = [lo, pos]
        del lo, pos
    timing.count("vrs.radix.first_pass.bulk")  # split_pad's padded buffers
    with timing.span("vrs.u64.lo"):
        pos = _passes(bufs, _shifts(min(end_bit, 32), config), config)[1]
    if end_bit > 32:
        with timing.span("vrs.u64.gather"):
            bufs = [gather_hi(pos, hi), pos]
        del pos, hi
        with timing.span("vrs.u64.hi"):
            pos = _passes(bufs, _shifts(end_bit - 32, config), config)[1]
    with timing.span("vrs.u64.gather"):
        return gather_out(pos, keys, rec)


def _check(keys, values) -> None:
    """Refuse what the passes cannot sort: keys other than 1-D uint32 or
    uint64, values other than uint32 of the keys' shape and device."""
    if keys.dtype != torch.uint64:
        check_u32(*((keys,) if values is None else (keys, values)))
        return
    if keys.dim() != 1:
        raise TypeError("expected 1-D uint64 keys")
    if values is not None:
        check_u32(values)
        if values.shape != keys.shape or values.device != keys.device:
            raise ValueError("keys and values must share shape and device")


def sort(keys: torch.Tensor, values: torch.Tensor | None = None, *,
         count=None, end_bit: int | None = None, stable: bool = True,
         config: SortConfig | None = None):
    """Stable ascending sort of uint32 or uint64 keys (and uint32 values,
    which ride as a separate buffer a pass, the reference's key-value
    layout, README.md:60) through the radix kernels: the backend's one
    entry (`Sorter`'s contract; `stable` is unread, every pass is stable).
    Returns new tensors, keys or (keys, values); the inputs are not
    modified. With `count` (an int or a 0-d tensor on the keys' device)
    only the first `count` keys are sorted and the pairs at or past it
    come back in place. With `end_bit` (1 to the width) the keys are
    ordered by bits [0, end_bit) alone, stably, and come back whole.

    n < MIN_RADIX_N goes to `reference.sort`. uint64 keys, and uint32
    keys by an end bit that is no multiple of the digit, take the (word,
    position) path (`_sort_words`: min(4, ceil(end_bit / 8)) passes of the
    low words, then ceil((end_bit - 32) / 8) of the high words, at 8-bit
    digits); other uint32 keys ceil(end_bit / digit_bits) passes of their
    own, the first reading the caller's buffers (`_first_pass`)."""
    config = config or default_config()
    _check(keys, values)
    n = keys.numel()
    bits = _end_bit(end_bit, 8 * keys.element_size())
    cnt = count_tensor(count, keys.device)
    if n < MIN_RADIX_N:
        return reference.sort(keys, values, count=cnt, end_bit=end_bit)
    if keys.dtype == torch.uint64 or bits % config.digit_bits:
        return _sort_words(keys, values, cnt, bits, config)
    bufs, first = _first_pass(keys, values, cnt, round_up(n, config.block))
    out = _passes(bufs, _shifts(bits, config), config, first)
    x = _tail(out[0], keys, cnt)
    return x if values is None else (x, out[1][:n])


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
