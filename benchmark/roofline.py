"""Bytes a radix pass and its kernels must move, and the H100's peak.

Frozen here from `chip_smoke.bound_ms`'s byte counts, so that a change to
the program cannot move the yardstick. Each input byte is counted read
once and each output byte written once, whatever a kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (at the full 700 W).
HBM_BYTES_PER_S = 3.35e12
TABLE_WORD = 4  # bytes of a histogram or offset table entry (uint32)


def pass_bytes(n: int, item_bytes: int) -> int:
    """A radix pass over n items of `item_bytes` (a key, and its value):
    each read once and written once, whatever kernels the pass runs."""
    return 2 * n * item_bytes


def block_sort_bytes(numel: int, nblocks: int, radix: int,
                     item_bytes: int) -> int:
    """K7: keys (and values) in and out, the (nblocks, radix) histogram
    out."""
    return 2 * numel * item_bytes + nblocks * radix * TABLE_WORD


def place_bytes(numel: int, nblocks: int, radix: int,
                item_bytes: int) -> int:
    """K8: keys (and values) in and out, the histogram and the run offsets
    in."""
    return 2 * numel * item_bytes + 2 * nblocks * radix * TABLE_WORD


def hbm_share(nbytes: float, seconds: float) -> float:
    """Percent of the HBM peak that moving `nbytes` in `seconds` reaches."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
