"""The plain reference that decides `correct` for `kv_u64_tile_depth`:
NumPy only.

It imports nothing of the program, of the JAX package or of JAX, and is
given the benchmark's own host inputs. It holds the sort to what CUB's
`DeviceRadixSort::SortPairs(..., begin_bit=0, end_bit=45)` returns in 3D
Gaussian Splatting's rasterizer: pairs in ascending order of the keys'
bits [0, 45), stably, the keys whole. Its method is not the program's:
one stable `np.lexsort` over the low word and the masked high word.
"""

from __future__ import annotations

import numpy as np

END_BIT = 45  # 32 depth bits and getHigherMsb(8,160 tiles) = 13 tile bits


def _bits(keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Bits [lo, hi) of the keys, hi - lo <= 16, as uint16."""
    return ((keys >> np.uint64(lo))
            & np.uint64((1 << (hi - lo)) - 1)).astype(np.uint16)


def tile_depth_pairs(keys: np.ndarray,
                     values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys and uint32 values in stable ascending order of the
    keys' bits [0, END_BIT): lexsort's last key, the high word masked to
    bits [32, END_BIT), decides first, then the low word, and equal masked
    keys keep their input order. The low word goes in as its two 16-bit
    halves, which numpy's stable sort orders by radix (a 32-bit word would
    take its merge sort, four times as long at 2^25)."""
    order = np.lexsort((_bits(keys, 0, 16), _bits(keys, 16, 32),
                        _bits(keys, 32, END_BIT)))
    return keys[order], values[order]
