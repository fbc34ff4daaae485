"""The plain reference that decides `correct`: NumPy only.

It imports nothing of the program, of the JAX package or of JAX, and is
given the benchmark's own host inputs, never what the program made. A
configuration names its reference function by `module:function`.
"""

from __future__ import annotations

import numpy as np


def sort_keys(keys: np.ndarray) -> tuple[np.ndarray]:
    """Ascending sort of keys (the analog of `std::sort`)."""
    return (np.sort(keys),)


def sort_pairs_stable(keys: np.ndarray,
                      values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stable key-value sort (the analog of `std::stable_sort` on pairs):
    equal keys keep their values in input order.

    For uint32 keys one sort of `key << 32 | position`, whose entries are
    all distinct, gives the stable order several times faster than a
    stable argsort; other keys take `np.argsort(kind="stable")`."""
    n = keys.size
    if keys.dtype == np.uint32 and n <= 1 << 32:
        composite = keys.astype(np.uint64) << np.uint64(32)
        composite |= np.arange(n, dtype=np.uint64)
        composite.sort()
        order = (composite & np.uint64(0xFFFFFFFF)).astype(np.int64)
        return (composite >> np.uint64(32)).astype(np.uint32), values[order]
    order = np.argsort(keys, kind="stable")
    return keys[order], values[order]


def mismatched(got: np.ndarray, want: np.ndarray) -> int:
    """Positions at which `got` differs from `want`; every position of the
    longer one if their lengths or dtypes differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.size, want.size)
    return int(np.count_nonzero(got != want))
