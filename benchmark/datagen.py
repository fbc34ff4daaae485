"""Key and value generators of the benchmark's traffic.

A frozen copy of `vulkan_radix_sort_tpu_torch/utils/datagen.py` (NumPy
only), so that a change to the program cannot change the benchmark's
inputs. Two departures: `seed` is anything `np.random.default_rng` takes
(the harness passes `[seed, slot, stream]`), and keys come in the key
type of the configuration, uint32 or uint64 (for uint32 the same keys as
the original's from the same seed).

Analog of the reference's DataGenerator (bench/data_generator.cc: mt19937
uniform uint32 keys and values, an optional reduced key range through a
`bits` parameter), with the skewed distributions a sort must be robust to.
"""

from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("uniform", "zipf", "sorted", "reverse", "few", "constant")
ZIPF_EXPONENT = 1.2


def _below(rng, bits: int, size=None):
    """Uniform integers of `bits` bits (1 to 64) as uint64."""
    if bits == 64:
        return rng.integers(0, np.iinfo(np.uint64).max, size=size,
                            dtype=np.uint64, endpoint=True)
    return rng.integers(0, np.uint64(1) << np.uint64(bits), size=size,
                        dtype=np.uint64)


def generate_keys(
    n: int,
    seed=0,
    distribution: str = "uniform",
    bits: int | None = None,
    dtype=np.uint32,
) -> np.ndarray:
    """Generate n keys of `dtype` (uint32 or uint64) with the given
    distribution.

    bits: restrict keys to the low `bits` bits, by default all of them
    (reference: data_generator.cc:12-15).
    """
    width = 8 * np.dtype(dtype).itemsize
    bits = width if bits is None else bits
    if not 1 <= bits <= width:
        raise ValueError(f"bits {bits} outside 1..{width}")
    rng = np.random.default_rng(seed)
    if distribution == "uniform":
        keys = _below(rng, bits, n)
    elif distribution == "zipf":
        # Zipfian ranks mapped through a hash so hot keys are spread over
        # the key space but concentrated in count (degenerate digit
        # histograms).
        ranks = rng.zipf(ZIPF_EXPONENT, size=n).astype(np.uint64)
        keys = (ranks * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - width)
        if bits < 64:
            keys %= np.uint64(1) << np.uint64(bits)
    elif distribution == "sorted":
        keys = np.sort(_below(rng, bits, n))
    elif distribution == "reverse":
        keys = np.sort(_below(rng, bits, n))[::-1].copy()
    elif distribution == "few":
        # few distinct values -> most digit buckets empty
        vocab = _below(rng, bits, max(1, min(7, n)))
        keys = vocab[rng.integers(0, len(vocab), size=n)]
    elif distribution == "constant":
        keys = np.full(n, _below(rng, bits), dtype=np.uint64)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    return keys.astype(dtype)


def generate_values(n: int, seed=1) -> np.ndarray:
    """Uniform random uint32 payload values (reference:
    data_generator.cc:21-27)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.uint64(1) << np.uint64(32), size=n,
                        dtype=np.uint64).astype(np.uint32)
