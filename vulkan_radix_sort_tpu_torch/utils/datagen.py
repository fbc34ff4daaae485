"""Key/value data generators for tests and benchmarks.

Analog of the reference's DataGenerator (bench/data_generator.cc: mt19937
uniform uint32 keys/values, optional reduced key range via a `bits` param).
We add the skewed distributions the TPU build must be robust to (BASELINE
configs: Zipfian, few-distinct-digits, pre-sorted) — degenerate histograms
are the hard case for both block-level ranks and distributed bucket balance.

All streams are NumPy-seeded and deterministic. This is the port's own
copy of `vulkan_radix_sort_tpu/utils/datagen.py` (NumPy only), so the port
never imports the JAX package; the same seed gives the same data in both.
The correctness contract only compares two sorts of the *same* data,
exactly like the reference bench does (bench/bench.cc:41-64), so generator
identity is not load-bearing.
"""

from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("uniform", "zipf", "sorted", "reverse", "few", "constant")


def generate_keys(
    n: int,
    seed: int = 0,
    distribution: str = "uniform",
    bits: int = 32,
) -> np.ndarray:
    """Generate n uint32 keys with the given distribution.

    bits: restrict keys to the low `bits` bits (reference: data_generator.cc:12-15).
    """
    rng = np.random.default_rng(seed)
    hi = np.uint64(1) << np.uint64(bits)
    if distribution == "uniform":
        keys = rng.integers(0, hi, size=n, dtype=np.uint64)
    elif distribution == "zipf":
        # Zipfian ranks mapped through a hash so hot keys are spread over the
        # key space but concentrated in count (degenerate digit histograms).
        ranks = rng.zipf(1.2, size=n).astype(np.uint64)
        keys = (ranks * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(32)
        keys %= hi
    elif distribution == "sorted":
        keys = np.sort(rng.integers(0, hi, size=n, dtype=np.uint64))
    elif distribution == "reverse":
        keys = np.sort(rng.integers(0, hi, size=n, dtype=np.uint64))[::-1].copy()
    elif distribution == "few":
        # few distinct values -> most digit buckets empty
        vocab = rng.integers(0, hi, size=max(1, min(7, n)), dtype=np.uint64)
        keys = vocab[rng.integers(0, len(vocab), size=n)]
    elif distribution == "constant":
        keys = np.full(n, rng.integers(0, hi), dtype=np.uint64)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    return keys.astype(np.uint32)


def generate_values(n: int, seed: int = 1) -> np.ndarray:
    """Uniform random uint32 payload values (reference: data_generator.cc:21-27)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.uint64(1) << np.uint64(32), size=n, dtype=np.uint64).astype(
        np.uint32
    )
