"""The yardstick: the plain reference, the byte counts, the generator."""

import numpy as np
import pytest

from benchmark import datagen, reference, roofline

N25 = 1 << 25


def test_reference_sorts_keys():
    keys = np.array([7, 0, 0xFFFFFFFF, 3, 7, 2**31], dtype=np.uint32)
    (got,) = reference.sort_keys(keys)
    assert got.tolist() == [0, 3, 7, 7, 2**31, 0xFFFFFFFF]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_reference_pairs_keep_equal_keys_in_input_order(dtype):
    keys = np.array([5, 1, 5, 0xFFFFFFFF, 1, 5, 0], dtype=dtype)
    values = np.array([10, 11, 12, 13, 14, 15, 16], dtype=np.uint32)
    k, v = reference.sort_pairs_stable(keys, values)
    assert k.tolist() == [0, 1, 1, 5, 5, 5, 0xFFFFFFFF]
    assert v.tolist() == [16, 11, 14, 10, 12, 15, 13]
    assert k.dtype == dtype


def test_reference_pairs_match_a_stable_argsort():
    keys = datagen.generate_keys(1 << 14, [9, 0, 0], "zipf")
    values = datagen.generate_values(1 << 14, [9, 0, 1])
    order = np.argsort(keys, kind="stable")
    k, v = reference.sort_pairs_stable(keys, values)
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(v, values[order])


def test_mismatched_counts_positions():
    a = np.arange(8, dtype=np.uint32)
    b = a.copy()
    b[[1, 6]] = 0
    assert reference.mismatched(a, a) == 0
    assert reference.mismatched(b, a) == 2
    assert reference.mismatched(a[:4], a) == 8
    assert reference.mismatched(a.astype(np.uint64), a) == 8


def test_byte_counts_at_2_25_by_hand():
    nblocks, radix = 2048, 256  # 16384-key blocks, 8-bit digits
    keys, kv = 4, 8  # bytes an item: a uint32 key, and its uint32 value
    assert roofline.block_sort_bytes(N25, nblocks, radix, keys) == \
        2 * N25 * 4 + 2048 * 256 * 4
    assert roofline.block_sort_bytes(N25, nblocks, radix, kv) == \
        4 * N25 * 4 + 2048 * 256 * 4
    assert roofline.place_bytes(N25, nblocks, radix, keys) == \
        2 * N25 * 4 + 2 * 2048 * 256 * 4
    assert roofline.place_bytes(N25, nblocks, radix, kv) == \
        4 * N25 * 4 + 2 * 2048 * 256 * 4
    assert roofline.pass_bytes(N25, keys) == 2 * N25 * 4
    assert roofline.pass_bytes(N25, kv) == 4 * N25 * 4
    assert roofline.pass_bytes(N25, 8 + 4) == 2 * N25 * 12  # uint64 keys
    # K7 keys at 2^25 moves 270 MB: 0.0807 ms at 3.35 TB/s
    assert roofline.hbm_share(roofline.block_sort_bytes(
        N25, nblocks, radix, keys), 0.0807e-3) == pytest.approx(100, 0.01)


def test_generator_is_seeded():
    a = datagen.generate_keys(1000, [2**40 + 3, 1, 0], "zipf")
    b = datagen.generate_keys(1000, [2**40 + 3, 1, 0], "zipf")
    c = datagen.generate_keys(1000, [2**40 + 3, 2, 0], "zipf")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.dtype == np.uint32
    top = np.unique(datagen.generate_keys(1 << 16, [1, 0, 0], "zipf"),
                    return_counts=True)[1].max()
    assert 0.15 < top / (1 << 16) < 0.21  # ~18% of keys are one value


@pytest.mark.parametrize("distribution", datagen.DISTRIBUTIONS)
def test_keys_follow_the_key_type(distribution):
    n = 1 << 12
    k32 = datagen.generate_keys(n, [5, 0, 0], distribution)
    k64 = datagen.generate_keys(n, [5, 0, 0], distribution, dtype=np.uint64)
    assert k32.dtype == np.uint32 and k64.dtype == np.uint64
    if distribution in ("uniform", "sorted", "reverse"):
        assert k64.max() >= 1 << 62  # all 64 bits are drawn
    low = datagen.generate_keys(n, [5, 0, 0], distribution, 16, np.uint64)
    assert low.max() < 1 << 16
    with pytest.raises(ValueError):
        datagen.generate_keys(n, [5, 0, 0], distribution, 33)
