"""The 3DGS tile-depth cell's yardstick and readers: the NumPy reference
and the control on small inputs, the byte counts by hand, and each new
metric reader on launch records made by hand."""

import numpy as np
import pytest
import torch

from benchmark import reference_u64, roofline, roofline_u64, run
from benchmark.tests.test_portbench_imports import BENCH, _imported

N = 1 << 25
CELL = "kv_u64_tile_depth.n25_b45_uniform"


@pytest.mark.parametrize("name", ["reference_u64.py", "control_u64.py",
                                  "roofline_u64.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert _imported(BENCH / name) <= {"__future__", "numpy", "torch"}


def _keys(n, seed):
    """Keys with bits above 45 set (the sort must ignore them and hand
    them back), few distinct masked keys (stability decides) and values
    that tell equal keys apart."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    k &= ~np.uint64((1 << 45) - 1) | np.uint64(0x1F0F000000FF)
    return k, np.arange(n, dtype=np.uint32)[::-1].copy()


def test_reference_is_a_stable_sort_of_the_masked_keys():
    keys, values = _keys(5000, 1)
    k, v = reference_u64.tile_depth_pairs(keys, values)
    order = np.argsort(keys & np.uint64((1 << 45) - 1), kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(v, values[order])
    assert (k >> np.uint64(45)).any()  # whole keys, not masked ones


def test_control_drops_the_top_digits_bits():
    keys, values = _keys(5000, 2)
    want = reference_u64.tile_depth_pairs(keys, values)
    from benchmark import control_u64
    got = control_u64.short_passes(
        torch.from_numpy(keys.view(np.int64)).view(torch.uint64),
        torch.from_numpy(values.view(np.int32)).view(torch.uint32),
        stable=True, end_bit=45)
    got = [run.to_host(t) for t in got]
    assert not np.array_equal(got[0], want[0])
    low40 = np.uint64((1 << 40) - 1)
    assert np.all(np.diff((got[0] & low40).astype(np.int64)) >= 0)


def test_byte_counts_at_2_25_by_hand():
    assert roofline_u64.sort_bytes(N, 12, 45) == 2 * N * 12 * 6
    assert roofline_u64.sort_bytes(N, 12, 64) == 2 * N * 12 * 8
    assert roofline_u64.split_pad_bytes(N, N, 8, False) == 8 * N + 8 * N
    # kv: the values in, a 12-byte (key, value) record out; 45 bits: the
    # high words out in 16 bits, and the high-word gather reads them
    assert roofline_u64.split_pad_bytes(N, N, 8, True) == 32 * N
    assert roofline_u64.split_pad_bytes(N, N, 8, True, 2) == 34 * N
    # 64 bits: the high words in 32 bits, for each padded slot
    assert roofline_u64.split_pad_bytes(N - 5, N, 8, False, 4) == (
        8 * (N - 5) + 12 * N)
    assert roofline_u64.gather_hi_bytes(N, 4) == 12 * N
    assert roofline_u64.gather_hi_bytes(N, 2) == 10 * N
    assert [roofline_u64.hi_bytes(8, b) for b in (32, 33, 45, 48, 49, 64)
            ] == [0, 2, 2, 2, 4, 4]
    assert roofline_u64.hi_bytes(4, 45) == 0
    assert roofline_u64.gather_out_bytes(N, 8, True) == 28 * N
    assert roofline_u64.gather_out_bytes(N, 4, False) == 12 * N
    assert roofline_u64.key_bytes({"key_dtype": "uint64"}) == 8


def _launch(name, start, end, shift=None, numel=N):
    return {"name": name, "start_s": start, "end_s": end, "numel": numel,
            "shift": shift, "nblocks": None, "radix": None}


def _sort(n=N):
    """split_pad, 4 low-word passes, gather hi, 2 high-word passes, gather
    out: the launch records of one end_bit=45 sort, 1e-4 s each."""
    launches = [_launch("split_pad", 0.0, 2e-4)]
    t = 2e-4

    def add(name, shift=None):
        nonlocal t
        launches.append(_launch(name, t, t + 1e-4, shift))
        t += 1e-4
    for p in range(4):
        for name in ("block_sort", "spine", "place"):
            add(name, None if name == "spine" else 8 * p)
    add("gather")
    for p in range(2):
        for name in ("block_sort", "spine", "place"):
            add(name, None if name == "spine" else 8 * p)
    launches.append(_launch("gather", t, t + 1e-3, numel=n))
    return {"n": n, "call_s": t + 2e-3, "launches": launches}


def _run(*sorts):
    spec = run.load_cell(CELL)
    return {"sorts": list(sorts), "item_bytes": 12,
            "config": spec["config"]}


def read(name, record):
    return run.read_metrics([{"name": name, "unit": "x"}], record).get(
        name, {}).get("value")


def test_passes_per_sort_counts_the_block_sorts():
    assert read("u64_passes_per_sort", _run(_sort(), _sort())) == 6


def test_sort_share_is_the_least_bytes_over_the_span():
    s = _sort()
    span = s["launches"][-1]["end_s"]
    assert read("u64_sort_hbm_share", _run(s)) == pytest.approx(
        100 * 2 * N * 12 * 6 / roofline.HBM_BYTES_PER_S / span)


def test_split_pad_share():
    assert read("split_pad_roofline", _run(_sort())) == pytest.approx(
        100 * 34 * N / roofline.HBM_BYTES_PER_S / 2e-4)


def test_gather_share_tells_hi_from_out_by_order():
    hi = 100 * 10 * N / roofline.HBM_BYTES_PER_S / 1e-4
    out = 100 * 28 * N / roofline.HBM_BYTES_PER_S / 1e-3
    assert read("gather_roofline", _run(_sort())) == pytest.approx(
        (hi + out) / 2)
    # an end_bit within the low word gathers once: its output
    s = _sort()
    s["launches"] = [x for x in s["launches"]
                     if not (x["name"] == "gather" and x["end_s"] -
                             x["start_s"] < 5e-4)]
    assert read("gather_roofline", _run(s)) == pytest.approx(out)


def test_a_program_without_the_path_reads_nothing():
    """The parent's radix path records no split_pad or gather: the
    readers of this cell leave their metric out rather than raise."""
    empty = {"n": N, "call_s": 1e-3, "launches": []}
    for name in ("u64_passes_per_sort", "u64_sort_hbm_share",
                 "split_pad_roofline", "gather_roofline"):
        assert read(name, _run(empty)) is None, name
        assert read(name, {"config": run.load_cell(CELL)["config"],
                           "item_bytes": 12}) is None, name
