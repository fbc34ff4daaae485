"""The metric readers' arithmetic, on records made by hand."""

import pytest

from benchmark import roofline, run

N = 1 << 25


def _launch(name, start, end, shift=None):
    return {"name": name, "start_s": start, "end_s": end, "numel": N,
            "shift": shift, "nblocks": 2048, "radix": 256}


def _sort():
    launches = []
    t = 0.0
    for p in range(4):
        launches += [_launch("block_sort", t, t + 1e-4, 8 * p),
                     _launch("spine", t + 1e-4, t + 1.2e-4),
                     _launch("place", t + 1.2e-4, t + 2.2e-4, 8 * p)]
        t += 2.5e-4
    return {"n": N, "call_s": 1.1e-3, "launches": launches}


def read(name, record):
    return run.read_metrics([{"name": name, "unit": "x"}], record).get(
        name, {}).get("value")


def test_kernel_shares():
    rec = {"sorts": [_sort(), _sort()], "item_bytes": 4}
    k7 = roofline.block_sort_bytes(N, 2048, 256, 4)
    assert read("k7_roofline", rec) == pytest.approx(
        100 * k7 / roofline.HBM_BYTES_PER_S / 1e-4)
    k8 = roofline.place_bytes(N, 2048, 256, 4)
    assert read("k8_roofline", rec) == pytest.approx(
        100 * k8 / roofline.HBM_BYTES_PER_S / 1e-4)
    # a pass: 2.2e-4 s from its K7's start to its K8's end
    assert read("pass_hbm_share", rec) == pytest.approx(
        100 * 2 * N * 4 / roofline.HBM_BYTES_PER_S / 2.2e-4)
    assert read("launches_per_sort", rec) == 12
    assert read("glue_ms", rec) == pytest.approx(1e3 * (1.1e-3 - 4 * 2.2e-4))
    rec_kv = {"sorts": [_sort()], "item_bytes": 8}
    assert read("pass_hbm_share", rec_kv) == pytest.approx(
        2 * read("pass_hbm_share", rec))


def test_nothing_to_read_is_left_out():
    rec = {"sorts": [{"n": N, "call_s": 1e-3, "launches": []}],
           "item_bytes": 4}
    for name in ("k7_roofline", "k8_roofline", "pass_hbm_share",
                 "launches_per_sort", "glue_ms", "device_idle_share",
                 "host_enqueue_ms", "sort_mem_mib", "gitems_s",
                 "sort_ms_p95"):
        assert read(name, rec) is None, name


def test_end_to_end_readers():
    rec = {"items": [N] * 100, "window_s": 0.125, "setup_s": 12.5,
           "sort_s": [1e-3] * 90 + [2e-3] * 10, "window_mem_bytes": 2**28,
           "enqueue_s": [1e-4, 3e-4],
           "device_busy": {"window_s": 2.0, "busy_s": 1.5}}
    assert read("gitems_s", rec) == pytest.approx(100 * N / 0.125 / 1e9)
    assert 1.0 < read("sort_ms_p95", rec) <= 2.0
    assert read("sort_mem_mib", rec) == 256
    assert read("setup_s", rec) == 12.5
    assert read("host_enqueue_ms", rec) == pytest.approx(0.2)
    assert read("device_idle_share", rec) == pytest.approx(25.0)


def test_host_activity_is_the_innermost_op():
    cpu = sorted([(0, 100, "bench.call"), (10, 20, "aten::arange"),
                  (30, 90, "aten::where"), (40, 50, "cudaLaunchKernel")])
    starts = [a for a, _, _ in cpu]
    assert run._host_activity(cpu, starts, 45) == "cudaLaunchKernel"
    assert run._host_activity(cpu, starts, 60) == "aten::where"
    assert run._host_activity(cpu, starts, 25) == "bench.call"
    assert run._host_activity(cpu, starts, 150).startswith("python")
    assert run._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
