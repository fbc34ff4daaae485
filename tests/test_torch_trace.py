"""The recorder's spans and counts inside the port, on the CPU: the entry
points' root spans, the `count=` tail's span, the counter of the backend
that served each call and of a radix sort's first pass, the kernel
build's record, the null path when nothing listens, and the spans' host
ranges on the torch profiler's timeline."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch import _build
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.utils import timing

N = radix.MIN_RADIX_N
RADIX = SortConfig(backend="radix")
RADIX_PASS = ("block_sort", "spine", "place")
COUNT_KERNELS = ("restore_tail",)


def _u32(n: int, seed: int, dtype=np.uint32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**64, n, dtype=np.uint64)
                            .astype(dtype))


def _sorter(n=N, config=RADIX, **kw):
    return vrs.Sorter(n, config=config, device="cpu", **kw)


def _kv_count_call(s, n=N):
    k, v = _u32(n, 1), _u32(n, 2)
    with timing.LaunchTimer() as timer:
        gk, gv = s.sort_key_value(k, v, count=torch.tensor(n - 5))
    order = np.argsort(k[:n - 5].numpy(), kind="stable")
    np.testing.assert_array_equal(gk[:n - 5].numpy(), k[:n - 5][order])
    np.testing.assert_array_equal(gv[:n - 5].numpy(), v[:n - 5][order])
    return timer


@pytest.mark.parametrize("kind", ["keys", "kv_count"])
def test_one_root_span_a_call_shared_below(kind):
    s = _sorter()
    if kind == "keys":
        with timing.LaunchTimer() as timer:
            s.sort(_u32(N, 3))
    else:
        timer = _kv_count_call(s)
    roots = [x for x in timer.spans if x["parent"] is None]
    assert len(roots) == 1
    root = roots[0]
    assert root["name"] == ("vrs.sort" if kind == "keys"
                            else "vrs.sort_key_value")
    assert root["id"] == root["root"]
    assert (root["n"], root["backend"], root["count"]) == (
        N, "radix", kind != "keys")
    assert all(x["root"] == root["id"] for x in timer.spans)
    assert all(x["parent"] == root["id"] for x in timer.spans[1:])
    assert timer.records
    # the passes' launches lie below the root alone (the first K7 masks
    # and pads as it loads); a count= call's tail kernel inside its
    # count_mask span
    spans = {x["id"]: x for x in timer.spans}
    assert all(r["root"] == root["id"] for r in timer.records)
    assert all(r["span"] == root["id"] if r["names"][0] not in COUNT_KERNELS
               else spans[r["span"]]["name"] == "vrs.count_mask"
               for r in timer.records)
    for x in timer.spans:
        assert root["start_ns"] <= x["start_ns"] <= x["end_ns"] \
            <= root["end_ns"]
    assert not timing._OPEN


def test_count_call_spans_the_masks_twice_and_the_pad_once():
    """A radix count= call: the mask and the pad are the first K7's load,
    below the root, and the tail's kernel is in the one count_mask span,
    after every pass's launch on the host's clock."""
    timer = _kv_count_call(_sorter())
    names = [x["name"] for x in timer.spans]
    assert names == ["vrs.sort_key_value", "vrs.count_mask"]
    root, tail = (x["id"] for x in timer.spans)
    assert [(r["names"][0], r["span"]) for r in timer.records] == (
        [(k, root) for k in RADIX_PASS] * RADIX.num_passes
        + [("restore_tail", tail)])
    assert timer.records[0]["first"] == "masked"
    assert timer.counts["vrs.radix.first_pass.masked"] == 1


@pytest.mark.parametrize("wide", [False, True])
def test_count_masks_span_the_64_bit_and_network_paths(wide):
    dtype = torch.uint64 if wide else torch.uint32
    n = 1 << 10
    s = _sorter(n, SortConfig(backend="network"), key_dtype=dtype)
    keys = _u32(n, 4, np.uint64 if wide else np.uint32)
    with timing.LaunchTimer() as timer:
        s.sort(keys, count=n - 3)
    assert [x["name"] for x in timer.spans] == [
        "vrs.sort", "vrs.count_mask", "vrs.count_mask"]
    assert timer.counts == {"vrs.backend.network": 1}


def test_spans_leave_the_launch_records_alone():
    s = _sorter()
    keys = _u32(N, 5)
    with timing.LaunchTimer() as timer:
        s.sort(keys)
    assert len(timer.records) == 3 * RADIX.num_passes
    assert [r["names"][0] for r in timer.records[:3]] == [
        "block_sort", "spine", "place"]
    assert [x["name"] for x in timer.spans] == ["vrs.sort"]
    with timing.LaunchTimer() as plain:
        radix.sort(keys, config=RADIX)
    assert [{k: v for k, v in r.items() if k in ("names", "numel", "shift")}
            for r in plain.records] == [
        {k: v for k, v in r.items() if k in ("names", "numel", "shift")}
        for r in timer.records]


CALLS = {
    "keys": lambda s, k, v: s.sort(k),
    "keys_count": lambda s, k, v: s.sort(k, count=k.numel() - 1),
    "kv": lambda s, k, v: s.sort_key_value(k, v),
    "kv_count": lambda s, k, v: s.sort_key_value(k, v, count=3),
    "kvns": lambda s, k, v: s.sort_key_value(k, v, stable=False),
}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("backend,n,served", [
    ("radix", N, "radix"), ("radix", N - 1, "reference"),
    ("auto", N, "reference"), ("reference", 64, "reference"),
    ("network", 1 << 10, "network")])
def test_one_backend_count_a_call(call, backend, n, served):
    s = _sorter(max(n, 1 << 10), SortConfig(backend=backend))
    k, v = _u32(n, 6), _u32(n, 7)
    with timing.LaunchTimer() as timer:
        CALLS[call](s, k, v)
        CALLS[call](s, k, v)
    # and each radix call counts its four passes and its first pass's
    # load: bulk where the host sees no block to mask
    passes = {}
    if served == "radix":
        first = "bulk" if call in ("keys", "kv", "kvns") else "masked"
        passes = {"vrs.radix.pass": 8, f"vrs.radix.first_pass.{first}": 2}
    assert timer.counts == {f"vrs.backend.{served}": 2, **passes}
    assert (len(timer.records) > 0) == (served != "reference")
    # a radix count= call launches the tail's kernel once
    masked = served == "radix" and call.endswith("_count")
    names = [r["names"][0] for r in timer.records]
    assert [names.count(k) for k in COUNT_KERNELS] == [2 * masked]


def test_the_adaptive_fast_path_counts_itself():
    s = _sorter(config=SortConfig(backend="radix", adaptive=True))
    k = torch.arange(N, dtype=torch.int32).view(torch.uint32)
    with timing.LaunchTimer() as timer:
        s.sort(k)
        s.sort_key_value(k, k)
        s.sort(_u32(N, 8))
    assert timer.counts == {"vrs.backend.adaptive": 2,
                            "vrs.backend.radix": 1, "vrs.radix.pass": 4,
                            "vrs.radix.first_pass.bulk": 1}


def test_nothing_listening_is_the_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered")
    monkeypatch.setattr(timing, "_RANGE", refuse)
    assert not timing._ACTIVE
    assert timing.span("vrs.sort", n=1) is timing._NULL
    assert timing.span("vrs.pad") is timing._NULL
    with timing.span("vrs.pad") as entry:
        assert entry is None
    timing.count("vrs.backend.radix")
    s = _sorter()
    k, v = _u32(N, 9), _u32(N, 10)
    s.sort(k)
    s.sort_key_value(k, v, count=torch.tensor(N - 1))


def test_spans_nest_and_counts_add():
    with timing.LaunchTimer() as outer:
        timing.count("a")
        with timing.LaunchTimer() as inner:
            with timing.span("x", k=1) as x:
                with pytest.raises(ValueError):
                    with timing.span("y"):
                        raise ValueError
                timing.count("a", 2)
        timing.count("b")
    assert outer.counts == {"a": 3, "b": 1} and inner.counts == {"a": 2}
    assert outer.spans == inner.spans
    y = inner.spans[1]
    assert (x["k"], x["parent"], y["parent"], y["root"]) == (
        1, None, x["id"], x["id"])
    assert y["end_ns"] is not None and not timing._OPEN


def test_spans_are_host_ranges_on_the_profiler_timeline():
    s = _sorter()
    k, v = _u32(N, 11), _u32(N, 12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.sort_key_value(k, v, count=torch.tensor(N - 1))
        s.sort(k)  # no count: no span below the root
    names = {e.name for e in prof.events()}
    assert {"vrs.sort_key_value", "vrs.count_mask", "vrs.sort"} <= names
    assert "vrs.pad" not in names
    # the root encloses the ops the call ran: the count= call's mask and
    # tail (their plain versions on the CPU)
    root = next(e for e in prof.events() if e.name == "vrs.sort_key_value")
    where = [e for e in prof.events() if e.name == "aten::where"]
    assert where and all(root.time_range.start <= e.time_range.start
                         and e.time_range.end <= root.time_range.end
                         for e in where)


@pytest.mark.parametrize("compiled", [(), _build.SOURCES])
def test_the_build_is_kept(monkeypatch, compiled):
    class Fn:
        argtypes = restype = None

    monkeypatch.setattr(_build, "build", lambda: ("none.so", "", compiled))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            **{name: Fn() for name in _build.SIGNATURES}))
    monkeypatch.setattr(_build, "built", None)
    with timing.LaunchTimer() as timer:
        _build.library.__wrapped__()
    assert _build.built["compiled"] == compiled
    assert _build.built["seconds"] >= 0
    assert not timer.spans and not timer.records


def test_spans_are_host_ranges_alone(monkeypatch):
    """A span records the host's clock and no CUDA event: the launch
    records' events are the recorder's only device times."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    timer = _kv_count_call(_sorter())
    assert all(set(x) == {"name", "id", "parent", "root", "start_ns",
                          "end_ns"} for x in timer.spans[1:])
    assert set(timer.spans[0]) == {"name", "id", "parent", "root",
                                   "start_ns", "end_ns", "n", "backend",
                                   "count"}
    assert all(r["events"] is None for r in timer.records)
