"""Per-stage timing, the launch recorder and profiling, on the CPU.

On CPU tensors the kernels run their plain versions, and a
`timing.LaunchTimer` records each launch's counter names without a time;
`bitonic.stage_times*` then return the launch plan of the real
`_sort_padded` with every time None. Held against: the launch counters
the wrappers add to on each call (counted by a spy on `bk.run`), the
network's plan (chunk once, the fused rounds once, each later round's
cross spans and one local pass), and the JAX package's `stage_times*`
(interpret mode) for `rounds` and `mode`, through `bitonic.JAX_MODES`, at
the same n and chunk. Times are the card's only: `Sorter.sort_timed` on a
CPU sorter raises. Tolerance: exact counts, names and rounds.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_radix_sort_tpu.ops import bitonic as jbit
import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.utils import profiling, timing

CHUNK = 256
N = 3000  # np2 = 4096: 4 merge rounds at C = 256


def _u32(n, seed, mod=None):
    k = np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if mod is not None:
        k %= np.uint32(mod)
    return torch.from_numpy(k)


# name -> (stage_times call, the sort it times); values=None for keys
CARRIES = {
    "keys": (lambda k, v: tbit.stage_times(k, chunk=CHUNK),
             lambda k, v, c: tbit.sort_u32(k, c, chunk=CHUNK)),
    "stable": (lambda k, v: tbit.stage_times_pairs(k, v, chunk=CHUNK),
               lambda k, v, c: tbit.sort_pairs_u32(k, v, c, chunk=CHUNK)),
    "pairs": (lambda k, v: tbit.stage_times_pairs(k, v, chunk=CHUNK,
                                                  stable=False),
              lambda k, v, c: tbit.sort_pairs_u32(k, v, c, chunk=CHUNK,
                                                  stable=False)),
    "w3": (lambda k, v: tbit.stage_times_w64(k, v, v, chunk=CHUNK,
                                             stable=False),
           lambda k, v, c: tbit.sort_pairs_w64(k, v, v, c, chunk=CHUNK,
                                               stable=False)),
    "w4_big": (lambda k, v: tbit.stage_times_w64(k, v, v, chunk=CHUNK),
               lambda k, v, c: tbit.sort_pairs_w64(k, v, v, c, chunk=CHUNK)),
}


def _spy(monkeypatch):
    """Count the launch counters each call of bk.run adds to."""
    counted = Counter()
    real = bk.run

    def spy(launch, arrs, mode, nunits, valid=None):
        if nunits:
            counted.update(bk.counters(launch, valid))
        real(launch, arrs, mode, nunits, valid)
    monkeypatch.setattr(bk, "run", spy)
    return counted


@pytest.mark.parametrize("count", [None, 1234], ids=["full", "count"])
@pytest.mark.parametrize("name", list(CARRIES))
def test_recorded_launches_equal_counters(monkeypatch, name, count):
    """The timer's launch names and counts equal the launch counters of
    `_sort_padded`, gate included, and follow the network's plan."""
    monkeypatch.setattr(tbit, "MAX_FUSED_ELEMS", 2 * CHUNK)  # fuse round 1
    counted = _spy(monkeypatch)
    k, v = _u32(N, 1, 500), _u32(N, 2)
    _, sort = CARRIES[name]
    with timing.LaunchTimer() as timer:
        sort(k, v, count)
    recorded = Counter(n for r in timer.records for n in r["names"])
    assert recorded == counted
    assert all(r["events"] is None and r["mode"].name == name
               for r in timer.records)
    assert timer.seconds() == [None] * len(timer.records)
    nrounds = 4
    cross = sum(len(tbit._cross_spans(r, getattr(bk, name.upper())))
                for r in range(2, nrounds + 1))
    plan = {"chunk": 1, "fused": 1, "cross": cross, "local": nrounds - 1}
    if count is not None:
        plan["gate"] = sum(plan.values())
    assert recorded == plan


@pytest.mark.parametrize("name", list(CARRIES))
def test_stage_times_plan_on_cpu(monkeypatch, name):
    """stage_times* on CPU tensors: one launch of the real sort each in
    `kernels`, in launch order, with no times; rounds and mode."""
    monkeypatch.setattr(tbit, "MAX_FUSED_ELEMS", 2 * CHUNK)
    counted = _spy(monkeypatch)
    k, v = _u32(N, 3, 500), _u32(N, 4)
    stage_times, _ = CARRIES[name]
    st = stage_times(k, v)
    assert st["mode"] == name and st["rounds"] == 4
    assert st["chunk"] is st["cross"] is st["local"] is None
    names = [kn for kn, t in st["kernels"] if t is None]
    assert len(names) == len(st["kernels"]) == sum(counted.values())
    assert names[:2] == ["chunk[p1-8]", "fused[r1-1]"]
    assert names[-1] == "local[r4]"
    assert Counter(kn.split("[")[0] for kn in names) == counted


# JAX stage_times* call -> the port's, same n and chunk: each JAX mode
# name that maps to another name (packed, w4), keys, the pairs carry (the
# 64-bit keys-only sort) and w3. Each JAX call times its kernels in
# interpret mode, 5-15 s on the CPU.
JAX_CASES = {
    "keys": (lambda k, v: jbit.stage_times(k, chunk=CHUNK, iters=1,
                                           interpret=True),
             lambda k, v: tbit.stage_times(k, chunk=CHUNK)),
    "packed": (lambda k, v: jbit.stage_times_pairs(
        k, v, chunk=CHUNK, iters=1, interpret=True),
        lambda k, v: tbit.stage_times_pairs(k, v, chunk=CHUNK)),
    "w64_keys": (lambda k, v: jbit.stage_times_w64(
        k, v, chunk=CHUNK, iters=1, interpret=True),
        lambda k, v: tbit.stage_times_w64(k, v, chunk=CHUNK)),
    "w3": (lambda k, v: jbit.stage_times_w64(
        k, v, v, chunk=CHUNK, iters=1, stable=False, interpret=True),
        lambda k, v: tbit.stage_times_w64(k, v, v, chunk=CHUNK,
                                          stable=False)),
    "w4": (lambda k, v: jbit.stage_times_w64(
        k, v, v, chunk=CHUNK, iters=1, interpret=True),
        lambda k, v: tbit.stage_times_w64(k, v, v, chunk=CHUNK)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_rounds_and_mode_match_jax(case):
    n = 600  # np2 = 1024: two merge rounds at C = 256
    k = _u32(n, 5).numpy()
    v = _u32(n, 6).numpy()
    jax_fn, port_fn = JAX_CASES[case]
    want = jax_fn(jnp.asarray(k), jnp.asarray(v))
    got = port_fn(torch.from_numpy(k), torch.from_numpy(v))
    assert got["rounds"] == want["rounds"] == 2
    assert got["mode"] == tbit.JAX_MODES[want["mode"]]
    assert set(got) == set(want)


def test_radix_launches_recorded():
    """K7, the spine and K8 record one launch per pass each, in that
    order; nested timers both record, and no launch is recorded once they
    have exited."""
    cfg = SortConfig(backend="radix")
    k = _u32(1 << 14, 7)
    with timing.LaunchTimer() as outer:
        with timing.LaunchTimer() as inner:
            inner.tag = "radix"
            radix.sort(k, config=cfg)
    radix.sort(k, config=cfg)
    for t in (outer, inner):
        assert Counter(r["names"][0] for r in t.records) == {
            "block_sort": cfg.num_passes, "spine": cfg.num_passes,
            "place": cfg.num_passes}
    assert [r["names"][0] for r in inner.records] == \
        ["block_sort", "spine", "place"] * cfg.num_passes
    for name in ("block_sort", "place"):
        assert [r["shift"] for r in inner.records
                if r["names"][0] == name] == [0, 8, 16, 24]
    assert [r["nblocks"] for r in inner.records
            if r["names"][0] == "spine"] == [1] * cfg.num_passes
    assert {r["tag"] for r in inner.records} == {"radix"}
    assert {r["tag"] for r in outer.records} == {""}
    assert not timing._ACTIVE


@pytest.mark.parametrize("key_value", [False, True], ids=["keys", "kv"])
def test_sort_timed_refuses_cpu(key_value):
    s = vrs.Sorter(64, device="cpu")
    k = _u32(64, 8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        if key_value:
            s.sort_key_value_timed(k, k)
        else:
            s.sort_timed(k)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.stage_report(k)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.time_fn(lambda: None)


def test_profiling_trace_writes_chrome_trace(tmp_path):
    """On the CPU the trace holds the host side only (no kernel times)."""
    s = vrs.Sorter(1024, device="cpu",
                   config=SortConfig(backend="network", chunk=CHUNK))
    k = _u32(1000, 9)
    with profiling.trace(str(tmp_path)) as prof:
        out = s.sort(k)
    assert np.array_equal(out.numpy(), np.sort(k.numpy()))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert '"traceEvents"' in files[0].read_text()
    assert len(prof.key_averages()) > 0
