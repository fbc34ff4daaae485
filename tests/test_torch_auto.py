"""'auto' by size and kind: the port's `_pick_backend` and the Sorter's
per-kind backends against the JAX package's.

The JAX Sorter picks one backend per kind of sort (keys, stable kv,
non-stable kv) from its max_n (`_pick_backend(cfg, max_n, kind)`); the
port does the same with its own H100 constants (`sorter.AUTO`) and its
device. A `torch.device("cuda")` object needs no card, so the decision
table is checked here on the CPU. The routing tests give each kind a
different backend and hold a CPU Sorter (plain versions) to the JAX
Sorter given the same three names (interpret mode, n = 2^10) and, at
n = 2^14 where the radix kernels run, to numpy. Tolerance: bitwise
equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vulkan_radix_sort_tpu as jvrs
from vulkan_radix_sort_tpu.models import sorter as jsorter
import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.models import sorter
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
KINDS = ("keys", "kv", "kvns")
NETWORK = {"chunk", "fused", "cross", "local", "gate"}
RADIX = {"block_sort", "spine", "place"}
# the routing tests' kinds -> backends, in the port's and the JAX names
ROUTE = {"keys": "network", "kv": "radix", "kvns": "reference"}
JAX_ROUTE = {"keys": "network", "kv": "radix", "kvns": "xla"}
CHUNK = 256


def test_auto_constants():
    """Pins the H100 constants, from chip_smoke.py's two `[sweep-median]`
    lines, the crossovers of the median of three sweeps in one run (one
    NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5). 32-bit: radix has
    the most GItems/s at 2^25 for every kind and beats the one-sort
    reference backend from 2^23 (keys, kv, kvns). 64-bit: radix beats the
    reference at 2^25 for every kind at 5, 6 and 7 passes (end_bit 40,
    48, 56), not at 8 (a whole 64-bit key), from 2^22 (keys) and 2^23
    (kv, kvns), the largest of its crossovers at 5-7 passes."""
    assert sorter.AUTO == {
        ("keys", False): ("radix", 1 << 23),
        ("kv", False): ("radix", 1 << 23),
        ("kvns", False): ("radix", 1 << 23),
        ("keys", True): ("radix", 1 << 22),
        ("kv", True): ("radix", 1 << 23),
        ("kvns", True): ("radix", 1 << 23),
    }
    assert sorter.AUTO_MAX_PASSES64 == 7


@pytest.mark.parametrize("kind,wide", list(sorter.AUTO),
                         ids=lambda x: str(x))
def test_decision_table(kind, wide):
    """On a card: the reference below the kind's cut, its engine from the
    cut (and for max_n=None, as JAX's); the reference at every n where the
    kind has no cut."""
    engine, cut = sorter.AUTO[kind, wide]
    cfg = SortConfig()

    def pick(n):
        return sorter._pick_backend(cfg, CUDA, n, kind, wide)
    if cut is None:
        assert {pick(1 << p) for p in range(31)} | {pick(None)} == {
            "reference"}
        return
    assert [pick(1), pick(cut - 1), pick(cut), pick(1 << 30), pick(None)] \
        == ["reference", "reference", engine, engine, engine]


def test_cpu_is_reference_and_names_pass_through():
    for kind, wide in sorter.AUTO:
        for n in (1, 1 << 14, 1 << 25, 1 << 30, None):
            assert sorter._pick_backend(SortConfig(), CPU, n, kind,
                                        wide) == "reference"
    for backend, want in (("network", "network"), ("radix", "radix"),
                          ("pallas", "radix"), ("reference", "reference")):
        cfg = SortConfig(backend=backend)
        for dev in (CPU, CUDA):
            for kind, wide in sorter.AUTO:
                assert sorter._pick_backend(cfg, dev, 1 << 25, kind,
                                            wide) == want
            # as in the JAX package, a named backend is returned before
            # the kind is looked up
            assert sorter._pick_backend(cfg, dev, 1, "bogus") == want
    assert jsorter._pick_backend(jvrs.SortConfig(backend="network"), 1,
                                 kind="bogus") == "network"


def test_wide_keys_never_get_radix(monkeypatch):
    """64-bit keys never get radix under 'auto' on the CPU, nor on a card
    for a call of more radix passes than AUTO_MAX_PASSES64 (a whole
    64-bit key's 8 among them): those go to the reference. A call of at
    most that many passes, from the cut, gets radix: the 2^25 sorter's
    stable kv call at end_bit 45 (6 passes) among them. A named backend is
    never overridden. The card's picks are made on a CPU sorter through
    `_pick_backend` asked for a CUDA device."""
    for kind in KINDS:
        assert {sorter._pick_backend(SortConfig(), CPU, n, kind, True)
                for n in [1 << p for p in range(31)] + [None]} == {
            "reference"}
    for dtype in (torch.uint64, torch.int64, torch.float64):
        s = vrs.Sorter(1 << 25, key_dtype=dtype, device="cpu")
        assert {s.backend_for(k, e) for k in KINDS
                for e in (None, 45)} == {"reference"}
    real = sorter._pick_backend
    monkeypatch.setattr(sorter, "_pick_backend",
                        lambda cfg, device, *a: real(cfg, CUDA, *a))
    for kind in KINDS:
        engine, cut = sorter.AUTO[kind, True]
        limit = sorter.AUTO_MAX_PASSES64
        assert limit < 8
        for max_n in (cut - 1, cut, 1 << 25):
            s = vrs.Sorter(max_n, key_dtype=torch.uint64, device="cpu")
            for end_bit in range(1, 65):
                passes = -(-end_bit // 8)
                want = engine if max_n >= cut and passes <= limit \
                    else "reference"
                assert s.backend_for(kind, end_bit) == want, (max_n,
                                                              end_bit)
            assert s.backend_for(kind) == "reference"
    s = vrs.Sorter(1 << 25, key_dtype=torch.uint64, device="cpu")
    assert s.backend_for("kv", 45) == "radix"
    named = vrs.Sorter(1 << 25, key_dtype=torch.uint64, device="cpu",
                       config=SortConfig(backend="radix"))
    assert {named.backend_for(k, e) for k in KINDS
            for e in (None, 45)} == {"radix"}
    narrow = vrs.Sorter(1 << 25, device="cpu")
    assert {narrow.backend_for(k, e) for k in KINDS
            for e in (None, 4, 32)} == {"radix"}


@pytest.mark.parametrize("device", [CPU, CUDA], ids=str)
def test_unknown_kind_raises_like_jax(device):
    """The kind is looked up before the device check, so a bad caller
    fails on every device, as the JAX `_pick_backend` fails on the CPU."""
    with pytest.raises(KeyError):
        sorter._pick_backend(SortConfig(), device, 1 << 20, "bogus")
    with pytest.raises(KeyError):
        jsorter._pick_backend(jvrs.SortConfig(backend="auto"), 1 << 20,
                              kind="bogus")


def test_sorter_backends_per_kind(monkeypatch):
    """Sorter.__init__ asks once per kind, with its max_n and width; a CPU
    sorter's 'auto' is the reference for every kind."""
    asked = []

    def pick(cfg, device, max_n=None, kind="keys", wide=False):
        asked.append((device.type, max_n, kind, wide))
        return ROUTE[kind]
    monkeypatch.setattr(sorter, "_pick_backend", pick)
    s = vrs.Sorter(1000, device="cpu")
    assert (s.backend, s.backend_kv, s.backend_kvns) == (
        "network", "radix", "reference")
    assert asked == [("cpu", 1000, k, False) for k in KINDS]
    monkeypatch.undo()
    s = vrs.Sorter(1 << 25, key_dtype=torch.int64, device="cpu")
    assert (s.backend, s.backend_kv, s.backend_kvns) == ("reference",) * 3


def _route(monkeypatch):
    """Give 'auto' keys -> network, kv -> radix, kvns -> reference in both
    packages."""
    real, jreal = sorter._pick_backend, jsorter._pick_backend

    def pick(cfg, device, max_n=None, kind="keys", wide=False):
        if cfg.backend != "auto":
            return real(cfg, device, max_n, kind, wide)
        return ROUTE[kind]

    def jpick(cfg, max_n=None, kind="keys"):
        if cfg.backend != "auto":
            return jreal(cfg, max_n, kind)
        return JAX_ROUTE[kind]
    monkeypatch.setattr(sorter, "_pick_backend", pick)
    monkeypatch.setattr(jsorter, "_pick_backend", jpick)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 9, n).astype(np.uint32)  # ties
    k[::17] = 0xFFFFFFFF
    return k, datagen.generate_values(n, seed=seed + 1)


# path -> (kind, call on a Sorter, adaptive)
PATHS = {
    "sort": ("keys", lambda s, k, v, c: s.sort(k), False),
    "sort count=": ("keys", lambda s, k, v, c: s.sort(k, count=c), False),
    "adaptive sort": ("keys", lambda s, k, v, c: s.sort(k), True),
    "kv": ("kv", lambda s, k, v, c: s.sort_key_value(k, v), False),
    "kv count=": ("kv", lambda s, k, v, c: s.sort_key_value(k, v, count=c),
                  False),
    "adaptive kv": ("kv", lambda s, k, v, c: s.sort_key_value(k, v), True),
    "kvns": ("kvns", lambda s, k, v, c: s.sort_key_value(k, v, stable=False),
             False),
    "kvns count=": ("kvns", lambda s, k, v, c: s.sort_key_value(
        k, v, count=c, stable=False), False),
    "adaptive kvns": ("kvns", lambda s, k, v, c: s.sort_key_value(
        k, v, stable=False), True),
}


def _run(n, path):
    """One CPU sort on the routed Sorter; its output (numpy) and the
    counter names its launches recorded."""
    kind, call, adaptive = PATHS[path]
    k, v = _inputs(n, seed=n % 97)
    count = n - n // 5 - 3
    s = vrs.Sorter(n, device="cpu",
                   config=SortConfig(chunk=CHUNK, adaptive=adaptive))
    with timing.LaunchTimer() as t:
        out = call(s, torch.from_numpy(k), torch.from_numpy(v),
                   torch.tensor(count))
    out = out if isinstance(out, tuple) else (out,)
    names = [x for rec in t.records for x in rec["names"]]
    return kind, [x.numpy() for x in out], names, (k, v, count)


def _held_to_backend(backend, names, n, count=False):
    got = set(names)
    if backend == "network":
        assert got and got <= NETWORK
    elif backend == "radix" and n >= radix.MIN_RADIX_N:
        # 4 8-bit passes; a count= sort's tail after them
        edges = ["restore_tail"] if count else []
        assert sorted(names) == sorted(list(RADIX) * 4 + edges)
    else:  # the reference, and radix below MIN_RADIX_N, launch nothing
        assert not names


@pytest.mark.parametrize("path", list(PATHS))
def test_routing_by_kind_matches_jax(monkeypatch, path):
    """n = 2^10: each kind runs its own backend (recorded launches), and
    the outputs equal the JAX Sorter's with the same backend per kind,
    through its `_sort_dispatch` / `_sort_pairs_dispatch`."""
    _route(monkeypatch)
    n = 1 << 10
    kind, got, names, (k, v, count) = _run(n, path)
    _held_to_backend(ROUTE[kind], names, n)
    _, call, adaptive = PATHS[path]
    js = jvrs.Sorter(n, config=jvrs.SortConfig(chunk=CHUNK, interpret=True,
                                               adaptive=adaptive))
    assert (js.backend, js.backend_kv, js.backend_kvns) == tuple(
        JAX_ROUTE[x] for x in KINDS)
    want = call(js, jnp.asarray(k), jnp.asarray(v), count)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("path", list(PATHS))
def test_routing_by_kind_matches_numpy(monkeypatch, path):
    """n = 2^14 (radix.MIN_RADIX_N), where the radix kernels run: each
    kind's recorded launches are its backend's, and the outputs equal
    numpy's stable sort (every routed backend is stable but the network,
    which here runs keys only); count= leaves the tail as it was."""
    _route(monkeypatch)
    n = radix.MIN_RADIX_N
    kind, got, names, (k, v, count) = _run(n, path)
    _held_to_backend(ROUTE[kind], names, n, count="count" in path)
    m = count if "count" in path else n
    o = np.argsort(k[:m], kind="stable")
    np.testing.assert_array_equal(got[0], np.concatenate([k[:m][o], k[m:]]))
    if kind != "keys":
        np.testing.assert_array_equal(got[1],
                                      np.concatenate([v[:m][o], v[m:]]))


def test_storage_follows_the_kinds_backend(monkeypatch):
    """storage_requirements sizes the backend the sort runs: `backend`
    for keys, `backend_kv` for key-value."""
    _route(monkeypatch)
    for n in (1000, 1 << 20):
        s = vrs.Sorter(n, device="cpu")
        named = {b: vrs.Sorter(n, device="cpu",
                               config=SortConfig(backend=b))
                 for b in ("network", "radix")}
        assert s.storage_requirements() == \
            named["network"].storage_requirements()
        assert s.storage_requirements(key_value=True) == \
            named["radix"].storage_requirements(key_value=True)
        assert s.storage_requirements(key_value=True) != \
            named["network"].storage_requirements(key_value=True)
