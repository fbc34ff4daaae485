"""The port's Sorter and public API against the JAX package's.

`Sorter(device="cpu", backend="network")` runs the network with each
kernel's plain version; the JAX side is `Sorter(backend="network",
interpret=True)`. Same numpy-seeded inputs; tolerance: bitwise equality.
Also: the configuration carried across from a JAX SortConfig, the storage
estimate, the refusals, and that neither the port nor chip_smoke.py
imports JAX or the JAX package.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vulkan_radix_sort_tpu as jvrs
import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, RADIX_BLOCK, SortConfig, config_from_jax)
from vulkan_radix_sort_tpu_torch.ops import bitonic, radix, reference
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 256
N = 1500

DTYPES = {  # torch dtype -> (jnp dtype, numpy dtype)
    torch.uint32: (jnp.uint32, np.uint32),
    torch.int32: (jnp.int32, np.int32),
    torch.float32: (jnp.float32, np.float32),
}


def _keys(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        k = rng.standard_normal(n).astype(np.float32)
        k[::13] = k[::7][: len(k[::13])]  # duplicates
        return k
    k = rng.integers(0, 1 << 9, n).astype(np.uint32)
    k[::17] = 0xFFFFFFFF
    return k.view(DTYPES[dtype][1])


def _pair(dtype):
    port = vrs.Sorter(4096, key_dtype=dtype, device="cpu",
                      config=SortConfig(backend="network", chunk=CHUNK))
    jax_ = jvrs.Sorter(4096, key_dtype=DTYPES[dtype][0],
                       config=jvrs.SortConfig(backend="network", chunk=CHUNK,
                                              interpret=True))
    return port, jax_


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_sort_matches_jax(dtype):
    port, jax_ = _pair(dtype)
    k = _keys(dtype)
    _eq(port.sort(torch.from_numpy(k)), jax_.sort(jnp.asarray(k)))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_sort_key_value_matches_jax(dtype, stable):
    port, jax_ = _pair(dtype)
    k = _keys(dtype, seed=1)
    v = datagen.generate_values(N, seed=2)
    gk, gv = port.sort_key_value(torch.from_numpy(k), torch.from_numpy(v),
                                 stable=stable)
    wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v),
                                 stable=stable)
    _eq(gk, wk)
    _eq(gv, wv)


@pytest.mark.parametrize("path", ["keys", "stable", "nonstable"])
@pytest.mark.parametrize("count_kind", ["int", "tensor"])
def test_count_matches_jax(path, count_kind):
    """count= on the keys path and both key-value paths: the prefix sorted,
    the tail untouched, genuine 0xFFFFFFFF keys inside the prefix."""
    port, jax_ = _pair(torch.uint32)
    k = _keys(torch.uint32, seed=3)
    v = datagen.generate_values(N, seed=4)
    count = 977
    cnt = count if count_kind == "int" else torch.tensor(count)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if path == "keys":
        _eq(port.sort(tk, count=cnt), jax_.sort(jnp.asarray(k), count=count))
        return
    stable = path == "stable"
    gk, gv = port.sort_key_value(tk, tv, count=cnt, stable=stable)
    wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v), count=count,
                                 stable=stable)
    _eq(gk, wk)
    _eq(gv, wv)
    np.testing.assert_array_equal(gv.numpy()[count:], v[count:])


def test_reference_backend_matches_jax_xla():
    port = vrs.Sorter(4096, device="cpu")
    assert (port.backend, port.backend_kv, port.backend_kvns) == (
        "reference",) * 3
    jax_ = jvrs.Sorter(4096, config=jvrs.SortConfig(backend="xla"))
    k = _keys(torch.uint32, seed=5)
    v = datagen.generate_values(N, seed=6)
    _eq(port.sort(torch.from_numpy(k)), jax_.sort(jnp.asarray(k)))
    gk, gv = port.sort_key_value(torch.from_numpy(k), torch.from_numpy(v))
    wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v))
    _eq(gk, wk)
    _eq(gv, wv)
    for stable in (True, False):
        gk, gv = port.sort_key_value(torch.from_numpy(k), torch.from_numpy(v),
                                     count=700, stable=stable)
        wk, wv = jax_.sort_key_value(jnp.asarray(k), jnp.asarray(v),
                                     count=700)
        _eq(gk, wk)
        _eq(gv, wv)
    _eq(port.sort(torch.from_numpy(k), count=torch.tensor(700)),
        jax_.sort(jnp.asarray(k), count=700))


def test_module_functions_match_jax():
    k = _keys(torch.uint32, seed=7)
    v = datagen.generate_values(N, seed=8)
    cfg = SortConfig(backend="network", chunk=CHUNK)
    jcfg = jvrs.SortConfig(backend="network", chunk=CHUNK, interpret=True)
    _eq(vrs.sort(torch.from_numpy(k), config=cfg),
        jvrs.sort(jnp.asarray(k), config=jcfg))
    gk, gv = vrs.sort_key_value(torch.from_numpy(k), torch.from_numpy(v),
                                config=cfg, stable=False)
    wk, wv = jvrs.sort_key_value(jnp.asarray(k), jnp.asarray(v), config=jcfg,
                                 stable=False)
    _eq(gk, wk)
    _eq(gv, wv)


CONTRACT = {  # backend -> (module, n, config)
    "radix": (radix, radix.MIN_RADIX_N + 5, SortConfig(backend="radix")),
    "network": (bitonic, 1029, SortConfig(backend="network", chunk=CHUNK)),
    "reference": (reference, 1029, SortConfig(backend="reference"))}
CONTRACT_END_BIT = {32: 13, 64: 45}


@pytest.mark.parametrize("end_bit", [None, "odd"])
@pytest.mark.parametrize("count", [None, 0, "mid", "n"])
@pytest.mark.parametrize("kind", ["keys", "kv", "kvns"])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("backend", list(CONTRACT))
def test_backend_sort_contract(backend, width, kind, count, end_bit):
    """Each backend's one `sort` on encoded keys against the reference
    backend's and numpy's stable argsort of the prefix, for every key
    width, kind, `count` (None, 0, the middle, n) and an `end_bit` no
    multiple of 8 (or None): keys and values bitwise, but for the
    network's stable=False without `end_bit`, whose values are checked as
    a multiset per key (equal keys come out by ascending value). Genuine
    maximum keys lie in the prefix; the radix case runs its kernels'
    plain versions (n = MIN_RADIX_N + 5)."""
    module, n, cfg = CONTRACT[backend]
    np_dt = np.uint32 if width == 32 else np.uint64
    rng = np.random.default_rng(width + n)
    k = rng.integers(0, 2**width - 1, n, dtype=np.uint64,
                     endpoint=True).astype(np_dt)
    k[::13] = k[::11][: len(k[::13])]  # ties
    k[::17] = np.iinfo(np_dt).max
    v = datagen.generate_values(n, seed=width)
    c = {"mid": n // 2, "n": n}.get(count, count)
    bits = CONTRACT_END_BIT[width] if end_bit else None
    stable = kind != "kvns"
    cnt = None if c is None else torch.tensor(c)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    values = None if kind == "keys" else tv
    kw = dict(count=cnt, end_bit=bits, stable=stable, config=cfg)
    got = module.sort(tk, values, **kw)
    want = reference.sort(tk, values, **kw)
    gk, gv = (got, None) if values is None else got
    wk, wv = (want, None) if values is None else want
    m = n if c is None else c
    order = np.argsort(k[:m] if bits is None
                       else k[:m] & np_dt((1 << bits) - 1), kind="stable")
    np.testing.assert_array_equal(wk.numpy(),
                                  np.concatenate([k[:m][order], k[m:]]))
    np.testing.assert_array_equal(gk.numpy(), wk.numpy())
    np.testing.assert_array_equal(tk.numpy(), k)  # inputs untouched
    if values is None:
        return
    np.testing.assert_array_equal(wv.numpy(),
                                  np.concatenate([v[:m][order], v[m:]]))
    if backend == "network" and not stable and bits is None:
        np.testing.assert_array_equal(gv.numpy()[m:], v[m:])
        pairs = np.lexsort((gv.numpy()[:m], gk.numpy()[:m]))
        want_pairs = np.lexsort((v[:m], k[:m]))
        np.testing.assert_array_equal(gv.numpy()[:m][pairs],
                                      v[:m][want_pairs])
        return
    np.testing.assert_array_equal(gv.numpy(), wv.numpy())


@pytest.mark.parametrize("max_n", [1, 255, 1000, 1 << 20, (1 << 20) + 1])
@pytest.mark.parametrize("key_value", [False, True])
def test_storage_requirements_match_jax_network(max_n, key_value):
    port = vrs.Sorter(max_n, device="cpu",
                      config=SortConfig(backend="network"))
    jax_ = jvrs.Sorter(max_n, config=jvrs.SortConfig(backend="network"))
    assert port.storage_requirements(key_value) == \
        jax_.storage_requirements(key_value)
    ref = vrs.Sorter(max_n, device="cpu")
    assert ref.storage_requirements(key_value) > 0


def test_config_from_jax():
    fields = dataclasses.asdict(jvrs.SortConfig(backend="xla", chunk=4096,
                                                interpret=True))
    cfg = config_from_jax(fields)
    assert cfg == SortConfig(chunk=4096, backend="reference")
    assert config_from_jax(dataclasses.asdict(jvrs.SortConfig())) == \
        SortConfig()
    net = config_from_jax(dataclasses.asdict(
        jvrs.SortConfig(backend="network")))
    assert (net.backend, net.chunk_keys, net.chunk_carry) == (
        "network", CHUNK_KEYS, CHUNK_CARRY)
    with pytest.raises(ValueError):  # the JAX chunk sizes do not fit smem
        config_from_jax(dataclasses.asdict(jvrs.SortConfig(chunk=1 << 16)))
    # the radix backend maps by name; its TPU geometry (block=2048, 4-bit
    # digits, flush rows) gives way to the port's Hopper defaults
    for backend in ("radix", "pallas"):
        rad = config_from_jax(dataclasses.asdict(jvrs.SortConfig(
            backend=backend, block=1024, digit_bits=4, flush_rows=4)))
        assert rad == SortConfig(backend="radix")
        assert (rad.block, rad.digit_bits, rad.radix, rad.num_passes) == (
            RADIX_BLOCK, 8, 256, 4)
    assert config_from_jax(dataclasses.asdict(
        jvrs.SortConfig(adaptive=True))) == SortConfig(adaptive=True)
    with pytest.raises(TypeError):
        config_from_jax({"bogus": 1})


def test_refusals():
    # the radix backend is ported: 'pallas' is its alias, as in the JAX
    # package; only its two digit widths and shared-memory-sized blocks
    # are taken
    assert SortConfig(backend="pallas") == SortConfig(backend="radix")
    assert SortConfig(backend="radix", digit_bits=4).num_passes == 8
    for bad in (dict(digit_bits=5), dict(digit_bits=16), dict(block=1000),
                dict(block=256), dict(block=1 << 15)):
        with pytest.raises(ValueError):
            SortConfig(backend="radix", **bad)
    with pytest.raises(ValueError):
        SortConfig(backend="xla")
    with pytest.raises(ValueError):
        SortConfig(chunk=300)
    for dt in (torch.int32, torch.float32, torch.int64, torch.float64):
        # radix takes 64-bit keys too; end_bit orders unsigned keys only
        s = vrs.Sorter(16, key_dtype=dt, device="cpu",
                       config=SortConfig(backend="radix"))
        keys = torch.zeros(8, dtype=dt)
        with pytest.raises(ValueError, match="end_bit"):
            s.sort(keys, end_bit=8)
    for dt, width in ((torch.uint32, 32), (torch.uint64, 64)):
        s = vrs.Sorter(16, key_dtype=dt, device="cpu")
        keys = torch.zeros(8, dtype=torch.int64).to(
            torch.int32 if width == 32 else torch.int64).view(dt)
        for bad in (0, -1, width + 1):
            with pytest.raises(ValueError, match="end_bit"):
                s.sort(keys, end_bit=bad)
    with pytest.raises(ValueError):
        vrs.Sorter(16, key_dtype=torch.int16, device="cpu")
    s = vrs.Sorter(16, device="cpu")
    keys = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    # timing is on the card only: a CPU sorter refuses to time the CPU
    with pytest.raises(RuntimeError, match="CUDA device"):
        s.sort_timed(keys)
    with pytest.raises(RuntimeError, match="CUDA device"):
        s.sort_key_value_timed(keys, keys)
    with pytest.raises(ValueError):  # another device is refused, not moved
        s.sort(keys.to("meta"))
    with pytest.raises(ValueError):
        s.sort(keys, count=torch.tensor(3, device="meta"))
    with pytest.raises(TypeError):
        s.sort(keys.view(torch.int32))
    with pytest.raises(TypeError):
        s.sort_key_value(keys, keys.view(torch.int32))
    with pytest.raises(ValueError):
        vrs.Sorter(4, device="cpu").sort(
            torch.zeros(8, dtype=torch.int32).view(torch.uint32))
    with pytest.raises(TypeError):
        vrs.create_sorter(16, device="cpu", bogus=1)
    assert vrs.create_sorter(16, device="cpu", backend="network").backend \
        == "network"
    for backend in ("radix", "pallas"):
        assert vrs.create_sorter(16, device="cpu",
                                 backend=backend).backend == "radix"


def test_cuda_default_needs_a_card():
    """The entry points run on the card unless asked for the CPU; without
    a card, asking for it raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        vrs.Sorter(16)
    with pytest.raises(RuntimeError):
        timing.time_fn(lambda: None)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None))
                in ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "vulkan_radix_sort_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 8
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "vulkan_radix_sort_tpu"), (
                f"{path.relative_to(ROOT)} imports {mod}")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: nonzero exit and no result line. Alone in a directory
    without the package: nonzero too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_chip_smoke_dist2_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 7b (overlap on the 1-D world, the 2 x 2 mesh,
    the reports) rehearsed on 4 gloo CPU ranks at 2^13 keys a rank with
    the plain versions: every answer against numpy, every launch check
    (from the launch recorder: plain versions count no launch), the
    dcn_slack=1 refusal, and the reports the same on every rank."""
    monkeypatch.syspath_prepend(str(ROOT))  # the ranks import it by name
    cs = importlib.import_module("chip_smoke")
    cs.dist2_phase(n_rank=1 << 13, device="cpu", use_kernels=True, iters=1)


def test_chip_smoke_phases_on_the_cpu(monkeypatch):
    """chip_smoke.py's kernel-vs-plain (K6 through the slot-merge phase,
    K3 and K4 through the half merge) and main-path phases, rehearsed at a
    small size on the CPU (plain versions): the network, then the radix
    and the reference backends, then 'auto' with the card's decisions at
    2^9 times the size (so each kind takes the engine it takes at 2^25 on
    the card), against
    one set of oracles, each sort's recorded launches held to its kind's
    backend; then the 64-bit path on the network and through 'auto'; then
    the 64-bit sweep's gates, and the '[auto]' report on a made-up
    sweep."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vulkan_radix_sort_tpu_torch.models import sorter

    err = cs.check_kernels(sizes=((1 << 16, True), (1 << 16, False)),
                           device="cpu",
                           radix_sizes=((1 << 16, True), (1 << 16, False)))
    err["local_gated"] = cs.check_slot_merges(slot=1 << 12, device="cpu")
    cs.check_halves_merge(m=1 << 13, device="cpu")
    # every kernel row's kernel, and the spine (K8's column sums, a
    # launch of its own)
    assert set(err) == set(cs.KERNELS) | set(cs.RADIX_KERNELS)
    assert not any(err.values())
    oracles = {}
    kw = dict(n=1 << 16, n_ragged=(1 << 15) + 4096, device="cpu",
              oracles=oracles)
    assert set(cs.main_path(config=cs.NETWORK, **kw).values()) == {
        "network"}
    shared = len(oracles)
    assert set(cs.main_path(config=cs.RADIX, **kw).values()) == {"radix"}
    assert set(cs.main_path(config=cs.REFERENCE, **kw).values()) == {
        "reference"}
    real = sorter._pick_backend
    monkeypatch.setattr(
        sorter, "_pick_backend",
        lambda cfg, device, max_n=None, kind="keys", wide=False: real(
            cfg, torch.device("cuda"), max_n << 9, kind, wide))
    picked = cs.main_path(**kw)
    assert picked == {k: real(SortConfig(), torch.device("cuda"), 1 << 25,
                              k) for k in ("keys", "kv", "kvns")}
    assert len(oracles) == shared  # the later runs compute no new oracle
    kw64 = dict(n=1 << 15, n_ragged=(1 << 14) + 4096, device="cpu")
    cs.main_path64(config=cs.NETWORK, **kw64)
    cs.main_path64(**kw64)
    monkeypatch.undo()
    for backend in cs.SWEEP64_BACKENDS:
        cs.gate64(backend, 1 << 12, device="cpu")
    # a made-up sweep: radix fastest from 2^16 on (network second), the
    # reference fastest below; 'auto' picked the reference below 2^16
    sizes = (1 << 14, 1 << 15, 1 << 16, 1 << 17)
    ms = {(b, s, n): {"radix": 1.0, "network": 2.0, "reference": 1.5}[b]
          if n >= 1 << 16 else {"radix": 3.0, "network": 2.0,
                                "reference": 1.0}[b]
          for b in ("network", "radix", "reference") for s in cs.SWEEP_SORTS
          for n in sizes}
    auto = {(s, n): ("radix" if n >= 1 << 16 else "reference", 1.0)
            for s in cs.SWEEP_SORTS for n in sizes}
    report = cs.auto_report(False, ms, auto, sizes)
    for kind, r in report.items():
        assert (r["engine_measured"], r["cut_measured"]) == ("radix", 1 << 16)
        assert (r["engine_constant"], r["cut_constant"]) == \
            sorter.AUTO[kind, False]
        assert [x["best"] for x in r["sizes"]] == \
            ["reference"] * 2 + ["radix"] * 2
        assert [x["picked"] for x in r["sizes"]] == \
            [x["best"] for x in r["sizes"]]


def test_chip_smoke_median_sweeps(monkeypatch):
    """chip_smoke.median_sweeps on made-up sweeps: each (backend, sort, n)
    point is the median of its runs, and the crossovers it logs are those
    of the medians: the first run's outlying reference time at 2^16 alone
    would move radix's cut to 2^17, the median keeps it at 2^16."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sizes = (1 << 14, 1 << 15, 1 << 16, 1 << 17)
    base = {"network": 2.0, "radix": 1.0, "reference": 1.5}

    def table(r, backends):
        return {(b, s, n): base[b] + 0.1 * r
                + (1.0 if b == "radix" and n < 1 << 16 else 0.0)
                - (0.8 if (r, b, n) == (0, "reference", 1 << 16) else 0.0)
                for b in backends for s in cs.SWEEP_SORTS for n in sizes}
    calls, lines = [], []

    def sweep32(card):
        calls.append(32)
        return table(calls.count(32) - 1, ("network", "radix", "reference"))

    def sweep64(card):  # radix the only 64-bit engine
        calls.append(64)
        return table(calls.count(64) - 1, ("radix", "reference"))
    monkeypatch.setattr(cs, "sweep_phase", sweep32)
    monkeypatch.setattr(cs, "sweep64_phase", sweep64)
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(a))
    med32, med64 = cs.median_sweeps("card", repeats=3)
    assert calls == [32, 64] * 3
    assert med32["radix", "keys", 1 << 16] == pytest.approx(1.1)
    assert med32["reference", "keys", 1 << 16] == pytest.approx(1.6)
    assert set(med64) == {k for k in med32 if k[0] != "network"}
    assert cs.crossovers(table(0, base), ("radix",))["radix_keys"] == 1 << 17
    logged = [json.loads(a[1]) for a in lines if a[0] == "[sweep-median]"]
    assert [x["keys"] for x in logged] == ["uint32", "uint64"]
    assert logged[0]["crossover"]["radix_keys"] == 1 << 16
    assert logged[0]["crossover"]["network_kv"] is None
    assert logged[1]["crossover"] == {f"radix_{s}": 1 << 16
                                      for s in cs.SWEEP_SORTS}
    row = next(x for x in logged[0]["results"] if (
        x["backend"], x["sort"], x["n"]) == ("reference", "kv", 1 << 16))
    assert (row["lo"], row["ms"], row["hi"]) == pytest.approx((0.7, 1.6, 1.7))
