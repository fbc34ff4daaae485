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
    assert port.backend == "reference"
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
    with pytest.raises(NotImplementedError):
        config_from_jax(dataclasses.asdict(jvrs.SortConfig(adaptive=True)))
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
    with pytest.raises(NotImplementedError):
        SortConfig(adaptive=True)
    with pytest.raises(ValueError):
        SortConfig(backend="xla")
    with pytest.raises(ValueError):
        SortConfig(chunk=300)
    for dt in (torch.uint64, torch.int64, torch.float64):
        with pytest.raises(NotImplementedError):
            vrs.Sorter(16, key_dtype=dt, device="cpu")
    s = vrs.Sorter(16, device="cpu")
    keys = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(NotImplementedError):
        s.sort_timed(keys)
    with pytest.raises(NotImplementedError):
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


def test_chip_smoke_phases_on_the_cpu(monkeypatch):
    """chip_smoke.py's kernel-vs-plain (K6 through the slot-merge phase)
    and main-path phases, rehearsed at a small size on the CPU (plain
    versions): the network through 'auto', then the radix backend, against
    one set of oracles."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vulkan_radix_sort_tpu_torch.models import sorter

    monkeypatch.setattr(sorter, "_pick_backend", lambda cfg, dev: (
        "network" if cfg.backend == "auto" else cfg.backend))
    err = cs.check_kernels(sizes=((1 << 16, True), (1 << 16, False)),
                           device="cpu")
    err["local_gated"] = cs.check_slot_merges(slot=1 << 12, device="cpu")
    assert set(err) == set(cs.KERNELS) and not any(err.values())
    oracles = {}
    kw = dict(n=1 << 16, n_ragged=(1 << 15) + 4096, device="cpu",
              oracles=oracles)
    cs.main_path(**kw)
    shared = len(oracles)
    cs.main_path(config=cs.RADIX, **kw)
    assert len(oracles) == shared  # the radix run computes no new oracle
