"""The port's 1-D distributed sort (`parallel/distributed.py`) on a world of
4 gloo CPU ranks, against the JAX package's `sort_sharded` /
`sort_pairs_sharded` on a 4-device CPU mesh with its Pallas kernels in
interpret mode (`SortConfig(chunk=1<<10, interpret=True)`, use_pallas).

One world is spawned for the module (start method spawn, initialised
through a file store in a temporary directory, so parallel test workers
never contend for a port). It runs every case of CASES and writes each
rank's output shard, the kernels it called and any error it raised; each
test then joins the shards. The port runs its kernels' plain versions
(use_kernels=True on CPU tensors) at the JAX side's chunk. Stable
key-value is held against numpy's stable order (the JAX suite marks that
case slow). Tolerance: bitwise equality.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.config import SortConfig as JaxConfig
from vulkan_radix_sort_tpu.parallel import distributed as jdist
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.parallel import distributed as td
from vulkan_radix_sort_tpu_torch.utils import datagen

WORLD = 4
CHUNK = 1 << 10

# name -> keys (distribution, n, seed), values or not, and the call's options
CASES = {
    "keys_merge": dict(dist="uniform", n=WORLD * 2048, seed=31),
    # ragged n and count=: padding and mask go to the last slot, which fits
    "ragged_count": dict(dist="uniform", n=WORLD * 1024 - 37, seed=33,
                         count=WORLD * 1024 - 137, merge_resort=True),
    # m = 2: the ranks hold 2, 2, 1 and 0 keys
    "short_and_empty_shards": dict(dist="uniform", n=5, seed=34,
                                   merge_resort=True),
    "constant_fallback": dict(dist="zeros", n=WORLD * 512),
    "explicit_overflow": dict(dist="zeros", n=WORLD * 1024,
                              merge_resort=True),
    "stable_kv_dups": dict(dist="dups", n=WORLD * 1024, seed=32, kv=True,
                           merge_resort=True),
    "stable_kv_reference": dict(dist="dups", n=WORLD * 1000 + 3, seed=35,
                                kv=True, use_kernels=False),
    "overlap": dict(dist="uniform", n=WORLD * 256, seed=36, overlap=True),
    "bad_layout": dict(dist="uniform", n=WORLD * 256, seed=37),
}


def _data(case):
    n = case["n"]
    if case["dist"] == "zeros":
        keys = np.zeros(n, np.uint32)
    else:
        keys = datagen.generate_keys(n, seed=case["seed"])
        if case["dist"] == "dups":
            keys = (keys & np.uint32(0xF)) * np.uint32(0x11111111)
    return keys, np.arange(n, dtype=np.uint32)


def _shard(rank, n):
    m = -(-n // WORLD)
    return min(rank * m, n), min((rank + 1) * m, n)


def _world(rank, world, tmp):
    """One rank: every case through the public entry points."""
    calls = []
    real = bk.run

    def spy(launch, arrs, mode, nunits, valid=None):
        calls.append(launch.kernel)
        real(launch, arrs, mode, nunits, valid)

    bk.run = spy
    for name, case in CASES.items():
        keys, vals = _data(case)
        lo, hi = _shard(rank, case["n"])
        if name == "bad_layout" and rank == 0:  # short before full shards
            hi -= 1
        k = torch.from_numpy(keys[lo:hi].copy())
        v = torch.from_numpy(vals[lo:hi].copy())
        kw = dict(config=SortConfig(chunk=CHUNK), count=case.get("count"),
                  use_kernels=case.get("use_kernels", True),
                  overlap=case.get("overlap", False),
                  merge_resort=case.get("merge_resort"))
        calls.clear()
        result = {}
        try:
            if case.get("kv"):
                gk, gv = td.sort_pairs_sharded(k, v, **kw)
                np.save(f"{tmp}/{name}_{rank}_v.npy", gv.numpy())
            else:
                gk = td.sort_sharded(k, **kw)
            np.save(f"{tmp}/{name}_{rank}_k.npy", gk.numpy())
        except ValueError as e:
            result["error"] = [type(e).__name__, str(e)]
        result["kernels"] = sorted(set(calls))
        with open(f"{tmp}/{name}_{rank}.json", "w") as f:
            json.dump(result, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    td.spawn_world(_world, WORLD, str(tmp), init_file=str(tmp / "store"),
                   timeout_s=300)
    return tmp


def _reports(tmp, name):
    out = []
    for r in range(WORLD):
        with open(tmp / f"{name}_{r}.json") as f:
            out.append(json.load(f))
    return out


def _joined(tmp, name, what="k"):
    return np.concatenate([np.load(tmp / f"{name}_{r}_{what}.npy")
                           for r in range(WORLD)])


def _jax_sort(case, keys, **kw):
    return np.asarray(jdist.sort_sharded(
        jnp.asarray(keys), jdist.make_mesh(WORLD),
        config=JaxConfig(chunk=CHUNK, interpret=True), use_pallas=True,
        count=case.get("count"), merge_resort=case.get("merge_resort"),
        **kw))


def _kernels(tmp, name):
    return [set(r["kernels"]) for r in _reports(tmp, name)]


@pytest.mark.parametrize("name", ["keys_merge", "ragged_count",
                                  "short_and_empty_shards"])
def test_merge_path_matches_jax(world, name):
    """The merge re-sort: every rank with data ran the gated local (K6)."""
    case = CASES[name]
    keys, _ = _data(case)
    got = _joined(world, name)
    np.testing.assert_array_equal(got, _jax_sort(case, keys))
    c = case.get("count", case["n"])
    np.testing.assert_array_equal(got[:c], np.sort(keys[:c]))
    np.testing.assert_array_equal(got[c:], keys[c:])
    for r, kernels in enumerate(_kernels(world, name)):
        assert "local_gated" in kernels and "cross" in kernels, r
    lens = [np.load(world / f"{name}_{r}_k.npy").size for r in range(WORLD)]
    assert lens == [hi - lo for lo, hi in (_shard(r, case["n"])
                                           for r in range(WORLD))]


def test_constant_keys_fall_back_as_jax(world):
    """Constant keys put a whole shard in one slot: the auto mode falls
    back to the packed exchange and a full re-sort (no K6)."""
    case = CASES["constant_fallback"]
    keys, _ = _data(case)
    got = _joined(world, "constant_fallback")
    np.testing.assert_array_equal(got, _jax_sort(case, keys))
    for kernels in _kernels(world, "constant_fallback"):
        assert "local_gated" not in kernels and "chunk" in kernels


def test_explicit_overflow_raises_as_jax(world):
    case = CASES["explicit_overflow"]
    for rep in _reports(world, "explicit_overflow"):
        assert rep["error"][0] == "ValueError"
        assert "slot staging" in rep["error"][1]
    with pytest.raises(ValueError, match="slot staging"):
        _jax_sort(case, _data(case)[0])


@pytest.mark.parametrize("name", ["stable_kv_dups", "stable_kv_reference"])
def test_stable_kv_matches_numpy(world, name):
    """16 distinct keys: stability across ranks is the (source rank,
    intra-source order) tiebreak of the slot merge, or the reference's
    stable sort with use_kernels=False (which calls no kernel)."""
    keys, vals = _data(CASES[name])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(_joined(world, name), keys[order])
    np.testing.assert_array_equal(_joined(world, name, "v"), vals[order])
    kernels = _kernels(world, name)
    if name == "stable_kv_reference":
        assert all(not k for k in kernels)
    else:
        assert all("local_gated" in k for k in kernels)


@pytest.mark.parametrize("name,error", [("bad_layout", "ValueError")])
def test_refusals(world, name, error):
    """Shards off the JAX layout are refused on every rank."""
    for rep in _reports(world, name):
        assert rep["error"][0] == error


def test_overlap_matches_jax(world):
    """overlap=True (merge_resort=None: the slot merge per source half,
    then the keys half merge) as the JAX package's: every rank ran the
    gated local kernel (the half merges) and the local kernel (the
    bitonic merge of the halves)."""
    case = CASES["overlap"]
    keys, _ = _data(case)
    got = _joined(world, "overlap")
    np.testing.assert_array_equal(got, _jax_sort(case, keys, overlap=True))
    np.testing.assert_array_equal(got, np.sort(keys))
    for r, kernels in enumerate(_kernels(world, "overlap")):
        assert {"local_gated", "local"} <= kernels, r


def test_slot_dest_prearranges_odd_sources():
    """Placement: source s's run into slot s, descending in the suffix of
    an odd slot; zero-size runs place nothing."""
    recv, S = [3, 2, 0, 1], 4
    dest = td._slot_dest(recv, S, torch.device("cpu")).tolist()
    assert dest == [0, 1, 2, 7, 6, 15]
    got = [torch.arange(10, 16, dtype=torch.int32).view(torch.uint32)]
    (buf,), sizes = td.slot_arrivals(got, recv, S)
    assert buf.view(torch.int32).tolist() == [
        10, 11, 12, -1, -1, -1, 14, 13, -1, -1, -1, -1, -1, -1, -1, 15]
    assert sizes.tolist() == recv


def test_slot_size():
    assert td.slot_size(2048, 4) == 1024
    assert td.slot_size(100, 4) == 256  # at least MIN_CHUNK
    assert td.slot_size(1000, 3) == 1024
