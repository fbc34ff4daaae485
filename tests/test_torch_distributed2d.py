"""The port's overlap exchange, 2-D dcn/ici tier and scaling reports
(`parallel/distributed.py`, `parallel/scaling.py`) on one world of 8 gloo
CPU ranks, against the JAX package on its 8-device CPU mesh.

One world is spawned for the module (start method spawn, a file store in a
temporary directory). Inside it, `dist.new_group` subgroups serve as 1-D
worlds of 3 and 4 ranks, and `make_mesh_2d` as the 2x4 and 4x2 meshes of
the JAX fixture and a 2x2 mesh on ranks 0-3. Each rank runs every case of
CASES it belongs to through the public entry points and writes its output
shard, the kernels it launched (the launch recorder's names) and any
error; each test joins the shards and holds them against the JAX
`sort_sharded` / `sort_pairs_sharded` on `make_mesh_2d(H, C)` /
`make_mesh(D)`. The port runs its kernels' plain versions
(use_kernels=True on CPU tensors) at chunk 2^10. The JAX side runs as its
own tests run it: use_pallas=False, except two 1-D cases in interpret mode
(`SortConfig(chunk=1<<10, interpret=True)`), an overlap keys case whose
half merge is a lone local pass (np2 == C) and an overlap + merge case.
Data from `utils.datagen` with fixed seeds. Tolerance: bitwise equality.
"""

import json
import threading
from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from vulkan_radix_sort_tpu.config import SortConfig as JaxConfig
from vulkan_radix_sort_tpu.parallel import distributed as jdist
from vulkan_radix_sort_tpu.parallel import scaling as jscaling
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.parallel import distributed as td
from vulkan_radix_sort_tpu_torch.parallel import scaling
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

WORLD = 8
CHUNK = 1 << 10
# mesh name -> (H, C) of a 2-D mesh, or D of a 1-D world of ranks 0..D-1
MESHES = {"2x4": (2, 4), "4x2": (4, 2), "2x2": (2, 2), "1d4": 4, "1d3": 3}
N2 = WORLD * 1024
REPORT_N = 8 * 1024


def _cases() -> dict:
    """name -> mesh, keys (dist, n, seed), kv, the port's options, the JAX
    reference's (`jax`: interpret mode), and launch expectations."""
    c = {}
    for mesh in ("2x4", "4x2"):  # tests/test_distributed.py:225-317
        for dist_ in ("uniform", "zipf", "constant"):
            c[f"{mesh}_keys_{dist_}"] = dict(mesh=mesh, dist=dist_, n=N2,
                                             seed=41)
        c[f"{mesh}_kv_stable"] = dict(mesh=mesh, dist="mod7", n=N2, seed=42,
                                      kv=True)
        for dist_ in ("uniform", "constant"):
            c[f"{mesh}_overlap_keys_{dist_}"] = dict(
                mesh=mesh, dist=dist_, n=N2, seed=45, overlap=True)
        c[f"{mesh}_overlap_kv_max"] = dict(mesh=mesh, dist="max9", n=N2,
                                           seed=46, kv=True, overlap=True)
        c[f"{mesh}_ragged_count"] = dict(mesh=mesh, dist="uniform",
                                         n=N2 - 133, seed=43, count=997)
        c[f"{mesh}_merge_kv"] = dict(mesh=mesh, dist="dups", n=N2, seed=42,
                                     kv=True, merge_resort=True)
    c.update({
        "2x4_merge_keys": dict(mesh="2x4", dist="uniform", n=N2, seed=41,
                               merge_resort=True),
        "2x4_skew_slack1": dict(mesh="2x4", dist="skew", n=N2, dcn_slack=1,
                                error="dcn_slack"),
        "2x4_skew_adaptive": dict(mesh="2x4", dist="skew", n=N2),
        "2x4_skew_overlap": dict(mesh="2x4", dist="skew", n=N2,
                                 overlap=True),
        "2x4_merge_overlap": dict(mesh="2x4", dist="uniform", n=N2, seed=41,
                                  overlap=True, merge_resort=True,
                                  error="1-D"),
        "2x2_keys": dict(mesh="2x2", dist="uniform", n=4 * 1024, seed=41),
        "2x2_kv": dict(mesh="2x2", dist="mod7", n=4 * 1024, seed=42,
                       kv=True),
        # m = 2: the ranks hold 2, 2, 1 and 0 keys
        "2x2_short_and_empty": dict(mesh="2x2", dist="uniform", n=5,
                                    seed=34),
        "2x2_short_and_empty_overlap": dict(mesh="2x2", dist="uniform", n=5,
                                            seed=34, overlap=True),
        # tests/test_distributed.py:107-160 and :496-560 on 4 and 3 ranks
        "1d4_overlap_keys_small": dict(
            mesh="1d4", dist="uniform", n=4 * 512, seed=29, overlap=True,
            merge_resort=False, jax="interpret", launches={"local": 1}),
        "1d4_overlap_merge_keys": dict(
            mesh="1d4", dist="uniform", n=4 * 1024, seed=43, overlap=True,
            merge_resort=True, jax="interpret", gated=True),
        "1d4_overlap_keys_uniform": dict(
            mesh="1d4", dist="uniform", n=4 * 2048, seed=26, overlap=True,
            merge_resort=False, launches={"cross": 1, "local": 1}),
        "1d4_overlap_keys_constant": dict(
            mesh="1d4", dist="constant", n=4 * 2048, seed=26, overlap=True,
            merge_resort=False, launches={"cross": 1, "local": 1}),
        "1d4_overlap_kv_max": dict(mesh="1d4", dist="max50", n=4 * 1024,
                                   seed=31, kv=True, overlap=True),
        "1d4_overlap_kv_count": dict(mesh="1d4", dist="few", n=4 * 1024,
                                     seed=32, kv=True, overlap=True,
                                     count=3000),
        "1d4_overlap_merge_kv_max": dict(
            mesh="1d4", dist="dups_max", n=4 * 1024, seed=44, kv=True,
            overlap=True, merge_resort=True, gated=True),
        "1d4_short_and_empty_overlap": dict(mesh="1d4", dist="uniform", n=5,
                                            seed=34, overlap=True),
        "1d4_short_and_empty_overlap_kv": dict(
            mesh="1d4", dist="uniform", n=5, seed=34, kv=True, overlap=True),
        "1d3_overlap_merge_keys": dict(
            mesh="1d3", dist="uniform", n=3 * 1500, seed=45, overlap=True,
            merge_resort=True, gated=True),
        "1d3_overlap_merge_kv": dict(
            mesh="1d3", dist="mod4", n=3 * 1500, seed=45, kv=True,
            overlap=True, merge_resort=True, gated=True),
    })
    for dist_ in ("uniform", "constant", "few"):
        c[f"1d4_overlap_kv_{dist_}"] = dict(mesh="1d4", dist=dist_,
                                           n=4 * 2048, seed=30, kv=True,
                                           overlap=True)
    return c


CASES = _cases()


def _data(case):
    """(keys, values) of a case, made with numpy from its seed."""
    n, dist_, seed = case["n"], case["dist"], case.get("seed", 0)
    if dist_ == "skew":  # tests/test_distributed.py:279-292
        m = n // WORLD
        rng = np.random.default_rng(44)
        keys = np.full(n, 0xF0000000, np.uint32)
        keys[:m] = rng.integers(0, 1000, m).astype(np.uint32)
        keys[4 * m:5 * m] = rng.integers(0, 1000, m).astype(np.uint32)
    elif dist_.startswith("max"):  # genuine max keys among few others
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, int(dist_[3:]), n).astype(np.uint32)
        keys[rng.random(n) < 0.25] = 0xFFFFFFFF
    else:
        base = "uniform" if dist_ in ("mod7", "mod4", "dups", "dups_max") \
            else dist_
        keys = datagen.generate_keys(n, seed=seed, distribution=base)
        if dist_ == "mod7":
            keys %= np.uint32(7)
        elif dist_ == "mod4":
            keys = (keys & np.uint32(3)) * np.uint32(0x40000001)
        elif dist_.startswith("dups"):
            keys = (keys & np.uint32(0xF)) * np.uint32(0x11111111)
            if dist_ == "dups_max":
                keys[np.random.default_rng(seed).random(n) < 0.1] = \
                    0xFFFFFFFF
    return keys, np.arange(n, dtype=np.uint32)


def _ranks(mesh: str) -> int:
    spec = MESHES[mesh]
    return spec if isinstance(spec, int) else spec[0] * spec[1]


def _shard(rank, n, d):
    m = -(-n // d)
    return min(rank * m, n), min((rank + 1) * m, n)


def _flat_sizes(keys, d):
    """The exact plan's (d src, d dst) size matrix from the global keys:
    destination r owns stable-sorted positions [r*m, (r+1)*m)."""
    m = -(-keys.size // d)
    padded = np.full(d * m, 0xFFFFFFFF, np.uint32)
    padded[:keys.size] = keys
    src = np.argsort(padded, kind="stable") // m
    dst = np.arange(d * m) // m
    sizes = np.zeros((d, d), np.int64)
    np.add.at(sizes, (src, dst), 1)
    return sizes


def _overflowing_seed(n, H, C):
    """The first seed whose uniform keys overflow a hop-A staging buffer
    of one shard on an H x C mesh (dcn_report's refusal)."""
    seed = 0
    while td._staging_need(_flat_sizes(datagen.generate_keys(n, seed=seed),
                                       H * C).tolist(), H, C) <= n // (H * C):
        seed += 1
    return seed


def _world(rank, world, tmp):
    """One rank: the groups and meshes (every rank, in one order), then
    every case it belongs to, then the reports."""
    torch.set_num_threads(1)
    groups = {"1d3": dist.new_group([0, 1, 2]),
              "1d4": dist.new_group([0, 1, 2, 3])}
    groups["2x4"] = td.make_mesh_2d(2, 4)
    groups["4x2"] = td.make_mesh_2d(4, 2)
    groups["2x2"] = td.make_mesh_2d(2, 2, group=groups["1d4"])
    meta = {"2x2_member": groups["2x2"] is not None}
    try:
        td.make_mesh_2d(3)
    except ValueError as e:
        meta["3_hosts_error"] = str(e)
    cfg = SortConfig(chunk=CHUNK)
    for name, case in CASES.items():
        d = _ranks(case["mesh"])
        if rank >= d:
            continue
        keys, vals = _data(case)
        lo, hi = _shard(rank, case["n"], d)
        k = torch.from_numpy(keys[lo:hi].copy())
        v = torch.from_numpy(vals[lo:hi].copy())
        kw = dict(group=groups[case["mesh"]], config=cfg,
                  count=case.get("count"), use_kernels=True,
                  overlap=case.get("overlap", False),
                  merge_resort=case.get("merge_resort"),
                  dcn_slack=case.get("dcn_slack"))
        result = {}
        with timing.LaunchTimer() as timer:
            try:
                if case.get("kv"):
                    gk, gv = td.sort_pairs_sharded(k, v, **kw)
                    np.save(f"{tmp}/{name}_{rank}_v.npy", gv.numpy())
                else:
                    gk = td.sort_sharded(k, **kw)
                np.save(f"{tmp}/{name}_{rank}_k.npy", gk.numpy())
            except ValueError as e:
                result["error"] = str(e)
        result["launches"] = Counter(n for rec in timer.records
                                     for n in rec["names"])
        with open(f"{tmp}/{name}_{rank}.json", "w") as f:
            json.dump(result, f)
    reports = {}
    if rank < 4:
        reports["phase"] = scaling.phase_report(
            groups["1d4"], 4 * 1024, config=cfg, use_kernels=True, iters=1,
            device="cpu")
        reports["phase_overlap"] = scaling.phase_report(
            groups["1d4"], 4 * 1024, overlap=True, iters=1, device="cpu")
        try:
            scaling.phase_report(groups["2x2"], 4 * 1024, device="cpu")
        except ValueError as e:
            reports["phase_2d_error"] = str(e)
    reports["dcn"] = scaling.dcn_report(groups["2x4"], REPORT_N, iters=1,
                                        device="cpu")
    try:
        scaling.dcn_report(groups["2x4"], REPORT_N, dcn_slack=1,
                           seed=_overflowing_seed(REPORT_N, 2, 4), iters=1,
                           device="cpu")
    except ValueError as e:
        reports["dcn_error"] = str(e)
    reports["scaling"] = scaling.scaling_report(1024, [1, 2, 4], iters=1,
                                                device="cpu")
    with open(f"{tmp}/meta_{rank}.json", "w") as f:
        json.dump({**meta, "reports": reports}, f)


@pytest.fixture(scope="module")
def started_world(tmp_path_factory):
    """The world, spawned from a thread so that the JAX reports of
    `jax_dcn` run while it does."""
    tmp = tmp_path_factory.mktemp("world2d")
    errors = []

    def run():
        try:
            td.spawn_world(_world, WORLD, str(tmp),
                           init_file=str(tmp / "store"), timeout_s=300)
        except Exception as e:  # re-raised by `world`
            errors.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    return tmp, thread, errors


@pytest.fixture(scope="module")
def jax_dcn(started_world):
    """The JAX dcn_report on the 2x4 mesh, and its refusal of dcn_slack=1
    on keys that overflow it (the error)."""
    mesh = jdist.make_mesh_2d(2, 4)
    rep = jscaling.dcn_report(mesh, REPORT_N, use_pallas=False, iters=1)
    with pytest.raises(ValueError, match="dcn_slack") as refused:
        jscaling.dcn_report(mesh, REPORT_N, use_pallas=False, dcn_slack=1,
                            seed=_overflowing_seed(REPORT_N, 2, 4), iters=1)
    return rep, str(refused.value)


@pytest.fixture(scope="module")
def world(started_world, jax_dcn):
    tmp, thread, errors = started_world
    thread.join(timeout=600)
    assert not thread.is_alive()
    if errors:
        raise errors[0]
    return tmp


def _result(tmp, name, rank):
    with open(tmp / f"{name}_{rank}.json") as f:
        return json.load(f)


def _meta(tmp, rank):
    with open(tmp / f"meta_{rank}.json") as f:
        return json.load(f)


def _joined(tmp, name, what="k"):
    d = _ranks(CASES[name]["mesh"])
    return np.concatenate([np.load(tmp / f"{name}_{r}_{what}.npy")
                           for r in range(d)])


def _jax_mesh(mesh):
    spec = MESHES[mesh]
    if isinstance(spec, int):
        return jdist.make_mesh(spec)
    return jdist.make_mesh_2d(*spec)


def _jax(case, **extra):
    """The JAX package's answer: use_pallas=False, or in interpret mode
    with the port's merge_resort where the case asks."""
    keys, vals = _data(case)
    kw = dict(count=case.get("count"), overlap=case.get("overlap", False),
              **extra)
    if case.get("jax") == "interpret":
        kw.update(config=JaxConfig(chunk=CHUNK, interpret=True),
                  use_pallas=True, merge_resort=case.get("merge_resort"))
    else:
        kw["use_pallas"] = False
    if "dcn_slack" in case:
        kw["dcn_slack"] = case["dcn_slack"]
    mesh = _jax_mesh(case["mesh"])
    if case.get("kv"):
        k, v = jdist.sort_pairs_sharded(jnp.asarray(keys), jnp.asarray(vals),
                                        mesh, **kw)
        return np.asarray(k), np.asarray(v)
    return np.asarray(jdist.sort_sharded(jnp.asarray(keys), mesh, **kw)),


SORTED = [name for name, case in CASES.items() if "error" not in case]


@pytest.mark.parametrize("name", SORTED)
def test_matches_jax(world, name):
    """Every sort bitwise equal to the JAX package's on the same mesh
    shape, and (a check of both) to numpy's stable order."""
    case = CASES[name]
    keys, vals = _data(case)
    want = _jax(case)
    got = [_joined(world, name, w) for w in ("k", "v")[:len(want)]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    c = case.get("count", case["n"])
    order = np.argsort(keys[:c], kind="stable")
    np.testing.assert_array_equal(got[0][:c], keys[:c][order])
    np.testing.assert_array_equal(got[0][c:], keys[c:])
    if case.get("kv"):
        np.testing.assert_array_equal(got[1][:c], vals[:c][order])


@pytest.mark.parametrize("name", [n for n in SORTED
                                  if "launches" in CASES[n]
                                  or "gated" in CASES[n]])
def test_launches(world, name):
    """The overlap keys merge runs K3 and K4 once a rank beyond the local
    sorts (a lone K4 where np2 == C: the JAX `_run_local(r=0)` case), and
    every merge case runs the gated local kernel on every rank."""
    case = CASES[name]
    want = {"cross": 0, "local": 0, **case.get("launches", {})}
    for r in range(_ranks(case["mesh"])):
        got = _result(world, name, r)["launches"]
        if "launches" in case:
            assert {k: got.get(k, 0) for k in want} == want, (r, got)
        if case.get("gated"):
            assert got.get("local_gated", 0) > 0, (r, got)


@pytest.mark.parametrize("mesh", ["2x4", "4x2"])
def test_2d_merge_and_fallback(world, mesh):
    """The 2-D slot merge runs K6 on every rank; constant keys overflow
    the slots and fall back to the full re-sort (chunk twice, no K6)."""
    for r in range(WORLD):
        merged = _result(world, f"{mesh}_keys_uniform", r)["launches"]
        assert merged.get("local_gated", 0) > 0 and merged["chunk"] == 1
        fell = _result(world, f"{mesh}_keys_constant", r)["launches"]
        assert fell.get("local_gated", 0) == 0 and fell["chunk"] == 2


@pytest.mark.parametrize("name,match", [("2x4_skew_slack1", "dcn_slack"),
                                        ("2x4_merge_overlap", "1-D")])
def test_refusals_as_jax(world, name, match):
    """An explicit dcn_slack whose staging overflows, and merge_resort=True
    with overlap on a 2-D mesh, raise ValueError on every rank, as in the
    JAX package."""
    for r in range(WORLD):
        assert match in _result(world, name, r)["error"]
    case = CASES[name]
    keys, _ = _data(case)
    kw = dict(use_pallas=False, dcn_slack=case.get("dcn_slack"))
    if case.get("merge_resort"):  # JAX refuses it before any program
        kw = dict(config=JaxConfig(chunk=CHUNK, interpret=True),
                  use_pallas=True, merge_resort=True)
    with pytest.raises(ValueError, match="dcn_slack|1-D meshes only"):
        jdist.sort_sharded(jnp.asarray(keys), _jax_mesh(case["mesh"]),
                           overlap=case.get("overlap", False), **kw)


def test_mesh_membership_and_shape(world):
    """Ranks 4-7 are outside the 2x2 mesh of ranks 0-3 and get None; a
    mesh that does not cover the group raises on every rank."""
    for r in range(WORLD):
        meta = _meta(world, r)
        assert meta["2x2_member"] == (r < 4)
        assert "does not cover" in meta["3_hosts_error"]


JAX_PHASE_KEYS = {"n", "devices", "local_sort_s", "exchange_s", "resort_s",
                  "full_s", "overlap_hidden_s", "exchange_fraction",
                  "overlap_mode", "use_kernels"}


def test_phase_report(world):
    """The JAX report's keys (use_kernels for use_pallas), the same on
    every rank; full_merge_s with the kernels and no overlap; a 2-D mesh
    refused."""
    reps = [_meta(world, r)["reports"] for r in range(4)]
    for rep in reps:
        assert rep == reps[0]
    plain, over = reps[0]["phase"], reps[0]["phase_overlap"]
    assert set(plain) == JAX_PHASE_KEYS | {"full_merge_s"}
    assert set(over) == JAX_PHASE_KEYS
    assert plain["devices"] == 4 and plain["n"] == 4 * 1024
    assert over["overlap_mode"] and not over["use_kernels"]
    parts = sum(over[k] for k in ("local_sort_s", "exchange_s",
                                  "resort_s"))
    assert over["overlap_hidden_s"] == pytest.approx(parts - over["full_s"])
    assert "dcn_report" in reps[0]["phase_2d_error"]


def test_dcn_report_bytes_match_jax(world, jax_dcn):
    """The byte and message counts equal the JAX dcn_report's for the same
    n, seed and mesh, and the plan's own from numpy; the rest of its
    keys."""
    rep = _meta(world, 0)["reports"]["dcn"]
    for r in range(1, WORLD):
        assert _meta(world, r)["reports"]["dcn"] == rep
    want = {k: v for k, v in jax_dcn[0].items() if k != "use_pallas"}
    assert set(rep) == set(want) | {"use_kernels"}
    for k in ("dcn_bytes", "hop_b_ici_bytes", "dcn_messages_per_chip",
              "flat_dcn_messages_per_chip", "dcn_slack", "n"):
        assert rep[k] == want[k], k
    assert tuple(rep["mesh"]) == want["mesh"]
    s4 = _flat_sizes(datagen.generate_keys(REPORT_N, seed=0),
                     8).reshape(2, 4, 2, 4)
    assert rep["dcn_bytes"] == 4 * (s4[0, :, 1].sum() + s4[1, :, 0].sum())


def test_dcn_report_refuses_overflowing_slack(world, jax_dcn):
    """dcn_slack=1 on keys whose staging needs more: ValueError on every
    rank, as the JAX report raises."""
    for r in range(WORLD):
        assert "dcn_slack=1" in _meta(world, r)["reports"]["dcn_error"]
    assert "dcn_slack=1" in jax_dcn[1]


def test_scaling_report(world):
    """Rows for 1, 2 and 4 ranks, t(1)/t(d) as weak_efficiency, the same
    on every rank of the world."""
    rows = _meta(world, 0)["reports"]["scaling"]
    for r in range(1, WORLD):
        assert _meta(world, r)["reports"]["scaling"] == rows
    assert [row["devices"] for row in rows] == [1, 2, 4]
    assert [row["n"] for row in rows] == [1024, 2048, 4096]
    assert rows[0]["weak_efficiency"] == 1.0
    for row in rows:
        assert row["weak_efficiency"] == pytest.approx(
            rows[0]["full_s"] / row["full_s"])
        assert set(row) == JAX_PHASE_KEYS | {"weak_efficiency"}


# -- without a world ----------------------------------------------------------

def _halves(m, seed, pad=0, max_share=0.0):
    """Two ascending m-key halves whose genuine prefixes hold m keys in all
    (the rest 0xFFFFFFFF fill), with genuine max keys at the seam."""
    rng = np.random.default_rng(seed)
    r_a = m // 2 - pad
    keys = rng.integers(0, 40, m).astype(np.uint32)
    keys[rng.random(m) < max_share] = 0xFFFFFFFF
    vals = np.arange(m, dtype=np.uint32)
    out = []
    for k, v in ((keys[:r_a], vals[:r_a]), (keys[r_a:], vals[r_a:])):
        o = np.argsort(k, kind="stable")
        kk = np.full(m, 0xFFFFFFFF, np.uint32)
        vv = np.zeros(m, np.uint32)
        kk[:k.size], vv[:k.size] = k[o], v[o]
        out += [kk, vv]
    return keys, vals, r_a, out


@pytest.mark.parametrize("r_a_pad", [0, 100])
def test_stable_merge_valid_max_keys_at_the_seam(r_a_pad):
    """Genuine 0xFFFFFFFF keys at the end of both genuine prefixes, next to
    the fill: every one kept with its value, A's before B's, as the JAX
    `_stable_merge_valid` and numpy's stable order give them."""
    m = 1000
    keys, vals, r_a, (kA, vA, kB, vB) = _halves(m, 5, r_a_pad, 0.3)
    t = [torch.from_numpy(x) for x in (kA, vA, kB, vB)]
    ko, vo = td._stable_merge_valid(t[0], t[1], r_a, t[2], t[3])
    jk, jv = jdist._stable_merge_valid(*map(jnp.asarray, (kA, vA)), r_a,
                                       *map(jnp.asarray, (kB, vB)), True)
    np.testing.assert_array_equal(ko.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vo.numpy(), np.asarray(jv))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ko.numpy(), keys[order])
    np.testing.assert_array_equal(vo.numpy(), vals[order])


@pytest.mark.parametrize("m,want", [(512, {"local": 1}),
                                    (1000, {"cross": 1, "local": 1}),
                                    (1024, {"cross": 1, "local": 1})],
                         ids=["np2_eq_C", "np2_gt_C_padded", "np2_gt_C"])
def test_bitonic_merge_halves_as_jax(m, want):
    """The half merge (the top merge round over [A | pad | flip(B)]) at
    np2 == C (a lone local pass: JAX `_run_local(..., r=0)`) and np2 > C
    (one cross span and the local pass), bitwise as the JAX
    `_bitonic_merge_halves` in interpret mode and as a plain sort."""
    keys, _, _, (kA, _, kB, _) = _halves(m, 7, 0, 0.05)
    with timing.LaunchTimer() as timer:
        got = td._bitonic_merge_halves(torch.from_numpy(kA),
                                       torch.from_numpy(kB),
                                       SortConfig(chunk=CHUNK)).numpy()
    assert Counter(n for rec in timer.records for n in rec["names"]) == want
    jax_got = jdist._bitonic_merge_halves(
        jnp.asarray(kA), jnp.asarray(kB),
        JaxConfig(chunk=CHUNK, interpret=True), True)
    np.testing.assert_array_equal(got, np.asarray(jax_got))
    np.testing.assert_array_equal(got, np.sort(keys))


def test_merge_keys_halves_below_the_smallest_chunk():
    """2m below MIN_CHUNK: a plain sort of both halves, no launch."""
    keys, _, _, (kA, _, kB, _) = _halves(100, 9)
    with timing.LaunchTimer() as timer:
        got = td._merge_keys_halves(torch.from_numpy(kA),
                                    torch.from_numpy(kB), None, True)
    assert not timer.records
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def test_staging_need_and_slack():
    """The fullest staging buffer from the size matrix, and the slack
    rule: explicit values checked, None the first of min(2, cap) doubled
    up to cap = min(H, C) that holds it."""
    sizes = np.zeros((8, 8), np.int64)
    sizes[0, 0:4] = sizes[4, 0:4] = 10  # (h, i=0) -> host 0, both hosts
    # staging rank (0, 0) gets both hosts' index-0 sends to host 0
    assert td._staging_need(sizes.tolist(), 2, 4) == 80
    assert td._pick_slack(80, 40, 2, 4, None) == 2  # cap 2 always holds
    assert td._pick_slack(15, 10, 4, 4, None) == 2
    assert td._pick_slack(25, 10, 4, 4, None) == 4
    assert td._pick_slack(25, 10, 8, 8, None) == 4
    assert td._pick_slack(5, 10, 3, 3, 1) == 1
    with pytest.raises(ValueError, match="dcn_slack=1"):
        td._pick_slack(11, 10, 2, 4, 1)
