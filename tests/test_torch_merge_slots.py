"""The port's slot merges (`merge_slots_u32`, `merge_slots_pairs`) and its
gated local kernel K6 against the JAX package's.

On the CPU the port runs each kernel's plain version; the JAX side runs its
Pallas kernels in interpret mode (`.__wrapped__(..., interpret=True)`, K6
through `_block_call_dma_gated`). Same numpy-seeded slot buffers: 8 slots
of 512 at chunk 256, with empty and full slots and slots cut mid-block in
both parities, and genuine 0xFFFFFFFF keys in front of the fills.
Tolerance: bitwise equality of keys and values (the stable tiebreak word
is not compared: its encoding differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.ops import bitonic as jbit
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk

N_SLOTS, S, CHUNK = 8, 512, 256
LANES = 128


def _runs(seed: int, kind: str = "keys"):
    """Sorted runs with the sizes of a slack-2 exchange, plus slots that
    are empty (0 even, 1 odd), full (2 even, 5 odd) and cut mid-block (3,
    6); one key in five is a genuine 0xFFFFFFFF. Values are the slot-major
    running index."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(S // 4, 3 * S // 4, N_SLOTS)
    sizes[[0, 1, 2, 5, 3, 6]] = [0, 0, S, S, 300, 17]
    runs, vals, base = [], [], 0
    for size in sizes:
        k = rng.integers(0, 2**32, size, dtype=np.uint64).astype(np.uint32)
        if kind == "dups":
            k %= np.uint32(11)
        k[rng.random(size) < 0.2] = 0xFFFFFFFF
        runs.append(np.sort(k))
        vals.append(np.arange(base, base + size, dtype=np.uint32))
        base += size
    return runs, vals, sizes


def _buffer(runs, fill: int, prearranged: bool) -> np.ndarray:
    buf = np.full((len(runs), S), fill, np.uint32)
    for s, run in enumerate(runs):
        if prearranged and s & 1:
            buf[s, S - run.size:] = run[::-1]
        else:
            buf[s, :run.size] = run
    return buf.reshape(-1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("prearranged", [False, True])
@pytest.mark.parametrize("with_sizes", [False, True])
def test_merge_slots_u32_matches_jax(with_sizes, prearranged):
    runs, _, sizes = _runs(1 + 2 * with_sizes + prearranged)
    buf = _buffer(runs, 0xFFFFFFFF, prearranged)
    got = tbit.merge_slots_u32(_t(buf), _t(sizes) if with_sizes else None,
                               slot=S, chunk=CHUNK,
                               prearranged=prearranged).numpy()
    want = np.asarray(jbit.merge_slots_u32.__wrapped__(
        jnp.asarray(buf),
        jnp.asarray(sizes.astype(np.int32)) if with_sizes else None,
        slot=S, chunk=CHUNK, interpret=True, prearranged=prearranged))
    np.testing.assert_array_equal(got, want)
    allk = np.concatenate(runs)
    np.testing.assert_array_equal(got[:allk.size], np.sort(allk))


@pytest.mark.parametrize("prearranged", [False, True])
@pytest.mark.parametrize("stable", [True, False])
def test_merge_slots_pairs_matches_jax(stable, prearranged):
    runs, vals, sizes = _runs(5 + 2 * stable + prearranged, kind="dups")
    kbuf = _buffer(runs, 0xFFFFFFFF, prearranged)
    vbuf = _buffer(vals, 0 if stable else 0xFFFFFFFF, prearranged)
    gk, gv = tbit.merge_slots_pairs(_t(kbuf), _t(vbuf), _t(sizes), slot=S,
                                    chunk=CHUNK, stable=stable,
                                    prearranged=prearranged)
    wk, wv = jbit.merge_slots_pairs.__wrapped__(
        jnp.asarray(kbuf), jnp.asarray(vbuf),
        jnp.asarray(sizes.astype(np.int32)), slot=S, chunk=CHUNK,
        interpret=True, stable=stable, prearranged=prearranged)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    allk, allv = np.concatenate(runs), np.concatenate(vals)
    order = (np.argsort(allk, kind="stable") if stable
             else np.lexsort((allv, allk)))
    np.testing.assert_array_equal(gk.numpy()[:allk.size], allk[order])
    np.testing.assert_array_equal(gv.numpy()[:allk.size], allv[order])


@pytest.mark.parametrize("mode_name", ["keys", "stable"])
def test_local_gated_matches_jax_dma_gated(mode_name):
    """K6: the gated local pass bitwise equal to the JAX package's
    DMA-gated block call (interpret mode) on a merge round's input, with
    gated blocks left as they are."""
    assert jbit.DMA_GATE
    C, r = 256, 2
    rng = np.random.default_rng(11)
    n = 4096
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) % 97
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    idx = np.arange(n, dtype=np.uint32)
    valid = np.ones(n // C, np.int32)
    valid[[0, 3, 4, 9, 15]] = 0
    if mode_name == "keys":
        port, jarrs, mode, jmode, cmp = [k], [k], bk.KEYS, jbit.MODE_KEYS, [0]
    else:
        port, jarrs = [k, idx, v], [k, idx << np.uint32(7), v]
        mode, jmode, cmp = bk.STABLE, jbit.MODE_PACKED, [0, 2]
    port = [_t(a.copy()) for a in port]
    bk.local_gated(port, mode, C, r, n // C, _t(valid))
    out = jbit._run_local([jnp.asarray(a.reshape(-1, LANES)) for a in jarrs],
                          C, r, jmode, True, valid=jnp.asarray(valid))
    for i in cmp:
        np.testing.assert_array_equal(port[i].numpy(),
                                      np.asarray(out[i]).reshape(-1))
    for b in np.flatnonzero(valid == 0):  # gated blocks untouched
        np.testing.assert_array_equal(port[0].numpy()[b * C:(b + 1) * C],
                                      k[b * C:(b + 1) * C])


@pytest.mark.parametrize("seed", range(6))
def test_gated_blocks_hold_only_fill(monkeypatch, seed):
    """The count tracking never gates a block that holds a genuine element:
    before every K6 launch each gated C-block is pure fill (key
    0xFFFFFFFF and pad tiebreak), across random slot sizes of both
    parities (ROADMAP queue 3, skip granularity). Checked on the stable
    carry, whose tiebreak tells fills from genuine 0xFFFFFFFF keys."""
    rng = np.random.default_rng(100 + seed)
    n_slots, slot, C = 16, 1024, 256
    sizes = rng.integers(0, slot + 1, n_slots)
    sizes[rng.random(n_slots) < 0.25] = 0
    sizes[rng.random(n_slots) < 0.25] = slot
    kbuf = np.full((n_slots, slot), 0xFFFFFFFF, np.uint32)
    for s, size in enumerate(sizes):
        run = np.sort(rng.integers(0, 5, size).astype(np.uint32))
        run[rng.random(size) < 0.3] = 0xFFFFFFFF
        kbuf[s, :size] = np.sort(run)
    launches = []
    real = bk.run

    def spy(launch, arrs, mode, nunits, valid=None):
        if launch.kernel == "local_gated":
            aux = arrs[1].view(torch.int32).view(-1, C)
            gated = valid[:nunits] == 0
            assert bool((aux[gated] == tbit.STABLE_PAD_IDX).all())
            launches.append(int(gated.sum()))
        real(launch, arrs, mode, nunits, valid)

    monkeypatch.setattr(bk, "run", spy)
    vbuf = np.zeros_like(kbuf)
    gk, _ = tbit.merge_slots_pairs(_t(kbuf.reshape(-1)), _t(vbuf.reshape(-1)),
                                   _t(sizes), slot=slot, chunk=C)
    assert len(launches) == 4  # rounds 3..6
    allk = np.concatenate([kbuf[s, :size] for s, size in enumerate(sizes)])
    np.testing.assert_array_equal(gk.numpy()[:allk.size], np.sort(allk))


def test_merge_launches_k6_only_with_sizes(monkeypatch):
    """With sizes the local passes are K6 (each with a per-block mask) and
    the cross passes carry the group mask; without, they are K4, ungated."""
    calls = []
    real = bk.run

    def spy(launch, arrs, mode, nunits, valid=None):
        calls.append((launch.kernel, valid is not None))
        real(launch, arrs, mode, nunits, valid)

    monkeypatch.setattr(bk, "run", spy)
    runs, _, sizes = _runs(9)
    buf = _t(_buffer(runs, 0xFFFFFFFF, False))
    tbit.merge_slots_u32(buf, _t(sizes), slot=S, chunk=CHUNK)
    assert {c for c in calls} == {("cross", True), ("local_gated", True)}
    assert calls.count(("local_gated", True)) == 3  # rounds 2..4
    calls.clear()
    tbit.merge_slots_u32(buf, None, slot=S, chunk=CHUNK)
    assert {c for c in calls} == {("cross", False), ("local", False)}


def test_slot_merge_rejects_bad_input():
    k = torch.zeros(N_SLOTS * S, dtype=torch.int32).view(torch.uint32)
    sizes = torch.zeros(N_SLOTS, dtype=torch.int64)
    with pytest.raises(ValueError):  # 3 slots is not a power of two
        tbit.merge_slots_u32(k[:3 * S], slot=S)
    with pytest.raises(ValueError):  # slot below the minimum chunk
        tbit.merge_slots_u32(k, slot=128)
    with pytest.raises(ValueError):  # a size per slot
        tbit.merge_slots_u32(k, sizes[:-1], slot=S)
    with pytest.raises(ValueError):  # key-value needs the sizes
        tbit.merge_slots_pairs(k, k.clone(), None, slot=S)
    with pytest.raises(ValueError):  # stable chunk over the smem cap
        tbit.merge_slots_pairs(k, k.clone(), sizes, slot=S, chunk=1 << 15)
    with pytest.raises(ValueError):  # K6 always carries a mask
        bk.local_gated([k], bk.KEYS, CHUNK, 1, 4, None)
    meta = torch.zeros(N_SLOTS, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):  # sizes on another device
        tbit.merge_slots_u32(k, meta, slot=S)
