"""The port's network sort (`sort_u32`, `sort_pairs_u32`) against the JAX
package's, which runs its Pallas kernels in interpret mode.

Inputs are numpy-seeded; on the CPU the port runs each kernel's plain
version. Tolerance: bitwise equality. Shapes cover ragged n, n = 2^k, heavy
duplicates, genuine 0xFFFFFFFF keys, `count=`, and the unfused
cross + local path with the fused-group limit lowered, on the shapes of
`tests/test_bitonic.py::test_unfused_trailing_skip_escape`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.ops import bitonic as jbit
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit

CHUNK = 1 << 10


def _keys(n, seed, kind):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "dups":
        k %= np.uint32(61)
        k[rng.random(n) < 0.1] = 0xFFFFFFFF
    elif kind == "max":
        k[::3] = 0xFFFFFFFF
    return k


def _vals(n, seed):
    return np.random.default_rng(seed + 100).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kind", ["uniform", "dups", "max"])
@pytest.mark.parametrize("n", [100, 3000, 1 << 12])
def test_sort_u32_matches_jax(n, kind):
    keys = _keys(n, n, kind)
    got = tbit.sort_u32(_t(keys), chunk=CHUNK).numpy()
    want = np.asarray(jbit.sort_u32(jnp.asarray(keys), chunk=CHUNK,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "dups", "max"])
@pytest.mark.parametrize("n", [2311, 1 << 12])
def test_sort_pairs_matches_jax(n, kind, stable):
    keys, vals = _keys(n, n + 1, kind), _vals(n, n)
    gk, gv = tbit.sort_pairs_u32(_t(keys), _t(vals), chunk=CHUNK,
                                 stable=stable)
    wk, wv = jbit.sort_pairs_u32(jnp.asarray(keys), jnp.asarray(vals),
                                 chunk=CHUNK, interpret=True, stable=stable)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    order = (np.argsort(keys, kind="stable") if stable
             else np.lexsort((vals, keys)))
    np.testing.assert_array_equal(gv.numpy(), vals[order])


@pytest.mark.parametrize("count_kind", ["int", "tensor"])
def test_sort_u32_count_matches_jax(count_kind):
    """count=: units past the live prefix are gated; the caller has masked
    keys[count:] to 0xFFFFFFFF, and the first count outputs are exact."""
    n, count = 1 << 12, 1901
    keys = _keys(n, 11, "dups")
    masked = keys.copy()
    masked[count:] = 0xFFFFFFFF
    cnt = count if count_kind == "int" else torch.tensor(count)
    got = tbit.sort_u32(_t(masked), cnt, chunk=CHUNK).numpy()
    want = np.asarray(jbit.sort_u32(jnp.asarray(masked), jnp.uint32(count),
                                    chunk=CHUNK, interpret=True))
    np.testing.assert_array_equal(got[:count], want[:count])
    np.testing.assert_array_equal(got[:count], np.sort(keys[:count]))


@pytest.mark.parametrize("stable", [True, False])
def test_sort_pairs_count_matches_jax(stable):
    n, count = 3000, 1234
    keys, vals = _keys(n, 12, "dups"), _vals(n, 12)
    mk, mv = keys.copy(), vals.copy()
    mk[count:] = 0xFFFFFFFF
    if not stable:
        mv[count:] = 0xFFFFFFFF
    gk, gv = tbit.sort_pairs_u32(_t(mk), _t(mv), torch.tensor(count),
                                 chunk=CHUNK, stable=stable)
    wk, wv = jbit.sort_pairs_u32(jnp.asarray(mk), jnp.asarray(mv),
                                 jnp.uint32(count), chunk=CHUNK,
                                 interpret=True, stable=stable)
    np.testing.assert_array_equal(gk.numpy()[:count], np.asarray(wk)[:count])
    np.testing.assert_array_equal(gv.numpy()[:count], np.asarray(wv)[:count])


@pytest.mark.parametrize("n", [8193, 8193 + 511, 12289, 16383 - 1024 + 7])
def test_unfused_trailing_skip_escape(monkeypatch, n):
    """Fused rounds off: every merge round runs as cross + local, and the
    genuine boundary sits just past np2/2, where descending groups move
    genuine elements into trailing chunks; the group-granularity skip rule
    must still give the JAX package's (unfused) result."""
    monkeypatch.setattr(tbit, "MAX_FUSED_ELEMS", 1)
    monkeypatch.setattr(jbit, "MAX_FUSED_ROWS", 1)
    keys = _keys(n, n, "uniform")
    got = tbit.sort_u32(_t(keys), chunk=CHUNK).numpy()
    want = np.asarray(jbit.sort_u32.__wrapped__(
        jnp.asarray(keys), chunk=CHUNK, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_unfused_stable_pairs_and_count(monkeypatch):
    """The same escape shapes through the stable carry and the count= gate,
    against numpy (the JAX package's own tests pin these shapes there)."""
    monkeypatch.setattr(tbit, "MAX_FUSED_ELEMS", 1)
    n = 8193 + 300
    keys = _keys(n, 13, "dups")
    vals = _vals(n, 13)
    gk, gv = tbit.sort_pairs_u32(_t(keys), _t(vals), chunk=CHUNK)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.numpy(), keys[order])
    np.testing.assert_array_equal(gv.numpy(), vals[order])
    n, count = 1 << 14, 10 * CHUNK + 549
    keys = _keys(n, 14, "uniform")
    masked = keys.copy()
    masked[count:] = 0xFFFFFFFF
    got = tbit.sort_u32(_t(masked), count, chunk=CHUNK).numpy()
    np.testing.assert_array_equal(got[:count], np.sort(keys[:count]))


@pytest.mark.parametrize("n,chunk", [(600, 256), (768, 256), (1543, 256)])
def test_trailing_skip_desc_group_shapes(n, chunk):
    """tests/test_bitonic.py's descending-group skip shapes, fused on."""
    keys = _keys(n, n, "uniform")
    got = tbit.sort_u32(_t(keys), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, np.sort(keys))


def test_plan_and_skip_launch_geometry(monkeypatch):
    """The grid covers the genuine prefix only: at n just past a chunk the
    chunk kernel runs two units, not the whole padded buffer."""
    calls = []
    real = tbit.bk.run

    def spy(launch, arrs, mode, nunits, valid=None):
        calls.append((launch.kernel, launch.cargs, nunits))
        real(launch, arrs, mode, nunits, valid)

    monkeypatch.setattr(tbit.bk, "run", spy)
    monkeypatch.setattr(tbit, "MAX_FUSED_ELEMS", 1)
    tbit.sort_u32(_t(_keys(CHUNK + 5, 1, "uniform")), chunk=256)
    # np2 = 2048, C = 256: chunk covers 5 of 8 chunks; round 1 groups of 2
    assert calls[0] == ("chunk", (8,), 5)
    assert ("local", (8, 1), 6) in calls
    assert ("local", (8, 3), 8) in calls
    assert tbit._plan(5, 1 << 13) == (256, 256)
    with pytest.raises(ValueError):
        tbit._plan(5, 300)


def test_chunk_over_smem_cap_raises():
    keys = _t(_keys(64, 0, "uniform"))
    with pytest.raises(ValueError):
        tbit.sort_pairs_u32(keys, keys.clone(), chunk=1 << 15)
    with pytest.raises(TypeError):
        tbit.sort_u32(keys.view(torch.int32))


def test_empty_and_tiny():
    empty = torch.empty(0, dtype=torch.uint32)
    assert tbit.sort_u32(empty).numel() == 0
    k, v = tbit.sort_pairs_u32(empty, empty)
    assert k.numel() == v.numel() == 0
    one = _t(np.array([7], np.uint32))
    assert tbit.sort_u32(one).tolist() == [7]
