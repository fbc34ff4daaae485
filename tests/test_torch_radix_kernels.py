"""The port's radix kernels, K7 (block sort) and K8 (placement), against the
JAX package's Pallas kernels and against numpy.

On the CPU each wrapper of `vulkan_radix_sort_tpu_torch.ops.block_sort` /
`stream_place` runs its kernel's plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, at the JAX package's own test
geometry (block=1024, 4-bit digits, 8 blocks), as `tests/test_kernels.py`
does. Same numpy-seeded inputs; tolerance: bitwise equality (all data is
integer). The JAX tiles are (rows, 128) and its histogram rows are padded
to 128 lanes: the port's flat keys are compared with the flattened tiles,
and its (nblocks, radix) histogram with the first `radix` lanes. The CUDA
kernels themselves are held against these plain versions on the card in
`test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkan_radix_sort_tpu.config import SortConfig as JaxConfig
from vulkan_radix_sort_tpu.ops.block_sort import block_sort as jax_block_sort
from vulkan_radix_sort_tpu.ops.radix import _pad2d, _spine as jax_spine
from vulkan_radix_sort_tpu.ops.stream_place import (
    stream_place as jax_stream_place)
from vulkan_radix_sort_tpu_torch.config import (
    MAX_RADIX_BLOCK, RADIX_THREADS, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8

JCFG = JaxConfig(block=1024, flush_rows=4, interpret=True)
CFG = SortConfig(block=1024, digit_bits=4)
B = 1024
N = 8 * B
R = CFG.radix


def _keys(seed, hi=2**32, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


def _vals(seed, n=N):
    return _keys(seed + 1000, n=n)


def _tile(x, fill):
    return _pad2d(jnp.asarray(x), x.size, fill)


def _flat(a):
    return np.array(a).reshape(-1)  # a writable copy, for torch.from_numpy


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("shift", [0, 4, 28])
def test_block_sort_matches_jax(shift, key_value, skew):
    """K7 bitwise equal to the Pallas block sort; `skew` leaves the digit at
    `shift` two values, so nearly every key ties and stability decides."""
    keys = _keys(shift + 10 * key_value)
    if skew:
        keys &= ~np.uint32(0xE << shift)
    vals = _vals(shift)
    got = k7.block_sort(torch.from_numpy(keys),
                        torch.from_numpy(vals) if key_value else None,
                        shift=shift, config=CFG, key_value=key_value)
    want = jax_block_sort(_tile(keys, 0xFFFFFFFF),
                          _tile(vals, 0) if key_value else None,
                          shift=shift, config=JCFG, key_value=key_value,
                          interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), _flat(want[0]))
    if key_value:
        np.testing.assert_array_equal(got[1].numpy(), _flat(want[1]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1])[:, :R])


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("kind", ["one digit", "all equal"])
def test_block_sort_degenerate_blocks_match_jax(kind, key_value):
    """K7 where every lane of a warp is a peer, bitwise equal to the Pallas
    block sort: keys that differ everywhere but in the digit at `shift`
    (every position set by stability alone), and keys all equal."""
    shift = 8
    if kind == "one digit":
        keys = (_keys(77 + key_value) & ~np.uint32(0xF << shift)) \
            | np.uint32(0x9 << shift)
    else:
        keys = np.full(N, 0x12345978, np.uint32)  # digit 9 too
    vals = _vals(77)
    got = k7.block_sort(torch.from_numpy(keys),
                        torch.from_numpy(vals) if key_value else None,
                        shift=shift, config=CFG, key_value=key_value)
    want = jax_block_sort(_tile(keys, 0xFFFFFFFF),
                          _tile(vals, 0) if key_value else None,
                          shift=shift, config=JCFG, key_value=key_value,
                          interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), _flat(want[0]))
    if key_value:
        np.testing.assert_array_equal(got[1].numpy(), _flat(want[1]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1])[:, :R])
    assert (got[-1].numpy()[:, 9] == B).all()


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("dist_hi", [2**32, 16, 2])
def test_stream_place_matches_jax(dist_hi, key_value):
    """K8 fed the same block-sorted (y, hist, g) as the Pallas placement,
    uniform and skewed digits; the pass's result is also the stable digit
    sort of the input."""
    keys = _keys(dist_hi % 97 + key_value, hi=dist_hi)
    vals = _vals(7)
    y, yv, hist = jax_block_sort(_tile(keys, 0xFFFFFFFF), _tile(vals, 0),
                                 shift=0, config=JCFG, key_value=True,
                                 interpret=True)
    g = jax_spine(hist, R)
    if key_value:
        want = jax_stream_place(y, hist, g, yv, config=JCFG, key_value=True,
                                interpret=True)
    else:
        want = (jax_stream_place(y, hist, g, config=JCFG, interpret=True),)
    ty, tyv = torch.from_numpy(_flat(y)), torch.from_numpy(_flat(yv))
    th = torch.tensor(np.asarray(hist)[:, :R])  # copies: contiguous
    tg = torch.tensor(np.asarray(g)[0, :R])
    got = k8.stream_place(ty, th, tg, tyv if key_value else None, config=CFG,
                          key_value=key_value)
    got = got if key_value else (got,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _flat(b))
    order = np.argsort(keys & 15, kind="stable")
    np.testing.assert_array_equal(got[0].numpy(), keys[order])
    if key_value:
        np.testing.assert_array_equal(got[1].numpy(), vals[order])


def test_spine_and_block_offsets_match_numpy():
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 100, size=(37, 256)).astype(np.int32)
    hist[:, 5] = 0  # an empty digit
    tot = hist.sum(0)
    g = np.cumsum(tot) - tot
    got_g = radix._spine(torch.from_numpy(hist))
    assert got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), g)
    off = k8.block_offsets(torch.from_numpy(hist), got_g)
    assert off.dtype == torch.int32 and off.is_contiguous()
    np.testing.assert_array_equal(off.numpy(),
                                  np.cumsum(hist, 0) - hist + g[None, :])
    # the JAX package's spine agrees on its lane-padded layout
    padded = np.zeros((37, 128), np.int32)
    padded[:, :16] = hist[:, :16]
    np.testing.assert_array_equal(
        np.asarray(jax_spine(jnp.asarray(padded), 16))[0, :16],
        radix._spine(torch.from_numpy(hist[:, :16].copy())).numpy())


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("shift", [0, 8, 24])
def test_plain_kernels_8bit_match_numpy(shift, key_value):
    """At the port's own geometry (8-bit digits, the default blocks): K7 is
    a stable digit sort of each block with its bincount, and K7 then K8 is
    a stable digit sort of the whole input."""
    cfg = SortConfig()
    n = 4 * cfg.block
    keys = _keys(shift + 1, n=n)
    ties = keys[1::5] & np.uint32(0xFF << shift)
    keys[::5][:ties.size] = ties
    vals = _vals(shift, n=n)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    out = k7.block_sort(tk, tv if key_value else None, shift=shift,
                        config=cfg, key_value=key_value)
    digit = (keys >> np.uint32(shift)) & np.uint32(255)
    for b in range(n // cfg.block):
        s = slice(b * cfg.block, (b + 1) * cfg.block)
        order = np.argsort(digit[s], kind="stable")
        np.testing.assert_array_equal(out[0][s].numpy(), keys[s][order])
        if key_value:
            np.testing.assert_array_equal(out[1][s].numpy(), vals[s][order])
        np.testing.assert_array_equal(out[-1][b].numpy(),
                                      np.bincount(digit[s], minlength=256))
    placed = k8.stream_place(out[0], out[-1], radix._spine(out[-1]),
                             out[1] if key_value else None, config=cfg,
                             key_value=key_value)
    placed = placed if key_value else (placed,)
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(placed[0].numpy(), keys[order])
    if key_value:
        np.testing.assert_array_equal(placed[1].numpy(), vals[order])


def test_block_sort_geometry():
    """Every block SortConfig admits gives K7 whole warps of at most
    RADIX_THREADS threads holding 4 to 32 keys each, a whole number of
    16-byte vectors (csrc/radix.cu, sort_threads)."""
    block = RADIX_THREADS
    while block <= MAX_RADIX_BLOCK:
        SortConfig(block=block)
        threads, per = k7.sort_geometry(block)
        assert threads * per == block and threads % 32 == 0
        assert threads <= RADIX_THREADS and per % 4 == 0 and 4 <= per <= 32
        block *= 2
    assert k7.sort_geometry(SortConfig().block) == (512, 32)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    k7.reset_launches()
    k8.reset_launches()
    keys = torch.from_numpy(_keys(5))
    y, hist = k7.block_sort(keys, shift=4, config=CFG)
    want = k7.block_sort_plain(keys, shift=4, config=CFG)
    assert torch.equal(y, want[0]) and torch.equal(hist, want[1])
    g = radix._spine(hist)
    assert torch.equal(k8.stream_place(y, hist, g, config=CFG),
                       k8.stream_place_plain(y, hist, g, config=CFG))
    assert k7.launches == {"block_sort": 0} and k8.launches == {"place": 0}


def test_wrappers_reject_bad_inputs():
    keys = torch.from_numpy(_keys(6))
    with pytest.raises(TypeError):
        k7.block_sort(keys.view(torch.int32), shift=0, config=CFG)
    with pytest.raises(ValueError):  # not a block multiple
        k7.block_sort(keys[:-1], shift=0, config=CFG)
    with pytest.raises(ValueError):
        k7.block_sort(keys, shift=32, config=CFG)
    with pytest.raises(TypeError):  # key_value without values
        k7.block_sort(keys, shift=0, config=CFG, key_value=True)
    with pytest.raises(ValueError):
        k7.block_sort(keys, keys[:B], shift=0, config=CFG, key_value=True)
    y, hist = k7.block_sort(keys, shift=0, config=CFG)
    g = radix._spine(hist)
    with pytest.raises(ValueError):  # histogram of another geometry
        k8.stream_place(y, hist[:, :8].contiguous(), g, config=CFG)
    with pytest.raises(ValueError):
        k8.stream_place(y, hist, g.to(torch.int64), config=CFG)
    meta = torch.empty(N, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):  # no kernel and no plain off the CPU/GPU
        k7.block_sort(meta, shift=0, config=CFG)
