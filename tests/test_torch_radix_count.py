"""The radix backend's `count=` path on the CPU (each kernel's plain
version): the first pass's masked load (K7 on the caller's unpadded
buffers) and the tail restored after the passes, against the composition
they replaced (`arange(n) < count`, `select_u32`, `pad_u32`, and the
select of the keys after the sort), numpy's stable sort of the prefix and
the reference backend's `count=` sorts; and the launches and the
first-pass counter such a sort records. Tolerance: bitwise equality.
"""

import numpy as np
import pytest
import torch

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix, reference
from vulkan_radix_sort_tpu_torch.ops.bitops import (count_tensor,
                                                    max_like_u32, pad_u32,
                                                    select_u32)
from vulkan_radix_sort_tpu_torch.utils import datagen, timing

M = radix.MIN_RADIX_N
DTYPES = {torch.uint32: np.uint32, torch.int32: np.int32,
          torch.float32: np.float32}


@pytest.fixture(autouse=True)
def one_thread():
    """Each case is a few small sorts: one intra-op thread keeps them from
    contending for the cores with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _u32(n, seed, hi=2**32):
    return np.random.default_rng(seed).integers(
        0, hi, n, dtype=np.uint64).astype(np.uint32)


def _keys(dtype, n, seed):
    """Many ties (stability decides), genuine 0xFFFFFFFF words, and for
    float32 duplicates and -0.0."""
    if dtype == torch.float32:
        k = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        k[::13] = k[::7][: len(k[::13])]
        k[::101] = -0.0
        return k
    k = _u32(n, seed, 1 << 9)
    k[::17] = 0xFFFFFFFF
    return k.view(DTYPES[dtype])


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


COUNTS = (-3, 0, 1, 4095, 4096, "n-999", "n", "n+5")


def _count(count, n):
    """A count of COUNTS at n: those named by n are relative to it."""
    return {"n-999": n - 999, "n": n, "n+5": n + 5}.get(count, count)


def _count_keys(n, seed):
    """Keys with genuine 0xFFFFFFFF in the prefix and in the tail of every
    count, and many ties."""
    keys = _u32(n, seed, 1 << 10)
    keys[::61] = 0xFFFFFFFF
    keys[-3:] = 0xFFFFFFFF
    keys[:2] = 0xFFFFFFFF
    return keys


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("kv", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("n", [M, M + 17, 3 * M])
def test_count_mask_pad_and_restore(n, kv, count, as_tensor):
    """The count= first pass and tail of the radix path against today's
    composition (`arange(n) < count`, `select_u32`, `pad_u32`, K7's plain
    pass, and the select of the keys after the sort), and the radix
    count= sort against numpy's stable sort of the prefix and against the
    reference backend's count= sorts."""
    cfg = SortConfig(backend="radix")
    count = _count(count, n)
    c = min(max(count, 0), n)
    keys, vals = _count_keys(n, n + c), _u32(n, n + 1)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    cnt = torch.tensor(count)
    size = -(-n // cfg.block) * cfg.block
    live = torch.arange(n) < cnt
    want_x = pad_u32(select_u32(live, tk, max_like_u32(tk)), size,
                     0xFFFFFFFF)
    want = k7.block_sort_plain(want_x, pad_u32(tv, size, 0) if kv else None,
                               shift=8, config=cfg, key_value=kv)
    got = k7.block_sort(tk, tv if kv else None, shift=8, config=cfg,
                        key_value=kv, size=size, count=cnt)
    for g, w in zip(got, want):
        _eq(g, w.numpy())
    # the tail: any sorted buffer gets the keys at or past c back
    buf = torch.from_numpy(_u32(size, 3))
    _eq(radix.restore_tail(buf, tk, cnt),
        select_u32(live, buf[:n], tk).numpy())

    arg = cnt if as_tensor else count
    order = np.argsort(keys[:c], kind="stable")
    want_k = np.concatenate([keys[:c][order], keys[c:]])
    if kv:
        gk, gv = radix.sort(tk, tv, count=arg, config=cfg)
        rk, rv = reference.sort(tk, tv, count=cnt)
        _eq(gv, np.concatenate([vals[:c][order], vals[c:]]))
        _eq(gv, rv.numpy())
    else:
        gk = radix.sort(tk, count=arg, config=cfg)
        rk = reference.sort(tk, count=cnt)
    _eq(gk, want_k)
    _eq(gk, rk.numpy())
    np.testing.assert_array_equal(tk.numpy(), keys)  # inputs untouched


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
def test_sorter_radix_count_matches_reference(dtype, stable, count):
    """The radix Sorter's count= sorts in every 32-bit key dtype: numpy's
    stable sort of the prefix and the untouched tail, and bitwise the
    reference backend's."""
    n = M + 17
    c = min(max(_count(count, n), 0), n)
    keys = _keys(dtype, n, seed=c + 1)
    vals = datagen.generate_values(n, seed=c + 2)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    cnt = torch.tensor(_count(count, n))
    s = vrs.Sorter(n, key_dtype=dtype, device="cpu",
                   config=SortConfig(backend="radix"))
    ref = vrs.Sorter(n, key_dtype=dtype, device="cpu",
                     config=SortConfig(backend="reference"))
    o = np.argsort(keys[:c], kind="stable")
    if dtype == torch.float32:  # IEEE total order: -0.0 before 0.0
        o = np.lexsort((np.signbit(keys[:c]) == 0, keys[:c]))
    want = np.concatenate([keys[:c][o], keys[c:]])
    if stable:  # a keys sort has no `stable`: held once a count
        gk = s.sort(tk, count=cnt)
        _eq(gk, want)
        _eq(gk, ref.sort(tk, count=cnt).numpy())
    gk, gv = s.sort_key_value(tk, tv, count=cnt, stable=stable)
    rk, rv = ref.sort_key_value(tk, tv, count=cnt, stable=True)
    _eq(gk, want)
    _eq(gv, np.concatenate([vals[:c][o], vals[c:]]))
    _eq(gk, rk.numpy())
    _eq(gv, rv.numpy())


def test_count_sort_launches_and_counts_the_mask_kernel():
    """A radix count= sort records K7, the spine and K8 a pass, the first
    K7 the masked load of the caller's buffers, and the tail's launch:
    13, and the masked first pass counted once. The network, reference and
    64-bit count= paths keep their ATen masks and record no tail."""
    n = M
    keys, vals = _u32(n, 21), _u32(n, 22)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    passes = ["block_sort", "spine", "place"] * SortConfig().num_passes
    for call in ("keys", "kv"):
        s = vrs.Sorter(n, device="cpu", config=SortConfig(backend="radix"))
        with timing.LaunchTimer() as timer:
            if call == "kv":
                s.sort_key_value(tk, tv, count=n - 5)
            else:
                s.sort(tk, count=torch.tensor(n - 5))
        assert [r["names"][0] for r in timer.records] == \
            passes + ["restore_tail"]
        assert len(timer.records) == 13
        assert [r.get("first") for r in timer.records[:4]] == \
            ["masked", None, None, None]
        assert timer.counts["vrs.radix.first_pass.masked"] == 1
    for backend, dtype, m in (("network", torch.uint32, 1 << 10),
                              ("reference", torch.uint32, n),
                              ("network", torch.uint64, 1 << 10),
                              ("radix", torch.uint32, M - 1)):
        s = vrs.Sorter(m, key_dtype=dtype, device="cpu",
                       config=SortConfig(backend=backend))
        k = torch.from_numpy(_u32(m, 23).astype(
            np.uint64 if dtype == torch.uint64 else np.uint32))
        with timing.LaunchTimer() as timer:
            s.sort(k, count=m - 3)
            s.sort_key_value(k, torch.from_numpy(_u32(m, 24)), count=m - 3)
        assert "restore_tail" not in {
            r["names"][0] for r in timer.records}, backend
        assert not any(r.get("first") for r in timer.records), backend


FIRST_SIZES = {"block": M, "block-5": M - 5, "block+1": M + 1}
FIRST_COUNTS = (None, 0, "n-999", "n+5")


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("count", FIRST_COUNTS)
@pytest.mark.parametrize("kv", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("n", list(FIRST_SIZES.values()),
                         ids=list(FIRST_SIZES))
def test_first_pass_is_mask_pad_then_the_plain_pass(n, kv, count,
                                                    as_tensor):
    """K7's first pass on the caller's unpadded buffers (`size=`) is
    `mask_pad_plain` followed by K7's plain pass: the output, the values
    and the histogram, at n a block multiple, a block multiple less 5 and
    one block plus 1, without a count and with counts 0, below n and past
    it (an int made a tensor as the sort does, or a tensor), keys with
    genuine 0xFFFFFFFF words."""
    cfg = SortConfig(backend="radix")
    count = _count(count, n)
    keys, vals = _count_keys(n, n + 7), _u32(n, n + 8)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    cnt = count_tensor(torch.tensor(count) if as_tensor and count is not None
                       else count, tk.device)
    size = -(-n // cfg.block) * cfg.block
    padded = k7.mask_pad_plain(tk, tv if kv else None, cnt, size)
    want = k7.block_sort_plain(*(padded if kv else (padded,)), shift=0,
                               config=cfg, key_value=kv)
    got = k7.block_sort(tk, tv if kv else None, shift=0, config=cfg,
                        key_value=kv, size=size, count=cnt)
    assert len(got) == len(want) == 2 + kv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_array_equal(tk.numpy(), keys)  # inputs untouched
    c = n if count is None else min(max(count, 0), n)
    x = (padded[0] if kv else padded).numpy()
    assert (x[c:] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(x[:c], keys[:c])
    if kv:
        np.testing.assert_array_equal(padded[1].numpy()[:n], vals)
        assert not padded[1].numpy()[n:].any()


@pytest.mark.parametrize("call", ["keys", "kv", "keys_count", "ragged",
                                  "unaligned", "u64"])
def test_first_pass_counter_once_a_sort(call):
    """`vrs.radix.first_pass.bulk` where the host sees every block
    bulk-loaded (no count, n a block multiple, aligned buffers: the K7
    launch takes no `size`), `.masked` otherwise (a count, a ragged n, a
    view one word in), once a radix sort; the 64-bit path's first pass
    reads split_pad's padded buffers: bulk."""
    cfg = SortConfig(backend="radix")
    n = 2 * M
    base = torch.from_numpy(_u32(n + 1, 41))
    vals = torch.from_numpy(_u32(n, 42))
    keys = base[:n]
    assert keys.data_ptr() % 16 == 0
    with timing.LaunchTimer() as timer:
        if call == "keys":
            radix.sort(keys, config=cfg)
        elif call == "kv":
            radix.sort(keys, vals, config=cfg)
        elif call == "keys_count":
            radix.sort(keys, count=n, config=cfg)
        elif call == "ragged":
            radix.sort(keys[:n - 5], vals[:n - 5], config=cfg)
        elif call == "unaligned":
            radix.sort(base[1:], config=cfg)
        else:
            radix.sort(keys.to(torch.int64).view(torch.uint64), config=cfg,
                       end_bit=40)
    bulk = call in ("keys", "kv", "u64")
    kind = "bulk" if bulk else "masked"
    assert {k: v for k, v in timer.counts.items()
            if k.startswith("vrs.radix.first_pass.")} == {
        f"vrs.radix.first_pass.{kind}": 1}
    k7s = [r for r in timer.records if r["names"][0] == "block_sort"]
    assert [r.get("first") for r in k7s[:2]] == [
        None if bulk else "masked", None]
    assert all(r["numel"] % cfg.block == 0 for r in k7s)
