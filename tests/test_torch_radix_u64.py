"""The radix backend's 64-bit and end_bit paths on the CPU (each kernel's
plain version): the (word, position) path of `ops/radix.py` (split-pad,
the kv passes on the low then the high words, the gathers) and the
32-bit passes cut to end_bit, each held bitwise to `plain_reference`
(two stable torch.sorts of the masked words, then a gather); the
reference and network backends with end_bit; and the spans, counters and
launches such a sort records. Tolerance: bitwise equality.
"""

import numpy as np
import pytest
import torch

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch import plain_reference as pr
from vulkan_radix_sort_tpu_torch.config import SortConfig
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.utils import timing

M = radix.MIN_RADIX_N
SIZES = (M, M + 37, 1 << 16)
END_BITS = (1, 8, 32, 33, 45, 64)
RADIX = SortConfig(backend="radix")


@pytest.fixture(autouse=True)
def one_thread():
    """Each case is a few small sorts: one intra-op thread keeps them from
    contending for the cores with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _u64(n, seed):
    """uint64 keys with every bit drawn (so bits above any end_bit are
    set), few distinct values in each word's low byte and a quarter of
    one high word (many keys equal below the end bit: stability decides),
    and every 97th the maximum."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    k &= np.uint64(0xFFFFFF03FFFFFF03)
    k[::4] = (k[::4] & np.uint64(0xFFFFFFFF)) | np.uint64(0xDEAD << 45)
    k[::97] = np.uint64(2**64 - 1)
    return torch.from_numpy(k.view(np.int64)).view(torch.uint64)


def _u32(n, seed):
    k = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    k &= np.uint64(0xFFFF03FF)
    return torch.from_numpy(k.astype(np.uint32).view(np.int32)).view(
        torch.uint32)


def _eq(got, want):
    signed = torch.int64 if want.element_size() == 8 else torch.int32
    assert got.dtype == want.dtype
    assert torch.equal(got.view(signed), want.view(signed))


def _with_count(fn, keys, values, count):
    """`fn` on the prefix, the tail as it was."""
    n = keys.numel()
    c = min(max(count, 0), n)
    out = fn(keys[:c], values[:c]) if values is not None else (
        fn(keys[:c]),)
    tails = (keys[c:],) if values is None else (keys[c:], values[c:])
    return tuple(torch.cat([o, t]) for o, t in zip(out, tails))


@pytest.mark.parametrize("end_bit", END_BITS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("call", ["keys", "kv", "kvns"])
def test_radix_u64_matches_plain_reference(call, n, end_bit):
    keys, values = _u64(n, n + end_bit), _u32(n, 7)
    s = vrs.Sorter(n, key_dtype=torch.uint64, device="cpu", config=RADIX)
    if call == "keys":
        _eq(s.sort(keys, end_bit=end_bit), pr.sort_keys_bits(keys, end_bit))
        return
    gk, gv = s.sort_key_value(keys, values, stable=call == "kv",
                              end_bit=end_bit)
    wk, wv = pr.sort_pairs_bits(keys, values, end_bit)
    _eq(gk, wk)
    _eq(gv, wv)  # radix is stable either way


@pytest.mark.parametrize("count", [-3, 0, 1, 4096, "n-999", "n", "n+5"])
@pytest.mark.parametrize("end_bit", [13, 45, 64])
def test_radix_u64_count(end_bit, count):
    n = 1 << 15
    count = {"n-999": n - 999, "n": n, "n+5": n + 5}.get(count, count)
    keys, values = _u64(n, 11), _u32(n, 12)
    s = vrs.Sorter(n, key_dtype=torch.uint64, device="cpu", config=RADIX)
    cnt = torch.tensor(count)
    want = _with_count(lambda k, v: pr.sort_pairs_bits(k, v, end_bit),
                       keys, values, count)
    for got, w in zip(s.sort_key_value(keys, values, count=cnt,
                                       end_bit=end_bit), want):
        _eq(got, w)
    want = _with_count(lambda k: pr.sort_keys_bits(k, end_bit), keys, None,
                       count)
    _eq(s.sort(keys, count=count, end_bit=end_bit), want[0])


@pytest.mark.parametrize("end_bit", [1, 12, 16, 20, 31, 32])
@pytest.mark.parametrize("n", [M + 37, 1 << 16])
def test_radix_u32_end_bit(n, end_bit):
    """32-bit keys: a multiple of the digit runs fewer passes of the plain
    path; any other end_bit the (word, position) path."""
    keys, values = _u32(n, end_bit), _u32(n, 3)
    s = vrs.Sorter(n, device="cpu", config=RADIX)
    with timing.LaunchTimer() as t:
        gk, gv = s.sort_key_value(keys, values, end_bit=end_bit)
    wk, wv = pr.sort_pairs_bits(keys, values, end_bit)
    _eq(gk, wk)
    _eq(gv, wv)
    _eq(s.sort(keys, end_bit=end_bit), wk)
    _eq(s.sort(keys, count=n - 999, end_bit=end_bit), _with_count(
        lambda k: pr.sort_keys_bits(k, end_bit), keys, None, n - 999)[0])
    names = [r["names"][0] for r in t.records]
    words = end_bit not in (8, 16, 24, 32)
    assert names.count("block_sort") == -(-end_bit // 8)
    assert names.count("split_pad") == names.count("gather") == int(words)


@pytest.mark.parametrize("backend", ["reference", "network"])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("end_bit", [5, 16, 33, 45])
def test_other_backends_honour_end_bit(backend, width, end_bit):
    if end_bit > width:
        end_bit -= 32
    n = M + 37
    keys = _u64(n, 21) if width == 64 else _u32(n, 21)
    values = _u32(n, 22)
    s = vrs.Sorter(n, key_dtype=keys.dtype, device="cpu",
                   config=SortConfig(backend=backend, chunk=256))
    wk, wv = pr.sort_pairs_bits(keys, values, end_bit)
    for stable in (True, False):
        gk, gv = s.sort_key_value(keys, values, stable=stable,
                                  end_bit=end_bit)
        _eq(gk, wk)
        _eq(gv, wv)
    _eq(s.sort(keys, end_bit=end_bit), wk)
    got = s.sort_key_value(keys, values, count=n - 500, end_bit=end_bit)
    for g, w in zip(got, _with_count(
            lambda k, v: pr.sort_pairs_bits(k, v, end_bit), keys, values,
            n - 500)):
        _eq(g, w)


def test_one_shot_functions_take_end_bit():
    keys, values = _u64(M, 31), _u32(M, 32)
    cfg = SortConfig(backend="radix")
    _eq(vrs.sort(keys, config=cfg, end_bit=45), pr.sort_keys_bits(keys, 45))
    for g, w in zip(vrs.sort_key_value(keys, values, config=cfg, end_bit=45),
                    pr.sort_pairs_bits(keys, values, 45)):
        _eq(g, w)


def test_the_cells_call_records_its_path():
    """A stable kv sort by end_bit 45 on radix: one split-pad, 4 passes
    on the low words, the high words' gather, 2 passes on them, the
    output's gather; the spans of each stretch, 6 `vrs.radix.pass`, one
    call served by radix. At end_bit 32 the high words take no pass."""
    n = 1 << 15
    keys, values = _u64(n, 41), _u32(n, 42)
    s = vrs.Sorter(n, key_dtype=torch.uint64, device="cpu", config=RADIX)
    with timing.LaunchTimer() as t:
        s.sort_key_value(keys, values, end_bit=45)
    names = [r["names"][0] for r in t.records]
    assert names == (["split_pad"] + ["block_sort", "spine", "place"] * 4
                     + ["gather"] + ["block_sort", "spine", "place"] * 2
                     + ["gather"])
    assert [r["what"] for r in t.records if "what" in r] == ["hi", "out"]
    assert [r["shift"] for r in t.records if r["names"] == ["place"]] == [
        0, 8, 16, 24, 0, 8]
    assert t.counts == {"vrs.backend.radix": 1, "vrs.radix.pass": 6,
                        "vrs.radix.first_pass.bulk": 1}
    spans = [sp["name"] for sp in t.spans]
    assert spans == ["vrs.sort_key_value", "vrs.u64.split", "vrs.u64.lo",
                     "vrs.u64.gather", "vrs.u64.hi", "vrs.u64.gather"]
    lo = next(sp["id"] for sp in t.spans if sp["name"] == "vrs.u64.lo")
    assert {r["span"] for r in t.records if r["names"] == ["block_sort"]
            } == {lo, lo + 2}
    with timing.LaunchTimer() as t:
        s.sort_key_value(keys, values, end_bit=32)
    assert [sp["name"] for sp in t.spans] == [
        "vrs.sort_key_value", "vrs.u64.split", "vrs.u64.lo",
        "vrs.u64.gather"]
    assert t.counts["vrs.radix.pass"] == 4


def test_32_bit_sorts_keep_their_launches():
    """uint32 keys with every bit: 12 launches (4 passes), 13 with
    count= (the tail; the first K7 masks as it loads), 4
    `vrs.radix.pass`."""
    n = 1 << 15
    keys, values = _u32(n, 51), _u32(n, 52)
    s = vrs.Sorter(n, device="cpu", config=RADIX)
    for call, launches in ((lambda: s.sort(keys), 12),
                           (lambda: s.sort_key_value(keys, values,
                                                     count=n - 3), 13)):
        with timing.LaunchTimer() as t:
            call()
        assert len(t.records) == launches
        assert t.counts["vrs.radix.pass"] == 4


def test_pass_loop_frees_each_buffer():
    """The loop takes the buffers out of the caller's list: once it
    returns, only its output is held."""
    n = 1 << 15
    x = radix.pad_u32(_u32(n, 61), n, 0xFFFFFFFF)
    bufs = [x]
    del x
    out = radix._passes(bufs, range(0, 32, 8), RADIX)
    assert bufs == [] and len(out) == 1
