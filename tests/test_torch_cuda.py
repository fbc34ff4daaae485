"""The port on an NVIDIA card: each CUDA kernel against its plain version,
and the sort and the Sorter, network and radix, against numpy oracles.

Every test here is marked `cuda` and skips with a reason on a host without
a card (decided in the fixture, never at import). The file imports neither
JAX nor the JAX package, so it also runs where they are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bitwise equality (all data is integer or compared as bits).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import vulkan_radix_sort_tpu_torch as vrs
from vulkan_radix_sort_tpu_torch.config import (
    CHUNK_CARRY, CHUNK_KEYS, MIN_CHUNK, SortConfig)
from vulkan_radix_sort_tpu_torch.ops import bitonic as tbit
from vulkan_radix_sort_tpu_torch.ops import bitonic_kernels as bk
from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.ops import radix
from vulkan_radix_sort_tpu_torch.ops import stream_place as k8
from vulkan_radix_sort_tpu_torch.parallel import distributed as td
from vulkan_radix_sort_tpu_torch.parallel import scaling
from vulkan_radix_sort_tpu_torch.bench import harness
from vulkan_radix_sort_tpu_torch.models import sorter
from vulkan_radix_sort_tpu_torch.utils import datagen, profiling, timing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _launched(timer: timing.LaunchTimer) -> dict[str, int]:
    """Kernel launches by counter name in a LaunchTimer's records: those
    with CUDA events."""
    got = {}
    for rec in timer.records:
        if rec["events"] is not None:
            for k in rec["names"]:
                got[k] = got.get(k, 0) + 1
    return got


def _u32(n, seed, mod=None):
    k = np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if mod is not None:
        k %= np.uint32(mod)
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_cuda_kernels_match_plain(cuda_device, mode):
    """Each CUDA kernel bitwise equal to its plain version on the card,
    with and without a validity mask, including a two-span cross round;
    the fused group is the main path's, sized by the carry's cap."""
    rng = np.random.default_rng(9)
    n = 1 << 18
    C = CHUNK_KEYS if mode is bk.KEYS else CHUNK_CARRY
    r = bk.log2(n // C)
    cases = [bk.spec("chunk", C), bk.spec("local", C, r),
             bk.spec("fused", C, 1, tbit._fused_rounds(C, r, mode)),
             bk.spec("cross", C, r, 0, r), bk.spec("cross", C, r, 1, r - 1)]
    for launch in cases:
        units = n // launch.unit
        flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
        for valid in (None, flags.to(cuda_device)):
            a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 1000))
                 .to(cuda_device) for _ in range(mode.n_arrays)]
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units, valid)
            bk.run_plain(launch, b, mode, units, valid)
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _tie_tail(arrs, mode, start):
    """Tied (max key, pad tiebreak) tuples from `start` on, riding values
    distinct, as a count= tail or the padding holds them in a stable
    carry."""
    for a in arrs[:mode.words - 1]:
        a.view(torch.int32)[start:] = -1
    arrs[mode.words - 1].view(torch.int32)[start:] = tbit.STABLE_PAD_IDX


def _chunk_cases():
    """(mode, C) for every chunk the config admits in every carry."""
    cases = []
    for mode in bk.MODES:
        c = MIN_CHUNK
        while c <= mode.reg_cap:
            cases.append(pytest.param(mode, c, id=f"{mode.name}-{c}"))
            c *= 2
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode,C", _chunk_cases())
def test_cuda_register_kernels_every_chunk(cuda_device, mode, C):
    """K1 and K4 bitwise equal to their plain versions at every chunk, whose
    register and thread geometry changes with C, with and without a
    validity mask; the stable carries' riding values under tied tuples stay
    put."""
    rng = np.random.default_rng(C + mode.code)
    n = 1 << 18
    units = n // C
    flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
    for launch in (bk.spec("chunk", C), bk.spec("local", C, 1)):
        for valid in (None, flags.to(cuda_device)):
            a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 50))
                 .to(cuda_device) for _ in range(mode.n_arrays)]
            if mode.ride:  # a tail of tied (max, ..., pad) tuples
                _tie_tail(a, mode, n // 2)
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units, valid)
            bk.run_plain(launch, b, mode, units, valid)
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _fused_cases():
    """(mode, G) for every group the fused kernel takes: two MIN_CHUNK
    chunks up to the carry's register cap."""
    cases = []
    for mode in bk.MODES:
        g = 2 * MIN_CHUNK
        while g <= mode.reg_cap:
            cases.append(pytest.param(mode, g, id=f"{mode.name}-{g}"))
            g *= 2
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mode,G", _fused_cases())
def test_cuda_fused_every_group(cuda_device, mode, G):
    """K2 bitwise equal to its plain version at every group size, whose
    register and thread geometry changes with G: groups of 256-chunks and
    of two chunks, from round 1 and from the last round alone, with and
    without a validity mask, the stable carries' riding values under tied
    tuples staying put."""
    rng = np.random.default_rng(G + mode.code)
    n = 1 << 18
    units = n // G
    flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
    launches = []
    for C in sorted({MIN_CHUNK, G // 2}):
        r_hi = bk.log2(G // C)
        launches += [bk.spec("fused", C, r_lo, r_hi)
                     for r_lo in sorted({1, r_hi})]
    for launch in launches:
        for valid in (None, flags.to(cuda_device)):
            a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 50))
                 .to(cuda_device) for _ in range(mode.n_arrays)]
            if mode.ride:  # a tail of tied (max, ..., pad) tuples
                _tie_tail(a, mode, n // 2)
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units, valid)
            bk.run_plain(launch, b, mode, units, valid)
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [bk.STABLE, bk.W3, bk.W4_BIG],
                         ids=lambda m: m.name)
def test_cuda_network_tail_mid_chunk(cuda_device, mode):
    """K1, K2, K3 and K4 at the main path's chunk and group bitwise equal
    to their plain versions when a stable carry's tied (max, max, pad)
    tail with distinct riding values starts mid-chunk, as a count= that is
    no multiple of C leaves it; W3 (no ties: every word compared) on the
    same shapes, with few distinct (hi, lo) so the third word decides. The
    three-word carries' K1 and K2 are csrc/wide.cuh's kernels."""
    rng = np.random.default_rng(17 + mode.code)
    n = 1 << 18
    C = CHUNK_CARRY
    r = bk.log2(n // C)
    launches = [bk.spec("chunk", C),
                bk.spec("fused", C, 1, tbit._fused_rounds(C, r, mode)),
                bk.spec("local", C, r)]
    launches += [bk.spec("cross", C, r, t_lo, span)
                 for t_lo, span in tbit._cross_spans(r, mode)]
    for launch in launches:
        a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 50))
             .to(cuda_device) for _ in range(mode.n_arrays)]
        if mode.ride:
            _tie_tail(a, mode, n - n // 8 - C // 2 - 3)
        b = [x.clone() for x in a]
        bk.run(launch, a, mode, n // launch.unit)
        bk.run_plain(launch, b, mode, n // launch.unit)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _cross_cases():
    """(mode, span) for every span of the 32-bit carries' cross kernel."""
    return [pytest.param(mode, s, id=f"{mode.name}-{s}")
            for mode in (bk.KEYS, bk.PAIRS, bk.STABLE)
            for s in range(1, mode.cross_cap + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,span", _cross_cases())
def test_cuda_cross_every_span(cuda_device, mode, span):
    """K3 bitwise equal to its plain version at every span up to the
    carry's cap, whose thread and tile geometry changes with the span: the
    round's lowest and highest stages on MIN_CHUNK chunks and on the main
    path's chunks, on a clipped grid, with and without a validity mask;
    the stable carry's riding values under tied tuples stay put."""
    rng = np.random.default_rng(100 * span + mode.code)
    r = mode.cross_cap
    for C in (MIN_CHUNK, CHUNK_KEYS if mode is bk.KEYS else CHUNK_CARRY):
        n = max(1 << 22, 2 * (C << r))
        units = n // (C << r) - 1
        flags = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32))
        for t_lo in sorted({0, r - span}):
            launch = bk.spec("cross", C, r, t_lo, span)
            for valid in (None, flags.to(cuda_device)):
                a = [torch.from_numpy(_u32(n, int(rng.integers(1 << 30)), 50))
                     .to(cuda_device) for _ in range(mode.n_arrays)]
                if mode.ride:  # a tail of tied (max, ..., pad) tuples
                    _tie_tail(a, mode, n // 2)
                b = [x.clone() for x in a]
                bk.run(launch, a, mode, units, valid)
                bk.run_plain(launch, b, mode, units, valid)
                torch.cuda.synchronize()
                for x, y in zip(a, b):
                    assert torch.equal(x.view(torch.int32),
                                       y.view(torch.int32)), (C, t_lo, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [512 << i for i in range(6)])
def test_cuda_block_sort_every_block(cuda_device, block, bits):
    """K7 bitwise equal to its plain version at every block size, whose
    thread geometry changes with the block, at both digit widths: uniform
    keys, five distinct keys, and keys that differ everywhere but in the
    digit (every lane of a warp a peer), keys and kv, at the lowest and
    the highest shift, with a last block closed by sentinel pads."""
    cfg = SortConfig(backend="radix", digit_bits=bits, block=block)
    rng = np.random.default_rng(block + bits)
    n = 1 << 18
    for kind in ("uniform", "few", "one digit"):
        for shift in (0, 32 - bits):
            keys = _u32(n, int(rng.integers(1 << 30)))
            if kind == "few":
                keys = rng.choice(keys[:5], n)
            elif kind == "one digit":
                digit = np.uint32(((1 << bits) - 1) << shift)
                keys = (keys & ~digit) | np.uint32(5 << shift)
            keys[-777:] = 0xFFFFFFFF
            dk = torch.from_numpy(keys).to(cuda_device)
            dv = torch.from_numpy(_u32(n, shift)).to(cuda_device)
            for kv in (False, True):
                vals = dv if kv else None
                want = k7.block_sort_plain(dk, vals, shift=shift, config=cfg,
                                           key_value=kv)
                got = k7.block_sort(dk, vals, shift=shift, config=cfg,
                                    key_value=kv)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), (kind, shift, kv)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [512 << i for i in range(6)])
def test_cuda_block_sort_walks_blocks(cuda_device, block, bits):
    """K7's resident thread blocks walk 2 or more blocks each: a block
    count that is no multiple of the grid (twice the card's SMs times the
    most blocks its threads let an SM hold, plus 7), bitwise equal to the
    plain version on uniform keys, two digits at every shift (about 16
    peers a lane), one digit and all-equal keys, with the index as the
    value, so that any break in stability shows, keys and kv, at the
    lowest and the highest shift."""
    cfg = SortConfig(backend="radix", digit_bits=bits, block=block)
    threads, _ = k7.sort_geometry(block)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    nblocks = 2 * sms * (2048 // threads) + 7
    n = nblocks * block
    rng = np.random.default_rng(block * 3 + bits)
    dv = torch.arange(n, dtype=torch.int32,
                      device=cuda_device).view(torch.uint32)
    base = _u32(n, block + bits)
    for kind in ("uniform", "two digits", "one digit", "all equal"):
        for shift in (0, 32 - bits):
            keys = base.copy()
            if kind == "two digits":
                keys = np.uint32(0x2A2A2A2A) + (keys & np.uint32(0x01010101))
            elif kind == "one digit":
                digit = np.uint32(((1 << bits) - 1) << shift)
                keys = (keys & ~digit) | np.uint32(5 << shift)
            elif kind == "all equal":
                keys = np.full(n, int(rng.integers(1 << 32)), np.uint32)
            dk = torch.from_numpy(keys).to(cuda_device)
            for kv in (False, True):
                vals = dv if kv else None
                want = k7.block_sort_plain(dk, vals, shift=shift, config=cfg,
                                           key_value=kv)
                got = k7.block_sort(dk, vals, shift=shift, config=cfg,
                                    key_value=kv)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), (kind, shift, kv)


@pytest.mark.cuda
def test_cuda_radix_sorter_full_size_matches_numpy(cuda_device):
    """The radix Sorter at 2^25 keys (the main path's size: 2048 blocks
    on 132 resident thread blocks): keys, stable and non-stable kv
    against numpy's stable argsort."""
    n = 1 << 25
    keys, vals = _u32(n, 25), _u32(n, 26)
    s = vrs.Sorter(n, config=SortConfig(backend="radix"))
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(s.sort(dk).cpu().numpy(), keys[order])
    for stable in (True, False):
        gk, gv = s.sort_key_value(dk, dv, stable=stable)
        np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
        np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])


MASK_COUNTS = (None, -3, 0, 1, 4095, 4096, "n-999", "n", "n+5")


def _as_i32(*ts):
    return [t.view(torch.int32) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("n", [radix.MIN_RADIX_N + 17, 1 << 25])
def test_cuda_mask_pad_and_restore_match_plain(cuda_device, n, kv):
    """K7's first pass on the caller's unpadded buffers (`size=`: the keys
    at or past the count and the pads loaded as 0xFFFFFFFF, the values
    past n as 0) and the tail kernel (`restore_tail`) bitwise equal to
    their plain versions over every count and none, on 16-byte aligned
    inputs and on views one word in (keys[1:]), which are not; genuine
    0xFFFFFFFF keys sit beside the masked tail. At the smaller n the
    count= sort on each view against numpy as well."""
    cfg = SortConfig(backend="radix")
    size = -(-n // cfg.block) * cfg.block
    k = _u32(n + 1, 31, 1 << 10)
    k[::61] = 0xFFFFFFFF
    k[n - 1001:n - 997] = 0xFFFFFFFF  # on both sides of count n - 999
    base_k = torch.from_numpy(k).to(cuda_device)
    base_v = torch.from_numpy(_u32(n + 1, 32)).to(cuda_device)
    for offset in (0, 1):
        keys = base_k[offset:offset + n]
        vals = base_v[offset:offset + n] if kv else None
        assert (keys.data_ptr() % 16 == 0) == (offset == 0)
        for count in MASK_COUNTS:
            count = {"n-999": n - 999, "n": n, "n+5": n + 5}.get(count,
                                                                  count)
            cnt = (None if count is None
                   else torch.tensor(count, device=cuda_device))
            for shift in (0, 24):
                args = dict(shift=shift, config=cfg, key_value=kv, size=size,
                            count=cnt)
                got = k7.block_sort(keys, vals, **args)
                want = k7.block_sort_plain(keys, vals, **args)
                for g, w in zip(_as_i32(*got[:-1]), _as_i32(*want[:-1])):
                    assert torch.equal(g, w), (offset, count, shift)
                assert torch.equal(got[-1], want[-1]), (offset, count, shift)
            if cnt is None:
                continue
            buf = torch.from_numpy(_u32(size, 33)).to(cuda_device)
            want_t = radix.restore_tail_plain(buf.clone(), keys, cnt)
            got_t = radix.restore_tail(buf, keys, cnt)
            assert got_t.data_ptr() == buf.data_ptr()  # in place
            assert torch.equal(*_as_i32(got_t, want_t)), (offset, count)
            if n > 1 << 20:
                continue
            c = min(max(count, 0), n)
            hk = k[offset:offset + n]
            order = np.argsort(hk[:c], kind="stable")
            if kv:
                gk, gv = radix.sort(keys, vals, count=cnt, config=cfg)
                hv = base_v[offset:offset + n].cpu().numpy()
                np.testing.assert_array_equal(
                    gv.cpu().numpy(), np.concatenate([hv[:c][order],
                                                      hv[c:]]))
            else:
                gk = radix.sort(keys, count=cnt, config=cfg)
            np.testing.assert_array_equal(
                gk.cpu().numpy(), np.concatenate([hk[:c][order], hk[c:]]))


@pytest.mark.cuda
def test_cuda_count_sort_holds_what_the_plain_sort_holds(cuda_device):
    """A 2^25 key-value count= sort on radix raises the allocator's peak
    exactly as much as the same sort without a count: both first passes
    read the caller's buffers, and no mask is held."""
    n = 1 << 25
    s = vrs.Sorter(n, config=SortConfig(backend="radix"))
    dk = torch.from_numpy(_u32(n, 34)).to(cuda_device)
    dv = torch.from_numpy(_u32(n, 35)).to(cuda_device)
    cnt = torch.tensor(n, device=cuda_device)

    def rise(**kw):
        s.sort_key_value(dk, dv, **kw)  # built and warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = s.sort_key_value(dk, dv, **kw)
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base
    assert rise(count=cnt) == rise()


@pytest.mark.cuda
def test_cuda_radix_peak_within_storage_requirements(cuda_device):
    """A 2^25 radix sort's allocator-peak rise (its scratch and output) is
    at most `storage_requirements()`: two ping-pong buffers (and value
    buffers) and one pass's tables, for uint32 keys and kv `count=`; and
    for uint64 keys by end_bit 45 the (word, position) pairs and the
    16-bit high words, and for kv the records."""
    n = 1 << 25
    rng = np.random.default_rng(47)
    k32 = torch.from_numpy(_u32(n, 48)).to(cuda_device)
    k64 = torch.from_numpy(rng.integers(0, 1 << 45, n, dtype=np.uint64)
                           .view(np.int64)).to(cuda_device).view(
        torch.uint64)
    vals = torch.from_numpy(_u32(n, 49)).to(cuda_device)
    cnt = torch.tensor(n - 5, device=cuda_device)
    cfg = SortConfig(backend="radix")
    s32 = vrs.Sorter(n, config=cfg)
    s64 = vrs.Sorter(n, key_dtype=torch.uint64, config=cfg)

    def rise(fn):
        fn()  # built and warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base
    for sorter, fn, kv in (
            (s32, lambda: s32.sort(k32), False),
            (s32, lambda: s32.sort_key_value(k32, vals, count=cnt), True),
            (s64, lambda: s64.sort(k64, end_bit=45), False),
            (s64, lambda: s64.sort_key_value(k64, vals, end_bit=45), True)):
        assert rise(fn) <= sorter.storage_requirements(key_value=kv)


U64_COUNTS = (None, -3, 0, 1, 4095, "n-999", "n", "n+5")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("n", [radix.MIN_RADIX_N + 17, 1 << 25])
def test_cuda_split_pad_and_gather_match_plain(cuda_device, n, width, kv):
    """The (word, position) path's split-pad and gather kernels bitwise
    equal to their plain versions over every count, on 16-byte aligned
    keys and on views one word in (keys[1:]), which are not: the
    split-pad's words, positions, records and high words (16 bits at end
    bit 45, 32 at 64); the high-word gather by a permutation of the padded
    positions; the output gather of the keys, or of keys and values from
    the records."""
    block = SortConfig().block
    size = -(-n // block) * block
    g = torch.Generator(device=cuda_device).manual_seed(n + width)
    base = torch.randint(-(1 << 63), (1 << 63) - 1, (n + 1,), generator=g,
                         device=cuda_device)
    base[::61] = -1
    base = (base.view(torch.uint64) if width == 64
            else base.to(torch.int32).view(torch.uint32))
    base_v = torch.from_numpy(_u32(n + 1, 36)).to(cuda_device)
    end_bits = (13, 45, 64) if width == 64 else (12,)
    for offset in (0, 1):
        keys = base[offset:offset + n]
        vals = base_v[offset:offset + n] if kv else None
        assert (keys.data_ptr() % 16 == 0) == (offset == 0)
        for end_bit in end_bits:
            for count in U64_COUNTS:
                count = {"n-999": n - 999, "n": n, "n+5": n + 5}.get(count,
                                                                      count)
                cnt = None if count is None else torch.tensor(
                    count, device=cuda_device)
                got = radix.split_pad(keys, vals, cnt, size, end_bit)
                want = radix.split_pad_plain(keys, vals, cnt, size, end_bit)
                assert [x is None for x in got] == [x is None for x in want]
                for a, b in zip(got, want):
                    if a is not None:
                        assert torch.equal(a.view(b.dtype), b), (offset,
                                                                 count)
                if end_bit > 32:
                    pos = torch.randperm(size, generator=g,
                                         device=cuda_device).to(
                        torch.int32).view(torch.uint32)
                    assert torch.equal(*_as_i32(
                        radix.gather_hi(pos, got[3]),
                        radix.gather_hi_plain(pos, want[3]))), (offset,
                                                                count)
        pos = torch.cat([torch.randperm(n, generator=g, device=cuda_device),
                         torch.arange(n, size, device=cuda_device)]).to(
            torch.int32).view(torch.uint32)
        rec = radix.split_pad(keys, vals, None, size, width)[2]
        got = radix.gather_out(pos, keys, rec)
        want = radix.gather_out_plain(pos, keys, rec)
        got, want = (got, want) if kv else ((got,), (want,))
        for a, b in zip(got, want):
            signed = torch.int64 if a.element_size() == 8 else torch.int32
            assert torch.equal(a.view(signed), b.view(signed)), offset


@pytest.mark.cuda
def test_cuda_tile_depth_sort_matches_plain_reference(cuda_device):
    """The benchmark cell's call on the card: a 2^25 uint64 Sorter under
    'auto' sorts uniform 45-bit keys and uint32 values stably by
    end_bit 45 on radix (split-pad, 6 passes, 2 gathers), bitwise as
    `plain_reference.sort_pairs_bits`."""
    from vulkan_radix_sort_tpu_torch import plain_reference
    n = 1 << 25
    rng = np.random.default_rng(45)
    keys = torch.from_numpy(rng.integers(0, 1 << 45, n, dtype=np.uint64)
                            .view(np.int64)).to(cuda_device).view(
        torch.uint64)
    vals = torch.from_numpy(_u32(n, 46)).to(cuda_device)
    s = vrs.Sorter(n, key_dtype=torch.uint64)
    with timing.LaunchTimer() as t:
        gk, gv = s.sort_key_value(keys, vals, stable=True, end_bit=45)
    names = [r["names"][0] for r in t.records]
    assert names == (["split_pad"] + ["block_sort", "spine", "place"] * 4
                     + ["gather"] + ["block_sort", "spine", "place"] * 2
                     + ["gather"])
    assert t.counts == {"vrs.backend.radix": 1, "vrs.radix.pass": 6,
                        "vrs.radix.first_pass.bulk": 1}
    wk, wv = plain_reference.sort_pairs_bits(keys, vals, 45)
    assert torch.equal(gk.view(torch.int64), wk.view(torch.int64))
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.cuda
def test_cuda_unaligned_buffer_is_refused(cuda_device):
    k = torch.zeros(1 << 12, dtype=torch.int32,
                    device=cuda_device).view(torch.uint32)
    with pytest.raises(ValueError, match="aligned"):
        bk.local([k[1:1 + 2048]], bk.KEYS, 1024, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        bk.fused([k[1:1 + 2048]], bk.KEYS, 256, 1, 3, 1)
    with pytest.raises(ValueError, match="aligned"):
        bk.cross([k[1:1 + 2048]], bk.KEYS, 256, 3, 0, 3, 1)
    with pytest.raises(ValueError, match="aligned"):
        bk.cross([k[1:1 + 2048], k[:2048]], bk.PAIRS, 256, 3, 0, 3, 1)
    with pytest.raises(ValueError, match="aligned"):
        k7.block_sort(k[1:1 + 2048], shift=0,
                      config=SortConfig(backend="radix", block=512))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, (1 << 20) + 77])
def test_cuda_sort_matches_numpy(cuda_device, n):
    keys, vals = _u32(n, 3, 61), _u32(n, 4)
    keys[::10] = 0xFFFFFFFF
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    np.testing.assert_array_equal(tbit.sort_u32(dk).cpu().numpy(),
                                  np.sort(keys))
    _, gv = tbit.sort_pairs_u32(dk, dv)
    np.testing.assert_array_equal(gv.cpu().numpy(),
                                  vals[np.argsort(keys, kind="stable")])
    _, gv = tbit.sort_pairs_u32(dk, dv, stable=False)
    np.testing.assert_array_equal(gv.cpu().numpy(),
                                  vals[np.lexsort((vals, keys))])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32],
                         ids=str)
def test_cuda_sorter_matches_numpy(cuda_device, dtype):
    n = (1 << 18) + 5
    if dtype == torch.float32:
        k = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    else:
        k = _u32(n, 9, 1 << 9).view(
            np.uint32 if dtype == torch.uint32 else np.int32)
    v = datagen.generate_values(n, seed=10)
    s = vrs.Sorter(n, key_dtype=dtype, config=SortConfig(backend="network"))
    assert s.backend == "network"
    dk = torch.from_numpy(k).to(cuda_device)
    dv = torch.from_numpy(v).to(cuda_device)
    got = s.sort(dk).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sort(k).view(np.uint32))
    m = n - 999
    _, gv = s.sort_key_value(dk, dv, count=torch.tensor(m,
                                                        device=cuda_device))
    order = np.argsort(k[:m], kind="stable")
    np.testing.assert_array_equal(gv.cpu().numpy()[:m], v[:m][order])
    np.testing.assert_array_equal(gv.cpu().numpy()[m:], v[m:])


@pytest.mark.cuda
@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_radix_kernels_match_plain(cuda_device, bits, key_value):
    """K7, the spine and K8 bitwise equal to their plain versions on the
    card at every shift of a sort, with few distinct digits and a last
    block closed by sentinel pads; each launch is counted, one of each
    kernel a pass."""
    cfg = SortConfig(backend="radix", digit_bits=bits)
    n = 1 << 18
    keys = _u32(n, bits + 10 * key_value, 1 << 12)
    keys[-777:] = 0xFFFFFFFF
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(_u32(n, 5)).to(cuda_device) if key_value else None
    timer = timing.LaunchTimer()
    for p in range(cfg.num_passes):
        kw = dict(shift=p * bits, config=cfg, key_value=key_value)
        with timer:
            got = k7.block_sort(dk, dv, **kw)
        want = k7.block_sort_plain(dk, dv, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        hist = want[-1]
        with timer:
            g, offsets = k8.spine(hist)
        want_g, want_off = k8.spine_plain(hist)
        torch.cuda.synchronize()
        assert torch.equal(g, want_g) and torch.equal(offsets, want_off)
        args = (want[0], hist, want_g, want[1] if key_value else None)
        with timer:
            got = k8.stream_place(*args, config=cfg, key_value=key_value,
                                  shift=p * bits, offsets=offsets)
        want = k8.stream_place_plain(*args, config=cfg, key_value=key_value)
        torch.cuda.synchronize()
        for a, b in zip(*((got, want) if key_value else ((got,), (want,)))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert _launched(timer) == dict.fromkeys(("block_sort", "spine",
                                              "place"), cfg.num_passes)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("nblocks", [0, 1, 5, 8, 9, 1000, 2048, 65536])
def test_cuda_spine_matches_plain(cuda_device, nblocks, bits):
    """The spine kernel bitwise equal to its plain version on histogram
    tables of every shape the cluster splits unevenly (fewer rows than
    blocks of the cluster, rows not a multiple of them), with empty
    columns."""
    rng = np.random.default_rng(nblocks + bits)
    # totals below 2^31, as a sort's counts are
    hist = rng.integers(0, 64, size=(nblocks, 1 << bits))
    hist[:, ::7] = 0
    dh = torch.from_numpy(hist.astype(np.int32)).to(cuda_device)
    got = k8.spine(dh)
    want = k8.spine_plain(dh)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [512 << i for i in range(6)])
def test_cuda_spine_and_place_every_block(cuda_device, block, bits):
    """The spine kernel and K8 (given the pass's shift and the spine's
    offsets) bitwise equal to their plain versions at every block size,
    whose K8 tiling changes with the block, at both digit widths: on K7's
    output for uniform keys, five distinct keys and one digit only, keys
    and kv, at the lowest and the highest shift, with a last block closed
    by sentinel pads."""
    cfg = SortConfig(backend="radix", digit_bits=bits, block=block)
    rng = np.random.default_rng(block + bits + 1)
    n = 1 << 18
    for kind in ("uniform", "few", "one digit"):
        for shift in (0, 32 - bits):
            keys = _u32(n, int(rng.integers(1 << 30)))
            if kind == "few":
                keys = rng.choice(keys[:5], n)
            elif kind == "one digit":
                digit = np.uint32(((1 << bits) - 1) << shift)
                keys = (keys & ~digit) | np.uint32(5 << shift)
            keys[-777:] = 0xFFFFFFFF
            dk = torch.from_numpy(keys).to(cuda_device)
            dv = torch.from_numpy(_u32(n, shift)).to(cuda_device)
            for kv in (False, True):
                out = k7.block_sort(dk, dv if kv else None, shift=shift,
                                    config=cfg, key_value=kv)
                hist = out[-1]
                g, offsets = k8.spine(hist)
                want_g, want_off = k8.spine_plain(hist)
                args = (out[0], hist, want_g, out[1] if kv else None)
                got = k8.stream_place(*args, config=cfg, key_value=kv,
                                      shift=shift, offsets=offsets)
                want = k8.stream_place_plain(*args, config=cfg, key_value=kv)
                torch.cuda.synchronize()
                assert torch.equal(g, want_g) and torch.equal(offsets,
                                                              want_off)
                for a, b in zip(*((got, want) if kv
                                  else ((got,), (want,)))):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), (kind, shift, kv)


@pytest.mark.cuda
def test_cuda_place_needs_the_shift(cuda_device):
    """On the card K8 takes each key's digit from the key: without the
    pass's shift it raises, and launches nothing."""
    cfg = SortConfig(backend="radix")
    dk = torch.from_numpy(_u32(1 << 16, 37)).to(cuda_device)
    y, hist = k7.block_sort(dk, shift=0, config=cfg)
    g, offsets = k8.spine(hist)
    with timing.LaunchTimer() as timer, pytest.raises(ValueError,
                                                      match="shift"):
        k8.stream_place(y, hist, g, config=cfg, offsets=offsets)
    assert _launched(timer) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("key_value", [False, True])
def test_cuda_place_without_offsets_runs_the_spine(cuda_device, key_value):
    """K8 called as the JAX package calls it, without the run offsets: the
    spine kernel computes them (one launch of each, no torch op) and the
    result is bitwise the plain version's."""
    cfg = SortConfig(backend="radix")
    dk = torch.from_numpy(_u32(1 << 17, 41)).to(cuda_device)
    dv = torch.from_numpy(_u32(1 << 17, 42)).to(cuda_device)
    out = k7.block_sort(dk, dv if key_value else None, shift=8, config=cfg,
                        key_value=key_value)
    g = k8.digit_offsets(out[-1])
    args = (out[0], out[-1], g, out[1] if key_value else None)
    with timing.LaunchTimer() as timer:
        got = k8.stream_place(*args, config=cfg, key_value=key_value,
                              shift=8)
    torch.cuda.synchronize()
    assert _launched(timer) == {"spine": 1, "place": 1}
    want = k8.stream_place_plain(*args, config=cfg, key_value=key_value)
    for a, b in zip(*((got, want) if key_value else ((got,), (want,)))):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_cuda_radix_pass_is_three_launches(cuda_device):
    """A radix keys sort's device work, from its first K7 to its last K8,
    is K7, the spine and K8 once a pass and nothing else: no torch op
    between them."""
    s = vrs.Sorter(1 << 20, config=SortConfig(backend="radix"))
    k = torch.from_numpy(_u32(1 << 20, 38)).to(cuda_device)
    s.sort(k)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s.sort(k)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = ("block_sort_kernel", "spine_kernel", "place_kernel")
    first = next(i for i, x in enumerate(names) if kernels[0] in x)
    last = max(i for i, x in enumerate(names) if kernels[2] in x)
    got = [next((k for k in kernels if k in x), x)
           for x in names[first:last + 1]]
    assert got == list(kernels) * s.config.num_passes


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [1000, (1 << 20) + 77])
def test_cuda_radix_sort_matches_numpy(cuda_device, n, bits):
    cfg = SortConfig(backend="radix", digit_bits=bits)
    keys, vals = _u32(n, 3, 61), _u32(n, 4)
    keys[::10] = 0xFFFFFFFF
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    np.testing.assert_array_equal(radix.sort(dk, config=cfg).cpu().numpy(),
                                  np.sort(keys))
    gk, gv = radix.sort(dk, dv, config=cfg)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])


@pytest.mark.cuda
def test_cuda_radix_stage_times(cuda_device):
    keys = torch.from_numpy(_u32(1 << 20, 8)).to(cuda_device)
    t = radix.stage_times(keys, SortConfig(backend="radix"), iters=2)
    assert all(t["per_pass"][k] > 0 for k in ("upsweep", "spine",
                                               "downsweep"))
    assert t["upsweep"] == 4 * t["per_pass"]["upsweep"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32],
                         ids=str)
def test_cuda_radix_sorter_matches_numpy(cuda_device, dtype):
    """The Sorter with backend='radix': stable either way, count= on the
    device."""
    n = (1 << 18) + 5
    if dtype == torch.float32:
        k = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    else:
        k = _u32(n, 9, 1 << 9).view(
            np.uint32 if dtype == torch.uint32 else np.int32)
    v = datagen.generate_values(n, seed=10)
    s = vrs.Sorter(n, key_dtype=dtype, config=SortConfig(backend="radix"))
    dk = torch.from_numpy(k).to(cuda_device)
    dv = torch.from_numpy(v).to(cuda_device)
    np.testing.assert_array_equal(s.sort(dk).cpu().numpy().view(np.uint32),
                                  np.sort(k).view(np.uint32))
    m = n - 999
    order = np.argsort(k[:m], kind="stable")
    for stable in (True, False):
        _, gv = s.sort_key_value(dk, dv, stable=stable,
                                 count=torch.tensor(m, device=cuda_device))
        np.testing.assert_array_equal(gv.cpu().numpy()[:m], v[:m][order])
        np.testing.assert_array_equal(gv.cpu().numpy()[m:], v[m:])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bk.MODES, ids=lambda m: m.name)
def test_cuda_local_gated_matches_plain(cuda_device, mode):
    """K6 bitwise equal to its plain version under a mask with zeros; it
    counts as local_gated, never as a K5 gate launch."""
    rng = np.random.default_rng(12)
    n, C, r = 1 << 20, CHUNK_CARRY, 3
    units = n // C
    valid = torch.from_numpy(rng.integers(0, 2, units).astype(np.int32)).to(
        cuda_device)
    a = [torch.from_numpy(_u32(n, 20 + i, 1000)).to(cuda_device)
         for i in range(mode.n_arrays)]
    b = [x.clone() for x in a]
    with timing.LaunchTimer() as timer:
        bk.local_gated(a, mode, C, r, units, valid)
    bk.run_plain(bk.spec("local_gated", C, r), b, mode, units, valid)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert _launched(timer) == {"local_gated": 1}


@pytest.mark.cuda
def test_cuda_merge_slots_match_numpy(cuda_device):
    """The slot merges on the card: 8 slots of 2^16 with empty, full and
    mid-block slots and genuine 0xFFFFFFFF keys, keys and stable kv."""
    rng = np.random.default_rng(13)
    n_slots, slot = 8, 1 << 16
    sizes = rng.integers(0, slot + 1, n_slots)
    sizes[[1, 2, 4, 7]] = [0, slot, 0, slot]
    kbuf = np.full((n_slots, slot), 0xFFFFFFFF, np.uint32)
    vbuf = np.zeros((n_slots, slot), np.uint32)
    runs = []
    for s, size in enumerate(sizes):
        k = _u32(size, 30 + s, 100)
        k[::7] = 0xFFFFFFFF
        kbuf[s, :size] = np.sort(k)
        vbuf[s, :size] = np.arange(size) + s * slot
        runs.append(s * slot + np.arange(size))
    flat = np.concatenate(runs)
    allk, allv = kbuf.reshape(-1)[flat], vbuf.reshape(-1)[flat]
    order = np.argsort(allk, kind="stable")
    dk = torch.from_numpy(kbuf.reshape(-1)).to(cuda_device)
    dv = torch.from_numpy(vbuf.reshape(-1)).to(cuda_device)
    ds = torch.from_numpy(sizes).to(cuda_device)
    got = tbit.merge_slots_u32(dk, ds, slot=slot).cpu().numpy()
    np.testing.assert_array_equal(got[:flat.size], allk[order])
    gk, gv = tbit.merge_slots_pairs(dk, dv, ds, slot=slot)
    np.testing.assert_array_equal(gk.cpu().numpy()[:flat.size], allk[order])
    np.testing.assert_array_equal(gv.cpu().numpy()[:flat.size], allv[order])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_cuda_sort_sharded_single_rank(cuda_device, backend, tmp_path):
    """sort_sharded / sort_pairs_sharded on a world of one rank on the
    card (the NCCL branch's only run on one card), with count=."""
    n = (1 << 20) + 3
    keys, vals = _u32(n, 14, 1 << 12), _u32(n, 15)
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    c = n - 777
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got = td.sort_sharded(dk, count=torch.tensor(c, device=cuda_device))
        gk, gv = td.sort_pairs_sharded(dk, dv, merge_resort=True)
    finally:
        dist.destroy_process_group()
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[:c], np.sort(keys[:c]))
    np.testing.assert_array_equal(got[c:], keys[c:])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])


@pytest.mark.cuda
def test_cuda_overlap_single_rank_gloo(cuda_device, tmp_path):
    """overlap=True through gloo on a world of one rank (nothing to split:
    it sorts as without it, as in the JAX package), keys and stable kv;
    then the half merge it runs on more ranks, `_bitonic_merge_halves`, on
    the card: the launch recorder sees its K3 and K4, and its keys equal
    numpy's."""
    n = (1 << 20) + 5
    keys, vals = _u32(n, 40, 1 << 16), _u32(n, 41)
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got = td.sort_sharded(dk, overlap=True)
        gk, gv = td.sort_pairs_sharded(dk, dv, overlap=True)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.cpu().numpy(), np.sort(keys))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])
    m = 1 << 20
    halves = [np.sort(_u32(m // 2 + d, 42 + d)) for d in (3, -3)]
    fill = np.full(m, 0xFFFFFFFF, np.uint32)
    sA, sB = fill.copy(), fill.copy()
    sA[:halves[0].size], sB[:halves[1].size] = halves
    with timing.LaunchTimer() as timer:
        merged = td._bitonic_merge_halves(
            torch.from_numpy(sA).to(cuda_device),
            torch.from_numpy(sB).to(cuda_device))
        torch.cuda.synchronize()
    names = [name for rec in timer.records for name in rec["names"]]
    assert names.count("local") == 1 and names.count("cross") >= 1
    np.testing.assert_array_equal(merged.cpu().numpy(),
                                  np.sort(np.concatenate(halves)))


@pytest.mark.cuda
def test_cuda_mesh_2d_single_rank(cuda_device, tmp_path):
    """make_mesh_2d(1, 1) on a world of one gloo rank: sort_sharded and
    sort_pairs_sharded with count= through it, the two-hop exchange over
    its one-rank dcn and ici groups on card tensors, and the reports'
    CUDA-event timing (dcn_report, phase_report) with their byte
    counts."""
    n = (1 << 20) + 7
    keys, vals = _u32(n, 43, 1 << 12), _u32(n, 44)
    dk = torch.from_numpy(keys).to(cuda_device)
    dv = torch.from_numpy(vals).to(cuda_device)
    c = n - 999
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = td.make_mesh_2d(1, 1)
        got = td.sort_sharded(dk, mesh, count=c)
        gk, gv = td.sort_pairs_sharded(dk, dv, mesh)
        out = torch.empty_like(dk)
        td._exchange([dk], [[n]], td._Group(None, cuda_device), mesh, n, 1,
                     [out])()
        rep = scaling.dcn_report(mesh, 1 << 20, iters=1)
        phases = scaling.phase_report(None, 1 << 20, iters=1)
    finally:
        dist.destroy_process_group()
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[:c], np.sort(keys[:c]))
    np.testing.assert_array_equal(got[c:], keys[c:])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), vals[order])
    np.testing.assert_array_equal(out.cpu().numpy(), keys)
    assert rep["dcn_bytes"] == 0 and rep["hop_b_ici_bytes"] == 4 << 20
    assert rep["mesh"] == (1, 1) and rep["use_kernels"]
    assert phases["devices"] == 1 and phases["full_s"] > 0


def _keys64(n, seed):
    """uint64 keys with few distinct high words, genuine maximum keys."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    k[::3] = (k[::3] & np.uint64(0xFFFFFFFF)) | np.uint64(0xDEADBEEF << 32)
    k[::101] = np.uint64(2**64 - 1)
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64],
                         ids=str)
def test_cuda_sorter64_matches_numpy(cuda_device, dtype):
    """64-bit keys through the Sorter on the card at 2^18 + 5: keys, stable
    and non-stable key-value, count= on the device; launches in both
    three-word carries. Oracles sort the encoded words (float64: IEEE total
    order, so -0.0 < 0.0)."""
    n = (1 << 18) + 5
    u = _keys64(n, 21)
    if dtype == torch.float64:
        k = np.random.default_rng(22).standard_normal(n)
        k[:4] = [0.0, -0.0, np.inf, -np.inf]
        b = k.view(np.uint64)
        u = b ^ np.where(b >> np.uint64(63) == 1, np.uint64(2**64 - 1),
                         np.uint64(1 << 63))
    else:
        k = u.view(np.int64) if dtype == torch.int64 else u
        u = u ^ np.uint64(1 << 63) if dtype == torch.int64 else u
    v = datagen.generate_values(n, seed=23)
    s = vrs.Sorter(n, key_dtype=dtype, config=SortConfig(backend="network"))
    dk = torch.from_numpy(k).to(cuda_device)
    dv = torch.from_numpy(v).to(cuda_device)
    got = s.sort(dk).cpu().numpy().view(np.uint64)
    np.testing.assert_array_equal(got, k[np.argsort(u, kind="stable")]
                                  .view(np.uint64))
    timer = timing.LaunchTimer()
    for stable in (True, False):
        order = (np.argsort(u, kind="stable") if stable
                 else np.lexsort((v, u)))
        with timer:
            gk, gv = s.sort_key_value(dk, dv, stable=stable)
        np.testing.assert_array_equal(gk.cpu().numpy().view(np.uint64),
                                      k[order].view(np.uint64))
        np.testing.assert_array_equal(gv.cpu().numpy(), v[order])
        m = n - 999
        cnt = torch.tensor(m, device=cuda_device)
        order = (np.argsort(u[:m], kind="stable") if stable
                 else np.lexsort((v[:m], u[:m])))
        with timer:
            gk, gv = s.sort_key_value(dk, dv, count=cnt, stable=stable)
        np.testing.assert_array_equal(gk.cpu().numpy()[:m].view(np.uint64),
                                      k[:m][order].view(np.uint64))
        np.testing.assert_array_equal(gv.cpu().numpy()[:m], v[:m][order])
        np.testing.assert_array_equal(gv.cpu().numpy()[m:], v[m:])
    launched = _launched(timer)
    assert all(launched.get(k, 0) > 0 for k in ("chunk", "fused", "cross",
                                                "local", "gate"))
    got = s.sort(dk, count=torch.tensor(n - 7, device=cuda_device))
    np.testing.assert_array_equal(
        got.cpu().numpy()[:n - 7].view(np.uint64),
        k[:n - 7][np.argsort(u[:n - 7], kind="stable")].view(np.uint64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_cuda_reference_backend_matches_numpy(cuda_device, dtype):
    """The reference backend on the card at 2^20 (one torch.sort of the
    sign-flipped signed view a sort): keys, stable and non-stable kv,
    each also with count= on the device, genuine maximum keys in the
    range; no kernel launched. Stable order either way."""
    n = 1 << 20
    if dtype == torch.uint64:
        k = _keys64(n, 50)
    else:
        k = _u32(n, 50)
        k[::101] = 0xFFFFFFFF
    v = datagen.generate_values(n, seed=51)
    s = vrs.Sorter(n, key_dtype=dtype, device=cuda_device,
                   config=SortConfig(backend="reference"))
    dk = torch.from_numpy(k).to(cuda_device)
    dv = torch.from_numpy(v).to(cuda_device)
    width = k.dtype
    with timing.LaunchTimer() as t:
        for m in (n, n - 999, 0, 1):
            cnt = None if m == n else torch.tensor(m, device=cuda_device)
            o = np.argsort(k[:m], kind="stable")
            wk = np.concatenate([k[:m][o], k[m:]])
            wv = np.concatenate([v[:m][o], v[m:]])
            got = s.sort(dk, count=cnt).cpu().numpy().view(width)
            np.testing.assert_array_equal(got, wk)
            for stable in (True, False):
                gk, gv = s.sort_key_value(dk, dv, count=cnt, stable=stable)
                np.testing.assert_array_equal(gk.cpu().numpy().view(width),
                                              wk)
                np.testing.assert_array_equal(gv.cpu().numpy(), wv)
        torch.cuda.synchronize()
    assert t.records == []


NET_LAUNCHES = ("chunk", "fused", "cross", "local")

STAGE_SORTS = {  # carry -> (stage_times call, the sort it times)
    "keys": (lambda k, v: tbit.stage_times(k, iters=3),
             lambda k, v: tbit.sort_u32(k)),
    "stable": (lambda k, v: tbit.stage_times_pairs(k, v, iters=3),
               lambda k, v: tbit.sort_pairs_u32(k, v)),
    "pairs": (lambda k, v: tbit.stage_times_pairs(k, v, iters=3,
                                                  stable=False),
              lambda k, v: tbit.sort_pairs_u32(k, v, stable=False)),
    "w3": (lambda k, v: tbit.stage_times_w64(k, v, v, iters=3,
                                             stable=False),
           lambda k, v: tbit.sort_pairs_w64(k, v, v, stable=False)),
    "w4_big": (lambda k, v: tbit.stage_times_w64(k, v, v, iters=3),
               lambda k, v: tbit.sort_pairs_w64(k, v, v)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STAGE_SORTS))
def test_cuda_stage_times(cuda_device, name):
    """stage_times* at 2^20 on the card: every launch timed, the stage sum
    positive, and the launch list as long as one sort's recorded launches."""
    n = 1 << 20
    k = torch.from_numpy(_u32(n, 30)).to(cuda_device)
    v = torch.from_numpy(_u32(n, 31)).to(cuda_device)
    stage_times, sort = STAGE_SORTS[name]
    st = stage_times(k, v)
    with timing.LaunchTimer() as timer:
        sort(k, v)
    torch.cuda.synchronize()
    launched = _launched(timer)
    assert len(st["kernels"]) == sum(launched.get(x, 0)
                                     for x in NET_LAUNCHES)
    assert st["mode"] == name
    assert all(t > 0 for _, t in st["kernels"])
    assert st["chunk"] > 0 and st["chunk"] + st["cross"] + st["local"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["network", "radix", "reference"])
def test_cuda_sort_timed(cuda_device, backend):
    n = 1 << 20
    s = vrs.Sorter(n, config=SortConfig(backend=backend))
    k = torch.from_numpy(_u32(n, 32)).to(cuda_device)
    t = s.sort_timed(k, iters=3)
    assert t.total_ns > 0 and t.cpu_ns > 0
    tk = s.sort_key_value_timed(k, k, iters=3)
    assert tk.total_ns > 0
    if backend == "reference":
        assert t.upsweep_ns == t.spine_ns == t.downsweep_ns == 0
        return
    assert t.upsweep_ns > 0 and t.downsweep_ns > 0
    if backend == "network":
        assert t.extra["mode"] == "keys" and tk.extra["mode"] == "stable"
    report = profiling.stage_report(k, SortConfig(backend=backend), iters=2)
    assert report.startswith(f"backend={backend} n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["sorted", "reverse", "constant", "uniform"])
def test_cuda_adaptive_network(cuda_device, dist):
    """Adaptive network sorts on the card against numpy: no network
    launch on the fast paths, launches on the others (uniform keys, and
    reverse keys in the key-value sort, which takes no flip)."""
    n = (1 << 20) + 3
    s = vrs.Sorter(n, config=SortConfig(backend="network", adaptive=True))
    k = datagen.generate_keys(n, seed=33, distribution=dist)
    dk = torch.from_numpy(k).to(cuda_device)
    with timing.LaunchTimer() as timer:
        got = s.sort(dk).cpu().numpy()
    np.testing.assert_array_equal(got, np.sort(k))
    launched = sum(_launched(timer).get(x, 0) for x in NET_LAUNCHES)
    assert (launched == 0) == (dist != "uniform")
    v = datagen.generate_values(n, seed=34)
    with timing.LaunchTimer() as timer:
        gk, gv = s.sort_key_value(dk, torch.from_numpy(v).to(cuda_device))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), k[order])
    np.testing.assert_array_equal(gv.cpu().numpy(), v[order])
    launched = sum(_launched(timer).get(x, 0) for x in NET_LAUNCHES)
    assert (launched == 0) == (dist in ("sorted", "constant"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["network", "radix", "reference"])
def test_cuda_harness_measure(cuda_device, name):
    b = harness.make_backend(name)
    harness.check_correctness(b, 1 << 16, nonstable=True)
    for sort in ("keys", "kv", "kvns"):
        r = harness.measure(b, 1 << 16, sort, iters=3)
        assert r.backend == name and r.gpu_ms > 0 and r.cpu_ms > 0


@pytest.mark.cuda
def test_cuda_profiling_trace(cuda_device, tmp_path):
    s = vrs.Sorter(1 << 20, config=SortConfig(backend="network"))
    k = torch.from_numpy(_u32(1 << 20, 35)).to(cuda_device)
    s.sort(k)
    with profiling.trace(str(tmp_path)) as prof:
        s.sort(k)
    (trace,) = tmp_path.iterdir()
    assert "chunk_kernel" in trace.read_text()
    assert any("chunk_kernel" in e.key for e in prof.key_averages())


@pytest.mark.cuda
def test_cuda_launch_timer_records_events(cuda_device):
    k = torch.from_numpy(_u32(1 << 18, 36)).to(cuda_device)
    with timing.LaunchTimer() as t:
        tbit.sort_u32(k)
    secs = t.seconds()
    assert len(secs) == len(t.records) > 0 and all(x > 0 for x in secs)


AUTO_KERNELS = {"network": {"chunk", "fused", "cross", "local", "gate"},
                "radix": {"block_sort", "spine", "place"},
                "reference": set()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,wide", list(sorter.AUTO), ids=str)
def test_cuda_auto_by_size_and_kind(cuda_device, kind, wide):
    """Sorter(n) with 'auto' on the card at the kind's cut - 1 and at the
    cut (at 2^25 where the kind has none): the kind's backend is the one
    the table gives, one sort of that kind launches that backend's kernels
    and no other, and the answer is numpy's (stable=False: the network's
    (key, value) order, else the stable one). A 64-bit sort is by the
    most bits radix serves (`AUTO_MAX_PASSES64`), so it takes the (word,
    position) path's kernels too; a whole 64-bit key goes to the
    reference at every n."""
    engine, cut = sorter.AUTO[kind, wide]
    dtype = torch.uint64 if wide else torch.uint32
    end_bit = 8 * sorter.AUTO_MAX_PASSES64 if wide else None
    for n, want in (((cut - 1, "reference"), (cut, engine)) if cut
                    else ((1 << 25, "reference"),)):
        s = vrs.Sorter(n, key_dtype=dtype)
        got = {"keys": s.backend, "kv": s.backend_kv,
               "kvns": s.backend_kvns}[kind]
        assert got == want == s.backend_for(kind, end_bit)
        if wide:
            assert s.backend_for(kind) == "reference"
            k = _keys64(n, 40)
        else:
            k = _u32(n, 40, 1 << 20)
        v = datagen.generate_values(n, seed=41)
        dk = torch.from_numpy(k).to(cuda_device)
        dv = torch.from_numpy(v).to(cuda_device)
        with timing.LaunchTimer() as t:
            out = (s.sort(dk, end_bit=end_bit) if kind == "keys" else
                   s.sort_key_value(dk, dv, stable=kind == "kv",
                                    end_bit=end_bit))
            torch.cuda.synchronize()
        names = {x for rec in t.records for x in rec["names"]}
        if want == "network":
            assert names and names <= AUTO_KERNELS["network"]
        elif want == "radix" and wide:
            assert names == AUTO_KERNELS[want] | {"split_pad", "gather"}
        else:
            assert names == AUTO_KERNELS[want]
        if wide:
            k_bits = k & np.uint64((1 << end_bit) - 1)
            order = np.argsort(k_bits, kind="stable")
        else:
            order = (np.lexsort((v, k)) if kind == "kvns" and
                     want == "network" else np.argsort(k, kind="stable"))
        if kind == "keys":
            np.testing.assert_array_equal(out.cpu().numpy(), k[order])
        else:
            np.testing.assert_array_equal(out[0].cpu().numpy(), k[order])
            np.testing.assert_array_equal(out[1].cpu().numpy(), v[order])
