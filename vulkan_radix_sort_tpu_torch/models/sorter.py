"""The Sorter: a reusable sorter for keys up to max_n elements on one device.

Counterpart of `vulkan_radix_sort_tpu/models/sorter.py`, with the same
analogs of the reference host library's entry points
(include/vk_radix_sort.h:24-81):

  vrdxCreateSorter                    -> Sorter(...) / create_sorter(...)
  vrdxGetSorterStorageRequirements    -> Sorter.storage_requirements()
  vrdxGetSorterKeyValueStorageRequirements -> idem with key_value=True
  vrdxCmdSort                         -> Sorter.sort(keys)
  vrdxCmdSortIndirect                 -> Sorter.sort(keys, count=...)
  vrdxCmdSortKeyValue                 -> Sorter.sort_key_value(keys, values)
  vrdxCmdSortKeyValueIndirect         -> Sorter.sort_key_value(..., count=...)

Keys may be uint32, int32, float32, or (beyond the reference's uint32-only
API, as in the JAX package) uint64, int64 and float64, which sort as (hi,
lo) uint32 word pairs on the network, as (word, position) pairs on the
radix backend and as one torch.sort on the reference backend. uint32 and
uint64 keys may be sorted by their low `end_bit` bits alone (CUB's
end_bit: stably, the keys back whole), on every backend.

The Sorter owns the checks, the encoding, the backend choice, the
adaptive path and the spans and counters of a call; it hands the encoded
keys to one function, the backend's `sort` (`_BACKENDS`), which owns
`count=`, `end_bit` and the key width.

Each sorter picks one backend per kind of sort (keys, stable key-value,
stable=False key-value) from its max_n: `backend`, `backend_kv` and
`backend_kvns`. A named backend serves every kind; 'auto' is the
reference backend below the kind's measured cut and the kind's engine
from it (`AUTO`, `_pick_backend`), as the JAX package's 'auto' is XLA's
sort below its cuts and the network from them. A 64-bit call also weighs
its number of radix passes (`AUTO_MAX_PASSES64`, `Sorter.backend_for`).

A sorter lives on one device, the card unless the caller asks for the CPU.
A tensor on another device is refused, never moved. PyTorch runs eagerly,
so there is no compiled pipeline to cache: the kernels build once per
process on first use (see `_build`).
"""

from __future__ import annotations

import statistics
import time

import torch

from ..config import SortConfig, default_config, round_up
from ..ops import bitonic, bitops, radix, reference
from ..utils import timing
from ..utils.timing import StageTimes, time_fn


# 'auto' on a CUDA device, per sort kind and key width: (engine, cut).
# Below the cut the reference backend (one torch.sort) runs, from the
# cut the engine; a cut of None means the engine did not beat the
# reference at 2^25, so 'auto' is the reference at every n. The engine is
# the kernel backend with the most GItems/s at 2^25 among those that sort
# the kind (network and radix for 32-bit keys; for 64-bit keys radix, since
# the network lost to the reference at every size); the cut is the
# smallest swept n (2^14..2^25) from which it beats the reference at every
# larger swept size (chip_smoke.crossover), taken on the median of three
# sweeps in one run (chip_smoke.median_sweeps), since below 2^22 one
# sweep's times move up to 2x. The `[sweep-median]` lines of chip_smoke.py
# on one NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 5, call 2):
#   uint32, crossover vs reference: radix_keys, _kv, _kvns 2^23; network
#     null; at 2^23 radix 0.467 / 0.696 / 0.699 ms (keys / kv / kvns)
#     against the reference's 0.576 / 0.706 / 0.717, at 2^22 0.389 /
#     0.547 / 0.505 against 0.335 / 0.387 / 0.382; at 2^25 radix 1.578 /
#     2.406 / 2.398, the network 3.039 / 11.956 / 7.799, the reference
#     1.969 / 3.010 / 3.013;
#   uint64, crossover vs reference: network_keys, _kv, _kvns null; at
#     2^25 the network 9.178 / 19.873 / 16.016 ms, the reference 4.703 /
#     5.736 / 5.736 (an earlier run of the 64-bit sweep, which then timed
#     the network: it now times radix in its place, below).
# uint64 through radix, by end_bit 40, 48, 56 and 64 (5 to 8 passes; the
# same sweeps on the (word, position) path, PERF.md section 6):
#   crossover vs reference, keys / kv / kvns: 40 bits 2^21 / 2^22 / 2^21,
#     48 bits 2^22 / 2^23 / 2^22, 56 bits 2^22 / 2^22 / 2^23, 64 bits
#     null; at 2^25 radix against the reference, keys and kv: 40 bits
#     4.543 / 5.811 and 4.947 / 6.839 ms, 48 bits 5.000 / 5.910 and
#     5.419 / 6.930, 56 bits 5.756 / 6.005 and 6.208 / 7.032, 64 bits
#     6.217 / 4.762 and 6.688 / 5.786 (kvns as kv). A later single
#     sweep: 56 bits 5.755 / 6.068 and 6.159 / 7.073, every 5-7-pass
#     crossover 2^23, none at 64 bits.
# So a 64-bit kind's cut is the largest of its crossovers at 5-7 passes,
# and radix serves at most 7 (`AUTO_MAX_PASSES64`).
AUTO = {
    ("keys", False): ("radix", 1 << 23),
    ("kv", False): ("radix", 1 << 23),
    ("kvns", False): ("radix", 1 << 23),
    ("keys", True): ("radix", 1 << 22),
    ("kv", True): ("radix", 1 << 23),
    ("kvns", True): ("radix", 1 << 23),
}
# 'auto' on a CUDA device for 64-bit keys: the most radix passes (at 8-bit
# digits, ceil(end_bit / 8)) a call may take and still go to radix, the
# most at which radix beat the reference at 2^25 in every kind; a call of
# more goes to the reference (`Sorter.backend_for`).
AUTO_MAX_PASSES64 = 7


def _pick_backend(cfg: SortConfig, device: torch.device,
                  max_n: int | None = None, kind: str = "keys",
                  wide: bool = False) -> str:
    """The backend a sorter of `max_n` keys (64-bit with `wide`) runs for
    one kind of sort: 'keys', 'kv' (stable key-value) or 'kvns'
    (stable=False). A named backend passes through ('pallas' is already
    'radix'). 'auto' is the reference backend on the CPU, and on a CUDA
    device the reference below the kind's cut and its engine from the
    cut (AUTO). An unknown kind raises KeyError on every device."""
    if cfg.backend != "auto":
        return cfg.backend
    # look the kind up before the device check, so that a bad caller
    # fails on the CPU too, as in the JAX package
    engine, cut = AUTO[kind, wide]
    if device.type != "cuda" or cut is None or (max_n is not None
                                                and max_n < cut):
        return "reference"
    return engine


# Each backend's module: its `sort` owns `count=`, `end_bit` and the key
# width behind one signature.
_BACKENDS = {"radix": radix, "network": bitonic, "reference": reference}

# The counter of each backend that can serve a call ('adaptive': the
# opt-in fast path answered it with a copy or a flip).
_SERVED = {b: f"vrs.backend.{b}"
           for b in ("radix", "network", "reference", "adaptive")}


def _served(backend: str, n: int) -> None:
    """Count the backend whose work gives a call's result: radix hands
    n < MIN_RADIX_N to the reference."""
    if backend == "radix" and n < radix.MIN_RADIX_N:
        backend = "reference"
    timing.count(_SERVED[backend])


def _order_view(u: torch.Tensor) -> torch.Tensor:
    """A signed view of encoded keys (uint32 or uint64) with their order:
    the sign bit flipped. torch has no `<` for uint32 or uint64."""
    if u.dtype == torch.uint64:
        return u.view(torch.int64) ^ -(1 << 63)
    return u.view(torch.int32) ^ -(1 << 31)


def _flip(u: torch.Tensor) -> torch.Tensor:
    """u reversed, through its signed bit pattern (uint flip has no
    kernel)."""
    signed = torch.int64 if u.dtype == torch.uint64 else torch.int32
    return u.view(signed).flip(0).view(u.dtype)


def _adaptive_sort(u: torch.Tensor, slow):
    """Opt-in adaptive fast path (SortConfig.adaptive) of a keys sort, as
    the JAX package's: one detection pass over the encoded keys finds
    already-sorted, reverse-sorted and constant inputs and answers them
    with a copy or a flip; anything else goes to `slow`. Equal keys are
    bitwise interchangeable, so a flip of non-increasing keys is their
    ascending sort. The branch is one host read of the two flags (a sync
    with the card); both branches are never computed."""
    if u.numel() < 2:
        timing.count(_SERVED["adaptive"])
        return u.clone()
    s = _order_view(u)
    nondec, noninc = torch.stack(((s[1:] >= s[:-1]).all(),
                                  (s[1:] <= s[:-1]).all())).tolist()
    if nondec or noninc:
        timing.count(_SERVED["adaptive"])
        return u.clone() if nondec else _flip(u)
    return slow(u)


def _adaptive_sort_pairs(u: torch.Tensor, v: torch.Tensor, slow):
    """The key-value fast path: identity copies on non-decreasing keys,
    the stable answer and a valid non-stable one. Reverse-sorted keys go
    to `slow`: a flip would reverse the order of equal keys."""
    if u.numel() < 2:
        timing.count(_SERVED["adaptive"])
        return u.clone(), v.clone()
    s = _order_view(u)
    if (s[1:] >= s[:-1]).all().item():
        timing.count(_SERVED["adaptive"])
        return u.clone(), v.clone()
    return slow(u, v)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to sort on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class Sorter:
    """Ascending sorts of 32- and 64-bit keys and key-value pairs (uint32
    values) on one device, each kind on its own backend (`backend`,
    `backend_kv`, `backend_kvns`)."""

    def __init__(self, max_n: int, key_dtype=torch.uint32,
                 config: SortConfig | None = None, device="cuda"):
        if max_n <= 0:
            raise ValueError("max_n must be positive")
        self.wide = key_dtype in bitops.WIDE_DTYPES
        encoders = bitops.ENCODERS64 if self.wide else bitops.ENCODERS
        if key_dtype not in encoders:
            raise ValueError(f"unsupported key dtype {key_dtype}")
        self.config = config or default_config()
        self.max_n = int(max_n)
        self.key_dtype = key_dtype
        self.device = _resolve_device(device)
        self._encode, self._decode = encoders[key_dtype]
        # one backend per kind of sort, decided by max_n, not by the n of
        # each call (as in the JAX package)
        self.backend, self.backend_kv, self.backend_kvns = (
            _pick_backend(self.config, self.device, self.max_n, kind,
                          self.wide) for kind in ("keys", "kv", "kvns"))

    def backend_for(self, kind: str, end_bit: int | None = None) -> str:
        """The backend of one call of `kind` ('keys', 'kv' or 'kvns') by
        bits [0, end_bit) (None: every bit): the kind's backend, except
        that 'auto' sends a 64-bit call of more radix passes than
        `AUTO_MAX_PASSES64` to the reference."""
        backend = {"keys": self.backend, "kv": self.backend_kv,
                   "kvns": self.backend_kvns}[kind]
        if (backend == "radix" and self.config.backend == "auto"
                and self.wide and radix.num_passes(
                    end_bit or 64, self.config) > AUTO_MAX_PASSES64):
            return "reference"
        return backend

    def _end_bit(self, end_bit: int | None) -> int | None:
        """`end_bit` checked: 1 to the key width, for uint32 and uint64
        keys only; None (every bit) for None or the width."""
        if end_bit is None:
            return None
        if self.key_dtype not in (torch.uint32, torch.uint64):
            raise ValueError(f"end_bit orders the bits of unsigned keys; "
                             f"the keys are {self.key_dtype}")
        width = 64 if self.wide else 32
        if not 1 <= end_bit <= width:
            raise ValueError(f"end_bit {end_bit} outside 1..{width}")
        return None if end_bit == width else end_bit

    # -- storage sizing (analog of h.in:279-308) ---------------------------

    def storage_requirements(self, key_value: bool = False) -> int:
        """Estimated bytes of scratch a sort holds on the device.

        network: the padded buffers the kernels sort in place (keys, plus
        the index tiebreak and values for stable key-value). radix: the two
        ping-pong key buffers (and two value buffers) padded to a block
        multiple, one pass's (nblocks, radix) histogram and run offsets,
        and the spine's digit totals and offsets. reference: the flipped
        int32 view of the keys, torch.sort's values and int64 indices, the
        output keys (and the gathered values). 64-bit keys, any backend:
        the padded (hi, lo) word buffers (plus the index tiebreak and
        values for key-value) and the 8-byte input and output keys, as in
        the JAX package; on radix the (word, position) path's two
        ping-pong pairs of padded word and position buffers, one pass's
        tables, the 16-bit high words of an end bit up to 48 and, for
        key-value, the 16-byte (key, value) records, which also bound the
        output's gather. The backend sized is the kind's: `backend_kv`
        for key-value.
        """
        backend = self.backend_kv if key_value else self.backend
        if self.wide and backend == "radix":
            cfg = self.config
            n = round_up(self.max_n, cfg.block)
            tables = 2 * (n // cfg.block) * cfg.radix + 2 * cfg.radix
            return 4 * ((8 if key_value else 4) * n + tables) + 2 * n
        if self.wide:
            np2 = 1 << max(8, (self.max_n - 1).bit_length())
            return 4 * np2 * (4 if key_value else 2) + 2 * 8 * self.max_n
        if backend == "network":
            np2 = 1 << max(8, (self.max_n - 1).bit_length())
            return 4 * np2 * (3 if key_value else 1)
        if backend == "radix":
            cfg = self.config
            n = round_up(self.max_n, cfg.block)
            tables = 2 * (n // cfg.block) * cfg.radix + 2 * cfg.radix
            return 4 * (2 * n * (2 if key_value else 1) + tables)
        return self.max_n * (4 * 3 + 8 + (4 if key_value else 0))

    # -- checks ------------------------------------------------------------

    def _check(self, keys, values=None):
        if keys.dim() != 1:
            raise ValueError("keys must be rank-1")
        if keys.numel() > self.max_n:
            raise ValueError(f"n={keys.numel()} exceeds max_n={self.max_n}")
        if keys.dtype != self.key_dtype:
            raise TypeError(f"expected key dtype {self.key_dtype}, "
                            f"got {keys.dtype}")
        if keys.device != self.device:
            raise ValueError(f"keys live on {keys.device}, the sorter on "
                             f"{self.device}")
        if values is not None:
            if values.shape != keys.shape:
                raise ValueError("values must match keys shape")
            if values.dtype != torch.uint32:
                raise TypeError(f"values must be uint32, got {values.dtype}")
            if values.device != self.device:
                raise ValueError(f"values live on {values.device}, the "
                                 f"sorter on {self.device}")

    # -- public API --------------------------------------------------------

    def sort(self, keys: torch.Tensor, count=None,
             end_bit: int | None = None) -> torch.Tensor:
        """Ascending sort. `count` (int or 0-d device tensor) sorts only the
        prefix and leaves the tail untouched: the reference's indirect
        path. `end_bit` (uint32 and uint64 keys, 1 to the width) orders
        the keys by bits [0, end_bit) alone, stably, and gives them back
        whole, as CUB's end_bit. With SortConfig.adaptive and neither,
        sorted, reverse-sorted and constant keys skip the engine."""
        end_bit = self._end_bit(end_bit)
        backend = self.backend_for("keys", end_bit)
        with timing.span("vrs.sort", n=keys.numel(), backend=backend,
                         count=count is not None):
            return self._run(keys, None, count, end_bit, True, backend)

    def sort_key_value(self, keys: torch.Tensor, values: torch.Tensor,
                       count=None, stable: bool = True,
                       end_bit: int | None = None):
        """Ascending key-value sort; values ride as a separate uint32 buffer.

        stable=True matches the reference's std::stable_sort contract
        (on `backend_kv`). stable=False (on `backend_kvns`) lets the
        network compare (key, value) and drop the index carry: equal keys
        then come out by ascending value. The radix and reference backends
        are stable either way, which is also a valid answer to
        stable=False: so under 'auto' the order of equal keys may change
        at a cut, and only the multiset of pairs per key is the contract.
        `end_bit` as in `sort`: a call with it is stable on every backend.
        With SortConfig.adaptive and neither `count` nor `end_bit`, keys
        already in non-decreasing order come back as they are (with
        copies), the stable answer and a valid non-stable one.
        """
        end_bit = self._end_bit(end_bit)
        backend = self.backend_for("kv" if stable else "kvns", end_bit)
        with timing.span("vrs.sort_key_value", n=keys.numel(),
                         backend=backend, count=count is not None):
            return self._run(keys, values, count, end_bit, stable, backend)

    def _run(self, keys: torch.Tensor, values, count, end_bit: int | None,
             stable: bool, backend: str):
        """The one dispatch: the checks, the encoding, the adaptive path
        (neither `count` nor `end_bit`), the served backend's counter and
        its `sort`, which owns `count=`, `end_bit` and the key width
        (`_BACKENDS`), and the decoding."""
        self._check(keys, values)
        u = self._encode(keys)
        cnt = bitops.count_tensor(count, self.device)

        def slow(u, v=None):
            _served(backend, u.numel())
            return _BACKENDS[backend].sort(u, v, count=cnt, end_bit=end_bit,
                                           stable=stable, config=self.config)
        if not self.config.adaptive or cnt is not None or end_bit is not None:
            out = slow(u, values)
        elif values is None:
            out = _adaptive_sort(u, slow)
        else:
            out = _adaptive_sort_pairs(u, values, slow)
        if values is None:
            return self._decode(out)
        return self._decode(out[0]), out[1]

    # -- timing queries (analog of the timestamps, h.in:39-50) -------------

    def _totals(self, fn, args, iters: int) -> StageTimes:
        """total_ns: device time per call (CUDA events, `time_fn`);
        cpu_ns: the median host wall clock of a call and a synchronize,
        the reference's submit-to-fence time (vulkan_benchmark.cc:299-302).
        Every call sorts the same input."""
        if self.device.type != "cuda":
            raise RuntimeError("sort_timed and sort_key_value_timed measure "
                               "device time: use a sorter on a CUDA device")
        t = StageTimes()
        t.total_ns = time_fn(fn, *args, iters=iters) * 1e9
        walls = []
        for _ in range(max(1, iters)):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize(self.device)
            walls.append(time.perf_counter() - t0)
        t.cpu_ns = statistics.median(walls) * 1e9
        return t

    @staticmethod
    def _network_stages(t: StageTimes, stage: dict) -> StageTimes:
        # chunk sorts play the upsweep's part (per-block work), the cross
        # passes the spine's (movement between blocks), the local passes
        # the downsweep's
        t.upsweep_ns = stage["chunk"] * 1e9
        t.spine_ns = stage["cross"] * 1e9
        t.downsweep_ns = stage["local"] * 1e9
        t.extra = stage
        return t

    def sort_timed(self, keys: torch.Tensor, iters: int = 10) -> StageTimes:
        """Times of `sort(keys)` on the card: totals, and where `backend`
        (the keys kind's) is the network or radix per stage
        (`bitonic.stage_times*`, `radix.stage_times`, whose dict lands in
        `extra`). The reference backend, and radix on 64-bit keys, fill
        the totals only. A CPU sorter raises: nothing here times the
        CPU."""
        self._check(keys)
        t = self._totals(self.sort, (keys,), iters)
        u = self._encode(keys)
        backend = self.backend_for("keys")
        if backend == "radix" and not self.wide:
            stage = radix.stage_times(u, self.config, iters=iters)
            t.upsweep_ns = stage["upsweep"] * 1e9
            t.spine_ns = stage["spine"] * 1e9
            t.downsweep_ns = stage["downsweep"] * 1e9
            t.extra = stage
        elif backend == "network":
            stage = (bitonic.stage_times_w64(*bitops.split_u64(u),
                                             chunk=self.config.chunk_carry,
                                             iters=iters)
                     if self.wide else
                     bitonic.stage_times(u, chunk=self.config.chunk_keys,
                                         iters=iters))
            self._network_stages(t, stage)
        return t

    def sort_key_value_timed(self, keys: torch.Tensor, values: torch.Tensor,
                             stable: bool = True,
                             iters: int = 10) -> StageTimes:
        """`sort_timed` for `sort_key_value(keys, values, stable=stable)`;
        per stage only where the kind's backend (`backend_kv`, or
        `backend_kvns` for stable=False) is the network (the radix
        backend's stage times are of a keys pass), `extra["mode"]` naming
        the carry that ran."""
        self._check(keys, values)
        t = self._totals(lambda k, v: self.sort_key_value(k, v,
                                                          stable=stable),
                         (keys, values), iters)
        if self.backend_for("kv" if stable else "kvns") != "network":
            return t
        u = self._encode(keys)
        chunk = self.config.chunk_carry
        stage = (bitonic.stage_times_w64(*bitops.split_u64(u), values,
                                         chunk=chunk, iters=iters,
                                         stable=stable)
                 if self.wide else
                 bitonic.stage_times_pairs(u, values, chunk=chunk,
                                           iters=iters, stable=stable))
        return self._network_stages(t, stage)


def create_sorter(max_n: int, key_dtype=torch.uint32, config=None,
                  device="cuda", **kw) -> Sorter:
    """vrdxCreateSorter analog (h.in:141-265).

    Takes either `config=SortConfig(...)` or SortConfig fields as keywords
    (`backend=`, `chunk=`, ...), not both; unknown keywords raise.
    """
    unknown = set(kw) - set(SortConfig.__dataclass_fields__)
    if unknown:
        raise TypeError(f"unknown sorter options: {sorted(unknown)}")
    if kw:
        if config is not None:
            raise TypeError("pass either config= or SortConfig field "
                            "keywords, not both")
        config = SortConfig(**kw)
    return Sorter(max_n, key_dtype=key_dtype, config=config, device=device)
