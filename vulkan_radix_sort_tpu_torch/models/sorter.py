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

A sorter lives on one device, the card unless the caller asks for the CPU.
A tensor on another device is refused, never moved. PyTorch runs eagerly,
so there is no compiled pipeline to cache: the kernels build once per
process on first use (see `_build`).
"""

from __future__ import annotations

import torch

from ..config import SortConfig, default_config, round_up
from ..ops import bitonic, bitops, radix, reference

_NOT_YET = "is not ported yet"


def _pick_backend(cfg: SortConfig, device: torch.device) -> str:
    """'auto' is the network on a CUDA device at every size (no crossover
    against torch.sort or the radix backend has been measured on the H100
    yet) and the reference backend on the CPU. 'radix' is asked for by
    name (or by its alias 'pallas')."""
    if cfg.backend != "auto":
        return cfg.backend
    return "network" if device.type == "cuda" else "reference"


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
    """Ascending sorts of 32-bit keys and key-value pairs on one device."""

    def __init__(self, max_n: int, key_dtype=torch.uint32,
                 config: SortConfig | None = None, device="cuda"):
        if max_n <= 0:
            raise ValueError("max_n must be positive")
        if key_dtype in bitops.WIDE_DTYPES:
            raise NotImplementedError(f"{key_dtype} keys {_NOT_YET}")
        if key_dtype not in bitops.ENCODERS:
            raise ValueError(f"unsupported key dtype {key_dtype}")
        self.config = config or default_config()
        self.max_n = int(max_n)
        self.key_dtype = key_dtype
        self.device = _resolve_device(device)
        self._encode, self._decode = bitops.ENCODERS[key_dtype]
        self.backend = _pick_backend(self.config, self.device)

    # -- storage sizing (analog of h.in:279-308) ---------------------------

    def storage_requirements(self, key_value: bool = False) -> int:
        """Estimated bytes of scratch a sort holds on the device.

        network: the padded buffers the kernels sort in place (keys, plus
        the index tiebreak and values for stable key-value). radix: the two
        ping-pong key buffers (and two value buffers) padded to a block
        multiple, one pass's (nblocks, radix) histogram and run offsets,
        and the spine's digit totals and offsets. reference: int64-widened
        keys, torch.sort's int64 values and indices, and the gathered
        uint32 outputs.
        """
        if self.backend == "network":
            np2 = 1 << max(8, (self.max_n - 1).bit_length())
            return 4 * np2 * (3 if key_value else 1)
        if self.backend == "radix":
            cfg = self.config
            n = round_up(self.max_n, cfg.block)
            tables = 2 * (n // cfg.block) * cfg.radix + 2 * cfg.radix
            return 4 * (2 * n * (2 if key_value else 1) + tables)
        return self.max_n * (8 * 3 + 4 * (2 if key_value else 1))

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

    def _live(self, n: int, count: torch.Tensor) -> torch.Tensor:
        return torch.arange(n, device=self.device) < count

    # -- public API --------------------------------------------------------

    def sort(self, keys: torch.Tensor, count=None) -> torch.Tensor:
        """Ascending sort. `count` (int or 0-d device tensor) sorts only the
        prefix and leaves the tail untouched: the reference's indirect
        path."""
        self._check(keys)
        u = self._encode(keys)
        if count is None:
            if self.backend == "network":
                out = bitonic.sort_u32(u, chunk=self.config.chunk_keys)
            elif self.backend == "radix":
                out = radix.sort_u32(u, config=self.config)
            else:
                out = reference.sort_keys(u)
            return self._decode(out)
        cnt = bitonic.count_tensor(count, self.device)
        if self.backend == "reference":
            return self._decode(reference.sort_keys_count(u, cnt))
        live = self._live(u.numel(), cnt)
        # The first `count` slots of the masked keys-only sort are exactly
        # the sorted prefix: sentinels and genuine 0xFFFFFFFF keys are
        # indistinguishable in the output, so no index carry is needed.
        masked = bitops.select_u32(live, u, bitops.max_like_u32(u))
        if self.backend == "network":
            k = bitonic.sort_u32(masked, cnt, chunk=self.config.chunk_keys)
        else:  # radix sorts every pass in full: count only masks
            k = radix.sort_u32(masked, config=self.config)
        return self._decode(bitops.select_u32(live, k, u))

    def sort_key_value(self, keys: torch.Tensor, values: torch.Tensor,
                       count=None, stable: bool = True):
        """Ascending key-value sort; values ride as a separate uint32 buffer.

        stable=True matches the reference's std::stable_sort contract.
        stable=False lets the network compare (key, value) and drop the
        index carry: equal keys then come out by ascending value. The
        radix and reference backends are stable either way, which is also
        a valid answer to stable=False.
        """
        self._check(keys, values)
        u = self._encode(keys)
        if count is None:
            if self.backend == "network":
                k, v = bitonic.sort_pairs_u32(
                    u, values, chunk=self.config.chunk_carry, stable=stable)
            elif self.backend == "radix":
                k, v = radix.sort_pairs_u32(u, values, config=self.config)
            else:
                k, v = reference.sort_pairs(u, values)
            return self._decode(k), v
        cnt = bitonic.count_tensor(count, self.device)
        if self.backend == "reference":
            k, v = reference.sort_pairs_count(u, values, cnt)
            return self._decode(k), v
        live = self._live(u.numel(), cnt)
        masked = bitops.select_u32(live, u, bitops.max_like_u32(u))
        if self.backend == "radix":
            # stable either way: the masked tail, behind every genuine
            # 0xFFFFFFFF key in input order, stays behind it
            k, v = radix.sort_pairs_u32(masked, values, config=self.config)
        else:
            # non-stable: mask values too, making the masked tail the
            # lexicographic maximum, so genuine (max key, max value) pairs
            # are bitwise interchangeable with it and the prefix stays exact
            mv = values if stable else bitops.select_u32(
                live, values, bitops.max_like_u32(values))
            k, v = bitonic.sort_pairs_u32(masked, mv, cnt,
                                          chunk=self.config.chunk_carry,
                                          stable=stable)
        return (self._decode(bitops.select_u32(live, k, u)),
                bitops.select_u32(live, v, values))

    def sort_timed(self, keys, iters: int = 10):
        raise NotImplementedError(f"per-stage timing {_NOT_YET}")

    def sort_key_value_timed(self, keys, values, stable: bool = True,
                             iters: int = 10):
        raise NotImplementedError(f"per-stage timing {_NOT_YET}")


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
