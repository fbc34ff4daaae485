"""Reference backend: stable sorts expressed with `torch.sort`.

Counterpart of `vulkan_radix_sort_tpu/ops/reference.py` (`lax.sort`). It is
the port's non-network backend and the oracle its other paths are held to:
`std::sort` for keys and `std::stable_sort` of an index array for key-value,
as in the reference's bench/cpu_benchmark.cc. It is not the plain version
of any network kernel; those live beside the kernels in `bitonic_kernels`.
Keys are widened to int64 first, where every comparison is defined; 64-bit
keys (the `*64` functions, encoded as uint64) are sorted as their int64
view with the sign bit flipped, which has the same order.
"""

from __future__ import annotations

import torch

from .bitops import (decode_i64, max_like_u32, max_like_u64, select_u32,
                     select_u64, widen_u32)


def _order(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(widen_u32(keys), stable=True).indices


def _gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)[perm].view(torch.uint32)


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of uint32 keys."""
    return _gather(keys, _order(keys))


def sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """Stable ascending key-value sort (values gathered by the key order)."""
    perm = _order(keys)
    return _gather(keys, perm), _gather(values, perm)


def _in_range(keys: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.arange(keys.numel(), device=keys.device) < count


def sort_keys_count(keys: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Sort only the first `count` keys; the tail stays untouched. `count`
    is a 0-d tensor on the keys' device and is never read on the host."""
    live = _in_range(keys, count)
    masked = select_u32(live, keys, max_like_u32(keys))
    return select_u32(live, sort_keys(masked), keys)


def sort_pairs_count(keys: torch.Tensor, values: torch.Tensor,
                     count: torch.Tensor):
    """Stable key-value sort of the first `count` pairs; tails untouched."""
    live = _in_range(keys, count)
    masked = select_u32(live, keys, max_like_u32(keys))
    k, v = sort_pairs(masked, values)
    return select_u32(live, k, keys), select_u32(live, v, values)


def _order64(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(decode_i64(keys), stable=True).indices


def _gather64(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64)[perm].view(torch.uint64)


def sort_keys64(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of uint64 keys."""
    return _gather64(keys, _order64(keys))


def sort_pairs64(keys: torch.Tensor, values: torch.Tensor):
    """Stable ascending key-value sort of uint64 keys, uint32 values."""
    perm = _order64(keys)
    return _gather64(keys, perm), _gather(values, perm)


def sort_keys64_count(keys: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """`sort_keys_count` for uint64 keys."""
    live = _in_range(keys, count)
    masked = select_u64(live, keys, max_like_u64(keys))
    return select_u64(live, sort_keys64(masked), keys)


def sort_pairs64_count(keys: torch.Tensor, values: torch.Tensor,
                       count: torch.Tensor):
    """`sort_pairs_count` for uint64 keys."""
    live = _in_range(keys, count)
    masked = select_u64(live, keys, max_like_u64(keys))
    k, v = sort_pairs64(masked, values)
    return select_u64(live, k, keys), select_u32(live, v, values)
