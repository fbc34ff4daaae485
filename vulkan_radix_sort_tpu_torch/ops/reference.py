"""Reference backend: stable sorts expressed with `torch.sort`.

Counterpart of `vulkan_radix_sort_tpu/ops/reference.py` (`lax.sort`). It is
the port's non-network backend and the oracle its other paths are held to:
`std::sort` for keys and `std::stable_sort` of an index array for key-value,
as in the reference's bench/cpu_benchmark.cc. It is not the plain version
of any network kernel; those live beside the kernels in `bitonic_kernels`.
Keys are widened to int64 first, where every comparison is defined.
"""

from __future__ import annotations

import torch

from .bitops import max_like_u32, select_u32, widen_u32


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
