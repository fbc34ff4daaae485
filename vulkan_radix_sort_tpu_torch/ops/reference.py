"""Reference backend: each sort is one `torch.sort`.

Counterpart of `vulkan_radix_sort_tpu/ops/reference.py`, whose `sort_keys`
is one `jnp.sort` and whose `sort_pairs` is one stable `lax.sort` of
(keys, values), and of the JAX Sorter's 64-bit reference path,
`dec(jnp.sort(enc(keys)))`. It is the port's non-network backend and the
oracle its other paths are held to: `std::sort` for keys and
`std::stable_sort` of an index array for key-value, as in the reference's
bench/cpu_benchmark.cc. It is not the plain version of any kernel; those
live beside the kernels in `bitonic_kernels`, `block_sort` and
`stream_place`.

torch has no CUDA sort for uint32 or uint64, so the keys are sorted as
their signed view with the sign bit flipped (`bitops.decode_i32` /
`decode_i64`), which has the unsigned order and the same width, and the
sorted values are flipped back (`encode_i32` / `encode_i64`). A keys sort
uses the sorted values alone; a pair sort is one stable sort whose
indices gather the values, never the keys; a sort by the low `end_bit`
bits (`sort_bits`) gathers the keys too, since they come back whole.
"""

from __future__ import annotations

import torch

from .bitops import (decode_i32, decode_i64, encode_i32, encode_i64,
                     in_range, low_bits, max_like_u32, max_like_u64,
                     select_u32, select_u64)

# uint dtype -> (to the signed view with the same order, and back)
_SIGNED = {torch.uint32: (decode_i32, encode_i32),
           torch.uint64: (decode_i64, encode_i64)}


def _sort(keys: torch.Tensor, stable: bool = False):
    """(sorted keys, permutation): one torch.sort of the flipped view."""
    to_signed, to_unsigned = _SIGNED[keys.dtype]
    s, perm = torch.sort(to_signed(keys), stable=stable)
    return to_unsigned(s), perm


def _take(values: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """uint32 values gathered by `perm`, through their int32 view."""
    return values.view(torch.int32)[perm].view(torch.uint32)


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of uint32 keys (equal keys are equal bits, so
    stability is irrelevant)."""
    return _sort(keys)[0]


def sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """Stable ascending key-value sort: the values gathered by the keys'
    stable order."""
    k, perm = _sort(keys, stable=True)
    return k, _take(values, perm)


def sort_keys_count(keys: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Sort only the first `count` keys; the tail stays untouched. `count`
    is a 0-d tensor on the keys' device and is never read on the host."""
    live = in_range(keys, count)
    masked = select_u32(live, keys, max_like_u32(keys))
    return select_u32(live, sort_keys(masked), keys)


def sort_pairs_count(keys: torch.Tensor, values: torch.Tensor,
                     count: torch.Tensor):
    """Stable key-value sort of the first `count` pairs; tails untouched.
    The masked tail holds 0xFFFFFFFF keys at the largest indices, so the
    stable sort leaves it behind every genuine 0xFFFFFFFF key."""
    live = in_range(keys, count)
    masked = select_u32(live, keys, max_like_u32(keys))
    k, v = sort_pairs(masked, values)
    return select_u32(live, k, keys), select_u32(live, v, values)


def sort_keys64(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of uint64 keys."""
    return _sort(keys)[0]


def sort_pairs64(keys: torch.Tensor, values: torch.Tensor):
    """Stable ascending key-value sort of uint64 keys, uint32 values."""
    k, perm = _sort(keys, stable=True)
    return k, _take(values, perm)


def sort_keys64_count(keys: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """`sort_keys_count` for uint64 keys."""
    live = in_range(keys, count)
    masked = select_u64(live, keys, max_like_u64(keys))
    return select_u64(live, sort_keys64(masked), keys)


def sort_pairs64_count(keys: torch.Tensor, values: torch.Tensor,
                       count: torch.Tensor):
    """`sort_pairs_count` for uint64 keys."""
    live = in_range(keys, count)
    masked = select_u64(live, keys, max_like_u64(keys))
    k, v = sort_pairs64(masked, values)
    return select_u64(live, k, keys), select_u32(live, v, values)


def sort_bits(keys: torch.Tensor, values: torch.Tensor | None, end_bit: int,
              count: torch.Tensor | None = None):
    """Stable ascending sort of uint32 or uint64 keys (and uint32 values)
    by bits [0, end_bit) alone (CUB's end_bit), the keys back whole: one
    stable sort of the masked keys, whose indices gather the keys and the
    values. With `count` the keys at or past it are masked to the maximum
    and sort behind the live ones in input order, so the tail comes back
    in place."""
    wide = keys.dtype == torch.uint64
    masked = low_bits(keys, end_bit)
    if count is not None:
        live = in_range(keys, count)
        masked = (select_u64(live, masked, max_like_u64(masked)) if wide
                  else select_u32(live, masked, max_like_u32(masked)))
    perm = _sort(masked, stable=True)[1]
    k = keys.view(torch.int64 if wide else torch.int32)[perm].view(
        keys.dtype)
    return k if values is None else (k, _take(values, perm))
