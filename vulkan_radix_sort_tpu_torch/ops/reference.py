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
bits gathers the keys too, since they come back whole.
"""

from __future__ import annotations

import torch

from .bitops import (decode_i32, decode_i64, encode_i32, encode_i64,
                     low_bits, mask_past, select, signed_dtype)

# uint dtype -> (to the signed view with the same order, and back)
_SIGNED = {torch.uint32: (decode_i32, encode_i32),
           torch.uint64: (decode_i64, encode_i64)}


def _torch_sort(keys: torch.Tensor, stable: bool = False):
    """(sorted keys, permutation): one torch.sort of the flipped view."""
    to_signed, to_unsigned = _SIGNED[keys.dtype]
    s, perm = torch.sort(to_signed(keys), stable=stable)
    return to_unsigned(s), perm


def _take(values: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """uint32 values gathered by `perm`, through their int32 view."""
    return values.view(torch.int32)[perm].view(torch.uint32)


def sort(keys: torch.Tensor, values: torch.Tensor | None = None, *,
         count=None, end_bit: int | None = None, stable: bool = True,
         config=None):
    """Stable ascending sort of 1-D uint32 or uint64 keys (and uint32
    values): the backend's one entry (`Sorter`'s contract; `stable` and
    `config` are unread, the sort is stable either way). Returns keys, or
    (keys, values), in new tensors.

    `count` (a 0-d tensor on the keys' device, never read on the host)
    sorts only the first `count` keys and leaves the tail in place: the
    keys at or past it are masked to the maximum (`bitops.mask_past`), the
    masked keys sorted, and the tail selected back. The masked tail sorts
    behind every genuine maximum key, in input order, so the values need
    no mask. `end_bit` (1 to the width - 1) orders the keys by bits [0,
    end_bit) alone (CUB's end_bit): one stable sort of the masked keys,
    whose indices gather the whole keys and the values; with `count` the
    masked tail sorts behind the live keys in input order, so it comes
    back in place with no select."""
    if end_bit is not None:
        masked = low_bits(keys, end_bit)
        if count is not None:
            masked = mask_past(count, masked)[1]
        perm = _torch_sort(masked, stable=True)[1]
        k = keys.view(signed_dtype(keys))[perm].view(keys.dtype)
        return k if values is None else (k, _take(values, perm))
    if count is not None:
        live, masked = mask_past(count, keys)
        if values is None:
            return select(live, sort(masked), keys)
        k, v = sort(masked, values)
        return select(live, k, keys), select(live, v, values)
    if values is None:  # equal keys are equal bits: stability is moot
        return _torch_sort(keys)[0]
    k, perm = _torch_sort(keys, stable=True)
    return k, _take(values, perm)
