"""Order-preserving bijections from key dtypes onto uint32 and uint64.

Counterpart of the encoders in `vulkan_radix_sort_tpu/ops/bitops.py`.
PyTorch's uint32 and uint64 are storage types with few kernels (no `<`,
`>>` or `minimum`, and fewer still on CUDA), so every operation here works
on the int32 or int64 bit pattern (`.view(torch.int32)`,
`.view(torch.int64)`) and only the result is viewed back as unsigned.
64-bit keys are sorted as (hi, lo) uint32 word pairs (`split_u64`), whose
lexicographic order is the unsigned 64-bit order.
"""

from __future__ import annotations

import torch

_SIGN = -(1 << 31)  # int32 bit pattern of 0x80000000
_SIGN64 = -(1 << 63)  # int64 bit pattern of 0x8000000000000000
_MASK32 = 0xFFFFFFFF


def encode_u32(x: torch.Tensor) -> torch.Tensor:
    return x


def decode_u32(u: torch.Tensor) -> torch.Tensor:
    return u


def encode_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> uint32, order preserving (flip the sign bit)."""
    return (x ^ _SIGN).view(torch.uint32)


def decode_i32(u: torch.Tensor) -> torch.Tensor:
    return u.view(torch.int32) ^ _SIGN


def encode_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 on IEEE-754 total order: negative floats get every
    bit flipped, the others only the sign bit. NaNs land above +inf."""
    b = x.view(torch.int32)
    mask = torch.where(b < 0, -1, _SIGN).to(torch.int32)
    return (b ^ mask).view(torch.uint32)


def decode_f32(u: torch.Tensor) -> torch.Tensor:
    b = u.view(torch.int32)
    mask = torch.where(b < 0, _SIGN, -1).to(torch.int32)
    return (b ^ mask).view(torch.float32)


ENCODERS = {
    torch.uint32: (encode_u32, decode_u32),
    torch.int32: (encode_i32, decode_i32),
    torch.float32: (encode_f32, decode_f32),
}


def encode_u64(x: torch.Tensor) -> torch.Tensor:
    return x


def decode_u64(u: torch.Tensor) -> torch.Tensor:
    return u


def encode_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 -> uint64, order preserving (flip the sign bit)."""
    return (x ^ _SIGN64).view(torch.uint64)


def decode_i64(u: torch.Tensor) -> torch.Tensor:
    return u.view(torch.int64) ^ _SIGN64


def encode_f64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> uint64 on IEEE-754 total order: negative floats get every
    bit flipped, the others only the sign bit. NaNs with the sign bit clear
    land above +inf, those with it set below -inf."""
    b = x.view(torch.int64)
    mask = torch.where(b < 0, -1, _SIGN64)
    return (b ^ mask).view(torch.uint64)


def decode_f64(u: torch.Tensor) -> torch.Tensor:
    b = u.view(torch.int64)
    mask = torch.where(b < 0, _SIGN64, -1)
    return (b ^ mask).view(torch.float64)


ENCODERS64 = {
    torch.uint64: (encode_u64, decode_u64),
    torch.int64: (encode_i64, decode_i64),
    torch.float64: (encode_f64, decode_f64),
}

WIDE_DTYPES = tuple(ENCODERS64)


def split_u64(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint64 -> (hi, lo) uint32 words; (hi, lo) lexicographic order is the
    uint64 order. Arithmetic on the int64 view, so endianness-independent:
    the shift keeps the high word, the truncating cast the low one."""
    b = u.view(torch.int64)
    hi = (b >> 32).to(torch.int32).view(torch.uint32)
    lo = b.to(torch.int32).view(torch.uint32)
    return hi, lo


def merge_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 words -> uint64."""
    return ((hi.view(torch.int32).to(torch.int64) << 32)
            | widen_u32(lo)).view(torch.uint64)


def low_bits(u: torch.Tensor, bits: int) -> torch.Tensor:
    """uint32 or uint64 words with every bit from `bits` up cleared (CUB's
    end_bit), through the signed view; u itself at the full width."""
    if bits >= 8 * u.element_size():
        return u
    return (u.view(signed_dtype(u)) & ((1 << bits) - 1)).view(u.dtype)


def widen_u32(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> int64 in [0, 2^32), where every comparison works."""
    return u.view(torch.int32).to(torch.int64) & _MASK32


def narrow_u32(w: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> uint32 with the same value."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(
        torch.int32).view(torch.uint32)


def max_like_u32(x: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor like x, filled with 0xFFFFFFFF (the key sentinel)."""
    return torch.full_like(x.view(torch.int32), -1).view(torch.uint32)


def select_u32(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where for uint32 operands, through their int32 bit patterns."""
    return torch.where(cond, a.view(torch.int32), b.view(torch.int32)).view(
        torch.uint32)


def pad_u32(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """A new `size`-element uint32 buffer holding x, then `fill`."""
    out = torch.full((size,), fill - (1 << 32) if fill >= 1 << 31 else fill,
                     dtype=torch.int32, device=x.device).view(torch.uint32)
    out[: x.numel()].copy_(x)
    return out


def count_tensor(count, device: torch.device) -> torch.Tensor | None:
    """`count` (None, an int or a tensor on `device`) as a 0-d int64
    tensor on `device`; a tensor given by the caller is never read on the
    host and never moved."""
    if count is None:
        return None
    if isinstance(count, torch.Tensor):
        if count.device != device:
            raise ValueError(f"count lives on {count.device}, the keys "
                             f"on {device}")
        return count.reshape(()).to(torch.int64)
    return torch.tensor(int(count), dtype=torch.int64, device=device)


def in_range(keys: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The `count=` prefix of keys as a bool mask, `arange(n) < count`,
    on the card without reading the count."""
    return torch.arange(keys.numel(), device=keys.device) < count


def signed_dtype(u: torch.Tensor) -> torch.dtype:
    """The signed dtype of uint32 or uint64 words' bit patterns."""
    return torch.int64 if u.dtype == torch.uint64 else torch.int32


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where for uint32 or uint64 operands of one dtype, through
    their signed bit patterns."""
    signed = signed_dtype(a)
    return torch.where(cond, a.view(signed), b.view(signed)).view(a.dtype)


def mask_past(count: torch.Tensor, *xs: torch.Tensor):
    """The `count=` mask of the backends that sort whole buffers: (live,
    *masked), `live` the prefix (`in_range`) and each of xs (uint32 or
    uint64 words, as long as the first) with every slot at or past the
    count set to the maximum of its width, so that it sorts behind the
    live ones. The caller sorts the masked buffers and gives the tail back
    with `select(live, sorted, x)`."""
    live = in_range(xs[0], count)
    maxes = (torch.full_like(x.view(signed_dtype(x)), -1).view(x.dtype)
             for x in xs)
    return (live, *(select(live, x, m) for x, m in zip(xs, maxes)))


VECTOR_BYTES = 16  # the kernels load and store 16-byte vectors


def check_aligned(arrs) -> None:
    """Raise unless every buffer starts on a 16-byte boundary, as the
    kernels' vector loads and stores need (a view such as x[1:] does
    not)."""
    for a in arrs:
        if a.data_ptr() % VECTOR_BYTES:
            raise ValueError(f"buffer at {a.data_ptr():#x} is not "
                             f"{VECTOR_BYTES}-byte aligned")


def check_u32(*xs: torch.Tensor) -> None:
    """Raise unless every x is a 1-D uint32 tensor of one shape and device."""
    for x in xs:
        if x.dtype != torch.uint32 or x.dim() != 1:
            raise TypeError("expected 1-D uint32 tensors")
    if any(x.device != xs[0].device or x.shape != xs[0].shape for x in xs):
        raise ValueError("keys and values must share shape and device")
