"""Order-preserving bijections from 32-bit key dtypes onto uint32.

Counterpart of the 32-bit encoders in `vulkan_radix_sort_tpu/ops/bitops.py`.
PyTorch's uint32 is a storage type with few kernels (no `<`, `>>` or
`minimum`, and fewer still on CUDA), so every operation here works on the
int32 bit pattern (`.view(torch.int32)`) and only the result is viewed back
as uint32. The 64-bit encoders come with the 64-bit slice.
"""

from __future__ import annotations

import torch

_SIGN = -(1 << 31)  # int32 bit pattern of 0x80000000
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

WIDE_DTYPES = (torch.uint64, torch.int64, torch.float64)


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
