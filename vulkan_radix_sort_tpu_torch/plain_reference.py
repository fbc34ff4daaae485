"""A plain stable sort by the low `end_bit` bits of uint32 or uint64 keys,
in torch alone: the oracle the (word, position) radix path is held to.

It imports nothing of the rest of the port and uses no float. A key's
bits [0, end_bit) are split into 32-bit words, each masked to its part of
the range; one stable `torch.sort` a word, the low word first, then the
high word on the order the first left, gives the stable order of the
masked keys (an LSD sort of two digits), which gathers the whole keys and
the values. torch sorts no unsigned words, so each word is widened to
int64 first, where every uint32 value keeps its order.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _words(keys: torch.Tensor, end_bit: int) -> list[torch.Tensor]:
    """The key's masked words as int64 in [0, 2^32), least significant
    first, as many as bits [0, end_bit) reach."""
    width = 8 * keys.element_size()
    if keys.dtype not in (torch.uint32, torch.uint64) or keys.dim() != 1:
        raise TypeError("expected 1-D uint32 or uint64 keys")
    if not 1 <= end_bit <= width:
        raise ValueError(f"end_bit {end_bit} outside 1..{width}")
    if width == 32:
        wide = keys.view(torch.int32).to(torch.int64) & _MASK32
    else:
        wide = keys.view(torch.int64)
    words = []
    for lo in range(0, end_bit, 32):
        word = (wide >> lo) & _MASK32
        bits = min(end_bit - lo, 32)
        words.append(word & ((1 << bits) - 1))
    return words


def _order(keys: torch.Tensor, end_bit: int) -> torch.Tensor:
    order = torch.arange(keys.numel(), device=keys.device)
    for word in _words(keys, end_bit):
        order = order[torch.sort(word[order], stable=True).indices]
    return order


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    signed = torch.int64 if x.element_size() == 8 else torch.int32
    return x.view(signed)[order].view(x.dtype)


def sort_keys_bits(keys: torch.Tensor, end_bit: int) -> torch.Tensor:
    """uint32 or uint64 keys in stable ascending order of bits [0,
    end_bit), whole."""
    return _take(keys, _order(keys, end_bit))


def sort_pairs_bits(keys: torch.Tensor, values: torch.Tensor,
                    end_bit: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`sort_keys_bits`, and the values (uint32) in the same order."""
    order = _order(keys, end_bit)
    return _take(keys, order), _take(values, order)
