"""Bytes the 64-bit radix path must move: its two kernels, and a whole
sort by bits [0, end_bit).

The (word, position) path's own counts, frozen here so that a change to
the program cannot move the yardstick; the peak is `roofline.py`'s. Each
input byte is counted read once and each output byte written once, what
the work needs, whatever a kernel reads again (a random gather reads a
32-byte sector for every 4 or 8 useful bytes).
"""

from __future__ import annotations

POSITION = 4  # bytes of a sorted position (uint32)
WORD = 4      # bytes of a key word the passes sort (uint32)
VALUE = 4     # bytes of a value (uint32)


def sort_bytes(n: int, item_bytes: int, end_bit: int,
               digit_bits: int = 8) -> int:
    """The least any LSD sort of n items of `item_bytes` by bits [0,
    end_bit) moves at `digit_bits` a pass, however it is built: every item
    read once and written once a pass."""
    return 2 * n * item_bytes * -(-end_bit // digit_bits)


def hi_bytes(key_bytes: int, end_bit: int) -> int:
    """Bytes of each high word split_pad writes for the high-word gather:
    for 64-bit keys by an end bit past 32, 2 up to bit 48 and 4 above it;
    0 (no high words, no high-word gather) otherwise."""
    if key_bytes != 8 or end_bit <= 32:
        return 0
    return 2 if end_bit <= 48 else 4


def split_pad_bytes(n: int, size: int, key_bytes: int, key_value: bool,
                    high: int = 0) -> int:
    """split_pad: the n keys (and values) in; a word and a position out
    for each of the `size` padded slots; for key-value sorts each key and
    its value out again, as one record for the gathers; a high word of
    `high` bytes (`hi_bytes`) out for each padded slot."""
    kv = (VALUE + key_bytes + VALUE) * n if key_value else 0
    return key_bytes * n + (WORD + POSITION + high) * size + kv


def gather_hi_bytes(m: int, high: int) -> int:
    """gather, `hi`: a position and a high word of `high` bytes in, a word
    out, for each of the m padded slots."""
    return (POSITION + high + WORD) * m


def gather_out_bytes(n: int, key_bytes: int, key_value: bool) -> int:
    """gather, `out`: a position, a key (and a value: a record) in, the
    key (and the value) out, for each of the n items."""
    return n * (POSITION + 2 * key_bytes + (2 * VALUE if key_value else 0))


def key_bytes(config: dict) -> int:
    """Bytes of a key of the configuration's `key_dtype`."""
    return {"uint32": 4, "uint64": 8}[config["key_dtype"]]
