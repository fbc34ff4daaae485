"""The control of `kv_u64_tile_depth`: the reference put in the program's
place, breaking one guarantee that the configuration states, to show that
the comparison which decides `correct` fails it.

Plain PyTorch on the sorter's device, importing nothing of the program.

  short_passes  the pairs stably sorted by bits [0, 40) only: five 8-bit
                passes, the fault of a driver that drops the partial top
                digit of a 45-bit key, so the tile bits 40-44 are not
                ordered.
"""

from __future__ import annotations

import torch

SHORT_BITS = 40


def short_passes(keys, values, count=None, **_):
    order = torch.sort(keys.view(torch.int64) & ((1 << SHORT_BITS) - 1),
                       stable=True).indices
    return (keys.view(torch.int64)[order].view(torch.uint64),
            values.view(torch.int32)[order].view(torch.uint32))
