"""Controls: the reference put in the program's place, breaking one
guarantee that a configuration states, to show that the comparison which
decides `correct` fails them.

Plain PyTorch on the sorter's device, importing nothing of the program.
Each control takes the call's tensors as the program's entry point does
and returns what that entry point returns.

  float32_keys    keys ranked in float32, the precision below their 32
                  bits (24-bit significand): the output is not exactly
                  sorted.
  unstable_pairs  exact keys, but equal keys' values by ascending value
                  (a (key, value) compare, as a non-stable pair sort
                  gives): the order is not stable.
"""

from __future__ import annotations

import torch


def _u32_as_i64(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _gather(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)[order].view(torch.uint32)


def float32_keys(keys, values=None, count=None, **_):
    order = torch.sort(_u32_as_i64(keys).to(torch.float32),
                       stable=True).indices
    if values is None:
        return _gather(keys, order)
    return _gather(keys, order), _gather(values, order)


def unstable_pairs(keys, values, count=None, **_):
    composite = ((_u32_as_i64(keys) - (1 << 31)) << 32) | _u32_as_i64(values)
    order = torch.sort(composite).indices
    return _gather(keys, order), _gather(values, order)
