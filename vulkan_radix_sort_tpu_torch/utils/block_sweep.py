"""Time the radix backend's sorts at several block sizes on one CUDA card.

    python -m vulkan_radix_sort_tpu_torch.utils.block_sweep
    python -m vulkan_radix_sort_tpu_torch.utils.block_sweep \\
        --sizes 20 25 --blocks 4096 16384

For each n (given as log2) and each block, the radix Sorter's keys sort
and stable key-value sort on uniform keys (`time_fn` medians, ms), and one
keys pass split into block sort, spine and placement (`radix.stage_times`).
Every block is timed twice, in turns (the blocks in order, then in
reverse), and each output is checked against torch.sort first. Prints one
JSON line per n, then the card's name and power limit as nvidia-smi gives
them. This is how `config.RADIX_BLOCK` was chosen; rerun it when a radix
kernel changes.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..config import SortConfig
from ..models.sorter import Sorter
from ..ops import radix
from .datagen import generate_keys, generate_values
from .timing import time_fn


def _check(sorter: Sorter, keys, vals) -> None:
    """Compare int32 bit patterns: torch has few uint32 kernels on CUDA."""
    flipped = keys.view(torch.int32) ^ -(1 << 31)
    want, perm = torch.sort(flipped, stable=True)
    want = want ^ -(1 << 31)
    got_k, got_v = sorter.sort_key_value(keys, vals)
    if not (torch.equal(sorter.sort(keys).view(torch.int32), want)
            and torch.equal(got_k.view(torch.int32), want)
            and torch.equal(got_v.view(torch.int32),
                            vals.view(torch.int32)[perm])):
        raise AssertionError(f"radix sort at block {sorter.config.block} "
                             "differs from torch.sort")


def sweep(n: int, blocks, seed: int = 0) -> dict:
    keys = torch.from_numpy(generate_keys(n, seed=seed)).cuda()
    vals = torch.from_numpy(generate_values(n, seed=seed + 1)).cuda()
    sorters = {b: Sorter(n, config=SortConfig(backend="radix", block=b))
               for b in blocks}
    for s in sorters.values():
        _check(s, keys, vals)
    runs = {b: {"keys_ms": [], "stable_kv_ms": []} for b in blocks}
    for order in (list(blocks), list(blocks)[::-1]):
        for b in order:
            s = sorters[b]
            runs[b]["keys_ms"].append(time_fn(s.sort, keys) * 1e3)
            runs[b]["stable_kv_ms"].append(
                time_fn(s.sort_key_value, keys, vals) * 1e3)
    out = {}
    for b in blocks:
        per_pass = radix.stage_times(keys, sorters[b].config)["per_pass"]
        out[b] = {**{k: sum(v) / len(v) for k, v in runs[b].items()},
                  "runs": runs[b], "blocks": -(-n // b),
                  "per_pass_ms": {k: v * 1e3 for k, v in per_pass.items()}}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[16, 18, 20, 22, 25], help="log2 of each n")
    ap.add_argument("--blocks", type=int, nargs="+",
                    default=[4096, 8192, 16384])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_sweep times the card and needs a CUDA device")
    for lg in args.sizes:
        print(json.dumps({"n": 1 << lg, "block_sweep":
                          sweep(1 << lg, args.blocks)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
