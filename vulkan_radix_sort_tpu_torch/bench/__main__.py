"""Benchmark CLI (reference bench/bench.cc:117-147 analog).

Usage:
    python -m vulkan_radix_sort_tpu_torch.bench <backend> [-o results.csv]
        [--steps K] [--iters I] [--no-verify] [--distribution D]
        [--indirect] [--nonstable] [--stages] [--adaptive]

Backends: network (the bitonic kernels), radix (the LSD radix kernels),
reference (torch.sort on the card; `xla` is its alias), on a CUDA card;
and on the host cpu (numpy, the oracle), cpp (the native C++ engine) and
torch (torch.sort). A card backend without a card exits with status 2.
The JAX package's `--interpret` has no counterpart: nothing here times
the CPU under a device's name.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import SortConfig
from ..utils import datagen
from .harness import (BACKENDS, DEFAULT_STEPS, DEVICE_BACKENDS, run_sweep,
                      sweep_sizes, write_csv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vulkan_radix_sort_tpu_torch.bench")
    p.add_argument("backend", choices=BACKENDS)
    p.add_argument("-o", "--output", default=None, help="CSV output path")
    p.add_argument("--steps", type=int, default=DEFAULT_STEPS,
                   help="sweep step count (the reference uses 128)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--no-verify", action="store_true",
                   help="skip the oracle-diff gate (reference --no-verify)")
    p.add_argument("--distribution", default="uniform",
                   choices=list(datagen.DISTRIBUTIONS))
    p.add_argument("--indirect", action="store_true",
                   help="route sorts through the dynamic-count path "
                        "(reference indirect API, vulkan_benchmark.cc:386)")
    p.add_argument("--nonstable", action="store_true",
                   help="also sweep the stable=False key-value path "
                        "(reported as sort type 'kvns')")
    p.add_argument("--stages", action="store_true",
                   help="also print the network's per-stage split at the "
                        "largest N (the reference's upsweep/spine/"
                        "downsweep %% lines, bench.cc:178-186)")
    p.add_argument("--adaptive", action="store_true",
                   help="enable the adaptive fast paths (sorted, reverse "
                        "and constant inputs skip the engine; one "
                        "detection pass and a sync on everything else)")
    args = p.parse_args(argv)

    if args.backend in DEVICE_BACKENDS and not torch.cuda.is_available():
        print(f"[{args.backend}] no CUDA device is available: this backend "
              "runs on an NVIDIA card (host backends: cpu, cpp, torch)",
              file=sys.stderr)
        return 2
    # the device backends take the backend from their name
    cfg = SortConfig(adaptive=args.adaptive)

    def progress(r):
        print(f"[{r.backend}] n={r.n:>9} {r.sort:<4} "
              f"{r.gpu_ms:9.3f} ms  {r.gpu_gitems_s:7.3f} GItems/s",
              flush=True)

    results = run_sweep(
        args.backend, steps=args.steps, iters=args.iters,
        no_verify=args.no_verify, distribution=args.distribution,
        config=cfg, indirect=args.indirect, nonstable=args.nonstable,
        progress=progress)
    if args.output:
        write_csv(args.output, results)
        print(f"wrote {args.output}")
    if args.stages:
        print_stage_split(args.backend, steps=args.steps, iters=args.iters)
    return 0


def print_stage_split(backend: str, *, steps: int, iters: int,
                      n: int | None = None) -> dict:
    """Per-stage split of one network keys sort at the largest sweep N, on
    the card: chunk (K1), cross (K3) and local (K4), K2's time split
    between the last two by stage count, then every launch (the analog of
    the reference's per-pass timestamp decode, vulkan_benchmark.cc:318-337,
    printed at bench.cc:178-186)."""
    if backend != "network":
        print(f"[{backend}] the stage split is the network backend's")
        return {}
    from ..ops import bitonic

    if n is None:
        n = sweep_sizes(steps=steps)[-1]
    keys = torch.from_numpy(datagen.generate_keys(n, seed=0)).to("cuda")
    st = bitonic.stage_times(keys, iters=iters)
    tot = st["chunk"] + st["cross"] + st["local"]
    parts = "  ".join(
        f"{name} {st[name] * 1e3:8.3f} ms ({st[name] / tot * 100:4.1f}%)"
        for name in ("chunk", "cross", "local"))
    print(f"[network] stages at n={n}: {parts}  "
          f"[{st['rounds']} merge rounds, sum {tot * 1e3:.3f} ms]")
    for name, t in st["kernels"]:
        print(f"[network]   {name:<14} {t * 1e3:8.3f} ms")
    return st


if __name__ == "__main__":
    sys.exit(main())
