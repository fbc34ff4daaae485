"""Readings that the limits of `correct` are set from: the numbers that a
run compares, for the program on many seeds and for the control on a few,
each in a short window at the cell's own sizes and load, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 ... \\
        --control-seeds 21 22 23 --seconds 1

The control is the configuration's `control` (`control.py`): the
reference put in the program's place, breaking one guarantee that the
configuration states. Prints one JSON line per run: the cell, the side
(program or control), the seed, `correct` and the numbers compared. Not
run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402


def read(spec: dict, seeds, control_seeds, seconds: float, device):
    """Yield (side, seed, result) for each seed: the program's, then the
    control's in the program's place."""
    control = run.resolve(spec["config"]["control"])
    for side, seeds_, program in (("program", seeds, None),
                                  ("control", control_seeds, control)):
        for seed in seeds_:
            yield side, seed, run.run_cell(spec, seed, seconds, False,
                                           device, program=program)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("readings are taken on a CUDA device; none is available")
        return 2
    spec = run.load_cell(args.workload)
    for side, seed, res in read(spec, args.seeds, args.control_seeds,
                                args.seconds, "cuda:0"):
        print(json.dumps({"cell": args.workload, "side": side, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
