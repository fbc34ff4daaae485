"""Probes of the three-word carries' chunk (K1) and fused (K2) kernels on
the card, for their design work:

    python -m vulkan_radix_sort_tpu_torch.utils.wide_probe \\
        [--n-log 25] [--sass PATTERN ...]

prints one `[wide]` JSON line, the card as nvidia-smi names it and, for
W3 and W4_BIG, the ms a launch of K1 at CHUNK_CARRY and of K2 on the main
path's groups at 2^n-log elements (utils.timing.time_fn: the median of
CUDA-event samples), each kernel first held bitwise against its plain
version at 2^20; then a `[sass]` line for each pattern: the first kernel
of the built library whose mangled name matches it, its instruction count
and its opcodes by count (`cuobjdump -sass`). Both need a card and the
CUDA toolkit, and raise without them.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess

import torch

from .. import _build
from ..config import CHUNK_CARRY
from ..ops import bitonic, bitonic_kernels as bk
from .timing import time_fn


def opcode_mix(sass: str, pattern: str):
    """(kernel name, instruction count, Counter of opcodes) of the first
    function in `cuobjdump -sass` output whose name matches `pattern`, or
    None."""
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)",
                         sass, re.S):
        if re.search(pattern, m[1]):
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", m[2])
            return m[1], len(ops), collections.Counter(ops)
    return None


def sass_mix(patterns) -> list:
    lib, _, _ = _build.build()
    cuobjdump = _build.nvcc().replace("nvcc", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return [opcode_mix(sass, p) for p in patterns]


def _inputs(mode, n: int, gen, device) -> list[torch.Tensor]:
    """Uniform (hi, lo) words, the third word uniform (W3) or the index
    (W4_BIG), the riding values uniform."""
    def rand():
        return torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                             device=device, dtype=torch.int32)
    arrs = [rand(), rand()]
    arrs.append(torch.arange(n, device=device, dtype=torch.int32)
                if mode.ride else rand())
    arrs += [rand() for _ in range(mode.ride)]
    return [a.view(torch.uint32) for a in arrs]


def _launches(mode, n: int):
    C = CHUNK_CARRY
    r_hi = bitonic._fused_rounds(C, bk.log2(n // C), mode)
    return {"chunk": (bk.spec("chunk", C), n // C),
            "fused": (bk.spec("fused", C, 1, r_hi), n // (C << r_hi))}


def wide_times(n: int, device="cuda") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the wide kernels run only on a CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for mode in (bk.W3, bk.W4_BIG):
        for name, (launch, units) in _launches(mode, 1 << 20).items():
            a = _inputs(mode, 1 << 20, gen, device)
            b = [x.clone() for x in a]
            bk.run(launch, a, mode, units)
            bk.run_plain(launch, b, mode, units)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name} {mode.name}: the kernel "
                                     "differs from its plain version")
        arrs = _inputs(mode, n, gen, device)
        for name, (launch, units) in _launches(mode, n).items():
            out[f"{name}_{mode.name}_ms"] = 1e3 * time_fn(
                bk.run, launch, arrs, mode, units)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log", type=int, default=25)
    ap.add_argument("--sass", nargs="*", default=[])
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("[wide]", json.dumps({"card": card, "n": 1 << args.n_log,
                                **wide_times(1 << args.n_log)}), flush=True)
    for pattern, mix in zip(args.sass, sass_mix(args.sass)):
        if mix is None:
            raise SystemExit(f"no kernel matches {pattern!r}")
        name, count, ops = mix
        print("[sass]", json.dumps({"kernel": name, "instructions": count,
                                    "opcodes": dict(ops.most_common())}))


if __name__ == "__main__":
    main()
