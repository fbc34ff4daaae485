"""Probes of the radix block sort (K7) on the card, for its design work:

    python -m vulkan_radix_sort_tpu_torch.utils.block_sort_probe \\
        [--csrc DIR ...] [--n-log 25] [--block 16384] [--bits 8] \\
        [--blocks 4096 8192 16384] [--pin] [--sass]

For each `csrc` directory (by default the package's own), builds copies of
its `radix.cu`, one for each phase marker in `block_sort_kernel` and one
unchanged. A marker is a comment line

    // phase <name> ends; probe sink: <expression>; <return|continue>

and its copy replaces it by `if (blockIdx.x == 0xffffffffu) hist[0] =
int(<expression>);` and the statement, so the copy stops after that phase
and the compiler keeps the work the expression depends on. `--pin`
launches every copy with the most shared memory a block may have, so that
each holds one block an SM as the full kernel does (a copy that stops
early needs fewer registers and could hold more). Each copy is compiled
with nvcc alone (its C entry points, loaded with ctypes), the full copy
held bitwise against `block_sort_plain` at 2^20 at every block and both
digit widths (a tree that fails to build or to match is reported with
its error and not timed), and every copy timed at 2^n-log keys, keys and
key-value, on uniform keys, on keys of one digit and on keys of two, the
copies in turns (in order, then in reverse; `time_fn` medians). Prints one `[k7]` JSON line per
tree: ms per launch by phase, input and carry; each kernel's registers,
local (spill) bytes, dynamic shared memory and resident blocks an SM
(`cudaFuncGetAttributes`, `cudaOccupancyMaxActiveBlocksPerMultiprocessor`);
the full kernel's ms at each of `--blocks`; and with `--sass`, the full
kernel's opcodes by count (`cuobjdump -sass`). Then the card's name and
power limit as nvidia-smi gives them. Needs a card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from .. import _build
from ..config import SortConfig
from ..ops.block_sort import block_sort_plain
from .timing import time_fn
from .wide_probe import opcode_mix

MARKER = re.compile(r"^(\s*)// phase (\w+) ends; probe sink: (.+); "
                    r"(return|continue)$", re.M)
PIN_FROM = "const size_t smem = sort_smem(a.block, BITS, KV);"
PIN_TO = "const size_t smem = size_t(kSmemBytes);"
PROBE_DIR = _build.BUILD_DIR / "probe"


def geometry(source: str, block: int, kv: bool) -> tuple[int, int]:
    """(threads, keys a thread) of the source's K7 at `block`: one thread a
    16-byte vector up to kThreads, or for keys up to kKeysThreads where the
    source has it."""
    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", source)
        return int(m[1]) if m else None
    cap = const("kThreads")
    if not kv and const("kKeysThreads"):
        cap = const("kKeysThreads")
    threads = min(block // const("kVecKeys"), cap)
    return threads, block // threads


def attrs_source(source: str, block: int, bits: int) -> str:
    """An entry point that reports the attributes of the K7 instantiations
    a launch at `block` runs (keys, key-value)."""
    (tk, kk), (tv, kv) = (geometry(source, block, v) for v in (False, True))
    return f"""
extern "C" int vrs_probe_attrs(int kv, int* out) {{
  const void* f = kv ? (const void*)block_sort_kernel<true, {kv}, {bits}>
                     : (const void*)block_sort_kernel<false, {kk}, {bits}>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return int(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, f, kv ? {tv} : {tk}, a.maxDynamicSharedSizeBytes);
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = a.maxDynamicSharedSizeBytes;
  out[3] = blocks;
  return int(e);
}}
"""


def variants(source: str, pin: bool) -> dict[str, str]:
    """Phase name -> the copy of `source` that stops after that phase,
    in the kernel's order, then "full" -> the source unchanged."""
    if pin:
        if PIN_FROM not in source:
            raise ValueError("--pin: the launcher's shared-memory line "
                             "was not found")
        source = source.replace(PIN_FROM, PIN_TO)
    out = {}
    for m in MARKER.finditer(source):
        indent, name, sink, stop = m.groups()
        stmt = (f"{indent}if (blockIdx.x == 0xffffffffu) "
                f"hist[0] = int({sink});\n{indent}{stop};")
        out[name] = source[:m.start()] + stmt + source[m.end():]
    out["full"] = source
    return out


def build(tag: str, sources: dict[str, str], extra: str) -> dict:
    """Compile each source (with `extra` appended) into its own library, all
    at once; return name -> (ctypes library, its path)."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for name, src in sources.items():
        cu = PROBE_DIR / f"{tag}_{name}.cu"
        cu.write_text(src + extra)
        so = cu.with_suffix(".so")
        libs[name] = so
        cmds.append([_build.nvcc(), *_build.COMPILE_FLAGS, "-shared",
                     "-o", str(so), str(cu)])
    _build._run_all(cmds)
    out = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.vrs_block_sort.argtypes = _build.SIGNATURES["vrs_block_sort"]
        lib.vrs_probe_attrs.argtypes = (ctypes.c_int, ctypes.c_void_p)
        out[name] = (lib, so)
    return out


class Bufs:
    def __init__(self, n: int):
        gen = torch.Generator(device="cuda").manual_seed(0)
        self.n = n
        rand = torch.randint(-(1 << 31), 1 << 31, (2, n), generator=gen,
                             device="cuda", dtype=torch.int32)
        low = rand[0] & ~0xFF
        self.keys = {"uniform": rand[0].view(torch.uint32),
                     # every key of digit 0x2a at shift 0: all lanes peers
                     "one": (low | 0x2A).view(torch.uint32),
                     # digits 0x2a and 0x2b: about 16 peers a lane
                     "two": (low | 0x2A | (rand[0] >> 8 & 1)).view(
                         torch.uint32)}
        self.vals = rand[1].view(torch.uint32)
        self.out_k = torch.empty_like(self.vals)
        self.out_v = torch.empty_like(self.vals)
        self.hist = torch.empty(n // 512 * 256, dtype=torch.int32,
                                device="cuda")  # the smallest block, 8 bits


def launch(lib, bufs: Bufs, inp: str, kv: bool, block: int, bits: int,
           n: int | None = None):
    n = bufs.n if n is None else n
    err = lib.vrs_block_sort(
        int(kv), bufs.keys[inp].data_ptr(), bufs.vals.data_ptr(),
        bufs.out_k.data_ptr(), bufs.out_v.data_ptr(), bufs.hist.data_ptr(),
        n // block, block, 0, bits,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vrs_block_sort failed: CUDA error {err}")


def check(lib, bufs: Bufs, n: int = 1 << 20) -> None:
    """The full copy against block_sort_plain at n keys, bitwise, at every
    block and both digit widths, keys and key-value, both inputs."""
    block = 512
    while block <= 1 << 14:
        for bits in (4, 8):
            cfg = SortConfig(backend="radix", digit_bits=bits, block=block)
            for inp in bufs.keys:
                keys = bufs.keys[inp][:n]
                for kv in (False, True):
                    launch(lib, bufs, inp, kv, block, bits, n)
                    want = block_sort_plain(
                        keys, bufs.vals[:n] if kv else None, shift=0,
                        config=cfg, key_value=kv)
                    got = [bufs.out_k[:n]] + ([bufs.out_v[:n]] if kv else [])
                    got.append(bufs.hist[:n // block * cfg.radix].view(
                        -1, cfg.radix))
                    if not all(torch.equal(g.view(torch.int32),
                                           w.view(torch.int32))
                               for g, w in zip(got, want)):
                        raise AssertionError(
                            f"K7 block={block} bits={bits} kv={kv} {inp}: "
                            "the kernel differs from its plain version")
        block *= 2


def probe_tree(csrc: Path, tag: str, args, bufs: Bufs) -> dict:
    try:  # a tree that does not build or is wrong is reported, not timed
        source = (csrc / "radix.cu").read_text()
        libs = build(tag, variants(source, args.pin),
                     attrs_source(source, args.block, args.bits))
        full = libs["full"][0]
        check(full, bufs)
    except (OSError, RuntimeError, AssertionError) as e:
        return {"tree": str(csrc), "error": str(e)[-4000:]}
    res = {"tree": str(csrc), "block": args.block, "bits": args.bits,
           "n": bufs.n, "pin": args.pin, "ms": {}, "attrs": {}}
    cases = [(inp, kv) for inp in bufs.keys for kv in (False, True)]
    names = list(libs)
    samples = {(p, inp, kv): [] for p in names for inp, kv in cases}
    for order in (names, names[::-1]):
        for p in order:
            for inp, kv in cases:
                samples[p, inp, kv].append(1e3 * time_fn(
                    launch, libs[p][0], bufs, inp, kv, args.block,
                    args.bits, iters=20))
    for (p, inp, kv), s in samples.items():
        res["ms"].setdefault(p, {})[f"{inp}_{'kv' if kv else 'keys'}"] = (
            sum(s) / len(s), s)
    for p in names:
        for kv in (False, True):
            out = (ctypes.c_int * 4)()
            err = libs[p][0].vrs_probe_attrs(int(kv), out)
            if err:
                raise RuntimeError(f"vrs_probe_attrs failed: {err}")
            res["attrs"][f"{p}_{'kv' if kv else 'keys'}"] = dict(
                zip(("regs", "local_bytes", "smem", "blocks_per_sm"), out))
    res["blocks_ms"] = {}
    for block in args.blocks:
        for kv in (False, True):
            res["blocks_ms"][f"{block}_{'kv' if kv else 'keys'}"] = (
                1e3 * time_fn(launch, full, bufs, "uniform", kv, block,
                              args.bits, iters=20))
    if args.sass:
        cuobjdump = _build.nvcc().replace("nvcc", "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(libs["full"][1])],
                              capture_output=True, text=True,
                              check=True).stdout
        res["sass"] = {}
        for kv in (0, 1):
            kpt = geometry(source, args.block, bool(kv))[1]
            mix = opcode_mix(sass, f"block_sort_kernelILb{kv}ELi{kpt}E"
                                   f"Li{args.bits}E")
            if mix is None:
                raise SystemExit("no block_sort_kernel in the SASS")
            name, count, ops = mix
            res["sass"]["kv" if kv else "keys"] = {
                "instructions": count, "opcodes": dict(ops.most_common())}
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", nargs="*", type=Path,
                    default=[_build.CSRC])
    ap.add_argument("--n-log", type=int, default=25)
    ap.add_argument("--block", type=int, default=1 << 14)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--blocks", type=int, nargs="*",
                    default=[4096, 8192, 16384])
    ap.add_argument("--pin", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_sort_probe times the card and needs a CUDA "
                         "device")
    bufs = Bufs(1 << args.n_log)
    for i, csrc in enumerate(args.csrc):
        print("[k7]", json.dumps(probe_tree(csrc, f"t{i}", args, bufs)),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
