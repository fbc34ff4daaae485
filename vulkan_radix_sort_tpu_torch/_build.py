"""Build and load the CUDA kernels of `csrc/` on first use.

The sources have a plain `extern "C"` interface, so they build with nvcc
alone (no PyTorch headers) and load with ctypes; `bitonic.cu` takes about
a minute and a half, for its fully unrolled chunk and local kernels at
every chunk size. Each source
compiles to an object in its own nvcc process, all started together, and
the objects link into one library in `_build/` beside this file, named by
a hash of the sources, their shared header and the flags, so a changed
source builds anew and an unchanged one loads at once. Nothing is built
at import time: the CPU paths never need a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("bitonic.cu", "fused.cu", "radix.cu")
HEADERS = ("network.cuh",)  # included by bitonic.cu and fused.cu
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The network kernels: (mode, k, t, v, n_units, *extra, valid, stream).
_BITONIC = {
    "vrs_chunk": (_I,),                  # lc
    "vrs_local": (_I, _I),               # lc, r
    "vrs_fused": (_I, _I, _I),           # lc, r_lo, r_hi
    "vrs_cross": (_I, _I, _I, _I),       # lc, r, t_lo, span
}
# name -> argtypes; every function returns cudaGetLastError() as an int
SIGNATURES = {
    **{name: (_I, _P, _P, _P, _LL, *extra, _P, _P)
       for name, extra in _BITONIC.items()},
    # (kv, keys, vals, out_k, out_v, hist, nblocks, block, shift, bits,
    #  stream)
    "vrs_block_sort": (_I, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
    # (kv, y, yv, hist, offsets, out, outv, nblocks, block, bits, stream)
    "vrs_place": (_I, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P),
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; return each one's output, or raise with
    the first failure's after every process has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build() -> tuple[Path, str]:
    """Compile the sources if needed; return the library path and the
    compiler's report (`-Xptxas -v`: registers, shared memory, spills)."""
    lib = BUILD_DIR / f"libvrs_kernels_{_digest()}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    try:
        reports = _run_all([[nvcc(), *COMPILE_FLAGS, "-c", "-o", str(o),
                             str(CSRC / s)] for s, o in zip(SOURCES, objs)])
        reports += _run_all([[nvcc(), *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)]])
        report = "".join(reports)
        log.write_text(report)
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib, report


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
