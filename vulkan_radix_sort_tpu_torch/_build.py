"""Build and load the CUDA kernels of `csrc/` on first use.

The sources have a plain `extern "C"` interface, so they build with nvcc
alone in seconds (no PyTorch headers) and load with ctypes. The library
goes into `_build/` beside this file, named by a hash of the sources and
flags, so a changed source builds anew and an unchanged one loads at once.
Nothing is built at import time: the CPU paths never need a compiler.
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
SOURCES = ("bitonic.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argtypes after (mode, k, t, v, n_units); all end in (valid, stream)
_SIGNATURES = {
    "vrs_chunk": (_I,),                  # lc
    "vrs_local": (_I, _I),               # lc, r
    "vrs_fused": (_I, _I, _I),           # lc, r_lo, r_hi
    "vrs_cross": (_I, _I, _I, _I),       # lc, r, t_lo, span
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the sources if needed; return the library path and the
    compiler's report (`-Xptxas -v`: registers, shared memory, spills)."""
    lib = BUILD_DIR / f"libvrs_kernels_{_digest()}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    report = res.stdout + res.stderr
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, report


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, extra in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_I, _P, _P, _P, _LL, *extra, _P, _P]
        fn.restype = _I
    return lib
