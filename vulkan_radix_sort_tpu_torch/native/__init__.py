"""ctypes binding of the native C++ CPU engine (`native/vrs_native.cpp`).

The port's own binding of the source the JAX package's
`vulkan_radix_sort_tpu/native/__init__.py` binds (which the port may not
import), with the same functions: a multithreaded stable LSD radix sort of
uint32 keys and key-value pairs on the host, the mt19937 generator of the
reference's benchmark data (bench/data_generator.cc), and a sortedness
check. The bench harness's `cpp` backend runs it.

The library is built with g++ at first use into `_build/` beside the
package's other build outputs, named by a hash of the source and the
flags; nothing is written next to the source. A failed build raises with
the compiler's output. There is no NumPy fallback: a function of this
module runs the native engine or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vrs_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_U32P = ctypes.POINTER(ctypes.c_uint32)
SIGNATURES = {  # name -> (argtypes, restype)
    "vrs_sort_u32": ((_U32P, ctypes.c_size_t), None),
    "vrs_sort_pairs_u32": ((_U32P, _U32P, ctypes.c_size_t), None),
    "vrs_generate_uniform": ((_U32P, ctypes.c_size_t, ctypes.c_uint64,
                              ctypes.c_int), None),
    "vrs_is_sorted_u32": ((_U32P, ctypes.c_size_t), ctypes.c_int),
}


def compiler() -> str | None:
    return shutil.which("g++")


def available() -> bool:
    """True where the engine can be built: g++ and the source exist."""
    return compiler() is not None and SOURCE.exists()


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` into a shared library in `build_dir` unless one
    built from the same source and flags is there; return its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    gxx = compiler()
    if gxx is None:
        raise RuntimeError("g++ not found: the native engine needs a C++ "
                           "compiler")
    h = hashlib.sha256(" ".join(FLAGS).encode() + source.read_bytes())
    lib = build_dir / f"libvrs_native_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([gxx, *FLAGS, str(source), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {source}:"
                               f"\n{res.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded engine, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def _u32_buffer(a: np.ndarray, name: str) -> np.ndarray:
    if (not isinstance(a, np.ndarray) or a.dtype != np.uint32 or a.ndim != 1
            or not a.flags.c_contiguous or not a.flags.writeable):
        raise TypeError(f"{name} must be a writeable contiguous 1-D uint32 "
                        "numpy array")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def sort_u32(keys: np.ndarray) -> np.ndarray:
    """Stable ascending sort of uint32 keys, into a new array."""
    out = np.array(keys, dtype=np.uint32, copy=True).reshape(-1)
    library().vrs_sort_u32(_ptr(out), out.size)
    return out


def sort_pairs_u32(keys: np.ndarray, values: np.ndarray):
    """Stable ascending key-value sort, into new arrays."""
    k = np.array(keys, dtype=np.uint32, copy=True).reshape(-1)
    v = np.array(values, dtype=np.uint32, copy=True).reshape(-1)
    if k.size != v.size:
        raise ValueError("keys and values must have one length")
    library().vrs_sort_pairs_u32(_ptr(k), _ptr(v), k.size)
    return k, v


def sort_u32_inplace(buf: np.ndarray) -> np.ndarray:
    """Sort a contiguous uint32 buffer in place: the timed-region
    primitive, so that the copy stays outside the clock, as in the
    reference's CPU timing (bench/cpu_benchmark.cc:22-25)."""
    _u32_buffer(buf, "buf")
    library().vrs_sort_u32(_ptr(buf), buf.size)
    return buf


def sort_pairs_u32_inplace(k: np.ndarray, v: np.ndarray):
    """Stable key-value sort of contiguous uint32 buffers in place."""
    _u32_buffer(k, "k")
    _u32_buffer(v, "v")
    if k.size != v.size:
        raise ValueError("keys and values must have one length")
    library().vrs_sort_pairs_u32(_ptr(k), _ptr(v), k.size)
    return k, v


def generate_uniform(n: int, seed: int = 0, bits: int = 32) -> np.ndarray:
    """n mt19937 uniform uint32 keys, the low `bits` bits kept (bits
    outside (0, 32) keep all 32), as the reference's data generator."""
    out = np.empty(n, dtype=np.uint32)
    library().vrs_generate_uniform(_ptr(out), n, seed, bits)
    return out


def is_sorted_u32(keys: np.ndarray) -> bool:
    """True iff the uint32 keys are in ascending order."""
    a = np.ascontiguousarray(keys, dtype=np.uint32).reshape(-1)
    return bool(library().vrs_is_sorted_u32(_ptr(a), a.size))
