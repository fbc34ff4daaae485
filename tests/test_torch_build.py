"""The ctypes binding of the port's CUDA library against its C interface.

`_build.library()` sets each entry point's argtypes from
`_build.SIGNATURES`; an entry point missing there, or with a stale
signature, would get its pointers cut to 32-bit ints at the call. The
C prototypes are read from the sources in `csrc/`, so this runs without
nvcc or a card.
"""

import ctypes
import re

from vulkan_radix_sort_tpu_torch import _build


def _prototypes() -> dict[str, tuple]:
    found = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for fn, params in re.findall(r"^int (vrs_\w+)\(([^)]*)\)", text,
                                     re.M):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                types.append(ctypes.c_void_p if "*" in p
                             else ctypes.c_longlong if "long long" in p
                             else ctypes.c_int)
            found[fn] = tuple(types)
    return found


def test_every_entry_point_has_its_signature():
    protos = _prototypes()
    assert {"vrs_block_sort", "vrs_spine", "vrs_place"} <= set(protos)
    assert set(protos) == set(_build.SIGNATURES)
    for fn, types in protos.items():
        assert tuple(_build.SIGNATURES[fn]) == types, fn
