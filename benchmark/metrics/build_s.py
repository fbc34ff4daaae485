"""build_s: seconds the program took to build (on a first run in a
checkout, nvcc) or find, and load, its kernel library, which it keeps as
`_build.built` once the library has loaded."""

import sys

BUILD = "vulkan_radix_sort_tpu_torch._build"


def read(run: dict):
    built = getattr(sys.modules.get(BUILD), "built", None)
    return None if built is None else built["seconds"]
