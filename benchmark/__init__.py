"""The benchmark of `vulkan_radix_sort_tpu_torch` on one NVIDIA H100.

`run.py` runs one cell of the repository's `BENCHMARK.json`. Each
configuration (`configs/`), traffic mix (`traffic/`) and metric
(`metrics/`) is a file of its own, found by the name that
`BENCHMARK.json` gives it. `datagen.py`, `reference.py`, `roofline.py`
and `control.py` are the yardstick: frozen here so that a change to the
program cannot move it.
"""
