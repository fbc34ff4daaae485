"""Benchmark and verification harness: the counterpart of
`vulkan_radix_sort_tpu/bench`, run as
`python -m vulkan_radix_sort_tpu_torch.bench <backend>`."""

from .harness import (  # noqa: F401
    BACKENDS,
    BenchResult,
    check_correctness,
    make_backend,
    measure,
    run_sweep,
    sweep_sizes,
    write_csv,
)
