"""vulkan_radix_sort_tpu_torch — the sort engine on PyTorch and CUDA (Hopper).

The PyTorch port of `vulkan_radix_sort_tpu`, beside it in this repository.
Its main path is the same bitonic compare-exchange network, with each TPU
(Pallas) kernel written again by hand in CUDA C++ for sm_90a
(`csrc/bitonic.cu`, built with nvcc on first use). `backend="radix"` is the
LSD radix sort the reference library is named for, over two more such
kernels, the block sort and the placement (`csrc/radix.cu`); a `torch.sort`
reference backend completes the set. It sorts uint32, int32 and float32
keys, key-value pairs (stable, or on the network non-stable by (key,
value)), and dynamic counts (`count=`, the reference's indirect path), on a
CUDA device unless asked for the CPU, where each kernel's plain PyTorch
version runs instead.
"""

from .config import SortConfig, config_from_jax, default_config
from .models.sorter import Sorter, create_sorter
from .ops import bitonic, radix, reference

__version__ = "0.1.0"

__all__ = [
    "SortConfig",
    "Sorter",
    "bitonic",
    "config_from_jax",
    "create_sorter",
    "default_config",
    "radix",
    "reference",
    "sort",
    "sort_key_value",
]


def sort(keys, count=None, config=None):
    """One-shot ascending sort on the keys' device (a throwaway Sorter).

    Analog of vrdxCmdSort / vrdxCmdSortIndirect (h.in:310-331).
    """
    s = Sorter(max(1, keys.numel()), key_dtype=keys.dtype, config=config,
               device=keys.device)
    return s.sort(keys, count=count)


def sort_key_value(keys, values, count=None, config=None, stable=True):
    """One-shot key-value sort on the keys' device (stable by default).

    Analog of vrdxCmdSortKeyValue / ...Indirect (h.in:333-342).
    """
    s = Sorter(max(1, keys.numel()), key_dtype=keys.dtype, config=config,
               device=keys.device)
    return s.sort_key_value(keys, values, count=count, stable=stable)
