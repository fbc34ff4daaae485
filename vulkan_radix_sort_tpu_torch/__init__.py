"""vulkan_radix_sort_tpu_torch — the sort engine on PyTorch and CUDA (Hopper).

The PyTorch port of `vulkan_radix_sort_tpu`, beside it in this repository.
Each TPU (Pallas) kernel is written again by hand in CUDA C++ for sm_90a
and built with nvcc on first use: the bitonic compare-exchange network
(`backend="network"`, `csrc/bitonic.cu`, `csrc/fused.cu`) and the LSD
radix sort the reference library is named for (`backend="radix"`, a block
sort and a placement kernel, `csrc/radix.cu`); a `torch.sort` reference
backend completes the set. The default, `backend="auto"`, picks per kind
of sort (keys, stable and non-stable key-value) and key width from the
sorter's size, as the JAX package's does: on a card the reference below a
cut measured on the H100 and the kind's engine from it, on the CPU the
reference (`models.sorter.AUTO`). The one-shot `sort` and
`sort_key_value` size their sorter by the call's n. It sorts uint32,
int32 and float32 keys, key-value pairs (stable, or on the network
non-stable by (key, value)), and dynamic counts (`count=`, the
reference's indirect path), on a CUDA device unless asked for the CPU,
where each kernel's plain PyTorch version runs instead. uint64, int64
and float64 keys sort the same ways on the network (as (hi, lo) uint32
words, key-value in the three-word carries of `csrc/network_w64.cu`), on
radix (as (word, position) pairs through the same passes) and on the
reference backend. The Sorter checks, encodes, picks the backend and
opens the spans; each backend's one `sort` (`ops.radix`, `ops.bitonic`,
`ops.reference`) owns `count=`, `end_bit` and the key width. uint32 and uint64 keys may be ordered by
their low `end_bit` bits alone, stably, and come back whole, as with
CUB's end_bit: a sort of fewer bits runs fewer radix passes, and 'auto'
gives a 64-bit call to radix only at pass counts where radix was measured
to win (`models.sorter.AUTO_MAX_PASSES64`). `SortConfig(adaptive=True)`
answers sorted, reverse-sorted and constant inputs without the engine.
Measurement:
`Sorter.sort_timed` / `sort_key_value_timed` (per-stage device times),
`utils.profiling` (a torch.profiler trace), and the bench harness,
`python -m vulkan_radix_sort_tpu_torch.bench <backend>`.
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


def sort(keys, count=None, config=None, end_bit=None):
    """One-shot ascending sort on the keys' device (a throwaway Sorter);
    `end_bit` as in `Sorter.sort`.

    Analog of vrdxCmdSort / vrdxCmdSortIndirect (h.in:310-331).
    """
    s = Sorter(max(1, keys.numel()), key_dtype=keys.dtype, config=config,
               device=keys.device)
    return s.sort(keys, count=count, end_bit=end_bit)


def sort_key_value(keys, values, count=None, config=None, stable=True,
                   end_bit=None):
    """One-shot key-value sort on the keys' device (stable by default);
    `end_bit` as in `Sorter.sort`.

    Analog of vrdxCmdSortKeyValue / ...Indirect (h.in:333-342).
    """
    s = Sorter(max(1, keys.numel()), key_dtype=keys.dtype, config=config,
               device=keys.device)
    return s.sort_key_value(keys, values, count=count, stable=stable,
                            end_bit=end_bit)
