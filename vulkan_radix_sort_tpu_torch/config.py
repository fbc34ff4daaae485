"""Sort configuration and the Hopper geometry the network kernels are sized by.

PyTorch/CUDA counterpart of `vulkan_radix_sort_tpu/config.py`. The TPU
geometry there (128 lanes, 8 sublanes, VMEM-swept chunk sizes) does not
carry over: on an H100 a thread block holds at most 232,448 bytes of
shared memory, and that budget decides how many elements one kernel can
keep on chip for each carry.
"""

from __future__ import annotations

import dataclasses
import functools

# Dynamic shared memory one H100 thread block may use (227 KB of the SM's
# 256 KB; above 48 KB only after cudaFuncSetAttribute).
SMEM_BYTES = 232_448

# Out-of-range keys read as the maximum key, as in the reference's
# upsweep.slang:32 and the JAX package's KEY_SENTINEL.
KEY_SENTINEL = 0xFFFFFFFF

# Bytes per element of each carry the network moves.
BYTES_KEYS = 4      # (k,)
BYTES_PAIRS = 8     # (k, v), both compared
BYTES_STABLE = 12   # (k, idx) compared, v rides


def smem_elems(bytes_per_elem: int) -> int:
    """Largest power-of-two element count whose carry fits one block."""
    return 1 << ((SMEM_BYTES // bytes_per_elem).bit_length() - 1)


MAX_SMEM_KEYS = smem_elems(BYTES_KEYS)        # 2^15
MAX_SMEM_PAIRS = smem_elems(BYTES_PAIRS)      # 2^14
MAX_SMEM_STABLE = smem_elems(BYTES_STABLE)    # 2^14
MIN_CHUNK = 256

# Default chunk (elements one chunk/local kernel block sorts in shared
# memory). A quarter of each carry's cap, so a fused group of 2^2 chunks
# still fits one block and the fused-rounds kernel runs on the main path.
CHUNK_KEYS = MAX_SMEM_KEYS // 4               # 2^13
CHUNK_CARRY = MAX_SMEM_STABLE // 4            # 2^12

BACKENDS = ("auto", "network", "reference")


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration of one sorter.

    chunk: elements per chunk of the network backend, a power of two
        >= 256. None resolves per path kind (CHUNK_KEYS for keys-only
        sorts, CHUNK_CARRY for key-value sorts); an explicit value applies
        to every path and must fit each carry's shared-memory cap.
    backend: 'network' (the bitonic kernels), 'reference' (torch.sort, the
        counterpart of the JAX package's 'xla'), or 'auto' (network on a
        CUDA device, reference on the CPU).
    adaptive: the JAX package's sorted-input fast paths; not ported yet.
    """

    chunk: int | None = None
    backend: str = "auto"
    adaptive: bool = False

    def __post_init__(self):
        if self.backend in ("radix", "pallas"):
            raise NotImplementedError(
                "the radix backend is not ported yet; use 'network', "
                "'reference' or 'auto'")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.adaptive:
            raise NotImplementedError("adaptive fast paths are not ported yet")
        c = self.chunk
        if c is not None and (c < MIN_CHUNK or c & (c - 1)):
            raise ValueError(f"chunk must be a power of two >= {MIN_CHUNK}")

    @property
    def chunk_keys(self) -> int:
        """Resolved chunk for keys-only network sorts."""
        return CHUNK_KEYS if self.chunk is None else self.chunk

    @property
    def chunk_carry(self) -> int:
        """Resolved chunk for key-value network sorts."""
        return CHUNK_CARRY if self.chunk is None else self.chunk


@functools.cache
def default_config() -> SortConfig:
    return SortConfig()


def config_from_jax(fields: dict) -> SortConfig:
    """Map `dataclasses.asdict` of a JAX-package SortConfig onto the port's.

    A sorter has no weights, so its configuration is all the state there is
    to carry across. Backend names map ('xla' -> 'reference'). `interpret`
    is dropped: the port's counterpart of interpret mode is a CPU device.
    The radix pipeline's geometry (`block`, `digit_bits`, `flush_rows`) is
    dropped with it, since the radix backend is not ported. An explicit
    chunk is kept only if it fits every carry's shared-memory cap (it
    applies to every path); otherwise this raises rather than clamp.
    """
    known = {"block", "digit_bits", "flush_rows", "chunk", "backend",
             "interpret", "adaptive"}
    unknown = set(fields) - known
    if unknown:
        raise TypeError(f"unknown SortConfig fields: {sorted(unknown)}")
    backend = fields.get("backend", "auto")
    backend = {"xla": "reference", "pallas": "radix"}.get(backend, backend)
    chunk = fields.get("chunk")
    cap = min(MAX_SMEM_KEYS, MAX_SMEM_PAIRS, MAX_SMEM_STABLE)
    if chunk is not None and chunk > cap:
        raise ValueError(
            f"chunk {chunk} exceeds the {cap}-element shared-memory cap of "
            "the key-value carries on this card")
    return SortConfig(chunk=chunk, backend=backend,
                      adaptive=bool(fields.get("adaptive", False)))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b
