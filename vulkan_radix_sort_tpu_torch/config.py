"""Sort configuration and the Hopper geometry the kernels are sized by.

PyTorch/CUDA counterpart of `vulkan_radix_sort_tpu/config.py`. The TPU
geometry there (128 lanes, 8 sublanes, VMEM-swept chunk sizes, a 4-bit
digit sized for the MXU's one-hot ranks, DMA flush rows) does not carry
over: on an H100 a thread block holds at most 232,448 bytes of shared
memory, and that budget decides how many elements one kernel can keep on
chip for each carry. The radix geometry starts from the reference's own
constants (src/shader/constants.slang:1-5: RADIX=256, WORKGROUP_SIZE=512,
PARTITION_SIZE=4096).
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

# Radix backend. Bits per LSD pass: the reference's RADIX = 256. 4 is
# also supported, so the kernels can be held against the JAX package's
# 4-bit geometry; the block-sort kernel's ranks and scans assume at most
# 256 digits.
DIGIT_BITS = 8
RADIX_DIGIT_BITS = (4, 8)
# Keys per block of the radix kernels, by default the largest block
# (MAX_RADIX_BLOCK below) rather than the reference's PARTITION_SIZE of
# 4096: on an H100 a pass's block sort, spine and placement together are
# faster there at 2^25 keys, as the placement's runs grow and the offset
# table shrinks fourfold while the block sort slows by less; from 2^16 to
# 2^22 keys no block size sorts measurably faster, since host launch time
# bounds those sorts (`utils/block_sweep.py`, PERF.md).
RADIX_BLOCK = 1 << 14
# Most threads of a block-sort block (the reference's WORKGROUP_SIZE;
# kThreads in csrc/radix.cu), and the smallest block: a block is split
# into one contiguous segment per warp, held in registers and ranked 32
# keys at a time, with 4 to 32 keys a thread
# (`block_sort.sort_geometry`).
RADIX_THREADS = 512
# Largest block whose keys and values in registers, and whose block-sort
# tile (keys and values, per-warp digit counts), fit one thread block.
MAX_RADIX_BLOCK = 1 << 14

BACKENDS = ("auto", "network", "radix", "reference")
# 'pallas' predates the network engine in the JAX package, which keeps it
# as an alias of its radix pipeline (models/sorter.py:58-60); so does the
# port.
BACKEND_ALIASES = {"pallas": "radix"}


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration of one sorter.

    chunk: elements per chunk of the network backend, a power of two
        >= 256. None resolves per path kind (CHUNK_KEYS for keys-only
        sorts, CHUNK_CARRY for key-value sorts); an explicit value applies
        to every path and must fit each carry's shared-memory cap.
    block: keys per block of the radix backend, a power of two from
        RADIX_THREADS to MAX_RADIX_BLOCK.
    digit_bits: bits per radix pass, 4 or 8 (16 or 256 buckets; 8 or 4
        passes over a 32-bit key).
    backend: 'network' (the bitonic kernels), 'radix' (the LSD radix
        kernels; 'pallas' is an alias, stored as 'radix'), 'reference'
        (torch.sort, the counterpart of the JAX package's 'xla'), or
        'auto' (network on a CUDA device, reference on the CPU).
    adaptive: the JAX package's sorted-input fast paths; not ported yet.
    """

    chunk: int | None = None
    backend: str = "auto"
    adaptive: bool = False
    block: int = RADIX_BLOCK
    digit_bits: int = DIGIT_BITS

    def __post_init__(self):
        backend = BACKEND_ALIASES.get(self.backend, self.backend)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        object.__setattr__(self, "backend", backend)
        if self.adaptive:
            raise NotImplementedError("adaptive fast paths are not ported yet")
        c = self.chunk
        if c is not None and (c < MIN_CHUNK or c & (c - 1)):
            raise ValueError(f"chunk must be a power of two >= {MIN_CHUNK}")
        b = self.block
        if b < RADIX_THREADS or b > MAX_RADIX_BLOCK or b & (b - 1):
            raise ValueError(f"block must be a power of two in "
                             f"[{RADIX_THREADS}, {MAX_RADIX_BLOCK}]")
        if self.digit_bits not in RADIX_DIGIT_BITS:
            raise ValueError(f"digit_bits must be one of {RADIX_DIGIT_BITS}")

    @property
    def radix(self) -> int:
        """Buckets per radix pass."""
        return 1 << self.digit_bits

    @property
    def num_passes(self) -> int:
        """Radix passes over a 32-bit key."""
        return -(-32 // self.digit_bits)

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
    to carry across. Backend names map ('xla' -> 'reference', 'pallas' and
    'radix' -> 'radix'). `interpret` is dropped: the port's counterpart of
    interpret mode is a CPU device. The radix pipeline's geometry (`block`,
    `digit_bits`, `flush_rows`) is dropped too: it is TPU geometry (a 4-bit
    digit for the MXU's one-hot ranks, 128-lane rows, DMA flush rows), and
    the port's radix backend takes Hopper's own defaults. An explicit
    chunk is kept only if it fits every carry's shared-memory cap (it
    applies to every path); otherwise this raises rather than clamp.
    """
    known = {"block", "digit_bits", "flush_rows", "chunk", "backend",
             "interpret", "adaptive"}
    unknown = set(fields) - known
    if unknown:
        raise TypeError(f"unknown SortConfig fields: {sorted(unknown)}")
    backend = fields.get("backend", "auto")
    backend = "reference" if backend == "xla" else backend
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
