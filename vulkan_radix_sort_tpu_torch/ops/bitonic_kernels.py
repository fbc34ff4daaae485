"""The bitonic network's kernels: a wrapper and a plain version for each.

Each kernel of `csrc/bitonic.cu` (and `csrc/fused.cu`, K2) replaces one
Pallas kernel of `vulkan_radix_sort_tpu/ops/bitonic.py`:

  chunk  (K1)  _run_chunk / _chunk_phases_body      bitonic.py:934, 513
  fused  (K2)  _run_fused_rounds / _fused_rounds_body  bitonic.py:723, 628
  cross  (K3)  _run_cross / _cross_kernel_body      bitonic.py:948, 579
  local  (K4)  _run_local / _local_kernel_body      bitonic.py:993, 604
  valid= (K5)  _gate_body                           bitonic.py:746
  local_gated (K6)  _block_call_dma_gated           bitonic.py:793

Every kernel works in place on the carry's flat uint32 buffers (1 to 3 of
them, see `Mode`), over the first `nunits` grid units only; a unit whose
`valid` flag (int32, one per unit) is 0 is left as it is. What bounds each
kernel on an H100 and what its design does about it is noted in the CUDA
source. The chunk, local and fused kernels hold E elements per thread in
registers (`block_geometry`) and load them as 16-byte vectors, so their
buffers must be 16-byte aligned (`check_aligned`).

K6 is K4's kernel launched over every C-block of a slot buffer under the
slot merge's per-block mask, with no prefix clip: on the TPU it exists
because a BlockSpec pipeline moves every grid step's block, while on
Hopper a gated thread block returns before its first load and moves
nothing. It has its own wrapper and launch counter so that a run shows
the slot merge went through it.

The wrapper (`chunk`, `fused`, `cross`, `local`, `local_gated`, all
through `run`) runs
the plain version when the buffers lie on the CPU, and otherwise launches
the CUDA kernel or raises; it counts each launch in `launches`. The plain
version (`run_plain`, on the same `spec`) applies the same compare-exchange
stages with PyTorch tensor operations, widened to int64 where uint32 has no
comparisons. It serves the CPU tests and the kernel-versus-plain check on
the card, never the CUDA main path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..config import MIN_CHUNK, smem_elems
from .bitops import check_aligned, narrow_u32, widen_u32


class Mode(NamedTuple):
    """A carry: `words` lexicographically compared uint32 arrays, then
    `ride` riding arrays that move with them uncompared."""

    name: str
    code: int  # the mode code of the C interface
    words: int
    ride: int

    @property
    def n_arrays(self) -> int:
        return self.words + self.ride

    @property
    def smem_cap(self) -> int:
        """Elements of this carry one thread block holds in shared memory."""
        return smem_elems(4 * self.n_arrays)


KEYS = Mode("keys", 0, 1, 0)      # (k,)
PAIRS = Mode("pairs", 1, 2, 0)    # (k, v): non-stable key-value
STABLE = Mode("stable", 2, 2, 1)  # (k, idx) compared, v rides: stable kv
MODES = (KEYS, PAIRS, STABLE)

# consecutive elements per row of a cross tile; kCrossW in csrc/bitonic.cu
LOG_CROSS_W = 6
CROSS_W = 1 << LOG_CROSS_W

# The chunk, local and fused kernels keep E elements per thread in
# registers (net_threads and kNetThreads in csrc/network.cuh): 16 keys or 8
# elements of a two-word carry per thread, raised so a block has at most
# NET_THREADS threads and lowered so it has at least one warp; a thread
# that would hold REG_WORDS words or more (each carry's largest chunk)
# takes WIDE_THREADS threads instead, which leaves it twice the registers.
# A fused group of G elements has the geometry of a chunk of G, except
# there (fused_threads in csrc/fused.cu): one such block fits an SM, so
# it takes MAX_THREADS threads if a thread then holds at most half of
# REG_WORDS words, else NET_THREADS.
NET_THREADS = 512
WIDE_THREADS = 256
MAX_THREADS = 1024
REG_WORDS = 64
WARP = 32
REG_KERNELS = ("chunk", "local", "local_gated", "fused")


def block_geometry(kernel: str, mode: Mode, C: int) -> tuple[int, int]:
    """(threads, elements per thread) of a chunk or local launch at C, or
    of a fused launch on groups of C elements."""
    if kernel not in REG_KERNELS:
        raise ValueError(f"{kernel} keeps its tile in shared memory")
    threads = min(max(C // (16 if mode.words == 1 else 8), WARP), NET_THREADS)
    if C // threads * mode.n_arrays >= REG_WORDS:
        threads = WIDE_THREADS
        if kernel == "fused":
            threads = (MAX_THREADS if C // MAX_THREADS * mode.n_arrays
                       <= REG_WORDS // 2 else NET_THREADS)
    return threads, C // threads


# Launches per kernel since the last reset; "gate" counts the launches of
# K1-K4 that carried a `valid` array (K5; K6 always carries one and counts
# only as "local_gated"). The only mutable state of the port.
launches = {"chunk": 0, "fused": 0, "cross": 0, "local": 0, "gate": 0,
            "local_gated": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def log2(n: int) -> int:
    b = n.bit_length() - 1
    if n <= 0 or 1 << b != n:
        raise ValueError(f"{n} is not a power of two")
    return b


class Launch(NamedTuple):
    """Geometry of one kernel launch, shared by the wrapper, the plain
    version and the work counts."""

    kernel: str
    unit: int      # elements per grid unit; a valid flag covers one unit
    tile: int      # elements one block holds in shared memory
    stages: tuple  # (j, p): pair i with i ^ 2^j, descending iff bit p of i
    cfn: str       # C entry point
    cargs: tuple   # its arguments after (mode, k, t, v, n_units)


def spec(kernel: str, C: int, *args: int) -> Launch:
    """Launch geometry: spec('chunk', C), spec('local', C, r),
    spec('local_gated', C, r), spec('fused', C, r_lo, r_hi),
    spec('cross', C, r, t_lo, span)."""
    lc = log2(C)
    if C < MIN_CHUNK:
        raise ValueError(f"chunk must be >= {MIN_CHUNK}")
    if kernel == "chunk":
        stages = tuple((pj, pk) for pk in range(1, lc + 1)
                       for pj in range(pk - 1, -1, -1))
        return Launch(kernel, C, C, stages, "vrs_chunk", (lc,))
    if kernel in ("local", "local_gated"):
        (r,) = args
        stages = tuple((pj, lc + r) for pj in range(lc - 1, -1, -1))
        return Launch(kernel, C, C, stages, "vrs_local", (lc, r))
    if kernel == "fused":
        r_lo, r_hi = args
        if not 1 <= r_lo <= r_hi:
            raise ValueError(f"bad fused rounds {r_lo}..{r_hi}")
        stages = tuple((j, lc + r) for r in range(r_lo, r_hi + 1)
                       for j in range(lc + r - 1, -1, -1))
        g = C << r_hi
        return Launch(kernel, g, g, stages, "vrs_fused", (lc, r_lo, r_hi))
    if kernel == "cross":
        r, t_lo, span = args
        if span < 1 or t_lo < 0 or t_lo + span > r:
            raise ValueError(f"bad cross span t_lo={t_lo} span={span} r={r}")
        stages = tuple((lc + t, lc + r)
                       for t in range(t_lo + span - 1, t_lo - 1, -1))
        return Launch(kernel, C << r, CROSS_W << span, stages, "vrs_cross",
                      (lc, r, t_lo, span))
    raise ValueError(f"unknown kernel {kernel!r}")


def _check(launch: Launch, arrs, mode: Mode, nunits: int, valid) -> None:
    if len(arrs) != mode.n_arrays:
        raise ValueError(f"{mode.name} carries {mode.n_arrays} arrays, "
                         f"got {len(arrs)}")
    n, dev = arrs[0].numel(), arrs[0].device
    for a in arrs:
        if a.dtype != torch.uint32 or a.dim() != 1 or not a.is_contiguous():
            raise TypeError("buffers must be contiguous 1-D uint32 tensors")
        if a.device != dev or a.numel() != n:
            raise ValueError("buffers must share one device and length")
    if not 0 <= nunits * launch.unit <= n:
        raise ValueError(f"{nunits} units of {launch.unit} exceed {n} "
                         "elements")
    if launch.tile > mode.smem_cap:
        raise ValueError(f"a {launch.kernel} tile of {launch.tile} "
                         f"{mode.name} elements exceeds the shared-memory "
                         f"cap {mode.smem_cap}")
    if valid is None and launch.kernel == "local_gated":
        raise ValueError("local_gated needs a per-block valid mask")
    if valid is not None and (
            valid.dtype != torch.int32 or valid.device != dev
            or not valid.is_contiguous() or valid.numel() < nunits):
        raise ValueError("valid must be a contiguous int32 tensor on the "
                         "buffers' device with a flag per unit")


def _plain(launch: Launch, arrs, mode: Mode, nunits: int, valid) -> None:
    m = launch.unit * nunits
    if m == 0:
        return
    words = [widen_u32(a[:m]) for a in arrs[:mode.words]]
    # one int64 per element whose order is the carry's lexicographic order
    key = words[0] if mode.words == 1 else (
        ((words[0] - (1 << 31)) << 32) | words[1])
    ride = arrs[mode.words][:m].view(torch.int32) if mode.ride else None
    idx = torch.arange(m, device=key.device)
    for j, p in launch.stages:
        h = 1 << j
        a, b = key.view(-1, 2, h).unbind(1)
        desc = ((idx.view(-1, 2, h)[:, 0] >> p) & 1).bool()
        swap = torch.where(desc, a < b, a > b)
        key = torch.stack(
            (torch.where(swap, b, a), torch.where(swap, a, b)), 1).view(-1)
        if ride is not None:
            ra, rb = ride.view(-1, 2, h).unbind(1)
            ride = torch.stack(
                (torch.where(swap, rb, ra), torch.where(swap, ra, rb)),
                1).view(-1)
    if mode.words == 1:
        outs = [narrow_u32(key)]
    else:
        outs = [narrow_u32((key >> 32) + (1 << 31)),
                narrow_u32(key & 0xFFFFFFFF)]
    if ride is not None:
        outs.append(ride.view(torch.uint32))
    if valid is not None:
        live = valid[:nunits].bool().repeat_interleave(launch.unit)
        outs = [torch.where(live, o.view(torch.int32),
                            a[:m].view(torch.int32)).view(torch.uint32)
                for o, a in zip(outs, arrs)]
    for a, o in zip(arrs, outs):
        a[:m].copy_(o)


def _launch(launch: Launch, arrs, mode: Mode, nunits: int, valid) -> None:
    dev = arrs[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if nunits == 0:
        return
    check_aligned(arrs)
    lib = _build.library()
    ptrs = [a.data_ptr() for a in arrs] + [None] * (3 - len(arrs))
    vptr = None if valid is None else valid.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, launch.cfn)(mode.code, *ptrs, nunits,
                                       *launch.cargs, vptr, stream)
    _build.check(err, f"{launch.cfn} ({mode.name})")
    for name in counters(launch, valid):
        launches[name] += 1


def counters(launch: Launch, valid) -> list[str]:
    """The launch counters one launch of the kernel adds to."""
    gate = valid is not None and launch.kernel != "local_gated"
    return [launch.kernel] + (["gate"] if gate else [])


def run(launch: Launch, arrs, mode: Mode, nunits: int, valid=None) -> None:
    """Wrapper: the plain version for CPU buffers, the kernel for CUDA."""
    _check(launch, arrs, mode, nunits, valid)
    if arrs[0].device.type == "cpu":
        _plain(launch, arrs, mode, nunits, valid)
    else:
        _launch(launch, arrs, mode, nunits, valid)


def run_plain(launch: Launch, arrs, mode: Mode, nunits: int,
              valid=None) -> None:
    """The plain version on any device."""
    _check(launch, arrs, mode, nunits, valid)
    _plain(launch, arrs, mode, nunits, valid)


# -- K1 chunk ---------------------------------------------------------------

def chunk(arrs, mode, C, nunits, valid=None):
    """Fully sort each of the first `nunits` C-element chunks; even chunks
    end ascending, odd ones descending."""
    run(spec("chunk", C), arrs, mode, nunits, valid)


# -- K2 fused rounds --------------------------------------------------------

def fused(arrs, mode, C, r_lo, r_hi, ngroups, valid=None):
    """Merge rounds r_lo..r_hi on each of the first `ngroups` groups of
    2^r_hi chunks, each group held whole on one thread block."""
    run(spec("fused", C, r_lo, r_hi), arrs, mode, ngroups, valid)


# -- K3 cross ---------------------------------------------------------------

def cross(arrs, mode, C, r, t_lo, span, ngroups, valid=None):
    """Round r's cross stages at distances 2^(t_lo+span-1)*C .. 2^t_lo*C on
    each of the first `ngroups` groups of 2^r chunks."""
    run(spec("cross", C, r, t_lo, span), arrs, mode, ngroups, valid)


# -- K4 local ---------------------------------------------------------------

def local(arrs, mode, C, r, nunits, valid=None):
    """Round r's stages at distance < C inside each of the first `nunits`
    chunks."""
    run(spec("local", C, r), arrs, mode, nunits, valid)


# -- K6 gated local ---------------------------------------------------------

def local_gated(arrs, mode, C, r, nunits, valid):
    """Round r's stages at distance < C in each of the first `nunits`
    C-blocks whose `valid` flag is set; the rest move no bytes. The slot
    merge's local pass."""
    run(spec("local_gated", C, r), arrs, mode, nunits, valid)
