"""utils/block_sort_probe.py on the CPU: the copies of K7 that stop after
each phase, cut at the phase markers of csrc/radix.cu, the geometry it
reads from a source, and the entry point that reports a copy's
attributes. Building and timing the copies needs nvcc and a card."""

import re
from pathlib import Path

import pytest
import torch

from vulkan_radix_sort_tpu_torch.ops import block_sort as k7
from vulkan_radix_sort_tpu_torch.utils import block_sort_probe as probe

RADIX_CU = (Path(k7.__file__).parents[1] / "csrc" / "radix.cu").read_text()


def test_variants_cut_the_kernel_after_each_phase():
    """One copy per marker of block_sort_kernel, in its order, and the
    source unchanged; each copy replaces its marker alone by a sink that
    keeps the phase's work and a `continue` to the next block."""
    cuts = probe.variants(RADIX_CU, pin=False)
    assert list(cuts) == ["rank", "scan", "scatter", "full"]
    assert cuts["full"] == RADIX_CU
    markers = probe.MARKER.findall(RADIX_CU)
    for (indent, name, sink, stop) in markers:
        copy = cuts[name]
        assert stop == "continue"  # the thread blocks walk the blocks
        assert f"hist[0] = int({sink});\n{indent}continue;" in copy
        assert len(probe.MARKER.findall(copy)) == len(markers) - 1
        assert copy.count("\n") == RADIX_CU.count("\n") + 1


def test_pin_gives_every_copy_the_most_shared_memory():
    for copy in probe.variants(RADIX_CU, pin=True).values():
        assert probe.PIN_TO in copy and probe.PIN_FROM not in copy
    with pytest.raises(ValueError, match="--pin"):
        probe.variants("no launcher here", pin=True)


@pytest.mark.parametrize("block", [512, 2048, 4096, 16384])
def test_geometry_read_from_the_source_is_sort_geometry(block):
    for kv in (False, True):
        assert probe.geometry(RADIX_CU, block, kv) == \
            k7.sort_geometry(block)


def test_attrs_entry_names_the_launched_instantiations():
    src = probe.attrs_source(RADIX_CU, 16384, 8)
    assert "block_sort_kernel<true, 32, 8>" in src
    assert "block_sort_kernel<false, 32, 8>" in src
    assert re.search(r"kv \? 512 : 512", src)


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs there")
    with pytest.raises(SystemExit, match="CUDA"):
        probe.main(["--n-log", "12"])
