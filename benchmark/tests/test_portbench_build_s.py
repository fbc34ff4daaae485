"""The reader of the program's kernel build, `build_s`."""

import pytest

from benchmark import run
from vulkan_radix_sort_tpu_torch import _build


def read(record):
    return run.read_metrics([{"name": "build_s", "unit": "s"}],
                            record).get("build_s", {}).get("value")


@pytest.mark.parametrize("compiled", [(), _build.SOURCES])
def test_build_s_reads_the_kept_build(monkeypatch, compiled):
    monkeypatch.setattr(_build, "built", {"seconds": 1.5,
                                          "compiled": compiled})
    assert read({}) == 1.5


def test_nothing_built_is_left_out(monkeypatch):
    monkeypatch.setattr(_build, "built", None)
    assert read({}) is None
    monkeypatch.delattr(_build, "built")  # a program that keeps no record
    assert read({}) is None
