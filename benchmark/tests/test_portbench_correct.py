"""What decides `correct` fails what it has to: the control in the
program's place, and the timed path broken underneath. Small sizes on the
CPU here; `test_control_fails_at_the_cells_size` runs the control at the
cells' own sizes on the card."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import readings, run
from vulkan_radix_sort_tpu_torch.models.sorter import Sorter

SMALL = 1 << 18  # uniform 2^18 keys hold ~8 pairs of equal keys
CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())[
        "workloads"]]


def small(cell: str) -> dict:
    spec = run.load_cell(cell)
    spec["traffic"]["sizes"] = [SMALL]
    spec["config"]["max_n"] = 2 * SMALL
    return spec


def _correct(spec, seed=2**31 + 11, program=None) -> dict:
    return run.run_cell(spec, seed, 0.05, False, "cpu", program=program)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    res = _correct(small(cell))
    assert res["correct"] and res["failed"] == 0
    assert all(v["value"] == 0 for v in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    spec = small(cell)
    res = _correct(spec, program=run.resolve(spec["config"]["control"]))
    assert not res["correct"] and res["failed"] > 0


def _unchanged(out, args):
    return tuple(a.clone() for a in args)


def _half(out, args):
    h = args[0].numel() // 2
    return tuple(torch.cat([o[:h], a[h:]]) for o, a in zip(out, args))


def _one_key(out, args):
    k = out[0].clone()
    k[len(k) // 3] = k[len(k) // 3 + 1] ^ 1
    return (k, *out[1:])


def _one_value(out, args):
    v = out[1].clone()
    v[7] ^= 1
    return (out[0], v)


FAULTS = [(cell, fault) for cell in CELLS
          for fault in (_unchanged, _half, _one_key, _one_value)
          if fault is not _one_value or cell.startswith("kv_")]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_sort_is_not_correct(cell, fault, monkeypatch):
    spec = small(cell)
    entry = spec["config"]["entry"]
    real = getattr(Sorter, entry)

    def broken(self, keys, *rest, **kw):
        out = real(self, keys, *rest, **kw)
        out = out if isinstance(out, tuple) else (out,)
        out = fault(out, (keys, *rest))
        return out if len(out) > 1 else out[0]
    monkeypatch.setattr(Sorter, entry, broken)
    res = _correct(spec)
    assert not res["correct"] and res["failed"] > 0


def test_keys_follow_the_configurations_key_type():
    spec = small("keys_u32.n25_uniform")
    spec["config"]["key_dtype"] = "uint64"
    spec["traffic"]["sizes"] = [1 << 12]
    inputs = run.make_inputs(spec["config"], spec["traffic"], 2**31 + 3)
    assert all(k.dtype.name == "uint64" for (k,) in inputs)
    assert max(int(k.max()) for (k,) in inputs) >= 1 << 62
    res = _correct(spec)
    assert res["correct"] and res["check"]["keys_mismatched"]["value"] == 0


def test_readings_give_both_sides():
    got = list(readings.read(small("kv_u32_indirect.n25_zipf"), [3, 4], [5],
                             0.05, "cpu"))
    assert [(side, res["correct"]) for side, _, res in got] == [
        ("program", True), ("program", True), ("control", False)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, card):
    spec = run.load_cell(cell)
    got = list(readings.read(spec, [], [101, 102, 103], 0.5, card))
    assert len(got) == 3
    for _, _, res in got:
        assert not res["correct"]
