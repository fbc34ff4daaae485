"""The benchmark's files: BENCHMARK.json to its contract, and every cell,
configuration, traffic mix and metric found by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    spec = run.load_cell(cell)
    w = spec["cell"]
    assert spec["config"]["name"] == w["config"]
    assert spec["traffic"]["name"] == w["traffic"]
    assert w["chips"] == 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    assert "setup_s" in names and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w[k] for w in BENCH["workloads"] for k in ("config",
                                                            "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.fullmatch(name), name
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_config_files_state_what_runs():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        run.resolve(cfg["reference"])
        run.resolve(cfg["control"])
        assert cfg["guarantees"] and cfg["assumed"]


def test_check_fits_in_its_time():
    cells = 24
    runs = 2 + 14 * cells
    seconds = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert seconds <= 43200
