"""Nothing the benchmark runs loads JAX or the JAX package, the yardstick
loads nothing of the program, and a run without a card or without the
program prints no result."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MODULES = sorted(BENCH.rglob("*.py"))
YARDSTICK = ("datagen.py", "reference.py", "roofline.py", "control.py")


def _imported(path: Path) -> set[str]:
    """Top-level names of every module that `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax(path):
    assert not _imported(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert run.PROGRAM not in _imported(BENCH / name)
    assert _imported(BENCH / name) <= {"__future__", "numpy", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vulkan_radix_sort_tpu_torch.ops", sys)
    monkeypatch.setitem(sys.modules, "vulkan_radix_sort_tpux", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vulkan_radix_sort_tpu.ops", sys)
    assert run.forbidden_modules() == ["vulkan_radix_sort_tpu"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "keys_u32.n25_uniform", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_run_without_a_card_prints_no_result(no_card):
    res = _run(ROOT)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""


def test_a_cell_across_cards_is_refused(monkeypatch, capsys):
    spec = run.load_cell("keys_u32.n25_uniform")
    spec["cell"]["chips"] = 4
    monkeypatch.setattr(run, "load_cell", lambda name: spec)
    assert run.main(["--workload", "keys_u32.n25_uniform", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
