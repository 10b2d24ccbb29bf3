"""The yardstick imports nothing of the program, no run loads JAX, and a run without a
card prints no result."""

import ast
import subprocess
import sys

import pytest

from benchmark import run

YARDSTICK = ("gen", "reference")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("part", YARDSTICK)
def test_yardstick_sources_import_nothing_of_the_program(part):
    for path in (run.BENCH / part).rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"plviwo_tpu_torch", "plviwo_tpu", "jax", "jaxlib", "flax"}, path


def test_yardstick_loads_no_program_module():
    code = ("import sys; import benchmark.reference.checks, benchmark.gen.scenarios, "
            "benchmark.metrics._roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'plviwo_tpu_torch', 'plviwo_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "plviwo_tpu_torch_fake", object())
    assert "plviwo_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "plviwo_tpu.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.loaded_forbidden() == ["jax", "plviwo_tpu"]


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fleet_plwg",
                          "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no card" in out.stderr
