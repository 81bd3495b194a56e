"""What the benchmark loads, and where it refuses to run."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tiny import ROOT, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "pwclonet_pylidarslam_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & ({"pwclonet_pylidarslam_torch"} | FORBIDDEN), path


def test_no_file_of_the_benchmark_names_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path


RUN_ALL_CELLS = """
import sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import runpy
runpy.run_path({run!r}, run_name="bench_run")  # the entry's own imports
from tiny import tiny_cell
from benchmark.harness import runner
for name in ("pwclonet-train-b8", "pwclonet-odometry-seq32", "pointnet2-semseg-train-b32"):
    runner.run_cell(tiny_cell(name), {seed}, 0.2, True, torch.device("cpu"), 0.0)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print("LOADED", ",".join(tops))
print("REF", ",".join(sorted(m for m in sys.modules if m.startswith("benchmark.reference"))))
"""


def test_no_module_of_jax_is_loaded_by_a_run():
    """Every cell's drive, reference and trace in one process (on the CPU, at
    a small size): no top-level module of JAX or of the JAX package, by
    whole names, is in ``sys.modules`` after."""
    code = RUN_ALL_CELLS.format(root=str(ROOT), tests=str(ROOT / "benchmark/tests"),
                                run=str(ROOT / "benchmark/run.py"), seed=SEED)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("LOADED "))
    loaded = set(line.split(" ", 1)[1].split(","))
    assert "pwclonet_pylidarslam_torch" in loaded  # the program did run
    assert not loaded & FORBIDDEN


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.pwclonet, benchmark.reference.pointnet2, "
            "benchmark.reference.world, benchmark.reference.rooms, benchmark.reference.params, "
            "benchmark.reference.adam\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "pwclonet_pylidarslam_torch" not in out.stdout


def _run(cwd: Path, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "pointnet2-semseg-train-b32", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_fails_without_a_card_and_prints_no_result():
    """Where no card is visible the run exits with another code than 0 and
    prints nothing on standard output: the measuring path never falls back
    to the CPU."""
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_fails_with_only_the_benchmarks_files(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of the cheapest cell on the card, its result line
    read (skips where no card is visible)."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "pointnet2-semseg-train-b32", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
