"""The manifest keeps to the benchmark's contract, and every cell finds its
files by name; a cell and a metric added as files alone are listed and
run."""

import json
import re
import shutil

import pytest
import torch

from tiny import ROOT, SEED, tiny_cell

from benchmark.harness import manifest, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") and m["source"] in SOURCES for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    assert all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = manifest.load_cell(ROOT / "BENCHMARK.json", cell)
    assert hasattr(c.driver, "Driver")
    assert c.workload["limits"]
    for m in c.end_to_end + c.per_layer:
        module = c.metric_modules[m["name"]]
        assert module.UNIT == m["unit"] and callable(module.read)
        if "layer" in m:
            assert (module.LAYER, module.MOVES, module.SOURCE) == (m["layer"], m["moves"],
                                                                    m["source"])
    names = {m["name"] for m in c.per_layer}
    assert names, "every cell reports a per-layer metric"
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}


def test_cell_and_metric_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a cell (a workload file over an existing
    configuration and driver) and a per-layer metric (a reader file), and
    entries in its manifest; no file that was there is edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    src = json.loads((ROOT / "benchmark/workloads/pwclonet-odometry-seq32.json").read_text())
    src["chunk"] = 8
    (tmp_path / "benchmark/workloads/pwclonet-odometry-seq8.json").write_text(json.dumps(src))
    (tmp_path / "benchmark/metrics/calls_in_window.odometry.py").write_text(
        'UNIT = "calls"\nLAYER = "odometry driver"\nMOVES = "odometry_frames_per_s"\n'
        'SOURCE = "host_clock"\n\n\ndef read(rec):\n    return rec.window.calls\n')
    bench["workloads"].append({"name": "pwclonet-odometry-seq8", "config": "pwclonet-kitti",
                               "traffic": "drive-chunks-8", "chips": 1, "why": "shorter chunks"})
    bench["per_layer"].append({"name": "calls_in_window.odometry", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "odometry driver", "moves": "odometry_frames_per_s",
                               "workloads": ["pwclonet-odometry-seq8"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = tiny_cell("pwclonet-odometry-seq8", path, tmp_path / "benchmark")
    assert "calls_in_window.odometry" in {m["name"] for m in cell.per_layer}
    result = runner.run_cell(cell, SEED, 0.5, True, torch.device("cpu"), 0.0)
    assert result["correct"]
    assert result["metrics"]["calls_in_window.odometry"]["value"] == result["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
