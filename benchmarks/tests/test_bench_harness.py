"""The harness around the runs: no JAX anywhere, a refusal without a card,
pieces found by name (a throwaway cell, configuration and metric added as
files in a temporary root), the traced window's arithmetic, and
BENCHMARK.json against its contract."""

import ast
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

import tiny
from harness.catalog import Catalog, cell_metrics, load_benchmark
from harness.runner import forbidden_loaded, run_cell
from harness.trace import Trace

BENCH = tiny.BENCH
ROOT = tiny.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "carel_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imported_tops(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = set(imported_tops(path))
        assert "carel_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "typing", "torch",
                        "reference"}, (path, tops)


def test_nothing_reads_the_root_bench_files():
    for path in sources():
        text = path.read_text()
        for name in ("BENCH" + "_r", "MULTICHIP" + "_r", "BASELINE" + ".json",
                     "import " + "bench", "from " + "bench "):
            assert name not in text, (path, name)


def test_forbidden_names_are_compared_whole():
    assert forbidden_loaded(["carel_tpu_torch.ops", "torch", "numpy"]) == []
    assert forbidden_loaded(["carel_tpu.ops", "jax.numpy", "flaxy"]) == [
        "carel_tpu", "jax"]


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "zh_train", "--seed", str(2 ** 31 + 5), "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and benchmarks/ has no
    program to measure: the run fails and prints no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.argv = ['run.py']; "
            "sys.path[:0] = ['benchmarks', '.']; "
            "from harness.catalog import Catalog, load_benchmark; "
            "from harness.runner import run_cell; "
            "run_cell('zh_train', 1, 1, False, 'cpu', Catalog(), "
            "load_benchmark(), time.perf_counter())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert "carel_tpu_torch" in p.stderr


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A later change adds a cell, its configuration, traffic and a
    per-layer metric as new files; the harness finds them by name and no
    file of benchmarks/ changes."""
    before = {p: p.read_bytes() for p in BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = tiny.write_root(tmp_path)
    (root / "configs" / "tiny_two.json").write_text(
        json.dumps(dict(tiny.tiny_config(), num_hidden_layers=1)))
    (root / "workloads" / "tiny_two_train.json").write_text(json.dumps(
        {"config": "tiny_two", "traffic": "tiny_pairs", "driver": "train",
         "chips": 1, "why": "a throwaway cell",
         "limits": {"loss": 1e-4, "grad": 1e-4, "change": 1e-4}}))
    (root / "metrics").mkdir()
    (root / "metrics" / "steps_per_unit.train.py").write_text(
        "def read(run):\n    w = run.window\n"
        "    return w.work['steps'] / w.units\n")
    bench = tiny.tiny_bench()
    bench["end_to_end"][0]["workloads"].append("tiny_two_train")
    bench["per_layer"].append(
        {"name": "steps_per_unit.train", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "loop",
         "moves": "train_pairs_per_s", "workloads": ["tiny_two_train"]})
    cat = Catalog([root])
    assert "tiny_two_train" in cat.names("workloads", ".json")
    result, lines = run_cell("tiny_two_train", 3, 0.2, False, "cpu", cat,
                             bench, time.perf_counter())
    assert result["correct"], lines
    run = cat.module("metrics", "steps_per_unit.train")
    assert run.read(type("R", (), {"window": type(
        "W", (), {"work": {"steps": 8.0}, "units": 2})()})) == 4.0
    _, layer = cell_metrics(bench, "tiny_two_train")
    assert [m["name"] for m in layer] == ["steps_per_unit.train"]
    after = {p: p.read_bytes() for p in BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def test_trace_arithmetic():
    kernels = [("a", 10.0, 20.0), ("b", 15.0, 30.0), ("copy_kernel x", 50.0,
                                                      60.0),
               ("a", 95.0, 120.0)]
    spans = [("host_prep", 30.0, 50.0), ("replays_and_fetch", 60.0, 95.0)]
    tr = Trace(kernels, (0.0, 100.0), spans, 1, {"steps": 2.0})
    assert tr.busy_intervals() == [(10.0, 30.0), (50.0, 60.0), (95.0, 100.0)]
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.kernel_us(["copy_kernel"]) == (10.0, 1)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["replays_and_fetch", pytest.approx(35e-6)]
    assert gaps[1] == ["host_prep", pytest.approx(20e-6)]
    assert gaps[2] == ["between units", pytest.approx(10e-6)]
    assert tr.top_ops()[0] == ["a", pytest.approx(35e-6)]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_contract():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmarks"]
    assert b["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    cat = Catalog()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert NAME.match(c["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        f = cat.workload(w["name"])
        assert (f["config"], f["traffic"], f["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        cat.module("drivers", f["driver"])
        mine, layer = cell_metrics(b, w["name"])
        names = {m["name"] for m in mine}
        assert "setup_s" in names and len(names) >= 2 and layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        cat.module("metrics", m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in cell_metrics(b, cell)[0]}
    assert len(json.dumps(b)) < 64 * 1024
