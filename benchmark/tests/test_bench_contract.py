"""BENCHMARK.json keeps to the benchmark's contract, the harness imports
no JAX and no JAX package, and a run without a card prints no result."""

import ast
import json
import re
import subprocess
import sys

from harness import cells, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    bench = cells.spec()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for kind in (("configs",), ("workloads",), ("end_to_end", "per_layer")):
        names = [e["name"] for group in kind for e in bench[group]]
        assert len(names) == len(set(names))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for w in bench["workloads"]:
        e2e_here = [m["name"] for m in cells.metrics(bench, w["name"], False)]
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        per_layer = cells.metrics(bench, w["name"], True)
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e_here
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in sorted(cells.BENCH.rglob("*.py")):
        for mod in _imports(path):
            if mod.split(".")[0] in runner.FORBIDDEN:
                bad.append((str(path), mod))
    assert not bad


def test_forbidden_names_are_compared_whole():
    assert runner.forbidden_modules(["mcax_torch", "mcax_torch.pipeline",
                                     "jaxtyping", "numpy"]) == []
    assert runner.forbidden_modules(["mcax.pipeline", "jax.numpy", "jaxlib",
                                     "flax.linen"]) == ["flax", "jax",
                                                        "jaxlib", "mcax"]


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, str(cells.BENCH / "run.py"), "--workload",
         "config4.bulk", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=str(cells.ROOT), timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_reference_imports_nothing_of_the_program():
    for path in sorted((cells.BENCH / "reference").glob("*.py")):
        for mod in _imports(path):
            assert not mod.startswith("mcax"), (path, mod)
    for path in sorted((cells.BENCH / "configs").glob("*.json")):
        json.loads(path.read_text())
