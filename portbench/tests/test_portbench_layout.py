"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and what the benchmark's modules import."""

import ast
import json
import pathlib
import re

import pytest

from portbench import inputs
from portbench.run import ROOT, benchmark, cell_metrics, load_module

BENCH = benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32 and all(map(line, BENCH["command"]))
    assert len(json.dumps(BENCH)) < 64 * 1024
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(WORKLOADS)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    all_names = [m["name"] for m in metrics] + WORKLOADS + names
    assert len(all_names) == len(set(all_names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files_by_name(workload):
    wl = next(w for w in BENCH["workloads"] if w["name"] == workload)
    cfg = inputs.read_json("configs", wl["config"])
    assert (ROOT / cfg["scene"]).is_file()
    mix = inputs.read_json("mixes", wl["traffic"])
    assert callable(load_module(ROOT / "loops" / f"{mix['loop']}.py").run)
    limits = inputs.read_json("checks", workload)
    assert limits and all(v > 0 for v in limits.values())
    e2e = cell_metrics(BENCH, workload, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layers = cell_metrics(BENCH, workload, "per_layer")
    assert layers
    for m in layers:
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py")
        assert reader.read({"kind": "none"}) is None


def test_config_files_are_their_entries():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = inputs.read_json("configs", c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "cutrace_tpu"}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "json", "math", "os",
                        "numpy", "torch", "portbench"}, path
        assert all(m.startswith("portbench.reference")
                   for m in _imports(path) if m.startswith("portbench"))
