"""BENCHMARK.json against the contract's rules, the discovery of what a
cell names, a new cell added as files alone, and what the benchmark's
modules import."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import registry, run

ROOT = registry.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys_and_bounds():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    reported = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        # each cell a metric lists reports the end-to-end metric it moves
        assert set(m.get("workloads", reported[m["moves"]])) <= reported[m["moves"]], m["name"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_discovery(workload):
    """Each cell finds its configuration, its mix and a reader for every
    metric it reports, and reports setup_s, another end-to-end metric and a
    per-layer one."""
    cell = registry.cell(workload)
    assert cell["config_data"]["recipe"] and cell["traffic_data"]["draw"]
    names = [m["name"] for m in cell["end_to_end"] + cell["per_layer"]]
    assert "setup_s" in names and len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for n in names:
        assert callable(registry.reader(n))


def test_a_cell_added_as_files(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell as new
    files and new BENCHMARK.json entries, and the harness runs the cell."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = dict(BENCH)
    cfg = json.loads((ROOT / "portbench/configs/recipe_field_240.json").read_text())
    cfg["name"], cfg["recipe"]["flow_levels"] = "recipe_field_small", 2
    cfg["recipe"]["flow_smooth"] = [0.5, 0.25]
    cfg["checks"]["flow_end_gap_median"]["limit"] = 0.2  # 32^3: a step moves the loss more
    (tmp_path / "portbench/configs/recipe_field_small.json").write_text(json.dumps(cfg))
    mix = {"deformable": 1, "rigid": 0, "max_disp": [2.0, 2.0], "batch": 1,
           "draw": "cycle", "profile_pairs": 1}
    (tmp_path / "portbench/traffic/one.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/calls_made.py").write_text(
        'def read(run):\n    return float(len(run["calls"]))\n')
    bench["configs"] = BENCH["configs"] + [
        {"name": "recipe_field_small", "source": "https://github.com/AgamChopra/TorchRegister",
         "file": "portbench/configs/recipe_field_small.json",
         "reduced": ["flow_levels", "flow_smooth"],
         "why": "a test"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "small.one", "config": "recipe_field_small", "traffic": "one", "chips": 1,
         "why": "a test"}]
    bench["end_to_end"] = [
        {**m, "workloads": m["workloads"] + ["small.one"]}
        if m["name"] == "registrations_per_min" else m for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "calls_made", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "cascade (engines/cascade.py)",
         "moves": "registrations_per_min", "workloads": ["small.one"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell("small.one", root=tmp_path)
    assert [m["name"] for m in cell["per_layer"]] == ["calls_made"]
    assert [m["name"] for m in cell["end_to_end"]] == ["registrations_per_min", "setup_s"]
    record = run.run_cell(cell, 5, 0.0, True, device="cpu", shape=(32, 32, 32))
    out = run.result(cell, record, True, "cpu", root=tmp_path)
    assert out["metrics"]["calls_made"]["value"] == 1.0
    assert out["correct"] is True


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." * node.level + (node.module or ""))
    return out


SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    """No module of the harness imports JAX or the JAX package, compared by
    whole top-level names (``torchregister_tpu_torch`` is another name), or
    reads the JAX package's benchmarks."""
    top = {m.split(".")[0] for m in _imports(path) if not m.startswith(".")}
    assert not top & {"jax", "jaxlib", "flax", "torchregister_tpu", "bench", "benchmarks"}
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((ROOT / "portbench/reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    """The reference imports nothing of the program, nor anything of the
    harness outside ``reference/``."""
    names = _imports(path)
    assert not [m for m in names if m.startswith("..")], names
    top = {m.split(".")[0] for m in names if not m.startswith(".")}
    assert top <= {"__future__", "math", "torch"}, top
