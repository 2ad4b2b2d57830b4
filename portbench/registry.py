"""Finds what a cell names: its configuration, its traffic mix and its
metrics' readers, each a file of its own under ``portbench/``, by the names
in ``BENCHMARK.json``. A new configuration, mix, metric or cell is new files
and new entries; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload ``name`` with its ``config`` and ``traffic`` dicts and
    its end-to-end and per-layer metric entries."""
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
    return {**w, "config_file": cfg_entry["file"],
            "config_data": json.loads((root / cfg_entry["file"]).read_text()),
            "traffic_data": json.loads(
                (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text()),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str, root: Path = ROOT):
    """``read(run) -> float | None`` of ``portbench/metrics/<metric>.py``;
    a quantity split by the end-to-end metric it moves (``<name>.<kind>``)
    shares ``<name>.py`` where it has no file of its own."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
