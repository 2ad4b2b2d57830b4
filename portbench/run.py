"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration (``portbench/configs``:
``make_cascade_fn``'s recipe and the volume shape) and a traffic mix
(``portbench/traffic``: the pool of pairs, how calls draw from it, pairs a
call, an optional mesh). Set-up makes the mix's pool of pairs on the card
from ``--seed`` (every seed the same set of displacements, so the same work
in another draw; the seed also orders the calls and draws the batches) and
makes one warm call, which builds the kernels (into the checkout) and
captures every level's step graph. The window then drives the program in a
closed loop, one client: each call is submitted when the last one has
returned and the card has synchronized, until ``--seconds`` have passed.
With ``--trace 1`` the first calls, covering ``profile_pairs``
registrations, run under ``torch.profiler`` (the stretch) and the result
carries the per-layer metrics instead of the end-to-end ones. After the
window the kept first result of each distinct pair is compared
with the plain reference (``portbench/check.py``).

The last line of standard output is the result, JSON; the numbers compared
and their limits are the last lines of standard error and the result's last
key. Exits non-zero, printing no result, without enough CUDA devices or if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / ".portbench_cache" / _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, registry  # noqa: E402
from .generator import make_pool  # noqa: E402
from .trace import STRETCH, reduce  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "torchregister_tpu")


def plan(traffic: dict, pool: int, seed: int):
    """The pool indices of each call: ``cycle`` takes consecutive chunks of
    one seeded permutation of the pool, cycled; ``sample`` draws each call's
    pairs afresh, without replacement within the call."""
    rng = np.random.default_rng([seed, 1])
    b = traffic.get("batch", 1)
    if traffic["draw"] == "cycle":
        order = [int(i) for i in rng.permutation(pool)]
        k = 0
        while True:
            yield [order[(k + j) % pool] for j in range(b)]
            k += b
    elif traffic["draw"] == "sample":
        while True:
            yield [int(i) for i in rng.choice(pool, b, replace=False)]
    else:
        raise ValueError(f"unknown draw {traffic['draw']!r}")


def _steps(res, b: int) -> list:
    """Each pair's executed steps ``{stage/levelI: n}`` of a result."""
    out = []
    for p in range(b):
        per = {}
        for stage, levels in (res.steps or {}).items():
            for i, n in enumerate(levels if b == 1 else levels[p]):
                per[f"{stage}/level{i}"] = int(n)
        out.append(per)
    return out


def _keep(res, p: int, b: int) -> dict:
    """Pair ``p``'s result of a call of ``b`` pairs, copied: what the check
    reads."""
    pick = (lambda x: x[p]) if b > 1 else (lambda x: x)
    row = (lambda x: x[p]) if b > 1 else (lambda x: x.reshape(-1))
    return {"theta": pick(res.theta)[0].clone(), "flow": pick(res.flow).clone(),
            "warped": pick(res.warped).clone(),
            "rigid": row(res.rigid_losses)[:check.STEPS].clone(),
            "affine": row(res.affine_losses).clone(), "flow_losses": row(res.flow_losses).clone(),
            "steps": _steps(res, b)[p]}


def _replays(graphs) -> dict:
    """``{level: replays}`` summed over a factory's step graphs (one set,
    or one a device)."""
    sets = graphs.values() if isinstance(graphs, dict) else [graphs]
    out: dict = {}
    for g in sets:
        for level, (_, n) in g.counts().items():
            out[level] = out.get(level, 0) + n
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def make_fn(recipe: dict, traffic: dict):
    """The program under test: ``make_cascade_fn`` for single pairs,
    ``make_cascade_batch_fn`` (over a ``data`` mesh if the mix names one)
    for batches."""
    from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn, make_cascade_fn

    if traffic.get("batch", 1) == 1:
        return make_cascade_fn(**recipe)
    if traffic.get("mesh"):
        from torchregister_tpu_torch.parallel.mesh import make_mesh

        return make_cascade_batch_fn(mesh=make_mesh(tuple(traffic["mesh"])), **recipe)
    return make_cascade_batch_fn(**recipe)


def _recipe(config: dict) -> dict:
    """The recipe as ``make_cascade_fn`` takes it: lists as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["recipe"].items()}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             shape=None, recipe=None) -> dict:
    """One run of ``cell`` (``registry.cell``): set-up, window, check.
    ``shape`` and ``recipe`` replace the configuration's (the CPU tests'
    small runs and the control). Returns the run's record."""
    config, traffic = cell["config_data"], cell["traffic_data"]
    shape = tuple(shape or config["shape"])
    recipe = recipe or _recipe(config)
    pool = make_pool(seed, shape, traffic["deformable"], traffic["rigid"], traffic["max_disp"],
                     device)
    b = traffic.get("batch", 1)
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn = make_fn(recipe, traffic)
    calls = plan(traffic, len(pool), seed)

    def inputs(idx):
        if b == 1:
            return pool[idx[0]].moving, pool[idx[0]].target
        return (torch.cat([pool[i].moving for i in idx]),
                torch.cat([pool[i].target for i in idx]))

    fn(*inputs(next(plan(traffic, len(pool), seed))))  # builds, captures
    sync()
    setup_s = time.perf_counter() - _T0

    record = {"setup_s": setup_s, "calls": [], "pairs_per_call": b, "shape": shape,
              "pairs_per_replay": b // math.prod(traffic.get("mesh") or [1]),
              "recipe": recipe, "stretch": None}
    kept: dict = {}
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()  # its start-up is not the window's
    before = _replays(fn.graphs)
    stretch = None

    def close_stretch():
        stretch.__exit__(None, None, None)
        sync()
        prof.stop()
        done = record["calls"]
        record["stretch"] = {"calls": len(done), "steps": _sum_steps(done),
                             "replays": _delta(_replays(fn.graphs), before)}

    t_start = time.perf_counter()
    deadline = t_start + seconds
    if prof is not None:
        stretch = torch.profiler.record_function(STRETCH)
        stretch.__enter__()
    while True:
        idx = next(calls)
        m, t = inputs(idx)
        t0 = time.perf_counter()
        res = fn(m, t)
        sync()
        t1 = time.perf_counter()
        record["calls"].append({"pairs": idx, "latency_s": t1 - t0, "steps": _steps(res, b)})
        for p, i in enumerate(idx):
            if i not in kept:
                kept[i] = _keep(res, p, b)
        del res
        registered = sum(len(c["pairs"]) for c in record["calls"])
        if stretch is not None and (registered >= traffic["profile_pairs"] or t1 >= deadline):
            close_stretch()
            stretch = None
        if t1 >= deadline:
            break
    record["window_s"] = time.perf_counter() - t_start
    record["replays"] = _delta(_replays(fn.graphs), before)
    record["registrations"] = sum(len(c["pairs"]) for c in record["calls"])
    record["memory_peak_bytes"] = max(
        (torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())),
        default=0) if cuda else 0
    del fn
    _free_program()
    if prof is not None and record["stretch"] is not None:
        record["stretch"]["trace"] = reduce(prof.profiler.kineto_results.events())
        del prof
    per_pair = [check.readings(pool[i], k, _recipe(config), config["checks"])
                for i, k in sorted(kept.items())]
    record["correct"], record["checks"] = check.judge(per_pair, config["checks"])
    return record


def _sum_steps(calls) -> dict:
    out: dict = {}
    for c in calls:
        for per in c["steps"]:
            for level, n in per.items():
                out[level] = out.get(level, 0) + n
    return out


def _free_program() -> None:
    """Drop the factories' cached programs (their graphs and memory pools)."""
    from torchregister_tpu_torch.engines import cascade

    for cache in (cascade._CASCADE_CACHE, cascade._BATCH_CACHE):
        cache.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def result(cell: dict, record: dict, trace: bool, device: str,
           root: Path = registry.ROOT) -> dict:
    """The result line of a run (the metrics' readers from ``root``)."""
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in entries:
        value = registry.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": bool(record["correct"]), "attempted": record["registrations"],
           "failed": 0, "metrics": metrics, "device": dev}
    tr = (record.get("stretch") or {}).get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = record["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    record = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    out = result(cell, record, bool(args.trace), "cuda")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
