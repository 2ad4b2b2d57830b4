"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 -m portbench.calibrate --workload field240.pairs --seeds 1-12 --control-seeds 3

Each seed makes the pool that a run of the cell with that ``--seed``
registers. In one process each pool is registered once, pair by pair,
through the program as the configuration states it, and every gap of
``portbench/check.py`` is printed a pair (the loss gaps one a step, up to
``check.STEPS``): the lower readings. For the first ``--control-seeds``
seeds it also prints the control's: the program with its own
lower-precision path switched on (the configuration's ``control``) and the
reference put in the program's place a precision lower
(``check.control_gaps``). One JSON line a seed and side. The benchmark's
own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, registry
from .generator import make_pool
from .run import _keep, _recipe, make_fn

ALL = ("warp_gap", "rigid_loss_gap", "affine_end_gap", "flow_loss_gap", "flow_end_gap")


def _seeds(text: str) -> list:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def readings(cell: dict, seed: int, recipe: dict, control: bool, device: str, shape=None):
    """Every pool pair of ``seed`` registered once by the program under
    ``recipe``: ``{"program": [each pair's gaps], "reference_low": [...]
    (with ``control``), "wall_s": [...], "steps": [...]}``, the gaps
    against the configuration's recipe."""
    config, traffic = cell["config_data"], cell["traffic_data"]
    shape = tuple(shape or config["shape"])
    pool = make_pool(seed, shape, traffic["deformable"], traffic["rigid"], traffic["max_disp"],
                     device)
    fn = make_fn(recipe, {"batch": 1})
    stated = _recipe(config)
    out = {"program": [], "wall_s": [], "steps": []}
    if control:
        out["reference_low"] = []
    for pair in pool:
        t0 = time.perf_counter()
        kept = _keep(fn(pair.moving, pair.target), 0, 1)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        out["wall_s"].append(time.perf_counter() - t0)
        out["steps"].append(kept["steps"])
        out["program"].append(check.gaps(pair, kept, stated, ALL))
        if control:
            out["reference_low"].append(check.control_gaps(pair, kept, stated, ALL))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    cell = registry.cell(args.workload)
    recipe = _recipe(cell["config_data"])
    low = {**recipe, **cell["config_data"]["control"]}
    for k, seed in enumerate(_seeds(args.seeds)):
        side = readings(cell, seed, recipe, k < args.control_seeds, "cuda")
        print(json.dumps({"seed": seed, "side": "program", **side}), flush=True)
        if k < args.control_seeds:
            ctl = readings(cell, seed, low, False, "cuda")
            print(json.dumps({"seed": seed, "side": "control", **ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
