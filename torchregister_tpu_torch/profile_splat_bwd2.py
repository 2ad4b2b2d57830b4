"""Time the NMI splat (``csrc/splat.cu``) and K1's second order
(``csrc/sweep.cu:sweep_bwd2``) across builds, and the paths that run them
across checkouts, in turns on one card:

    python -m torchregister_tpu_torch.profile_splat_bwd2
        [--splat-source NAME=PATH ...] [--sweep-source NAME=PATH ...]
        [--root NAME=DIR ...] [--no-paths] [--out FILE]

Kernels. The splat's builds are this checkout's file (``tree``) and each
``--splat-source``, ``sweep_bwd2``'s this checkout's file and each
``--sweep-source``: another checkout's (unpacked with ``git archive``), or a
copy with a line changed; its entry points must take this file's
arguments. A build whose name starts with ``probe`` (a
copy with a part of the work taken out, to see what that part costs) is timed
without the checks below. Each build's full ``ptxas`` report goes into
``--out``. Every build is called through the same
``ctypes`` path on outputs allocated beforehand (``device_ab``), so only the
device code differs. Cases: the splat on the default NMI's samples at 240³
(make_pair's moving image and a constant image, each resized to 200³ and cut
into 8 patches of 100³: 8 rows of 1 M samples), unsigned and signed (weights
``f - 0.5``); ``sweep_bwd2`` at each shape the LM paths launch it
(``LM_BWD2``), one call the three passes of a rigid transform's table. Each
build's splat lies within each bin's ``2 n u`` of its mass of the plain
version and this build's equals ``splat_ordered`` to the bit; each build's
``sweep_bwd2`` lies within ``TOL`` of ``sweep_bwd2_plain`` (gbar, sbar) and
1e-4 (the row's gradient); else this raises. For each case and build ``ms``
(CUDA events over 20 calls, host included) and ``device_ms``
(``torch.profiler``'s spans of the kernels), two readings each (builds in
order, then reversed), the bound and the share of it.

Paths. ``make_cascade_fn`` with the default criteria (``criterions=None``,
the binned branch: the splat twice a matrix step) and with the LM recipe
(``LM_RECIPE``: ``sweep_bwd2`` in every matrix step), on make_pair's pair,
each in a process of its own for this checkout (``tree``) and for each
``--root`` (another checkout's root, whose package that process imports), in
turns (tree, roots, then reversed): the walls of ``CALLS`` calls after the
capturing one, one more call's matrix levels (ms, steps, ms a step) and a
checksum of the warped image.

Prints a JSON line per build, per case and per path run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import device_ab as ab
from . import native
from .losses.nmi import _splat_weights
from .ops.cuda import splat as ks
from .ops.cuda import sweep as k1
from .ops.resize import nearest_resize
from .ops.separable import affine_to_index_map, factor_passes
from .ops.transforms import rigid_theta
from .synthetic import RECIPE, make_pair

SIZE = 240
HBM_BYTES_PER_S = 3.35e12
# K1's second order at the LM paths' shapes: (edge, window, dtype); the
# recipe's matrix levels (60³ and 120³, bf16, windows 11 and 6; 120³ also
# in f32), 240³ at the fine level's window, and Register's 240³ at its window
# S/4
LM_BWD2 = ((60, 11, torch.bfloat16), (120, 6, torch.float32), (120, 6, torch.bfloat16),
           (240, 8, torch.float32), (240, 8, torch.bfloat16), (240, 60, torch.float32))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# the LM recipe: benchmarks/tune_lm.py's "lm 24/16 pat3" matrix stages and the
# recipe's moment init
LM_RECIPE = {**RECIPE, "matrix_optimizer": "lm", "rigid_epochs": 24, "affine_epochs": 16,
             "matrix_patience": 3, "matrix_stop_rel": 1e-3}
CALLS = 3


def label(S: int, K: int, dtype) -> str:
    return f"{S}^3 K={K} {str(dtype).replace('torch.', '')}"


def splat_inputs(device="cuda") -> dict:
    """``{case: (idx, f)}``: the splat's inputs as the default NMI term makes
    them at 240³ (each image resized to 200³, 8 patches of 100³: 8 rows of
    1 M samples, not a whole number of the kernel's blocks) on the joint
    range of make_pair's pair: its moving image, and a constant image at a
    fractional bin (every sample in one bin)."""
    moving, target = make_pair((SIZE,) * 3, device=device)
    lo = torch.minimum(moving.min(), target.min())
    hi = torch.maximum(moving.max(), target.max())
    return {case: _splat_weights(nearest_resize(img, (200,) * 3).reshape(8, -1), hi, lo)
            for case, img in (("make_pair", moving),
                              ("constant", torch.full_like(moving, 0.37)))}


def splat_bound(f: torch.Tensor) -> dict:
    """idx and f read once, H written once (its two adds a sample take far
    less at 67 TFLOP/s)."""
    return {"bound_ms": 1e3 * 4.0 * (2 * f.numel() + f.shape[0] * ks.BINS) / HBM_BYTES_PER_S,
            "bound_by": "bytes"}


def splat_within_bound(out, ref, idx, w, signed: bool) -> bool:
    """Each bin within 2 n u of its mass (n its terms, u = 2^-24): the bound
    of two orders of f32 additions of the same terms."""
    i, w64 = idx.long(), w.double()
    zero = torch.zeros(out.shape, dtype=torch.float64, device=out.device)
    one = torch.ones_like(w64)
    n = zero.scatter_add(1, i, one).scatter_add(1, i + 1, one)
    first = w64.abs() if signed else 1.0 - w64
    mass = zero.scatter_add(1, i, first).scatter_add(1, i + 1, w64.abs())
    return bool(((out.double() - ref.double()).abs() <= 2.0 * n * 2.0**-24 * mass).all())


def bwd2_case(S, K, dtype, pairs, seed, device="cuda"):
    """Inputs of K1's second order on ``pairs`` images of S³ (``pairs`` 0:
    one image, one table): image, g and ubar in ``dtype``, the separable
    passes of rigid transforms drawn from ``seed`` (a table, or one a pair),
    rbar f32 shaped like the table."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = max(pairs, 1)
    shape = (n, 1) + (S,) * 3
    src, g, ubar = (torch.randn(shape, generator=gen, device=device).to(dtype)
                    for _ in range(3))
    params = 0.1 * (2.0 * torch.rand((n, 6), generator=gen, device=device) - 1.0)
    theta = rigid_theta(params)
    passes = factor_passes(*affine_to_index_map(theta if pairs else theta[0], (S,) * 3))
    table, axes = k1.pass_table(passes)
    rbar = torch.randn(table.shape, generator=gen, device=device)
    return src, g, ubar, table.contiguous(), rbar, axes


def bwd2_bound(S: int, dtype) -> dict:
    """g, ubar and src read once, gbar and sbar written once (its ~20
    operations a voxel take far less at 67 TFLOP/s)."""
    nbytes = 5.0 * torch.tensor([], dtype=dtype).element_size() * float(S) ** 3
    return {"bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}


def splat_launcher(fns: dict, idx, f, signed: bool):
    """One launch of a build's ``splat`` into outputs allocated here:
    ``(call, out, tensors)``, ``tensors`` every tensor whose address the
    call holds."""
    N, L = f.shape
    nblk = -(-L // ks.CHUNK)
    part, out = f.new_empty((N, nblk, ks.BINS)), f.new_empty((N, ks.BINS))
    stream = torch._C._cuda_getCurrentRawStream(f.get_device())
    args = (idx.data_ptr(), f.data_ptr(), part.data_ptr(), out.data_ptr(), N, L, nblk,
            int(signed), stream)
    fn = fns["splat"]

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"splat launch failed: cudaError {rc}")
    return call, out, (idx, f, part, out)


def bwd2_launcher(fns: dict, case):
    """The three passes of one ``sweep_bwd2`` case through a build, into
    outputs allocated here: ``(call, outs, tensors)`` with ``outs`` each
    pass's ``(gbar, sbar, drow)``."""
    src, g, ubar, table, rbar, axes, K = case
    stream = torch._C._cuda_getCurrentRawStream(src.get_device())
    launches, outs, tensors = [], [], [src, g, ubar, table, rbar]
    for p, axis in enumerate(axes):
        outer, L, inner, Z, Y, X, vaxis = k1._image(src.shape, axis)
        work = torch.zeros(fns["sweep_bwd_work"](outer, L, inner, K, 1), device=src.device)
        gbar, sbar, dtable = torch.empty_like(g), torch.empty_like(src), torch.zeros_like(table)
        args = (g.data_ptr(), src.data_ptr(), k1._row(table, p), ubar.data_ptr(),
                k1._row(rbar, p), gbar.data_ptr(), sbar.data_ptr(), work.data_ptr(),
                k1._row(dtable, p), outer, L, inner, K, k1._DTYPES[src.dtype], 3, Z, Y, X,
                vaxis, 1, 0, stream)
        launches.append(args)
        outs.append((gbar, sbar, dtable[p]))
        tensors += [work, gbar, sbar, dtable]
    fn = fns["sweep_bwd2"]

    def call():
        for args in launches:
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"sweep_bwd2 launch failed: cudaError {rc}")
    return call, outs, tensors


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def kernels(splat_sources: dict, sweep_sources: dict) -> dict:
    """The kernel A/B over ``{name: (source, defines)}`` of each file."""
    result = {"builds": {}, "cases": {}}
    built = {}
    for stem, sources, names in (("splat", splat_sources, ("splat_partial",)),
                                 ("sweep", sweep_sources, ("sweep_bwd2",))):
        done = ab.build_all(f"{stem}2", sources)
        entries = ks.LIB.entries if stem == "splat" else {
            n: k1.LIB.entries[n] for n in ("sweep_bwd2", "sweep_bwd_work")}
        built[stem] = {name: ab.bind(lib, entries) for name, (lib, _) in done.items()}
        for name, (_, report) in done.items():
            res = ab.resources(report, names)
            result["builds"][f"{stem} {name}"] = res
            result.setdefault("reports", {})[f"{stem} {name}"] = report
            print(f"[build] {stem} {name}: {json.dumps(res)}", flush=True)
    calls, alive, bounds = {}, [], {}
    splat_order, sweep_order = list(splat_sources), list(sweep_sources)
    with torch.no_grad():
        for case, (idx, f) in splat_inputs().items():
            for signed in (False, True):
                w = f - 0.5 if signed else f
                key = f"splat {case}{' signed' if signed else ''}"
                bounds[key] = splat_bound(f)
                ref = ks.splat_plain(idx, w, signed=signed)
                ordered = ks.splat_ordered(idx, w, signed=signed)
                for name in splat_order:
                    call, out, tensors = splat_launcher(built["splat"][name], idx, w, signed)
                    call()
                    torch.cuda.synchronize()
                    if not (name.startswith("probe") or
                            splat_within_bound(out, ref, idx, w, signed)):
                        raise AssertionError(f"{name}'s splat misses the bound on {key}")
                    if name == "tree" and not torch.equal(out, ordered):
                        raise AssertionError(f"the splat differs from splat_ordered on {key}")
                    calls[key, name] = call, "splat_"
                    alive.append(tensors)  # each call's tensors live as long as it
        for S, K, dtype in LM_BWD2:
            key = f"sweep_bwd2 {label(S, K, dtype)}"
            case = (*bwd2_case(S, K, dtype, 0, 9500 + S + K), K)
            src, g, ubar, table, rbar, axes, _ = case
            bounds[key] = {k: 3 * v if k == "bound_ms" else v
                           for k, v in bwd2_bound(S, dtype).items()}
            refs = [k1.sweep_bwd2_plain(g, src, ubar, rbar[p], table[p, :3], table[p, 3],
                                        axis, K) for p, axis in enumerate(axes)]
            for name in sweep_order:
                call, outs, tensors = bwd2_launcher(built["sweep"][name], case)
                call()
                torch.cuda.synchronize()
                for got, ref in zip(outs if not name.startswith("probe") else (), refs):
                    rel = [_rel(got[0], ref[0]), _rel(got[1], ref[1]), _rel(got[2], ref[2])]
                    if not (max(rel[:2]) < TOL[dtype] and rel[2] < 1e-4):
                        raise AssertionError(f"{name}'s sweep_bwd2 at {key}: {rel}")
                calls[key, name] = call, "sweep_bwd2"
                alive.append(tensors)
            del refs
    order = {key: splat_order if key.startswith("splat") else sweep_order for key in bounds}
    for key in bounds:  # each case's builds in turns
        sub = {k: v for k, v in calls.items() if k[0] == key}
        row = ab.in_turns(sub, order[key])[key]
        row.update(bounds[key])
        if key.startswith("sweep_bwd2"):  # a call is the three passes: a launch is a third
            row["launch_device_ms"] = {n: [v / 3 for v in vs if v]
                                       for n, vs in row["device_ms"].items()}
            row["launch_bound_ms"] = row["bound_ms"] / 3
        row["bound_share"] = {n: [row["bound_ms"] / v for v in vs if v]
                              for n, vs in row["device_ms"].items()}
        result["cases"][key] = row
        print(f"[ab] {key}: {json.dumps(row)}", flush=True)
    return result


# One process's cascade (its argv: the recipe's name, calls), run from a
# checkout's root so that it imports that checkout's package; only names that
# the port has had since it took the default criteria into its factory.
CASCADE = r"""
import json, sys, time
from concurrent.futures import ThreadPoolExecutor
import torch
from torchregister_tpu_torch.engines import cascade
from torchregister_tpu_torch.ops.cuda import kde, splat, sweep, warp
from torchregister_tpu_torch.synthetic import RECIPE, make_pair
mods = (sweep, warp, splat, kde)
with ThreadPoolExecutor(len(mods)) as pool:
    list(pool.map(lambda m: m.LIB.build(), mods))
which, calls = sys.argv[1], int(sys.argv[2])
recipes = {"default": {**RECIPE, "criterions": None},
           "lm": {**RECIPE, "matrix_optimizer": "lm", "rigid_epochs": 24, "affine_epochs": 16,
                  "matrix_patience": 3, "matrix_stop_rel": 1e-3}}
fn = cascade.make_cascade_fn(**recipes[which])
m, t = make_pair(device="cuda")
def wall():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(m, t)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res
first, res = wall()
walls = [wall()[0] for _ in range(calls)]
levels, orig = [], cascade._matrix_level
def timed(base, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = orig(base, *args)
    torch.cuda.synchronize()
    levels.append([args[-1].split("_")[0], base.shape[-1], 1e3 * (time.perf_counter() - t0),
                   out.steps[0]])
    return out
cascade._matrix_level = timed
fn(m, t)
cascade._matrix_level = orig
ms, steps = sum(r[2] for r in levels), sum(r[3] for r in levels)
print("CASCADE " + json.dumps({
    "capturing_call_s": first, "walls_s": walls, "steps": res.steps,
    "levels": [r + [r[2] / max(r[3], 1)] for r in levels],
    "matrix_ms_a_step": ms / max(steps, 1),
    "warped_sum": float(res.warped.double().sum())}))
"""


def paths(roots: dict) -> dict:
    """Each recipe's cascade for each ``{name: root}``, in turns."""
    order = list(roots)
    runs = {which: {name: [] for name in order} for which in ("default", "lm")}
    for which in runs:
        for name in order + order[::-1]:
            proc = subprocess.run([sys.executable, "-c", CASCADE, which, str(CALLS)],
                                  cwd=roots[name], capture_output=True, text=True)
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("CASCADE ")),
                        None)
            if proc.returncode != 0 or line is None:
                raise RuntimeError(f"the {which} cascade of {name} failed ({proc.returncode}):"
                                   f"\n{proc.stderr[-4000:]}")
            row = json.loads(line[len("CASCADE "):])
            runs[which][name].append(row)
            print(f"[path] {which} {name}: {json.dumps(row)}", flush=True)
    return runs


def _named(specs) -> dict:
    return {name: (Path(path), ()) for name, path in (s.split("=", 1) for s in specs)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splat-source", action="append", default=[], metavar="NAME=PATH",
                    help="another splat.cu to build and time beside this one's")
    ap.add_argument("--sweep-source", action="append", default=[], metavar="NAME=PATH",
                    help="another sweep.cu whose sweep_bwd2 runs beside this one's")
    ap.add_argument("--root", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout whose cascades run beside this one's")
    ap.add_argument("--no-paths", action="store_true", help="time the kernels only")
    ap.add_argument("--out", help="write every reading to this JSON file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_splat_bwd2 measures the card: no CUDA device")
    splat_sources = {"tree": (ks.SOURCE, ()), **_named(a.splat_source)}
    sweep_sources = {"tree": (k1.SOURCE, ()), **_named(a.sweep_source)}
    result = {"device": torch.cuda.get_device_name(0), **kernels(splat_sources, sweep_sources)}
    if not a.no_paths:
        roots = {"tree": str(native.PKG.parent)}
        roots.update(spec.split("=", 1) for spec in a.root)
        result["paths"] = paths(roots)
    if a.out:
        Path(a.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
