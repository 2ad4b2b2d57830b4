"""Time the exact KDE's kernels (``csrc/kde.cu``) across builds, and the
exact-branch cascade across checkouts, in turns on one card:

    python -m torchregister_tpu_torch.profile_kde [--source NAME=PATH ...]
        [--root NAME=DIR ...] [--out FILE]

Kernels. The builds are this checkout's file (``tree``), its ablations
(``ABLATIONS``: ``kde_sum``'s group of 16 points in place of 8, and the
term loops not unrolled, through ``-DKDE_GROUP``, ``-DKDE_UNROLL``) and each ``--source`` file, for example another
checkout's (unpacked with ``git archive``; its entry points must take this
file's arguments). Every build is called through the same ``ctypes`` path on
outputs allocated beforehand (``device_ab``), so only the device code
differs. Cases: ``kde_sum`` (phi) and ``kde_dot`` (phi', a cotangent from a
seed) on the default NMI's joint rows at 240³ (make_pair's pair resized to
200³, 8 patches of 100³ a side: ``[8, 2 M]`` x 256 points, bandwidth 3), the
pair scaled by each of ``SCALES``: 1000 (a CT-like range, 3.2 % of the
terms within the cut) and 360 (a joint range just past 767.25, where the
default NMI turns exact: the exact branch's densest case); each build's
output within 1e-5 of the plain version's largest entry, else this raises.
For each case and build ``ms`` (CUDA events over 20 launches, host
included) and ``device_ms`` (``torch.profiler``'s spans of the kernel's
launches), two readings each (builds in order, then reversed); for each
case the needed and the dense terms and the bounds (:func:`kde_bound`), and
for ``kde_sum`` the device time of this build's second stage alone; for
each build the kernels' registers and spill bytes from ``-Xptxas -v``.

Cascade. ``make_cascade_fn(**RECIPE, criterions=None)`` on make_pair's pair
times 1000 (every NMI call on the exact branch), run in a process of its own
for this checkout (``tree``) and for each ``--root`` (another checkout's
root, whose package that process imports), in turns (tree, roots, then
reversed): the wall of each of ``CALLS`` calls after the capturing one, and
one more call's matrix levels (ms, steps, ms a step), as ``chip_smoke.py``'s
``[cascade-fn-exact]`` reads them.

Prints a JSON line per build, per case and per cascade run.
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
from . import profile_sweep as ps
from .losses.nmi import _sample_points
from .ops.cuda import kde as kk
from .ops.resize import nearest_resize
from .synthetic import make_pair

SCALES = (1000.0, 360.0)
BANDWIDTH = 3.0
BINS = 256
SIZE = 240
ABLATIONS = {"group16": ("-DKDE_GROUP=16",), "unroll1": ("-DKDE_UNROLL=1",)}
CALLS = 3
# the card's rates (H100 SXM at 700 W): memory, f32 outside the tensor cores,
# and the exponentials' unit (SFU): 16 a clock on each of the 132 SMs at the
# 1.98 GHz boost clock (NVIDIA's Hopper tuning guide and data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# f32 operations a term: kde_sum's phi is a difference, a division, two
# products, an exponential, a product and the sum's add (7); kde_dot's phi'
# and its weight g add a product each (9)
KDE_OPS = {"sum": 7, "dot": 9}


def kde_rows(scale: float, device="cuda") -> dict:
    """``{"marginal": s1 [8, 1 M], "joint": [8, 2 M]}``: the rows the
    default NMI's KDE sums at 240³ on make_pair's pair times ``scale``."""
    moving, target = make_pair((SIZE,) * 3, device=device)
    s1, s2 = (nearest_resize(img * scale, (200,) * 3).reshape(8, -1) for img in (moving, target))
    return {"marginal": s1, "joint": torch.cat((s1, s2), 1)}


def kde_bound(kind: str, s: torch.Tensor, xis: torch.Tensor, h: float = BANDWIDTH) -> dict:
    """A kernel's least time on these inputs: its bytes (the rows, the
    points, ``kde_dot``'s cotangent and output, each once) over the memory
    rate, and the terms within the cut (:func:`ops.cuda.kde.kde_terms_needed`)
    as exponentials over the SFU's rate and as f32 operations over 67
    TFLOP/s, whichever is largest; beside it the same bound over every term
    (``dense_bound_ms``, what the kernels before the cut computed)."""
    N, L = s.shape
    P = xis.shape[0]
    needed, dense = kk.kde_terms_needed(s, xis, h), N * L * P
    rows = {"sum": 1, "dot": 2}[kind]  # [N, L] tensors: s; s and the output
    t_bytes = 4.0 * (rows * N * L + P + N * P) / HBM_BYTES_PER_S

    def parts(terms):
        return {"bytes": t_bytes, "fp32": KDE_OPS[kind] * terms / F32_FLOP_PER_S,
                "sfu": terms / SFU_EXP_PER_S}

    t, td = parts(needed), parts(dense)
    top = max(t, key=t.get)
    return {"bound_ms": 1e3 * t[top], "bound_by": "bytes" if top == "bytes" else "operations",
            "fp32_bound_ms": 1e3 * t["fp32"], "sfu_bound_ms": 1e3 * t["sfu"],
            "bytes_bound_ms": 1e3 * t_bytes, "dense_bound_ms": 1e3 * max(td.values()),
            "terms_needed": needed, "terms_dense": dense}


def launcher(fns: dict, kind: str, s, xis, g, flag):
    """One launch of a build's ``kde_sum`` (phi) or ``kde_dot`` (phi') into
    outputs allocated here: ``(call, out, tensors)``, ``tensors`` every
    tensor whose address the call holds (the caller keeps them alive)."""
    N, L = s.shape
    P = xis.shape[0]
    stream = torch._C._cuda_getCurrentRawStream(s.get_device())
    if kind == "sum":
        nblk = -(-L // kk.CHUNK)
        part, out = s.new_empty((N, nblk, P)), s.new_empty((N, P))
        args = (s.data_ptr(), None, xis.data_ptr(), flag.data_ptr(), part.data_ptr(),
                out.data_ptr(), N, L, P, nblk, BANDWIDTH, 0, stream)
    else:
        out = s.new_empty((N, L))
        args = (s.data_ptr(), g.data_ptr(), xis.data_ptr(), flag.data_ptr(), out.data_ptr(), N,
                L, P, BANDWIDTH, 1, stream)
    fn = fns[f"kde_{kind}"]

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"kde_{kind} launch failed: cudaError {rc}")
    return call, out, (s, xis, g, flag, out, *((part,) if kind == "sum" else ()))


def kernels(sources: dict) -> dict:
    """The kernel A/B over ``{name: (source, defines)}``."""
    done = ab.build_all("kde", sources)
    result = {"builds": {}, "cases": {}}
    for name, (_, report) in done.items():
        result["builds"][name] = ab.resources(report, ("kde_sum_partial", "kde_dot_kernel"),
                                              suffix="")
        print(f"[build] {name}: {json.dumps(result['builds'][name])}", flush=True)
    fns = {name: ab.bind(lib, kk.LIB.entries) for name, (lib, _) in done.items()}
    dev = torch.device("cuda")
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    order, calls, alive, bounds = list(sources), {}, [], {}
    with torch.no_grad():
        for scale in SCALES:
            s = kde_rows(scale)["joint"]
            xis = _sample_points(s, BINS)
            g = torch.randn((s.shape[0], BINS), generator=torch.Generator(device=dev)
                            .manual_seed(16), device=dev)
            for kind in ("sum", "dot"):
                case = f"kde_{kind} x{scale:g}"
                bounds[case] = kde_bound(kind, s, xis)
                ref = (kk.kde_sum_plain(s, xis, BANDWIDTH) if kind == "sum"
                       else kk.kde_dot_plain(g, s, xis, BANDWIDTH, 1))
                tol = 1e-5 * float(ref.abs().max())
                for name in order:
                    call, out, tensors = launcher(fns[name], kind, s, xis, g, flag)
                    call()
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    if not err <= tol:
                        raise AssertionError(f"{name}'s kde_{kind} at x{scale:g} is {err} "
                                             f"from the plain version (tol {tol})")
                    calls[case, name] = call, f"kde_{kind}"
                    alive.append(tensors)  # each call's tensors live as long as it
            del ref
    for case, row in ab.in_turns(calls, order).items():
        row.update(bounds[case])
        if case.startswith("kde_sum"):  # this build's stage 2 alone
            row["tree_stage2_device_ms"] = ps.device_ms(calls[case, "tree"][0],
                                                        name="kde_sum_total")
        row["bound_share"] = {n: [row["bound_ms"] / v for v in vs if v]
                              for n, vs in row["device_ms"].items()}
        result["cases"][case] = row
        print(f"[ab] {case}: {json.dumps(row)}", flush=True)
    return result


# One process's exact-branch cascade (its argv: scale, calls), run from a
# checkout's root so that it imports that checkout's package; only names
# that the port has had since it took the default criteria into its factory.
CASCADE = r"""
import importlib, json, sys, time
from concurrent.futures import ThreadPoolExecutor
import torch
from torchregister_tpu_torch.engines import cascade
from torchregister_tpu_torch.ops.cuda import kde, splat, sweep, warp
from torchregister_tpu_torch.synthetic import RECIPE, make_pair
nmi = importlib.import_module("torchregister_tpu_torch.losses.nmi")
mods = (sweep, warp, splat, kde)
with ThreadPoolExecutor(len(mods)) as pool:
    list(pool.map(lambda m: m.LIB.build(), mods))
scale, calls = float(sys.argv[1]), int(sys.argv[2])
fn = cascade.make_cascade_fn(**{**RECIPE, "criterions": None})
m, t = (x * scale for x in make_pair(device="cuda"))
def wall():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(m, t)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res
nmi.branch_calls.reset()
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
    "matrix_ms_a_step": ms / max(steps, 1), "branches": dict(nmi.branch_calls),
    "warped_sum": float(res.warped.double().sum())}))
"""


def cascades(roots: dict, scale: float = 1000.0) -> dict:
    """The exact-branch cascade of each ``{name: root}``, in turns."""
    order = list(roots)
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        proc = subprocess.run([sys.executable, "-c", CASCADE, str(scale), str(CALLS)],
                              cwd=roots[name], capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("CASCADE ")), None)
        if proc.returncode != 0 or line is None:
            raise RuntimeError(f"the cascade of {name} failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        row = json.loads(line[len("CASCADE "):])
        if row["branches"].get("binned") or not row["branches"].get("exact"):
            raise AssertionError(f"{name}'s cascade took the binned branch: {row['branches']}")
        runs[name].append(row)
        print(f"[cascade] {name} x{scale:g}: {json.dumps(row)}", flush=True)
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another kde.cu to build and time beside this one's")
    ap.add_argument("--root", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout whose exact-branch cascade runs beside this one's")
    ap.add_argument("--no-cascade", action="store_true", help="time the kernels only")
    ap.add_argument("--out", help="write every reading to this JSON file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_kde measures the card: no CUDA device")
    sources = {"tree": (kk.SOURCE, ())}
    sources.update({name: (kk.SOURCE, defines) for name, defines in ABLATIONS.items()})
    for spec in a.source:
        name, path = spec.split("=", 1)
        sources[name] = (Path(path), ())
    result = {"device": torch.cuda.get_device_name(0), **kernels(sources)}
    if not a.no_cascade:
        roots = {"tree": str(native.PKG.parent)}
        roots.update(spec.split("=", 1) for spec in a.root)
        result["cascade"] = cascades(roots)
    if a.out:
        Path(a.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
