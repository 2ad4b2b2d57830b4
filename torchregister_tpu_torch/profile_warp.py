"""Time K2's device code (``csrc/warp.cu``, both modes) across builds, in
turns on one card:

    python -m torchregister_tpu_torch.profile_warp [--source NAME=PATH ...] [--out FILE]

The builds are this checkout's file (``tree``), its ablations, each a copy
of the file with one constant's line changed (``ABLATIONS``; ``part1``:
``kStageAffine = false``, no block stages its box: the tiles and their index
arithmetic alone; ``tile_8x8x32``, ``tile_8x16x32``: the affine mode's other
tile shapes, each with the box its extents need; ``flow_16x16x16``: the flow
mode on the affine mode's tile), and each ``--source`` file, for example
another checkout's (unpacked with ``git archive``); a file whose entry
points take no ``staged`` counter (the kernel before the tiles) is called
without one. Every build is called
through the same ``ctypes`` path on outputs allocated beforehand
(``device_ab``), so only the device code differs.

Cases, 240³ f32 unless named: affine with the JAX bench selftest's rigid
theta, with ``make_pair``'s true rigid transform (the main path's), with a
90° rotation about z and a zoom by 2 (the direct route); flow, a smooth
field with |flow| <= 8, and an outward zoom by 1.25 plus that field
(samples past every face); a 240² image; C = 3. Each build's output must
equal ``warp_plain`` to the bit, else this raises. For each case and build:
``ms`` (CUDA events over 20 launches, host included) and ``device_ms``
(``torch.profiler``'s kernel spans), two readings each (builds in order,
then reversed); for each case the bound (bytes at 3.35 TB/s) and the tree's
staged-block share (its device counter, which must equal ``tile_boxes``'s
count); for each build the kernel's registers and spill bytes from
``-Xptxas -v``. Prints a JSON line per build and per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
from pathlib import Path

import torch

from . import device_ab as ab
from . import native
from .ops.cuda import warp as k2
from .ops.transforms import rigid_theta
from .warp_cases import (PAIR_RIGID, SELFTEST_THETA, index_map, rot90_zoom2, smooth_flow,
                         zoom_grid)

# each ablation: lines of csrc/warp.cu and what replaces them
ABLATIONS = {
    "part1": {"kStageAffine = true;": "kStageAffine = false;"},
    "tile_8x8x32": {"kTile[3] = {16, 16, 16}, kBox[3] = {24, 24, 24};":
                    "kTile[3] = {8, 8, 32}, kBox[3] = {16, 16, 40};"},
    "tile_8x16x32": {"kTile[3] = {16, 16, 16}, kBox[3] = {24, 24, 24};":
                     "kTile[3] = {8, 16, 32}, kBox[3] = {16, 24, 40};"},
    "flow_16x16x16": {"kFlowTile[3] = {8, 8, 32};": "kFlowTile[3] = {16, 16, 16};"},
}
SIZE = 240
HBM_BYTES_PER_S = 3.35e12


def variant(name: str, text: str) -> str:
    """The source ``text`` with ablation ``name``'s lines replaced; raises if
    a line is not found exactly once."""
    for old, new in ABLATIONS[name].items():
        if text.count(old) != 1:
            raise ValueError(f"ablation {name}: {old!r} is not one line of the source")
        text = text.replace(old, new)
    return text


def write_variants() -> dict:
    """``{name: path}``: each ablation of this checkout's ``csrc/warp.cu``
    written beside the builds (``_build/warp_<name>.cu``)."""
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in ABLATIONS:
        paths[name] = native.BUILD_DIR / f"warp_{name}.cu"
        paths[name].write_text(variant(name, k2.SOURCE.read_text()))
    return paths


def cases(dev: torch.device, S: int = SIZE) -> dict:
    """``{case: (mode, src [C, Z, Y, X], mt or flow)}`` in the kernel's view."""
    gen = torch.Generator(device=dev).manual_seed(11)
    vol = torch.rand((1, S, S, S), generator=gen, device=dev)
    flow = smooth_flow(S, 8.0, 6, dev)

    def rigid(params, spatial):
        return index_map(rigid_theta(torch.tensor(params, device=dev))[None], spatial)

    return {
        "affine_selftest": ("affine", vol, rigid(SELFTEST_THETA, (S,) * 3)),
        "affine_pair": ("affine", vol, rigid(PAIR_RIGID, (S,) * 3)),
        "affine_rot90_zoom2": ("affine", vol, index_map(rot90_zoom2().to(dev), (S,) * 3)),
        "flow_smooth": ("flow", vol, flow),
        "flow_past_faces": ("flow", vol, (zoom_grid(S, dev) + flow).contiguous()),
        "affine_2d": ("affine", torch.rand((1, 1, S, S), generator=gen, device=dev),
                      rigid((0.3, 0.1, -0.2), (S, S))),
        "affine_c3": ("affine", torch.rand((3, S, S, S), generator=gen, device=dev),
                      rigid(SELFTEST_THETA, (S,) * 3)),
    }


def bound_ms(mode: str, src: torch.Tensor) -> float:
    """Each input read once and the output written once at 3.35 TB/s."""
    C, vox = src.shape[0], math.prod(src.shape[1:])
    planes = 2 * C + (3 if mode == "flow" else 0)
    return 1e3 * 4.0 * planes * vox / HBM_BYTES_PER_S


def takes_counter(source: Path) -> bool:
    return "void* staged" in source.read_text()


def launcher(fn, mode: str, src, aux, counter):
    """One launch of a build's entry ``fn`` into an output allocated here:
    ``(call, out)``."""
    C, Z, Y, X = src.shape
    out = torch.empty_like(src)
    args = (src.data_ptr(), out.data_ptr(), aux.data_ptr(), C, Z, Y, X,
            *(() if counter is None else (counter.data_ptr(),)))

    def call():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(src.get_device()))
        if rc != 0:
            raise RuntimeError(f"warp_{mode} launch failed: cudaError {rc}")
    return call, out


def entries(with_counter: bool) -> dict:
    if with_counter:
        return k2.LIB.entries
    _P, _I = ctypes.c_void_p, ctypes.c_int
    return {name: (_I, [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P])
            for name in k2.LIB.entries}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another warp.cu to build and time beside this one's")
    ap.add_argument("--out", help="write every reading to this JSON file")
    a = ap.parse_args(argv)
    builds = {"tree": (k2.SOURCE, ())}
    builds.update({name: (path, ()) for name, path in write_variants().items()})
    for spec in a.source:
        name, path = spec.split("=", 1)
        builds[name] = (Path(path), ())
    done = ab.build_all("warp", builds)
    result = {"device": torch.cuda.get_device_name(0), "builds": {}, "cases": {}}
    for name, (lib, report) in done.items():
        result["builds"][name] = ab.resources(report, ("warp",))
        print(f"[build] {name}: {json.dumps(result['builds'][name])}", flush=True)
    dev = torch.device("cuda")
    counted = {name: takes_counter(builds[name][0]) for name in builds}
    fns = {name: ab.bind(lib, entries(counted[name])) for name, (lib, _) in done.items()}
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    order, calls, outs, shares, bounds = list(builds), {}, [], {}, {}
    inputs = cases(dev)  # alive until the timing: the calls hold its addresses
    for case, (mode, src, aux) in inputs.items():
        bounds[case] = bound_ms(mode, src)
        plain = k2.warp_plain(src, **{"mt" if mode == "affine" else "flow": aux})
        boxes = k2.tile_boxes(src.shape, **{"mt" if mode == "affine" else "flow": aux})
        for name in order:
            call, out = launcher(fns[name][f"warp_{mode}"], mode, src, aux,
                                 counter if counted[name] else None)
            counter.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise AssertionError(f"{name}'s warp_{mode} differs from warp_plain at {case}")
            if name == "tree":
                staged, tiles = int(counter.item()), boxes["staged"].numel()
                if staged != int(boxes["staged"].sum()):
                    raise AssertionError(f"{case}: {staged} staged blocks on the card, "
                                         f"tile_boxes says {int(boxes['staged'].sum())}")
                shares[case] = staged / tiles
            calls[case, name] = call, "warp_kernel"
            outs.append(out)  # each output lives as long as its call
    for case, row in ab.in_turns(calls, order).items():
        row.update(bound_ms=bounds[case], staged_share=shares[case])
        result["cases"][case] = row
        print(f"[ab] {case}: {json.dumps(row)}", flush=True)
    if a.out:
        Path(a.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
