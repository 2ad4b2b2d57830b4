"""Time the device code of the probe copies, ``slab_gather`` (P2, P4) and
``slice_transpose`` (P5), across builds of ``csrc/hatgather.cu``, in turns
on one card:

    python -m torchregister_tpu_torch.probes.profile_copies \\
        [--source NAME=PATH ...] [--out FILE]

The builds are this checkout's file, which picks each kernel's block shape
by size, its ablations (``gather_v1``, ``gather_v4``: ``SLAB_GATHER_V``
fixed at 1 or 4 elements a thread; ``transpose_256``, ``_512``, ``_1024``:
``TRANSPOSE_THREADS`` fixed; ``transpose_free``: ``TRANSPOSE_REG_CAP=0``,
the register count left to the compiler) and each ``--source`` file, for
example another checkout's (unpacked with ``git archive``), whose two
entry points must have this file's C interface. Every build is called through the same ``ctypes`` path
on outputs allocated beforehand, so only the device code differs.

Cases: the copies of ``chip_smoke.py``'s ``[times] probe``, at the probes'
sizes (P2's six and P4's five slabs of a [64, 64, 256] volume, P5's four
tiles of a [32, 32, 256] slab) and at the device-bound sizes (1728 slabs
(14, 16) of a 240 x 240 x 256 volume at P3's first origins; 4096 tiles
(14 x 16, CW = 16, 256 lanes) of that volume at ``default_rng(0)``
starts). Each build's output must equal the plain version to the bit, else
this raises. For each case and build: ``ms``, CUDA events over 20
launches (host included), and ``device_ms``, ``torch.profiler``'s kernel
spans, each taken in turns (the builds in order, then reversed: two readings
each);
for each build, each kernel's registers and spill bytes from ``-Xptxas
-v``. Prints a JSON line per build and per case.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import device_ab as ab
from . import checked_index
from . import hatgather as hg

ABLATIONS = {"tree": (), "gather_v1": ("-DSLAB_GATHER_V=1",),
             "gather_v4": ("-DSLAB_GATHER_V=4",),
             **{f"transpose_{n}": (f"-DTRANSPOSE_THREADS={n}",) for n in (256, 512, 1024)},
             "transpose_free": ("-DTRANSPOSE_REG_CAP=0",)}
KERNELS = ("slab_gather", "slice_transpose")
SIZE, BIG_SLABS, BIG_STARTS = 240, 1728, 4096


def resources(report: str) -> dict:
    """``{kernel: "N registers, S bytes spill"}`` for the copies' kernels in
    ptxas's report."""
    return ab.resources(report, KERNELS)


def cases(dev: torch.device) -> dict:
    """``{case: (kernel, args)}``, args as the kernel's ``*_launch`` takes
    them; the index data as ``chip_smoke.py``'s ``_probe_inputs`` makes it."""
    gen = torch.Generator().manual_seed(0)
    vol64 = torch.rand((64, 64, 256), generator=gen).to(dev)
    vol240 = torch.rand((SIZE, SIZE, 256), generator=gen).to(dev)
    slab = torch.rand((32, 32, 256), generator=gen).to(dev)
    p2 = [[3, 5], [11, 0], [0, 23], [9, 9], [64 - 14, 64 - 16], [17, 31]]
    p4 = [[3, 5], [11, 0], [0, 23], [9, 9], [64 - 16, 64 - 16]]
    p5 = [[0, 0, 3], [9, 13, 240 - 16], [18, 16, 0], [18, 16, 240]]
    rng = np.random.default_rng(0)
    big = np.stack([rng.integers(0, SIZE - 14 + 1, BIG_STARTS),
                    rng.integers(0, SIZE - 16 + 1, BIG_STARTS),
                    rng.integers(0, 256 - 16 + 1, BIG_STARTS)], axis=-1)

    def orgs(o, B, vol):
        return checked_index(o, (0, 1), (vol.shape[0] - B[0], vol.shape[1] - B[1]), "orgs", dev)

    def starts(s, vol):
        return checked_index(s, (0, 1, 2), (vol.shape[0] - 14, vol.shape[1] - 16,
                                            vol.shape[2] - 16), "starts", dev)

    return {"slab_gather": ("slab_gather", (vol64, orgs(p2, (14, 16), vol64), 14, 16)),
            "slab_gather_p4": ("slab_gather", (vol64, orgs(p4, (16, 16), vol64), 16, 16)),
            "slice_transpose": ("slice_transpose", (slab, starts(p5, slab), 14, 16, 16, 256)),
            "slab_gather_big": ("slab_gather", (vol240, orgs(hg.p3_origins(SIZE, BIG_SLABS),
                                                             (14, 16), vol240), 14, 16)),
            "slice_transpose_big": ("slice_transpose",
                                    (vol240, starts(big, vol240), 14, 16, 16, 256))}


def launcher(fn, kernel: str, args):
    """One launch of a build's entry ``fn`` on ``args`` into an output
    allocated here, on the current stream: ``(call, out)``."""
    src, idx, Bz, By, *rest = args
    T, (_, Y, X) = idx.shape[0], src.shape
    if kernel == "slab_gather":
        out = src.new_empty((T, Bz, By, X))
        ints = (T, Y, X, Bz, By)
    else:
        CW, lanes = rest
        out = src.new_empty((T, CW, lanes))
        ints = (T, Y, X, Bz, By, CW, lanes)
    ptrs = (src.data_ptr(), idx.data_ptr(), out.data_ptr())

    def call():
        rc = fn(*ptrs, *ints, torch._C._cuda_getCurrentRawStream(src.get_device()))
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
    return call, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another hatgather.cu to build and time beside this one's")
    ap.add_argument("--out", help="write every reading to this JSON file")
    a = ap.parse_args(argv)
    builds = {name: (hg.SOURCE, d) for name, d in ABLATIONS.items()}
    for spec in a.source:
        name, path = spec.split("=", 1)
        builds[name] = (Path(path), ())
    done = ab.build_all("hatgather", builds)
    result = {"device": torch.cuda.get_device_name(0), "builds": {}, "cases": {}}
    for name, (lib, report) in done.items():
        result["builds"][name] = resources(report)
        print(f"[build] {name}: {json.dumps(result['builds'][name])}", flush=True)
    dev = torch.device("cuda")
    entries = {k: hg.LIB.entries[k] for k in KERNELS}
    fns = {name: ab.bind(lib, entries) for name, (lib, _) in done.items()}
    order, calls, outs = list(builds), {}, []
    for case, (kernel, args) in cases(dev).items():
        plain = (hg.slab_gather_plain if kernel == "slab_gather"
                 else hg.slice_transpose_plain)(*args)
        for name in order:
            call, out = launcher(fns[name][kernel], kernel, args)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise AssertionError(f"{name}'s {kernel} differs from its plain version "
                                     f"at {case}")
            calls[case, name] = call, f"{kernel}_kernel"
            outs.append(out)  # each output lives as long as its call
    rows = ab.in_turns(calls, order)
    for case, row in rows.items():
        result["cases"][case] = row
        print(f"[ab] {case}: {json.dumps(row)}", flush=True)
    if a.out:
        Path(a.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
