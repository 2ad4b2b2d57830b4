"""Hold the two-stage sums, ``slab_sum`` (P3, ``csrc/hatgather.cu``) and the
ROI fetch (``csrc/roi_fetch.cu``), to another checkout's one-pass kernels to
the bit, and time their device code in turns on one card:

    python -m torchregister_tpu_torch.probes.profile_sums --parent DIR \\
        [--out FILE]

``DIR`` is the root of a checkout whose two sources still hold the one-pass
kernels (each tile or slab summed straight from the volume; 81242f6 and
earlier), for example one unpacked with ``git archive``. Builds: this
checkout's two files; ``slab_sum``'s ablations (``ABLATIONS``: a thread of
its first stage summing 4, 8 or 16 windows, not 2; no sort of the slabs by
oy); and the parent's two files, each ``nvcc`` run at once; each build
called through its
own C interface (the two-stage kernels take a scratch the one-pass ones do
not) on outputs and scratch allocated beforehand, so only the device code
differs.

Cases, the probes' inputs: P3's 13826 slabs (14, 16) of a 240 x 240 x 256
volume (``p3_origins`` with the last valid origin and (0, 0) appended), the
same slabs ordered by (oy, oz) (``slab_sum_by_oy``: how much stage 2's
rereads of ``W`` depend on the slabs' order), and
the fetch's 13825 tiles of the 240³ volume padded to 256³ (the probe's
theta, the last valid block origin appended). Every build's output must
equal the parent's to the bit, and this checkout's its torch order
(``slab_sum_ordered``, ``roi_fetch_ordered``) to the bit and its plain
version within ``P3_ATOL`` and ``FETCH_ATOL``, else this raises. For each
case and build: ``ms``, CUDA events over 20 launches (host included), and
``device_ms``, ``torch.profiler``'s kernel spans (both stages), each taken
in turns (the builds in order, then reversed: two readings each), then each
stage's device time alone (``stage_device_ms``); each
build's kernels' registers and spill bytes from ``-Xptxas -v``; last, the
floors of ``slab_sum``'s bytes at P3's size (:func:`floors`). Prints a
JSON line per build, per case and for the floors.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import device_ab as ab
from .. import profile_sweep as ps
from . import checked_index
from . import hatgather as hg
from . import roi_stages as rs

SIZE = 240
# slab_sum's ablations: -D defines of csrc/hatgather.cu other than its own
ABLATIONS = {**{f"sum_out_{n}": (f"-DSLAB_SUM_OUT={n}",) for n in (4, 8, 16)},
             "unsorted": ("-DSLAB_SUM_SORT=0",)}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the one-pass kernels' C interface: no scratch
PARENT_ENTRIES = {"slab_sum": (_I, [_P] * 3 + [_I] * 6 + [_P]),
                  "roi_fetch": (_I, [_P] * 3 + [_I] * 3 + [_P])}
# the profiler's name filter: every kernel of a launch
PROFILE_NAME = {"slab_sum": "slab_sum_", "roi_fetch": "roi_fetch_"}
SOURCES = {"slab_sum": ("hatgather", hg.SOURCE), "roi_fetch": ("roi_fetch", rs.SOURCE)}
# the kernels of a launch in ptxas's report: the one pass, the two stages
STAGES = {"slab_sum": ("slab_sum", "slab_sum_rows", "slab_sum_slabs"),
          "roi_fetch": ("roi_fetch", "roi_fetch_blocks", "roi_fetch_tiles")}


def builds(parent: Path) -> dict:
    """``{(kernel, build): (stem, source, defines)}``."""
    csrc = parent / "torchregister_tpu_torch" / "csrc"
    out = {}
    for kernel, (stem, source) in SOURCES.items():
        out[kernel, "tree"] = (stem, source, ())
        out[kernel, "parent"] = (stem, csrc / source.name, ())
    for name, defines in ABLATIONS.items():
        out["slab_sum", name] = ("hatgather", hg.SOURCE, defines)
    return out


def cases(dev: torch.device) -> dict:
    """``{case: args}``, as the two ``*_launch`` take them (``CASE_KERNEL``
    names a case's kernel): P3's slabs in the probe's order and the same
    slabs ordered by (oy, oz), and the fetch's tiles."""
    gen = torch.Generator().manual_seed(0)
    vol = torch.rand((SIZE, SIZE, 256), generator=gen).to(dev)
    T = (SIZE // 10) ** 3
    orgs = np.concatenate([hg.p3_origins(SIZE, T), [[SIZE - 14, SIZE - 16], [0, 0]]])
    by_oy = orgs[np.lexsort((orgs[:, 0], orgs[:, 1]))]
    _, _, scal, volp = rs.stage_inputs(SIZE, dev)
    last = volp.shape[0] // rs.QB - rs.NB
    scal = np.concatenate([scal, [[last, last, 0, 0, 0]]]).astype(np.int32)

    def checked(o):
        return checked_index(o, (0, 1), (SIZE - 14, SIZE - 16), "orgs", dev)
    return {"slab_sum": (vol, checked(orgs), 14, 16),
            "slab_sum_by_oy": (vol, checked(by_oy), 14, 16),
            "roi_fetch": (volp, rs.check_scalars(volp, scal))}


CASE_KERNEL = {"slab_sum_by_oy": "slab_sum"}


def floors(args) -> dict:
    """Device ms of the bytes ``slab_sum``'s two stages cannot avoid at
    ``args``, each a PyTorch call on buffers of their sizes: its output
    written alone (``zero_``), ``W`` written alone, and ``W``'s size copied
    from the volume (stage 1 reads the volume and writes ``W``)."""
    vol, orgs, Bz, By = args
    (Z, Y, X), T = vol.shape, orgs.shape[0]
    out = vol.new_empty((T, 8, X))
    W = vol.new_empty((Z, Y - By + 1, X))
    src = vol.reshape(-1)[:W.numel()].view(W.shape)
    return {"out_zero_ms": ps.device_ms(out.zero_, name=""),
            "w_zero_ms": ps.device_ms(W.zero_, name=""),
            "vol_to_w_copy_ms": ps.device_ms(lambda: W.copy_(src), name="")}


def launcher(fn, kernel: str, build: str, args):
    """One launch of ``fn`` through its build's C interface on ``args``, into
    an output (and, for the two-stage builds, a scratch) allocated here:
    ``(call, (out, scratch))``."""
    two_stage = build != "parent"
    if kernel == "slab_sum":
        vol, orgs, Bz, By = args
        (Z, Y, X), T, R = vol.shape, orgs.shape[0], 8
        out = vol.new_empty((T, R, X))
        scratch = (vol.new_empty((Z, Y - By + 1, X)), orgs.new_empty((T,)))
        ptrs = (vol.data_ptr(), orgs.data_ptr()) + (
            tuple(a.data_ptr() for a in scratch) if two_stage else ()) + (out.data_ptr(),)
        ints = (T, Z, Y, X, Bz, By, R) if two_stage else (T, Y, X, Bz, By, R)
    else:
        volp, scal = args
        (Zp, Yp, Xp), T = volp.shape, scal.shape[0]
        out = volp.new_empty((T, 1, rs.LANES))
        scratch = volp.new_empty(((Zp // rs.QB) * (Yp // rs.QB) * rs.LANES,))
        ptrs = (volp.data_ptr(), scal.data_ptr()) + (
            (scratch.data_ptr(),) if two_stage else ()) + (out.data_ptr(),)
        ints = (T, Zp, Yp, Xp) if two_stage else (T, Yp, Xp)
    stream_of = args[0].get_device()

    def call():
        rc = fn(*ptrs, *ints, torch._C._cuda_getCurrentRawStream(stream_of))
        if rc != 0:
            raise RuntimeError(f"{build}'s {kernel} launch failed: cudaError {rc}")
    return call, (out, scratch)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of a checkout with the one-pass kernels")
    ap.add_argument("--out", help="write every reading to this JSON file")
    a = ap.parse_args(argv)
    todo = builds(a.parent)
    with ThreadPoolExecutor(len(todo)) as pool:
        done = dict(zip(todo, pool.map(
            lambda k: ab.build(todo[k][0], k[1], todo[k][1], todo[k][2]), todo)))
    result = {"device": torch.cuda.get_device_name(0), "builds": {}, "cases": {}}
    for (kernel, name), (_, report) in done.items():
        result["builds"][f"{kernel} {name}"] = ab.resources(report, STAGES[kernel])
        print(f"[build] {kernel} {name}: {json.dumps(result['builds'][f'{kernel} {name}'])}",
              flush=True)
    dev = torch.device("cuda")
    calls, keep = {}, []
    for case, args in cases(dev).items():
        kernel = CASE_KERNEL.get(case, case)
        names = [n for k, n in done if k == kernel]
        outs = {}
        for name in names:
            entries = {kernel: (PARENT_ENTRIES[kernel] if name == "parent"
                                else (hg if kernel == "slab_sum" else rs).LIB.entries[kernel])}
            fn = ab.bind(done[kernel, name][0], entries)[kernel]
            call, held = launcher(fn, kernel, name, args)
            call()
            torch.cuda.synchronize()
            outs[name] = held[0]
            calls[case, name] = call, PROFILE_NAME[kernel]
            keep.append(held)  # each output and scratch lives as long as its call
        ordered, plain, atol = ((hg.slab_sum_ordered, hg.slab_sum_plain, hg.P3_ATOL)
                                if kernel == "slab_sum" else
                                (rs.roi_fetch_ordered, rs.roi_fetch_plain, rs.FETCH_ATOL))
        for name, out in outs.items():
            if not torch.equal(out, outs["parent"]):
                raise AssertionError(f"{case}: {name} differs from the parent's kernel")
        if not torch.equal(outs["tree"], ordered(*args)):
            raise AssertionError(f"{case}: the kernel differs from its torch order")
        err = float((outs["tree"] - plain(*args)).abs().max())
        if not err <= atol:
            raise AssertionError(f"{case}: {err:.3e} from its plain version (atol {atol:g})")
        print(f"[bits] {case}: {', '.join(names)} equal to the bit; the torch order equal; "
              f"plain version max|d| {err:.3e} (atol {atol:g})", flush=True)
    rows = ab.in_turns(calls, list(dict.fromkeys(n for _, n in done)))
    for case, row in rows.items():
        row = {k: {n: v for n, v in by.items() if v} for k, by in row.items()}
        # each stage's device time alone, for the two-stage builds
        row["stage_device_ms"] = {
            name: {stage: ms for stage in STAGES[CASE_KERNEL.get(case, case)][1:]
                   if (ms := ps.device_ms(call, name=f"{stage}_kernel")) is not None}
            for (c, name), (call, _) in calls.items() if c == case and name != "parent"}
        result["cases"][case] = row
        print(f"[ab] {case}: {json.dumps(row)}", flush=True)
    result["floors"] = floors(cases(dev)["slab_sum"])
    print(f"[floors] slab_sum: {json.dumps(result['floors'])}", flush=True)
    if a.out:
        Path(a.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
