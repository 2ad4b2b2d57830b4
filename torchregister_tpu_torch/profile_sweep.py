"""K1's launches and whole separable warps timed on a CUDA device.

    python -m torchregister_tpu_torch.profile_sweep

At the main path's shapes (``SHAPES``: the fine flow level, the 240³ level
re-warp, the matrix stages' in-loop warps), with coordinates as the path
gives them (a rigid theta's passes; a smooth field within the window):

1. ``launch`` rows: one launch of each pass's affine or flow form against
   the dense launch on the coordinates the previous composition built
   (``_axis_coord_grid``; ``flow[:, a] + ident``) and against the plain
   version (its backward: autograd to the image and to the table row or the
   field, as the kernel computes both), forward and backward, CUDA events,
   in turns (dense, mode, mode, dense), and each kernel's device time alone
   (``*_device_ms``, ``torch.profiler``: at the in-loop shapes a launch
   costs the host more than the card), mean over the three passes
   (``by_axis``: each pass's); with each form's bound (bytes over 3.35 TB/s
   or operations over 67 TFLOP/s, the larger).
2. ``warp3`` rows: one 3-pass warp through the whole-warp Functions
   (``_warp_affine_separable``, ``warp_flow_separable``) against the
   per-pass composition the port ran before (coordinates built per pass with
   torch ops, then ``sweep``), forward and forward+backward with theta or
   the field requiring grad, host included (events around the calls).
3. ``ops`` row: the aten operations one in-loop warp dispatches, forward
   and backward, both ways.

Prints one JSON object per line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .ops.cuda import sweep as k1
from .ops.separable import (_warp_affine_separable, affine_to_index_map, factor_passes,
                            warp_flow_separable)
from .ops.transforms import as_matrix, rigid_theta
from .synthetic import cubic_resize

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# (mode, S, K, image dtype): the fine flow level, the 240³ level re-warp and
# the matrix stages' in-loop warps at 60³ and 120³
SHAPES = (("flow", 240, 8, torch.float32), ("affine", 240, 80, torch.float32),
          ("affine", 60, 11, torch.bfloat16), ("affine", 120, 6, torch.bfloat16))
# a rigid transform inside the in-loop windows (the JAX bench selftest's)
THETA = (0.15, -0.12, 0.1, 0.12, -0.08, 0.06)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, name: str = "sweep_") -> float | None:
    """The mean device time of the kernels whose names hold ``name`` (K1's
    by default; ``""``: every kernel) that one call of ``fn`` launches
    (``torch.profiler``'s kernel spans, no host time); None (not measured)
    when no profile of three records such kernels for every call, as CUPTI
    now and then drops a profile's device records (a span count that is not
    a multiple of the calls marks a drop)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if spans and len(spans) % iters == 0:
            return sum(r.end - r.start for r in spans) / 1e3 / iters
    return None


def in_turns(fns: dict) -> dict:
    """Each function timed twice, in the order given and then reversed
    (a, b, b, a); the mean of its two times."""
    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(time_ms(fns[n]))
    return {n: sum(v) / 2 for n, v in got.items()}


def bound_ms(nbytes: float, flops: float) -> dict:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}


def case(mode: str, S: int, K: int, dtype, seed: int = 0):
    """An image, a cotangent, and the warp's parameters: theta's table of
    passes (affine) or a smooth field within the window (flow)."""
    gen = torch.Generator(device=DEV).manual_seed(seed + S + K)
    src = torch.rand((1, 1, S, S, S), generator=gen, device=DEV).to(dtype)
    g = torch.randn(src.shape, generator=gen, device=DEV).to(dtype)
    theta = rigid_theta(torch.tensor(THETA, device=DEV))[None]
    passes = factor_passes(*affine_to_index_map(theta[0], (S,) * 3))
    table = torch.stack([torch.cat([c, o.reshape(1)]) for _, (c, o) in passes]).contiguous()
    coarse = torch.randn((3, 6, 6, 6), generator=gen, device=DEV)
    flow = cubic_resize(coarse, (S, S, S))
    flow = (flow * (K / torch.max(torch.abs(flow))))[None].contiguous()
    return src, g, theta, [a for a, _ in passes], table, flow


def parent_q(src, table, flow, mode: str, p: int, axis: int) -> torch.Tensor:
    """The dense coordinates the per-pass composition built for a pass."""
    spatial = tuple(src.shape[2:])
    if mode == "affine":
        q = k1._axis_coord_grid(table[p, :3], table[p, 3], spatial)
    else:
        ident = torch.arange(spatial[axis], dtype=torch.float32, device=DEV)
        q = flow[:, axis][:, None] + ident.view(tuple(
            spatial[axis] if i == axis else 1 for i in range(3)))
    return q.expand(src.shape).contiguous()


def _bounds(mode: str, S: int, dtype) -> dict:
    """Each input read once, each output written once: the image side in
    its dtype, coordinates, fields and their gradients f32; ~6 operations
    per output of a sweep, ~10 per voxel of its adjoint."""
    vox, e = float(S) ** 3, torch.finfo(dtype).bits / 8
    u = 4.0 if mode == "flow" else 0.0  # the field's channel, and du
    return {"fwd": bound_ms(vox * (2 * e + u), 6 * vox),
            "bwd": bound_ms(vox * (3 * e + 2 * u), 10 * vox),
            "dense_fwd": bound_ms(vox * (2 * e + 4), 6 * vox),
            "dense_bwd": bound_ms(vox * (3 * e + 8), 10 * vox)}


def launch_row(mode: str, S: int, K: int, dtype) -> dict:
    """One launch of each form, mean over the three passes of the warp: the
    raw launches (no input checks)."""
    src, g, _, axes, table, flow = case(mode, S, K, dtype)
    keys = ["fwd_ms", "dense_fwd_ms", "bwd_ms", "dense_bwd_ms", "fwd_device_ms",
            "dense_fwd_device_ms", "bwd_device_ms", "dense_bwd_device_ms", "plain_fwd_ms",
            "plain_bwd_ms"]
    per_axis = {k: {} for k in keys}
    dtable = torch.empty_like(table)
    dflow = torch.empty_like(flow)
    work = k1._affine_work(src, axes, [K] * len(axes))
    s = src.clone().requires_grad_(True)

    def dense_bwd(q, dim):
        dsrc, dq = torch.empty_like(src), torch.empty_like(q)
        k1._bwd_dense(g, src, q, dim, K, dsrc, dq)
        return dsrc, dq

    for p, axis in enumerate(axes):
        dim = 2 + axis
        q = parent_q(src, table, flow, mode, p, axis)
        if mode == "affine":
            fwd = lambda: k1._fwd_affine(src, table, p, axis, K)  # noqa: E731
            bwd = lambda: k1._bwd_affine(g, src, table, p, axis, K, True, dtable,  # noqa: E731
                                         work)
            row = table[p].clone().requires_grad_(True)
            plain = lambda x: k1.sweep_affine_plain(x, row[:3], row[3], axis, K)  # noqa: E731
            wrt = (s, row)
        else:
            fwd = lambda: k1._fwd_flow(src, flow, axis, K)  # noqa: E731
            bwd = lambda: k1._bwd_flow(g, src, flow, axis, K, True, dflow)  # noqa: E731
            fl = flow.clone().requires_grad_(True)
            plain = lambda x: k1.sweep_flow_plain(x, fl, axis, K)  # noqa: E731
            wrt = (s, fl)
        launches = {"dense_fwd": lambda: k1._fwd_dense(src, q, dim, K),
                    "fwd": fwd, "dense_bwd": lambda: dense_bwd(q, dim), "bwd": bwd}
        t = in_turns({f"{n}_ms": launches[n] for n in ("dense_fwd", "fwd")})
        t.update(in_turns({f"{n}_ms": launches[n] for n in ("dense_bwd", "bwd")}))
        t.update({f"{n}_device_ms": device_ms(f) for n, f in launches.items()})
        with torch.no_grad():
            t["plain_fwd_ms"] = time_ms(lambda: plain(src))
        out = plain(s)
        t["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(out, wrt, g, retain_graph=True))
        del out
        for k in keys:
            per_axis[k][axis] = t[k]
    b = _bounds(mode, S, dtype)
    # a device time not measured on one pass leaves its mean not measured
    sums = {k: None if None in v.values() else sum(v.values()) / len(v)
            for k, v in per_axis.items()}
    sums["by_axis"] = per_axis
    return {"mode": mode, "S": S, "K": K, "dtype": str(dtype).replace("torch.", ""), **sums,
            **{f"{k}_bound_ms": v["bound_ms"] for k, v in b.items()},
            **{f"{k}_bound_by": v["bound_by"] for k, v in b.items()}}


def previous_affine_warp(theta, src, K):
    """The per-pass composition the port ran before the modes."""
    theta = as_matrix(theta)
    spatial = tuple(src.shape[2:])
    out = src
    for axis, (coef, offset) in factor_passes(*affine_to_index_map(theta[0], spatial)):
        out = k1.sweep(out, k1._axis_coord_grid(coef, offset, spatial), 2 + axis, K)
    return out


def previous_flow_warp(src, flow, K):
    spatial = tuple(src.shape[2:])
    out = src
    for axis in (2, 1, 0):
        ident = torch.arange(spatial[axis], dtype=torch.float32, device=flow.device)
        ident = ident.view(tuple(spatial[axis] if i == axis else 1 for i in range(3)))
        out = k1.sweep(out, flow[:, axis].to(torch.float32)[:, None] + ident, 2 + axis, K)
    return out


def _warps(mode: str, K: int):
    if mode == "affine":
        return {"warp3": lambda s, th: _warp_affine_separable(th, s, max_shift=K),
                "previous_warp3": lambda s, th: previous_affine_warp(th, s, K)}
    return {"warp3": lambda s, f: warp_flow_separable(s, f, max_disp=K),
            "previous_warp3": lambda s, f: previous_flow_warp(s, f, K)}


def warp3_row(mode: str, S: int, K: int, dtype) -> dict:
    """One 3-pass warp both ways, forward and forward+backward, the warp's
    parameter requiring grad (the image does not, as in the engines)."""
    src, g, theta, _, _, flow = case(mode, S, K, dtype)
    param = (theta if mode == "affine" else flow).clone().requires_grad_(True)
    warps = _warps(mode, K)
    fwd = in_turns({f"{n}_fwd_ms": (lambda w=w: w(src, param)) for n, w in warps.items()})
    both = in_turns({f"{n}_fwdbwd_ms": (lambda w=w: torch.autograd.grad(w(src, param), param, g))
                     for n, w in warps.items()})
    return {"mode": mode, "S": S, "K": K, "dtype": str(dtype).replace("torch.", ""), **fwd,
            **both}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def op_counts(S: int = 60, K: int = 11, dtype=torch.bfloat16) -> dict:
    """aten operations of one in-loop affine warp (theta requiring grad),
    forward and backward, through the Function and the previous way."""
    src, g, theta, _, _, _ = case("affine", S, K, dtype)
    row = {"mode": "affine", "S": S, "K": K, "dtype": str(dtype).replace("torch.", "")}
    for name, warp in _warps("affine", K).items():
        th = theta.clone().requires_grad_(True)
        with _OpCount() as fwd:
            out = warp(src, th)
        with _OpCount() as bwd:
            torch.autograd.grad(out, th, g)
        row[f"{name}_fwd_ops"], row[f"{name}_bwd_ops"] = fwd.n, bwd.n
    return row


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sweep needs a CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for mode, S, K, dtype in SHAPES:
        print(json.dumps({"launch": launch_row(mode, S, K, dtype)}), flush=True)
    for mode, S, K, dtype in SHAPES:
        print(json.dumps({"warp3": warp3_row(mode, S, K, dtype)}), flush=True)
    print(json.dumps({"ops": op_counts()}), flush=True)


if __name__ == "__main__":
    main()
