"""Where the time of the recipe cascade goes on a CUDA device.

    python -m torchregister_tpu_torch.profile_cascade [--unet] [--fn]

For the 240³ rigid pair and deformable-truth pair of :mod:`.synthetic` under
``RECIPE`` (with ``--unet``: the deformable pair alone under ``RECIPE_UNET``,
the U-Net flow stage), through ``register_cascade`` (with ``--fn``: through
``make_cascade_fn``'s ``fn``, each engine level's step replayed from a CUDA
graph), after one warm-up cascade each (which captures the graphs):

1. ``wall``: the wall time of ``RUNS`` cascades, no profiler, no extra syncs;
2. ``stages``: one cascade with each of its stage functions wrapped in a
   device sync on both sides (time and executed steps per stage and level);
3. ``profile``: one cascade under ``torch.profiler`` (the card's activity
   alone). ``device_s`` sums the durations of every device event (kernels,
   copies, fills; ``top_device_ms`` by kernel); ``busy_union_s``
   is the union of their intervals. Two busy shares are printed:
   ``busy_share_profiled`` = ``busy_union_s`` / wall time of the profiled run
   (the profiler slows the host, so this is a lower bound), and
   ``busy_share_est`` = ``busy_union_s`` / the median of the unprofiled wall
   times of step 1 (assumes the profiler leaves device work unchanged);
4. ``score_bf16`` (deformable pair): ``flow_truth_metrics`` as the port runs
   it (f32) and with the operands of the total map's matrix product
   (``M`` and ``x + f(x)``) rounded to bf16 first, as one bf16 pass of a
   matrix unit at default precision would take them.

Prints one JSON object per line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import time

import torch

from . import synthetic
from .engines import cascade
from .ops.separable import affine_to_index_map

RUNS = 5
_STAGES = ("build_pyramid", "rigid_register", "compose_theta", "_level_warp",
           "affine_register", "flow_register", "upsample_flow", "warp_flow_separable",
           "compose_flows")


def _sync_ms(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


@contextlib.contextmanager
def _patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def _timed_stages(records: list):
    """Wrap the cascade module's stage functions: each call appends
    ``[name, shape of its first tensor argument, ms, executed steps]``."""
    with contextlib.ExitStack() as stack:
        for name in _STAGES:
            def timed(*args, _name=name, _fn=getattr(cascade, name), **kwargs):
                out, ms = _sync_ms(_fn, *args, **kwargs)
                shape = next((list(a.shape[2:]) for a in args
                              if isinstance(a, torch.Tensor) and a.ndim >= 5), None)
                steps = (getattr(out[1], "steps", None)
                         if isinstance(out, tuple) and len(out) == 2 else None)
                records.append([_name, shape, round(ms, 3), steps])
                return out

            stack.enter_context(_patched(cascade, name, timed))
        yield


def _map_bf16(theta, flow, spatial):
    """``synthetic.total_sampling_map`` with the matrix product's operands
    rounded to bf16 (products and sums stay f32)."""
    d = len(spatial)
    axes = [torch.arange(s, dtype=torch.float32, device=theta.device) for s in spatial]
    y = torch.stack(torch.meshgrid(*axes, indexing="ij"))
    if flow is not None:
        y = y + flow[0]
    M, t = affine_to_index_map(theta[0].to(torch.float32), spatial, align_corners=False)
    rnd = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    return torch.einsum("ij,j...->i...", rnd(M), rnd(y)) + t.reshape((d,) + (1,) * d)


def busy_profile(moving, target, wall_s: list, run) -> dict:
    """One ``run(moving, target)`` under ``torch.profiler`` recording the
    card's activity alone (the host's ops, ~10^4 a U-Net step, would cost
    minutes to parse): its device events, their union and the busy shares
    (step 3 above)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ms = _sync_ms(run, moving, target)
    # device work only: a trace span (the cascade's rigid/level0, ...) may
    # show as a device-side range over the kernels it encloses
    events = prof.events()
    spans = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in spans]
    if not dev:
        return {"device_s": "not measured", "profiled_wall_s": ms / 1e3}
    intervals = sorted((e.time_range.start, e.time_range.end) for e in dev)
    union, cur_lo, cur_hi = 0.0, *intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            union += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    union = (union + cur_hi - cur_lo) / 1e6  # us -> s
    top = sorted((a for a in prof.key_averages() if a.key not in spans),
                 key=lambda a: a.self_device_time_total, reverse=True)[:16]
    return {
        "profiled_wall_s": ms / 1e3,
        "device_events": len(dev),
        "device_s": sum(e.time_range.end - e.time_range.start for e in dev) / 1e6,
        "busy_union_s": union,
        "busy_share_profiled": union / (ms / 1e3),
        "busy_share_est": union / statistics.median(wall_s),
        "top_device_ms": [[a.key[:70], round(a.self_device_time_total / 1e3, 3), a.count]
                          for a in top],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unet", action="store_true",
                    help="the U-Net recipe on the deformable pair")
    ap.add_argument("--fn", action="store_true",
                    help="through make_cascade_fn (each level's step a CUDA graph)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cascade needs a CUDA device")
    recipe = synthetic.RECIPE_UNET if args.unet else synthetic.RECIPE
    run = (cascade.make_cascade_fn(**recipe) if args.fn
           else functools.partial(cascade.register_cascade, **recipe))
    fmov, ftgt, theta_true, flow_true = synthetic.make_flow_truth_pair(device="cuda")
    pairs = [("deformable", (fmov, ftgt))]
    if not args.unet:
        pairs.insert(0, ("rigid", synthetic.make_pair(device="cuda")))
    for pair, (mov, tgt) in pairs:
        run(mov, tgt)  # warm-up
        wall_s = [_sync_ms(run, mov, tgt)[1] / 1e3 for _ in range(RUNS)]
        print(json.dumps({"pair": pair, "fn": args.fn, "wall_s": wall_s,
                          "median_wall_s": statistics.median(wall_s)}), flush=True)
        records: list = []
        with _timed_stages(records):
            res, ms = _sync_ms(run, mov, tgt)
        print(json.dumps({"pair": pair, "stages_total_ms": ms, "steps": res.steps,
                          "stages": records}), flush=True)
        print(json.dumps({"pair": pair, "profile": busy_profile(mov, tgt, wall_s, run)}),
              flush=True)
        if pair == "deformable":
            f32 = synthetic.flow_truth_metrics(res, fmov, ftgt, theta_true, flow_true)
            with _patched(synthetic, "total_sampling_map", _map_bf16):
                bf16 = synthetic.flow_truth_metrics(res, fmov, ftgt, theta_true, flow_true)
            keys = ("flow_truth_rmse_reduction_pct", "flow_field_err_vox",
                    "flow_field_err_observable_vox")
            print(json.dumps({"pair": pair, "score_bf16": {
                "f32": dict(zip(keys, f32)), "bf16_map_operands": dict(zip(keys, bf16))}}),
                flush=True)


if __name__ == "__main__":
    main()
