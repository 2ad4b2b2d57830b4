"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds kernels K1 (the sweep resampler, ``torchregister_tpu_torch/csrc/
sweep.cu``) and K2 (the exact trilinear warp, ``csrc/warp.cu``) from the
checkout, holds each against its plain PyTorch version on the card, drives
the port's paths with quality gates (the recipe cascade on the 240³ pairs;
the CLI's register/apply round trip on NIfTI files; ``Register`` rigid, then
flow), and times each kernel against its plain version. Any failure raises,
so the exit code is non-zero.

    python3 chip_smoke.py

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels with their launches on the paths (counts
set to 0 just before each path and read just after), their largest absolute
deviation from the plain version over all checks, and the time of one launch
against one pass of the plain version.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from torchregister_tpu_torch import Register
from torchregister_tpu_torch.__main__ import main as cli
from torchregister_tpu_torch.engines.cascade import register_cascade
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.ops.separable import affine_to_index_map
from torchregister_tpu_torch.ops.transforms import rigid_theta
from torchregister_tpu_torch.synthetic import (
    RECIPE,
    cubic_resize,
    flow_truth_metrics,
    make_flow_truth_pair,
    make_pair,
    rmse_reduction_pct,
)
from torchregister_tpu_torch.utils import volio

DEV = "cuda"
GATES = dict(rmse_reduction_pct=98.5, flow_truth_rmse_reduction_pct=97.0,
             flow_field_err_observable_vox=0.6)
REPLACES = {
    "sweep_fwd": "torchregister_tpu/ops/pallas/sweep.py:38",
    "sweep_bwd": "torchregister_tpu/ops/pallas/sweep.py:134",
    "warp_affine": "torchregister_tpu/ops/pallas/roigather.py:145",
    "warp_flow": "torchregister_tpu/ops/pallas/roigather.py:145",
}
SOURCES = {"sweep_fwd": "torchregister_tpu_torch/csrc/sweep.cu",
           "sweep_bwd": "torchregister_tpu_torch/csrc/sweep.cu",
           "warp_affine": "torchregister_tpu_torch/csrc/warp.cu",
           "warp_flow": "torchregister_tpu_torch/csrc/warp.cu"}
# Register rigid at 240³ (Adam from the identity, the cascade's coarse
# window S/4): 150 steps at lr 1e-2 reach 99.97 % on make_pair (H100)
REGISTER_RIGID = dict(lr=1e-2, max_epochs=150)
# The CLI cascade's flow-stage lr. Its default, 0.3, reaches 97.49 % on the
# 240³ rigid pair: the CLI runs the flow stage without a plateau stop, and
# Adam's near-full steps in the flat background move the field where the
# exact final warp then samples. 0.1 reaches 99.12 % (H100).
CLI_FLOW_LR = "0.1"
SIZE = 240  # the user path's volumes: make_pair's published size


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return smi


def phase_build() -> None:
    """Both kernels' nvcc runs at once, then load them."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(), (k1, k2)))
    k1._lib()
    k2._lib()
    print(f"[build] K1 and K2 built in {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(lib.name for lib in libs)}", flush=True)


def _rows(R, X, K, seed, lo, hi):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    src = torch.rand((R, X), generator=gen, device=DEV)
    q = torch.arange(X, dtype=torch.float32, device=DEV)[None] + (
        lo + (hi - lo) * torch.rand((R, X), generator=gen, device=DEV))
    return src, q


def _pinned(R, X, K, seed):
    """Displacements pinned at ±K and ±(K+1) plus a fraction."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    src = torch.randn((R, X), generator=gen, device=DEV)
    pick = torch.tensor([-(K + 1), -K, K, K + 1], dtype=torch.float32, device=DEV)
    disp = pick[torch.randint(0, 4, (R, X), generator=gen, device=DEV)]
    frac = 0.1 + 0.8 * torch.rand((R, X), generator=gen, device=DEV)
    return src, torch.arange(X, dtype=torch.float32, device=DEV)[None] + disp + frac


def _max_err(a, b) -> float:
    return float(torch.max(torch.abs(a.float() - b.float())))


def _rel_err(a, b) -> float:
    return _max_err(a, b) / max(float(torch.max(torch.abs(b.float()))), 1e-30)


def _check_fwd(src, q, dim, K, tol, label) -> float:
    out, diff = k1.sweep_fwd(src.contiguous(), q.contiguous(), dim, K, with_diff=True)
    ref, ref_diff = k1.sweep_plain(src, q, dim, K, with_diff=True)
    torch.cuda.synchronize()
    err = max(_max_err(out, ref), _max_err(diff, ref_diff))
    print(f"[kernel] fwd {label}: max|d| {err:.3e} (tol {tol:g})", flush=True)
    if not err < tol:
        raise AssertionError(f"K1 forward {label} disagrees: {err:.3e} >= {tol:g}")
    return err


def _check_bwd(src, q, dim, K, tol, label) -> float:
    """Relative error of (dsrc, dq) against autograd through the plain
    version (the sums run in another order)."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    g = torch.randn(src.shape, generator=gen, device=DEV).to(src.dtype)
    dsrc, dq = k1.sweep_bwd(g, src.contiguous(), q.contiguous(), dim, K)
    s = src.detach().clone().requires_grad_(True)
    qq = q.detach().clone().requires_grad_(True)
    ref_s, ref_q = torch.autograd.grad(k1.sweep_plain(s, qq, dim, K)[0], (s, qq), g)
    torch.cuda.synchronize()
    errs = (_rel_err(dsrc, ref_s), _rel_err(dq, ref_q))
    abs_err = max(_max_err(dsrc, ref_s), _max_err(dq, ref_q))
    print(f"[kernel] bwd {label}: rel dsrc {errs[0]:.3e}, rel dq {errs[1]:.3e} "
          f"(tol {tol:g})", flush=True)
    if not max(errs) < tol:
        raise AssertionError(f"K1 backward {label} disagrees: {errs} >= {tol:g}")
    return abs_err


# (S, K, image dtype) of every sweep the main path runs: the matrix stages'
# in-loop sweeps (bf16, K=11 and 6), their re-warps (K=S//3), the 240³
# re-warp (f32, K=80) and the flow levels and final warp (f32, K=8)
PATH_SWEEPS = ((60, 11, torch.bfloat16), (60, 6, torch.bfloat16),
               (120, 6, torch.bfloat16), (60, 20, torch.bfloat16),
               (120, 40, torch.bfloat16), (240, 80, torch.float32),
               (60, 8, torch.float32), (120, 8, torch.float32),
               (240, 8, torch.float32))
# f32: both versions sum in f32, so only FMA contraction and summation order
# differ. bf16 images: both sum in f32 and round once, so they may differ by
# one bf16 rounding (2^-8 relative) where a value lands on a rounding boundary.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def _vol_case(S, K, dtype, axis, seed):
    """A [1, 1, S, S, S] image and coordinates along ``axis`` spread over
    the whole window and 2 voxels past it, shaped as the main path's q."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    src = torch.rand((1, 1, S, S, S), generator=gen, device=DEV).to(dtype)
    shape = [1, 1, 1, 1, 1]
    shape[2 + axis] = S
    q = (torch.arange(S, dtype=torch.float32, device=DEV).view(shape)
         + (K + 2.0) * (2.0 * torch.rand((1, 1, S, S, S), generator=gen, device=DEV)
                        - 1.0))
    return src, q


def _check_path_sweep(S, K, dtype, axis) -> tuple[float, float]:
    """``k1.sweep`` (the autograd Function the main path calls) against
    autograd through the plain version on the same tensors: forward values,
    then dsrc and dq, each relative to the largest reference value. Returns
    the largest absolute deviations, forward and backward."""
    src, q = _vol_case(S, K, dtype, axis, 1000 * S + 10 * K + axis)
    gen = torch.Generator(device=DEV).manual_seed(7)
    g = torch.randn(src.shape, generator=gen, device=DEV).to(dtype)
    grads, outs = [], []
    for fn in (k1.sweep, lambda s, qq, d, k: k1.sweep_plain(s, qq, d, k)[0]):
        s = src.clone().requires_grad_(True)
        qq = q.clone().requires_grad_(True)
        out = fn(s, qq, 2 + axis, K)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (s, qq), g))
    torch.cuda.synchronize()
    (ds, dq), (ref_s, ref_q) = grads
    rel = (_rel_err(outs[0], outs[1]), _rel_err(ds, ref_s), _rel_err(dq, ref_q))
    tol = TOL[dtype]
    label = f"{S}³ K={K} {str(dtype).replace('torch.', '')} axis {axis}"
    print(f"[kernel] sweep {label}: rel out {rel[0]:.3e}, dsrc {rel[1]:.3e}, "
          f"dq {rel[2]:.3e} (tol {tol:g})", flush=True)
    if not max(rel) < tol:
        raise AssertionError(f"k1.sweep {label} disagrees with the plain version: "
                             f"{rel} >= {tol:g}")
    return _max_err(outs[0], outs[1]), max(_max_err(ds, ref_s), _max_err(dq, ref_q))


def phase_kernels() -> dict:
    """K1 against its plain version on the card; returns the largest
    absolute deviations seen, forward and backward, f32 and bf16 alike."""
    fwd_err = bwd_err = 0.0
    # the raw launchers, with diff: the JAX bench selftest's case (R=1024,
    # X=240, K=80, q over [-K-2, K+2]), then displacements pinned at ±K and
    # ±(K+1) with R not a multiple of any block or tile size
    K = 80
    src, q = _rows(1024, 240, K, 42, -K - 2.0, K + 2.0)
    fwd_err = max(fwd_err, _check_fwd(src, q, 1, K, 1e-5, "R=1024 X=240 K=80"))
    for K in (8, 80):
        src, q = _pinned(1001, 240, K, 3 + K)
        fwd_err = max(fwd_err, _check_fwd(src, q, 1, K, 1e-5, f"edges R=1001 K={K}"))
        bwd_err = max(bwd_err, _check_bwd(src, q, 1, K, 1e-5, f"edges R=1001 K={K}"))
    for K in (8, 80):
        src, q = _rows(1024, 240, K, 7 + K, -K - 2.0, K + 2.0)
        bwd_err = max(bwd_err, _check_bwd(src, q, 1, K, 1e-5, f"R=1024 K={K}"))
    # the autograd Function at every shape, window and dtype the main path
    # runs, along each axis of the volume (no transpose)
    for S, K, dtype in PATH_SWEEPS:
        for axis in range(3):
            f, b = _check_path_sweep(S, K, dtype, axis)
            fwd_err, bwd_err = max(fwd_err, f), max(bwd_err, b)
    return {"sweep_fwd": fwd_err, "sweep_bwd": bwd_err}


# the JAX bench selftest's rigid transform of the K2 check (bench.py:82)
SELFTEST_THETA = (0.15, -0.12, 0.1, 0.12, -0.08, 0.06)


def _mt(theta, spatial):
    M, t = affine_to_index_map(theta[0], spatial)
    return k2.pack_affine(M, t)


def _smooth_flow(S, max_disp, seed):
    """A band-limited field (cubic upsample of a 6³ draw), |flow| <= max_disp."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    coarse = torch.randn((3, 6, 6, 6), generator=gen, device=DEV)
    flow = cubic_resize(coarse, (S, S, S))
    return (flow * (max_disp / torch.max(torch.abs(flow)))).contiguous()


def _check_k2(label, src, mt=None, flow=None) -> float:
    """One raw launch against ``warp_plain`` on the same tensors; tolerance
    1e-5 of max |src| (both run the same f32 operations in the same order)."""
    if src.ndim == 3:  # 2D [C, Y, X]: through the wrapper, one z plane
        out = k2.warp(src, mt=mt)
        ref = k2.warp_plain(src[:, None], mt=mt)[:, 0]
    elif flow is None:
        out, ref = k2.warp_affine_launch(src, mt), k2.warp_plain(src, mt=mt)
    else:
        out, ref = k2.warp_flow_launch(src, flow), k2.warp_plain(src, flow=flow)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    rel = err / max(float(torch.max(torch.abs(src))), 1e-30)
    zeros = float(torch.mean((out == 0).float()))
    print(f"[k2] {label}: max|d| {err:.3e}, rel {rel:.3e} (tol 1e-5); zero share "
          f"{zeros:.3f}", flush=True)
    if not rel < 1e-5:
        raise AssertionError(f"K2 {label} disagrees with warp_plain: {rel:.3e}")
    return err


def phase_k2() -> dict:
    """K2 against its plain version at the shapes the user path gives it."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    theta = rigid_theta(torch.tensor(SELFTEST_THETA, device=DEV))[None]
    S = SIZE
    vol = torch.rand((1, S, S, S), generator=gen, device=DEV)
    aff = [_check_k2(f"affine {S}³ selftest theta", vol, mt=_mt(theta, (S,) * 3))]
    small = torch.rand((1, 50, 47, 44), generator=gen, device=DEV)
    aff.append(_check_k2("affine 50x47x44 selftest theta", small,
                         mt=_mt(theta, (50, 47, 44))))
    out_theta = torch.tensor([[[1.0, 0, 0, 0.9], [0, 1.0, 0, -0.8], [0, 0, 1.0, 0.5]]],
                             device=DEV)  # pushes part of the output past the volume
    aff.append(_check_k2(f"affine {S}³ zeros padding", vol, mt=_mt(out_theta, (S,) * 3)))
    theta2 = rigid_theta(torch.tensor((0.3, 0.1, -0.2), device=DEV))[None]
    img = torch.rand((1, S, S), generator=gen, device=DEV)
    aff.append(_check_k2(f"affine {S}² 2D", img, mt=_mt(theta2, (S, S))))
    batch = torch.rand((3, S, S, S), generator=gen, device=DEV)
    aff.append(_check_k2(f"affine {S}³ folded batch C=3", batch, mt=_mt(theta, (S,) * 3)))
    flow = _smooth_flow(S, 8.0, 6)
    fl = [_check_k2(f"flow {S}³ smooth |flow|<=8", vol, flow=flow)]
    # outward zoom by 1.25 plus the smooth field: samples past all six faces
    o = torch.arange(S, dtype=torch.float32, device=DEV) - (S - 1) / 2
    grid = torch.stack(torch.meshgrid(o, o, o, indexing="ij"))
    fl.append(_check_k2(f"flow {S}³ past every face", vol,
                        flow=(0.25 * grid + flow).contiguous()))
    return {"warp_affine": max(aff), "warp_flow": max(fl)}


def _on_cuda(res) -> None:
    for name, v in res._asdict().items():
        if isinstance(v, torch.Tensor) and not v.is_cuda:
            raise AssertionError(f"CascadeResult.{name} is not on the GPU")


def _finite(res, shape) -> None:
    if tuple(res.warped.shape) != shape or not bool(torch.isfinite(res.warped).all()):
        raise AssertionError("cascade output is not a finite volume of the input shape")
    if not bool(torch.isfinite(res.theta).all()) or not bool(torch.isfinite(res.flow).all()):
        raise AssertionError("cascade theta or flow is not finite")


def phase_main_path() -> dict:
    """The 240³ recipe cascade on both pairs, with quality gates."""
    t0 = time.perf_counter()
    moving, target = make_pair(device=DEV)
    fmov, ftgt, theta_true, flow_true = make_flow_truth_pair(device=DEV)
    torch.cuda.synchronize()
    print(f"[main] pairs made in {time.perf_counter() - t0:.1f} s", flush=True)

    k1.reset_counts()
    res = register_cascade(moving, target, **RECIPE)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = register_cascade(moving, target, **RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fres = register_cascade(fmov, ftgt, **RECIPE)
    torch.cuda.synchronize()
    launches = {"sweep_fwd": k1.fwd_launches, "sweep_bwd": k1.bwd_launches}

    for r, m in ((res, moving), (fres, fmov)):
        _on_cuda(r)
        _finite(r, tuple(m.shape))
    quality = {"rmse_reduction_pct": rmse_reduction_pct(res.warped, moving, target)}
    q3 = flow_truth_metrics(fres, fmov, ftgt, theta_true, flow_true)
    quality.update(flow_truth_rmse_reduction_pct=q3[0], flow_field_err_vox=q3[1],
                   flow_field_err_observable_vox=q3[2])
    print(f"[main] cascade wall time after warm-up: {wall:.3f} s", flush=True)
    print(f"[main] steps, rigid pair: {res.steps}", flush=True)
    print(f"[main] steps, deformable pair: {fres.steps}", flush=True)
    print(f"[main] quality: {json.dumps(quality)}", flush=True)
    print(f"[main] K1 launches: {json.dumps(launches)}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path did not run K1: {launches}")
    if quality["rmse_reduction_pct"] < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"rigid gate failed: {quality}")
    if quality["flow_truth_rmse_reduction_pct"] < GATES["flow_truth_rmse_reduction_pct"]:
        raise AssertionError(f"deformable gate failed: {quality}")
    if quality["flow_field_err_observable_vox"] > GATES["flow_field_err_observable_vox"]:
        raise AssertionError(f"observable map error gate failed: {quality}")
    return launches


def _counts() -> dict:
    return {"sweep_fwd": k1.fwd_launches, "sweep_bwd": k1.bwd_launches,
            "warp_affine": k2.affine_launches, "warp_flow": k2.flow_launches}


def _reset_counts() -> None:
    k1.reset_counts()
    k2.reset_counts()


def _need(launches: dict, names, path: str) -> None:
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{path} did not launch {missing}: {launches}")


def phase_cli(tmp: str) -> dict:
    """``register --mode cascade`` then ``apply`` on NIfTI files at 240³,
    through the CLI's own entry point."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    paths = {k: os.path.join(tmp, f"{k}.nii") for k in ("moving", "target", "warped",
                                                         "applied")}
    trf = os.path.join(tmp, "t.npz")
    volio.write_volume(paths["moving"], moving[0, 0].cpu().numpy())
    volio.write_volume(paths["target"], target[0, 0].cpu().numpy())
    print(f"[cli] volume I/O: {'native' if volio._get_lib() else 'numpy'}", flush=True)
    _reset_counts()
    t0 = time.perf_counter()
    if cli(["register", paths["moving"], paths["target"], "--mode", "cascade",
            "--flow-lr", CLI_FLOW_LR, "--device", DEV, "-o", paths["warped"],
            "--save-transform", trf]) != 0:
        raise AssertionError("register failed")
    t1 = time.perf_counter()
    if cli(["apply", paths["moving"], trf, "-o", paths["applied"], "--device", DEV]) != 0:
        raise AssertionError("apply failed")
    torch.cuda.synchronize()
    launches = _counts()
    warped, applied = (volio.read_volume(paths[k]) for k in ("warped", "applied"))
    mov, tgt = (volio.read_volume(paths[k]) for k in ("moving", "target"))
    pct = rmse_reduction_pct(*(torch.from_numpy(a) for a in (warped, mov, tgt)))
    exact = bool(np.array_equal(warped, applied))
    print(f"[cli] register {t1 - t0:.2f} s, apply {time.perf_counter() - t1:.2f} s; "
          f"RMSE reduction {pct:.3f} %; applied == warped bit for bit: {exact}; "
          f"launches {json.dumps(launches)}", flush=True)
    if warped.shape != (SIZE,) * 3 or not np.isfinite(warped).all():
        raise AssertionError("the CLI's output is not a finite volume of the input shape")
    if not exact:
        raise AssertionError("apply does not reproduce register's output bit for bit")
    if pct < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"CLI cascade RMSE gate failed: {pct:.3f} %")
    _need(launches, ("sweep_fwd", "sweep_bwd", "warp_affine", "warp_flow"), "the CLI")
    return launches


def phase_register() -> tuple[dict, float]:
    """``Register`` rigid at 240³, then flow on its result; ``reg(x)`` (K2)
    against ``warp_plain`` on the same field."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    _reset_counts()
    t0 = time.perf_counter()
    reg = Register(mode="rigid", device=DEV, criterion=["mse", "ncc"], optimizer="adam",
                   init="identity", max_shift=SIZE // 4)
    reg.optim(moving, target, **REGISTER_RIGID)
    rigid_out = reg(moving)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    freg = Register(mode="flow", device=DEV, criterion=["mse", "ncc"])
    # stop_crit -inf: all 50 epochs, though the pair is aligned already
    freg.optim(rigid_out, target, max_epochs=50, stop_crit=float("-inf"))
    flow_out = freg(rigid_out)
    torch.cuda.synchronize()
    launches = _counts()
    pct = rmse_reduction_pct(rigid_out, moving, target)
    flow_pct = rmse_reduction_pct(flow_out, moving, target)
    err = _max_err(flow_out[0], k2.warp_plain(rigid_out[0], flow=freg.theta[0]))
    rel = err / float(torch.max(torch.abs(rigid_out)))
    print(f"[register] rigid {REGISTER_RIGID} {t1 - t0:.2f} s, "
          f"{int(reg.result.steps)} steps, RMSE reduction {pct:.3f} %; flow 50 epochs "
          f"{time.perf_counter() - t1:.2f} s, {int(freg.result.steps)} steps, "
          f"RMSE reduction {flow_pct:.3f} %; reg(x) vs warp_plain max|d| {err:.3e} "
          f"(rel {rel:.3e}); launches {json.dumps(launches)}", flush=True)
    if pct < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"Register rigid RMSE gate failed: {pct:.3f} %")
    if not rel < 1e-5 or not bool(torch.isfinite(flow_out).all()):
        raise AssertionError(f"Register flow output disagrees with warp_plain: {rel:.3e}")
    _need(launches, ("sweep_fwd", "sweep_bwd", "warp_affine", "warp_flow"), "Register")
    return launches, err


def _time_ms(fn, iters=20, warmup=3) -> float:
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


def _warp_case(S, K, dtype):
    """One 3-pass separable warp (axis 2, 1, 0) with displacements spread
    over the window, as the slice runs it."""
    gen = torch.Generator(device=DEV).manual_seed(S + K)
    src = torch.rand((1, 1, S, S, S), generator=gen, device=DEV).to(dtype)
    qs = []
    for axis in (2, 1, 0):
        shape = [1, 1, 1, 1, 1]
        shape[2 + axis] = S
        qs.append((axis, torch.arange(S, dtype=torch.float32, device=DEV).view(shape)
                   + K * (2.0 * torch.rand((1, 1, S, S, S), generator=gen, device=DEV)
                          - 1.0)))
    return src, qs


def _warp(src, qs, K, fn):
    out = src
    for axis, q in qs:
        out = fn(out, q, 2 + axis, K)
    return out


def _launch_times(src, qs, K) -> dict:
    """One launch of each raw kernel against one pass of the plain version
    (forward; backward by autograd with the graph kept), mean over the three
    passes of the warp, ms."""
    times = {"fwd_ms": [], "plain_fwd_ms": [], "bwd_ms": [], "plain_bwd_ms": []}
    g = torch.ones_like(src)
    for axis, q in qs:
        q = q.contiguous()
        times["fwd_ms"].append(_time_ms(lambda: k1.sweep_fwd(src, q, 2 + axis, K)))
        times["bwd_ms"].append(_time_ms(lambda: k1.sweep_bwd(g, src, q, 2 + axis, K)))
        with torch.no_grad():
            times["plain_fwd_ms"].append(
                _time_ms(lambda: k1.sweep_plain(src, q, 2 + axis, K)))
        s = src.clone().requires_grad_(True)
        qq = q.clone().requires_grad_(True)
        out = k1.sweep_plain(s, qq, 2 + axis, K)[0]
        times["plain_bwd_ms"].append(_time_ms(
            lambda: torch.autograd.grad(out, (s, qq), g, retain_graph=True)))
        del out
    return {k: sum(v) / len(v) for k, v in times.items()}


def phase_times() -> list:
    """K1 against the plain version at the slice's shapes, CUDA events: one
    launch of each kernel (mean over the three axes), and one 3-pass warp
    through the autograd Function (wrapper included), forward and
    forward+backward."""
    plain = lambda s, q, d, K: k1.sweep_plain(s, q, d, K)[0]  # noqa: E731
    rows = []
    for S, K, dtype in ((60, 11, torch.bfloat16), (120, 6, torch.bfloat16),
                        (240, 8, torch.float32), (240, 80, torch.float32)):
        src, qs = _warp_case(S, K, dtype)
        row = {"S": S, "K": K, "dtype": str(dtype).replace("torch.", "")}
        row.update(_launch_times(src, qs, K))
        for name, fn in (("warp3", k1.sweep), ("plain_warp3", plain)):
            with torch.no_grad():
                row[f"{name}_fwd_ms"] = _time_ms(lambda: _warp(src, qs, K, fn))
            qg = [(a, q.clone().requires_grad_(True)) for a, q in qs]
            sg = src.clone().requires_grad_(True)
            g = torch.ones_like(src)

            def fwd_bwd():
                out = _warp(sg, qg, K, fn)
                torch.autograd.grad(out, [sg] + [q for _, q in qg], g)

            row[f"{name}_fwdbwd_ms"] = _time_ms(fwd_bwd)
        print(f"[times] {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def phase_k2_times() -> dict:
    """One K2 launch against one pass of ``warp_plain`` at 240³ (f32, one
    channel), CUDA events: affine mode with the selftest theta, flow mode
    with a smooth field of |flow| <= 8."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    src = torch.rand((1, SIZE, SIZE, SIZE), generator=gen, device=DEV)
    mt = _mt(rigid_theta(torch.tensor(SELFTEST_THETA, device=DEV))[None], (SIZE,) * 3)
    flow = _smooth_flow(SIZE, 8.0, 10)
    times = {}
    with torch.no_grad():
        for name, launch, plain in (
                ("warp_affine", lambda: k2.warp_affine_launch(src, mt),
                 lambda: k2.warp_plain(src, mt=mt)),
                ("warp_flow", lambda: k2.warp_flow_launch(src, flow),
                 lambda: k2.warp_plain(src, flow=flow))):
            times[name] = {"ms": _time_ms(launch), "plain_ms": _time_ms(plain, iters=5)}
    print(f"[times] K2 at 240³: {json.dumps(times)}", flush=True)
    return times


def main() -> None:
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_k2())
    launches = phase_main_path()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [launches, phase_cli(tmp)]
    reg_launches, reg_err = phase_register()
    paths.append(reg_launches)
    errs["warp_flow"] = max(errs["warp_flow"], reg_err)
    total = {name: sum(p.get(name, 0) for p in paths) for name in REPLACES}
    rows = phase_times()
    k2_times = phase_k2_times()
    # per-launch times at the fine flow level's shape (240³, K=8, f32)
    flow_row = next(r for r in rows if r["S"] == 240 and r["K"] == 8)
    times = {"sweep_fwd": {"ms": flow_row["fwd_ms"], "plain_ms": flow_row["plain_fwd_ms"]},
             "sweep_bwd": {"ms": flow_row["bwd_ms"], "plain_ms": flow_row["plain_bwd_ms"]},
             **k2_times}
    timed_at = {"sweep_fwd": "one launch, 240^3 K=8 f32, mean of axes 0-2",
                "warp_affine": "one launch, 240^3 f32, selftest rigid theta",
                "warp_flow": "one launch, 240^3 f32, smooth field |flow|<=8"}
    timed_at["sweep_bwd"] = timed_at["sweep_fwd"]
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], "timed_at": timed_at[name]}
        for name in REPLACES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
