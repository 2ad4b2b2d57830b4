"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds kernels K1 (the sweep resampler, ``torchregister_tpu_torch/csrc/
sweep.cu``), K2 (the exact trilinear warp, ``csrc/warp.cu``), K3 (the valid
3x3x3 convolution of the U-Net and the Sobel edge filter, ``csrc/conv3d.cu``),
K2b (the compact ROI gather of the exact warp's compact-block route,
``csrc/roigather.cu``) and the benchmark probes' kernels (``csrc/
hatgather.cu``: P1-P5 of ``benchmarks/probe_hatgather.py``; ``csrc/
roi_fetch.cu``: the fetch of ``benchmarks/probe_roi_stages.py``) from the
checkout, holds each against its plain PyTorch version on the card, drives
the port's paths with quality gates (the recipe cascade on the 240³ pairs;
the CLI's register/apply round trip on NIfTI files; ``Register`` rigid, then
flow; the U-Net parity cascade on the 240³ deformable pair, which must repeat
to the bit; ``Register`` in U-Net mode at the reference width; ``Register``
with the reference's default criteria and its exact warp on the compact
route; the matrix engines with their own defaults, edge filter and default
criteria; the two probe scripts' entry points), and times each kernel against its plain
version and the one PyTorch call that computes the same function, where
there is one. Any failure raises, so the exit code is non-zero.

    python3 chip_smoke.py

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels with their launches on the paths (counts
set to 0 just before each path and read just after), their largest absolute
deviation from the plain version over all checks, the time of one launch
against one pass of the plain version and of the library call, and the
least time the card could take for the same work (``bound_ms``: the bytes
the function must move over 3.35 TB/s, or its f32 operations over 67
TFLOP/s, whichever is larger).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from torchregister_tpu_torch import Register
from torchregister_tpu_torch.__main__ import main as cli
from torchregister_tpu_torch.engines.affine import affine_register
from torchregister_tpu_torch.engines.cascade import register_cascade
from torchregister_tpu_torch.engines.flow import flow_register
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.losses.nmi import branch_calls, nmi_loss
from torchregister_tpu_torch.ops import blocked
from torchregister_tpu_torch.ops.cuda import conv3d as k3
from torchregister_tpu_torch.ops.cuda import roigather as k2b
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.ops.edge import edge_filter, edge_magnitude
from torchregister_tpu_torch.ops.grid import affine_grid
from torchregister_tpu_torch.ops.resize import downsample_avg
from torchregister_tpu_torch.ops.separable import affine_to_index_map
from torchregister_tpu_torch.ops.transforms import rigid_theta
from torchregister_tpu_torch.probes import checked_index
from torchregister_tpu_torch.probes import hatgather as hg
from torchregister_tpu_torch.probes import roi_stages as rs
from torchregister_tpu_torch.synthetic import (
    RECIPE,
    RECIPE_UNET,
    cubic_resize,
    flow_truth_metrics,
    make_flow_truth_pair,
    make_pair,
    rmse_reduction_pct,
)
from torchregister_tpu_torch.utils import volio

# the plain versions compared with K3 run in cuDNN: full f32, no TF32
torch.backends.cudnn.allow_tf32 = False

DEV = "cuda"
GATES = dict(rmse_reduction_pct=98.5, flow_truth_rmse_reduction_pct=97.0,
             flow_field_err_observable_vox=0.6)
REPLACES = {
    "sweep_fwd": "torchregister_tpu/ops/pallas/sweep.py:38",
    "sweep_bwd": "torchregister_tpu/ops/pallas/sweep.py:134",
    "warp_affine": "torchregister_tpu/ops/pallas/roigather.py:145",
    "warp_flow": "torchregister_tpu/ops/pallas/roigather.py:145",
    # K3 serves both Pallas variants (A: whole planes, C: H strips), in the
    # forward and, on the padded cotangent, in the input gradient
    "conv3d_fwd": "torchregister_tpu/ops/pallas/conv3d.py:174",
    "conv3d_dgrad": "torchregister_tpu/ops/pallas/conv3d.py:174",
    "roigather": "torchregister_tpu/ops/pallas/roigather.py:49",
    # the benchmark probes: one kernel serves P2 and P4 (the same slab copy
    # at two slab sizes)
    "block_permute_add": "benchmarks/probe_hatgather.py:34",
    "slab_gather": "benchmarks/probe_hatgather.py:69",
    "slab_sum": "benchmarks/probe_hatgather.py:131",
    "slice_transpose": "benchmarks/probe_hatgather.py:270",
    "roi_fetch": "benchmarks/probe_roi_stages.py:69",
}
ALSO_REPLACES = {"conv3d_fwd": "torchregister_tpu/ops/pallas/conv3d.py:203",
                 "conv3d_dgrad": "torchregister_tpu/ops/pallas/conv3d.py:203",
                 "slab_gather": "benchmarks/probe_hatgather.py:222"}
SOURCES = {"sweep_fwd": "torchregister_tpu_torch/csrc/sweep.cu",
           "sweep_bwd": "torchregister_tpu_torch/csrc/sweep.cu",
           "warp_affine": "torchregister_tpu_torch/csrc/warp.cu",
           "warp_flow": "torchregister_tpu_torch/csrc/warp.cu",
           "conv3d_fwd": "torchregister_tpu_torch/csrc/conv3d.cu",
           "conv3d_dgrad": "torchregister_tpu_torch/csrc/conv3d.cu",
           "roigather": "torchregister_tpu_torch/csrc/roigather.cu",
           **{name: "torchregister_tpu_torch/csrc/hatgather.cu" for name in hg.KERNELS},
           "roi_fetch": "torchregister_tpu_torch/csrc/roi_fetch.cu"}
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory and
# f32 outside the tensor cores (the kernels sum in f32 FMAs, no TF32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The U-Net parity cascade's gates on the 240³ deformable-truth pair. The JAX
# package's TPU run read 68.55 % / 3.023 vox / 0.879 vox (BENCH_r05.json);
# the margin covers initial weights drawn from another random generator.
UNET_GATES = dict(unet_flow_truth_rmse_reduction_pct=62.0, unet_flow_field_err_vox=3.4,
                  unet_flow_field_err_observable_vox=1.1)
UNET_TPU = dict(unet_flow_truth_rmse_reduction_pct=68.55, unet_flow_field_err_vox=3.023,
                unet_flow_field_err_observable_vox=0.879)
# Adam at lr 0.3 on the U-Net's weights is chaotic: a last-bit difference
# in a gradient grows into another plateau stop. With atomic sums in K1's
# backward and in index_select's (and cuDNN free to pick a nondeterministic
# algorithm), 13 runs of one seed on an H100 spread over 63.1-76.3 %. Every
# sum on the path now runs in a fixed order, so two runs must agree to the
# bit (the first is the warm-up, the second the timed run), and the gates
# hold that one value.
UNET_RUNS = 2
# Register in U-Net mode at 240³ with the reference's width divisor n=32
# (depth 4, channels 2/4/8/16/32): SGD steps at the API's default lr
REGISTER_UNET_STEPS = 30
# Register rigid at 240³ (Adam from the identity, the cascade's coarse
# window S/4): 150 steps at lr 1e-2 reach 99.97 % on make_pair (H100)
REGISTER_RIGID = dict(lr=1e-2, max_epochs=150)
# The CLI cascade's flow-stage lr. Its default, 0.3, reaches 97.49 % on the
# 240³ rigid pair: the CLI runs the flow stage without a plateau stop, and
# Adam's near-full steps in the flat background move the field where the
# exact final warp then samples. 0.1 reaches 99.12 % (H100).
CLI_FLOW_LR = "0.1"
SIZE = 240  # the user path's volumes: make_pair's published size
# make_pair's rigid transform (synthetic.make_pair), whose 10³ output tiles
# each fit a 16³ source window of the ROI route
PAIR_RIGID = (0.06, -0.04, 0.05, 0.2, -0.15, 0.1)
# the matrix engines with their own defaults (grad_edges=True, the default
# criteria, SGD at lr 1e-5, rigid from a random init): steps of each engine
ENGINE_STEPS = 30
# nmi_loss on the card against the CPU at the default stack's shapes (the
# 240³ image resized to 200³, 8 patches of 100³, 16 M samples splatted) at
# the tolerances of tests/test_torch_cuda.py. The loss is 1000 |NMI - 1| and
# the reference's pooled "joint" makes NMI 1 wherever the two marginals
# match: for the pair itself at the default bandwidth 3.0, another order of
# the splat's sums (the card's atomics) moves the value and the gradient by
# percents. So the check pairs the target with the square of the moving
# image, whose marginals differ, at a bandwidth that resolves the unit range.
NMI_CHECK = dict(bandwidth=0.05, value_rtol=3e-5, grad_atol=3e-4)


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
    """Every kernel's nvcc run at once, then load them."""
    t0 = time.perf_counter()
    mods = (k1, k2, k3, k2b, hg, rs)
    with ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.build(), mods))
    for m in mods:
        m._lib()
    print(f"[build] K1, K2, K3, K2b and the probes built in "
          f"{time.perf_counter() - t0:.2f} s -> "
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


def unet_conv_shapes(edge: int, n: float, depth: int, in_c: int = 1) -> list:
    """``(Ci, Co, input edge)`` of every 3x3x3 convolution of the U-Net's
    forward on a cube of ``edge`` voxels (``models/attention_unet.py``:
    each double conv eats 4 voxels, max pooling halves, a decoder level
    convolves at its skip's size)."""
    ch = [max(1, int(64 * 2**i / n)) for i in range(depth + 1)]
    out, skips, s, c = [], [], edge, in_c
    for i in range(depth):
        out += [(c, ch[i], s), (ch[i], ch[i], s - 2)]
        s -= 4
        skips.append(s)
        s //= 2
        c = ch[i]
    out += [(c, ch[depth], s), (ch[depth], ch[depth], s - 2)]
    for j in range(depth - 1, -1, -1):
        out += [(2 * ch[j], ch[j], skips[j]), (ch[j], ch[j], skips[j] - 2)]
    return out


# the U-Net cascade's 120³ flow level (n=8, depth 2) and Register's 240³
# network (n=32, depth 4), the latter checked on z-slabs of 10 planes
K3_CASES = ([(ci, co, e, None) for ci, co, e in unet_conv_shapes(120, 8, 2)]
            + [(ci, co, e, 10) for ci, co, e in unet_conv_shapes(240, 32, 4)])
# the Sobel filter of the engines' grad_edges: 1 -> 9 channels on the
# reflect-padded 240³ image, f32 only (the second chunk of output channels
# holds one channel), on a z-slab of 10 planes as the 240³ net: over the whole
# volume dw sums 14 M products an entry and sits 1.01e-5 from cuDNN's (H100).
# The path runs the forward alone, held whole against the CPU in
# [engines-default].
K3_EDGE_CASE = (1, 9, SIZE + 2, 10)


def _check_k3(ci, co, edge, slab, dtype) -> tuple[float, float]:
    """K3's forward launch, then the autograd Function's dx (K3 on the padded
    cotangent) and dw (torch contractions), against the plain version and
    autograd through it (cuDNN with TF32 off). Each error is relative to the
    largest reference value; f32 tolerance 1e-5 (summation order), bf16 one
    bf16 rounding (2^-7 of the largest value: both sum in f32 and round once).
    Returns the largest absolute deviations, forward and dx."""
    gen = torch.Generator(device=DEV).manual_seed(1000 * ci + 10 * co + edge)
    z = edge if slab is None else slab
    x = torch.randn((1, ci, z, edge, edge), generator=gen, device=DEV).to(dtype)
    w = (torch.randn((3, 3, 3, ci, co), generator=gen, device=DEV)
         / math.sqrt(27 * ci)).to(dtype)
    g = torch.randn((1, co, z - 2, edge - 2, edge - 2), generator=gen, device=DEV).to(dtype)
    out, ref = k3.conv_launch(x, w), k3.conv3x3x3_plain(x, w)
    grads = []
    for fn in (k3.conv3x3x3, k3.conv3x3x3_plain):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xs, ws), (xs, ws), g))
    torch.cuda.synchronize()
    (dx, dw), (rdx, rdw) = grads
    rel = (_rel_err(out, ref), _rel_err(dx, rdx), _rel_err(dw, rdw))
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    label = (f"{ci}->{co} edge {edge}{'' if slab is None else f' (z-slab {slab})'} "
             f"{str(dtype).replace('torch.', '')}")
    print(f"[k3] {label}: rel fwd {rel[0]:.3e}, dx {rel[1]:.3e}, dw {rel[2]:.3e} "
          f"(tol {tol:g})", flush=True)
    if out.dtype != dtype or dx.dtype != dtype or not max(rel) < tol:
        raise AssertionError(f"K3 {label} disagrees with the plain version: {rel}")
    return _max_err(out, ref), _max_err(dx, rdx)


def phase_k3() -> dict:
    """K3 against its plain version at every convolution of both U-Net
    paths, f32 and bf16, and at the edge filter's, f32."""
    cases = [(c, dtype) for c in K3_CASES for dtype in (torch.float32, torch.bfloat16)]
    fwd = dgrad = 0.0
    for case, dtype in cases + [(K3_EDGE_CASE, torch.float32)]:
        f, d = _check_k3(*case, dtype)
        fwd, dgrad = max(fwd, f), max(dgrad, d)
    return {"conv3d_fwd": fwd, "conv3d_dgrad": dgrad}


def _pair_theta() -> torch.Tensor:
    return rigid_theta(torch.tensor(PAIR_RIGID, device=DEV))[None]


def _check_k2b(label, vol, scal) -> float:
    """One raw K2b launch against its plain version on the same tensors: a
    copy, so the difference must be exactly 0."""
    out, ref = k2b.roigather_launch(vol, scal), k2b.roigather_plain(vol, scal)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    print(f"[k2b] {label}: T={scal.shape[0]}, max|d| {err:.3e} (tol 0)", flush=True)
    if err != 0.0 or tuple(out.shape) != (scal.shape[0], k2b.CW, k2b.AW * k2b.BW):
        raise AssertionError(f"K2b {label} disagrees with its plain version: {err:.3e}")
    return err


def _roi_scalars(theta, spatial):
    sup = blocked._roi_supports(theta[0].double().cpu().numpy(), spatial, False)
    return torch.from_numpy(sup[0]).to(DEV)


def phase_k2b() -> dict:
    """K2b against its plain version at 240³ on make_pair's moving image with
    the windows of make_pair's rigid transform, on ragged shapes, and on
    scalars whose windows leave the volume; then the compact route against
    K2 (``warp_affine_fast`` with the route off) at 240³, tolerance 1e-5 of
    the largest value; and a transform the route declines."""
    moving, _ = make_pair((SIZE,) * 3, device=DEV)
    theta = _pair_theta()
    errs = [_check_k2b(f"{SIZE}³ make_pair", moving[0, 0], _roi_scalars(theta, (SIZE,) * 3))]
    gen = torch.Generator(device=DEV).manual_seed(12)
    for shape in ((45, 50, 41), (33, 40, 37)):
        vol = torch.rand(shape, generator=gen, device=DEV)
        errs.append(_check_k2b(f"{'x'.join(map(str, shape))}", vol, _roi_scalars(theta, shape)))
    vol = torch.rand((40, 36, 44), generator=gen, device=DEV)
    wild = torch.randint(-3, 6, (500, 5), generator=gen, device=DEV, dtype=torch.int32)
    wild[:, 4] = torch.randint(-20, 44, (500,), generator=gen, device=DEV, dtype=torch.int32)
    errs.append(_check_k2b("40x36x44 windows past every face (zeros)", vol, wild))

    ref = blocked.warp_affine_fast(theta, moving)  # K2: the route is off by default
    out = blocked.warp_affine_roi(theta, moving)  # the compact route: K2b and the hats
    torch.cuda.synchronize()
    rel = _rel_err(out, ref)
    print(f"[k2b] compact route vs K2 at {SIZE}³: rel {rel:.3e} (tol 1e-5)", flush=True)
    if out is None or not rel < 1e-5:
        raise AssertionError(f"the compact route disagrees with K2: {rel:.3e}")
    zoom = torch.tensor([[[2.0, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, 2.0, 0]]], device=DEV)
    if blocked.warp_affine_roi(zoom, moving) is not None:
        raise AssertionError("the ROI route took a 2x zoom, whose support outgrows its windows")
    print("[k2b] a 2x zoom: the route declines (None)", flush=True)
    return {"roigather": max(errs)}


def _probe_inputs() -> dict:
    """Each probe kernel's inputs at the probe's own sizes, index data
    checked on the host and put on the card: ``{name: (args, atol)}``. P2's
    and P4's slabs include the last valid origin; P3's 13824 origins (240³
    bench fetch) come with the last valid one and (0, 0) appended, the
    fetch's scalars (240³, the probe's theta) with the last valid block
    origin appended. The copies must match to the bit; the sums at their
    stated atol (``hg.P3_ATOL``, ``rs.FETCH_ATOL``)."""
    dev = torch.device(DEV)
    gen = torch.Generator().manual_seed(0)
    x = torch.arange(16 * 256, dtype=torch.float32, device=dev).reshape(16, 256)
    vol64 = torch.rand((64, 64, 256), generator=gen).to(dev)
    p2 = [[3, 5], [11, 0], [0, 23], [9, 9], [64 - 14, 64 - 16], [17, 31]]
    p4 = [[3, 5], [11, 0], [0, 23], [9, 9], [64 - 16, 64 - 16]]
    vol240 = torch.rand((SIZE, SIZE, 256), generator=gen).to(dev)
    T = (SIZE // 10) ** 3
    p3 = np.concatenate([hg.p3_origins(SIZE, T), [[SIZE - 14, SIZE - 16], [0, 0]]])
    slab = torch.rand((32, 32, 256), generator=gen).to(dev)
    p5 = [[0, 0, 3], [9, 13, 240 - 16], [18, 16, 0], [18, 16, 240]]
    _, _, scal, volp = rs.stage_inputs(SIZE, dev)
    last = volp.shape[0] // rs.QB - rs.NB
    scal = np.concatenate([scal, [[last, last, 0, 0, 0]]]).astype(np.int32)

    def orgs(o, B, vol):
        return checked_index(o, (0, 1), (vol.shape[0] - B[0], vol.shape[1] - B[1]), "orgs", dev)

    return {
        "block_permute_add": ((x, checked_index([1, 0], (0,), (1,), "order", dev)[:, 0]), 0.0),
        "slab_gather": ((vol64, orgs(p2, (14, 16), vol64), 14, 16), 0.0),
        "slab_gather_p4": ((vol64, orgs(p4, (16, 16), vol64), 16, 16), 0.0),
        "slab_sum": ((vol240, orgs(p3, (14, 16), vol240), 14, 16), hg.P3_ATOL),
        "slice_transpose": ((slab, checked_index(p5, (0, 1, 2), (18, 16, 240), "starts", dev),
                             14, 16, 16, 256), 0.0),
        "roi_fetch": ((volp, rs.check_scalars(volp, scal)), rs.FETCH_ATOL),
    }


PROBE_FNS = {"block_permute_add": (hg.block_permute_add_launch, hg.block_permute_add_plain),
             "slab_gather": (hg.slab_gather_launch, hg.slab_gather_plain),
             "slab_gather_p4": (hg.slab_gather_launch, hg.slab_gather_plain),
             "slab_sum": (hg.slab_sum_launch, hg.slab_sum_plain),
             "slice_transpose": (hg.slice_transpose_launch, hg.slice_transpose_plain),
             "roi_fetch": (rs.roi_fetch_launch, rs.roi_fetch_plain)}


def phase_probes(inputs: dict) -> tuple[dict, dict]:
    """Each probe kernel against its plain version at the probe's own sizes
    (``_probe_inputs``); then the path: both probe modules' ``main`` (P1-P5, and
    the ROI stages at 240³), counts set to 0 just before and read just
    after. Returns the largest deviations and the path's launches."""
    errs = {}
    for case, (args, atol) in inputs.items():
        launch, plain = PROBE_FNS[case]
        out, ref = launch(*args), plain(*args)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        name = "slab_gather" if case == "slab_gather_p4" else case
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"[probes] {case}: out {tuple(out.shape)}, max|d| {err:.3e} (tol {atol:g})",
              flush=True)
        if out.shape != ref.shape or not err <= atol:
            raise AssertionError(f"{case} disagrees with its plain version: {err:.3e}")
    _reset_counts()
    hg.main(["p1", "p2", "p3", "p4", "p5"])
    rs.main()
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[probes] the probe entry points' launches: {json.dumps(launches)}", flush=True)
    _need(launches, (*hg.KERNELS, "roi_fetch", "roigather", "warp_affine"),
          "the probe entry points")
    return errs, launches


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
            "warp_affine": k2.affine_launches, "warp_flow": k2.flow_launches,
            "conv3d_fwd": k3.fwd_launches, "conv3d_dgrad": k3.dgrad_launches,
            "roigather": k2b.launches, **hg.launches, "roi_fetch": rs.launches}


def _reset_counts() -> None:
    for m in (k1, k2, k3, k2b, hg, rs):
        m.reset_counts()


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


def _level_ms_per_step(moving, target, steps: int = 20) -> list:
    """ms per U-Net optimizer step at each flow level of RECIPE_UNET on the
    240³ pair (halved to 120³, then 60³ and 120³), fresh net with a zero
    head, Adam, all ``steps`` steps; host clock around a synchronised run."""
    mov, tgt = downsample_avg(moving, 2), downsample_avg(target, 2)
    out = []
    for m, t in ((downsample_avg(mov, 2), downsample_avg(tgt, 2)), (mov, tgt)):
        kw = dict(lr=RECIPE_UNET["flow_lr"], criterions=list(RECIPE_UNET["criterions"]),
                  optimizer="adam", n=RECIPE_UNET["n"], depth=2, zero_head=True,
                  stop_crit=float("-inf"), check_disp=False)
        flow_register(m, t, max_epochs=2, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow_register(m, t, max_epochs=steps, **kw)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / steps)
    return out


def phase_unet() -> dict:
    """The U-Net parity cascade (RECIPE_UNET) on the 240³ deformable-truth
    pair, ``UNET_RUNS`` times (the first is the warm-up, the second the timed
    run), which must give the same steps, flow and quality fields to the bit,
    gated on that quality; then the matrix stages alone on the same pair, the
    floor a working U-Net must clearly beat."""
    fmov, ftgt, theta_true, flow_true = make_flow_truth_pair(device=DEV)
    names = list(UNET_GATES)
    runs = []
    _reset_counts()
    for i in range(UNET_RUNS):
        t0 = time.perf_counter()
        res = register_cascade(fmov, ftgt, **RECIPE_UNET)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _on_cuda(res)
        _finite(res, tuple(fmov.shape))
        q = dict(zip(names, flow_truth_metrics(res, fmov, ftgt, theta_true, flow_true)))
        runs.append((res.steps, res.flow, q))
        print(f"[unet] run {i}{' (warm-up)' if i == 0 else ''}: {wall:.3f} s, steps "
              f"{res.steps}; {json.dumps(q)}", flush=True)
    launches = _counts()
    steps, flow, quality = runs[0]
    repeat = all(st == steps and torch.equal(fl, flow) and q == quality for st, fl, q in runs)
    print(f"[unet] {UNET_RUNS} runs equal to the bit (steps, flow, quality): {repeat}",
          flush=True)
    if not repeat:
        raise AssertionError("the U-Net cascade does not repeat to the bit from one seed")
    floor_res = register_cascade(fmov, ftgt, **{**RECIPE_UNET, "stages": ("rigid", "affine")})
    floor = dict(zip(names, flow_truth_metrics(floor_res, fmov, ftgt, theta_true, flow_true)))
    ms = _level_ms_per_step(fmov, ftgt)
    print(f"[unet] flow ms/step at 60³, 120³: {ms[0]:.2f}, {ms[1]:.2f}", flush=True)
    print(f"[unet] quality: {json.dumps(quality)}", flush=True)
    print(f"[unet] the JAX package on the TPU: {json.dumps(UNET_TPU)}; gates "
          f"{json.dumps(UNET_GATES)}", flush=True)
    print(f"[unet] matrix stages alone (no flow): {json.dumps(floor)}", flush=True)
    print(f"[unet] launches: {json.dumps(launches)}", flush=True)
    _need(launches, ("sweep_fwd", "sweep_bwd", "conv3d_fwd", "conv3d_dgrad"), "the U-Net cascade")
    if quality["unet_flow_truth_rmse_reduction_pct"] < UNET_GATES[
            "unet_flow_truth_rmse_reduction_pct"]:
        raise AssertionError(f"U-Net deformable gate failed: {quality}")
    for k in ("unet_flow_field_err_vox", "unet_flow_field_err_observable_vox"):
        if quality[k] > UNET_GATES[k]:
            raise AssertionError(f"U-Net map error gate {k} failed: {quality}")
    if not quality["unet_flow_truth_rmse_reduction_pct"] > floor[
            "unet_flow_truth_rmse_reduction_pct"] + 5.0:
        raise AssertionError(f"the U-Net does not beat the matrix stages alone: "
                             f"{quality} vs {floor}")
    return launches


def phase_register_unet() -> dict:
    """``Register(mode='flow', flow_model='unet')`` at 240³ with ``n=32``
    (depth 4): a finite flow of the volume's shape, ms per step, K3."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    reg = Register(mode="flow", flow_model="unet", device=DEV, criterion=["mse", "ncc"])
    reg.optim(moving, target, max_epochs=2, n=32)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    # stop_crit -inf: every step runs
    reg.optim(moving, target, max_epochs=REGISTER_UNET_STEPS, n=32, stop_crit=float("-inf"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = reg(moving)
    torch.cuda.synchronize()
    launches = _counts()
    depth = sum(1 for k in reg.result.params if k.startswith("enc") and k.endswith(
        "Conv_0.kernel"))
    steps = int(reg.result.steps)
    losses = reg.losses[:steps].cpu().numpy()
    print(f"[register-unet] n=32 depth {depth}: {steps} steps in {t1 - t0:.2f} s "
          f"({1e3 * (t1 - t0) / steps:.1f} ms/step), loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches {json.dumps(launches)}", flush=True)
    if tuple(reg.theta.shape) != (1, 3) + (SIZE,) * 3 or not bool(
            torch.isfinite(reg.theta).all()) or not bool(torch.isfinite(out).all()):
        raise AssertionError("Register U-Net flow or output is not finite of the right shape")
    if depth != 4 or steps != REGISTER_UNET_STEPS:
        raise AssertionError(f"Register U-Net ran depth {depth}, {steps} steps")
    _need(launches, ("conv3d_fwd", "conv3d_dgrad", "warp_flow"), "Register U-Net")
    return launches


def phase_register_default() -> dict:
    """``Register(mode='rigid')`` with ``criterion=None`` (MSE + NCC(100) +
    NMI(1000)) at 240³, its exact warp on the compact ROI route (K2b and
    the hats), with the [register] phase's lr and epochs under Adam from the
    identity; the NMI branches the run took; then ``nmi_loss`` on the pair
    on the card against the CPU (``NMI_CHECK``)."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    routes = blocked.ROIGATHER_ENABLED, blocked.ROIGATHER_FUSED
    blocked.ROIGATHER_ENABLED, blocked.ROIGATHER_FUSED = True, False
    try:
        kw = dict(mode="rigid", device=DEV, criterion=None, optimizer="adam",
                  init="identity", max_shift=SIZE // 4)
        Register(**kw).optim(moving, target, **dict(REGISTER_RIGID, max_epochs=3))  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        branch_calls.update(binned=0, exact=0)
        t0 = time.perf_counter()
        reg = Register(**kw).optim(moving, target, **REGISTER_RIGID)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = reg(moving)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _counts()
        branches = dict(branch_calls)
    finally:
        blocked.ROIGATHER_ENABLED, blocked.ROIGATHER_FUSED = routes
    steps = int(reg.result.steps)
    pct = rmse_reduction_pct(out, moving, target)
    print(f"[register-default] criterion=None, {REGISTER_RIGID}: {steps} steps in "
          f"{t1 - t0:.2f} s ({1e3 * (t1 - t0) / steps:.2f} ms/step), NMI branch calls "
          f"{json.dumps(branches)}; "
          f"__call__ on the compact route {1e3 * (t2 - t1):.1f} ms; RMSE reduction "
          f"{pct:.3f} % (gate {GATES['rmse_reduction_pct']}); launches "
          f"{json.dumps(launches)}", flush=True)
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != tuple(moving.shape):
        raise AssertionError("Register's default-criteria output is not finite")
    if pct < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"Register default-criteria RMSE gate failed: {pct:.3f} %")
    _need(launches, ("sweep_fwd", "sweep_bwd", "roigather"), "Register with criterion=None")
    if sum(branches.values()) < steps:
        raise AssertionError(f"the default criteria ran NMI {branches} times in {steps} steps")
    _check_nmi(target, moving)
    return launches


def _check_nmi(y, yp) -> None:
    """``nmi_loss(y, yp²)`` and its gradient in ``yp²`` on the card against
    the CPU at ``NMI_CHECK``'s bandwidth (binned: the atomic splat of 16 M
    samples) and tolerances; ``nmi_loss(y, yp)`` at the default bandwidth,
    the term the run optimized, printed from both."""
    bw = NMI_CHECK["bandwidth"]
    out = []
    for d in (DEV, "cpu"):
        branch_calls.update(binned=0, exact=0)
        p = (yp * yp).to(d).requires_grad_(True)
        loss = nmi_loss(y.to(d), p, bandwidth=bw)
        loss.backward()
        with torch.no_grad():
            default = float(nmi_loss(y.to(d), yp.to(d)))
        out.append((float(loss.detach()), p.grad.cpu(), dict(branch_calls), default))
    (lg, gg, bg, dg), (lc, gc, bc, dc) = out
    rel = abs(lg - lc) / abs(lc)
    grel = _max_err(gg, gc) / float(gc.abs().max())
    print(f"[register-default] nmi_loss(target, moving²) at {SIZE}³ (patch 100), bandwidth "
          f"{bw}: card {lg:.7f}, "
          f"CPU {lc:.7f}, rel {rel:.3e} (tol {NMI_CHECK['value_rtol']:g}); gradient "
          f"{grel:.3e} of its largest entry (tol {NMI_CHECK['grad_atol']:g}); branches "
          f"{json.dumps(bg)}; at the default bandwidth 3.0: card {dg:.3e}, CPU {dc:.3e}",
          flush=True)
    if bg != bc or not bg["binned"]:
        raise AssertionError(f"nmi_loss took other branches on the card: {bg} vs {bc}")
    if not (rel < NMI_CHECK["value_rtol"] and grel < NMI_CHECK["grad_atol"]):
        raise AssertionError(f"nmi_loss on the card disagrees with the CPU: {rel:.3e}, {grel:.3e}")
    if not (math.isfinite(dg) and math.isfinite(dc)):
        raise AssertionError(f"nmi_loss at the default bandwidth is not finite: {dg}, {dc}")


def phase_engines_default() -> dict:
    """``rigid_register`` and ``affine_register`` at 240³ with their own
    defaults (``grad_edges=True``: both images through the Sobel filter on
    K3; ``criterions=None``; SGD at lr 1e-5; rigid from a seeded random
    init), ``ENGINE_STEPS`` steps each: finite losses, every step run; then
    the Sobel filter of the moving image on the card against the CPU."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    _reset_counts()
    rows = {}
    for name, fn, kw in (
            ("rigid", rigid_register,
             dict(generator=torch.Generator(device=DEV).manual_seed(0))),
            ("affine", affine_register, {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warped, res = fn(moving, target, epochs=ENGINE_STEPS, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = res.losses[:res.steps].cpu().numpy()
        rows[name] = dict(steps=res.steps, s=round(dt, 3),
                          ms_per_step=round(1e3 * dt / res.steps, 2),
                          loss_first=float(losses[0]), loss_last=float(losses[-1]))
        if res.steps != ENGINE_STEPS or not np.isfinite(losses).all() or not bool(
                torch.isfinite(warped).all()):
            raise AssertionError(f"{name}_register with its defaults: {rows[name]}")
    launches = _counts()
    print(f"[engines-default] {json.dumps(rows)} (wall time includes the edge filter of "
          f"both images); launches {json.dumps(launches)}", flush=True)
    _need(launches, ("sweep_fwd", "sweep_bwd", "conv3d_fwd"), "the engines' defaults")
    _check_edges(moving)
    return launches


def _check_edges(img) -> None:
    """``edge_magnitude`` and ``edge_filter`` of ``img`` on the card (K3)
    against the same calls on the CPU (the plain convolution): the magnitude
    at rtol 1e-5 and atol 1e-5, the mask equal everywhere but within 1e-5 of
    a threshold, where a rounding flips a voxel. The atol: each Sobel
    response sums 27 f32 products (sum of |weights| 32 on a unit-range
    image) and cancels where it is small, so its rounding, over the
    magnitude's range, reaches ~1e-6 where no relative bound holds (2.2e-6
    at 240³, H100)."""
    mag, ref = edge_magnitude(img).cpu(), edge_magnitude(img.cpu())
    mask, ref_mask = edge_filter(img).cpu(), edge_filter(img.cpu())
    off = int((~torch.isclose(mag, ref, rtol=1e-5, atol=1e-5)).sum())
    near = ((ref - 0.2).abs() <= 1e-5) | ((ref - 0.9).abs() <= 1e-5)
    flips = int(((mask != ref_mask) & ~near).sum())
    print(f"[engines-default] edge filter at {SIZE}³, card vs CPU: magnitude max|d| "
          f"{_max_err(mag, ref):.3e}, {off} voxels past rtol and atol 1e-5; mask share "
          f"{float(mask.mean()):.4f}, {flips} flips away from the thresholds "
          f"({int(near.sum())} voxels within 1e-5 of one)", flush=True)
    if off or flips or not 0.0 < float(ref_mask.mean()) < 1.0:
        raise AssertionError(f"the edge filter on the card disagrees with the CPU: {off} "
                             f"magnitudes, {flips} mask voxels")


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


def phase_k3_times() -> dict:
    """One K3 forward and one dgrad launch, and one dw (``k3.wgrad``), against
    the plain version (cuDNN with TF32 off: ``F.conv3d``,
    ``torch.nn.grad.conv3d_input`` and ``conv3d_weight``) at two of the
    U-Net cascade's 120³-level shapes, f32, CUDA events."""
    rows = {}
    for ci, co, edge in ((8, 8, 118), (32, 16, 54)):
        gen = torch.Generator(device=DEV).manual_seed(ci + co + edge)
        x = torch.randn((1, ci, edge, edge, edge), generator=gen, device=DEV)
        w = torch.randn((3, 3, 3, ci, co), generator=gen, device=DEV) / math.sqrt(27 * ci)
        g = torch.randn((1, co) + (edge - 2,) * 3, generator=gen, device=DEV)
        gp = torch.nn.functional.pad(g, (2, 2) * 3)
        w_t = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        with torch.no_grad():
            row = {"fwd_ms": _time_ms(lambda: k3.conv_launch(x, w)),
                   "plain_fwd_ms": _time_ms(lambda: torch.nn.functional.conv3d(x, wt)),
                   "dgrad_ms": _time_ms(lambda: k3.conv_launch(gp, w_t, dgrad=True)),
                   "plain_dgrad_ms": _time_ms(
                       lambda: torch.nn.grad.conv3d_input(x.shape, wt, g)),
                   "dw_ms": _time_ms(lambda: k3.wgrad(x, g)),
                   "plain_dw_ms": _time_ms(
                       lambda: torch.nn.grad.conv3d_weight(x, wt.shape, g))}
        rows[f"{ci}->{co} edge {edge}"] = row
        print(f"[times] K3 {ci}->{co} edge {edge} f32: {json.dumps(row)}", flush=True)
    return rows


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its f32 operations over the
    f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_k2b_times() -> dict:
    """One K2b launch at 240³ with make_pair's rigid windows (T = 13824)
    against its plain version and one advanced-indexing gather with the
    indices made beforehand (the library call); then the compact route end
    to end (K2b and the hat einsums, host work included) against K2 on the
    same transform. CUDA events."""
    moving, _ = make_pair((SIZE,) * 3, device=DEV)
    vol = moving[0, 0].contiguous()
    theta = _pair_theta()
    scal = _roi_scalars(theta, (SIZE,) * 3)
    s = scal.long()
    ab = torch.arange(k2b.AW * k2b.BW, device=DEV)
    flat = ((((8 * s[:, 0] + s[:, 2])[:, None, None] + ab // k2b.BW) * SIZE
             + (8 * s[:, 1] + s[:, 3])[:, None, None] + ab % k2b.BW) * SIZE
            + s[:, 4][:, None, None] + torch.arange(k2b.CW, device=DEV)[None, :, None])
    with torch.no_grad():
        row = {"ms": _time_ms(lambda: k2b.roigather_launch(vol, scal)),
               "plain_ms": _time_ms(lambda: k2b.roigather_plain(vol, scal), iters=5),
               "library_ms": _time_ms(lambda: torch.take(vol, flat)),
               "route_ms": _time_ms(lambda: blocked.warp_affine_roi(theta, moving), iters=5),
               "k2_same_theta_ms": _time_ms(lambda: blocked.warp_affine_fast(theta, moving))}
    T = scal.shape[0]
    row.update(_bound(4.0 * (vol.numel() + T * k2b.CW * k2b.AW * k2b.BW) + scal.numel() * 4, 0))
    print(f"[times] K2b at {SIZE}³, T={T}: {json.dumps(row)}", flush=True)
    return row


def _touched_rows(orgs: np.ndarray, Bz: int, By: int, Z: int, Y: int) -> int:
    """The (z, y) rows of a [Z, Y, X] volume that slabs (Bz, By) at ``orgs``
    read: the input the function needs, each row once."""
    mask = np.zeros((Z, Y), bool)
    for z, y in orgs:
        mask[z:z + Bz, y:y + By] = True
    return int(mask.sum())


def phase_probe_times(inputs: dict) -> dict:
    """One launch of each probe kernel against one pass of its plain
    version and, for the copies (P2, P4, P5), one ``torch.take`` with the
    indices made beforehand (P5's on the slab with a zero appended for the
    empty lanes), at the probe's own sizes (``_probe_inputs``), CUDA events.
    Bounds: the bytes the function needs (each row or block it reads once,
    its output written once) over 3.35 TB/s; P1, P2, P4 and P5 move a few MB
    at most, so their real floor is the launch itself (a few microseconds).
    P1, P3 and the fetch have no one PyTorch call that computes them."""
    rows = {}
    for case, (args, _) in inputs.items():
        launch, plain = PROBE_FNS[case]
        with torch.no_grad():
            rows[case] = {"ms": _time_ms(lambda: launch(*args)),
                          "plain_ms": _time_ms(lambda: plain(*args), iters=3),
                          "library_ms": None}
    takes = {}
    for case in ("slab_gather", "slab_gather_p4"):
        vol, orgs, Bz, By = inputs[case][0]
        z, y = hg._slab_index(orgs, Bz, By)
        flat = ((z[..., None] * vol.shape[1] + y[..., None]) * vol.shape[2]
                + torch.arange(vol.shape[2], device=DEV))
        takes[case] = (vol, flat)
    slab, starts, Bz, By, CW, lanes = inputs["slice_transpose"][0]
    s = starts.long()
    r = torch.arange(lanes, device=DEV)
    flat = (((s[:, 0, None] + r // By) * slab.shape[1] + s[:, 1, None] + r % By)[:, None, :]
            * slab.shape[2] + s[:, 2, None, None] + torch.arange(CW, device=DEV)[None, :, None])
    flat = torch.where(r < Bz * By, flat, slab.numel())  # the appended zero
    takes["slice_transpose"] = (torch.cat([slab.flatten(), torch.zeros(1, device=DEV)]), flat)
    for case, (src, flat) in takes.items():
        # the library call computes the same function: the same values
        if not torch.equal(torch.take(src, flat), PROBE_FNS[case][0](*inputs[case][0])):
            raise AssertionError(f"torch.take does not compute {case}")
        rows[case]["library_ms"] = _time_ms(lambda: torch.take(src, flat))

    def slab_bytes(case, out_rows):
        vol, orgs, Bz, By = inputs[case][0][:4]
        o = orgs.cpu().numpy()
        need = _touched_rows(o, Bz, By, *vol.shape[:2]) * vol.shape[2]
        return 4.0 * (need + o.shape[0] * out_rows * vol.shape[2] + o.size)

    x, order = inputs["block_permute_add"][0]
    bounds = {"block_permute_add": 4.0 * (order.numel() * 8 * x.shape[1] * 2 + order.numel()),
              "slab_gather": slab_bytes("slab_gather", 14 * 16),
              "slab_gather_p4": slab_bytes("slab_gather_p4", 16 * 16),
              "slab_sum": slab_bytes("slab_sum", 8)}
    # P5 reads each window element once (distinct ones counted) and writes
    # [T, CW, lanes]
    touched = np.zeros(tuple(slab.shape), bool)
    for dz, dy, ox in s.cpu().numpy():
        touched[dz:dz + Bz, dy:dy + By, ox:ox + CW] = True
    bounds["slice_transpose"] = 4.0 * (touched.sum() + s.shape[0] * (CW * lanes + 3))
    volp, scal = inputs["roi_fetch"][0]
    sc = scal.cpu().numpy()
    blocks = np.zeros((volp.shape[0] // rs.QB, volp.shape[1] // rs.QB), bool)
    for zq, yq in sc[:, :2]:
        blocks[zq:zq + rs.NB, yq:yq + rs.NB] = True
    bounds["roi_fetch"] = 4.0 * (blocks.sum() * rs.QB * rs.QB * volp.shape[2]
                                 + sc.shape[0] * (rs.LANES + 5))
    for case, nbytes in bounds.items():
        rows[case].update(_bound(nbytes, 0.0), bytes=nbytes)
    T = inputs["slab_sum"][0][1].shape[0]
    logical = T * 14 * 16 * 256 * 4.0
    rows["slab_sum"]["logical_TBps"] = logical / (rows["slab_sum"]["ms"] * 1e9)
    T = sc.shape[0]
    logical = T * 9 * rs.QB * rs.QB * volp.shape[2] * 4.0
    rows["roi_fetch"]["logical_TBps"] = logical / (rows["roi_fetch"]["ms"] * 1e9)
    for case, row in rows.items():
        print(f"[times] probe {case}: {json.dumps(row)}", flush=True)
    return rows


def _library_times() -> dict:
    """The one PyTorch call that computes each kernel's function, where there
    is one, at the shapes of the kernel's own timing: ``F.grid_sample``
    (trilinear, zeros padding, on a grid made beforehand) for K2's two modes;
    cuDNN with TF32 off for K3's forward and input gradient (the same calls
    as K3's plain version). K1's windowed 1-D resample along one axis has
    none: ``grid_sample`` does not zero a tap past the window."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(9)
    src = torch.rand((1, 1) + (SIZE,) * 3, generator=gen, device=DEV)
    theta = rigid_theta(torch.tensor(SELFTEST_THETA, device=DEV))[None]
    grid_a = affine_grid(theta, (SIZE,) * 3)
    flow = _smooth_flow(SIZE, 8.0, 10)
    o = torch.arange(SIZE, dtype=torch.float32, device=DEV)
    idx = torch.stack(torch.meshgrid(o, o, o, indexing="ij")) + flow
    grid_f = ((2.0 * idx + 1.0) / SIZE - 1.0).flip(0).permute(1, 2, 3, 0)[None].contiguous()
    with torch.no_grad():
        out = {n: _time_ms(lambda g=g: F.grid_sample(src, g, mode="bilinear",
                                                      padding_mode="zeros",
                                                      align_corners=False))
               for n, g in (("warp_affine", grid_a), ("warp_flow", grid_f))}
    return out


def main() -> None:
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_k2())
    errs.update(phase_k3())
    errs.update(phase_k2b())
    probe_inputs = _probe_inputs()
    probe_errs, probe_launches = phase_probes(probe_inputs)
    errs.update(probe_errs)
    launches = phase_main_path()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [launches, phase_cli(tmp)]
    reg_launches, reg_err = phase_register()
    paths.append(reg_launches)
    errs["warp_flow"] = max(errs["warp_flow"], reg_err)
    paths += [phase_unet(), phase_register_unet(), phase_register_default(),
              phase_engines_default(), probe_launches]
    total = {name: sum(p.get(name, 0) for p in paths) for name in REPLACES}
    rows = phase_times()
    k2_times = phase_k2_times()
    k3_row = phase_k3_times()["8->8 edge 118"]
    k2b_row = phase_k2b_times()
    probe_rows = phase_probe_times(probe_inputs)
    library = _library_times()
    # per-launch times at the fine flow level's shape (240³, K=8, f32)
    flow_row = next(r for r in rows if r["S"] == 240 and r["K"] == 8)
    times = {"sweep_fwd": {"ms": flow_row["fwd_ms"], "plain_ms": flow_row["plain_fwd_ms"]},
             "sweep_bwd": {"ms": flow_row["bwd_ms"], "plain_ms": flow_row["plain_bwd_ms"]},
             **k2_times,
             "conv3d_fwd": {"ms": k3_row["fwd_ms"], "plain_ms": k3_row["plain_fwd_ms"]},
             "conv3d_dgrad": {"ms": k3_row["dgrad_ms"], "plain_ms": k3_row["plain_dgrad_ms"]},
             "roigather": k2b_row,
             **{name: probe_rows[name] for name in (*hg.KERNELS, "roi_fetch")}}
    vox, conv_out, conv_in = SIZE**3, 116**3, 118**3
    # bytes: each input read once, each output written once; operations:
    # ~6 per output of a sweep (two taps and their weights), ~10 per voxel
    # of its adjoint, ~60 per voxel of a trilinear warp (8 weights, 8
    # products, 8 sums, the coordinates)
    bounds = {"sweep_fwd": _bound(3 * 4.0 * vox, 6.0 * vox),  # src, q -> out
              "sweep_bwd": _bound(5 * 4.0 * vox, 10.0 * vox),  # g, src, q -> dsrc, dq
              "warp_affine": _bound(2 * 4.0 * vox, 60.0 * vox),  # src -> out
              "warp_flow": _bound(5 * 4.0 * vox, 60.0 * vox),  # src, 3-channel flow -> out
              # 8->8 at 118³: x and w -> out; dgrad: the padded cotangent -> dx
              "conv3d_fwd": _bound(4.0 * (8 * conv_in + 8 * conv_out + 27 * 64),
                                   2.0 * 27 * 64 * conv_out),
              "conv3d_dgrad": _bound(4.0 * (8 * 120**3 + 8 * conv_in + 27 * 64),
                                     2.0 * 27 * 64 * conv_in),
              "roigather": {k: k2b_row[k] for k in ("bound_ms", "bound_by")},
              **{name: {k: probe_rows[name][k] for k in ("bound_ms", "bound_by")}
                 for name in (*hg.KERNELS, "roi_fetch")}}
    library.update(sweep_fwd=None, sweep_bwd=None, conv3d_fwd=k3_row["plain_fwd_ms"],
                   conv3d_dgrad=k3_row["plain_dgrad_ms"], roigather=k2b_row["library_ms"],
                   **{name: probe_rows[name]["library_ms"] for name in (*hg.KERNELS, "roi_fetch")})
    timed_at = {"sweep_fwd": "one launch, 240^3 K=8 f32, mean of axes 0-2",
                "warp_affine": "one launch, 240^3 f32, selftest rigid theta",
                "warp_flow": "one launch, 240^3 f32, smooth field |flow|<=8",
                "conv3d_fwd": "one launch, 8->8 at 118^3 f32; plain: cuDNN, TF32 off",
                "roigather": "one launch, 240^3 f32, make_pair's rigid windows, T=13824",
                "block_permute_add": "one launch, P1: [16, 256] f32, order [1, 0]",
                "slab_gather": "one launch, P2: 6 slabs (14, 16, 256) of [64, 64, 256]",
                "slab_sum": "one launch, P3: 13826 slabs (14, 16, 256) of [240, 240, 256]",
                "slice_transpose": "one launch, P5: 4 tiles of a [32, 32, 256] slab",
                "roi_fetch": "one launch, 240^3 padded to 256^3, the probe's theta, T=13825"}
    timed_at["sweep_bwd"] = timed_at["sweep_fwd"]
    timed_at["conv3d_dgrad"] = timed_at["conv3d_fwd"]
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], **bounds[name], "library_ms": library[name],
         "timed_at": timed_at[name],
         **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {})}
        for name in REPLACES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
