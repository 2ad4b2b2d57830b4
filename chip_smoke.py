"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds kernels K1 (the sweep resampler, ``torchregister_tpu_torch/csrc/
sweep.cu``), K2 (the exact trilinear warp, ``csrc/warp.cu``: affine output
tiles that stage their source box in shared memory, and the direct route of
the flow mode, 2-D images and boxes that do not fit), K3 (the 3x3x3
convolution of the U-Net and the Sobel edge filter, forward and input
gradient, and its weight gradient, ``csrc/conv3d.cu``; each also with a
weight set per pair, each pair equal to a single-pair launch to the bit),
K2b (the compact ROI gather of the exact warp's compact-block route,
``csrc/roigather.cu``), the benchmark probes' kernels (``csrc/
hatgather.cu``: P1-P5 of ``benchmarks/probe_hatgather.py``, P3 in two
stages; ``csrc/roi_fetch.cu``: the fetch of ``benchmarks/probe_roi_stages.py``,
in two stages), the binned NMI's fixed-order splat (``csrc/splat.cu``)
and the exact NMI's KDE (``csrc/kde.cu``: ``kde_sum`` and ``kde_dot``,
which skip themselves on the binned branch's device flag) from the
checkout, holds each against its plain PyTorch version on the card
(the two-stage sums and the splat also against their order in torch ops, to
the bit; K1 in
its dense form and in the affine and flow forms the engines launch, which
compute each pass's coordinates in the kernel and must equal the dense
launch on the same coordinates to the bit, and the affine form with a table
per pair, each pair equal to a single-table launch to the bit), drives
the port's paths with quality gates (the recipe cascade on the 240³ pairs;
the CLI's register/apply round trip on NIfTI files; ``Register`` rigid, then
flow; the U-Net parity cascade on the 240³ deformable pair, which must repeat
to the bit; ``make_cascade_fn`` on the recipe's two pairs and the U-Net
control, each engine level's step captured once as a CUDA graph and
replayed, equal to ``register_cascade`` to the bit (``[cascade-fn]``); a
cohort (``[cohort]``): ``make_cascade_batch_fn`` on 8 240³ pairs, each against
its own ``make_cascade_fn`` run, and ``register_cohort`` rigid on the cohort
driver's 8 pairs; the U-Net cohort (``[cohort-unet]``):
``make_cascade_batch_fn(**RECIPE_UNET)`` on 4 240³ pairs, each pair its own
U-Net through K3 with a weight set per pair, each against its own
``make_cascade_fn`` run, the deformable pair of ``[unet]`` at its gates; the
meshes (``[mesh]``): the data axis, ``make_cascade_batch_fn(mesh=...)`` on a
mesh that names the card twice, on 4 of ``[cohort]``'s pairs and 2 of
``[cohort-unet]``'s, each pair equal to its unsharded batched run to the bit,
and, last but ``[busy]``, the space axis, K1's slab mode at 240³ on 4
z-slabs (the warp and dsrc equal to the unsharded launches' to the bit, each
slab launch against its plain version) and ``rigid_register`` on slabs
against its unsharded run, with the halo bytes and ms a step, then the
flow engine and LM on slabs, K2's slab mode (``[mesh-exact]``: each slab's
block equal to the unsharded launch's to the bit; the exact engines and
the exact final warp on slabs) and the cascade over a ``data x space``
mesh (``[mesh-batch]``: ``make_cascade_batch_fn(mesh=(2, 4),
spatial_axis=0, **RECIPE)`` on 4 of ``[cohort]``'s pairs, each equal to
its own run on one row of slabs to the bit, within ``[cohort]``'s quality
gate of the unsharded batch, each pair's steps and those of its one-ulp
runs near the unsharded ones; ``[mesh-batch-unet]``: the U-Net cohort on
slabs); the
engines' tensor-op Adam against ``torch.optim.Adam`` on the card
(``[adam]``), and last, after every timing, the busy share of both
(``[busy]``); ``Register`` in U-Net mode at the reference width; ``Register``
with the reference's default criteria and its exact warp on the compact
route, twice, which must repeat to the bit, and the binned NMI twice; the
matrix engines with their own defaults, edge filter and default
criteria; the two probe scripts' entry points; the LM matrix optimizer
(``[lm]``): K1's second order ``sweep_bwd2`` and the NMI splat's signed
mode against their plain versions (per pair to the bit against
single-table launches, repeating), the LM recipe through
``make_cascade_fn`` on both 240³ pairs equal to ``register_cascade`` to the
bit within the gates, beside the Adam recipe's walls and ms a step,
``Register`` rigid LM with the default criteria twice, equal to the bit,
and an LM cohort against single runs; the default criteria (MSE + NCC +
NMI, NMI's branch chosen on the device) through the factories:
``[kde]`` (the exact KDE's kernels at the default NMI's shapes, on a
CT-like range and on one just past the exact branch's flip, against their
plain version and an f64 evaluation), ``[cascade-fn-default]`` and
``[cascade-fn-exact]`` (``make_cascade_fn(**RECIPE, criterions=None)`` on
both 240³ pairs, and on the rigid pair times 1000, where every NMI call
takes the exact branch, three calls each equal to ``register_cascade`` to
the bit), ``[cascade-batch-default]`` (a batch taking both branches, each
pair equal to its single run) and LM with the default criteria through
the factory; every engine path must launch
K1's affine or flow form and never its dense form), and times each kernel
against its plain version and the one PyTorch call that computes the same
function, where there is one (``sweep_bwd2`` at every shape the LM paths
launch it, with its device time; K1: each form against the dense launch, and
whole 3-pass warps against the per-pass composition the port ran before,
``profile_sweep``; the redesigned probe copies also at a device-bound size,
with their device times), and the host time of each part of a launch (the
``[times] launch-path`` line: every kernel launches through
``native.Library.launch``). Any failure raises, so the exit code is
non-zero.

    python3 chip_smoke.py

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels with their launches on the paths (counts
set to 0 just before each path and read just after; a graph's replays add
the launches it captured), their largest absolute
deviation from the plain version over all checks, the time of one launch
against one pass of the plain version and of the library call, and the
least time the card could take for the same work (``bound_ms``: the bytes
the function must move over 3.35 TB/s, or its f32 operations over 67
TFLOP/s, whichever is larger; for K3's three kernels, which run f32 on the
tensor cores as three TF32 products, the operations over 495/3 TFLOP/s, with
the f32 FMA bound beside it as ``fma_bound_ms``; for the exact KDE's two, the
larger also of their exponentials over the SFU's rate, each part beside it,
counting only the terms within the kernels' cut, ``kde_terms_needed``, with
the bound over every term beside it as ``dense_bound_ms``).
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import importlib

import numpy as np
import torch

from torchregister_tpu_torch import Register
from torchregister_tpu_torch import profile_kde as pk
from torchregister_tpu_torch import profile_splat_bwd2 as psb
from torchregister_tpu_torch import profile_sweep as ps
from torchregister_tpu_torch import warp_cases as wc
from torchregister_tpu_torch.__main__ import main as cli
from torchregister_tpu_torch.engines.affine import affine_register
from torchregister_tpu_torch.engines import cascade as cascade_mod
from torchregister_tpu_torch.engines import common as engine_common
from torchregister_tpu_torch.engines.cascade import (make_cascade_batch_fn, make_cascade_fn,
                                                     register_cascade)
from torchregister_tpu_torch.engines.common import make_optimizer
from torchregister_tpu_torch.engines.flow import flow_register
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.losses import similarity as tsim
from torchregister_tpu_torch.losses.nmi import _sample_points, branch_calls, nmi_loss
from torchregister_tpu_torch.models.attention_unet import conv3x3x3_shapes
from torchregister_tpu_torch.profile_cascade import busy_profile
from torchregister_tpu_torch.ops import blocked
from torchregister_tpu_torch.ops.cuda import conv3d as k3
from torchregister_tpu_torch.ops.cuda import kde as kk
from torchregister_tpu_torch.ops.cuda import roigather as k2b
from torchregister_tpu_torch.ops.cuda import splat as ks
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.ops.edge import edge_filter, edge_magnitude
from torchregister_tpu_torch.ops.grid import affine_grid
from torchregister_tpu_torch.ops.resize import downsample_avg, nearest_resize
from torchregister_tpu_torch.ops.separable import affine_to_index_map, factor_passes
from torchregister_tpu_torch.ops.transforms import rigid_theta
from torchregister_tpu_torch.cohort_driver import cohort as driver_cohort
from torchregister_tpu_torch.parallel import halo, make_mesh, register_cohort
from torchregister_tpu_torch.parallel import mesh as pmesh
from torchregister_tpu_torch.probes import checked_index
from torchregister_tpu_torch.probes import hatgather as hg
from torchregister_tpu_torch.probes import roi_stages as rs
from torchregister_tpu_torch.synthetic import (
    RECIPE,
    RECIPE_UNET,
    flow_truth_metrics,
    make_flow_truth_pair,
    make_pair,
    rmse_reduction_pct,
)
from torchregister_tpu_torch.utils import volio

# the module (the package's ``losses`` exports a function named ``nmi``)
nmi_mod = importlib.import_module("torchregister_tpu_torch.losses.nmi")

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
    # forward and, reading the cotangent with a zero halo of 2, in the input
    # gradient
    "conv3d_fwd": "torchregister_tpu/ops/pallas/conv3d.py:174",
    "conv3d_dgrad": "torchregister_tpu/ops/pallas/conv3d.py:174",
    "conv3d_wgrad": "torchregister_tpu/ops/pallas/conv3d.py:301",
    "roigather": "torchregister_tpu/ops/pallas/roigather.py:49",
    # the benchmark probes: one kernel serves P2 and P4 (the same slab copy
    # at two slab sizes)
    "block_permute_add": "benchmarks/probe_hatgather.py:34",
    "slab_gather": "benchmarks/probe_hatgather.py:69",
    "slab_sum": "benchmarks/probe_hatgather.py:131",
    "slice_transpose": "benchmarks/probe_hatgather.py:270",
    "roi_fetch": "benchmarks/probe_roi_stages.py:69",
    "splat": "torchregister_tpu/losses/nmi.py:129",
    # K1's affine form with a table per pair: the same Pallas kernel under the
    # JAX cohort's vmap
    "sweep_fwd_pairs": "torchregister_tpu/ops/pallas/sweep.py:38",
    "sweep_bwd_pairs": "torchregister_tpu/ops/pallas/sweep.py:134",
    # K1's second order (the LM engines' Hessian): JAX differentiates its
    # in-loop XLA sweep twice by autodiff (ops/separable.py:304-311)
    "sweep_bwd2": "torchregister_tpu/ops/pallas/sweep.py:134",
    # the transpose of the splat's backward (the binned NMI's Hessian)
    "splat_signed": "torchregister_tpu/losses/nmi.py:129",
    # the exact KDE: the forward sum and the reductions of its derivatives
    "kde_sum": "torchregister_tpu/losses/nmi.py:39",
    "kde_dot": "torchregister_tpu/losses/nmi.py:49",
    # K3 with a weight set per pair: the same Pallas kernel (and the XLA
    # weight gradient) under the JAX U-Net cohort's vmap over stacked weights
    "conv3d_fwd_pairs": "torchregister_tpu/ops/pallas/conv3d.py:174",
    "conv3d_dgrad_pairs": "torchregister_tpu/ops/pallas/conv3d.py:174",
    "conv3d_wgrad_pairs": "torchregister_tpu/ops/pallas/conv3d.py:301",
    # K1's slab mode: the same Pallas kernel on the slabs of a volume that
    # GSPMD splits over the JAX mesh's space axis, with halos
    "sweep_fwd_slab": "torchregister_tpu/ops/pallas/sweep.py:38",
    "sweep_bwd_slab": "torchregister_tpu/ops/pallas/sweep.py:134",
    # K1's flow form on slabs (the flow engine on a space-sharded volume),
    # and its second order on slabs (LM there)
    "sweep_fwd_slab_flow": "torchregister_tpu/ops/pallas/sweep.py:38",
    "sweep_bwd_slab_flow": "torchregister_tpu/ops/pallas/sweep.py:134",
    "sweep_bwd2_slab": "torchregister_tpu/ops/pallas/sweep.py:134",
    # K2's slab mode: the same Pallas kernel on the slabs of a volume that
    # GSPMD splits (the exact warps on slabs, ROADMAP item 22)
    "warp_affine_slab": "torchregister_tpu/ops/pallas/roigather.py:145",
    "warp_flow_slab": "torchregister_tpu/ops/pallas/roigather.py:145",
}
ALSO_REPLACES = {"conv3d_fwd": "torchregister_tpu/ops/pallas/conv3d.py:203",
                 "conv3d_dgrad": "torchregister_tpu/ops/pallas/conv3d.py:203",
                 "conv3d_fwd_pairs": "torchregister_tpu/ops/pallas/conv3d.py:203",
                 "conv3d_dgrad_pairs": "torchregister_tpu/ops/pallas/conv3d.py:203",
                 "slab_gather": "benchmarks/probe_hatgather.py:222"}
# K3's weight gradient replaces XLA code, not a Pallas kernel
NOTES = {"conv3d_wgrad": "replaces _wgrad_xla, XLA code (27 einsums at HIGHEST), "
                         "not a Pallas kernel",
         "splat": "replaces the one-hot products of _binned_histogram, XLA code, not a "
                  "Pallas kernel: the binned NMI's splat, summed in a fixed order",
         "sweep_bwd2": "K1's second order for LM's Hessian: JAX takes it by autodiff of "
                       "its in-loop XLA sweep (ops/separable.py:304-311)",
         "splat_signed": "the splat's signed mode, the transpose of its backward: JAX "
                         "differentiates its one-hot products' custom VJP in reverse mode "
                         "only (its LM cannot, a custom_vjp has no forward mode)",
         "kde_sum": "replaces _kde_accumulate/kde_pdf's lax.scan, XLA code, not a Pallas "
                    "kernel: the exact KDE's sum over samples (forward; with w = ubar and "
                    "phi' the second order's gbar), skipping itself on the binned flag",
         "kde_dot": "replaces the autodiff backward of kde_pdf's lax.scan, XLA code: the "
                    "exact KDE's sum over points (ds with phi'; the second order's sbar with "
                    "phi''), skipping itself on the binned flag",
         "sweep_bwd2_slab": "K1's second order on the slabs of a space-sharded volume "
                            "(LM there): JAX takes it by autodiff of its in-loop XLA sweep "
                            "under GSPMD",
         "conv3d_wgrad_pairs": "K3's weight gradient with a weight set per pair: "
                               "_wgrad_xla (XLA code) under the JAX cohort's vmap; each "
                               "pair's dw its own, each equal to a single-pair launch"}
SOURCES = {"sweep_fwd": "torchregister_tpu_torch/csrc/sweep.cu",
           "sweep_bwd": "torchregister_tpu_torch/csrc/sweep.cu",
           "sweep_fwd_pairs": "torchregister_tpu_torch/csrc/sweep.cu",
           "sweep_bwd_pairs": "torchregister_tpu_torch/csrc/sweep.cu",
           "warp_affine": "torchregister_tpu_torch/csrc/warp.cu",
           "warp_flow": "torchregister_tpu_torch/csrc/warp.cu",
           "conv3d_fwd": "torchregister_tpu_torch/csrc/conv3d.cu",
           "conv3d_dgrad": "torchregister_tpu_torch/csrc/conv3d.cu",
           "conv3d_wgrad": "torchregister_tpu_torch/csrc/conv3d.cu",
           "roigather": "torchregister_tpu_torch/csrc/roigather.cu",
           **{name: "torchregister_tpu_torch/csrc/hatgather.cu" for name in hg.KERNELS},
           "roi_fetch": "torchregister_tpu_torch/csrc/roi_fetch.cu",
           "splat": "torchregister_tpu_torch/csrc/splat.cu",
           "sweep_bwd2": "torchregister_tpu_torch/csrc/sweep.cu",
           "splat_signed": "torchregister_tpu_torch/csrc/splat.cu",
           "kde_sum": "torchregister_tpu_torch/csrc/kde.cu",
           "kde_dot": "torchregister_tpu_torch/csrc/kde.cu",
           **{f"conv3d_{k}_pairs": "torchregister_tpu_torch/csrc/conv3d.cu"
              for k in ("fwd", "dgrad", "wgrad")},
           "sweep_fwd_slab": "torchregister_tpu_torch/csrc/sweep.cu",
           "sweep_bwd_slab": "torchregister_tpu_torch/csrc/sweep.cu",
           **{name: "torchregister_tpu_torch/csrc/sweep.cu"
              for name in ("sweep_fwd_slab_flow", "sweep_bwd_slab_flow", "sweep_bwd2_slab")},
           "warp_affine_slab": "torchregister_tpu_torch/csrc/warp.cu",
           "warp_flow_slab": "torchregister_tpu_torch/csrc/warp.cu"}
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory,
# f32 outside the tensor cores, and TF32 on them; K3's kernels take f32 as
# three TF32 products (3xTF32), so their f32 rate is a third of TF32's
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32_3XTF32_FLOP_PER_S = 495e12 / 3
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
# [unet]'s value while the engines stepped with torch.optim.Adam's foreach
# form, before their tensor-op Adam (H100)
UNET_FOREACH_PCT = 71.23863
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
# the matrix engines with their own defaults (grad_edges=True, the default
# criteria, SGD at lr 1e-5, rigid from a random init): steps of each engine
ENGINE_STEPS = 30
# nmi_loss on the card against the CPU at the default stack's shapes (the
# 240³ image resized to 200³, 8 patches of 100³, 16 M samples splatted) at
# the tolerances of tests/test_torch_cuda.py. The loss is 1000 |NMI - 1| and
# the reference's pooled "joint" makes NMI 1 wherever the two marginals
# match: for the pair itself at the default bandwidth 3.0, another order of
# the splat's sums (the card's kernel against the CPU's scatter) moves the
# value and the gradient by percents. So the check pairs the target with the
# square of the moving image, whose marginals differ, at a bandwidth that
# resolves the unit range.
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
    mods = (k1, k2, k3, k2b, hg, rs, ks, kk)
    with ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.LIB.build(), mods))
    for m in mods:
        m.LIB.fns()
    print(f"[build] K1, K2, K3, K2b, the probes, the NMI splat and the exact KDE built in "
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


def _mode_case(S, K, dtype, axis, seed):
    """A [1, 1, S, S, S] image and cotangent, a table whose row 0 sweeps
    ``axis`` with slope ~1 and displacements spread over the window and 2
    voxels past it along the next axis, and a field with displacements
    drawn over the same span."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    src = torch.rand((1, 1, S, S, S), generator=gen, device=DEV).to(dtype)
    g = torch.randn(src.shape, generator=gen, device=DEV).to(dtype)
    coef = 0.02 * (2.0 * torch.rand(3, generator=gen, device=DEV) - 1.0)
    coef[axis] += 1.0
    coef[(axis + 1) % 3] = (2.0 * K + 4.0) / (S - 1)
    offset = torch.tensor([0.37 - (K + 2.0)], device=DEV)
    table = torch.cat([coef, offset])[None].repeat(3, 1).contiguous()
    flow = (K + 2.0) * (2.0 * torch.rand((1, 3, S, S, S), generator=gen, device=DEV) - 1.0)
    return src, g, table, flow


def _check_path_modes(S, K, dtype, axis) -> tuple[float, float, float]:
    """K1's affine and flow forms along ``axis``: against the dense launch on
    the coordinates the per-pass composition built (forward, dsrc and du
    equal to the bit), against the plain version (forward, dsrc and du at
    ``TOL``, relative to the largest reference value; the table row's
    gradient at 1e-5 of its largest entry: another order of its sums), and
    against two more runs of their own (every output equal to the bit).
    Returns the largest absolute deviations from the plain version, forward
    and backward, and the row gradient's relative one."""
    src, g, table, flow = _mode_case(S, K, dtype, axis, 7000 + 10 * S + K + axis)
    dim = 2 + axis
    runs = [(k1.affine_fwd(src, table, 0, axis, K), *k1.affine_bwd(g, src, table, 0, axis, K),
             k1.flow_fwd(src, flow, axis, K), *k1.flow_bwd(g, src, flow, axis, K))
            for _ in range(3)]
    repeat = all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0]))
    aout, adsrc, arow, fout, fdsrc, fdu = runs[0]
    qa = ps.parent_q(src, table, flow, "affine", 0, axis)
    qf = ps.parent_q(src, table, flow, "flow", 0, axis)
    (da_s, _), (df_s, df_q) = k1.sweep_bwd(g, src, qa, dim, K), k1.sweep_bwd(g, src, qf, dim, K)
    bits = {"affine out": torch.equal(aout, k1.sweep_fwd(src, qa, dim, K)[0]),
            "affine dsrc": torch.equal(adsrc, da_s),
            "flow out": torch.equal(fout, k1.sweep_fwd(src, qf, dim, K)[0]),
            "flow dsrc": torch.equal(fdsrc, df_s), "flow du": torch.equal(fdu, df_q[:, 0])}
    s = src.clone().requires_grad_(True)
    row = table[0].clone().requires_grad_(True)
    pa = k1.sweep_affine_plain(s, row[:3], row[3], axis, K)
    pa_s, pa_row = torch.autograd.grad(pa, (s, row), g)
    s = src.clone().requires_grad_(True)
    f = flow.clone().requires_grad_(True)
    pf = k1.sweep_flow_plain(s, f, axis, K)
    pf_s, pf_f = torch.autograd.grad(pf, (s, f), g)
    torch.cuda.synchronize()
    fwd_pairs = ((aout, pa), (fout, pf))
    bwd_pairs = ((adsrc, pa_s), (fdsrc, pf_s), (fdu, pf_f[:, axis]))
    rel = [_rel_err(a, b) for a, b in (*fwd_pairs, *bwd_pairs)]
    row_rel = _rel_err(arow, pa_row)
    tol = TOL[dtype]
    label = f"{S}³ K={K} {str(dtype).replace('torch.', '')} axis {axis}"
    print(f"[kernel] modes {label}: equal to the dense launch {all(bits.values())}, "
          f"repeat {repeat}; rel out/dsrc affine {rel[0]:.3e}/{rel[2]:.3e}, flow "
          f"{rel[1]:.3e}/{rel[3]:.3e}, du {rel[4]:.3e} (tol {tol:g}); row gradient "
          f"{row_rel:.3e} (tol 1e-5)", flush=True)
    if not all(bits.values()) or not repeat:
        raise AssertionError(f"K1 modes {label}: bits {bits}, repeat {repeat}")
    if not (max(rel) < tol and row_rel < 1e-5):
        raise AssertionError(f"K1 modes {label} disagree with the plain version: {rel}, "
                             f"{row_rel:.3e}")
    return (max(_max_err(a, b) for a, b in fwd_pairs),
            max(_max_err(a, b) for a, b in bwd_pairs), row_rel)


# K1's affine form with a table per pair, as a cohort launches it: the 8
# pairs of [cohort] at 240³, a window of 8
PAIRS_N, PAIRS_S, PAIRS_K = 8, 240, 8


def _pair_case(dtype, seed):
    """Images and cotangents ``[8, 1, 240, 240, 240]`` and one table per
    pair ``[8, 3, 4]``: the separable passes of 8 rigid transforms drawn
    from ``seed``."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (PAIRS_N, 1) + (PAIRS_S,) * 3
    src = torch.rand(shape, generator=gen, device=DEV).to(dtype)
    g = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    params = 0.1 * (2.0 * torch.rand((PAIRS_N, 6), generator=gen, device=DEV) - 1.0)
    passes = factor_passes(*affine_to_index_map(rigid_theta(params), (PAIRS_S,) * 3))
    table = torch.stack([torch.cat([c, o[:, None]], dim=1) for _, (c, o) in passes], dim=1)
    return src, g, table.contiguous(), [a for a, _ in passes]


def _check_pair_tables(dtype) -> tuple[float, float, float]:
    """K1's affine form with a table per pair (one launch a pass for the 8
    pairs): each pair's output, dsrc and row gradient equal, to the bit, a
    single-table launch on that pair alone; the batched launch against the
    plain version with a row per pair (output and dsrc at ``TOL`` relative
    to the largest reference value, row gradients at 1e-5 of their largest
    entry: another order of the sums). Returns the largest absolute
    deviations from the plain version, forward and backward, and the row
    gradients' relative one."""
    src, g, table, axes = _pair_case(dtype, 9100 + (dtype == torch.bfloat16))
    K = PAIRS_K
    fwd = bwd = row_rel = 0.0
    bits = True
    rel = []
    for p, axis in enumerate(axes):
        out = k1.affine_fwd(src, table, p, axis, K)
        dsrc, drow = k1.affine_bwd(g, src, table, p, axis, K)
        for n in range(PAIRS_N):
            one = table[n].contiguous()
            s_n, g_n = src[n:n + 1], g[n:n + 1]
            ref_s, ref_row = k1.affine_bwd(g_n, s_n, one, p, axis, K)
            bits &= (torch.equal(out[n:n + 1], k1.affine_fwd(s_n, one, p, axis, K))
                     and torch.equal(dsrc[n:n + 1], ref_s) and torch.equal(drow[n], ref_row))
        s = src.clone().requires_grad_(True)
        row = table[:, p].clone().requires_grad_(True)
        plain = k1.sweep_affine_plain(s, row[:, :3], row[:, 3], axis, K)
        pl_s, pl_row = torch.autograd.grad(plain, (s, row), g)
        rel += [_rel_err(out, plain), _rel_err(dsrc, pl_s)]
        row_rel = max(row_rel, _rel_err(drow, pl_row))
        fwd, bwd = max(fwd, _max_err(out, plain)), max(bwd, _max_err(dsrc, pl_s))
        del s, row, plain, pl_s, pl_row
    label = f"{PAIRS_N} pairs {PAIRS_S}³ K={K} {str(dtype).replace('torch.', '')}"
    print(f"[kernel] table per pair, {label}: each pair equal to a single-table launch "
          f"(out, dsrc, row gradient) {bits}; rel out/dsrc {max(rel[0::2]):.3e}/"
          f"{max(rel[1::2]):.3e} (tol {TOL[dtype]:g}); row gradients {row_rel:.3e} "
          "(tol 1e-5)", flush=True)
    if not bits:
        raise AssertionError(f"K1's table per pair differs from single-table launches: {label}")
    if not (max(rel) < TOL[dtype] and row_rel < 1e-5):
        raise AssertionError(f"K1's table per pair disagrees with the plain version: {label}: "
                             f"{rel}, {row_rel:.3e}")
    return fwd, bwd, row_rel


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
    # the affine and flow forms (the only ones the engines launch) at the
    # same shapes and windows
    row_err = 0.0
    for S, K, dtype in PATH_SWEEPS:
        for axis in range(3):
            f, b, r = _check_path_modes(S, K, dtype, axis)
            fwd_err, bwd_err, row_err = max(fwd_err, f), max(bwd_err, b), max(row_err, r)
    # the affine form with a table per pair (a cohort's warps)
    pairs = [_check_pair_tables(dtype) for dtype in (torch.float32, torch.bfloat16)]
    torch.cuda.empty_cache()
    return {"sweep_fwd": fwd_err, "sweep_bwd": bwd_err, "sweep_row_grad_rel": row_err,
            "sweep_fwd_pairs": max(f for f, _, _ in pairs),
            "sweep_bwd_pairs": max(b for _, b, _ in pairs),
            "sweep_pairs_row_grad_rel": max(r for _, _, r in pairs)}


def _same_bits(out, ref) -> bool:
    """The same bits, NaN where the other has NaN."""
    nan = torch.isnan(out)
    return out.shape == ref.shape and bool(torch.equal(nan, torch.isnan(ref))) and bool(
        torch.equal(out.view(torch.int32)[~nan], ref.view(torch.int32)[~nan]))


def _equal_bits(a, b) -> bool:
    """The same dtype, shape and bits (f32 or bf16)."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a.view(as_int), b.view(as_int))))


def _check_k2(label, src, route, mt=None, flow=None) -> float:
    """One launch against ``warp_plain`` on the same tensors, equal to the bit
    (both run the same f32 operations in the same order), and the kernel's
    count of staged blocks equal to ``tile_boxes``'s: every block staged
    (``route='staged'``) or none (``'direct'``)."""
    k2.reset_counts()
    if src.ndim == 3:  # 2D [C, Y, X]: through the wrapper, one z plane
        out = k2.warp(src, mt=mt)
        src, out = src[:, None], out[:, None]
    elif flow is None:
        out = k2.warp_affine_launch(src, mt)
    else:
        out = k2.warp_flow_launch(src, flow)
    ref = k2.warp_plain(src, mt=mt, flow=flow)
    boxes = k2.tile_boxes(src.shape, mt=mt, flow=flow)
    torch.cuda.synchronize()
    staged, want, tiles = k2.staged_blocks(), int(boxes["staged"].sum()), k2.tiles_launched
    err = _max_err(torch.nan_to_num(out), torch.nan_to_num(ref))
    zeros = float(torch.mean((out == 0).float()))
    print(f"[k2] {label}: max|d| {err:.3e} (equal to the bit: {_same_bits(out, ref)}); "
          f"staged blocks {staged} of {tiles}; zero share {zeros:.3f}", flush=True)
    if not _same_bits(out, ref):
        raise AssertionError(f"K2 {label} differs from warp_plain: {err:.3e}")
    if staged != want or tiles != boxes["staged"].numel():
        raise AssertionError(f"K2 {label}: {staged} of {tiles} blocks staged, tile_boxes "
                             f"says {want} of {boxes['staged'].numel()}")
    if not {"staged": staged == tiles, "direct": staged == 0}[route]:
        raise AssertionError(f"K2 {label} is a {route} case: {staged} of {tiles} staged")
    return err


def _check_k2_wide(C: int = 160) -> None:
    """The 64-bit route: C * 240³ >= 2^31 elements (8.8 GB in, 8.8 GB out),
    each mode and route once; channels 0 and C-1 against ``warp_plain`` on
    those channels alone, which give the same bits."""
    S = SIZE
    src = torch.rand((C, S, S, S), generator=torch.Generator(device=DEV).manual_seed(7),
                     device=DEV)
    ends = src[[0, C - 1]]
    theta = rigid_theta(torch.tensor(wc.SELFTEST_THETA, device=DEV))[None]
    for label, route, mt, flow in (
            ("affine selftest theta", "staged", wc.index_map(theta, (S,) * 3), None),
            ("affine 90° zoom 2", "direct", wc.index_map(wc.rot90_zoom2().to(DEV), (S,) * 3),
             None),
            ("flow smooth |flow|<=8", "direct", None, wc.smooth_flow(S, 8.0, 6, DEV))):
        k2.reset_counts()
        out = (k2.warp_affine_launch(src, mt) if flow is None
               else k2.warp_flow_launch(src, flow))
        ref = k2.warp_plain(ends, mt=mt, flow=flow)
        want = int(k2.tile_boxes(ends.shape, mt=mt, flow=flow)["staged"].sum())
        torch.cuda.synchronize()
        staged, tiles = k2.staged_blocks(), k2.tiles_launched
        same = bool(torch.equal(out[[0, C - 1]], ref))
        del out
        print(f"[k2] C={C} at {S}³ (64-bit offsets), {label}: channels 0 and {C - 1} equal "
              f"to the bit: {same}; staged blocks {staged} of {tiles}", flush=True)
        routed = {"staged": staged == tiles, "direct": staged == 0}[route]
        if not same or staged != want or not routed:
            raise AssertionError(f"K2 C={C} {label}: bits {same}, {staged} of {tiles} staged, "
                                 f"tile_boxes says {want}")
    del src, ends
    torch.cuda.empty_cache()


def _check_k2_flow_wide(S: int = 1100) -> None:
    """The flow mode's 64-bit route at C = 1: the image holds 1100³ < 2^31
    elements, the field 3 * 1100³ (16 GB), whose third channel starts past
    2^31 (a width chosen from the image alone reads elsewhere; at 900³ the
    channel's start, 2 * 900³, stays below 2^31). The last 8 planes against
    ``sample_plain`` at their own coordinates, computed as ``warp_plain``
    computes them (the same bits)."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    src = torch.rand((1, S, S, S), generator=gen, device=DEV)
    flow = torch.randn((3, S, S, S), generator=gen, device=DEV).mul_(3.0)
    k2.reset_counts()
    out = k2.warp_flow_launch(src, flow)
    z0 = S - 8
    p = [torch.arange(a, S, dtype=torch.float32, device=DEV) for a in (z0, 0, 0)]
    p = [v.view([-1 if a == b else 1 for b in range(3)]) for a, v in enumerate(p)]
    ref = k2.sample_plain(src, [p[s] + flow[s, z0:] for s in range(3)])
    torch.cuda.synchronize()
    staged, tiles = k2.staged_blocks(), k2.tiles_launched
    same = bool(torch.equal(out[:, z0:], ref))
    print(f"[k2] flow C=1 at {S}³ (a field of 3·{S}³ >= 2^31 elements, 64-bit offsets): "
          f"planes {z0}-{S - 1} equal to the bit: {same}; staged blocks {staged} of {tiles}",
          flush=True)
    del src, flow, out
    torch.cuda.empty_cache()
    if not same or staged != 0:
        raise AssertionError(f"K2 flow at {S}³: bits {same}, {staged} of {tiles} staged")


def phase_k2() -> dict:
    """K2 against its plain version at the shapes the user path gives it:
    the affine mode's staged and direct routes, the flow mode (direct), 2-D,
    NaN and far coordinates, and the 64-bit offsets."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    theta = rigid_theta(torch.tensor(wc.SELFTEST_THETA, device=DEV))[None]
    S = SIZE
    vol = torch.rand((1, S, S, S), generator=gen, device=DEV)
    aff = [_check_k2(f"affine {S}³ selftest theta", vol, "staged",
                     mt=wc.index_map(theta, (S,) * 3))]
    aff.append(_check_k2(f"affine {S}³ make_pair's rigid", vol, "staged",
                         mt=wc.index_map(_pair_theta(), (S,) * 3)))
    small = torch.rand((1, 50, 47, 44), generator=gen, device=DEV)
    aff.append(_check_k2("affine 50x47x44 selftest theta", small, "staged",
                         mt=wc.index_map(theta, (50, 47, 44))))
    out_theta = torch.tensor([[[1.0, 0, 0, 0.9], [0, 1.0, 0, -0.8], [0, 0, 1.0, 0.5]]],
                             device=DEV)  # pushes part of the output past the volume
    aff.append(_check_k2(f"affine {S}³ zeros padding", vol, "staged",
                         mt=wc.index_map(out_theta, (S,) * 3)))
    aff.append(_check_k2(f"affine {S}³ 90° zoom 2", vol, "direct",
                         mt=wc.index_map(wc.rot90_zoom2().to(DEV), (S,) * 3)))
    theta2 = rigid_theta(torch.tensor((0.3, 0.1, -0.2), device=DEV))[None]
    img = torch.rand((1, S, S), generator=gen, device=DEV)
    aff.append(_check_k2(f"affine {S}² 2D", img, "direct", mt=wc.index_map(theta2, (S, S))))
    batch = torch.rand((3, S, S, S), generator=gen, device=DEV)
    aff.append(_check_k2(f"affine {S}³ folded batch C=3", batch, "staged",
                         mt=wc.index_map(theta, (S,) * 3)))
    flow = wc.smooth_flow(S, 8.0, 6, DEV)
    # the flow mode takes the direct route everywhere (PERF.md §6, K2)
    fl = [_check_k2(f"flow {S}³ smooth |flow|<=8", vol, "direct", flow=flow)]
    # outward zoom by 1.25 plus the smooth field: samples past all six faces
    fl.append(_check_k2(f"flow {S}³ past every face", vol, "direct",
                        flow=(wc.zoom_grid(S, DEV) + flow).contiguous()))
    torn = flow.clone()
    torn[0, 100, 100, 100], torn[2, 30, 200, 7] = float("nan"), 1e30
    fl.append(_check_k2(f"flow {S}³ a NaN and a 1e30", vol, "direct", flow=torn))
    _check_k2_wide()
    _check_k2_flow_wide()
    return {"warp_affine": max(aff), "warp_flow": max(fl)}


# the U-Net cascade's 120³ flow level (n=8, depth 2) and Register's 240³
# network (n=32, depth 4), the latter checked on z-slabs of 10 planes
K3_CASES = ([(ci, co, e, None) for ci, co, e in conv3x3x3_shapes(120, 8, 2)]
            + [(ci, co, e, 10) for ci, co, e in conv3x3x3_shapes(240, 32, 4)])
# the Sobel filter of the engines' grad_edges: 1 -> 9 channels on the
# reflect-padded 240³ image, f32 only (9 output channels: the kernel pads N
# to 16 with zeros), on a z-slab of 10 planes as the 240³ net: over the whole
# volume dw sums 14 M products an entry and sits 1.01e-5 from cuDNN's (H100).
# The path runs the forward alone, held whole against the CPU in
# [engines-default].
K3_EDGE_CASE = (1, 9, SIZE + 2, 10)


def _check_k3(ci, co, edge, slab, dtype) -> tuple[float, float, float]:
    """K3's forward launch, then the autograd Function's dx (K3 with padding 2
    on the cotangent) and dw (the weight-gradient kernel), against the plain
    version and autograd through it (cuDNN with TF32 off). Each error is
    relative to the largest reference value; f32 tolerance 1e-5 (summation
    order), bf16 one bf16 rounding (2^-7 of the largest value: both sum in
    f32 and round once). Then each of the three launches runs twice more on
    the same inputs and must give the same bits. Returns the largest
    absolute deviations: forward, dx, dw."""
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
    w_t = w.flip((0, 1, 2)).transpose(3, 4)
    launches = {"fwd": lambda: k3.conv_launch(x, w),
                "dgrad": lambda: k3.conv_launch(g, w_t, pad=2),
                "wgrad": lambda: k3.wgrad_launch(x, g)}
    unequal = [name for name, fn in launches.items() if not torch.equal(fn(), fn())]
    print(f"[k3] {label}: rel fwd {rel[0]:.3e}, dx {rel[1]:.3e}, dw {rel[2]:.3e} "
          f"(tol {tol:g}); launches repeat to the bit: {not unequal}", flush=True)
    if out.dtype != dtype or dx.dtype != dtype or not max(rel) < tol:
        raise AssertionError(f"K3 {label} disagrees with the plain version: {rel}")
    if unequal:
        raise AssertionError(f"K3 {label}: {unequal} differ between two launches")
    return _max_err(out, ref), _max_err(dx, rdx), _max_err(dw, rdw)


def phase_k3() -> dict:
    """K3's three kernels against their plain versions at every convolution
    of both U-Net paths, f32 and bf16, and at the edge filter's, f32; then
    with a weight set per pair at the U-Net cohort's 120³ level."""
    cases = [(c, dtype) for c in K3_CASES for dtype in (torch.float32, torch.bfloat16)]
    errs = [0.0, 0.0, 0.0]
    for case, dtype in cases + [(K3_EDGE_CASE, torch.float32)]:
        errs = [max(a, b) for a, b in zip(errs, _check_k3(*case, dtype))]
    pair_errs = [0.0, 0.0, 0.0]
    for ci, co, edge in K3_PAIR_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            got = _check_k3_pairs(COHORT_UNET_B, ci, co, edge, dtype)
            pair_errs = [max(a, b) for a, b in zip(pair_errs, got)]
    names = ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad")
    return {**dict(zip(names, errs)), **{f"{n}_pairs": e for n, e in zip(names, pair_errs)}}


# the U-Net cohort's 120³ level (RECIPE_UNET: n=8, depth 2): its first
# layer, the widest at 118³, the bottleneck's 16 -> 32 and a decoder's 32 -> 16
K3_PAIR_CASES = [c for c in conv3x3x3_shapes(120, 8, 2)
                 if c in ((1, 8, 120), (8, 8, 118), (16, 32, 27), (32, 16, 54))]


def _k3_pair_case(B, ci, co, edge, dtype, seed):
    """``B`` pairs' input, weight sets, cotangent and dgrad weights."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, ci) + (edge,) * 3, generator=gen, device=DEV).to(dtype)
    w = (torch.randn((B, 3, 3, 3, ci, co), generator=gen, device=DEV)
         / math.sqrt(27 * ci)).to(dtype)
    g = torch.randn((B, co) + (edge - 2,) * 3, generator=gen, device=DEV).to(dtype)
    return x, w, g, w.flip((1, 2, 3)).transpose(4, 5).contiguous()


def _check_k3_pairs(B, ci, co, edge, dtype) -> tuple[float, float, float]:
    """K3 with a weight set per pair (``B`` pairs at ``ci -> co`` on an
    ``edge`` cube): one launch each of the forward, the input gradient and
    the weight gradient. Each pair must equal a launch on that pair alone to
    the bit, the launches must repeat to the bit, and each is held against
    its plain version (a call a pair) at ``_check_k3``'s tolerances. Returns
    the largest absolute deviations: forward, dx, dw."""
    x, w, g, w_t = _k3_pair_case(B, ci, co, edge, dtype, 7 * B + 100 * ci + co + edge)
    launches = {"fwd": lambda: k3.conv_launch(x, w),
                "dgrad": lambda: k3.conv_launch(g, w_t, pad=2),
                "wgrad": lambda: k3.wgrad_launch(x, g, per_pair=True)}
    got = {name: fn() for name, fn in launches.items()}
    singles = {"fwd": lambda b: k3.conv_launch(x[b:b + 1], w[b]),
               "dgrad": lambda b: k3.conv_launch(g[b:b + 1], w_t[b], pad=2),
               "wgrad": lambda b: k3.wgrad_launch(x[b:b + 1], g[b:b + 1])[None]}
    off = [name for name in launches
           if not all(_equal_bits(got[name][b:b + 1], singles[name](b)) for b in range(B))]
    unequal = [name for name, fn in launches.items() if not _equal_bits(fn(), got[name])]
    ref = {"fwd": k3.conv3x3x3_plain(x, w), "dgrad": k3.conv3x3x3_plain(g, w_t, pad=2),
           "wgrad": k3.wgrad_plain(x, g, per_pair=True)}
    torch.cuda.synchronize()
    rel = {name: _rel_err(got[name], ref[name]) for name in launches}
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    label = f"{B} pairs {ci}->{co} edge {edge} {str(dtype).replace('torch.', '')}"
    print(f"[k3] a weight set per pair, {label}: rel {json.dumps(rel)} (tol {tol:g}, dw "
          f"1e-05); each pair equal to its single launch to the bit: {not off}; launches "
          f"repeat to the bit: {not unequal}", flush=True)
    if not (rel["fwd"] < tol and rel["dgrad"] < tol and rel["wgrad"] < 1e-5):
        raise AssertionError(f"K3 per pair {label} disagrees with the plain version: {rel}")
    if off or unequal:
        raise AssertionError(f"K3 per pair {label}: {off} off their single launches, "
                             f"{unequal} differ between two launches")
    return tuple(_max_err(got[name], ref[name]) for name in launches)


def _pair_theta() -> torch.Tensor:
    """make_pair's rigid transform, whose 10³ output tiles each fit a 16³
    source window of the ROI route."""
    return rigid_theta(torch.tensor(wc.PAIR_RIGID, device=DEV))[None]


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
    checked on the host and put on the card: ``{case: (args, atol)}``. P2's
    and P4's slabs include the last valid origin; P3's 13824 origins (240³
    bench fetch) come with the last valid one and (0, 0) appended, the
    fetch's scalars (240³, the probe's theta) with the last valid block
    origin appended. The two redesigned copies also run at a size where the
    device work dominates (``*_big``, P3's 240 x 240 x 256 volume):
    ``slab_gather`` at the first 1728 of P3's origins, ``slice_transpose``
    at 4096 starts from ``default_rng(0)``. The copies must match to the
    bit; the sums at their stated atol (``hg.P3_ATOL``, ``rs.FETCH_ATOL``)."""
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
    rng = np.random.default_rng(0)
    big_starts = np.stack([rng.integers(0, SIZE - 14 + 1, BIG_STARTS),
                           rng.integers(0, SIZE - 16 + 1, BIG_STARTS),
                           rng.integers(0, 256 - 16 + 1, BIG_STARTS)], axis=-1)
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
        "slab_gather_big": ((vol240, orgs(hg.p3_origins(SIZE, BIG_SLABS), (14, 16), vol240),
                             14, 16), 0.0),
        "slice_transpose_big": ((vol240, checked_index(big_starts, (0, 1, 2),
                                                       (SIZE - 14, SIZE - 16, 256 - 16),
                                                       "starts", dev), 14, 16, 16, 256), 0.0),
    }


PROBE_FNS = {"block_permute_add": (hg.block_permute_add_launch, hg.block_permute_add_plain),
             "slab_gather": (hg.slab_gather_launch, hg.slab_gather_plain),
             "slab_sum": (hg.slab_sum_launch, hg.slab_sum_plain),
             "slice_transpose": (hg.slice_transpose_launch, hg.slice_transpose_plain),
             "roi_fetch": (rs.roi_fetch_launch, rs.roi_fetch_plain)}
# the probe cases that run a kernel at another size than its probe's
CASE_KERNEL = {"slab_gather_p4": "slab_gather", "slab_gather_big": "slab_gather",
               "slice_transpose_big": "slice_transpose"}
# the redesigned copies, at the probes' sizes and the device-bound ones
COPIES = ("slab_gather", "slab_gather_p4", "slice_transpose", "slab_gather_big",
          "slice_transpose_big")
BIG_SLABS, BIG_STARTS = 1728, 4096


# the two-stage sums' order in torch ops: each kernel equals it to the bit
ORDERED = {"slab_sum": hg.slab_sum_ordered, "roi_fetch": rs.roi_fetch_ordered}


def phase_probes(inputs: dict, splat_inputs: dict) -> tuple[dict, dict]:
    """Each probe kernel against its plain version at the probe's own sizes
    (``_probe_inputs``), the two-stage sums also against their order in
    torch ops to the bit; the NMI splat (``_check_splat``); then the path:
    both probe modules' ``main`` (P1-P5, and the ROI stages at 240³), counts
    set to 0 just before and read just after. Returns the largest
    deviations and the path's launches."""
    errs = {}
    for case, (args, atol) in inputs.items():
        name = CASE_KERNEL.get(case, case)
        launch, plain = PROBE_FNS[name]
        out, ref = launch(*args), plain(*args)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        errs[name] = max(errs.get(name, 0.0), err)
        bits = name in ORDERED and torch.equal(out, ORDERED[name](*args))
        note = f", equal to its torch order to the bit: {bits}" if name in ORDERED else ""
        print(f"[probes] {case}: out {tuple(out.shape)}, max|d| {err:.3e} (tol {atol:g})"
              f"{note}", flush=True)
        if out.shape != ref.shape or not err <= atol:
            raise AssertionError(f"{case} disagrees with its plain version: {err:.3e}")
        if name in ORDERED and not bits:
            raise AssertionError(f"{case} differs from its order in torch ops")
    errs["splat"] = _check_splat(splat_inputs)
    _reset_counts()
    hg.main(["p1", "p2", "p3", "p4", "p5"])
    rs.main()
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[probes] the probe entry points' launches: {json.dumps(launches)}", flush=True)
    _need(launches, (*hg.KERNELS, "roi_fetch", "roigather", "warp_affine"),
          "the probe entry points")
    return errs, launches


def _splat_inputs() -> dict:
    """``{case: (idx, f)}``, the splat's inputs as the default NMI term makes
    them at 240³ on the joint range of make_pair's pair: its moving image,
    and a constant image at a fractional bin (every sample in one bin), each
    resized to 200³, 8 patches of 100³: 8 rows of 1 M samples, not a whole
    number of the kernel's blocks (``profile_splat_bwd2.splat_inputs``)."""
    return psb.splat_inputs(DEV)


def _check_splat(inputs: dict) -> float:
    """The splat kernel, launched twice, equal to the bit to itself and to
    its order in torch ops (``splat_ordered``), and within each bin's bound
    of its plain version (``scatter_add`` a block of samples, atomics on the
    card): both
    add a bin's n terms in f32 in different orders, and any order lies
    within (n - 1) u of the bin's mass (u = 2^-24) from the exact sum, so a
    bin may differ by 2 n u times its mass (n and the mass counted in f64),
    which a constant image's one bin approaches. Returns the largest
    absolute deviation from the plain version."""
    worst = 0.0
    for case, (idx, f) in inputs.items():
        out, again = ks.splat_launch(idx, f), ks.splat_launch(idx, f)
        ref, ordered = ks.splat_plain(idx, f), ks.splat_ordered(idx, f)
        i, f64 = idx.long(), f.double()
        zero = torch.zeros(out.shape, dtype=torch.float64, device=DEV)
        one = torch.ones_like(f64)
        n = zero.scatter_add(1, i, one).scatter_add(1, i + 1, one)
        mass = zero.scatter_add(1, i, 1.0 - f64).scatter_add(1, i + 1, f64)
        bound = 2.0 * n * 2.0**-24 * mass
        d = (out.double() - ref.double()).abs()
        share = float((d / bound.clamp_min(1e-300)).max())
        err = float(d.max())
        repeat, same = torch.equal(out, again), torch.equal(out, ordered)
        print(f"[probes] splat {case}: out {tuple(out.shape)} from {tuple(f.shape)}, "
              f"{int((n > 0).sum())} bins hit; two launches equal: {repeat}; equal to its "
              f"torch order: {same}; against the plain version max|d| {err:.3e}, at most "
              f"{share:.3f} of each bin's bound 2 n u mass", flush=True)
        if not (repeat and same):
            raise AssertionError(f"the splat kernel does not repeat its order on {case}")
        if not bool((d <= bound).all()):
            raise AssertionError(f"the splat disagrees with its plain version on {case}")
        worst = max(worst, err)
    return worst


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

    _reset_counts()
    res = register_cascade(moving, target, **RECIPE)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = register_cascade(moving, target, **RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fres = register_cascade(fmov, ftgt, **RECIPE)
    torch.cuda.synchronize()
    launches = _counts()

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
    k1_launches = {n: v for n, v in launches.items() if n.startswith("sweep")}
    print(f"[main] K1 launches: {json.dumps(k1_launches)}", flush=True)
    _need(launches, ("sweep_fwd", "sweep_bwd", *K1_MODES), "the main path")
    if quality["rmse_reduction_pct"] < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"rigid gate failed: {quality}")
    if quality["flow_truth_rmse_reduction_pct"] < GATES["flow_truth_rmse_reduction_pct"]:
        raise AssertionError(f"deformable gate failed: {quality}")
    if quality["flow_field_err_observable_vox"] > GATES["flow_field_err_observable_vox"]:
        raise AssertionError(f"observable map error gate failed: {quality}")
    return launches


# K1's launches by the form of their coordinates: the engines' paths launch
# the affine and flow forms only
K1_MODES = ("sweep_fwd_affine", "sweep_bwd_affine", "sweep_fwd_flow", "sweep_bwd_flow")


def _counts() -> dict:
    return {"sweep_fwd": k1.fwd_launches, "sweep_bwd": k1.bwd_launches,
            **{f"sweep_fwd_{m}": n for m, n in k1.fwd_modes.items()},
            **{f"sweep_bwd_{m}": n for m, n in k1.bwd_modes.items()},
            "sweep_bwd2": k1.bwd2_launches,
            **{f"sweep_bwd2_{m}": n for m, n in k1.bwd2_modes.items()},
            "warp_affine": k2.affine_launches, "warp_flow": k2.flow_launches,
            "warp_affine_slab": k2.affine_slab_launches, "warp_flow_slab": k2.flow_slab_launches,
            "conv3d_fwd": k3.fwd_launches, "conv3d_dgrad": k3.dgrad_launches,
            "conv3d_wgrad": k3.wgrad_launches, "conv3d_fwd_pairs": k3.fwd_pairs_launches,
            "conv3d_dgrad_pairs": k3.dgrad_pairs_launches,
            "conv3d_wgrad_pairs": k3.wgrad_pairs_launches,
            "roigather": k2b.launches, **hg.launches, "roi_fetch": rs.launches,
            "splat": ks.launches, "splat_signed": ks.signed_launches,
            "kde_sum": kk.sum_launches, "kde_dot": kk.dot_launches}


def _reset_counts() -> None:
    for m in (k1, k2, k3, k2b, hg, rs, ks, kk):
        m.reset_counts()


def _need(launches: dict, names, path: str) -> None:
    """Each of ``names`` launched on the path; K1's dense form never (the
    engines' warps compute their coordinates in the kernels)."""
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{path} did not launch {missing}: {launches}")
    dense = {n: launches[n] for n in ("sweep_fwd_dense", "sweep_bwd_dense") if launches[n]}
    if dense:
        raise AssertionError(f"{path} launched K1's dense form: {dense}")


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
    _need(launches, ("sweep_fwd", "sweep_bwd", *K1_MODES, "warp_affine", "warp_flow"),
          "the CLI")
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
    _need(launches, ("sweep_fwd", "sweep_bwd", *K1_MODES, "warp_affine", "warp_flow"),
          "Register")
    return launches, err


def _cascade_fn_pair(label, recipe, m, t, gates) -> dict:
    """One pair through ``register_cascade`` (the reference, then timed) and
    through ``make_cascade_fn``'s ``fn`` twice (capture, then replay only):
    both of ``fn``'s results equal the reference to the bit."""
    fn = make_cascade_fn(**recipe)
    ref = register_cascade(m, t, **recipe)  # also the warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    register_cascade(m, t, **recipe)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    first = fn(m, t)  # captures every engine level's step
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _reset_counts()
    engine_common.reset_counts()
    t0 = time.perf_counter()
    res = fn(m, t)  # copies its inputs in and replays
    torch.cuda.synchronize()
    wall_fn = time.perf_counter() - t0
    launches, reads = _counts(), dict(engine_common.host_reads)
    same = {}
    for name in ref._fields:
        a = getattr(ref, name)
        for run, r in (("capture", first), ("replay", res)):
            b = getattr(r, name)
            same[f"{run}.{name}"] = (a == b if not isinstance(a, torch.Tensor)
                                     else _same_bits(b, a))
    graphs = fn.graphs.counts()
    print(f"[cascade-fn] {label}: {len(graphs)} step graphs captured, replays "
          f"{sum(r for _, r in graphs.values())} ({json.dumps(graphs)}); steps {res.steps}; "
          f"host reads of the stop state {json.dumps(reads)}; peak memory of the capturing "
          f"call {peak:.3f} GiB; wall after warm-up: register_cascade {wall_ref:.3f} s, "
          f"fn {wall_fn:.3f} s; equal to register_cascade to the bit: {all(same.values())}; "
          f"launches of the replaying call {json.dumps(launches)}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"make_cascade_fn differs from register_cascade on {label}: "
                             f"{[k for k, v in same.items() if not v]}")
    if any(c != 1 or r <= 0 for c, r in graphs.values()):
        raise AssertionError(f"a level's step was not captured once and replayed: {graphs}")
    _on_cuda(res)
    _finite(res, tuple(m.shape))
    gates(res)
    return launches, (label, recipe, m, t, wall_ref, wall_fn)


def phase_cascade_fn() -> tuple[dict, list]:
    """``make_cascade_fn`` at 240³: ``RECIPE`` on both pairs and
    ``RECIPE_UNET`` on the deformable pair, each equal to
    ``register_cascade`` to the bit, with the quality gates; its launches
    (replays included) go through K1's affine and flow forms. Returns the
    launches, and each run's inputs and wall times for :func:`phase_busy`."""
    moving, target = make_pair(device=DEV)
    fmov, ftgt, theta_true, flow_true = make_flow_truth_pair(device=DEV)

    def rigid_gate(res):
        pct = rmse_reduction_pct(res.warped, moving, target)
        print(f"[cascade-fn] rigid pair: rmse_reduction_pct {pct}", flush=True)
        if pct < GATES["rmse_reduction_pct"]:
            raise AssertionError(f"make_cascade_fn rigid gate failed: {pct}")

    def deformable_gate(res):
        q = dict(zip(("flow_truth_rmse_reduction_pct", "flow_field_err_vox",
                      "flow_field_err_observable_vox"),
                     flow_truth_metrics(res, fmov, ftgt, theta_true, flow_true)))
        print(f"[cascade-fn] deformable pair: {json.dumps(q)}", flush=True)
        if (q["flow_truth_rmse_reduction_pct"] < GATES["flow_truth_rmse_reduction_pct"]
                or q["flow_field_err_observable_vox"]
                > GATES["flow_field_err_observable_vox"]):
            raise AssertionError(f"make_cascade_fn deformable gates failed: {q}")

    def unet_gate(res):
        q = dict(zip(UNET_GATES, flow_truth_metrics(res, fmov, ftgt, theta_true, flow_true)))
        print(f"[cascade-fn] U-Net: {json.dumps(q)}", flush=True)
        if (q["unet_flow_truth_rmse_reduction_pct"]
                < UNET_GATES["unet_flow_truth_rmse_reduction_pct"]
                or any(q[k] > UNET_GATES[k] for k in ("unet_flow_field_err_vox",
                                                      "unet_flow_field_err_observable_vox"))):
            raise AssertionError(f"make_cascade_fn U-Net gates failed: {q}")

    total: dict = {}
    runs = []
    for label, recipe, (m, t), gates, need in (
            ("rigid pair", RECIPE, (moving, target), rigid_gate, ()),
            ("deformable pair", RECIPE, (fmov, ftgt), deformable_gate, ()),
            ("U-Net", RECIPE_UNET, (fmov, ftgt), unet_gate,
             ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad"))):
        launches, run = _cascade_fn_pair(label, recipe, m, t, gates)
        _need(launches, ("sweep_fwd", "sweep_bwd", *K1_MODES, *need),
              f"make_cascade_fn ({label})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs.append(run)
    return total, runs


# [cohort]: make_pair seeds 0-3 and make_flow_truth_pair seeds 1-4 at 240³
# through make_cascade_batch_fn(**RECIPE); each pair against its own
# make_cascade_fn run within these limits
COHORT_PAIR_SEEDS, COHORT_TRUTH_SEEDS = (0, 1, 2, 3), (1, 2, 3, 4)
COHORT_STEPS_TOL, COHORT_QUALITY_TOL = 2, 0.1
# register_cohort rigid on the cohort driver's 8 perturbed 240³ pairs, with a plateau
# stop so that the pairs stop at different steps
COHORT_RIGID = dict(mode="rigid", lr=5e-3, epochs=300, criterions=["mse"], optimizer="adam",
                    init="identity", stop_rel=1e-3, patience=20)


def _cohort_inputs(pair_seeds=COHORT_PAIR_SEEDS, truth_seeds=COHORT_TRUTH_SEEDS) -> list:
    """``(kind, seed, moving, target, truth)`` of a cohort's pairs (make_pair
    seeds, then make_flow_truth_pair seeds, at 240³), made on 8 threads
    (each pair's blobs are numpy work)."""
    def pair(seed):
        return ("rigid", seed, *make_pair(seed=seed, device=DEV), None)

    def truth(seed):
        m, t, theta, flow = make_flow_truth_pair(seed=seed, device=DEV)
        return ("deformable", seed, m, t, (theta, flow))

    with ThreadPoolExecutor(8) as ex:
        jobs = ([ex.submit(pair, s) for s in pair_seeds]
                + [ex.submit(truth, s) for s in truth_seeds])
        return [j.result() for j in jobs]


def _pair_quality(kind, res, m, t, truth) -> dict:
    if kind == "rigid":
        return {"rmse_reduction_pct": rmse_reduction_pct(res.warped, m, t)}
    return dict(zip(("flow_truth_rmse_reduction_pct", "flow_field_err_vox",
                     "flow_field_err_observable_vox"), flow_truth_metrics(res, m, t, *truth)))


# the [cohort] and [cohort-unet] pairs that [mesh] runs again over a data mesh,
# each against the batched run kept here
MESH_PAIRS = {"cohort": (0, 1, 4, 5), "cohort-unet": (2, 3)}
MESH_REFS: dict = {}


def _keep(res, idx) -> object:
    """The pairs ``idx`` of a batched cascade's result."""
    sel = torch.tensor(idx, device=res.warped.device)
    return res._replace(**{n: None if getattr(res, n) is None
                           else getattr(res, n).index_select(0, sel).clone()
                           for n in ("warped", "theta", "flow", "rigid_losses",
                                     "affine_losses", "flow_losses")},
                        steps={k: [v[i] for i in idx] for k, v in res.steps.items()})


def _batch_against_singles(tag: str, recipe_name: str, recipe: dict, inputs: list,
                           gate) -> dict:
    """``make_cascade_batch_fn(**recipe)`` on ``inputs``' pairs: one
    capturing call, then one timed replaying call (equal to it to the bit).
    Each pair against its own ``make_cascade_fn(**recipe)`` run (steps per
    stage and level within ``COHORT_STEPS_TOL``, quality fields within
    ``COHORT_QUALITY_TOL``); ``gate(kind, seed, quality)`` names a failed
    absolute gate, or None. Prints a line a pair and the batch's walls,
    masked pair-steps, peak memory and launches; returns the replaying
    call's launches."""
    movings = torch.cat([m for _, _, m, _, _ in inputs])
    targets = torch.cat([t for _, _, _, t, _ in inputs])
    B = movings.shape[0]
    fn = make_cascade_batch_fn(**recipe)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # earlier phases' graphs and caches
    t0 = time.perf_counter()
    first = fn(movings, targets)  # captures every level's batched step
    torch.cuda.synchronize()
    wall_capture = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    before = fn.graphs.counts()
    _reset_counts()
    engine_common.reset_counts()
    t0 = time.perf_counter()
    res = fn(movings, targets)  # copies its inputs in and replays
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, reads = _counts(), dict(engine_common.host_reads)
    graphs = fn.graphs.counts()
    replays = {lvl: c[1] - before.get(lvl, [0, 0])[1] for lvl, c in graphs.items()}
    steps_run = sum(s for stage in res.steps.values() for pair in stage for s in pair)
    masked = sum(r for r in replays.values()) * B - steps_run
    repeat = all(_same_bits(getattr(res, n), getattr(first, n))
                 for n in ("warped", "theta", "flow", "rigid_losses", "affine_losses",
                           "flow_losses")) and res.steps == first.steps
    _on_cuda(res)
    single = make_cascade_fn(**recipe)
    single(*inputs[0][2:4])  # warm-up: its graphs captured
    walls, rows, bits, bad = [], [], [], []
    for b, (kind, seed, m, t, truth) in enumerate(inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = single(m, t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mine = res._replace(warped=res.warped[b], theta=res.theta[b], flow=res.flow[b],
                            steps={k: v[b] for k, v in res.steps.items()})
        if not (tuple(mine.warped.shape) == tuple(m.shape)
                and bool(torch.isfinite(mine.warped).all())
                and bool(torch.isfinite(mine.flow).all())):
            raise AssertionError(f"[{tag}] pair {b} is not a finite volume of its shape")
        q, q_ref = _pair_quality(kind, mine, m, t, truth), _pair_quality(kind, ref, m, t, truth)
        dsteps = max(abs(a - c) for k in ref.steps for a, c in zip(mine.steps[k], ref.steps[k]))
        dq = max(abs(q[k] - q_ref[k]) for k in q)
        bits.append(all(_same_bits(getattr(mine, n), getattr(ref, n))
                        for n in ("warped", "theta", "flow")) and mine.steps == ref.steps)
        rows.append({"pair": f"{kind} seed {seed}", "steps": mine.steps,
                     "single_steps": ref.steps, "quality": q, "single_quality": q_ref,
                     "equal_to_the_bit": bits[-1]})
        if dsteps > COHORT_STEPS_TOL or dq > COHORT_QUALITY_TOL:
            bad.append((b, dsteps, dq))
        failed = gate(kind, seed, q)
        if failed:
            raise AssertionError(f"[{tag}] {kind} seed {seed} gate failed: {failed}: {q}")
    for row in rows:
        print(f"[{tag}] {json.dumps(row)}", flush=True)
    single_mean = sum(walls) / len(walls)
    print(f"[{tag}] make_cascade_batch_fn(**{recipe_name}), {B} pairs at {SIZE}³: wall of "
          f"the capturing call {wall_capture:.3f} s, of the replaying call {wall:.3f} s = "
          f"{wall / B:.4f} s a pair, against make_cascade_fn's mean {single_mean:.4f} s a "
          f"pair alone ({json.dumps([round(w, 4) for w in walls])}); {len(graphs)} step "
          f"graphs, replays of the replaying call {json.dumps(replays)}; pair-steps run "
          f"{steps_run}, masked {masked} ({100.0 * masked / max(1, masked + steps_run):.1f} "
          f"%); host reads {json.dumps(reads)}; peak memory of the capturing call "
          f"{peak:.3f} GiB ({held:.3f} GiB held before it); replay equal to the capturing call to the bit {repeat}; pairs "
          f"equal to their single runs to the bit {sum(bits)} of {B}; launches of the "
          f"replaying call {json.dumps(launches)}", flush=True)
    if bad:
        raise AssertionError(f"[{tag}] pairs off their single runs (pair, steps, quality): "
                             f"{bad}")
    if not repeat:
        raise AssertionError(f"[{tag}] the replaying call differs from the capturing call")
    if any(c != 1 or r <= 0 for c, r in graphs.values()):
        raise AssertionError(f"[{tag}] a level's step was not captured once: {graphs}")
    idx = MESH_PAIRS[tag]
    MESH_REFS[tag] = (movings[list(idx)].clone(), targets[list(idx)].clone(), _keep(res, idx),
                      [(inputs[i][0], inputs[i][1], inputs[i][4]) for i in idx], wall / B)
    del first, res, movings, targets
    torch.cuda.empty_cache()
    return launches


def _cohort_gate(kind, seed, q):
    """The seed-0 rigid and seed-1 deformable pairs meet the field recipe's
    absolute gates."""
    if seed != (0 if kind == "rigid" else 1):
        return None
    if kind == "rigid":
        ok = q["rmse_reduction_pct"] >= GATES["rmse_reduction_pct"]
    else:
        ok = (q["flow_truth_rmse_reduction_pct"] >= GATES["flow_truth_rmse_reduction_pct"]
              and q["flow_field_err_observable_vox"] <= GATES["flow_field_err_observable_vox"])
    return None if ok else "GATES"


def phase_cohort() -> dict:
    """``make_cascade_batch_fn(**RECIPE)`` on 8 pairs at 240³ against their
    single runs (``_batch_against_singles``); the seed-0 rigid and seed-1
    deformable pairs also meet the absolute gates. Then ``register_cohort``
    rigid on the cohort driver's 8 perturbed pairs: its check, and each
    pair's steps those of its ``rigid_register`` run."""
    t0 = time.perf_counter()
    inputs = _cohort_inputs()
    torch.cuda.synchronize()
    print(f"[cohort] 8 pairs made in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = _batch_against_singles("cohort", "RECIPE", RECIPE, inputs, _cohort_gate)
    _need(launches, ("sweep_fwd", "sweep_bwd", "sweep_fwd_pairs", "sweep_bwd_pairs",
                     "sweep_fwd_flow", "sweep_bwd_flow"), "make_cascade_batch_fn")
    del inputs
    return launches, phase_cohort_rigid()


# [cohort-unet]: make_pair seeds 0-1 and make_flow_truth_pair seeds 1-2 at
# 240³ through make_cascade_batch_fn(**RECIPE_UNET), each pair its own U-Net
# (K3 with a weight set per pair), against its own make_cascade_fn run
# within [cohort]'s limits; the seed-1 deformable pair ([unet]'s) meets
# [unet]'s gates
COHORT_UNET_PAIR_SEEDS, COHORT_UNET_TRUTH_SEEDS = (0, 1), (1, 2)
COHORT_UNET_B = len(COHORT_UNET_PAIR_SEEDS) + len(COHORT_UNET_TRUTH_SEEDS)


def _unet_gate(kind, seed, q):
    if kind != "deformable" or seed != 1:
        return None
    ok = (q["flow_truth_rmse_reduction_pct"] >= UNET_GATES["unet_flow_truth_rmse_reduction_pct"]
          and q["flow_field_err_vox"] <= UNET_GATES["unet_flow_field_err_vox"]
          and q["flow_field_err_observable_vox"]
          <= UNET_GATES["unet_flow_field_err_observable_vox"])
    return None if ok else "UNET_GATES"


def phase_cohort_unet() -> dict:
    """The U-Net cohort: ``make_cascade_batch_fn(**RECIPE_UNET)`` on 4 pairs
    at 240³ (the U-Net at full width, its 120³ flow level at ``flow_max_size``
    160), each pair training its own net from the recipe's seed, against its
    single runs (``_batch_against_singles``); it must launch K3 with a weight
    set per pair (forward, input gradient, weight gradient)."""
    t0 = time.perf_counter()
    inputs = _cohort_inputs(COHORT_UNET_PAIR_SEEDS, COHORT_UNET_TRUTH_SEEDS)
    torch.cuda.synchronize()
    print(f"[cohort-unet] {len(inputs)} pairs made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = _batch_against_singles("cohort-unet", "RECIPE_UNET", RECIPE_UNET, inputs,
                                      _unet_gate)
    _need(launches, ("sweep_fwd_pairs", "sweep_bwd_pairs", "sweep_fwd_flow", "sweep_bwd_flow",
                     "conv3d_fwd_pairs", "conv3d_dgrad_pairs", "conv3d_wgrad_pairs"),
          "make_cascade_batch_fn(**RECIPE_UNET)")
    return launches


def phase_cohort_rigid() -> dict:
    """``register_cohort`` rigid on the cohort driver's 8 perturbed pairs at
    240³ (``COHORT_RIGID``): max |theta - true| < 0.05, a lower RMSE after
    the exact re-warp, and each pair's steps and best theta those of its own
    ``rigid_register`` run."""
    movings, targets, trues = driver_cohort(8, (SIZE,) * 3, device=DEV)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = register_cohort(movings, targets, **COHORT_RIGID)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    err = float(torch.max(torch.abs(res.best_theta[:, 0] - trues)))
    warped = blocked.warp_affine_fast(res.best_theta[:, 0], movings)
    rmse0 = float(torch.sqrt(torch.mean((movings - targets) ** 2)))
    rmse1 = float(torch.sqrt(torch.mean((warped - targets) ** 2)))
    kw = {k: v for k, v in COHORT_RIGID.items() if k != "mode"}
    solo_steps, same, t0 = [], 0, time.perf_counter()
    for b in range(movings.shape[0]):
        _, solo = rigid_register(movings[b:b + 1], targets[b:b + 1], grad_edges=False, **kw)
        solo_steps.append(solo.steps)
        same += _same_bits(res.best_theta[b], solo.best_theta)
    torch.cuda.synchronize()
    wall_solo = time.perf_counter() - t0
    print(f"[cohort] register_cohort rigid, 8 pairs at {SIZE}³: steps {res.steps}, alone "
          f"{solo_steps}; best thetas equal to the bit {same} of 8; max |theta - true| = "
          f"{err:.5f}; RMSE {rmse0:.5f} -> {rmse1:.5f}; wall {wall:.3f} s, the 8 single runs "
          f"{wall_solo:.3f} s; K1 launches {json.dumps({k: v for k, v in launches.items() if k.startswith('sweep') and v})}",
          flush=True)
    if res.steps != solo_steps or not (err < 0.05 and rmse1 < rmse0):
        raise AssertionError(f"[cohort] register_cohort rigid failed: steps {res.steps} vs "
                             f"{solo_steps}, err {err}, RMSE {rmse0} -> {rmse1}")
    _need(launches, ("sweep_fwd_pairs", "sweep_bwd_pairs"), "register_cohort")
    return launches


# [mesh]: the data axis on a mesh that names the card twice (the pairs of
# MESH_PAIRS, each against its batched run above), and the space axis: K1's
# slab mode at 240³ on MESH_SLABS z-slabs (the engines' default window, 60),
# and rigid_register on slabs against its unsharded run
MESH_SLABS = 4
MESH_K = max(8, SIZE // 4)
MESH_RIGID = dict(lr=3e-3, epochs=40, criterions=["mse", "ncc"], optimizer="adam",
                  init="identity", grad_edges=True)
MESH_THETA_TOL = 1e-4  # theta, relative to its largest entry, sharded against unsharded


def _mesh_data(tag: str, recipe_name: str, recipe: dict) -> dict:
    """``make_cascade_batch_fn(mesh=make_mesh(devices=[card] * 2))`` on the
    pairs kept from ``[tag]``: every field of every pair equal to the
    unsharded batched run's to the bit; returns its launches."""
    movings, targets, ref = MESH_REFS[tag][:3]
    mesh = make_mesh(devices=[DEV] * 2)
    fn = make_cascade_batch_fn(mesh=mesh, **recipe)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(movings, targets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    bits = {n: _same_bits(getattr(res, n), getattr(ref, n))
            for n in ("warped", "theta", "flow", "rigid_losses", "affine_losses", "flow_losses")
            if getattr(ref, n) is not None}
    graphs = {str(d): g.counts() for d, g in fn.graphs.items()}
    B = movings.shape[0]
    print(f"[mesh] data axis: make_cascade_batch_fn(mesh=make_mesh(devices=[card] * 2), "
          f"**{recipe_name}) on {B} of [{tag}]'s {SIZE}³ pairs, {B // 2} a shard, "
          f"{len(mesh.distinct_devices)} distinct device(s): wall {wall:.3f} s; step graphs "
          f"(captures, replays) {json.dumps(graphs)}; equal to the unsharded batched run's "
          f"pairs to the bit {json.dumps(bits)}, steps {res.steps == ref.steps}", flush=True)
    if not all(bits.values()) or res.steps != ref.steps:
        raise AssertionError(f"[mesh] {tag}: a sharded pair differs from its unsharded run: "
                             f"{bits}")
    _drop_mesh_factories()  # their graphs and pools: later phases need the memory
    del fn, res
    torch.cuda.empty_cache()
    return launches


def _drop_mesh_factories() -> None:
    """Take the factories made on a mesh out of ``make_cascade_batch_fn``'s
    cache."""
    for key in [k for k in cascade_mod._BATCH_CACHE
                if len(k) > 1 and k[-2][0] == "mesh"]:
        del cascade_mod._BATCH_CACHE[key]


def _slab_case():
    """make_pair's moving image at 240³, the table of make_pair's rigid
    transform, its passes' axes, its slabs and their geometry, and a seeded
    cotangent with its slabs."""
    moving = make_pair((SIZE,) * 3, seed=0, device=DEV)[0]
    table, axes = k1.pass_table(factor_passes(*affine_to_index_map(_pair_theta()[0],
                                                                  (SIZE,) * 3)))
    gen = torch.Generator(device=DEV).manual_seed(19)
    g = torch.randn(moving.shape, generator=gen, device=DEV)
    m = SIZE // MESH_SLABS
    sh = pmesh.volume_sharding(make_mesh((MESH_SLABS,), ("space",),
                                         devices=[DEV] * MESH_SLABS))
    geos = tuple(k1.SlabGeo(0, k * m, SIZE) for k in range(MESH_SLABS))
    return moving, g, table.contiguous(), axes, sh, geos


def _slab_buffers(slabs, axis):
    h = k1.slab_halo(MESH_K)
    return halo.fetch(slabs, 2, h, h) if axis == 0 else slabs


def _mesh_space_warp() -> dict:
    """K1's slab mode at 240³ on 4 z-slabs: the whole warp (a halo before the
    z pass; the upstream gradient's halo in its backward) against the
    unsharded launches, output and dsrc to the bit, the table's gradient
    within 1e-5 of its largest entry; then each slab launch of each pass,
    forward and backward, against its plain version (f32, 1e-5 of the
    largest entry)."""
    moving, g, table, axes, sh, geos = _slab_case()
    windows = (MESH_K,) * 3

    def run(slabs):
        slabs = [x.clone().requires_grad_(True) for x in slabs]
        t = table.clone().requires_grad_(True)
        if len(slabs) == 1:
            outs, gs = [k1._SeparableAffine.apply(slabs[0], t, axes, windows)], [g]
        else:
            outs = list(k1._SlabAffine.apply(t, axes, windows, geos, *slabs))
            gs = list(torch.split(g, SIZE // MESH_SLABS, dim=2))
        grads = torch.autograd.grad(outs, [*slabs, t], gs)
        return torch.cat(outs, 2), torch.cat(grads[:-1], 2), grads[-1]

    ref = run([moving])
    got = run(pmesh.shard(moving, sh).shards)
    out_eq, dsrc_eq = _same_bits(got[0], ref[0]), _same_bits(got[1], ref[1])
    row_rel = float((got[2] - ref[2]).abs().max() / ref[2].abs().max())
    slabs, gslabs = pmesh.shard(moving, sh).shards, pmesh.shard(g, sh).shards
    fwd_err = bwd_err = drow_rel = 0.0  # of the largest entry
    fwd_abs = bwd_abs = 0.0
    for p, axis in enumerate(axes):
        bufs, gbufs = _slab_buffers(slabs, axis), _slab_buffers(gslabs, axis)
        for k, geo in enumerate(geos):
            shape = slabs[k].shape
            out = k1.affine_slab_fwd(bufs[k], table, p, axis, MESH_K, geo, shape)
            plain = k1.sweep_affine_slab_plain(bufs[k], table[p, :3], table[p, 3], axis, MESH_K,
                                               geo, shape)
            fwd_abs = max(fwd_abs, _max_err(out, plain))
            fwd_err = max(fwd_err, _max_err(out, plain) / float(plain.abs().max()))
            dsrc, drow = k1.affine_slab_bwd(gbufs[k], bufs[k], table, p, axis, MESH_K, geo, shape)
            dtable = torch.zeros_like(table)
            pdsrc = k1._slab_bwd_plain(gbufs[k], bufs[k], table, p, axis, MESH_K, geo, shape,
                                       True, dtable)
            bwd_abs = max(bwd_abs, _max_err(dsrc, pdsrc))
            bwd_err = max(bwd_err, _max_err(dsrc, pdsrc) / float(pdsrc.abs().max()))
            drow_rel = max(drow_rel, float((drow - dtable[p]).abs().max()
                                           / dtable[p].abs().max()))
    print(f"[mesh] space axis: K1's slab mode, make_pair's moving image at {SIZE}³ on "
          f"{MESH_SLABS} z-slabs of {SIZE // MESH_SLABS} rows, K={MESH_K} (a halo of "
          f"{k1.slab_halo(MESH_K)} rows a side), make_pair's rigid transform: warp equal to the "
          f"unsharded launches' to the bit {out_eq}, dsrc {dsrc_eq}, the table's gradient "
          f"within {row_rel:.3g} of its largest entry; each slab launch against its plain "
          f"version: forward {fwd_abs:.3g}, dsrc {bwd_abs:.3g} ({fwd_err:.3g} and {bwd_err:.3g} "
          f"of the largest entry), row gradient {drow_rel:.3g} (relative)", flush=True)
    if not (out_eq and dsrc_eq) or row_rel > 1e-5 or max(fwd_err, bwd_err) > 1e-5:
        raise AssertionError("[mesh] K1's slab mode disagrees")
    del ref, got
    torch.cuda.empty_cache()
    return {"sweep_fwd_slab": fwd_abs, "sweep_bwd_slab": bwd_abs,
            "sweep_slab_row_grad_rel": max(row_rel, drow_rel)}


def _mesh_space_rigid(smi: str) -> dict:
    """``rigid_register`` (MSE + NCC, ``grad_edges=True``, Adam, 40 steps)
    on make_pair's 240³ pair split into 4 z-slabs against its unsharded run:
    the same steps, ``theta`` within ``MESH_THETA_TOL`` of its largest entry;
    the halo bytes a step, and the wall of each run over its steps. Returns
    the sharded run's launches."""
    moving, target = make_pair((SIZE,) * 3, seed=0, device=DEV)
    sh = _slab_case()[4]
    runs = {"unsharded": (moving, target),
            f"{MESH_SLABS} slabs": (pmesh.shard(moving, sh), pmesh.shard(target, sh))}
    out, launches = {}, {}
    for label, (m, t) in runs.items():
        rigid_register(m, t, **{**MESH_RIGID, "epochs": 2})  # warm-up
        _reset_counts()
        halo.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, res = rigid_register(m, t, **MESH_RIGID)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        out[label] = (res, wall, halo.copied_bytes)
    (ref, wall0, _), (res, wall1, counted) = out.values()
    rel = float((res.best_theta - ref.best_theta).abs().max() / ref.best_theta.abs().max())
    step = halo.bytes_of((1, 1, SIZE // MESH_SLABS, SIZE, SIZE), 2, MESH_SLABS,
                         k1.slab_halo(MESH_K), k1.slab_halo(MESH_K), 4)
    row = {"steps": res.steps, "unsharded_steps": ref.steps, "theta_max_rel_err": rel,
           "halo_bytes_per_step": 2 * step, "halo_bytes_counted": counted,
           "ms_per_step": 1e3 * wall1 / res.steps, "unsharded_ms_per_step": 1e3 * wall0 / ref.steps,
           "device": smi}
    print(f"[mesh] space axis: rigid_register(**{json.dumps(MESH_RIGID)}) on make_pair's "
          f"{SIZE}³ pair on {MESH_SLABS} z-slabs: {json.dumps(row)}; K1 launches of the "
          f"sharded run {json.dumps({k: v for k, v in launches.items() if k.startswith('sweep') and v})}",
          flush=True)
    if res.steps != ref.steps or rel > MESH_THETA_TOL:
        raise AssertionError(f"[mesh] rigid_register on slabs is off its unsharded run: {row}")
    _need(launches, ("sweep_fwd_slab", "sweep_bwd_slab", "conv3d_fwd"), "rigid_register on slabs")
    return launches


# [mesh-flow], [mesh-unet], [mesh-lm]: the flow engine and LM on 4 z-slabs.
# K1's flow form on slabs at the recipe's fine flow level's window
# (flow_max_disp), sweep_bwd2 on slabs at K = 8 f32 (the LM paths' window)
MESH_FLOW_K = 8
MESH_BWD2_K = 8
# the recipe's fine flow level (RECIPE: Adam, lr 0.3, MSE + NCC, window 8,
# plateau stop 1e-3 / 25) with smooth 0.25, at most 60 steps
MESH_FLOW = dict(flow_model="field", lr=RECIPE["flow_lr"], optimizer="adam",
                 criterions=["mse", "ncc"], smooth=0.25, max_disp=MESH_FLOW_K, stop_rel=1e-3,
                 patience=25, max_epochs=60)
# the field on slabs against the unsharded field after MESH_FLOW's 60 steps
# (voxels; the losses relative). Adam normalizes each entry's step, so the
# slab sums' last-bit differences move entries whose gradient is near 0 by
# up to lr a step, and the runs part: 0.169 voxel and 1.1e-3 on the H100
# (700 W). The phase prints beside them the same
# unsharded run on the moving image raised by one ulp, which parts from it
# alike
MESH_FLOW_TOL_VOX = 0.5
MESH_FLOW_LOSS_RTOL = 1e-2
# RECIPE_UNET's net (n = 8, the depth max_depth_for gives) at its finest
# flow level's size, 20 steps of the recipe's Adam from a seeded init with
# the flow head zeroed (the cascade's residual start). Adam at lr 0.3 on a
# net's weights is chaotic: a last-bit change parts two runs (UNET_RUNS'
# note), so this run is held to the same first loss and printed beside the
# unsharded run on the moving image raised by one ulp
MESH_UNET_SIZE = 120
MESH_UNET = dict(flow_model="unet", lr=RECIPE_UNET["flow_lr"], optimizer="adam",
                 criterions=["mse", "ncc"], n=RECIPE_UNET["n"], max_disp=MESH_FLOW_K,
                 max_epochs=20, zero_head=True)
# the same net and steps at tests/test_parallel.py:273's lr 1e-3 from the
# seeded init with its flow head (every layer learns from step 0). On the
# H100 these runs part too (the one-ulp run further than the slabs: PERF.md
# §6), so the flow after training is printed, not held, and the slabs'
# training is held one step at a time: one SGD step (lr 1) from the same
# init (MESH_UNET_STEP), each weight's step against the unsharded step
MESH_UNET_JAX_LR = {**MESH_UNET, "lr": 1e-3, "zero_head": False}
MESH_UNET_STEP = {**MESH_UNET, "optimizer": "sgd", "lr": 1.0, "zero_head": False}
# tests/test_parallel.py:295's tolerance (JAX's U-Net on slabs against
# unsharded), held by the net on slabs at fixed weights
MESH_UNET_RTOL, MESH_UNET_ATOL = 2e-3, 2e-4
# each weight's step or gradient on slabs against the unsharded one, of that
# weight's own largest entry: a gradient dropped on slabs is off by 1, while
# the unsharded net's gradients on the moving image raised by one ulp move
# by up to 5.0e-2 at the seeded init (H100, 700 W: sums of 118³ products
# that mostly cancel). A weight whose unsharded gradient moves by more than
# MESH_UNET_NOISE of its largest entry under that ulp carries rounding
# only (a bias whose channel the ReLU passes whole into an instance norm):
# it is printed, not held
MESH_UNET_GRAD_TOL = 5e-2
MESH_UNET_NOISE = 0.5
# LM_RECIPE's coarse matrix level (60³), rigid LM from the identity
MESH_LM_SIZE = 60
MESH_LM = dict(epochs=4, criterions=["mse", "ncc"], optimizer="lm", init="identity",
               check_window=False)


def _flow_slab_case():
    """make_flow_truth_pair's moving image and true field at 240³, a seeded
    cotangent, the 4 z-slab sharding and its geometry."""
    moving, _, _, flow = make_flow_truth_pair((SIZE,) * 3, seed=1, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(20)
    g = torch.randn(moving.shape, generator=gen, device=DEV)
    sh = _slab_case()[4]
    m = SIZE // MESH_SLABS
    geos = tuple(k1.SlabGeo(0, k * m, SIZE) for k in range(MESH_SLABS))
    return moving, flow.float().contiguous(), g, sh, geos


def _mesh_flow_kernels() -> dict:
    """K1's flow form on 4 z-slabs at 240³ (K = MESH_FLOW_K): the whole flow
    warp (the z pass on each slab's buffer with a halo of K + 1 rows, its
    backward the halos of g and of the field's channel) against the
    unsharded launches, output, dsrc and the field's gradient to the bit;
    each slab's z-pass launches against their plain versions. Then
    ``sweep_slab_bwd2`` (K = 8, f32, make_pair's rigid transform, each pass)
    against the unsharded ``sweep_bwd2``, gbar and sbar to the bit, the row
    gradient summed over the slabs within 1e-5 of its largest entry, and
    against its plain version. f32: 1e-5 of the largest entry."""
    moving, flow, g, sh, geos = _flow_slab_case()
    K = MESH_FLOW_K
    s0, f0 = moving.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    ref = k1._SeparableFlow.apply(s0, f0, K)
    rds, rdf = torch.autograd.grad(ref, (s0, f0), g)
    ss, fs = pmesh.shard(moving, sh), pmesh.shard(flow, sh)
    for t in ss.shards + fs.shards:
        t.requires_grad_(True)
    out = k1.sweep_flow_slabs(ss, fs, K)
    grads = torch.autograd.grad(out.shards, ss.shards + fs.shards, pmesh.shard(g, sh).shards)
    n = MESH_SLABS
    eq = {"warp": _same_bits(pmesh.gather(out), ref),
          "dsrc": _same_bits(torch.cat(grads[:n], 2), rds),
          "dflow": _same_bits(torch.cat(grads[n:], 2), rdf)}
    del ref, rds, rdf, out, grads, s0, f0
    slabs = [s.detach() for s in ss.shards]
    flows = [f.detach() for f in fs.shards]
    shape = slabs[0].shape
    bufs = k1._halo_of(slabs, 0, K, geos)
    gbufs = k1._halo_of(pmesh.shard(g, sh).shards, 0, K, geos)
    ubufs = k1._halo_of([f[:, 0:1] for f in flows], 0, K, geos)
    errs = {"sweep_fwd_slab_flow": 0.0, "sweep_bwd_slab_flow": 0.0}
    rel = 0.0
    for k, geo in enumerate(geos):
        o = k1.flow_slab_fwd(bufs[k], flows[k], 0, K, geo, shape)
        po = k1.sweep_flow_slab_plain(bufs[k], flows[k][:, 0:1], 0, K, geo, shape)
        ds, du = k1.flow_slab_bwd(gbufs[k], bufs[k], ubufs[k], 0, K, geo, shape)
        dfl = torch.zeros_like(flows[k])
        pds = k1._flow_slab_bwd_plain(gbufs[k], bufs[k], ubufs[k], 0, K, geo, shape, True, dfl)
        errs["sweep_fwd_slab_flow"] = max(errs["sweep_fwd_slab_flow"], _max_err(o, po))
        errs["sweep_bwd_slab_flow"] = max(errs["sweep_bwd_slab_flow"], _max_err(ds, pds),
                                          _max_err(du, dfl[:, 0]))
        rel = max(rel, _max_err(o, po) / float(po.abs().max()),
                  _max_err(ds, pds) / float(pds.abs().max()),
                  _max_err(du, dfl[:, 0]) / float(dfl.abs().max()))
    del bufs, gbufs, ubufs, slabs, flows
    torch.cuda.empty_cache()
    # sweep_bwd2 on slabs
    src, gg, ubar, table, rbar, axes = _bwd2_case(SIZE, MESH_BWD2_K, torch.float32, 0, 2030)
    Kb, m = MESH_BWD2_K, SIZE // n
    bwd2_eq, row_rel, b2_err, b2_rel = True, 0.0, 0.0, 0.0

    def split(x):
        return list(torch.split(x, m, 2))

    for p, axis in enumerate(axes):
        gbar, sbar, drow = k1.affine_bwd2(gg, src, table, p, axis, Kb, ubar, rbar[p])
        bufs, gbufs, ubufs = (k1._halo_of(split(x), axis, Kb, geos) for x in (src, gg, ubar))
        outs = [k1.affine_slab_bwd2(gb, b, ub, table, p, axis, Kb, geo, shape, rbar[p])
                for gb, b, ub, geo in zip(gbufs, bufs, ubufs, geos)]
        bwd2_eq &= _same_bits(torch.cat([o[0] for o in outs], 2), gbar)
        bwd2_eq &= _same_bits(torch.cat([o[1] for o in outs], 2), sbar)
        total = pmesh.ordered_sum([o[2] for o in outs], DEV)
        row_rel = max(row_rel, float((total - drow).abs().max() / drow.abs().max()))
        for k in (0, n - 1):
            pg, psb_, pr = k1.sweep_bwd2_slab_plain(gbufs[k], bufs[k], ubufs[k], rbar[p],
                                                    table[p, :3], table[p, 3], axis, Kb,
                                                    geos[k], shape)
            for a, b in ((outs[k][0], pg), (outs[k][1], psb_)):
                b2_err = max(b2_err, _max_err(a, b))
                b2_rel = max(b2_rel, _max_err(a, b) / float(b.abs().max()))
            row_rel = max(row_rel, float((outs[k][2] - pr).abs().max() / pr.abs().max()))
        del bufs, gbufs, ubufs, outs
    errs["sweep_bwd2_slab"] = b2_err
    errs["sweep_slab_bwd2_row_grad_rel"] = row_rel
    print(f"[kernel] slab mode, {SIZE}³ on {MESH_SLABS} z-slabs: K1's flow form (K={K}, "
          f"make_flow_truth_pair's moving image and true field) equal to the unsharded "
          f"launches to the bit {json.dumps(eq)}, each slab's z pass against its plain "
          f"version: forward {errs['sweep_fwd_slab_flow']:.3g}, backward "
          f"{errs['sweep_bwd_slab_flow']:.3g} ({rel:.3g} of the largest entry); sweep_slab_bwd2 "
          f"(K={Kb}, f32) gbar and sbar equal to the unsharded sweep_bwd2 to the bit "
          f"{bwd2_eq}, against the plain version {b2_err:.3g} ({b2_rel:.3g} of the largest "
          f"entry), row gradient within {row_rel:.3g} (relative)", flush=True)
    if not all(eq.values()) or not bwd2_eq or max(rel, b2_rel, row_rel) > 1e-5:
        raise AssertionError("[kernel] K1's flow form or sweep_bwd2 on slabs disagrees")
    del src, gg, ubar
    torch.cuda.empty_cache()
    return errs


def _ulp_up(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every entry raised by one ulp."""
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def _run_pair(fn, m, t, warm: dict) -> tuple:
    """``fn(m, t)`` after a warm-up ``fn(m, t, **warm)``: ``(result, wall,
    launches, halo bytes)``, the counts set to 0 just before the timed run."""
    fn(m, t, **warm)
    _reset_counts()
    halo.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(m, t)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts(), halo.copied_bytes


def _mesh_flow(smi: str) -> dict:
    """[mesh-flow]: ``flow_register(flow_model='field')`` at the recipe's
    fine flow level on make_flow_truth_pair's 240³ pair, on 4 z-slabs
    against the unsharded run: the same steps, the field within
    ``MESH_FLOW_TOL_VOX`` voxels, the losses within ``MESH_FLOW_LOSS_RTOL``;
    ms a step, halo bytes a step. Returns the sharded run's launches."""
    moving, target = make_flow_truth_pair((SIZE,) * 3, seed=1, device=DEV)[:2]
    sh = _slab_case()[4]
    fn = functools.partial(flow_register, **MESH_FLOW)
    warm = {"max_epochs": 2}
    (_, ref), wall0, _, _ = _run_pair(fn, moving, target, warm)
    (warped, res), wall1, launches, nbytes = _run_pair(
        fn, pmesh.shard(moving, sh), pmesh.shard(target, sh), warm)
    steps = res.steps

    def dev(run):
        rel = ((run.losses[:steps] - ref.losses[:steps]).abs() / ref.losses[:steps].abs())
        over = torch.nonzero(rel > 1e-5)
        return (float((pmesh.gather(run.flow) - ref.flow).abs().max()), float(rel.max()),
                int(over[0]) if len(over) else None)

    dvox, lrel, first = dev(res)
    # the same unsharded run on the moving image raised by one ulp
    other = flow_register(_ulp_up(moving), target, **MESH_FLOW)[1]
    row = {"steps": steps, "unsharded_steps": ref.steps, "flow_max_abs_dev_vox": dvox,
           "loss_max_rel_dev": lrel, "first_step_loss_rel_dev_over_1e-5": first,
           "unsharded_one_ulp": dict(zip(("flow_max_abs_dev_vox", "loss_max_rel_dev",
                                              "first_step_loss_rel_dev_over_1e-5"),
                                             dev(other))),
           "ms_per_step": 1e3 * wall1 / steps,
           "unsharded_ms_per_step": 1e3 * wall0 / ref.steps,
           "halo_bytes_per_step": nbytes / steps, "device": smi}
    print(f"[mesh-flow] flow_register(**{json.dumps(MESH_FLOW)}) on make_flow_truth_pair's "
          f"{SIZE}³ pair on {MESH_SLABS} z-slabs against unsharded: {json.dumps(row)}; K1 "
          f"launches of the sharded run "
          f"{json.dumps({k: v for k, v in launches.items() if k.startswith('sweep') and v})}",
          flush=True)
    if (steps != ref.steps or dvox > MESH_FLOW_TOL_VOX or lrel > MESH_FLOW_LOSS_RTOL
            or not isinstance(warped, pmesh.Sharded)):
        raise AssertionError(f"[mesh-flow] the field on slabs is off its unsharded run: {row}")
    _need(launches, ("sweep_fwd_slab_flow", "sweep_bwd_slab_flow", "sweep_fwd_flow",
                     "sweep_bwd_flow"), "flow_register on slabs")
    del moving, target, ref, res, warped
    torch.cuda.empty_cache()
    return launches


def _outside(flow: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of ``flow``'s entries outside ``MESH_UNET_RTOL`` /
    ``MESH_UNET_ATOL`` of ``ref``."""
    over = (flow - ref).abs() > MESH_UNET_ATOL + MESH_UNET_RTOL * ref.abs()
    return float(over.float().mean())


def _per_weight(got: dict, ref: dict, ulp: dict) -> dict:
    """Each weight's ``got`` against ``ref`` (steps or gradients by name), of
    ``ref``'s largest entry of that weight, beside ``ulp`` (the same on the
    moving image raised by one ulp); the largest over the weights that carry
    more than rounding (``MESH_UNET_NOISE``)."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    per = {k: [rel(got[k], ref[k]), rel(ulp[k], ref[k])] for k in ref}
    held = {k: v for k, v in per.items() if v[1] <= MESH_UNET_NOISE}
    return {"max_rel_dev": max(v[0] for v in held.values()),
            "worst": dict(sorted(held.items(), key=lambda kv: -kv[1][0])[:3]),
            "rounding_only": {k: v for k, v in per.items() if k not in held},
            "per_weight": per}


def _unet_slab_check(params: dict, m) -> dict:
    """The U-Net at ``params`` on the slabs of ``m`` against the same net
    unsharded: the flow (max |dev| and the share of voxels outside
    ``MESH_UNET_RTOL`` / ``MESH_UNET_ATOL``) and each weight's gradient of a
    seeded cotangent (:func:`_per_weight`)."""
    from torchregister_tpu_torch.engines.flow import _predict_slabs, _unet

    net = _unet(m, RECIPE_UNET["n"], 1, None, True, True, torch.float32, params, False, None)
    names, weights = zip(*net.named_parameters())
    gen = torch.Generator(device=DEV).manual_seed(21)
    sh = _slab_case()[4]
    ref = net(m)
    cot = torch.randn(ref.shape, generator=gen, device=DEV)

    def grads(outs, cots):
        return dict(zip(names, torch.autograd.grad(outs, weights, cots)))

    gref, gulp = grads(ref, cot), grads(net(_ulp_up(m)), cot)
    got = _predict_slabs(net, pmesh.shard(m, sh), False)
    gs = grads(got.shards, pmesh.shard(cot, sh).shards)
    flow, ref = pmesh.gather(got).detach(), ref.detach()
    return {"flow_max_abs_dev": float((flow - ref).abs().max()),
            "flow_share_outside_tol": _outside(flow, ref), **_per_weight(gs, gref, gulp)}


def _unet_step_check(moving, target) -> dict:
    """One training step on slabs (``MESH_UNET_STEP``: the whole step, the
    loss and the warp on slabs, the net's backward, the optimizer) against
    the unsharded step from the same weights: each weight's step
    (:func:`_per_weight`)."""
    sh = _slab_case()[4]

    def params(m, t, epochs=1):
        return flow_register(m, t, generator=torch.Generator().manual_seed(0),
                             **{**MESH_UNET_STEP, "max_epochs": epochs})[1].params

    p0 = params(moving, target, 0)

    def step(m, t):
        return {k: v - p0[k] for k, v in params(m, t).items()}

    return _per_weight(step(pmesh.shard(moving, sh), pmesh.shard(target, sh)),
                       step(moving, target), step(_ulp_up(moving), target))


def _mesh_unet(smi: str) -> dict:
    """[mesh-unet]: ``flow_register(flow_model='unet')`` with RECIPE_UNET's
    net at 120³ on 4 z-slabs against the unsharded run, twice: the recipe's
    Adam (``MESH_UNET``) and at lr 1e-3 (``MESH_UNET_JAX_LR``), each with the
    same steps and the same first loss (1e-5), the final losses and flows
    printed beside the unsharded run on the moving image raised by one ulp.
    Then one SGD step on slabs against the unsharded step
    (:func:`_unet_step_check`), and at the recipe run's final weights and
    at the initial ones the net on slabs against the net unsharded
    (:func:`_unet_slab_check`): the flow within tests/test_parallel.py:295's
    tolerance, each weight's step or gradient within ``MESH_UNET_GRAD_TOL``
    of its own largest entry; K3 launches, ms a step. Returns the recipe
    run's launches."""
    S = MESH_UNET_SIZE
    moving, target = make_flow_truth_pair((S,) * 3, seed=1, device=DEV)[:2]
    sh = _slab_case()[4]
    warm = {"max_epochs": 2}
    runs, bad = {}, []
    for tag, cfg in (("recipe", MESH_UNET), ("lr_1e-3", MESH_UNET_JAX_LR)):
        def fn(m, t, cfg=cfg, **kw):
            return flow_register(m, t, generator=torch.Generator().manual_seed(0),
                                 **{**cfg, **kw})

        (_, ref), wall0, _, _ = _run_pair(fn, moving, target, warm)
        (warped, res), wall1, counts, nbytes = _run_pair(
            fn, pmesh.shard(moving, sh), pmesh.shard(target, sh), warm)
        other = fn(_ulp_up(moving), target)[1]  # the unsharded run, one ulp up
        flow = pmesh.gather(res.flow)
        n = ref.steps
        runs[tag] = {
            "steps": res.steps, "unsharded_steps": n,
            "first_loss_rel_dev": float(abs(res.losses[0] - ref.losses[0]) / abs(ref.losses[0])),
            "final_loss": float(res.losses[res.steps - 1]),
            "unsharded_final_loss": float(ref.losses[n - 1]),
            "final_flow_max_abs_dev_vox": float((flow - ref.flow).abs().max()),
            "final_flow_share_outside_tol": _outside(flow, ref.flow),
            "unsharded_one_ulp": {
                "final_loss": float(other.losses[other.steps - 1]),
                "final_flow_max_abs_dev_vox": float((other.flow - ref.flow).abs().max()),
                "final_flow_share_outside_tol": _outside(other.flow, ref.flow)},
            "ms_per_step": 1e3 * wall1 / res.steps, "unsharded_ms_per_step": 1e3 * wall0 / n,
            "halo_bytes_per_step": nbytes / res.steps}
        if (res.steps != n or runs[tag]["first_loss_rel_dev"] > 1e-5
                or not isinstance(warped, pmesh.Sharded)):
            bad.append(tag)
        if tag == "recipe":
            launches, final = counts, res.params
        del ref, res, other, warped, flow
    init = flow_register(moving, target, generator=torch.Generator().manual_seed(0),
                         **{**MESH_UNET, "max_epochs": 0, "zero_head": False})[1].params
    step = _unet_step_check(moving, target)
    checks = {"recipe_final_weights": _unet_slab_check(final, moving),
              "initial_weights": _unet_slab_check(init, moving)}
    bad += ["sgd_step"] * (step["max_rel_dev"] > MESH_UNET_GRAD_TOL)
    bad += [k for k, c in checks.items() if c["flow_share_outside_tol"] > 0
            or c["max_rel_dev"] > MESH_UNET_GRAD_TOL]

    def brief(c):
        return {k: v for k, v in c.items() if k != "per_weight"}

    row = {**runs, "sgd_step": brief(step),
           "net_on_slabs": {k: brief(c) for k, c in checks.items()},
           "k3_launches": {k: launches[k] for k in ("conv3d_fwd", "conv3d_dgrad",
                                                    "conv3d_wgrad")}, "device": smi}
    print(f"[mesh-unet] flow_register(**{json.dumps(MESH_UNET)}), then at lr 1e-3 "
          f"(zero_head off) and one SGD step, with RECIPE_UNET's net on "
          f"make_flow_truth_pair's {S}³ pair on {MESH_SLABS} z-slabs against unsharded: "
          f"{json.dumps(row)}", flush=True)
    if bad:
        raise AssertionError(f"[mesh-unet] the U-Net on slabs is off the unsharded net "
                             f"({bad}): {row}")
    _need(launches, ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad", "sweep_fwd_slab_flow",
                     "sweep_bwd_slab_flow"), "flow_register(flow_model='unet') on slabs")
    del moving, target
    torch.cuda.empty_cache()
    return launches


def _mesh_lm(smi: str) -> dict:
    """[mesh-lm]: ``rigid_register(optimizer='lm')`` (``MESH_LM``, the edge
    filter on) on make_pair's pair at LM_RECIPE's coarse size (60³) on 4
    z-slabs against the unsharded run: the same iterations, theta within
    ``MESH_THETA_TOL`` of its largest entry; ms an iteration. Returns the
    sharded run's launches."""
    S = MESH_LM_SIZE
    moving, target = make_pair((S,) * 3, seed=0, device=DEV)
    sh = _slab_case()[4]
    fn = functools.partial(rigid_register, **MESH_LM)
    warm = {"epochs": 1}
    (_, ref), wall0, _, _ = _run_pair(fn, moving, target, warm)
    (_, res), wall1, launches, nbytes = _run_pair(
        fn, pmesh.shard(moving, sh), pmesh.shard(target, sh), warm)
    rel = float((res.best_theta - ref.best_theta).abs().max() / ref.best_theta.abs().max())
    hist = float((res.param_history[:res.steps] - ref.param_history[:ref.steps]).abs().max())
    row = {"iterations": res.steps, "unsharded_iterations": ref.steps,
           "theta_max_rel_err": rel, "param_history_max_abs_dev": hist,
           "ms_per_iteration": 1e3 * wall1 / res.steps,
           "unsharded_ms_per_iteration": 1e3 * wall0 / ref.steps,
           "halo_bytes_per_iteration": nbytes / res.steps,
           "sweep_bwd2_slab": launches["sweep_bwd2_slab"], "device": smi}
    print(f"[mesh-lm] rigid_register(**{json.dumps(MESH_LM)}) on make_pair's {S}³ pair on "
          f"{MESH_SLABS} z-slabs against unsharded: {json.dumps(row)}", flush=True)
    if res.steps != ref.steps or rel > MESH_THETA_TOL:
        raise AssertionError(f"[mesh-lm] LM on slabs is off its unsharded run: {row}")
    _need(launches, ("sweep_fwd_slab", "sweep_bwd_slab", "sweep_bwd2_slab"),
          "rigid_register(optimizer='lm') on slabs")
    return launches


def phase_mesh() -> list:
    """The ``data`` axis: ``[cohort]``'s and ``[cohort-unet]``'s kept pairs
    over a mesh that names the card twice; returns the paths' launches.
    The ``space`` axis runs last but ``[busy]`` (``phase_mesh_space``)."""
    return [_mesh_data("cohort", "RECIPE", RECIPE),
            _mesh_data("cohort-unet", "RECIPE_UNET", RECIPE_UNET)]


def phase_mesh_space(smi: str) -> tuple[dict, dict, list]:
    """The ``space`` axis: K1's slab modes timed (``phase_slab_times``) and
    held against the unsharded launches and their plain versions, then
    ``rigid_register`` on slabs, the flow engine's two modes and LM
    (``[mesh-flow]``, ``[mesh-unet]``, ``[mesh-lm]``); then K2's slab mode
    and the exact method on slabs (``[mesh-exact]``) and the cascade over a
    ``data x space`` mesh (``[mesh-batch]``, ``[mesh-batch-unet]``). Last but ``[busy]``:
    with the slab work earlier, later phases' profiled device times came
    back empty on the H100. Returns the slab rows, the deviations and the
    engine runs' launches."""
    rows = phase_slab_times()
    rows.update(_slab_flow_times())
    _k3_slab_times()
    rows.update(_k2_slab_times())
    errs = _mesh_space_warp()
    errs.update(_mesh_flow_kernels())
    paths = [_mesh_space_rigid(smi), _mesh_flow(smi), _mesh_unet(smi), _mesh_lm(smi)]
    _mark("mesh space axis, one pair")
    exact_errs, exact_paths = _mesh_exact(smi)
    errs.update(exact_errs)
    paths += [*exact_paths, _mesh_batch(smi), _mesh_batch_unet(smi)]
    _mark("mesh space axis, cascades")
    paths += _mesh_criteria(smi)
    _mark("mesh-criteria")
    paths += phase_dryrun(smi)
    _mark("dryrun")
    return rows, errs, paths


# [mesh-batch], [mesh-batch-unet], [mesh-exact]: the cascade over a data x
# space mesh (make_cascade_batch_fn(mesh=, spatial_axis=0)) and K2's slab mode
MESH_GRID = (2, 4)  # data x space, the card named 8 times
# [mesh-batch-unet]: RECIPE_UNET's 300 flow epochs cut so that the phase's
# two slab runs stay near a minute (the net at its width, n=8)
MESH_BATCH_UNET = {**RECIPE_UNET, "flow_epochs": 40}
# [mesh-exact]: the engines with method='exact' on 4 z-slabs, a few steps each
MESH_EXACT_RIGID = dict(lr=3e-3, epochs=5, criterions=["mse"], optimizer="adam",
                        init="identity", grad_edges=False, method="exact")
MESH_EXACT_FLOW = dict(flow_model="field", lr=10.0, optimizer="sgd", criterions=["mse"],
                       smooth=0.25, max_epochs=4, method="exact")
# the final warp's check: the recipe cut to 2 levels and few epochs, one pair
MESH_EXACT_CASCADE = {**RECIPE, "final_warp": "exact", "levels": 2, "matrix_levels": 2,
                      "flow_levels": 2, "flow_smooth": (0.5, 0.25), "rigid_epochs": 60,
                      "affine_epochs": 30, "flow_epochs": 40}


def _grid_mesh(data: int, space: int):
    return make_mesh((data, space), ("data", "space"), devices=[DEV] * (data * space))


def _pair_of(res, b: int, gathered: dict) -> object:
    """Pair ``b`` of a batched result (``warped``, ``flow`` gathered)."""
    return res._replace(warped=gathered["warped"][b], theta=res.theta[b],
                        flow=None if res.flow is None else gathered["flow"][b],
                        steps={k: v[b] for k, v in res.steps.items()})


def _gathered(res) -> dict:
    return {n: None if getattr(res, n) is None else pmesh.gather(getattr(res, n))
            for n in ("warped", "flow")}


def _space_run(fn, movings, targets) -> tuple:
    """``fn(movings, targets)`` with the counts set to 0 just before: the
    result, its wall, launches, and the halo's bytes and fetches."""
    _reset_counts()
    halo.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(movings, targets)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _counts(), halo.copied_bytes, halo.calls


def _steps_apart(a: dict, b: dict) -> int:
    """The largest gap between two runs' steps at a stage's level."""
    return max(abs(x - y) for k in b for x, y in zip(a[k], b[k]))


def _ulp_down(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every entry lowered by one ulp."""
    return torch.nextafter(x, torch.full_like(x, float("-inf")))


def _one_pair(res, b: int):
    """Pair ``b`` of an unsharded batched result, its pair axis off."""
    one = _keep(res, [b])
    return one._replace(warped=one.warped[0], theta=one.theta[0],
                        flow=None if one.flow is None else one.flow[0],
                        steps={k: v[0] for k, v in one.steps.items()})


def _pairs_equal(res, others: list) -> list:
    """Each pair ``b`` of ``res`` against ``others[b] = (result, i)``, pair
    ``i`` of another run: every field to the bit, the steps."""
    got = _gathered(res)
    out = []
    for b, (other, i) in enumerate(others):
        mine, one = _pair_of(res, b, got), _pair_of(other, i, _gathered(other))
        same = (mine.steps == one.steps and _same_bits(mine.theta, one.theta)
                and _same_bits(mine.warped, one.warped)
                and (mine.flow is None or _same_bits(mine.flow, one.flow)))
        for n in ("rigid_losses", "affine_losses", "flow_losses"):
            if getattr(res, n) is not None:
                same = same and _same_bits(getattr(res, n)[b], getattr(other, n)[i])
        out.append(same)
    return out


def _level_warp_halo_bytes() -> int:
    """The halo bytes of one full-transform re-warp at 240³ on 4 z-slabs
    (``engines/cascade._level_warp``: K = max(8, S // 3), a halo of K + 1
    rows a side of each slab, f32), forward: the z pass's fetch."""
    K = max(8, SIZE // 3)
    m = SIZE // MESH_SLABS
    return halo.bytes_of((1, 1, m, SIZE, SIZE), 2, MESH_SLABS, K + 1, K + 1, 4)


def _steps_envelope(runs: list, b: int) -> dict:
    """Pair ``b``'s least and greatest steps at each stage's level over
    ``runs`` (each a list of per-pair step dicts)."""
    ks = runs[0][b].keys()
    return {k: [[min(r[b][k][i] for r in runs), max(r[b][k][i] for r in runs)]
                for i in range(len(runs[0][b][k]))] for k in ks}


def _envelopes_apart(a: dict, b: dict) -> int:
    """The largest gap between two step envelopes at a stage's level (0
    where they overlap)."""
    return max(max(0, x[0] - y[1], y[0] - x[1]) for k in a for x, y in zip(a[k], b[k]))


def _mesh_batch(smi: str) -> dict:
    """[mesh-batch]: ``make_cascade_batch_fn(mesh=(2, 4) data x space,
    spatial_axis=0, **RECIPE)`` on 4 of ``[cohort]``'s 240³ pairs (the rigid
    seeds 0, 1 and the deformable seeds 1, 2), 2 a row of 4 z-slabs: each
    pair equal to its own run on a ``(1, 4)`` mesh to the bit; against the
    unsharded batch (``[cohort]``'s run of these pairs) each pair's quality
    fields within ``COHORT_QUALITY_TOL``, the absolute gates
    (``_cohort_gate``), and its steps per stage and level: the slab run's
    steps and those of the same slab run on the moving images one ulp up
    and one ulp down, against the unsharded run's and those of the
    unsharded run on the moving or the target images one ulp up or down,
    each pair's two envelopes within ``COHORT_STEPS_TOL`` of each other. The
    plateau stops of ``RECIPE``'s matrix levels (``matrix_stop_rel`` 1e-3,
    patience 10) move by up to 10 steps under one ulp of input on the H100
    (PERF.md, PR 21), so one slab run against one unsharded run cannot be
    held to ±2; each envelope is a pair's own. Prints ms a pair and the halo
    bytes of the call."""
    movings, targets, ref, info, cohort_s = MESH_REFS.pop("cohort")
    B = movings.shape[0]
    fn = make_cascade_batch_fn(mesh=_grid_mesh(*MESH_GRID), spatial_axis=0, **RECIPE)
    res, wall, launches, nbytes, fetches = _space_run(fn, movings, targets)
    one = make_cascade_batch_fn(mesh=_grid_mesh(1, MESH_GRID[1]), spatial_axis=0, **RECIPE)
    t0 = time.perf_counter()
    rows = [one(movings[b:b + 1], targets[b:b + 1]) for b in range(B)]
    torch.cuda.synchronize()
    wall_one = (time.perf_counter() - t0) / B
    bits = _pairs_equal(res, [(r, 0) for r in rows])
    del rows
    slab_ulps = [fn(_ulp_up(movings), targets).steps, fn(_ulp_down(movings), targets).steps]
    flat = make_cascade_batch_fn(**RECIPE)
    ulps = [flat(_ulp_up(movings), targets), flat(_ulp_down(movings), targets),
            flat(movings, _ulp_up(targets)), flat(movings, _ulp_down(targets))]

    def per_pair(steps):
        return [{k: v[b] for k, v in steps.items()} for b in range(B)]

    slab_runs = [per_pair(st) for st in (res.steps, *slab_ulps)]
    flat_runs = [per_pair(st) for st in (ref.steps, *(u.steps for u in ulps))]
    got = _gathered(res)
    out, bad = [], []
    for b, (kind, seed, truth) in enumerate(info):
        m, t = movings[b:b + 1], targets[b:b + 1]
        mine, base = _pair_of(res, b, got), _one_pair(ref, b)
        up = _one_pair(ulps[0], b)
        if not (bool(torch.isfinite(mine.warped).all()) and bool(torch.isfinite(mine.flow).all())
                and tuple(mine.warped.shape) == tuple(m.shape)):
            raise AssertionError(f"[mesh-batch] pair {b} is not a finite volume of its shape")
        q, q_ref, q_ulp = (_pair_quality(kind, r, m, t, truth) for r in (mine, base, up))
        env, env_ref = _steps_envelope(slab_runs, b), _steps_envelope(flat_runs, b)
        dsteps = _envelopes_apart(env, env_ref)
        dq = max(abs(q[k] - q_ref[k]) for k in q)
        row = {"pair": f"{kind} seed {seed}", "steps": mine.steps, "unsharded_steps": base.steps,
               "slab_ulp_steps": [r[b] for r in slab_runs[1:]],
               "unsharded_ulp_steps": [r[b] for r in flat_runs[1:]],
               "steps_envelope": env, "unsharded_steps_envelope": env_ref,
               "envelopes_apart": dsteps, "steps_apart": _steps_apart(mine.steps, base.steps),
               "quality": q, "unsharded_quality": q_ref,
               "ulp_quality": q_ulp, "theta_vs_unsharded": _max_err(mine.theta, base.theta),
               "theta_ulp_vs_unsharded": _max_err(up.theta, base.theta),
               "flow_vs_unsharded_vox": _max_err(mine.flow, base.flow),
               "flow_ulp_vs_unsharded_vox": _max_err(up.flow, base.flow),
               "equal_to_its_row_run": bits[b]}
        out.append(row)
        print(f"[mesh-batch] {json.dumps(row)}", flush=True)
        if dsteps > COHORT_STEPS_TOL or dq > COHORT_QUALITY_TOL:
            bad.append((b, dsteps, dq))
        failed = _cohort_gate(kind, seed, q)
        if failed:
            raise AssertionError(f"[mesh-batch] {kind} seed {seed} gate failed: {failed}: {q}")
    print(f"[mesh-batch] make_cascade_batch_fn(mesh=(data {MESH_GRID[0]}, space "
          f"{MESH_GRID[1]}) naming the card {MESH_GRID[0] * MESH_GRID[1]} times, "
          f"spatial_axis=0, **RECIPE), {B} pairs at {SIZE}³, {B // MESH_GRID[0]} a row of "
          f"{MESH_GRID[1]} z-slabs (eager): wall {wall:.3f} s = {wall / B:.4f} s a pair, "
          f"against {wall_one:.4f} s a pair on a (1, {MESH_GRID[1]}) mesh alone and "
          f"{cohort_s:.4f} s a pair in [cohort]'s unsharded batch (graphs); halo bytes of the "
          f"call {nbytes} in {fetches} fetches (a full-transform level re-warp's forward at "
          f"{SIZE}³ fetches {_level_warp_halo_bytes()} bytes f32); pairs equal to their row "
          f"runs to the bit {sum(bits)} of {B}; each pair's step envelopes (slabs and 2 "
          f"one-ulp slab runs; unsharded and 4 one-ulp unsharded runs) apart by "
          f"{[r['envelopes_apart'] for r in out]} (gate {COHORT_STEPS_TOL}), its slab run's "
          f"steps from the unsharded run's by {[r['steps_apart'] for r in out]}; {smi}; "
          f"launches {json.dumps(launches)}", flush=True)
    if not all(bits):
        raise AssertionError(f"[mesh-batch] a pair differs from its own row run: {bits}")
    if bad:
        raise AssertionError(f"[mesh-batch] pairs off the unsharded batch (pair, envelopes "
                             f"apart, quality): {bad}")
    _need(launches, ("sweep_fwd_slab", "sweep_bwd_slab", "sweep_fwd_slab_flow",
                     "sweep_bwd_slab_flow"), "[mesh-batch]")
    _drop_mesh_factories()
    del res, ulps, movings, targets, ref
    torch.cuda.empty_cache()
    return launches


def _mesh_batch_unet(smi: str) -> dict:
    """[mesh-batch-unet]: ``RECIPE_UNET``'s net (``n=8``) with its flow
    epochs cut (``MESH_BATCH_UNET``) on ``[cohort-unet]``'s two deformable
    240³ pairs: on the ``(2, 4)`` mesh (a pair a row of 4 z-slabs: each row's
    run is that pair's own run on a ``(1, 4)`` mesh) and both on one row of
    a ``(1, 4)`` mesh (the U-Net cohort on slabs, K3 with a weight set per
    pair): each pair of the latter equal to its own row run to the bit.
    The trained flows printed beside the unsharded cohort's and beside the
    same unsharded cohort run on the moving images raised by one ulp (not
    gated: Adam parts two runs whose sums differ, ROADMAP queue 3,
    Watched)."""
    movings, targets, _, info, _ = MESH_REFS.pop("cohort-unet")
    B = movings.shape[0]
    grid = make_cascade_batch_fn(mesh=_grid_mesh(*MESH_GRID), spatial_axis=0, **MESH_BATCH_UNET)
    rows, wall_rows, launches_rows, _, _ = _space_run(grid, movings, targets)
    row_fn = make_cascade_batch_fn(mesh=_grid_mesh(1, MESH_GRID[1]), spatial_axis=0,
                                   **MESH_BATCH_UNET)
    res, wall, launches, nbytes, fetches = _space_run(row_fn, movings, targets)
    bits = _pairs_equal(res, [(rows, b) for b in range(B)])
    flat = make_cascade_batch_fn(**MESH_BATCH_UNET)
    ref, ulp = flat(movings, targets), flat(_ulp_up(movings), targets)
    got = _gathered(res)
    for b, (kind, seed, truth) in enumerate(info):
        m, t = movings[b:b + 1], targets[b:b + 1]
        mine, base, up = _pair_of(res, b, got), _one_pair(ref, b), _one_pair(ulp, b)
        row = {"pair": f"{kind} seed {seed}", "steps": mine.steps, "unsharded_steps": base.steps,
               "ulp_steps": up.steps, "quality": _pair_quality(kind, mine, m, t, truth),
               "unsharded_quality": _pair_quality(kind, base, m, t, truth),
               "ulp_quality": _pair_quality(kind, up, m, t, truth),
               "flow_vs_unsharded_vox": _max_err(mine.flow, base.flow),
               "flow_ulp_vs_unsharded_vox": _max_err(up.flow, base.flow),
               "equal_to_its_row_run": bits[b]}
        print(f"[mesh-batch-unet] {json.dumps(row)}", flush=True)
    print(f"[mesh-batch-unet] RECIPE_UNET with flow_epochs={MESH_BATCH_UNET['flow_epochs']} "
          f"(cut from {RECIPE_UNET['flow_epochs']}), {B} deformable pairs at {SIZE}³: on the "
          f"({MESH_GRID[0]}, {MESH_GRID[1]}) mesh, a pair a row, wall {wall_rows:.3f} s; both "
          f"on one row of a (1, {MESH_GRID[1]}) mesh (the U-Net cohort on slabs) wall "
          f"{wall:.3f} s, halo bytes {nbytes} in {fetches} fetches, K3's per-pair launches "
          f"fwd {launches['conv3d_fwd_pairs']}, dgrad {launches['conv3d_dgrad_pairs']}, "
          f"dw {launches['conv3d_wgrad_pairs']}; pairs equal to their own row runs to the bit "
          f"{sum(bits)} of {B}; {smi}; launches {json.dumps(launches)}", flush=True)
    if not all(bits):
        raise AssertionError(f"[mesh-batch-unet] a pair differs from its own row run: {bits}")
    _need(launches, ("conv3d_fwd_pairs", "conv3d_dgrad_pairs", "conv3d_wgrad_pairs",
                     "sweep_fwd_slab_flow"), "[mesh-batch-unet]")
    _drop_mesh_factories()
    del res, rows, ref, ulp, movings, targets
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + launches_rows.get(k, 0) for k in launches}


# [mesh-criteria]: NMI and LNCC on 4 z-slabs at 240³ against the unsharded
# calls on the same card; the engines' default criteria on slabs
MESH_LNCC_WIN = 9
MESH_NMI_PATCH = 100  # nmi_loss's default
MESH_CRIT_TOL = 1e-6  # the loss (relative) and each slab's gradient (of its largest entry)
MESH_CRIT_CALLS = 3  # timed calls of each, after one warm-up


def _timed_value_and_grad(fn, y, yp) -> tuple:
    """``fn(y, yp)`` and its gradient in ``yp`` (a tensor, or the slabs of a
    split volume), ``MESH_CRIT_CALLS`` times after a warm-up: the last
    value, its gradient (the slabs' put back together), the ms of each call
    and the halo bytes of the last."""
    ms = []
    for i in range(MESH_CRIT_CALLS + 1):
        if isinstance(yp, torch.Tensor):
            leaves = [yp.detach().requires_grad_(True)]
            p = leaves[0]
        else:
            p = yp.map(lambda b: b.detach().requires_grad_(True))
            leaves = p.shards
        halo.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = fn(y, p)
        gs = torch.autograd.grad(v, leaves)
        torch.cuda.synchronize()
        if i:
            ms.append(round(1e3 * (time.perf_counter() - t0), 3))
    dim = 2 if isinstance(yp, torch.Tensor) else yp.slab_axis()[0]
    return v.detach(), torch.cat(gs, dim), ms, halo.copied_bytes


def _mesh_criteria(smi: str) -> list:
    """[mesh-criteria]: ``nmi_loss`` with its defaults on make_pair's 240³
    pair (unit range: the binned branch) and on the pair x 1000 (the exact
    branch), and ``lncc`` (``win=9``), on 4 z-slabs of the card against the
    unsharded calls: each NMI patch equal to its unsharded value to the bit,
    the loss within ``MESH_CRIT_TOL`` (relative), each slab's gradient within
    ``MESH_CRIT_TOL`` of the gradient's largest entry (LNCC: or within the
    unsharded gradient's own move under one ulp of the moving image, if
    larger), ms a call (value and
    gradient) beside the unsharded call's and the bytes fetched; then
    ``rigid_register`` with its defaults (``criterions=None``,
    ``grad_edges=True``, SGD, ``ENGINE_STEPS`` steps, as
    ``[engines-default]``) on slabs against unsharded: the same steps, theta
    within ``MESH_THETA_TOL``. Returns the slab runs' launches."""
    moving, target = make_pair((SIZE,) * 3, seed=0, device=DEV)
    sh = pmesh.volume_sharding(make_mesh((MESH_SLABS,), ("space",),
                                         devices=[DEV] * MESH_SLABS))
    nmi = functools.partial(nmi_loss, patch_size=MESH_NMI_PATCH)
    cases = (("nmi_loss binned", nmi, 1.0), ("nmi_loss exact", nmi, 1000.0),
             (f"lncc win={MESH_LNCC_WIN}",
              functools.partial(tsim.lncc, win=MESH_LNCC_WIN), 1.0))
    failed, paths = [], []
    for label, fn, scale in cases:
        y, yp = target * scale, moving * scale
        ys, yps = pmesh.shard(y, sh), pmesh.shard(yp, sh)
        uv, ug, ums, _ = _timed_value_and_grad(fn, y, yp)
        _reset_counts()
        branch_calls.reset()
        sv, sg, sms, fetched = _timed_value_and_grad(fn, ys, yps)
        launches, branches = _counts(), dict(branch_calls)
        paths.append(launches)
        row = {"loss": float(sv), "unsharded_loss": float(uv),
               "loss_rel_err": abs(float(sv) / float(uv) - 1.0) if float(uv) else abs(float(sv)),
               "grad_max_rel_err": _max_err(sg, ug) / float(ug.abs().max()),
               "ms": sms, "unsharded_ms": ums, "fetched_bytes": fetched}
        tol = MESH_CRIT_TOL
        if fn is not nmi:
            # LNCC's near-constant windows (make_pair's background) make its
            # gradient ill-conditioned: the gate is the unsharded gradient's
            # own move under one ulp of the moving image
            ulp_g = _timed_value_and_grad(fn, y, _ulp_up(yp))[1]
            row["unsharded_one_ulp_grad_rel"] = _max_err(ulp_g, ug) / float(ug.abs().max())
            tol = max(tol, row["unsharded_one_ulp_grad_rel"])
        if fn is nmi:
            p = MESH_NMI_PATCH
            bits = _same_bits(nmi_mod.patch_nmi_slabs(ys, yps, patch_size=p),
                              nmi_mod.nmi(nmi_mod._patch_rows(y, p), nmi_mod._patch_rows(yp, p),
                                          bandwidth=3.0)[0])
            row.update(patch_nmi_bits_equal=bits, branches=branches,
                       splat=launches["splat"], kde_sum=launches["kde_sum"],
                       kde_dot=launches["kde_dot"])
            if not bits:
                failed.append(f"{label}: a patch's NMI differs from its unsharded value")
        print(f"[mesh-criteria] {label} at {SIZE}³ on {MESH_SLABS} z-slabs against the "
              f"unsharded call: {json.dumps(row)} ({smi})", flush=True)
        if not (row["loss_rel_err"] <= MESH_CRIT_TOL and row["grad_max_rel_err"] <= tol):
            failed.append(f"{label}: {row}")
        del ys, yps, sg, ug
    runs = {}
    for label, (m, t) in (("unsharded", (moving, target)),
                          ("slabs", (pmesh.shard(moving, sh), pmesh.shard(target, sh)))):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, res = rigid_register(m, t, epochs=ENGINE_STEPS,
                                generator=torch.Generator(device=DEV).manual_seed(0))
        torch.cuda.synchronize()
        runs[label] = (res, time.perf_counter() - t0, _counts())
    (ref, wall0, _), (res, wall1, launches) = runs["unsharded"], runs["slabs"]
    paths.append(launches)
    rel = float((res.best_theta - ref.best_theta).abs().max() / ref.best_theta.abs().max())
    row = {"steps": res.steps, "unsharded_steps": ref.steps, "theta_max_rel_err": rel,
           "ms_per_step": round(1e3 * wall1 / res.steps, 3),
           "unsharded_ms_per_step": round(1e3 * wall0 / ref.steps, 3)}
    print(f"[mesh-criteria] rigid_register(criterions=None, grad_edges=True, {ENGINE_STEPS} "
          f"SGD steps) on make_pair's {SIZE}³ pair on {MESH_SLABS} z-slabs against unsharded: "
          f"{json.dumps(row)} ({smi}); launches {json.dumps(launches)}", flush=True)
    if res.steps != ref.steps or res.steps != ENGINE_STEPS or rel > MESH_THETA_TOL:
        failed.append(f"rigid_register(criterions=None) on slabs: {row}")
    if failed:
        raise AssertionError(f"[mesh-criteria] {failed}")
    _need(launches, ("sweep_fwd_slab", "sweep_bwd_slab", "conv3d_fwd", "splat", "kde_sum",
                     "kde_dot"), "[mesh-criteria] rigid_register(criterions=None) on slabs")
    return paths


# [dryrun]: the counterpart of __graft_entry__.py on meshes that name the card
DRYRUN_SIZES = (8, 4, 2)
DRYRUN_GRAD_TOL = MESH_UNET_GRAD_TOL  # each weight's gradient, of its own largest entry
DRYRUN_LOSS_RTOL = 1e-5


def phase_dryrun(smi: str) -> list:
    """[dryrun]: ``dryrun.entry()`` once (40³, the U-Net then the exact
    warp), then ``dryrun.dryrun_multichip(n)`` for ``DRYRUN_SIZES`` with the
    default devices (the one card named n times); then the ``(4, 2)`` train
    step against the port's unsharded step at the same weights on
    ``dryrun.blob_batch``: the loss within ``DRYRUN_LOSS_RTOL``, each
    weight's gradient within ``DRYRUN_GRAD_TOL`` of its own largest entry
    (the gap printed), and the Adam-updated weights' largest gap printed
    beside it, ungated (Adam's first step moves each weight by about lr
    times the sign of its gradient). Returns the launches of each part."""
    from torchregister_tpu_torch import dryrun

    paths = []
    _reset_counts()
    fn, args = dryrun.entry()
    warped, flow = fn(*args)
    torch.cuda.synchronize()
    paths.append(_counts())
    if tuple(flow.shape) != (1, 3) + (dryrun.ENTRY_SIZE,) * 3 or not (
            bool(torch.isfinite(warped).all()) and bool(torch.isfinite(flow).all())):
        raise AssertionError(f"[dryrun] entry(): warped {tuple(warped.shape)}, flow "
                             f"{tuple(flow.shape)}, not finite or of the wrong shape")
    print(f"[dryrun] entry(): warped {tuple(warped.shape)}, flow {tuple(flow.shape)}, finite "
          f"({smi})", flush=True)
    for n in DRYRUN_SIZES:
        _reset_counts()
        t0 = time.perf_counter()
        line = dryrun.dryrun_multichip(n)
        torch.cuda.synchronize()
        launches = _counts()
        paths.append(launches)
        print(f"[dryrun] dryrun_multichip({n}) in {time.perf_counter() - t0:.3f} s ({smi}); "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
        if "space" in line:
            _need(launches, ("sweep_fwd_slab", "sweep_bwd_slab", "conv3d_fwd", "conv3d_dgrad",
                             "conv3d_wgrad"), f"[dryrun] dryrun_multichip({n})")
    mesh, _ = dryrun.dryrun_mesh(8, [DEV] * 8)
    mov, tgt = dryrun.blob_batch(mesh.shape["data"], device=DEV)
    sh = dryrun.batch_layout(mesh)
    out = {}
    for label, (m, t) in (("unsharded", (mov, tgt)),
                          ("mesh", (pmesh.shard(mov, sh), pmesh.shard(tgt, sh)))):
        model = dryrun._net(dryrun.TRAIN_NET, DEV)
        params, opt = dryrun.init_train_state(model)
        _reset_counts()
        loss, grads = dryrun.make_loss_and_grads(model)(params, m, t)
        dryrun.make_train_step(model)(params, opt, m, t)
        torch.cuda.synchronize()
        if label == "mesh":
            paths.append(_counts())
        out[label] = (float(loss), grads, {k: v.detach().clone()
                                           for k, v in model.named_parameters()})
    (uloss, ugrads, unew), (loss, grads, new) = out["unsharded"], out["mesh"]
    gaps = {k: float((grads[k] - g).abs().max() / g.abs().max()) for k, g in ugrads.items()}
    rel = abs(loss / uloss - 1.0)
    worst = max(gaps, key=gaps.get)
    step_gap = max(float((new[k] - w).abs().max()) for k, w in unew.items())
    row = {"loss": loss, "unsharded_loss": uloss, "loss_rel_err": rel,
           "grad_gap_max": gaps[worst], "grad_gap_weight": worst,
           "updated_weights_max_gap": step_gap, "lr": dryrun.TRAIN_LR}
    print(f"[dryrun] the (4, 2) train step against the unsharded step at the same weights on "
          f"the blob batch ({mesh.shape['data']} pairs, {dryrun.TRAIN_SIZE}³): "
          f"{json.dumps(row)}; per weight {json.dumps(gaps)} ({smi})", flush=True)
    if rel > DRYRUN_LOSS_RTOL or gaps[worst] > DRYRUN_GRAD_TOL:
        raise AssertionError(f"[dryrun] the train step on the mesh is off the unsharded step: "
                             f"{row}")
    return paths


def _k2_slab_case():
    """make_pair's moving image and true rigid theta at 240³, and
    make_flow_truth_pair's (seed 1) moving image and true field, split into
    4 z-slabs."""
    m, _ = make_pair((SIZE,) * 3, seed=0, device=DEV)
    fm, _, _, flow = make_flow_truth_pair(seed=1, device=DEV)
    sh = pmesh.volume_sharding(make_mesh((MESH_SLABS,), ("space",), devices=[DEV] * MESH_SLABS))
    return m, _pair_theta(), fm, flow.to(torch.float32).reshape(1, 3, *(SIZE,) * 3), sh


def _k2_slab_buffers(src, sh, mt=None, flow=None):
    """Each slab's K2 slab-mode call on the buffers ``ops/blocked.py``
    fetches: ``[(buf, out_shape, origin, start, aux)]`` (the last the map or
    the slab's field)."""
    from torchregister_tpu_torch.ops.blocked import _affine_rows, _slab_origin

    spatial = (SIZE,) * 3
    parts = halo.equal(SIZE, MESH_SLABS)
    blocks = pmesh.shard(src, sh).shards
    if mt is not None:
        host = mt.cpu().numpy()
        wants = [_affine_rows(host, spatial, 2, lo, hi) for lo, hi in parts]
        aux = [mt] * MESH_SLABS
    else:
        D = math.ceil(float(flow[:, 0].abs().max())) + 1
        wants = [(max(lo - D, 0), min(hi + D, SIZE)) for lo, hi in parts]
        aux = [f[0] for f in pmesh.shard(flow, sh).shards]
    bufs = halo.fetch_rows(blocks, parts, 2, wants)
    return [(b[0], (hi - lo, SIZE, SIZE), (lo, 0, 0), (w0, 0, 0), a)
            for b, (lo, hi), (w0, _), a in zip(bufs, parts, wants, aux)]


def _mesh_exact(smi: str) -> tuple[dict, list]:
    """[mesh-exact]: K2's slab mode at 240³ on 4 z-slabs, affine
    (make_pair's true theta) and flow (make_flow_truth_pair's true field):
    every slab's block equal to the unsharded launch's to the bit and to its
    plain version to the bit; ``rigid_register(method='exact')`` and
    ``flow_register(method='exact', flow_model='field')`` on the slabs
    against their unsharded runs (``tests/test_torch_mesh_exact.py``'s
    tolerances); ``make_cascade_batch_fn(final_warp='exact')`` on a
    ``(1, 4)`` mesh, its final warp equal to the unsharded K2 launches at its
    own theta and field to the bit. Returns the deviations and the paths'
    launches."""
    m, theta, fm, flow, sh = _k2_slab_case()
    mt = k2.pack_affine(*affine_to_index_map(theta[0], (SIZE,) * 3))
    errs, eq = {}, {}
    halo.reset_counts()
    aff = pmesh.gather(blocked.warp_affine_fast(theta, pmesh.shard(m, sh)))
    aff_bytes = halo.copied_bytes
    halo.reset_counts()
    flw = pmesh.gather(blocked.warp_flow_fast(pmesh.shard(fm, sh), pmesh.shard(flow, sh)))
    flow_bytes = halo.copied_bytes
    eq["affine"] = _same_bits(aff[0], k2.warp_affine_launch(m[0].contiguous(), mt))
    eq["flow"] = _same_bits(flw[0], k2.warp_flow_launch(fm[0].contiguous(), flow[0]))
    for name, calls in (("warp_affine_slab", _k2_slab_buffers(m, sh, mt=mt)),
                        ("warp_flow_slab", _k2_slab_buffers(fm, sh, flow=flow))):
        geo_err, plain_eq = 0.0, True
        for buf, shape, origin, start, aux in calls:
            geo = k2.SlabGeo(origin, start, (SIZE,) * 3)
            kw = {"mt": aux} if name == "warp_affine_slab" else {"flow": aux}
            got = (k2.warp_affine_slab_launch(buf, aux, shape, geo) if "mt" in kw
                   else k2.warp_flow_slab_launch(buf, aux, geo))
            want = k2.warp_plain_slab(buf, shape, geo, **kw)
            geo_err = max(geo_err, _max_err(got, want))
            plain_eq = plain_eq and _same_bits(got, want)
        errs[name] = geo_err
        eq[f"{name}_plain"] = plain_eq
    print(f"[mesh-exact] K2's slab mode at {SIZE}³ on {MESH_SLABS} z-slabs: equal to the "
          f"unsharded launch to the bit {json.dumps(eq)}; fetched bytes: affine {aff_bytes}, "
          f"flow {flow_bytes}", flush=True)
    if not all(eq.values()):
        raise AssertionError(f"[mesh-exact] K2's slab mode disagrees: {eq}")
    del aff, flw
    mr, tr_ = make_pair((SIZE,) * 3, seed=0, device=DEV)
    ms, ts = pmesh.shard(mr, sh), pmesh.shard(tr_, sh)
    paths = []
    _, r0 = rigid_register(mr, tr_, **MESH_EXACT_RIGID)
    _reset_counts()
    w1, r1 = rigid_register(ms, ts, **MESH_EXACT_RIGID)
    paths.append(_counts())
    d_theta = _max_err(r1.best_theta, r0.best_theta) / float(r0.best_theta.abs().max())
    warp_eq = _same_bits(pmesh.gather(w1), blocked.warp_affine_fast(r1.best_theta, mr))
    fr, ft = make_flow_truth_pair(seed=1, device=DEV)[:2]
    fs, fts = pmesh.shard(fr, sh), pmesh.shard(ft, sh)
    _, f0 = flow_register(fr, ft, **MESH_EXACT_FLOW)
    _reset_counts()
    fw1, f1 = flow_register(fs, fts, **MESH_EXACT_FLOW)
    paths.append(_counts())
    d_field = _max_err(pmesh.gather(f1.flow), f0.flow) / float(f0.flow.abs().max())
    print(f"[mesh-exact] rigid_register(method='exact') on {MESH_SLABS} z-slabs, "
          f"{MESH_EXACT_RIGID['epochs']} Adam steps at {SIZE}³: steps {r1.steps} (unsharded "
          f"{r0.steps}), best theta within {d_theta:.3g} of its largest entry, warped_best (K2 "
          f"on slabs) equal to the unsharded K2 at its theta {warp_eq}; flow_register("
          f"method='exact', field, SGD lr 10, {MESH_EXACT_FLOW['max_epochs']} steps): steps "
          f"{f1.steps} ({f0.steps}), the field within {d_field:.3g} of its largest value",
          flush=True)
    if r1.steps != r0.steps or d_theta > 1e-4 or not warp_eq:
        raise AssertionError("[mesh-exact] rigid_register(method='exact') on slabs is off")
    if f1.steps != f0.steps or d_field > 1e-5:
        raise AssertionError("[mesh-exact] flow_register(method='exact') on slabs is off")
    del ms, ts, fs, fts, w1, fw1
    fn = make_cascade_batch_fn(mesh=_grid_mesh(1, MESH_SLABS), spatial_axis=0,
                               **MESH_EXACT_CASCADE)
    res, wall, launches, nbytes, _ = _space_run(fn, fr, ft)
    paths.append(launches)
    got = _gathered(res)
    want = k2.warp_flow_launch(
        k2.warp_affine_launch(fr[0].contiguous(), k2.pack_affine(*affine_to_index_map(
            res.theta[0, 0], (SIZE,) * 3))), got["flow"][0, 0])
    final_eq = _same_bits(got["warped"][0, 0], want)
    print(f"[mesh-exact] make_cascade_batch_fn(mesh=(1, {MESH_SLABS}), spatial_axis=0, "
          f"final_warp='exact', the recipe cut to 2 levels) on the deformable pair: wall "
          f"{wall:.3f} s, halo bytes {nbytes}; its final warp equal to the unsharded K2 "
          f"launches at its theta and field to the bit {final_eq}; launches "
          f"{json.dumps(launches)}", flush=True)
    if not final_eq:
        raise AssertionError("[mesh-exact] the exact final warp on slabs differs from K2")
    _need(launches, ("warp_affine_slab", "warp_flow_slab"), "[mesh-exact] cascade")
    _drop_mesh_factories()
    del res, fr, ft, mr, tr_
    torch.cuda.empty_cache()
    return errs, paths


def _k2_slab_times() -> dict:
    """K2's slab mode at 240³ on 4 z-slabs (the ``[mesh-exact]`` cases):
    each mode's 4 slab launches against the one unsharded launch and against
    the slab mode launched once on the whole volume (its geometry the
    volume's; the same bits as the unsharded launch), in turns (CUDA
    events), with device times (``torch.profiler``), the plain version
    on the slabs, ``F.grid_sample`` on the whole volume with its grid made
    beforehand (the library call), the fetch's ms and bytes; the bound:
    each slab's buffer and (flow) field read once, each output written once,
    against ~60 f32 operations a voxel."""
    F = torch.nn.functional
    m, theta, fm, flow, sh = _k2_slab_case()
    mt = k2.pack_affine(*affine_to_index_map(theta[0], (SIZE,) * 3))
    o = torch.arange(SIZE, dtype=torch.float32, device=DEV)
    rows = {}
    with torch.no_grad():
        for name in ("warp_affine_slab", "warp_flow_slab"):
            affine = name == "warp_affine_slab"
            src = m if affine else fm
            slabs = pmesh.shard(src, sh)
            fslabs = None if affine else pmesh.shard(flow, sh)
            halo.reset_counts()
            calls = (_k2_slab_buffers(src, sh, mt=mt) if affine
                     else _k2_slab_buffers(src, sh, flow=flow))
            fetched = halo.copied_bytes

            def kernel(calls=calls, affine=affine):
                return [k2.warp_affine_slab_launch(b, a, s, k2.SlabGeo(org, st, (SIZE,) * 3))
                        if affine else k2.warp_flow_slab_launch(b, a, k2.SlabGeo(
                            org, st, (SIZE,) * 3)) for b, s, org, st, a in calls]

            def unsharded(src=src, affine=affine):
                return (k2.warp_affine_launch(src[0].contiguous(), mt) if affine
                        else k2.warp_flow_launch(src[0].contiguous(), flow[0]))

            def whole(src=src, affine=affine):
                geo = k2.SlabGeo((0, 0, 0), (0, 0, 0), (SIZE,) * 3)
                return (k2.warp_affine_slab_launch(src[0].contiguous(), mt, (SIZE,) * 3, geo)
                        if affine else k2.warp_flow_slab_launch(src[0].contiguous(), flow[0],
                                                                geo))

            def fetch(slabs=slabs, affine=affine, fslabs=fslabs):
                return (blocked.warp_affine_fast(theta, slabs) if affine
                        else blocked.warp_flow_fast(slabs, fslabs))

            if affine:
                grid = affine_grid(theta, (SIZE,) * 3)
            else:
                idx = torch.stack(torch.meshgrid(o, o, o, indexing="ij")) + flow[0]
                grid = ((2.0 * idx + 1.0) / SIZE - 1.0).flip(0).permute(1, 2, 3, 0)[None] \
                    .contiguous()
                del idx

            def library(grid=grid, src=src):
                return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=False)

            row = ps.in_turns({"ms": kernel, "unsharded_ms": unsharded,
                               "whole_volume_slab_mode_ms": whole})
            if not _same_bits(whole(), unsharded()):
                raise AssertionError(f"[times] {name} on the whole volume differs from the "
                                     f"unsharded launch")
            row["device_ms"] = ps.device_ms(kernel, name="warp_kernel")
            row["unsharded_device_ms"] = ps.device_ms(unsharded, name="warp_kernel")
            row["plain_ms"] = ps.time_ms(lambda calls=calls, affine=affine: [
                k2.warp_plain_slab(b, s, k2.SlabGeo(org, st, (SIZE,) * 3),
                                   **({"mt": a} if affine else {"flow": a}))
                for b, s, org, st, a in calls], iters=3, warmup=1)
            row["library_ms"] = ps.time_ms(library)
            row["fetch_and_launch_ms"] = ps.time_ms(fetch, iters=5, warmup=1)
            row["fetched_bytes"] = fetched
            nbytes = sum(4.0 * b.numel() for b, *_ in calls) + 4.0 * SIZE**3 * (
                1 if affine else 4)
            row.update(_bound(nbytes, 60.0 * SIZE**3))
            row["unsharded_bound_ms"] = pw_bound(name[:-5])["bound_ms"]
            rows[name] = row
            del grid, calls
    print(f"[times] slab mode, K2 at {SIZE}³ on {MESH_SLABS} z-slabs (affine: make_pair's true "
          f"theta; flow: make_flow_truth_pair's true field), the 4 slab launches against the "
          f"unsharded launch: {json.dumps(rows)}", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_slab_times() -> dict:
    """K1's slab mode at 240³ on 4 z-slabs, K = 60, f32: the 4 slab
    launches of a pass against the unsharded launch of that pass, in turns,
    and against the plain version on the slabs, mean of the 3 passes; the
    bound counts each slab's buffer (its halo included) read once and its
    outputs written once, ~6 operations an output forward and ~10 backward;
    the halo fetch of the z pass beside it."""
    moving, g, table, axes, sh, geos = _slab_case()
    slabs, gslabs = pmesh.shard(moving, sh).shards, pmesh.shard(g, sh).shards
    shape = slabs[0].shape
    dtables = [torch.zeros_like(table) for _ in geos]
    works = [k1._slab_work(shape, axes, (MESH_K,) * 3, geo, 1, moving.device) for geo in geos]
    dtable = torch.zeros_like(table)
    work = k1._affine_work(moving, axes, [MESH_K] * 3)
    out: dict = {"fwd": [], "bwd": []}
    nbytes: dict = {"fwd": 0.0, "bwd": 0.0}
    for p, axis in enumerate(axes):
        bufs, gbufs = _slab_buffers(slabs, axis), _slab_buffers(gslabs, axis)
        calls = {"fwd": {"ms": lambda: [k1._fwd_slab(b, table, p, axis, MESH_K, geo, shape)
                                        for b, geo in zip(bufs, geos)],
                         "unsharded_ms": lambda: k1._fwd_affine(moving, table, p, axis, MESH_K)},
                 "bwd": {"ms": lambda: [k1._bwd_slab(gb, b, table, p, axis, MESH_K, geo, shape,
                                                     True, dt, w)
                                        for gb, b, geo, dt, w in zip(gbufs, bufs, geos, dtables,
                                                                     works)],
                         "unsharded_ms": lambda: k1._bwd_affine(g, moving, table, p, axis,
                                                                MESH_K, True, dtable, work)}}
        fwd, bwd = ps.in_turns(calls["fwd"]), ps.in_turns(calls["bwd"])
        for row, kind in ((fwd, "fwd"), (bwd, "bwd")):  # K1's kernels' device time alone
            row["device_ms"] = ps.device_ms(calls[kind]["ms"])
            row["unsharded_device_ms"] = ps.device_ms(calls[kind]["unsharded_ms"])
        fwd["plain_ms"] = ps.time_ms(lambda: [k1.sweep_affine_slab_plain(
            b, table[p, :3], table[p, 3], axis, MESH_K, geo, shape)
            for b, geo in zip(bufs, geos)], iters=3, warmup=1)
        bwd["plain_ms"] = ps.time_ms(lambda: [k1._slab_bwd_plain(
            gb, b, table, p, axis, MESH_K, geo, shape, True, torch.zeros_like(table))
            for gb, b, geo in zip(gbufs, bufs, geos)], iters=3, warmup=1)
        if axis == 0:
            fwd["halo_ms"] = ps.time_ms(lambda: _slab_buffers(slabs, 0))
        out["fwd"].append(fwd)
        out["bwd"].append(bwd)
        src_bytes = sum(4.0 * b.numel() for b in bufs)
        nbytes["fwd"] += (src_bytes + 4.0 * moving.numel()) / 3
        nbytes["bwd"] += (2 * src_bytes + 4.0 * moving.numel()) / 3
    vox = float(moving.numel())
    rows = {}
    for kind, ops in (("fwd", 6 * vox), ("bwd", 10 * vox)):
        mean = {k: None if any(r[k] is None for r in out[kind])
                else sum(r[k] for r in out[kind]) / 3 for k in out[kind][0] if k != "halo_ms"}
        rows[f"sweep_{kind}_slab"] = {**mean, **_bound(nbytes[kind], ops),
                                      "unsharded_bound_ms": _bound(
                                          (2 if kind == "fwd" else 3) * 4.0 * vox, ops)["bound_ms"]}
    rows["sweep_fwd_slab"]["halo_ms"] = out["fwd"][[a for a in axes].index(0)]["halo_ms"]
    print(f"[times] slab mode, {SIZE}³ on {MESH_SLABS} z-slabs K={MESH_K} f32, the {MESH_SLABS} "
          f"slab launches of a pass, mean of the 3 passes: {json.dumps(rows)}", flush=True)
    return rows


def _slab_flow_times() -> dict:
    """The slab modes added for the flow engine and LM, at 240³ on 4
    z-slabs, f32, each slab's 4 launches against the unsharded launch they
    split, in turns (CUDA events), then each one's device time
    (``torch.profiler``), and the plain version on the slabs: K1's flow
    form along the split axis (``sweep_fwd_slab_flow``, ``sweep_bwd_slab_flow``:
    the z pass of make_flow_truth_pair's field, K = MESH_FLOW_K) and
    ``sweep_slab_bwd2`` (K = 8, a rigid table, mean of the 3 passes). Bounds:
    each slab's buffers (halo included) read once and its outputs written
    once; ~6 operations an output forward, ~10 backward, ~20 for the second
    order (all bytes-bound at 67 TFLOP/s)."""
    moving, flow, g, sh, geos = _flow_slab_case()
    K = MESH_FLOW_K
    slabs, flows = pmesh.shard(moving, sh).shards, pmesh.shard(flow, sh).shards
    gslabs = pmesh.shard(g, sh).shards
    shape = slabs[0].shape
    bufs = k1._halo_of(slabs, 0, K, geos)
    gbufs = k1._halo_of(gslabs, 0, K, geos)
    ubufs = k1._halo_of([f[:, 0:1] for f in flows], 0, K, geos)
    dflows = [torch.empty_like(f) for f in flows]
    dflow = torch.empty_like(flow)
    calls = {"fwd": {"ms": lambda: [k1._fwd_slab_flow(b, f, 0, K, geo, shape)
                                    for b, f, geo in zip(bufs, flows, geos)],
                     "unsharded_ms": lambda: k1._fwd_flow(moving, flow, 0, K)},
             "bwd": {"ms": lambda: [k1._bwd_slab_flow(gb, b, ub, 0, K, geo, shape, True, df)
                                    for gb, b, ub, geo, df in zip(gbufs, bufs, ubufs, geos,
                                                                  dflows)],
                     "unsharded_ms": lambda: k1._bwd_flow(g, moving, flow, 0, K, True, dflow)}}
    plain = {"fwd": lambda: [k1.sweep_flow_slab_plain(b, f[:, 0:1], 0, K, geo, shape)
                             for b, f, geo in zip(bufs, flows, geos)],
             "bwd": lambda: [k1._flow_slab_bwd_plain(gb, b, ub, 0, K, geo, shape, True, df)
                             for gb, b, ub, geo, df in zip(gbufs, bufs, ubufs, geos, dflows)]}
    vox = float(moving.numel())
    buf_bytes = sum(4.0 * b.numel() for b in bufs)
    nbytes = {"fwd": buf_bytes + 4.0 * vox + 4.0 * vox,            # src, u, out
              "bwd": 2 * buf_bytes + buf_bytes + 2 * 4.0 * vox}     # g, src, u; dsrc, du
    rows = {}
    for kind, ops in (("fwd", 6 * vox), ("bwd", 10 * vox)):
        row = ps.in_turns(calls[kind])
        row["device_ms"] = ps.device_ms(calls[kind]["ms"])
        row["unsharded_device_ms"] = ps.device_ms(calls[kind]["unsharded_ms"])
        row["plain_ms"] = ps.time_ms(plain[kind], iters=3, warmup=1)
        row.update(_bound(nbytes[kind], ops))
        row["unsharded_bound_ms"] = _bound(nbytes[kind] - (buf_bytes - 4.0 * vox)
                                           * (1 if kind == "fwd" else 3), ops)["bound_ms"]
        rows[f"sweep_{kind}_slab_flow"] = row
    rows["sweep_fwd_slab_flow"]["halo_ms"] = ps.time_ms(lambda: k1._halo_of(slabs, 0, K, geos))
    del bufs, gbufs, ubufs, dflows, dflow, slabs, flows, gslabs
    torch.cuda.empty_cache()
    src, gg, ubar, table, rbar, axes = _bwd2_case(SIZE, MESH_BWD2_K, torch.float32, 0, 2031)
    Kb, m = MESH_BWD2_K, SIZE // MESH_SLABS
    work = k1._affine_work(src, axes, [Kb] * 3)
    dtable = torch.empty_like(table)
    dtables = [torch.zeros_like(table) for _ in geos]
    works = [k1._slab_work(shape, axes, (Kb,) * 3, geo, 1, src.device) for geo in geos]
    per = []
    for p, axis in enumerate(axes):
        bufs, gbufs, ubufs = (k1._halo_of(list(torch.split(x, m, 2)), axis, Kb, geos)
                              for x in (src, gg, ubar))
        fns = {"ms": lambda: [k1._bwd2_slab(gb, b, ub, table, p, axis, Kb, geo, shape, rbar,
                                            True, True, dt, w)
                              for gb, b, ub, geo, dt, w in zip(gbufs, bufs, ubufs, geos,
                                                               dtables, works)],
               "unsharded_ms": lambda: k1._bwd2_affine(gg, src, table, p, axis, Kb, ubar, rbar,
                                                       True, True, dtable, work)}
        row = ps.in_turns(fns)
        row["device_ms"] = ps.device_ms(fns["ms"], name="sweep_bwd2")
        row["unsharded_device_ms"] = ps.device_ms(fns["unsharded_ms"], name="sweep_bwd2")
        row["plain_ms"] = ps.time_ms(lambda: [k1.sweep_bwd2_slab_plain(
            gb, b, ub, rbar[p], table[p, :3], table[p, 3], axis, Kb, geo, shape)
            for gb, b, ub, geo in zip(gbufs, bufs, ubufs, geos)], iters=3, warmup=1)
        row["nbytes"] = 3 * sum(4.0 * b.numel() for b in bufs) + 2 * 4.0 * src.numel()
        per.append(row)
        del bufs, gbufs, ubufs
    mean = {k: None if any(r[k] is None for r in per) else sum(r[k] for r in per) / 3
            for k in per[0]}
    nb = mean.pop("nbytes")
    rows["sweep_bwd2_slab"] = {**mean, **_bound(nb, 20 * float(src.numel())),
                               "unsharded_bound_ms": psb.bwd2_bound(SIZE, torch.float32)[
                                   "bound_ms"], "per_pass": per}
    print(f"[times] slab mode, flow form (z pass, K={K}) and sweep_slab_bwd2 (K={Kb}), "
          f"{SIZE}³ on {MESH_SLABS} z-slabs f32, the {MESH_SLABS} slab launches against the "
          f"unsharded launch: {json.dumps(rows)}", flush=True)
    del src, gg, ubar, work, works
    torch.cuda.empty_cache()
    return rows


def _k3_slab_times() -> dict:
    """K3 on slab buffers, as the U-Net runs on 4 z-slabs
    (``attention_unet.forward_slabs``): the second convolution of the
    120³ level (8 -> 8 on 118³, the input split by the partition the first
    convolution leaves, rows [0, 30), [30, 60), [60, 90), [90, 118)): each
    slab's buffer (its rows and the 2 after them) forward, its cotangent's
    rows with padding 2 (dgrad; the halo's share goes back by the fetch's
    backward) and the weight gradient, the 4 launches of each against the
    unsharded launch and cuDNN on the same four buffers (``F.conv3d``,
    ``conv3d_input``, ``conv3d_weight``, TF32 off: the library call), in
    turns (CUDA events), then their device times. The bound counts each
    buffer and output once (``_k3_bound``'s terms)."""
    ci = co = 8
    edge = 118
    gen = torch.Generator(device=DEV).manual_seed(118)
    x = torch.randn((1, ci, edge, edge, edge), generator=gen, device=DEV)
    w = torch.randn((3, 3, 3, ci, co), generator=gen, device=DEV) / math.sqrt(27 * ci)
    g = torch.randn((1, co) + (edge - 2,) * 3, generator=gen, device=DEV)
    w_t = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
    parts = ((0, 30), (30, 60), (60, 90), (90, edge))
    outs = tuple((a, min(b, edge - 2)) for a, b in parts)  # rows.window's output rows
    bufs = halo.fetch_rows([x[:, :, a:b].contiguous() for a, b in parts], parts, 2,
                           [(a, b + 2) for a, b in outs])
    gs = [g[:, :, a:b].contiguous() for a, b in outs]
    w_cudnn = w.permute(4, 3, 0, 1, 2).contiguous()  # cuDNN's layout [Co, Ci, 3, 3, 3]
    conv_grad = torch.nn.grad
    calls = {"fwd": {"ms": lambda: [k3.conv_launch(b, w) for b in bufs],
                     "unsharded_ms": lambda: k3.conv_launch(x, w),
                     "library_ms": lambda: [torch.nn.functional.conv3d(b, w_cudnn) for b in bufs]},
             "dgrad": {"ms": lambda: [k3.conv_launch(gk, w_t, pad=2) for gk in gs],
                       "unsharded_ms": lambda: k3.conv_launch(g, w_t, pad=2),
                       "library_ms": lambda: [conv_grad.conv3d_input(b.shape, w_cudnn, gk)
                                              for b, gk in zip(bufs, gs)]},
             "wgrad": {"ms": lambda: [k3.wgrad_launch(b, gk) for b, gk in zip(bufs, gs)],
                       "unsharded_ms": lambda: k3.wgrad_launch(x, g),
                       "library_ms": lambda: [conv_grad.conv3d_weight(b, w_cudnn.shape, gk)
                                              for b, gk in zip(bufs, gs)]}}
    nbytes = 4.0 * (sum(b.numel() for b in bufs) + co * (edge - 2) ** 3 + 4 * 27 * ci * co)
    flops = 2.0 * 27 * ci * co * (edge - 2) ** 3
    rows = {}
    with torch.no_grad():
        for kind, fns in calls.items():
            row = ps.in_turns(fns)
            row["device_ms"] = ps.device_ms(fns["ms"], name="")
            row["unsharded_device_ms"] = ps.device_ms(fns["unsharded_ms"], name="")
            row["library_device_ms"] = ps.device_ms(fns["library_ms"], name="")
            rows[f"conv3d_{kind}_slab"] = {**row, **_bound(nbytes, flops, F32_3XTF32_FLOP_PER_S),
                                           "unsharded_bound_ms": _k3_bound(ci, co, edge)[
                                               "bound_ms"]}
    print(f"[times] slab mode, K3 on slab buffers ({ci}->{co} at {edge}³ on 4 z-slabs of "
          f"{[b - a for a, b in parts]} rows, f32), the 4 launches against the unsharded "
          f"launch and cuDNN's 4 calls (library_ms): {json.dumps(rows)}", flush=True)
    del x, g, bufs, gs
    torch.cuda.empty_cache()
    return rows


def phase_pair_times() -> dict:
    """K1's affine form with a table per pair (8 pairs at 240³, K = 8, f32):
    one batched launch against the 8 single-table launches it replaces, in
    turns, and against the plain version (a row per pair; its backward to
    the image and the rows), with the bounds: each image, cotangent and
    output read or written once, ~6 operations per output forward and ~10
    per voxel backward (as ``profile_sweep``'s rows)."""
    src, g, table, axes = _pair_case(torch.float32, 9200)
    K, N = PAIRS_K, PAIRS_N
    singles = [(src[n:n + 1], g[n:n + 1], table[n].contiguous()) for n in range(N)]
    dtable = torch.empty_like(table)
    work = k1._affine_work(src, axes, [K] * 3, N)
    one_dtable = torch.empty_like(singles[0][2])
    one_work = k1._affine_work(singles[0][0], axes, [K] * 3)
    out: dict = {"fwd": [], "bwd": []}
    for p, axis in enumerate(axes):
        fwd = ps.in_turns({
            "ms": lambda: k1._fwd_affine(src, table, p, axis, K),
            "singles_ms": lambda: [k1._fwd_affine(s, t, p, axis, K) for s, _, t in singles]})
        bwd = ps.in_turns({
            "ms": lambda: k1._bwd_affine(g, src, table, p, axis, K, True, dtable, work),
            "singles_ms": lambda: [k1._bwd_affine(gg, s, t, p, axis, K, True, one_dtable,
                                                  one_work) for s, gg, t in singles]})
        row = table[:, p].clone().requires_grad_(True)
        s = src.clone().requires_grad_(True)
        fwd["plain_ms"] = ps.time_ms(
            lambda: k1.sweep_affine_plain(src, table[:, p, :3], table[:, p, 3], axis, K),
            iters=3, warmup=1)
        bwd["plain_ms"] = ps.time_ms(lambda: torch.autograd.grad(
            k1.sweep_affine_plain(s, row[:, :3], row[:, 3], axis, K), (s, row), g), iters=3,
            warmup=1)
        out["fwd"].append(fwd)
        out["bwd"].append(bwd)
    vox = float(N) * PAIRS_S**3
    rows = {}
    for kind, nbytes, ops in (("fwd", 2 * 4 * vox, 6 * vox), ("bwd", 3 * 4 * vox, 10 * vox)):
        mean = {k: sum(r[k] for r in out[kind]) / 3 for k in out[kind][0]}
        rows[f"sweep_{kind}_pairs"] = {**mean, **_bound(nbytes, ops)}
    print(f"[times] table per pair, {N} pairs {PAIRS_S}³ K={K} f32, mean of the 3 passes: "
          f"{json.dumps(rows)}", flush=True)
    return rows


def phase_busy(runs: list) -> None:
    """The device's busy share of the factory's ``fn`` (graphs already
    captured) on ``[cascade-fn]``'s runs, and of ``register_cascade`` on the
    first: one profiled cascade each, its device intervals' union over the
    unprofiled wall time (``profile_cascade.busy_profile``), and ``fn``'s
    kernels that take the most device time. Last, since a profiler session
    slows every later launch. (The eager ``register_cascade`` is host-bound,
    12-24 % busy on every run profiled before; profiling and parsing it on
    every run took more time than the U-Net cohort adds.)"""
    for i, (label, recipe, m, t, wall_ref, wall_fn) in enumerate(runs):
        out = {}
        eager = [("register_cascade", functools.partial(register_cascade, **recipe),
                  wall_ref)] if i == 0 else []
        for name, run, wall in (*eager, ("fn", make_cascade_fn(**recipe), wall_fn)):
            p = busy_profile(m, t, [wall], run)
            out[name] = {k: p.get(k) for k in ("busy_share_est", "busy_share_profiled",
                                                "busy_union_s", "profiled_wall_s")}
        out["fn"]["top_device_ms"] = p.get("top_device_ms", [])[:10]
        print(f"[busy] {label}: {json.dumps(out)}", flush=True)


ADAM_STEPS = 100


def phase_adam() -> None:
    """The engines' tensor-op Adam against ``torch.optim.Adam``'s default
    form on the card (foreach), 100 steps of the same gradients on a field
    of the fine flow level's size (3 x 240³): m and v to the bit, the
    parameters within 4 ulps of lr a step (the last op differs, PERF.md)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    p0 = torch.randn((1, 3) + (SIZE,) * 3, generator=gen, device=DEV)
    ref = p0.clone().requires_grad_(True)
    opt_ref = torch.optim.Adam([ref], lr=RECIPE["flow_lr"])
    ours = p0.clone()
    opt = make_optimizer("adam", ours, RECIPE["flow_lr"], ADAM_STEPS)
    on = torch.ones((), dtype=torch.bool, device=DEV)
    for _ in range(ADAM_STEPS):
        g = torch.randn(p0.shape, generator=gen, device=DEV)
        ref.grad = g.clone()
        opt_ref.step()
        opt.step(g, on)
    st = opt_ref.state[ref]
    diff = (ours - ref.detach()).abs()
    moments = (bool(torch.equal(opt.state["m"], st["exp_avg"]))
               and bool(torch.equal(opt.state["v"], st["exp_avg_sq"])))
    err, bound = float(diff.max()), ADAM_STEPS * RECIPE["flow_lr"] * 2.0**-21
    print(f"[adam] {ADAM_STEPS} steps at lr {RECIPE['flow_lr']} on 3 x {SIZE}^3: m and v "
          f"equal torch.optim.Adam (foreach) to the bit: {moments}; parameters: "
          f"{int((diff > 0).sum())} of {diff.numel()} differ, max |d| {err:.3e} "
          f"(bound {bound:.3e}), equal to the bit: {err == 0.0}", flush=True)
    if not moments or not err <= bound:
        raise AssertionError("the engines' Adam strays from torch.optim.Adam on the card")


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
    print(f"[unet] quality: {json.dumps(quality)}; rmse reduction with "
          f"torch.optim.Adam's foreach form {UNET_FOREACH_PCT} %", flush=True)
    print(f"[unet] the JAX package on the TPU: {json.dumps(UNET_TPU)}; gates "
          f"{json.dumps(UNET_GATES)}", flush=True)
    print(f"[unet] matrix stages alone (no flow): {json.dumps(floor)}", flush=True)
    print(f"[unet] launches: {json.dumps(launches)}", flush=True)
    _need(launches, ("sweep_fwd", "sweep_bwd", *K1_MODES, "conv3d_fwd", "conv3d_dgrad",
                     "conv3d_wgrad"), "the U-Net cascade")
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
    # a flow-only run: its separable warps are flow passes, none affine
    _need(launches, ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad", "warp_flow",
                     "sweep_fwd_flow", "sweep_bwd_flow"), "Register U-Net")
    return launches


# timed Register(criterion=None) runs after the phase's warm-up: every sum
# on the path runs in a fixed order (the NMI splat too), so they must agree
# to the bit
REGISTER_DEFAULT_RUNS = 2


def phase_register_default() -> dict:
    """``Register(mode='rigid')`` with ``criterion=None`` (MSE + NCC(100) +
    NMI(1000)) at 240³, its exact warp on the compact ROI route (K2b and
    the hats), with the [register] phase's lr and epochs under Adam from the
    identity, ``REGISTER_DEFAULT_RUNS`` times after a short warm-up: the
    same steps, parameters, losses and output to the bit; the NMI branches
    the runs took; then ``nmi_loss`` on the pair on the card against the CPU
    and against itself (``NMI_CHECK``)."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    routes = blocked.ROIGATHER_ENABLED, blocked.ROIGATHER_FUSED
    blocked.ROIGATHER_ENABLED, blocked.ROIGATHER_FUSED = True, False
    runs = []
    try:
        kw = dict(mode="rigid", device=DEV, criterion=None, optimizer="adam",
                  init="identity", max_shift=SIZE // 4)
        Register(**kw).optim(moving, target, **dict(REGISTER_RIGID, max_epochs=3))  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        branch_calls.reset()
        for _ in range(REGISTER_DEFAULT_RUNS):
            t0 = time.perf_counter()
            reg = Register(**kw).optim(moving, target, **REGISTER_RIGID)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = reg(moving)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs.append((reg, out, t1 - t0, t2 - t1))
        launches = _counts()
        branches = dict(branch_calls)
    finally:
        blocked.ROIGATHER_ENABLED, blocked.ROIGATHER_FUSED = routes
    reg, out = runs[0][:2]
    steps = int(reg.result.steps)
    pct = rmse_reduction_pct(out, moving, target)
    repeat = all(
        int(r.result.steps) == steps and torch.equal(o, out)
        and torch.equal(r.result.best_params, reg.result.best_params)
        and torch.equal(r.result.final_params, reg.result.final_params)
        and torch.equal(r.losses[:steps], reg.losses[:steps]) for r, o, _, _ in runs)
    ms = [round(1e3 * dt / steps, 3) for _, _, dt, _ in runs]
    print(f"[register-default] criterion=None, {REGISTER_RIGID}: {steps} steps, "
          f"{[round(dt, 3) for _, _, dt, _ in runs]} s ({ms} ms/step), NMI branch calls "
          f"{json.dumps(branches)}; "
          f"__call__ on the compact route {[round(1e3 * dc, 1) for *_, dc in runs]} ms; "
          f"RMSE reduction {pct:.3f} % (gate {GATES['rmse_reduction_pct']}); "
          f"{REGISTER_DEFAULT_RUNS} runs equal to the bit (steps, parameters, losses, output): "
          f"{repeat}; launches {json.dumps(launches)}", flush=True)
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != tuple(moving.shape):
        raise AssertionError("Register's default-criteria output is not finite")
    if pct < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"Register default-criteria RMSE gate failed: {pct:.3f} %")
    if not repeat:
        raise AssertionError("Register with criterion=None does not repeat to the bit")
    _need(launches, ("sweep_fwd", "sweep_bwd", "sweep_fwd_affine", "sweep_bwd_affine",
                     "roigather", "splat"), "Register with criterion=None")
    if sum(branches.values()) < REGISTER_DEFAULT_RUNS * steps:
        raise AssertionError(f"the default criteria ran NMI {branches} times in "
                             f"{REGISTER_DEFAULT_RUNS} x {steps} steps")
    _check_nmi(target, moving)
    return launches


def _check_nmi(y, yp) -> None:
    """``nmi_loss(y, yp²)`` and its gradient in ``yp²`` on the card twice,
    equal to the bit (the splat kernel's fixed order), and against the CPU
    at ``NMI_CHECK``'s bandwidth (binned: the splat of 16 M samples) and
    tolerances; ``nmi_loss(y, yp)`` at the default bandwidth, the term the
    run optimized, printed from both."""
    bw = NMI_CHECK["bandwidth"]
    out = []
    for d in (DEV, DEV, "cpu"):
        branch_calls.reset()
        p = (yp * yp).to(d).requires_grad_(True)
        loss = nmi_loss(y.to(d), p, bandwidth=bw)
        loss.backward()
        with torch.no_grad():
            default = float(nmi_loss(y.to(d), yp.to(d)))
        out.append((loss.detach().cpu(), p.grad.cpu(), dict(branch_calls), default))
    (lg, gg, bg, dg), (lg2, gg2, _, _), (lc, gc, bc, dc) = out
    repeat = torch.equal(lg, lg2) and torch.equal(gg, gg2)
    lg, lc = float(lg), float(lc)
    rel = abs(lg - lc) / abs(lc)
    grel = _max_err(gg, gc) / float(gc.abs().max())
    print(f"[register-default] nmi_loss(target, moving²) at {SIZE}³ (patch 100), bandwidth "
          f"{bw}: card {lg:.7f}, twice equal to the bit (value and gradient): {repeat}; "
          f"CPU {lc:.7f}, rel {rel:.3e} (tol {NMI_CHECK['value_rtol']:g}); gradient "
          f"{grel:.3e} of its largest entry (tol {NMI_CHECK['grad_atol']:g}); branches "
          f"{json.dumps(bg)}; at the default bandwidth 3.0: card {dg:.3e}, CPU {dc:.3e}",
          flush=True)
    if bg != bc or not bg["binned"]:
        raise AssertionError(f"nmi_loss took other branches on the card: {bg} vs {bc}")
    if not repeat:
        raise AssertionError("nmi_loss on the card does not repeat to the bit")
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
    _need(launches, ("sweep_fwd", "sweep_bwd", "sweep_fwd_affine", "sweep_bwd_affine",
                     "conv3d_fwd", "splat"), "the engines' defaults")
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


# [lm]: the LM matrix optimizer (engines/second_order.py). The recipe with
# benchmarks/tune_lm.py's "lm 24/16 pat3" matrix stages and the recipe's
# moment init, held to GATES as the JAX package's LM was on the TPU
LM_RECIPE = psb.LM_RECIPE
# K1's second order at the LM paths' shapes: (edge, window, dtype)
LM_BWD2 = psb.LM_BWD2
# Register rigid with LM and the default criteria (MSE + NCC + NMI) at 240³,
# from the identity at the coarse window S/4: LM iterations (no plateau stop,
# as Register runs the engines)
LM_REGISTER_STEPS = 12
# register_cohort rigid with LM on the cohort driver's 8 perturbed 240³ pairs
LM_COHORT = dict(mode="rigid", epochs=30, criterions=["mse"], optimizer="lm", init="identity",
                 stop_rel=1e-3, patience=3)


def _bwd2_case(S, K, dtype, pairs, seed):
    """Inputs of K1's second order on ``pairs`` images of S³ on the card
    (``profile_splat_bwd2.bwd2_case``)."""
    return psb.bwd2_case(S, K, dtype, pairs, seed, device=DEV)


def _check_bwd2(S, K, dtype) -> float:
    """``sweep_bwd2`` on one S³ image along each pass: two launches equal to
    the bit, gbar and sbar against ``sweep_bwd2_plain`` at ``TOL`` of the
    largest reference value, the row's gradient at 1e-4 of its largest entry
    (sums in other orders); with a table per pair (8 pairs), each pair equal
    to a single-table launch to the bit. Returns the largest absolute
    deviation from the plain version."""
    src, g, ubar, table, rbar, axes = _bwd2_case(S, K, dtype, 0, 9300 + S + K)
    err, rel, row_rel, repeat = 0.0, [], 0.0, True
    for p, axis in enumerate(axes):
        runs = [k1.affine_bwd2(g, src, table, p, axis, K, ubar, rbar[p]) for _ in range(2)]
        repeat &= all(torch.equal(a, b) for a, b in zip(*runs))
        gbar, sbar, drow = runs[0]
        ref = k1.sweep_bwd2_plain(g, src, ubar, rbar[p], table[p, :3], table[p, 3], axis, K)
        rel += [_rel_err(gbar, ref[0]), _rel_err(sbar, ref[1])]
        row_rel = max(row_rel, _rel_err(drow, ref[2]))
        err = max(err, _max_err(gbar, ref[0]), _max_err(sbar, ref[1]))
        del runs, gbar, sbar, ref
    bits = True
    if S >= 120:  # the 8 pairs of [cohort] at the path's larger levels
        src, g, ubar, table, rbar, axes = _bwd2_case(S, K, dtype, 8, 9400 + S + K)
        for p, axis in enumerate(axes):
            gbar, sbar, drow = k1.affine_bwd2(g, src, table, p, axis, K, ubar, rbar[:, p])
            for n in range(8):
                one = k1.affine_bwd2(g[n:n + 1], src[n:n + 1], table[n].contiguous(), p, axis,
                                     K, ubar[n:n + 1], rbar[n, p])
                bits &= (torch.equal(one[0], gbar[n:n + 1]) and torch.equal(one[1], sbar[n:n + 1])
                         and torch.equal(one[2], drow[n]))
        del src, g, ubar, gbar, sbar
    label = f"{S}³ K={K} {str(dtype).replace('torch.', '')}"
    print(f"[lm] sweep_bwd2 {label}: two launches equal {repeat}; rel gbar/sbar "
          f"{max(rel[0::2]):.3e}/{max(rel[1::2]):.3e} (tol {TOL[dtype]:g}); row gradients "
          f"{row_rel:.3e} (tol 1e-4); 8 pairs each equal to a single-table launch "
          f"{bits if S >= 120 else 'not run'}", flush=True)
    if not (repeat and bits):
        raise AssertionError(f"sweep_bwd2 does not repeat or differs per pair: {label}")
    if not (max(rel) < TOL[dtype] and row_rel < 1e-4):
        raise AssertionError(f"sweep_bwd2 disagrees with its plain version: {label}: {rel}, "
                             f"{row_rel:.3e}")
    torch.cuda.empty_cache()
    return err


def _check_splat_signed(inputs: dict) -> float:
    """The splat's signed mode on the default NMI's samples (``w = f -
    0.5``): two launches equal, equal to its torch order to the bit, and
    within each bin's 2 n u of its mass of the plain version; returns the
    largest absolute deviation from the plain version."""
    worst = 0.0
    for case, (idx, f) in inputs.items():
        w = f - 0.5
        out, again = ks.splat_launch(idx, w, signed=True), ks.splat_launch(idx, w, signed=True)
        ref = ks.splat_plain(idx, w, signed=True)
        same = torch.equal(out, ks.splat_ordered(idx, w, signed=True))
        i, w64 = idx.long(), w.double()
        zero = torch.zeros(out.shape, dtype=torch.float64, device=DEV)
        one = torch.ones_like(w64)
        n = zero.scatter_add(1, i, one).scatter_add(1, i + 1, one)
        mass = zero.scatter_add(1, i, w64.abs()).scatter_add(1, i + 1, w64.abs())
        d = (out.double() - ref.double()).abs()
        err = float(d.max())
        print(f"[lm] signed splat {case}: two launches equal {torch.equal(out, again)}; equal "
              f"to its torch order {same}; against the plain version max|d| {err:.3e}",
              flush=True)
        if not (torch.equal(out, again) and same):
            raise AssertionError(f"the signed splat does not repeat its order on {case}")
        if not bool((d <= 2.0 * n * 2.0**-24 * mass).all()):
            raise AssertionError(f"the signed splat disagrees with its plain version on {case}")
        worst = max(worst, err)
    return worst


def _matrix_levels(run, m, t) -> list:
    """One synchronised cascade ``run(m, t)``: ``[label, edge, ms, steps]``
    of each matrix level (``cascade._matrix_level`` timed between device
    syncs; inside a factory's call its graph replays)."""
    rows = []
    orig = cascade_mod._matrix_level

    def timed(base, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(base, *args)
        torch.cuda.synchronize()
        rows.append([args[-1].split("_")[0], base.shape[-1],
                     round(1e3 * (time.perf_counter() - t0), 3), res.steps[0]])
        return res

    cascade_mod._matrix_level = timed
    try:
        run(m, t)
    finally:
        cascade_mod._matrix_level = orig
    return rows


def _wall(run, m, t) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(m, t)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_lm_cascade() -> tuple[dict, dict]:
    """``make_cascade_fn(**LM_RECIPE)`` on both 240³ pairs: each call (the
    capturing one and a replaying one) equal to ``register_cascade`` of the
    same config to the bit, within ``GATES``; LM iterations and ms a step of
    each matrix level, and the walls of ``fn`` beside the Adam recipe's
    ``fn`` (``[cascade-fn]``'s, captured already) in this run. Returns the
    replaying calls' launches and the rows."""
    pairs = {"rigid pair": make_pair(device=DEV), "deformable pair": make_flow_truth_pair(device=DEV)}
    lm_fn, adam_fn = make_cascade_fn(**LM_RECIPE), make_cascade_fn(**RECIPE)
    total, rows = {}, {}
    for label, (m, t, *truth) in pairs.items():
        ref = register_cascade(m, t, **LM_RECIPE)
        wall_ref = _wall(functools.partial(register_cascade, **LM_RECIPE), m, t)
        torch.cuda.reset_peak_memory_stats()
        first = lm_fn(m, t)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _reset_counts()
        res = lm_fn(m, t)
        torch.cuda.synchronize()
        launches = _counts()
        same = all(_same_bits(getattr(r, k), getattr(ref, k)) if isinstance(getattr(ref, k),
                                                                            torch.Tensor)
                   else getattr(r, k) == getattr(ref, k)
                   for r in (first, res) for k in ref._fields)
        walls = {"lm_fn": [_wall(lm_fn, m, t) for _ in range(2)],
                 "adam_fn": [_wall(adam_fn, m, t) for _ in range(2)],
                 "lm_register_cascade": wall_ref}
        levels = {"lm": _matrix_levels(lm_fn, m, t), "adam": _matrix_levels(adam_fn, m, t)}
        for rs_ in levels.values():
            for r in rs_:
                r.append(round(r[2] / max(r[3], 1), 3))  # ms a step
        q = (_pair_quality("rigid", res, m, t, None) if not truth
             else _pair_quality("deformable", res, m, t, truth))
        rows[label] = {"steps": res.steps, "walls_s": walls, "levels": levels,
                       "peak_gib_capture": round(peak, 3), "quality": q}
        print(f"[lm] {label}: LM iterations {res.steps}; equal to register_cascade to the bit "
              f"(capture and replay): {same}; graphs {json.dumps(lm_fn.graphs.counts())}; "
              f"{json.dumps(rows[label])} (levels: [stage, edge, ms, steps, ms a step]); "
              f"launches {json.dumps(launches)}", flush=True)
        if not same:
            raise AssertionError(f"make_cascade_fn with LM differs from register_cascade: {label}")
        _on_cuda(res)
        _finite(res, tuple(m.shape))
        failed = [k for k, v in q.items() if k in GATES and (
            v > GATES[k] if k == "flow_field_err_observable_vox" else v < GATES[k])]
        if failed:
            raise AssertionError(f"[lm] {label} gates failed: {q}")
        _need(launches, ("sweep_fwd", "sweep_bwd", "sweep_bwd2", *K1_MODES), f"LM ({label})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total, rows


def phase_register_lm() -> dict:
    """``Register(mode='rigid', optimizer='lm')`` with the default criteria
    (MSE + NCC + NMI) at 240³ on make_pair, from the identity, twice: equal
    to the bit (steps, parameters, losses, output), within the rigid gate;
    the peak memory of a run (the Hessian's retained graph)."""
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    runs = []
    calls = dict(branch_calls)
    for _ in range(2):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = Register(mode="rigid", device=DEV, optimizer="lm", init="identity",
                       max_shift=SIZE // 4)
        reg.optim(moving, target, max_epochs=LM_REGISTER_STEPS)
        out = reg(moving)
        torch.cuda.synchronize()
        runs.append((reg, out, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2**30, _counts()))
    (a, out_a, wall, peak, launches), (b, out_b, wall_b, _, _) = runs
    same = (int(a.result.steps) == int(b.result.steps) and _same_bits(out_a, out_b)
            and all(_same_bits(getattr(a.result, k), getattr(b.result, k))
                    for k in ("losses", "best_params", "final_params", "param_history")))
    pct = rmse_reduction_pct(out_a, moving, target)
    branches = {k: branch_calls[k] - calls[k] for k in branch_calls}
    losses = a.result.losses[:int(a.result.steps)].cpu().numpy()
    print(f"[lm] Register rigid, LM, default criteria, {SIZE}³: {int(a.result.steps)} "
          f"iterations, {wall:.3f} / {wall_b:.3f} s, {1e3 * wall / int(a.result.steps):.1f} ms "
          f"an iteration; RMSE reduction {pct:.3f} %; losses {losses[0]:.6g} -> "
          f"{float(a.result.best_loss):.6g}; NMI branches {json.dumps(branches)}; peak memory "
          f"{peak:.3f} GiB; two runs equal to the bit: {same}; launches {json.dumps(launches)}",
          flush=True)
    if not same:
        raise AssertionError("Register with LM and the default criteria does not repeat")
    if pct < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"Register LM rigid RMSE gate failed: {pct:.3f} %")
    _need(launches, ("sweep_fwd", "sweep_bwd", "sweep_bwd2", "splat")
          + (("splat_signed",) if branches["binned"] else ()), "Register LM")
    return launches


def phase_cohort_lm() -> dict:
    """``register_cohort`` rigid with LM on the cohort driver's 8 perturbed
    240³ pairs (``LM_COHORT``): each pair's steps, losses and best theta
    those of its own ``rigid_register`` run to the bit, max |theta - true| <
    0.05, a lower RMSE after the exact re-warp."""
    movings, targets, trues = driver_cohort(8, (SIZE,) * 3, device=DEV)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = register_cohort(movings, targets, **LM_COHORT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    kw = {k: v for k, v in LM_COHORT.items() if k != "mode"}
    same, solo_steps = 0, []
    t0 = time.perf_counter()
    for n in range(movings.shape[0]):
        _, solo = rigid_register(movings[n:n + 1], targets[n:n + 1], grad_edges=False, **kw)
        solo_steps.append(solo.steps)
        same += all(_same_bits(getattr(solo, k), getattr(res, k)[n])
                    for k in ("best_theta", "losses", "best_params"))
    torch.cuda.synchronize()
    wall_solo = time.perf_counter() - t0
    err = float(torch.max(torch.abs(res.best_theta[:, 0] - trues)))
    warped = blocked.warp_affine_fast(res.best_theta[:, 0], movings)
    rmse0 = float(torch.sqrt(torch.mean((movings - targets) ** 2)))
    rmse1 = float(torch.sqrt(torch.mean((warped - targets) ** 2)))
    print(f"[lm] register_cohort rigid LM, 8 pairs at {SIZE}³: iterations {res.steps}, alone "
          f"{solo_steps}; pairs equal to their single runs to the bit {same} of 8; max |theta - "
          f"true| {err:.5f}; RMSE {rmse0:.5f} -> {rmse1:.5f}; wall {wall:.3f} s, the 8 single "
          f"runs {wall_solo:.3f} s", flush=True)
    if res.steps != solo_steps or same != len(solo_steps) or not (err < 0.05 and rmse1 < rmse0):
        raise AssertionError("[lm] register_cohort with LM failed its checks")
    _need(launches, ("sweep_fwd_pairs", "sweep_bwd_pairs", "sweep_bwd2_pairs"),
          "register_cohort LM")
    return launches


def phase_lm(splat_inputs: dict) -> tuple[dict, list, dict]:
    """[lm]: K1's second order and the splat's signed mode against their
    plain versions, then the LM paths: the recipe through the factory, then
    ``Register`` and a cohort. Returns the kernels' deviations, each path's
    launches and the cascade rows."""
    errs = {"sweep_bwd2": max(_check_bwd2(S, K, dtype) for S, K, dtype in LM_BWD2),
            "splat_signed": _check_splat_signed(splat_inputs)}
    launches, rows = phase_lm_cascade()
    return errs, [launches, phase_register_lm(), phase_cohort_lm()], rows


def phase_lm_times(splat_inputs: dict) -> dict:
    """``sweep_bwd2`` at each shape the LM paths launch it (``LM_BWD2``, a
    table, mean of the 3 passes) and the signed splat on the default NMI's
    make_pair samples: one launch against one pass of the plain version
    (CUDA events), then the kernel's device time (``torch.profiler``).
    Bounds: sweep_bwd2 reads g, ubar and src and writes gbar and sbar (5
    volumes at the shape's dtype; ~20 operations a voxel); the signed splat
    as the splat. The signed splat's library call: one ``scatter_add`` of
    both terms. The kernels line takes sweep_bwd2's row at 240³ K=8 f32,
    each shape's row beside it under ``shapes``."""
    shapes = {}
    for S, K, dtype in LM_BWD2:
        src, g, ubar, table, rbar, axes = _bwd2_case(S, K, dtype, 0, 9500 + S + K)
        dtable = torch.empty_like(table)
        work = k1._affine_work(src, axes, [K] * 3)
        calls = [functools.partial(k1._bwd2_affine, g, src, table, p, axis, K, ubar, rbar, True,
                                   True, dtable, work) for p, axis in enumerate(axes)]
        ms = [_time_ms(call) for call in calls]
        plain = [_time_ms(functools.partial(k1.sweep_bwd2_plain, g, src, ubar, rbar[p],
                                            table[p, :3], table[p, 3], axis, K), iters=3)
                 for p, axis in enumerate(axes)]
        dev = ps.device_ms(lambda: [call() for call in calls], name="sweep_bwd2")
        row = {"ms": sum(ms) / 3, "plain_ms": sum(plain) / 3, "per_pass_ms": ms,
               "device_ms": None if dev is None else dev / 3, **psb.bwd2_bound(S, dtype)}
        if row["device_ms"]:
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
        shapes[psb.label(S, K, dtype)] = row
        print(f"[times] lm sweep_bwd2 {psb.label(S, K, dtype)}: {json.dumps(row)}", flush=True)
        del src, g, ubar, calls, work
        torch.cuda.empty_cache()
    rows = {"sweep_bwd2": {**shapes[psb.label(240, 8, torch.float32)], "shapes": shapes}}
    idx, f = splat_inputs["make_pair"]
    w = f - 0.5
    i = idx.long()
    both = (torch.zeros((f.shape[0], ks.BINS), device=DEV), torch.cat([i, i + 1], 1),
            torch.cat([-w, w], 1))
    signed = {
        "ms": _time_ms(lambda: ks.splat_launch(idx, w, signed=True)),
        "plain_ms": _time_ms(lambda: ks.splat_plain(idx, w, signed=True), iters=3),
        "library_ms": _time_ms(lambda: torch.scatter_add(both[0], 1, both[1], both[2]), iters=3),
        "device_ms": ps.device_ms(lambda: ks.splat_launch(idx, w, signed=True), name="splat_"),
        **_bound(4.0 * (2 * f.numel() + f.shape[0] * ks.BINS), 2.0 * f.numel())}
    if signed["device_ms"]:
        signed["device_bound_share"] = signed["bound_ms"] / signed["device_ms"]
    rows["splat_signed"] = signed
    print(f"[times] lm {json.dumps(rows)}", flush=True)
    return rows


# ------------------------------------------------ the exact KDE and NMI's device branch

# [kde]: the exact KDE's kernels at the default NMI's shapes (each 240³ image
# resized to 200³ and cut into 8 patches of 100³: rows of 1 M samples for a
# marginal and of 2 M for the pooled joint, 256 points, bandwidth 3.0) on
# make_pair's pair times 1000, a CT-like range on which the default NMI takes
# the exact branch (it does past a joint range of 767.25), and times 360, a
# joint range just past that flip, where the exact branch's points lie
# closest (the most terms within the kernels' cut)
KDE_SCALE = 1000.0
KDE_FLIP = 360.0
KDE_BW = pk.BANDWIDTH
KDE_BINS = pk.BINS
# each kernel output within this share of its plain version's largest entry
# (both f32: other orders of the sums, and a true division by h against
# PyTorch's multiply by the reciprocal), and within twice the plain
# version's own error against its f64 evaluation
KDE_TOL = 1e-5
KDE_ERR_RATIO = 2.0
# a launch on the binned flag: at most twice the time its zeros take to
# write at the memory rate, plus this (µs of device time)
KDE_SKIP_US = 5.0


def _kde_inputs() -> dict:
    """``{(scale, L): (s, xis, g, ubar)}``: the rows the default NMI's KDE
    sums at 240³ on the pair times each of ``KDE_SCALE`` and ``KDE_FLIP`` (a
    marginal's, the joint's), their 256 points (``nmi``'s), a cotangent
    ``g [8, 256]`` and a second-order cotangent ``ubar [8, L]`` from a seed.
    Raises unless the default NMI takes the exact branch on both (its
    predicate on the joint's points, evaluated on the card)."""
    gen = torch.Generator(device=DEV).manual_seed(15)
    out = {}
    for scale in (KDE_SCALE, KDE_FLIP):
        rows = pk.kde_rows(scale, DEV)
        for s in rows.values():
            out[scale, s.shape[1]] = (s, _sample_points(s, KDE_BINS),
                                      torch.randn((8, KDE_BINS), generator=gen, device=DEV),
                                      torch.randn(s.shape, generator=gen, device=DEV))
        xj = out[scale, rows["joint"].shape[1]][1]
        binned = bool(nmi_mod._binned_ok(KDE_BW, xj[-1], xj[0]))
        print(f"[kde] make_pair x {scale:g}: joint range {float(xj[0] - xj[-1]):.3f}, the "
              f"default NMI's branch on the card: {'binned' if binned else 'exact'}", flush=True)
        if binned:
            raise AssertionError(f"[kde] the rows x {scale:g} are not on the exact branch")
    return out


def _kde_calls(s, xis, g, ubar, flag) -> dict:
    """``{output: (kernel, plain, f64 plain)}``: the forward sum, the
    backward ``ds``, and the second order's ``gbar`` and ``sbar``, as
    ``ops/cuda/kde``'s Functions compute them from the kernels."""
    h = KDE_BW
    d = (s.double(), xis.double(), g.double(), ubar.double())
    return {
        "forward": (lambda: kk.kde_sum_launch(s, xis, h, flag),
                    lambda: kk.kde_sum_plain(s, xis, h),
                    lambda: kk.kde_sum_plain(d[0], d[1], h)),
        "ds": (lambda: kk.kde_dot_launch(g, s, xis, h, flag, 1) / h,
               lambda: kk.kde_dot_plain(g, s, xis, h, 1) / h,
               lambda: kk.kde_dot_plain(d[2], d[0], d[1], h, 1) / h),
        "gbar": (lambda: kk.kde_sum_launch(s, xis, h, flag, w=ubar, deriv=1) / h,
                 lambda: kk.kde_sum_plain(s, xis, h, w=ubar, deriv=1) / h,
                 lambda: kk.kde_sum_plain(d[0], d[1], h, w=d[3], deriv=1) / h),
        "sbar": (lambda: ubar * kk.kde_dot_launch(g, s, xis, h, flag, 2) / (h * h),
                 lambda: ubar * kk.kde_dot_plain(g, s, xis, h, 2) / (h * h),
                 lambda: d[3] * kk.kde_dot_plain(d[2], d[0], d[1], h, 2) / (h * h)),
    }


KDE_KERNEL = {"forward": "kde_sum", "ds": "kde_dot", "gbar": "kde_sum", "sbar": "kde_dot"}


def phase_kde(inputs: dict) -> dict:
    """[kde]: each output of the exact KDE's kernels (``csrc/kde.cu``) at
    the default NMI's shapes against its plain version (within ``KDE_TOL``
    of its largest entry), both against the plain version evaluated in f64
    on the card (the kernel's largest error at most ``KDE_ERR_RATIO`` times
    the plain f32 version's), two launches equal to the bit, and on the
    binned flag zeros. Returns each kernel's largest deviation from its
    plain version."""
    errs = {"kde_sum": 0.0, "kde_dot": 0.0}
    with torch.no_grad():
        for (scale, L), (s, xis, g, ubar) in inputs.items():
            exact = torch.zeros((1,), dtype=torch.int32, device=DEV)
            for name, (kernel, plain, f64) in _kde_calls(s, xis, g, ubar, exact).items():
                out, again, ref, ref64 = kernel(), kernel(), plain(), f64()
                err_k = float((out.double() - ref64).abs().max())
                err_p = float((ref.double() - ref64).abs().max())
                dev = _max_err(out, ref)
                top = float(ref.abs().max())
                repeat = torch.equal(out, again)
                print(f"[kde] {name} x {scale:g} [8, {L}] x {KDE_BINS}: two launches equal "
                      f"{repeat}; against the plain version max|d| {dev:.3e} ({dev / top:.3e} "
                      f"of its largest entry {top:.4e}, tol {KDE_TOL:g}); against f64: kernel "
                      f"{err_k:.3e}, plain f32 {err_p:.3e} (ratio {err_k / err_p:.3f}, tol "
                      f"{KDE_ERR_RATIO:g})", flush=True)
                if not repeat or dev > KDE_TOL * top or err_k > KDE_ERR_RATIO * err_p:
                    raise AssertionError(f"[kde] {name} x {scale:g} at L={L} fails its checks")
                errs[KDE_KERNEL[name]] = max(errs[KDE_KERNEL[name]], dev)
            binned = torch.ones((1,), dtype=torch.int32, device=DEV)
            for name, (kernel, _, _) in _kde_calls(s, xis, g, ubar, binned).items():
                if bool(kernel().any()):
                    raise AssertionError(f"[kde] {name} on the binned flag is not zero")
            print(f"[kde] x {scale:g} [8, {L}]: every output zero on the binned flag", flush=True)
    return errs


def _nmi_loss_host_branch(y, yp, bandwidth=KDE_BW, bins=KDE_BINS, patch=100, alpha=1000.0):
    """The default ``nmi_loss`` as the port computed it before its branch
    moved to the device: the branch read on the host (one sync a call) and
    only that branch's densities, the exact ones by the plain torch KDE
    (``kde_sum_plain``)."""
    def rows(x):
        x = nearest_resize(x, (2 * patch,) * 3)
        return x.reshape(8 * x.shape[0] * x.shape[1], -1).to(torch.float32)

    s1, s2 = rows(y), rows(yp)
    sj = torch.cat((s1, s2), 1)
    xis = [_sample_points(s, bins) for s in (s1, s2, sj)]
    x0, xe = xis[2][0], xis[2][-1]
    L = s1.shape[1]
    if bool(nmi_mod._binned_ok(bandwidth, xe, x0)):
        H1, H2 = (nmi_mod._binned_histogram(s, x0, xe) for s in (s1, s2))
        hists = [nmi_mod._density_from_hist(H, x0, xe, x, bandwidth, n)
                 for H, x, n in ((H1, xis[0], L), (H2, xis[1], L), (H1 + H2, xis[2], 2 * L))]
    else:
        hists = [kk.kde_sum_plain(s, x, bandwidth) / (bandwidth * s.shape[1])
                 for s, x in zip((s1, s2, sj), xis)]
    e1, e2, ej = (-torch.sum(p * -torch.log2(p + nmi_mod.EPSILON), dim=1)
                  for p in (h / torch.sum(h, dim=1, keepdim=True) for h in hists))
    mi = e1 + e2 - ej
    return torch.mean(torch.abs(2.0 * mi / (e1 + e2) - 1.0)) * alpha


def _nmi_step(loss_fn, y, yp, reps=3) -> dict:
    """One value and gradient of ``loss_fn(y, yp)``: wall ms (synchronised,
    after a warm-up), the device ms of the exact KDE's kernels in it
    (``torch.profiler``), the value and the gradient."""
    def step():
        p = yp.clone().requires_grad_(True)
        loss = loss_fn(y, p)
        loss.backward()
        return loss.detach(), p.grad

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        loss, grad = step()
    torch.cuda.synchronize()
    return {"ms": 1e3 * (time.perf_counter() - t0) / reps,
            "kde_device_ms": ps.device_ms(step, iters=reps, name="kde_"),
            "value": float(loss), "grad": grad}


def phase_kde_times(inputs: dict) -> dict:
    """``kde_sum`` (phi) and ``kde_dot`` (phi') on the joint's rows
    (``[8, 2 M]`` x 256) times ``KDE_SCALE`` and, under ``flip``, times
    ``KDE_FLIP``: one launch by CUDA events and its device time
    (``torch.profiler``), one pass of its plain version, a launch on the
    binned flag (device time, against its zeros' write), with the bounds
    recounted on these rows (``profile_kde.kde_bound``: the terms within the
    cut, beside the dense count); a device time under its bound raises (the
    count would be wrong); no PyTorch call sums Gaussians of pairwise
    differences (``library_ms`` None). Then the default ``nmi_loss`` at 240³
    with its gradient on each branch (make_pair's pair, and times 1000), this
    path against the host branch's (:func:`_nmi_loss_host_branch`): wall
    time, and the exact KDE's device time in it."""
    h = KDE_BW
    exact = torch.zeros((1,), dtype=torch.int32, device=DEV)
    binned = torch.ones_like(exact)
    rows = {}
    with torch.no_grad():
        for scale in (KDE_SCALE, KDE_FLIP):
            s, xis, g, _ = inputs[scale, max(L for sc, L in inputs if sc == scale)]
            N, L = s.shape
            for name, kind, launch, plain in (
                    ("kde_sum", "sum", lambda f: kk.kde_sum_launch(s, xis, h, f),
                     lambda: kk.kde_sum_plain(s, xis, h)),
                    ("kde_dot", "dot", lambda f: kk.kde_dot_launch(g, s, xis, h, f, 1),
                     lambda: kk.kde_dot_plain(g, s, xis, h, 1))):
                row = {"ms": _time_ms(lambda: launch(exact), iters=5, warmup=1),
                       "plain_ms": _time_ms(plain, iters=1, warmup=1), "library_ms": None,
                       "device_ms": ps.device_ms(lambda: launch(exact), iters=3, name="kde_"),
                       "binned_device_ms": ps.device_ms(lambda: launch(binned), name="kde_"),
                       **pk.kde_bound(kind, s, xis, h)}
                zeros_ms = 1e3 * 4.0 * (N * (L if kind == "dot" else KDE_BINS)) / HBM_BYTES_PER_S
                row["binned_gate_ms"] = 2 * zeros_ms + KDE_SKIP_US / 1e3
                if row["device_ms"] is not None:
                    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
                print(f"[times] {name} x {scale:g} [{N}, {L}] x {KDE_BINS}: {json.dumps(row)}",
                      flush=True)
                if scale == KDE_SCALE:
                    rows[name] = row
                else:
                    rows[name]["flip"] = row
                if row["binned_device_ms"] is not None and (
                        row["binned_device_ms"] > row["binned_gate_ms"]):
                    raise AssertionError(f"[kde] {name} on the binned flag took "
                                         f"{row['binned_device_ms']} ms")
                if row["device_ms"] is not None and row["device_ms"] < row["bound_ms"]:
                    raise AssertionError(f"[kde] {name} x {scale:g} ran under its bound: "
                                         f"{row['device_ms']} < {row['bound_ms']} ms")
    moving, target = make_pair((SIZE,) * 3, device=DEV)
    for scale, branch in ((1.0, "binned"), (KDE_SCALE, "exact")):
        y, yp = target * scale, moving * scale
        branch_calls.reset()
        mine = _nmi_step(nmi_loss, y, yp)
        took = dict(branch_calls)
        host = _nmi_step(_nmi_loss_host_branch, y, yp, reps=2)
        value, value_host = mine["value"], host["value"]
        grad, grad_host = mine.pop("grad"), host.pop("grad")
        same = value == value_host and torch.equal(grad, grad_host)
        gerr = _max_err(grad, grad_host) / float(grad_host.abs().max())
        rows[f"nmi_{branch}"] = {**mine, **{f"host_branch_{k}": v for k, v in host.items()
                                            if k != "kde_device_ms"},
                                 "equal_to_the_bit": same, "grad_rel_err": gerr,
                                 "branches": took}
        print(f"[times] nmi_loss default at {SIZE}³ x {scale:g} ({branch} branch), value and "
              f"gradient: {json.dumps(rows[f'nmi_{branch}'])}", flush=True)
        if took[branch] == 0 or took["binned" if branch == "exact" else "exact"]:
            raise AssertionError(f"nmi_loss took another branch than {branch}: {took}")
        if branch == "binned" and not same:
            raise AssertionError("the binned nmi_loss differs from the host branch's path")
        if not (math.isfinite(value) and abs(value - value_host) <= 1e-3 * abs(value_host)
                and gerr < 1e-3):
            raise AssertionError(f"the exact nmi_loss disagrees with the host branch's path: "
                                 f"{rows[f'nmi_{branch}']}")
    return rows


def _timed_ref(m, t, recipe):
    """``register_cascade(m, t, **recipe)`` and its synchronised wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = register_cascade(m, t, **recipe)
    torch.cuda.synchronize()
    return ref, time.perf_counter() - t0


def _check_default_fn(label, fn, ref, m, t, calls=3) -> dict:
    """``calls`` calls of ``fn`` (the first captures every level, the rest
    replay) each equal to ``ref`` to the bit; the wall of each call, the
    launches of the last, each level's [captures, replays], and the matrix
    levels' ms a step of one more call (``_matrix_levels``)."""
    walls, same = [], []
    for _ in range(calls):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(m, t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        same.append(all(_same_bits(getattr(res, k), getattr(ref, k))
                        if isinstance(getattr(ref, k), torch.Tensor)
                        else getattr(res, k) == getattr(ref, k) for k in ref._fields))
    launches = _counts()
    levels = _matrix_levels(fn, m, t)
    for r in levels:
        r.append(round(r[2] / max(r[3], 1), 3))  # ms a step
    graphs = fn.graphs.counts()
    if not all(same):
        raise AssertionError(f"{label}: make_cascade_fn differs from register_cascade: {same}")
    if any(c != 1 or r <= 0 for c, r in graphs.values()):
        raise AssertionError(f"{label}: a level's step was not captured once and replayed: "
                             f"{graphs}")
    _on_cuda(res)
    _finite(res, tuple(m.shape))
    return {"res": res, "walls_s": walls, "launches": launches, "levels": levels,
            "graphs": graphs}


DEFAULT_RECIPE = {**RECIPE, "criterions": None}


def phase_cascade_fn_default() -> tuple[dict, list]:
    """[cascade-fn-default]: ``make_cascade_fn(**RECIPE, criterions=None)``
    (MSE + NCC + NMI, NMI on the binned branch) on both 240³ pairs, three
    calls each, each equal to ``register_cascade`` of the same config to
    the bit; the rigid gate; the deformable pair's quality printed (the
    recipe's flow gates were set for MSE + NCC); walls after warm-up beside
    ``register_cascade``'s; ms a step of the matrix levels through the
    graphs. Returns the launches and the rigid pair's run for
    :func:`phase_busy`."""
    fn = make_cascade_fn(**DEFAULT_RECIPE)
    pairs = {"rigid pair": make_pair(device=DEV), "deformable pair": make_flow_truth_pair(device=DEV)}
    total, runs = {}, []
    register_cascade(*pairs["rigid pair"], **DEFAULT_RECIPE)  # the run's first NMI: warm-up
    for label, (m, t, *truth) in pairs.items():
        branch_calls.reset()
        ref, wall_ref = _timed_ref(m, t, DEFAULT_RECIPE)
        got = _check_default_fn(f"[cascade-fn-default] {label}", fn, ref, m, t)
        q = (_pair_quality("rigid", got["res"], m, t, None) if not truth
             else _pair_quality("deformable", got["res"], m, t, truth))
        row = {"steps": ref.steps, "register_cascade_s": wall_ref, "fn_s": got["walls_s"],
               "levels": got["levels"], "quality": q, "nmi_branches": dict(branch_calls)}
        print(f"[cascade-fn-default] {label}: graphs {json.dumps(got['graphs'])}; three calls "
              f"equal to register_cascade to the bit: True; {json.dumps(row)} (levels: "
              f"[stage, edge, ms, steps, ms a step]); launches of the last call "
              f"{json.dumps(got['launches'])}", flush=True)
        if not truth and q["rmse_reduction_pct"] < GATES["rmse_reduction_pct"]:
            raise AssertionError(f"[cascade-fn-default] rigid gate failed: {q}")
        _need(got["launches"], ("sweep_fwd", "sweep_bwd", *K1_MODES, "splat", "kde_sum",
                                "kde_dot"), f"make_cascade_fn default criteria ({label})")
        for k, v in got["launches"].items():
            total[k] = total.get(k, 0) + v
        if not truth:
            runs.append((f"{label}, default criteria", DEFAULT_RECIPE, m, t, wall_ref,
                         got["walls_s"][-1]))
    return total, runs


def phase_cascade_fn_exact() -> dict:
    """[cascade-fn-exact]: the same factory on make_pair's pair times 1000
    (a CT-like range: every NMI call on the exact branch, through the KDE
    kernels): three calls equal to ``register_cascade`` to the bit, the
    device branch counter showing exact calls only, finite losses."""
    fn = make_cascade_fn(**DEFAULT_RECIPE)
    m, t = (x * KDE_SCALE for x in make_pair(device=DEV))
    branch_calls.reset()
    ref, wall_ref = _timed_ref(m, t, DEFAULT_RECIPE)  # the kernels warmed up by [kde]
    got = _check_default_fn("[cascade-fn-exact]", fn, ref, m, t)
    branches = dict(branch_calls)
    res = got["res"]
    finite = all(bool(torch.isfinite(x[~torch.isnan(x)]).all())
                 for x in (res.rigid_losses, res.affine_losses, res.flow_losses))
    row = {"steps": ref.steps, "register_cascade_s": wall_ref, "fn_s": got["walls_s"],
           "levels": got["levels"], "nmi_branches": branches, "losses_finite": finite,
           "quality": _pair_quality("rigid", res, m, t, None)}
    print(f"[cascade-fn-exact] rigid pair x {KDE_SCALE:g}: graphs {json.dumps(got['graphs'])}; "
          f"three calls equal to register_cascade to the bit: True; {json.dumps(row)}; "
          f"launches of the last call {json.dumps(got['launches'])}", flush=True)
    if branches["binned"] or not branches["exact"]:
        raise AssertionError(f"[cascade-fn-exact] NMI took the binned branch: {branches}")
    if not finite:
        raise AssertionError("[cascade-fn-exact] a loss is not finite")
    _need(got["launches"], ("sweep_fwd", "sweep_bwd", *K1_MODES, "kde_sum", "kde_dot"),
          "make_cascade_fn on the exact branch")
    return got["launches"]


def phase_cascade_batch_default() -> dict:
    """[cascade-batch-default]: ``make_cascade_batch_fn(**RECIPE,
    criterions=None)`` on [cohort]'s 8 pairs and make_pair's pair times 1000
    (so that one batch takes both branches), one call; each pair equal to
    its single ``make_cascade_fn`` run to the bit (steps, theta, flow,
    image, losses)."""
    inputs = _cohort_inputs()
    scaled = make_pair(device=DEV)
    movings = torch.cat([m for _, _, m, _, _ in inputs] + [scaled[0] * KDE_SCALE])
    targets = torch.cat([t for _, _, _, t, _ in inputs] + [scaled[1] * KDE_SCALE])
    del inputs, scaled
    B = movings.shape[0]
    fn, single = make_cascade_batch_fn(**DEFAULT_RECIPE), make_cascade_fn(**DEFAULT_RECIPE)
    _reset_counts()
    branch_calls.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(movings, targets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, branches = _counts(), dict(branch_calls)
    bits, walls = [], []
    for b in range(B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = single(movings[b:b + 1], targets[b:b + 1])
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t0, 4))
        bits.append({k: v[b] for k, v in res.steps.items()} == ref.steps and all(
            _same_bits(getattr(res, n)[b], getattr(ref, n))
            for n in ("warped", "theta", "flow", "rigid_losses", "affine_losses",
                      "flow_losses")))
    print(f"[cascade-batch-default] make_cascade_batch_fn(**RECIPE, criterions=None), {B} pairs "
          f"at {SIZE}³ (the last scaled by {KDE_SCALE:g}, on the exact branch): wall {wall:.3f} "
          f"s, the single runs {json.dumps(walls)} s; steps {json.dumps(res.steps)}; NMI "
          f"branches {json.dumps(branches)}; pairs equal to their single runs to the bit "
          f"{sum(bits)} of {B}; graphs {json.dumps(fn.graphs.counts())}; launches "
          f"{json.dumps(launches)}", flush=True)
    if not all(bits):
        raise AssertionError(f"[cascade-batch-default] pairs differ from their single runs: "
                             f"{[b for b, ok in enumerate(bits) if not ok]}")
    if not (branches["binned"] and branches["exact"]):
        raise AssertionError(f"[cascade-batch-default] one batch did not take both branches: "
                             f"{branches}")
    _need(launches, ("sweep_fwd_pairs", "sweep_bwd_pairs", "splat", "kde_sum", "kde_dot"),
          "make_cascade_batch_fn default criteria")
    del res, movings, targets
    torch.cuda.empty_cache()
    return launches


def phase_lm_default() -> dict:
    """[lm] with the default criteria: ``make_cascade_fn(**LM_RECIPE,
    criterions=None)`` on make_pair's pair, equal to ``register_cascade`` to
    the bit (LM's Hessian through the splat's signed mode; the exact KDE's
    kernels skip themselves on the binned path), within the rigid gate."""
    recipe = {**LM_RECIPE, "criterions": None}
    m, t = make_pair(device=DEV)
    ref = register_cascade(m, t, **recipe)
    got = _check_default_fn("[lm] default criteria", make_cascade_fn(**recipe), ref, m, t,
                            calls=2)
    q = _pair_quality("rigid", got["res"], m, t, None)
    print(f"[lm] make_cascade_fn(**LM_RECIPE, criterions=None), rigid pair: LM iterations "
          f"{ref.steps}; equal to register_cascade to the bit: True; graphs "
          f"{json.dumps(got['graphs'])}; walls {json.dumps(got['walls_s'])} s; levels "
          f"{json.dumps(got['levels'])}; {json.dumps(q)}; launches {json.dumps(got['launches'])}",
          flush=True)
    if q["rmse_reduction_pct"] < GATES["rmse_reduction_pct"]:
        raise AssertionError(f"[lm] default criteria rigid gate failed: {q}")
    _need(got["launches"], ("sweep_bwd2", "splat", "splat_signed", "kde_sum", "kde_dot"),
          "LM with the default criteria")
    return got["launches"]


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


def phase_mode_times() -> list:
    """K1's affine and flow forms at the main path's shapes (``ps.SHAPES``):
    one launch of each form against the dense launch on the coordinates the
    per-pass composition built, in turns, and the plain version, with their
    bounds; one 3-pass warp through the whole-warp Functions against that
    composition, forward and forward+backward with the warp's parameter
    requiring grad; the aten operations of one in-loop warp both ways
    (``profile_sweep``)."""
    rows = []
    for shape in ps.SHAPES:
        row = ps.launch_row(*shape)
        print(f"[times] launch {json.dumps(row)}", flush=True)
        rows.append(row)
    for shape in ps.SHAPES:
        print(f"[times] warp3 {json.dumps(ps.warp3_row(*shape))}", flush=True)
    print(f"[times] ops {json.dumps(ps.op_counts())}", flush=True)
    return rows


def phase_k2_times() -> dict:
    """One K2 launch at 240³ (f32, one channel) against one pass of
    ``warp_plain`` and one ``F.grid_sample`` (trilinear, zeros padding) on a
    grid made beforehand, the library call: CUDA events (``ms``), and the
    kernels' device time (``device_ms``, ``torch.profiler``); the bound (the
    source and the field read once, the output written once, at 3.35 TB/s)
    and its share of the device time; the share of blocks that staged
    their box. Affine mode with the selftest theta, flow mode with a smooth
    field of |flow| <= 8."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(9)
    src = torch.rand((1, SIZE, SIZE, SIZE), generator=gen, device=DEV)
    theta = rigid_theta(torch.tensor(wc.SELFTEST_THETA, device=DEV))[None]
    mt = wc.index_map(theta, (SIZE,) * 3)
    flow = wc.smooth_flow(SIZE, 8.0, 10, DEV)
    o = torch.arange(SIZE, dtype=torch.float32, device=DEV)
    idx = torch.stack(torch.meshgrid(o, o, o, indexing="ij")) + flow
    grids = {"warp_affine": affine_grid(theta, (SIZE,) * 3),
             "warp_flow": ((2.0 * idx + 1.0) / SIZE - 1.0).flip(0).permute(1, 2, 3, 0)[None]
             .contiguous()}
    del idx
    vol = src[None]
    times = {}
    with torch.no_grad():
        for name, aux in (("warp_affine", {"mt": mt}), ("warp_flow", {"flow": flow})):
            launch = getattr(k2, f"{name}_launch")

            def kernel(aux=aux, launch=launch):
                return launch(src, *aux.values())

            def library(g=grids[name]):
                return F.grid_sample(vol, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False)
            k2.reset_counts()
            kernel()
            torch.cuda.synchronize()
            row = {"ms": _time_ms(kernel),
                   "plain_ms": _time_ms(lambda aux=aux: k2.warp_plain(src, **aux), iters=5),
                   "library_ms": _time_ms(library),
                   "staged_share": k2.staged_blocks() / k2.tiles_launched}
            row.update(device_ms=ps.device_ms(kernel, name="warp_kernel"),
                       library_device_ms=ps.device_ms(library, name="grid_sampler"),
                       **pw_bound(name))
            row["bound_share"] = (row["bound_ms"] / row["device_ms"] if row["device_ms"]
                                  else None)
            times[name] = row
    print(f"[times] K2 at 240³: {json.dumps(times)}", flush=True)
    return times


def pw_bound(name: str) -> dict:
    """K2's bound at 240³, one channel: bytes (the source, the field in the
    flow mode, the output) against ~60 f32 operations a voxel (8 weights, 8
    products, 8 sums, the coordinates)."""
    planes = 2 + (3 if name == "warp_flow" else 0)
    return _bound(planes * 4.0 * SIZE**3, 60.0 * SIZE**3)


def phase_k3_times() -> dict:
    """K3's three launches (forward; dgrad, padding 2 on the cotangent itself;
    the weight gradient) against cuDNN with TF32 off (``F.conv3d``,
    ``torch.nn.grad.conv3d_input`` and ``conv3d_weight``: the forward's plain
    version and the library calls) and the weight gradient's plain version
    (27 matmuls) at two of the U-Net cascade's 120³-level shapes, f32, CUDA
    events, with each shape's bounds."""
    rows = {}
    for ci, co, edge in ((8, 8, 118), (32, 16, 54)):
        gen = torch.Generator(device=DEV).manual_seed(ci + co + edge)
        x = torch.randn((1, ci, edge, edge, edge), generator=gen, device=DEV)
        w = torch.randn((3, 3, 3, ci, co), generator=gen, device=DEV) / math.sqrt(27 * ci)
        g = torch.randn((1, co) + (edge - 2,) * 3, generator=gen, device=DEV)
        w_t = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        with torch.no_grad():
            row = {"fwd_ms": _time_ms(lambda: k3.conv_launch(x, w)),
                   "plain_fwd_ms": _time_ms(lambda: torch.nn.functional.conv3d(x, wt)),
                   "dgrad_ms": _time_ms(lambda: k3.conv_launch(g, w_t, pad=2)),
                   "plain_dgrad_ms": _time_ms(
                       lambda: torch.nn.grad.conv3d_input(x.shape, wt, g)),
                   "dw_ms": _time_ms(lambda: k3.wgrad_launch(x, g)),
                   "plain_dw_ms": _time_ms(
                       lambda: torch.nn.grad.conv3d_weight(x, wt.shape, g)),
                   "wgrad_plain_ms": _time_ms(lambda: k3.wgrad_plain(x, g), iters=5),
                   **_k3_bound(ci, co, edge)}
        rows[f"{ci}->{co} edge {edge}"] = row
        print(f"[times] K3 {ci}->{co} edge {edge} f32: {json.dumps(row)}", flush=True)
    return rows


def phase_k3_pair_times() -> dict:
    """K3 with a weight set per pair at the U-Net cohort's 120³ level
    (``COHORT_UNET_B`` pairs, 8->8 on 118³ and 32->16 on 54³, f32): each of
    the three per-pair launches against the B single launches it replaces,
    in turns, against its plain version (a call a pair) and against one
    grouped cuDNN call (TF32 off: ``F.conv3d``, ``conv3d_input`` and
    ``conv3d_weight`` with ``groups=B`` on the pairs folded into the
    channels), CUDA events, with B times a single launch's bounds."""
    B, rows = COHORT_UNET_B, {}
    for ci, co, edge in ((8, 8, 118), (32, 16, 54)):
        x, w, g, w_t = _k3_pair_case(B, ci, co, edge, torch.float32, ci + co + edge)
        xg, gg = x.reshape((1, B * ci) + x.shape[2:]), g.reshape((1, B * co) + g.shape[2:])
        wg = w.permute(0, 5, 4, 1, 2, 3).reshape((B * co, ci, 3, 3, 3)).contiguous()
        xs = [x[b:b + 1] for b in range(B)]
        gs = [g[b:b + 1] for b in range(B)]
        row = {}
        with torch.no_grad():
            for kind, mine, one, plain, lib in (
                    ("fwd", lambda: k3.conv_launch(x, w),
                     lambda: [k3.conv_launch(xs[b], w[b]) for b in range(B)],
                     lambda: k3.conv3x3x3_plain(x, w),
                     lambda: torch.nn.functional.conv3d(xg, wg, groups=B)),
                    ("dgrad", lambda: k3.conv_launch(g, w_t, pad=2),
                     lambda: [k3.conv_launch(gs[b], w_t[b], pad=2) for b in range(B)],
                     lambda: k3.conv3x3x3_plain(g, w_t, pad=2),
                     lambda: torch.nn.grad.conv3d_input(xg.shape, wg, gg, groups=B)),
                    ("wgrad", lambda: k3.wgrad_launch(x, g, per_pair=True),
                     lambda: [k3.wgrad_launch(xs[b], gs[b]) for b in range(B)],
                     lambda: k3.wgrad_plain(x, g, per_pair=True),
                     lambda: torch.nn.grad.conv3d_weight(xg, wg.shape, gg, groups=B))):
                t = ps.in_turns({"ms": mine, "singles_ms": one})
                row[f"conv3d_{kind}_pairs"] = {
                    **t, "plain_ms": _time_ms(plain, iters=3, warmup=1),
                    "library_ms": _time_ms(lib, iters=5, warmup=2),
                    **_k3_bound(ci, co, edge, B)}
        rows[f"{B}x {ci}->{co} edge {edge}"] = row
        print(f"[times] K3 a weight set per pair, {B} pairs {ci}->{co} edge {edge} f32: "
              f"{json.dumps(row)}", flush=True)
    return rows


def _k3_bound(ci: int, co: int, edge: int, pairs: int = 1) -> dict:
    """The bound of each of K3's three kernels at ``ci -> co`` on an ``edge``
    cube: each moves one input of ``ci`` channels, one of ``co`` channels
    (edge - 2) and the weights once, and does the forward's 2 * 27 * ci * co
    operations a valid output voxel (dgrad's taps past the cotangent are
    zero and not counted), f32 on the tensor cores at the 3xTF32 rate; the
    same over the f32 FMA peak as ``fma_bound_ms``; ``pairs`` times that
    with a weight set per pair."""
    nbytes = 4.0 * pairs * (ci * edge**3 + co * (edge - 2)**3 + 27 * ci * co)
    flops = 2.0 * pairs * 27 * ci * co * (edge - 2)**3
    return {**_bound(nbytes, flops, F32_3XTF32_FLOP_PER_S),
            "fma_bound_ms": _bound(nbytes, flops)["bound_ms"]}


def _bound(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over their
    peak (f32 outside the tensor cores unless ``flop_per_s`` says other)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
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


def _take_index(case: str, args) -> tuple:
    """The ``torch.take`` that computes a copy case: its source and its flat
    indices, made beforehand (P5's on the slab with a zero appended for the
    empty lanes)."""
    if CASE_KERNEL.get(case, case) == "slab_gather":
        vol, orgs, Bz, By = args
        z, y = hg._slab_index(orgs, Bz, By)
        return vol, ((z[..., None] * vol.shape[1] + y[..., None]) * vol.shape[2]
                     + torch.arange(vol.shape[2], device=DEV))
    slab, starts, Bz, By, CW, lanes = args
    s = starts.long()
    r = torch.arange(lanes, device=DEV)
    flat = (((s[:, 0, None] + r // By) * slab.shape[1] + s[:, 1, None] + r % By)[:, None, :]
            * slab.shape[2] + s[:, 2, None, None] + torch.arange(CW, device=DEV)[None, :, None])
    flat = torch.where(r < Bz * By, flat, slab.numel())  # the appended zero
    return torch.cat([slab.flatten(), torch.zeros(1, device=DEV)]), flat


def _copy_bytes(case: str, args) -> float:
    """The bytes a copy case needs: each row (slab_gather) or window element
    (slice_transpose) its index data touch read once, distinct ones
    counted, the index data, and its output written once."""
    if CASE_KERNEL.get(case, case) == "slab_gather":
        vol, orgs, Bz, By = args
        o = orgs.cpu().numpy()
        need = _touched_rows(o, Bz, By, *vol.shape[:2]) * vol.shape[2]
        return 4.0 * (need + o.shape[0] * Bz * By * vol.shape[2] + o.size)
    slab, starts, Bz, By, CW, lanes = args
    touched = np.zeros(tuple(slab.shape), bool)
    for dz, dy, ox in starts.cpu().numpy():
        touched[dz:dz + Bz, dy:dy + By, ox:ox + CW] = True
    return 4.0 * (touched.sum() + starts.shape[0] * (CW * lanes + 3))


def phase_probe_times(inputs: dict) -> dict:
    """One launch of each probe kernel against one pass of its plain
    version and, for the copies (P2, P4, P5, each redesigned copy also at
    its device-bound size), one ``torch.take`` with the indices made
    beforehand, CUDA events over 20 launches (``ms``); for the copies also
    the device time of the kernel and of the ``torch.take`` alone
    (``device_ms``, ``library_device_ms``: ``torch.profiler``'s kernel spans,
    no host time) and, at the device-bound sizes, one ``zero_`` of the
    output (``write_only_ms``: its writes alone). Bounds: the bytes the
    function needs (each row or block it reads once, its output written
    once) over 3.35 TB/s. P1, P3 and the fetch have no one PyTorch call that
    computes them; their device times (``device_ms``) count every kernel of
    a launch (the sums' two stages), and P1's row also holds the device span
    of an empty kernel launched through the same path
    (``empty_kernel_device_ms``) and the larger of it and P1's byte bound
    (``floor_bound_ms``)."""
    rows = {}
    for case, (args, _) in inputs.items():
        launch, plain = PROBE_FNS[CASE_KERNEL.get(case, case)]
        with torch.no_grad():
            rows[case] = {"ms": _time_ms(lambda: launch(*args)),
                          "plain_ms": _time_ms(lambda: plain(*args), iters=3),
                          "library_ms": None}
    takes = {case: _take_index(case, inputs[case][0]) for case in COPIES}
    for case, (src, flat) in takes.items():
        # the library call computes the same function: the same values
        if not torch.equal(torch.take(src, flat), PROBE_FNS[CASE_KERNEL.get(case, case)][0](
                *inputs[case][0])):
            raise AssertionError(f"torch.take does not compute {case}")
        rows[case]["library_ms"] = _time_ms(lambda: torch.take(src, flat))
        if case.endswith("_big"):  # how near the card's write rate the copy runs
            out = torch.empty(flat.shape, device=DEV)
            rows[case]["write_only_ms"] = _time_ms(out.zero_)
    # the profiler last: once it has run, each launch costs the host more
    for case, (src, flat) in takes.items():
        args = inputs[case][0]
        launch = PROBE_FNS[CASE_KERNEL.get(case, case)][0]
        rows[case].update(
            device_ms=ps.device_ms(lambda: launch(*args),
                                   name=f"{CASE_KERNEL.get(case, case)}_kernel"),
            library_device_ms=ps.device_ms(lambda: torch.take(src, flat), name=""))
    del takes
    # the sums' device time, both stages' kernels; P1's, and the span of an
    # empty kernel launched through the same path: the floor under any launch
    for case, name in (("slab_sum", "slab_sum_"), ("roi_fetch", "roi_fetch_"),
                       ("block_permute_add", "block_permute_add_kernel")):
        args = inputs[case][0]
        rows[case]["device_ms"] = ps.device_ms(lambda: PROBE_FNS[case][0](*args), name=name)
    one = torch.empty(1, device=DEV)
    rows["block_permute_add"]["empty_kernel_device_ms"] = ps.device_ms(
        lambda: hg.LIB.launch("empty_launch", one, 1), name="empty_kernel")
    x, order = inputs["block_permute_add"][0]
    bounds = {"block_permute_add": 4.0 * (order.numel() * 8 * x.shape[1] * 2 + order.numel()),
              **{case: _copy_bytes(case, inputs[case][0]) for case in COPIES}}
    vol, orgs, Bz, By = inputs["slab_sum"][0]
    o = orgs.cpu().numpy()
    bounds["slab_sum"] = 4.0 * (_touched_rows(o, Bz, By, *vol.shape[:2]) * vol.shape[2]
                                + o.shape[0] * 8 * vol.shape[2] + o.size)
    volp, scal = inputs["roi_fetch"][0]
    sc = scal.cpu().numpy()
    blocks = np.zeros((volp.shape[0] // rs.QB, volp.shape[1] // rs.QB), bool)
    for zq, yq in sc[:, :2]:
        blocks[zq:zq + rs.NB, yq:yq + rs.NB] = True
    bounds["roi_fetch"] = 4.0 * (blocks.sum() * rs.QB * rs.QB * volp.shape[2]
                                 + sc.shape[0] * (rs.LANES + 5))
    for case, nbytes in bounds.items():
        rows[case].update(_bound(nbytes, 0.0), bytes=nbytes)
    for case in (*COPIES, "slab_sum", "roi_fetch", "block_permute_add"):
        row = rows[case]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if row["device_ms"] is not None:
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    # P1's bytes take less time than any launch's shortest span
    p1 = rows["block_permute_add"]
    if p1["empty_kernel_device_ms"] is not None:
        p1["floor_bound_ms"] = max(p1["bound_ms"], p1["empty_kernel_device_ms"])
        if p1["device_ms"] is not None:
            p1["floor_bound_share"] = p1["floor_bound_ms"] / p1["device_ms"]
    T = inputs["slab_sum"][0][1].shape[0]
    logical = T * 14 * 16 * 256 * 4.0
    rows["slab_sum"]["logical_TBps"] = logical / (rows["slab_sum"]["ms"] * 1e9)
    T = sc.shape[0]
    logical = T * 9 * rs.QB * rs.QB * volp.shape[2] * 4.0
    rows["roi_fetch"]["logical_TBps"] = logical / (rows["roi_fetch"]["ms"] * 1e9)
    for case, row in rows.items():
        print(f"[times] probe {case}: {json.dumps(row)}", flush=True)
    return rows


def phase_splat_times(inputs: dict) -> dict:
    """The NMI splat on each case of ``_splat_inputs``: one launch against
    one pass of its plain version (two ``scatter_add``) and one
    ``torch.scatter_add`` of both terms on indices made beforehand (the
    library call), CUDA events (``ms``); then the kernel's and the library
    call's device time (``torch.profiler``). Bound: idx and f read once and
    H written once over 3.35 TB/s (its two adds a sample at 67 TFLOP/s take
    far less)."""
    rows = {}
    with torch.no_grad():
        libs = {}
        for case, (idx, f) in inputs.items():
            i = idx.long()
            both = (torch.zeros((f.shape[0], ks.BINS), device=DEV), torch.cat([i, i + 1], 1),
                    torch.cat([1.0 - f, f], 1))
            libs[case] = lambda both=both: torch.scatter_add(both[0], 1, both[1], both[2])
            rows[case] = {"ms": _time_ms(lambda: ks.splat_launch(idx, f)),
                          "plain_ms": _time_ms(lambda: ks.splat_plain(idx, f), iters=3),
                          "library_ms": _time_ms(libs[case], iters=3)}
        for case, (idx, f) in inputs.items():
            row = rows[case]
            row.update(device_ms=ps.device_ms(lambda: ks.splat_launch(idx, f), name="splat_"),
                       library_device_ms=ps.device_ms(libs[case], iters=3, name=""),
                       **_bound(4.0 * (2 * f.numel() + f.shape[0] * ks.BINS), 2.0 * f.numel()))
            if row["device_ms"] is not None:
                row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            print(f"[times] splat {case}, {tuple(f.shape)} samples: {json.dumps(row)}",
                  flush=True)
    return rows


def phase_launch_path(inputs: dict, calls: int = 2000) -> dict:
    """Host microseconds per call of one launch through the port's launch
    path (``native.Library.launch``) of an empty kernel, and of the parts
    of the path every wrapper took before it: the device guard, the Stream
    object, the ctypes call (alone, and with the CUDA launch), ``torch.empty``
    on the card; also one whole ``slab_gather_launch`` at P2's size. Each
    over ``calls`` calls after a warm-up, host clock, one synchronise at the
    end; each measured twice, the list in order and reversed."""
    t = torch.empty(1, device=DEV)
    index, dev = t.get_device(), t.device
    fn = hg.LIB.fns()["empty_launch"]
    stream = torch.cuda.current_stream().cuda_stream
    vol, orgs, Bz, By = inputs["slab_gather"][0]

    def old_path():  # the wrappers' launch before the helper
        with torch.cuda.device(dev):
            rc = fn(1, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty_launch failed: cudaError {rc}")

    def guard():
        with torch.cuda.device(dev):
            pass

    parts = {"helper_us": lambda: hg.LIB.launch("empty_launch", t, 1),
             "old_path_us": old_path,
             "ctypes_launch_us": lambda: fn(1, stream),
             "ctypes_call_us": lambda: fn(0, stream),
             "device_guard_us": guard,
             "stream_object_us": lambda: torch.cuda.current_stream(index).cuda_stream,
             "raw_stream_us": lambda: torch._C._cuda_getCurrentRawStream(index),
             "current_device_us": torch.cuda.current_device,
             "raw_device_us": torch._C._cuda_getDevice,
             "torch_empty_us": lambda: torch.empty(vol.shape, device=dev),
             "new_empty_us": lambda: vol.new_empty(vol.shape),
             "slab_gather_launch_us": lambda: hg.slab_gather_launch(vol, orgs, Bz, By)}

    def us(f) -> float:
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / calls

    got = {name: [] for name in parts}
    for name in list(parts) + list(parts)[::-1]:
        got[name].append(us(parts[name]))
    print(f"[times] launch-path {json.dumps({'calls': calls, **got})}", flush=True)
    return got


def _sweep_extras(name: str, flow_row: dict, modes: dict, row_err: float) -> dict:
    """K1's line beside its flow-form time: the dense launch's on the same
    coordinates, and every form's times and bounds at the path's shapes; the
    backward's, the largest relative deviation of an affine table row's
    gradient from autograd through the plain version."""
    kind = "fwd" if name == "sweep_fwd" else "bwd"
    keys = (f"{kind}_ms", f"dense_{kind}_ms", f"{kind}_device_ms", f"dense_{kind}_device_ms",
            f"{kind}_bound_ms", f"dense_{kind}_bound_ms")
    extras = {"dense_ms": flow_row[f"dense_{kind}_ms"],
              "modes": {label: {k: r[k] for k in keys} for label, r in modes.items()}}
    if kind == "bwd":
        extras["affine_row_grad_max_rel_err"] = row_err
    return extras


# the line of the sums, P1 and the splat beside their event times: their
# device times and bound shares; P1's launch floor; the splat's worst case
SUM_EXTRAS = ("device_ms", "device_bound_share")
P1_EXTRAS = ("device_ms", "empty_kernel_device_ms", "floor_bound_ms", "floor_bound_share")


def _splat_extras(splat_rows: dict) -> dict:
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "bound_ms")
    return {"device_ms": splat_rows["make_pair"]["device_ms"],
            "library_device_ms": splat_rows["make_pair"]["library_device_ms"],
            "device_bound_share": splat_rows["make_pair"].get("device_bound_share"),
            "constant_image": {k: splat_rows["constant"][k] for k in keys}}


# K2's line beside its event time: its device time and the library call's,
# the share of the bound, the share of blocks that staged their box
K2_EXTRAS = ("device_ms", "library_device_ms", "bound_share", "staged_share")


def _copy_extras(name: str, probe_rows: dict) -> dict:
    """A redesigned copy's line beside its probe-size time: its device time
    and the library call's, and the same at its device-bound size."""
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "write_only_ms", "bound_ms")
    return {"device_ms": probe_rows[name]["device_ms"],
            "library_device_ms": probe_rows[name]["library_device_ms"],
            "device_bound_size": {k: probe_rows[f"{name}_big"][k] for k in keys}}


KDE_NAMES = ("kde_sum", "kde_dot")
KDE_EXTRAS = ("device_ms", "binned_device_ms", "device_bound_share", "fp32_bound_ms",
              "sfu_bound_ms", "bytes_bound_ms", "dense_bound_ms", "terms_needed", "terms_dense",
              "flip")


def _mark(label: str) -> None:
    """The seconds since the script started, after ``label``'s phases."""
    print(f"[elapsed] {label}: {time.perf_counter() - T_START:.1f} s", flush=True)


T_START = time.perf_counter()


def main() -> None:
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_k2())
    errs.update(phase_k3())
    errs.update(phase_k2b())
    probe_inputs, splat_inputs = _probe_inputs(), _splat_inputs()
    probe_errs, probe_launches = phase_probes(probe_inputs, splat_inputs)
    errs.update(probe_errs)
    kde_inputs = _kde_inputs()
    errs.update(phase_kde(kde_inputs))
    _mark("build and kernel checks")
    launches = phase_main_path()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [launches, phase_cli(tmp)]
    reg_launches, reg_err = phase_register()
    paths.append(reg_launches)
    errs["warp_flow"] = max(errs["warp_flow"], reg_err)
    fn_launches, fn_runs = phase_cascade_fn()
    _mark("main, cli, register, cascade-fn")
    paths += [phase_unet(), fn_launches]
    _mark("unet")
    paths += [*phase_cohort()]
    _mark("cohort")
    paths.append(phase_cohort_unet())
    _mark("cohort-unet")
    paths += phase_mesh()
    _mark("mesh")
    default_launches, default_runs = phase_cascade_fn_default()
    paths += [default_launches, phase_cascade_fn_exact(), phase_cascade_batch_default()]
    phase_adam()
    paths += [phase_register_unet(), phase_register_default(), phase_engines_default(),
              probe_launches]
    lm_errs, lm_paths, _ = phase_lm(splat_inputs)
    errs.update(lm_errs)
    paths += [*lm_paths, phase_lm_default()]
    _mark("the other paths")
    # the batched factories' graphs and pools go before the timings (the
    # single factories stay: [busy] replays them)
    cascade_mod._BATCH_CACHE.clear()
    torch.cuda.empty_cache()
    # before the profiler first runs (after that each launch costs the host more)
    phase_launch_path(probe_inputs)
    mode_rows = phase_mode_times()
    k2_times = phase_k2_times()
    k3_row = phase_k3_times()["8->8 edge 118"]
    k3_pair_row = phase_k3_pair_times()[f"{COHORT_UNET_B}x 8->8 edge 118"]
    k2b_row = phase_k2b_times()
    probe_rows = phase_probe_times(probe_inputs)
    splat_rows = phase_splat_times(splat_inputs)
    pair_rows = phase_pair_times()
    lm_rows = phase_lm_times(splat_inputs)
    kde_rows = phase_kde_times(kde_inputs)
    _mark("times")
    slab_rows, slab_errs, slab_paths = phase_mesh_space(smi)
    errs.update(slab_errs)
    paths += slab_paths
    _mark("mesh space axis")
    total = {name: sum(p.get(name, 0) for p in paths) for name in REPLACES}
    library = {name: k2_times[name]["library_ms"] for name in ("warp_affine", "warp_flow")}
    # per-launch times at the fine flow level's shape (240³, K=8, f32): its
    # flow form, with the dense launch and every form's row beside it
    flow_row = next(r for r in mode_rows if r["mode"] == "flow")
    modes = {f"{r['mode']} {r['S']}^3 K={r['K']} {r['dtype']}": r for r in mode_rows}
    times = {"sweep_fwd": {"ms": flow_row["fwd_ms"], "plain_ms": flow_row["plain_fwd_ms"]},
             "sweep_bwd": {"ms": flow_row["bwd_ms"], "plain_ms": flow_row["plain_bwd_ms"]},
             **{name: {k: k2_times[name][k] for k in ("ms", "plain_ms")}
                for name in ("warp_affine", "warp_flow")},
             "conv3d_fwd": {"ms": k3_row["fwd_ms"], "plain_ms": k3_row["plain_fwd_ms"]},
             "conv3d_dgrad": {"ms": k3_row["dgrad_ms"], "plain_ms": k3_row["plain_dgrad_ms"]},
             "conv3d_wgrad": {"ms": k3_row["dw_ms"], "plain_ms": k3_row["wgrad_plain_ms"]},
             "roigather": k2b_row,
             **{name: probe_rows[name] for name in (*hg.KERNELS, "roi_fetch")},
             "splat": splat_rows["make_pair"],
             **{name: {k: pair_rows[name][k] for k in ("ms", "plain_ms")}
                for name in pair_rows},
             **{name: {k: lm_rows[name][k] for k in ("ms", "plain_ms")} for name in lm_rows},
             **{name: {k: kde_rows[name][k] for k in ("ms", "plain_ms")} for name in KDE_NAMES},
             **{name: {k: r[k] for k in ("ms", "plain_ms")} for name, r in k3_pair_row.items()},
             **{name: {k: r[k] for k in ("ms", "plain_ms")} for name, r in slab_rows.items()}}
    # bytes: each input read once, each output written once; operations:
    # ~6 per output of a sweep (two taps and their weights), ~10 per voxel
    # of its adjoint, ~60 per voxel of a trilinear warp (pw_bound)
    bounds = {**{name: {"bound_ms": flow_row[f"{kind}_bound_ms"],
                        "bound_by": flow_row[f"{kind}_bound_by"]}
                 for name, kind in (("sweep_fwd", "fwd"), ("sweep_bwd", "bwd"))},
              **{name: pw_bound(name) for name in ("warp_affine", "warp_flow")},
              **{name: {k: k3_row[k] for k in ("bound_ms", "bound_by", "fma_bound_ms")}
                 for name in ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad")},
              "roigather": {k: k2b_row[k] for k in ("bound_ms", "bound_by")},
              **{name: {k: probe_rows[name][k] for k in ("bound_ms", "bound_by")}
                 for name in (*hg.KERNELS, "roi_fetch")},
              "splat": {k: splat_rows["make_pair"][k] for k in ("bound_ms", "bound_by")},
              **{name: {k: pair_rows[name][k] for k in ("bound_ms", "bound_by")}
                 for name in pair_rows},
              **{name: {k: lm_rows[name][k] for k in ("bound_ms", "bound_by")}
                 for name in lm_rows},
              **{name: {k: kde_rows[name][k] for k in ("bound_ms", "bound_by")}
                 for name in KDE_NAMES},
              **{name: {k: r[k] for k in ("bound_ms", "bound_by", "fma_bound_ms")}
                 for name, r in k3_pair_row.items()},
              **{name: {k: r[k] for k in ("bound_ms", "bound_by")}
                 for name, r in slab_rows.items()}}
    library.update(sweep_fwd=None, sweep_bwd=None, conv3d_fwd=k3_row["plain_fwd_ms"],
                   conv3d_dgrad=k3_row["plain_dgrad_ms"], conv3d_wgrad=k3_row["plain_dw_ms"],
                   roigather=k2b_row["library_ms"],
                   **{name: probe_rows[name]["library_ms"] for name in (*hg.KERNELS, "roi_fetch")},
                   splat=splat_rows["make_pair"]["library_ms"], sweep_fwd_pairs=None,
                   sweep_bwd_pairs=None, sweep_bwd2=None,
                   splat_signed=lm_rows["splat_signed"]["library_ms"], kde_sum=None,
                   kde_dot=None,
                   **{name: r["library_ms"] for name, r in k3_pair_row.items()},
                   sweep_fwd_slab=None, sweep_bwd_slab=None, sweep_fwd_slab_flow=None,
                   sweep_bwd_slab_flow=None, sweep_bwd2_slab=None,
                   **{name: slab_rows[name]["library_ms"]
                      for name in ("warp_affine_slab", "warp_flow_slab")})
    timed_at = {"sweep_fwd": "one flow-form launch, 240^3 K=8 f32, smooth field, mean of "
                             "axes 0-2; dense_ms: the dense launch on the same q",
                "warp_affine": "one launch, 240^3 f32, selftest rigid theta",
                "warp_flow": "one launch, 240^3 f32, smooth field |flow|<=8",
                "conv3d_fwd": "one launch, 8->8 at 118^3 f32; plain: cuDNN, TF32 off",
                "conv3d_wgrad": "one launch, 8->8 at 118^3 f32; plain: 27 f32 matmuls; "
                                "library: cuDNN conv3d_weight, TF32 off",
                "roigather": "one launch, 240^3 f32, make_pair's rigid windows, T=13824",
                "block_permute_add": "one launch, P1: [16, 256] f32, order [1, 0]",
                "slab_gather": "one launch, P2: 6 slabs (14, 16, 256) of [64, 64, 256]; "
                               "device_bound_size: 1728 slabs of [240, 240, 256]",
                "slab_sum": "one launch, P3: 13826 slabs (14, 16, 256) of [240, 240, 256]",
                "slice_transpose": "one launch, P5: 4 tiles of a [32, 32, 256] slab; "
                                   "device_bound_size: 4096 tiles of [240, 240, 256]",
                "roi_fetch": "one launch, 240^3 padded to 256^3, the probe's theta, T=13825",
                "splat": "one launch, the default NMI's 8 x 1M samples of make_pair's moving "
                         "image at 240^3 (resized to 200^3); library: one scatter_add of both "
                         "terms; constant_image: one bin takes every sample"}
    timed_at["sweep_bwd"] = timed_at["sweep_fwd"]
    timed_at["sweep_fwd_pairs"] = timed_at["sweep_bwd_pairs"] = (
        "one launch for 8 pairs, 240^3 K=8 f32, a table per pair, mean of the 3 passes; "
        "singles_ms: the 8 single-table launches it replaces; plain: the plain version with "
        "a row per pair (backward: to the image and the rows)")
    timed_at["conv3d_dgrad"] = timed_at["conv3d_fwd"]
    timed_at["sweep_bwd2"] = ("one launch, 240^3 K=8 f32, one table, mean of the 3 passes "
                              "(per_pass_ms); shapes: the same at each shape the LM paths "
                              "launch it, with device_ms from torch.profiler; plain: "
                              "sweep_bwd2_plain; library: none, no PyTorch call computes "
                              "K1's second order")
    for name in KDE_NAMES:
        timed_at[name] = (f"one launch on the default NMI's joint rows at {SIZE}^3 x "
                          f"{KDE_SCALE:g} ([8, 2M] x 256, bandwidth 3); flip: the same at x "
                          f"{KDE_FLIP:g}, a joint range just past the exact branch's 767.25; "
                          "bound: the terms within the kernels' cut (|u| <= 14), "
                          "dense_bound_ms over every term; library: none, no PyTorch call "
                          "sums Gaussians of pairwise differences")
    for name in k3_pair_row:
        timed_at[name] = (f"one launch for {COHORT_UNET_B} pairs, 8->8 at 118^3 f32, a "
                          "weight set per pair; singles_ms: the single-pair launches it "
                          "replaces; plain: a plain call a pair; library: one grouped cuDNN "
                          "call (groups = pairs), TF32 off")
    timed_at["sweep_fwd_slab"] = timed_at["sweep_bwd_slab"] = (
        f"the {MESH_SLABS} slab launches of a pass, make_pair's moving image at {SIZE}^3 on "
        f"{MESH_SLABS} z-slabs, K={MESH_K} f32, make_pair's rigid transform, mean of the 3 "
        "passes (the z pass reads each slab's buffer with a halo of K+1 rows a side); "
        "unsharded_ms: the one unsharded affine launch of the pass; plain: the plain slab "
        "pass on each slab (backward: dsrc from the halo and the row); bound: each slab's "
        "buffer, halo included, read once; library: none, no PyTorch call resamples at "
        "coordinates of this form")
    timed_at["sweep_fwd_slab_flow"] = timed_at["sweep_bwd_slab_flow"] = (
        f"the {MESH_SLABS} slab launches of the pass along the split axis (the flow form's "
        f"slab mode), make_flow_truth_pair's moving image and true field at {SIZE}^3 on "
        f"{MESH_SLABS} z-slabs, K={MESH_FLOW_K} f32 (each slab's buffer with a halo of K+1 "
        "rows a side; backward: the halos of g and of the field's channel); unsharded_ms: "
        "the one unsharded flow launch of that pass; plain: the plain slab pass on each "
        "slab; bound: each slab's buffers read once; library: none, no PyTorch call "
        "resamples at coordinates of this form")
    timed_at["sweep_bwd2_slab"] = (
        f"the {MESH_SLABS} slab launches of sweep_slab_bwd2, {SIZE}^3 on {MESH_SLABS} "
        f"z-slabs, K={MESH_BWD2_K} f32, a rigid table, mean of the 3 passes (the z pass with "
        "the halos of g, src and ubar); unsharded_ms: the one unsharded sweep_bwd2 launch; "
        "plain: sweep_bwd2_slab_plain on each slab; library: none, no PyTorch call computes "
        "K1's second order")
    timed_at["warp_affine_slab"] = timed_at["warp_flow_slab"] = (
        f"the {MESH_SLABS} slab launches of K2's slab mode at {SIZE}^3 on {MESH_SLABS} z-slabs "
        "f32 (affine: make_pair's true theta; flow: make_flow_truth_pair's true field), each "
        "on the buffer of the source rows its block reaches (fetch_and_launch_ms: the "
        "fetch and the launches through ops/blocked.py; fetched_bytes: the rows copied from "
        "other slabs); unsharded_ms: the one unsharded launch; plain: warp_plain_slab on each "
        "slab; bound: each buffer (and field) read once, each output written once; library: "
        "one F.grid_sample on the whole volume with its grid made beforehand")
    timed_at["splat_signed"] = ("one launch, the default NMI's 8 x 1M samples of make_pair's "
                                "moving image at 240^3, weights f - 0.5; library: one "
                                "scatter_add of both terms")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"], **bounds[name], "library_ms": library[name],
         "timed_at": timed_at[name],
         **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
         **({"note": NOTES[name]} if name in NOTES else {}),
         **(_sweep_extras(name, flow_row, modes, errs["sweep_row_grad_rel"])
            if name in ("sweep_fwd", "sweep_bwd") else {}),
         **({"singles_ms": pair_rows[name]["singles_ms"]} if name in pair_rows else {}),
         **({"singles_ms": k3_pair_row[name]["singles_ms"]} if name in k3_pair_row else {}),
         **({"row_grad_max_rel_err": errs["sweep_pairs_row_grad_rel"]}
            if name == "sweep_bwd_pairs" else {}),
         **({k: slab_rows[name][k] for k in slab_rows[name]
             if k in ("unsharded_ms", "unsharded_bound_ms", "halo_ms", "device_ms",
                     "unsharded_device_ms", "fetch_and_launch_ms", "fetched_bytes")}
            if name in slab_rows else {}),
         **({"row_grad_max_rel_err": errs["sweep_slab_row_grad_rel"]}
            if name == "sweep_bwd_slab" else {}),
         **({"row_grad_max_rel_err": errs["sweep_slab_bwd2_row_grad_rel"]}
            if name == "sweep_bwd2_slab" else {}),
         **(_copy_extras(name, probe_rows) if name in COPIES else {}),
         **({k: probe_rows[name].get(k) for k in SUM_EXTRAS}
            if name in ("slab_sum", "roi_fetch") else {}),
         **({k: probe_rows[name].get(k) for k in P1_EXTRAS}
            if name == "block_permute_add" else {}),
         **(_splat_extras(splat_rows) if name == "splat" else {}),
         **({k: lm_rows[name][k] for k in ("per_pass_ms", "device_ms", "shapes")}
            if name == "sweep_bwd2" else {}),
         **({k: lm_rows[name].get(k) for k in ("device_ms", "device_bound_share")}
            if name == "splat_signed" else {}),
         **({k: k2_times[name][k] for k in K2_EXTRAS} if name in k2_times else {}),
         **({k: kde_rows[name].get(k) for k in KDE_EXTRAS} if name in KDE_NAMES else {})}
        for name in REPLACES
    ]
    phase_busy(fn_runs + default_runs)
    _mark("busy")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
