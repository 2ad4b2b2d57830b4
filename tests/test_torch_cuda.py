"""K1, K2, K3, K2b and the slices on the GPU: the kernels against their plain
versions, the port's cascades (field and U-Net flow) and criteria on the card
against the same calls on the CPU, and ``Register``'s default device.

Marked ``cuda``; each test skips without a CUDA device. The machine with the
card has no JAX, so run this file without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import pytest
import torch

from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.cuda import warp as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, shape, dim, K, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn(shape, generator=gen, device=dev).to(dtype)
    view = [1] * len(shape)
    view[dim] = shape[dim]
    iota = torch.arange(shape[dim], dtype=torch.float32, device=dev).view(view)
    q = iota + (K + 2.0) * (2.0 * torch.rand(shape, generator=gen, device=dev) - 1.0)
    return src, q


@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("K", [3, 11])
def test_torch_cuda_sweep_matches_plain(dev, dim, K):
    """Forward values and diff: f32 exact up to FMA contraction (1e-5);
    backward rtol 1e-5 of the largest gradient (summation order)."""
    shape = (2, 1, 17, 19, 23)
    src, q = _case(dev, shape, dim, K, torch.float32, dim * 10 + K)
    out, diff = k1.sweep_fwd(src, q, dim, K, with_diff=True)
    ref, ref_diff = k1.sweep_plain(src, q, dim, K, with_diff=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(diff, ref_diff, rtol=0, atol=1e-5)
    g = torch.randn_like(src)
    s, qq = src.clone().requires_grad_(True), q.clone().requires_grad_(True)
    ref_s, ref_q = torch.autograd.grad(k1.sweep_plain(s, qq, dim, K)[0], (s, qq), g)
    dsrc, dq = k1.sweep_bwd(g, src, q, dim, K)
    torch.testing.assert_close(dsrc, ref_s, rtol=0, atol=1e-5 * float(ref_s.abs().max()))
    torch.testing.assert_close(dq, ref_q, rtol=0, atol=1e-5 * float(ref_q.abs().max()))


def test_torch_cuda_sweep_bf16_and_broadcast_q(dev):
    """bf16 images, q broadcast over the batch, through the autograd
    Function: one bf16 rounding (2^-8 relative) against the plain version
    forward; dsrc (bf16) and dq (f32, summed back to q's shape) within
    2^-7 of the largest reference gradient (both sum in f32, the bf16
    gradient flowing in is rounded once more on its way out)."""
    shape = (3, 1, 16, 18, 20)
    src, q0 = _case(dev, shape, 4, 6, torch.bfloat16, 7)
    q0 = q0[:1]
    grads, outs = [], []
    for fn in (k1.sweep, lambda s, q, d, K: k1.sweep_plain(s, q, d, K)[0]):
        q = q0.clone().requires_grad_(True)
        s = src.clone().requires_grad_(True)
        k1.reset_counts()
        out = fn(s, q, 4, 6)
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append((s.grad, q.grad))
        if fn is k1.sweep:
            assert (k1.fwd_launches, k1.bwd_launches) == (1, 1)
    assert outs[0].dtype == torch.bfloat16 and grads[0][1].shape == q0.shape
    torch.testing.assert_close(outs[0].float(), outs[1].float(), rtol=2**-8, atol=1e-6)
    for got, ref in zip(grads[0], grads[1]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=2**-7 * float(ref.float().abs().max()))


def test_torch_cuda_sweep_rejects_bad_inputs(dev):
    src, q = _case(dev, (1, 1, 8, 8, 8), 4, 2, torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        k1.sweep_fwd(src.transpose(2, 4), q.transpose(2, 4), 4, 2)
    with pytest.raises(ValueError, match="same CUDA device"):
        k1.sweep_fwd(src, q.cpu(), 4, 2)


def test_torch_cuda_cascade_matches_cpu(dev):
    """The reduced recipe at 24³ on the card (K1) and on the CPU (plain
    version): the same rules, so the same executed steps within 4 per stage
    and the same quality within 2 points (Adam amplifies rounding
    differences in flat regions of the field)."""
    from torchregister_tpu_torch.engines.cascade import register_cascade
    from torchregister_tpu_torch.synthetic import RECIPE, make_pair, rmse_reduction_pct

    recipe = {**RECIPE, "rigid_epochs": 60, "affine_epochs": 30, "flow_epochs": 60,
              "levels": 2, "matrix_levels": 2, "flow_levels": 2, "flow_smooth": (0.5, 0.25)}
    mov, tgt = make_pair((24, 24, 24))
    cpu = register_cascade(mov, tgt, **recipe)
    k1.reset_counts()
    gpu = register_cascade(mov.to(dev), tgt.to(dev), **recipe)
    assert k1.fwd_launches > 0 and k1.bwd_launches > 0
    assert gpu.warped.is_cuda and gpu.flow.is_cuda
    for stage in ("rigid", "affine", "flow"):
        assert abs(sum(gpu.steps[stage]) - sum(cpu.steps[stage])) <= 4
    assert abs(rmse_reduction_pct(gpu.warped.cpu(), mov, tgt)
               - rmse_reduction_pct(cpu.warped, mov, tgt)) <= 2.0


# ------------------------------------------------------------------ K2


def _k2_case(dev, C, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn((C,) + shape, generator=gen, device=dev)
    return src, gen


@pytest.mark.parametrize("shape", [(17, 19, 23), (1, 31, 26)], ids=["3d", "one_plane"])
def test_torch_cuda_warp_affine_matches_plain(dev, shape):
    """The kernel runs the plain version's f32 operations in the same order
    (no FMA contraction): equal to the bit, padding and all."""
    src, gen = _k2_case(dev, 3, shape, 1)
    M = torch.eye(3, device=dev) + 0.3 * torch.randn((3, 3), generator=gen, device=dev)
    t = 4.0 * torch.randn((3,), generator=gen, device=dev)
    mt = k2.pack_affine(M, t)
    k2.reset_counts()
    out = k2.warp_affine_launch(src, mt)
    assert (k2.affine_launches, k2.flow_launches) == (1, 0)
    torch.testing.assert_close(out, k2.warp_plain(src, mt=mt), rtol=0, atol=0)


def test_torch_cuda_warp_flow_matches_plain(dev):
    src, gen = _k2_case(dev, 2, (18, 20, 22), 2)
    flow = 12.0 * torch.randn((3, 18, 20, 22), generator=gen, device=dev)
    k2.reset_counts()
    out = k2.warp_flow_launch(src, flow)
    assert (k2.affine_launches, k2.flow_launches) == (0, 1)
    torch.testing.assert_close(out, k2.warp_plain(src, flow=flow), rtol=0, atol=0)


def test_torch_cuda_exact_warps_match_cpu(dev):
    """``warp_affine_fast`` / ``warp_flow_fast`` (2D and 3D, batch folded)
    on the card against the same calls on the CPU."""
    from torchregister_tpu_torch.ops.blocked import warp_affine_fast, warp_flow_fast
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    gen = torch.Generator().manual_seed(3)
    for spatial, params in (((20, 21, 22), [0.2, -0.1, 0.15, 0.05, -0.03, 0.08]),
                            ((30, 27), [0.3, 0.1, -0.2])):
        mov = torch.randn((2, 2) + spatial, generator=gen)
        theta = rigid_theta(torch.tensor(params))[None]
        flow = 3.0 * torch.randn((2, len(spatial)) + spatial, generator=gen)
        for fn, args in ((warp_affine_fast, (theta, mov)), (warp_flow_fast, (mov, flow))):
            got = fn(*(a.to(dev) for a in args))
            assert got.is_cuda
            torch.testing.assert_close(got.cpu(), fn(*args), rtol=0, atol=1e-5)


def test_torch_cuda_warp_rejects_bad_inputs(dev):
    src, _ = _k2_case(dev, 1, (8, 8, 8), 4)
    mt = k2.pack_affine(torch.eye(3, device=dev), torch.zeros(3, device=dev))
    with pytest.raises(TypeError):
        k2.warp(src.half(), mt=mt)
    with pytest.raises(ValueError, match="contiguous"):
        k2.warp_affine_launch(src.transpose(1, 3), mt)
    with pytest.raises(ValueError, match="same CUDA device"):
        k2.warp_affine_launch(src, mt.cpu())


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("ci,co,shape", [(1, 8, (9, 12, 13)), (8, 8, (7, 10, 40)),
                                         (16, 32, (5, 27, 35)), (32, 16, (6, 19, 8)),
                                         (3, 11, (4, 70, 33)), (1, 9, (12, 30, 35))])
@pytest.mark.parametrize("N", [1, 2])
def test_torch_cuda_conv3d_matches_plain(dev, ci, co, shape, N):
    """K3 forward (raw launch) and the Function's dx (K3) and dw against the
    plain version and autograd through it, cuDNN with TF32 off: f32 sums in
    another order, 1e-5 of the largest value. Co = 11 and the Sobel filter's
    Co = 9 leave a ragged output-channel chunk; the shapes leave ragged
    tiles in y and x."""
    torch.backends.cudnn.allow_tf32 = False
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    gen = torch.Generator(device=dev).manual_seed(ci * co + N)
    x = torch.randn((N, ci) + shape, generator=gen, device=dev)
    w = torch.randn((3, 3, 3, ci, co), generator=gen, device=dev) / (27 * ci) ** 0.5
    g = torch.randn((N, co) + tuple(s - 2 for s in shape), generator=gen, device=dev)
    k3.reset_counts()
    out = k3.conv_launch(x, w)
    assert (k3.fwd_launches, k3.dgrad_launches) == (1, 0)
    ref = k3.conv3x3x3_plain(x, w)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    grads = []
    for fn in (k3.conv3x3x3, k3.conv3x3x3_plain):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xs, ws), (xs, ws), g))
    assert k3.dgrad_launches == 1
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_torch_cuda_conv3d_bf16_and_bad_inputs(dev):
    """bf16 in and out, summed in f32 and rounded once: one bf16 rounding
    (2^-7 of the largest value) from the plain version. The launcher refuses
    other dtypes, strided input and mixed devices."""
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((1, 8, 6, 20, 37), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, 3, 8, 8), generator=gen, device=dev) / 15).to(torch.bfloat16)
    out, ref = k3.conv_launch(x, w), k3.conv3x3x3_plain(x, w)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=2.0**-7 * float(ref.float().abs().max()))
    with pytest.raises(TypeError):
        k3.conv_launch(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        k3.conv_launch(x.float().transpose(3, 4), w.float())
    with pytest.raises(ValueError, match="same CUDA device"):
        k3.conv_launch(x, w.cpu())


def test_torch_cuda_unet_cascade_runs_k3(dev):
    """The U-Net flow stage on the card at 48³ launches K3 forward and dgrad
    and ends finite, with quality near the same run on the CPU (Adam's
    trajectories part in rounding: 3 points)."""
    from torchregister_tpu_torch.engines.cascade import register_cascade
    from torchregister_tpu_torch.ops.cuda import conv3d as k3
    from torchregister_tpu_torch.synthetic import (RECIPE_UNET, flow_truth_metrics,
                                                   make_flow_truth_pair)

    pair = make_flow_truth_pair((48, 48, 48), max_disp=3.0, rigid=(0.0,) * 6)
    recipe = {**RECIPE_UNET, "stages": ("flow",), "flow_epochs": 60, "flow_lr": 0.01}
    cpu = register_cascade(pair[0], pair[1], **recipe)
    k3.reset_counts()
    gpu = register_cascade(pair[0].to(dev), pair[1].to(dev), **recipe)
    assert k3.fwd_launches > 0 and k3.dgrad_launches > 0
    assert gpu.flow.is_cuda and bool(torch.isfinite(gpu.warped).all())
    q_gpu = flow_truth_metrics(gpu, *(a.to(dev) for a in pair))
    q_cpu = flow_truth_metrics(cpu, *pair)
    assert abs(q_gpu[0] - q_cpu[0]) <= 3.0, (q_gpu, q_cpu)


@pytest.mark.parametrize("shape", [(1, 1, 40, 37, 45), (2, 3, 12, 20, 17), (2, 1, 30, 41)])
def test_torch_cuda_edge_filter_matches_cpu(dev, shape):
    """The Sobel filter on the card (K3, 1 -> 9 channels) against the CPU:
    the magnitude at rtol 1e-5, the mask equal away from the thresholds."""
    from torchregister_tpu_torch.ops.cuda import conv3d as k3
    from torchregister_tpu_torch.ops.edge import edge_filter, edge_magnitude
    from torchregister_tpu_torch.synthetic import make_pair

    if len(shape) == 5 and shape[:2] == (1, 1):
        x = make_pair(shape[2:])[0]
    else:
        x = torch.rand(shape, generator=torch.Generator().manual_seed(sum(shape)))
    k3.reset_counts()
    mag = edge_magnitude(x.to(dev))
    assert k3.fwd_launches == 1
    ref = edge_magnitude(x)
    torch.testing.assert_close(mag.cpu(), ref, rtol=1e-5, atol=1e-6)
    away = ((ref - 0.2).abs() > 1e-5) & ((ref - 0.9).abs() > 1e-5)
    mask = edge_filter(x.to(dev))
    assert mask.is_cuda
    assert torch.equal(mask.cpu()[away], edge_filter(x)[away])


# ------------------------------------------------------------------ K2b


@pytest.mark.parametrize("shape", [(45, 50, 41), (33, 40, 37), (56, 48, 44)])
def test_torch_cuda_roigather_matches_plain(dev, shape):
    """K2b is a copy: equal to its plain version to the bit, on the windows
    of a rigid transform and on windows past every face (zeros there)."""
    import numpy as np

    from torchregister_tpu_torch.ops import blocked
    from torchregister_tpu_torch.ops.cuda import roigather as k2b
    from torchregister_tpu_torch.ops.transforms import rigid_theta_np

    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    vol = torch.randn(shape, generator=gen, device=dev)
    theta = rigid_theta_np(np.array([0.2, -0.1, 0.15, 0.05, -0.03, 0.08]))
    scal = torch.from_numpy(blocked._roi_supports(theta, shape, False)[0]).to(dev)
    wild = torch.randint(-3, 8, (300, 5), generator=gen, device=dev, dtype=torch.int32)
    k2b.reset_counts()
    for sc in (scal, wild):
        torch.testing.assert_close(k2b.roigather_launch(vol, sc), k2b.roigather_plain(vol, sc),
                                   rtol=0, atol=0)
    assert k2b.launches == 2


def test_torch_cuda_roigather_rejects_bad_inputs(dev):
    from torchregister_tpu_torch.ops.cuda import roigather as k2b

    vol = torch.rand((20, 20, 20), device=dev)
    scal = torch.zeros((4, 5), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        k2b.roigather(vol.to(torch.bfloat16), scal)
    with pytest.raises(TypeError):
        k2b.roigather(vol, scal.long())
    with pytest.raises(ValueError, match="same CUDA device"):
        k2b.roigather_launch(vol, scal.cpu())


@pytest.mark.parametrize("shape,align", [((48, 48, 48), False), ((45, 50, 41), True)])
def test_torch_cuda_compact_route_matches_k2(dev, shape, align, monkeypatch):
    """``warp_affine_roi``'s compact route (K2b and the hat einsums) against
    K2 on a smooth pair, 1e-5 of the largest value: the hats sum the same
    corners in another order from an index map rounded once from float64;
    ``warp_affine_fast`` takes the route when it is enabled and runs K2b,
    and with ``ROIGATHER_FUSED`` (the fused form, K2) it runs K2 alone."""
    from torchregister_tpu_torch.ops import blocked
    from torchregister_tpu_torch.ops.cuda import roigather as k2b
    from torchregister_tpu_torch.ops.transforms import rigid_theta
    from torchregister_tpu_torch.synthetic import make_pair

    moving = make_pair(shape, device=dev)[0]
    theta = rigid_theta(torch.tensor([0.2, -0.1, 0.15, 0.05, -0.03, 0.08], device=dev))[None]
    ref = blocked.warp_affine_fast(theta, moving, align)
    monkeypatch.setattr(blocked, "ROIGATHER_ENABLED", True)
    k2b.reset_counts()
    torch.testing.assert_close(blocked.warp_affine_fast(theta, moving, align), ref,
                               rtol=0, atol=0)
    assert k2b.launches == 0
    monkeypatch.setattr(blocked, "ROIGATHER_FUSED", False)
    out = blocked.warp_affine_fast(theta, moving, align)
    assert k2b.launches == 1 and out.is_cuda
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


# ------------------------------------------------------------------ criteria, API


def test_torch_cuda_nmi_loss_matches_cpu(dev):
    """``nmi_loss`` (binned path, scatter-add splat) on the card against the
    CPU: value within 3e-5 and gradient within 3e-4 of its largest entry. The
    loss is 1000 |NMI - 1|, a difference of near-equal f32 numbers, and the
    card's atomics sum the histogram in another order (the CPU tests hold
    the CPU path to the JAX package at the same tolerances)."""
    from torchregister_tpu_torch.losses.nmi import nmi_loss

    gen = torch.Generator().manual_seed(3)
    y = torch.rand((1, 1, 24, 20, 22), generator=gen)
    yp = 0.7 * y + 0.3 * torch.rand(y.shape, generator=gen)
    out = []
    for d in ("cpu", dev):
        p = yp.to(d).clone().requires_grad_(True)
        loss = nmi_loss(y.to(d), p, patch_size=8, bandwidth=0.05)
        loss.backward()
        out.append((float(loss), p.grad.cpu()))
    (lc, gc), (lg, gg) = out
    assert lg == pytest.approx(lc, rel=3e-5)
    torch.testing.assert_close(gg, gc, rtol=0, atol=3e-4 * float(gc.abs().max()))


def test_torch_cuda_register_default_device_is_cuda(dev):
    """``Register()`` with ``device=None`` runs on the card: numpy input
    lands there, and so do the transform and the warped image."""
    import numpy as np

    from torchregister_tpu_torch import Register
    from torchregister_tpu_torch.synthetic import make_pair

    mov, tgt = (a.numpy() for a in make_pair((24, 24, 24)))
    reg = Register(mode="rigid", criterion=["mse"], init="identity", optimizer="adam")
    assert reg.device.type == "cuda"
    reg.optim(mov, tgt, lr=1e-2, max_epochs=5)
    assert reg.theta.is_cuda and reg(np.asarray(mov)).is_cuda
