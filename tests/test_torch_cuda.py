"""K1, K2, K3, K2b, the probe kernels and the slices on the GPU: the kernels
against their plain versions, the port's cascades (field and U-Net flow) and
criteria on the card against the same calls on the CPU, ``Register``'s
default device, the U-Net cascade's repeat to the bit and both probe modules'
``main``.

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


# ------------------------------------------------------------------ determinism


def test_torch_cuda_sweep_backward_repeats_to_the_bit(dev):
    """K1's dsrc sums many outputs into each source voxel (coordinates
    bunched on a few positions); its fixed-order adjoint gives the same bits
    on every run, along each axis, f32 and bf16."""
    for dim in (2, 3, 4):
        for dtype in (torch.float32, torch.bfloat16):
            src, q = _case(dev, (1, 1, 30, 33, 35), dim, 6, dtype, dim)
            q = torch.floor(q / 3.0) * 3.0 + 0.37  # many outputs share each tap
            g = torch.randn(src.shape, generator=torch.Generator(device=dev).manual_seed(dim),
                            device=dev).to(dtype)
            runs = [k1.sweep_bwd(g, src, q, dim, 6) for _ in range(3)]
            for dsrc, dq in runs[1:]:
                assert torch.equal(dsrc, runs[0][0]) and torch.equal(dq, runs[0][1])


def test_torch_cuda_nearest_resize_backward_repeats_to_the_bit(dev):
    """The attention gates' nearest upsampling: its backward sums each
    source's run of outputs in a fixed order (``index_select``'s own
    backward adds with atomics), the same bits on every run and within
    rounding of ``index_select``'s gradient."""
    from torchregister_tpu_torch.ops.resize import axis_nearest_resize

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 26, 27, 25), generator=gen, device=dev)
    g = torch.randn((2, 26, 80, 25), generator=gen, device=dev)
    grads = []
    for _ in range(3):
        xs = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(axis_nearest_resize(xs, 2, 80), xs, g)[0])
    assert all(torch.equal(gr, grads[0]) for gr in grads[1:])
    xs = x.clone().requires_grad_(True)
    idx = (torch.arange(80, device=dev) * 27) // 80
    ref = torch.autograd.grad(torch.index_select(xs, 2, idx), xs, g)[0]
    torch.testing.assert_close(grads[0], ref, rtol=0, atol=1e-6)


def test_torch_cuda_unet_cascade_repeats_to_the_bit(dev):
    """A reduced U-Net cascade (48³, every stage, U-Net flow at two levels)
    twice from one seed: the same executed steps, flow and quality fields
    to the bit."""
    from torchregister_tpu_torch.engines.cascade import register_cascade
    from torchregister_tpu_torch.synthetic import (RECIPE_UNET, flow_truth_metrics,
                                                   make_flow_truth_pair)

    pair = [a.to(dev) for a in make_flow_truth_pair((48, 48, 48), max_disp=3.0)]
    recipe = {**RECIPE_UNET, "rigid_epochs": 40, "affine_epochs": 20, "flow_epochs": 40}
    runs = []
    for _ in range(2):
        res = register_cascade(pair[0], pair[1], **recipe)
        runs.append((res.steps, res.flow, flow_truth_metrics(res, *pair)))
    (steps0, flow0, q0), (steps1, flow1, q1) = runs
    assert steps0 == steps1 and q0 == q1
    assert torch.equal(flow0, flow1)


def test_torch_cuda_unet_deterministic_mode(dev, monkeypatch):
    """The reduced U-Net cascade under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the one op
    torch flags as lacking a deterministic implementation is max pooling's
    backward. It adds each output's gradient to its window's argmax with an
    atomic, but the U-Net pools 2x2x2 windows at stride 2, which do not
    overlap, so every input receives at most one addend and the sum has no
    order. (The mode does not see the port's own kernels; the cascade's
    repeat to the bit is the test above.)"""
    import warnings

    from torchregister_tpu_torch.engines.cascade import register_cascade
    from torchregister_tpu_torch.synthetic import RECIPE_UNET, make_flow_truth_pair

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    pair = [a.to(dev) for a in make_flow_truth_pair((48, 48, 48), max_disp=3.0)]
    recipe = {**RECIPE_UNET, "rigid_epochs": 10, "affine_epochs": 10, "flow_epochs": 10}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            register_cascade(pair[0], pair[1], **recipe)
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
    assert flagged == ["max_pool3d_with_indices_backward_cuda"]


# ------------------------------------------------------------------ probes


def _probe_case(dev, name):
    """(kernel, plain, inputs with index data checked on the card, atol) at
    the probe's own sizes (P3 and the fetch reduced to 80 and 96 voxels a
    side), with slabs at the last valid origin."""
    import numpy as np

    from torchregister_tpu_torch.probes import checked_index
    from torchregister_tpu_torch.probes import hatgather as hg
    from torchregister_tpu_torch.probes import roi_stages as rs

    gen = torch.Generator(device=dev).manual_seed(len(name))
    if name == "block_permute_add":
        x = torch.rand((16, 256), generator=gen, device=dev)
        order = checked_index([1, 0, 1], (0,), (1,), "order", dev)[:, 0]
        return hg.block_permute_add_launch, hg.block_permute_add_plain, (x, order), 0.0
    if name in ("slab_gather", "slab_gather_16", "slab_sum"):
        size = 80 if name == "slab_sum" else 64
        B = (14, 16) if name != "slab_gather_16" else (16, 16)
        vol = torch.rand((size, size, 256), generator=gen, device=dev)
        orgs = np.concatenate([hg.p3_origins(size, 40, *B),
                               [[size - B[0], size - B[1]], [0, 0]]]).astype(np.int32)
        orgs = checked_index(orgs, (0, 1), (size - B[0], size - B[1]), "orgs", dev)
        if name == "slab_sum":
            return hg.slab_sum_launch, hg.slab_sum_plain, (vol, orgs, *B), hg.P3_ATOL
        return hg.slab_gather_launch, hg.slab_gather_plain, (vol, orgs, *B), 0.0
    if name == "slice_transpose":
        slab = torch.rand((32, 32, 256), generator=gen, device=dev)
        starts = checked_index([[0, 0, 3], [9, 13, 224], [18, 16, 0], [18, 16, 240]],
                               (0, 1, 2), (18, 16, 240), "starts", dev)
        return (hg.slice_transpose_launch, hg.slice_transpose_plain,
                (slab, starts, 14, 16, 16, 256), 0.0)
    _, _, scal, volp = rs.stage_inputs(96, dev)
    return rs.roi_fetch_launch, rs.roi_fetch_plain, (volp, rs.check_scalars(volp, scal)), \
        rs.FETCH_ATOL


@pytest.mark.parametrize("name", ["block_permute_add", "slab_gather", "slab_gather_16",
                                  "slab_sum", "slice_transpose", "roi_fetch"])
def test_torch_cuda_probe_kernel_matches_plain(dev, name):
    """Each probe kernel against its plain version: the copies (P1, P2, P4,
    P5) to the bit, the sums (P3, fetch) at their stated atol."""
    launch, plain, args, atol = _probe_case(dev, name)
    out, ref = launch(*args), plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_torch_cuda_probe_mains_run(dev, capsys):
    """Both probe modules' ``main`` on the card; every new kernel launched."""
    from torchregister_tpu_torch.probes import hatgather as hg
    from torchregister_tpu_torch.probes import roi_stages as rs

    hg.reset_counts()
    rs.reset_counts()
    hg.main(["p1", "p2", "p3", "p4", "p5"])
    rs.main()
    assert min(hg.launches.values()) > 0 and rs.launches > 0
    out = capsys.readouterr().out
    assert out.count("OK") == 6 and "fetch only" in out


def test_torch_cuda_probe_origins_out_of_range_raise(dev):
    from torchregister_tpu_torch.probes import hatgather as hg
    from torchregister_tpu_torch.probes import roi_stages as rs

    vol = torch.rand((64, 64, 256), device=dev)
    with pytest.raises(ValueError, match="leaves"):
        hg.slab_gather(vol, [[64 - 13, 0]], 14, 16)
    with pytest.raises(ValueError, match="leaves"):
        hg.slab_sum(vol, [[0, -1]], 14, 16)
    with pytest.raises(ValueError, match="leaves"):
        hg.block_permute_add(torch.rand((16, 256), device=dev), [2, 0])
    with pytest.raises(ValueError, match="leaves"):
        hg.slice_transpose(vol[:32, :32], [[0, 0, 241]])
    with pytest.raises(ValueError, match="leaves"):
        rs.roi_fetch(torch.rand((64, 64, 128), device=dev), [[6, 0, 0, 0, 0]])
    with pytest.raises(ValueError, match="host data"):
        hg.slab_gather(vol, torch.zeros((1, 2), dtype=torch.int32, device=dev), 14, 16)
