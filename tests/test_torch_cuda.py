"""K1, K2, K3, K2b, the probe kernels and the slices on the GPU: the kernels
against their plain versions, the port's cascades (field and U-Net flow) and
criteria on the card against the same calls on the CPU, ``Register``'s
default device, the U-Net cascade's repeat to the bit, cohorts (each pair
of ``make_cascade_batch_fn`` and ``register_cohort`` equal to its single run
to the bit, K1's table per pair against single-table launches), both probe
modules' ``main``, the one launch path (a launch under a side stream, a tensor on
another device than the current one), and the fixed-order kernels: the
two-stage sums (P3, the ROI fetch) and the NMI splat, each equal to its
order in torch ops to the bit; the LM engines' second order: K1's
``sweep_bwd2`` and the splat's signed mode against their plain versions,
a Hessian through the kernels against the CPU's, the kernel Functions that
are differentiable once raising on a second derivative, and LM's cascade
factory and cohort against single runs to the bit; K3 with a weight set per
pair (each pair against a single-pair launch to the bit) and the U-Net
cohort against single runs.

Marked ``cuda``; each test skips without a CUDA device. The machine with the
card has no JAX, so run this file without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import pytest
import torch

from torchregister_tpu_torch.models.attention_unet import conv3x3x3_shapes
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


# ------------------------------------------------------------- K1's modes
# The affine and flow forms compute each pass's coordinates in the kernel.
# On the coordinates the parent built (``_axis_coord_grid``; ``flow[:, a] +
# ident``) and handed to the dense launch they give the same bits: forward,
# dsrc (both add each source's terms in ascending x) and du. The affine
# table's gradient is reduced in another order: rel 1e-5 of its largest
# entry against autograd through the plain version.


def _modes_case(dev, N, C, spatial, K, dtype, seed):
    from torchregister_tpu_torch.ops.separable import affine_to_index_map, factor_passes
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn((N, C) + spatial, generator=gen, device=dev).to(dtype)
    g = torch.randn(src.shape, generator=gen, device=dev).to(dtype)
    d = len(spatial)
    params = (0.2, -0.15, 0.1, 0.15, -0.1, 0.05) if d == 3 else (0.2, 0.1, -0.05)
    theta = rigid_theta(torch.tensor(params, device=dev))
    passes = factor_passes(*affine_to_index_map(theta, spatial))
    table = torch.stack([torch.cat([c, o.reshape(1)]) for _, (c, o) in passes]).contiguous()
    flow = (K + 2.0) * (2.0 * torch.rand((N, d) + spatial, generator=gen, device=dev) - 1.0)
    return src, g, [a for a, _ in passes], table, flow


def _parent_q(src, table, flow, p, axis):
    """The dense coordinates the parent built for pass ``p`` (affine) and
    for the flow pass along ``axis``, expanded to src's shape."""
    spatial = tuple(src.shape[2:])
    d = len(spatial)
    qa = k1._axis_coord_grid(table[p, :d], table[p, d], spatial)
    ident = torch.arange(spatial[axis], dtype=torch.float32, device=src.device)
    ident = ident.view(tuple(spatial[axis] if i == axis else 1 for i in range(d)))
    qf = flow[:, axis][:, None] + ident
    return (qa.expand(src.shape).contiguous(), qf.expand(src.shape).contiguous())


def _check_modes_against_dense(dev, N, C, K, dtype, seed):
    spatial = (17, 19, 23)
    src, g, axes, table, flow = _modes_case(dev, N, C, spatial, K, dtype, seed)
    for p, axis in enumerate(axes):
        qa, qf = _parent_q(src, table, flow, p, axis)
        dim = 2 + axis
        # affine: forward and dsrc to the bit, the row's gradient to 1e-5
        assert torch.equal(k1.affine_fwd(src, table, p, axis, K), k1.sweep_fwd(src, qa, dim, K)[0])
        dsrc, drow = k1.affine_bwd(g, src, table, p, axis, K)
        ref_s, _ = k1.sweep_bwd(g, src, qa, dim, K)
        assert torch.equal(dsrc, ref_s)
        row = table[p].clone().requires_grad_(True)
        out = k1.sweep_affine_plain(src, row[:3], row[3], axis, K)
        ref_row, = torch.autograd.grad(out, row, g)
        torch.testing.assert_close(drow, ref_row, rtol=0,
                                   atol=1e-5 * float(ref_row.abs().max()))
        # flow: forward, dsrc and du to the bit
        assert torch.equal(k1.flow_fwd(src, flow, axis, K), k1.sweep_fwd(src, qf, dim, K)[0])
        dsrc, du = k1.flow_bwd(g, src, flow, axis, K)
        ref_s, ref_q = k1.sweep_bwd(g, src, qf, dim, K)
        assert torch.equal(dsrc, ref_s)
        assert torch.equal(du, ref_q.sum(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [3, 11, 80])
@pytest.mark.parametrize("C", [1, 3])
def test_torch_cuda_sweep_modes_match_dense_launch(dev, dtype, K, C):
    _check_modes_against_dense(dev, 2, C, K, dtype, 10 * K + C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [3, 11, 80])
def test_torch_cuda_sweep_modes_one_image(dev, dtype, K):
    """N = C = 1, as every engine warp: the flow form's one-image kernel,
    whose field and du are indexed like the image."""
    _check_modes_against_dense(dev, 1, 1, K, dtype, 10 * K + 7)


def _dsrc_in_ascending_x(g, q, dim, K):
    """dsrc of the sweep, summed on the host in float32 in the kernel's
    fixed order: for each source index, its terms in ascending x (an x's
    floor tap and its ceil tap never reach the same index)."""
    import numpy as np

    gm = np.moveaxis(g.float().cpu().numpy(), dim, -1)
    qm = np.moveaxis(q.cpu().numpy(), dim, -1)
    X = qm.shape[-1]
    g2, q2 = gm.reshape(-1, X), qm.reshape(-1, X)
    q0 = np.floor(q2)
    fr = q2 - q0
    k = q0 - np.arange(X, dtype=np.float32)
    mf = (k >= -K) & (k <= K + 1) & (q0 >= 0) & (q0 < X)
    mc = (k >= -K - 1) & (k <= K) & (q0 + 1 >= 0) & (q0 + 1 < X)
    wf, wc = g2 * (np.float32(1.0) - fr), g2 * fr
    acc = np.zeros_like(g2)
    rows = np.arange(g2.shape[0])
    for x in range(X):
        f = q0[:, x].astype(np.int64)
        for m, tap, w in ((mf[:, x], f, wf[:, x]), (mc[:, x], f + 1, wc[:, x])):
            acc[rows[m], tap[m]] += w[m]
    return torch.from_numpy(np.moveaxis(acc.reshape(gm.shape), -1, dim).copy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("folded", [False, True], ids=["monotone", "folded"])
@pytest.mark.parametrize("K", [3, 11, 80])
def test_torch_cuda_sweep_bwd_dsrc_in_fixed_order(dev, dtype, folded, K):
    """The dense backward's dsrc equals the host's ascending-x float32 sum to
    the bit, on coordinates whose floor index never decreases along the
    axis (the gather) and on coordinates drawn per voxel (folds: the ordered
    scatter), with axes long enough for several chunks."""
    gen = torch.Generator(device=dev).manual_seed(100 * K + folded)
    for shape, dim in (((1, 2, 150, 5, 7), 2), ((2, 1, 5, 7, 150), 4)):
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        src = torch.randn(shape, generator=gen, device=dev).to(dtype)
        view = [1] * 5
        view[dim] = shape[dim]
        x = torch.arange(shape[dim], dtype=torch.float32, device=dev).view(view)
        u = (K + 2.0) * (2.0 * torch.rand(shape, generator=gen, device=dev) - 1.0)
        if not folded:  # slope 0.7 along the axis, an offset per column
            u = -0.3 * x + u.narrow(dim, 0, 1)
        q = (x + u).contiguous()
        dsrc, _ = k1.sweep_bwd(g, src, q, dim, K)
        ref = _dsrc_in_ascending_x(g, q, dim, K).to(dtype)
        assert torch.equal(dsrc.cpu(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_cuda_sweep_modes_2d_and_full_windows(dev, dtype):
    """2-D images (the view's z of 1) and windows as wide as the axis (the
    degenerate route of required_windows) against the dense launch."""
    for spatial, K in (((31, 26), 11), ((40, 37), 40), ((9, 10, 11), 240)):
        src, g, axes, table, flow = _modes_case(dev, 2, 3, spatial, K, dtype, K)
        d = len(spatial)
        for p, axis in enumerate(axes):
            qa, qf = _parent_q(src, table, flow, p, axis)
            assert torch.equal(k1.affine_fwd(src, table, p, axis, K),
                               k1.sweep_fwd(src, qa, 2 + axis, K)[0])
            assert torch.equal(k1.affine_bwd(g, src, table, p, axis, K)[0],
                               k1.sweep_bwd(g, src, qa, 2 + axis, K)[0])
            assert torch.equal(k1.flow_fwd(src, flow, axis, K),
                               k1.sweep_fwd(src, qf, 2 + axis, K)[0])
            dsrc, du = k1.flow_bwd(g, src, flow, axis, K)
            ref_s, ref_q = k1.sweep_bwd(g, src, qf, 2 + axis, K)
            assert torch.equal(dsrc, ref_s) and torch.equal(du, ref_q.sum(1))
            row = table[p].clone().requires_grad_(True)
            ref_row, = torch.autograd.grad(
                k1.sweep_affine_plain(src, row[:d], row[d], axis, K), row, g)
            drow = k1.affine_bwd(g, src, table, p, axis, K)[1]
            torch.testing.assert_close(drow, ref_row, rtol=0,
                                       atol=1e-5 * float(ref_row.abs().max()))


def _pair_tables(dev, N, spatial, seed):
    """One table [d, d+1] per item: the affine passes of N different rigid
    transforms, ``[N, d, d+1]``."""
    from torchregister_tpu_torch.ops.separable import affine_to_index_map, factor_passes
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    gen = torch.Generator().manual_seed(seed)
    d = len(spatial)
    params = 0.3 * (2.0 * torch.rand((N, 6 if d == 3 else 3), generator=gen) - 1.0)
    theta = rigid_theta(params.to(dev))
    passes = factor_passes(*affine_to_index_map(theta, spatial))
    table = torch.stack([torch.cat([c, o[:, None]], dim=1) for _, (c, o) in passes], dim=1)
    return table.contiguous(), [a for a, _ in passes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,C,spatial", [(3, 1, (17, 19, 23)), (2, 2, (5, 7, 9)),
                                         (4, 1, (31, 26)), (5, 1, (9, 10, 40))])
def test_torch_cuda_sweep_affine_table_per_item_equals_single_launches(dev, dtype, N, C,
                                                                        spatial):
    """K1's affine form with a table per item: each item's output, dsrc and
    row gradient equal, to the bit, a launch with its table alone on that
    item alone (rows that span two items in the forward's tiles at 5 x 7 x
    9)."""
    K = 6
    gen = torch.Generator(device=dev).manual_seed(N * 10 + C)
    src = torch.randn((N, C) + spatial, generator=gen, device=dev).to(dtype)
    g = torch.randn(src.shape, generator=gen, device=dev).to(dtype)
    table, axes = _pair_tables(dev, N, spatial, N + C)
    for p, axis in enumerate(axes):
        out = k1.affine_fwd(src, table, p, axis, K)
        dsrc, drow = k1.affine_bwd(g, src, table, p, axis, K)
        assert drow.shape == (N, len(spatial) + 1)
        for n in range(N):
            one = table[n].contiguous()
            assert torch.equal(out[n:n + 1], k1.affine_fwd(src[n:n + 1], one, p, axis, K))
            ref_s, ref_row = k1.affine_bwd(g[n:n + 1], src[n:n + 1], one, p, axis, K)
            assert torch.equal(dsrc[n:n + 1], ref_s)
            assert torch.equal(drow[n], ref_row)


def test_torch_cuda_separable_warp_table_per_item(dev):
    """The whole warp over a table per item (``_SeparableAffine``, d
    launches each way): each item's output, dsrc and table gradient equal
    those of its own warp to the bit, and the plain per-item passes on the
    CPU within 1e-5."""
    N, spatial, K = 3, (20, 18, 22), 8
    gen = torch.Generator(device=dev).manual_seed(5)
    src = torch.randn((N, 1) + spatial, generator=gen, device=dev)
    g = torch.randn(src.shape, generator=gen, device=dev)
    table, axes = _pair_tables(dev, N, spatial, 7)
    windows = (K,) * len(axes)

    def run(s, t, gs):
        s, t = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
        out = k1._SeparableAffine.apply(s, t, tuple(axes), windows)
        return (out, *torch.autograd.grad(out, (s, t), gs))

    out, dsrc, dtable = run(src, table, g)
    for n in range(N):
        ref = run(src[n:n + 1], table[n].contiguous(), g[n:n + 1])
        assert torch.equal(out[n:n + 1], ref[0]) and torch.equal(dsrc[n:n + 1], ref[1])
        assert torch.equal(dtable[n], ref[2])
    passes = [(a, (table[:, p, :3].cpu(), table[:, p, 3].cpu())) for p, a in enumerate(axes)]
    plain = k1.sweep_affine_passes(src.cpu(), passes, windows)
    torch.testing.assert_close(out.cpu(), plain, rtol=0, atol=1e-5)


def test_torch_cuda_sweep_modes_repeat_to_the_bit(dev):
    """Every output of every mode's launches, three runs: the same bits
    (coordinates bunched so many outputs share each tap)."""
    for dtype in (torch.float32, torch.bfloat16):
        src, g, axes, table, _ = _modes_case(dev, 1, 2, (30, 33, 35), 6, dtype, 3)
        flow = torch.floor(3.0 * torch.rand((1, 3, 30, 33, 35), device=dev)) - 1.37
        for p, axis in enumerate(axes):
            runs = [(k1.affine_fwd(src, table, p, axis, 6),
                     *k1.affine_bwd(g, src, table, p, axis, 6),
                     k1.flow_fwd(src, flow, axis, 6),
                     *k1.flow_bwd(g, src, flow, axis, 6)) for _ in range(3)]
            for run in runs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


@pytest.mark.parametrize("spatial", [(12, 13, 14), (21, 18)], ids=["3d", "2d"])
def test_torch_cuda_separable_warps_launch_d_passes(dev, spatial):
    """``_warp_affine_separable`` with theta requiring grad and
    ``warp_flow_separable`` with the field requiring grad: d forward and d
    backward launches each, all of their own mode, none dense; values and
    gradients against the per-pass plain versions (the CPU's route) on the
    same tensors (f32: 1e-5 of the largest value, theta's and the field's
    gradients 1e-4)."""
    from torchregister_tpu_torch.ops.separable import (_warp_affine_separable,
                                                       warp_flow_separable)
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    d = len(spatial)
    src, g, _, _, flow = _modes_case(dev, 1, 1, spatial, 4, torch.float32, 5)
    params = (0.2, -0.15, 0.1, 0.15, -0.1, 0.05) if d == 3 else (0.2, 0.1, -0.05)
    theta = rigid_theta(torch.tensor(params, device=dev))[None]
    for name, warp, param in (
            ("affine", lambda s, th: _warp_affine_separable(th, s, max_shift=6), theta),
            ("flow", lambda s, f: warp_flow_separable(s, f, max_disp=4), flow)):
        grads, outs = [], []
        for cuda_path in (True, False):
            s = src.clone().requires_grad_(True)
            pr = param.clone().requires_grad_(True)
            k1.reset_counts()
            if cuda_path:
                out = warp(s, pr)
                grads.append(torch.autograd.grad(out, (s, pr), g))
                assert k1.fwd_modes == {**{m: 0 for m in k1.fwd_modes}, name: d}
                assert k1.bwd_modes == {**{m: 0 for m in k1.bwd_modes}, name: d}
                assert (k1.fwd_launches, k1.bwd_launches) == (d, d)
            else:  # the plain passes: the same warp on CPU copies
                out = warp(s.cpu(), pr.cpu())
                grads.append(torch.autograd.grad(out, (s, pr), g.cpu()))
                out = out.to(dev)
            outs.append(out.detach())
        torch.testing.assert_close(outs[0], outs[1], rtol=0,
                                   atol=1e-5 * float(outs[1].abs().max()))
        for got, ref, tol in zip(grads[0], grads[1], (1e-5, 1e-4)):
            torch.testing.assert_close(got, ref, rtol=0, atol=tol * float(ref.abs().max()))


def test_torch_cuda_sweep_modes_reject_bad_inputs(dev):
    src = torch.zeros((1, 1, 8, 9, 10), device=dev)
    table = torch.zeros((3, 4), device=dev)
    flow = torch.zeros((1, 3, 8, 9, 10), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k1.affine_fwd(src.transpose(2, 4), table, 0, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.flow_fwd(src, torch.zeros((1, 3, 10, 9, 8), device=dev).transpose(2, 4), 0, 2)
    with pytest.raises(ValueError, match="same CUDA device"):
        k1.flow_fwd(src, flow.cpu(), 0, 2)
    with pytest.raises(ValueError, match="table"):
        k1.affine_fwd(src, table[:2], 0, 2, 2)


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


def _rigid_mt(dev, params, spatial):
    from torchregister_tpu_torch.warp_cases import index_map
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    return index_map(rigid_theta(torch.tensor(params, device=dev))[None], spatial)


def _tile_case(dev, case):
    """``(src [C, Z, Y, X], mt, flow, route)``: the kernel's view of a case,
    and the route its blocks must take (``staged``: every block, ``direct``:
    none)."""
    from torchregister_tpu_torch.warp_cases import SELFTEST_THETA, index_map, rot90_zoom2

    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, case)))

    def vol(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def shift_flow(spatial, noise=0.5):  # a steady shift plus noise: small boxes
        base = torch.tensor([1.3, -2.7, 0.6], device=dev).view(3, 1, 1, 1)
        return (base + noise * (2 * torch.rand((3,) + spatial, generator=gen, device=dev)
                                - 1)).contiguous()

    def zoom(spatial, by):  # 0.15 * (o - centre): samples past every face
        o = [torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2 for n in spatial]
        return (by * torch.stack(torch.meshgrid(*o, indexing="ij"))).contiguous()

    cube = (48, 48, 48)
    if case == "affine_staged":
        return vol(1, *cube), _rigid_mt(dev, SELFTEST_THETA, cube), None, "staged"
    if case == "affine_direct":  # 90° about z, zoom 2: boxes of 32³
        return vol(1, *cube), index_map(rot90_zoom2().to(dev), cube), None, "direct"
    if case == "affine_far":  # every coordinate past 2^13: direct
        mt = k2.pack_affine(torch.eye(3, device=dev), torch.tensor([0.0, 2e4, 0.0], device=dev))
        return vol(1, *cube), mt, None, "direct"
    if case == "affine_far_staged":  # boxes just inside -2^13, x 3 floats past 16 bytes
        mt = k2.pack_affine(torch.eye(3, device=dev),
                            torch.tensor([-8150.3, 0.7, 3.6], device=dev))
        return vol(1, *cube), mt, None, "staged"
    if case == "flow_smooth":  # the flow mode takes the direct route everywhere
        return vol(1, *cube), None, shift_flow(cube), "direct"
    if case == "flow_tears":
        return vol(1, *cube), None, 12.0 * vol(3, *cube), "direct"
    if case == "ragged_50x47x44":
        spatial = (50, 47, 44)
        return vol(1, *spatial), _rigid_mt(dev, SELFTEST_THETA, spatial), None, "staged"
    if case == "one_plane":  # Z == 1: 1 x 8 x 32 tiles, ragged, direct
        return vol(2, 1, 45, 37), _rigid_mt(dev, (0.3, 0.1, -0.2), (45, 37)), None, "direct"
    if case == "x_not_multiple_of_4":
        spatial = (35, 35, 35)
        return vol(1, *spatial), _rigid_mt(dev, SELFTEST_THETA, spatial), None, "staged"
    if case == "src_4_bytes_off_16":
        buf = torch.randn(1 + 32**3, generator=gen, device=dev)
        src = buf[1:].view(1, 32, 32, 32)
        assert src.data_ptr() % 16 == 4 and src.is_contiguous()
        return src, _rigid_mt(dev, SELFTEST_THETA, (32, 32, 32)), None, "staged"
    if case == "c3":
        spatial = (40, 40, 40)
        return vol(3, *spatial), _rigid_mt(dev, SELFTEST_THETA, spatial), None, "staged"
    if case == "affine_past_every_face":  # a zoom out by 1.15
        theta = torch.cat([1.15 * torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)],
                          1)[None]
        return vol(1, *cube), index_map(theta, cube), None, "staged"
    if case == "flow_past_every_face":
        return vol(1, *cube), None, (zoom(cube, 0.15) + shift_flow(cube, 0.2)).contiguous(), \
            "direct"
    if case == "flow_nan_and_1e30":
        flow = shift_flow(cube)
        flow[0, 5, 6, 7], flow[2, 40, 20, 30] = float("nan"), 1e30
        return vol(1, *cube), None, flow, "direct"
    raise KeyError(case)


TILE_CASES = ("affine_staged", "affine_direct", "affine_far", "affine_far_staged",
              "flow_smooth", "flow_tears",
              "ragged_50x47x44", "one_plane", "x_not_multiple_of_4", "src_4_bytes_off_16", "c3",
              "affine_past_every_face", "flow_past_every_face", "flow_nan_and_1e30")


@pytest.mark.parametrize("case", TILE_CASES)
def test_torch_cuda_warp_tiles_match_plain_on_their_route(dev, case):
    """Each case equals ``warp_plain`` to the bit (NaN where it has NaN),
    and the kernel's count of staged blocks equals ``tile_boxes``'s and
    shows the route the case is there for."""
    src, mt, flow, route = _tile_case(dev, case)
    k2.reset_counts()
    out = k2.warp_affine_launch(src, mt) if flow is None else k2.warp_flow_launch(src, flow)
    ref = k2.warp_plain(src, mt=mt, flow=flow)
    boxes = k2.tile_boxes(src.shape, mt=mt, flow=flow)
    staged, tiles = k2.staged_blocks(), k2.tiles_launched
    assert tiles == boxes["staged"].numel()
    assert staged == int(boxes["staged"].sum())
    assert {"staged": staged == tiles, "direct": staged == 0}[route], (staged, tiles)
    nan = torch.isnan(out)
    assert torch.equal(nan, torch.isnan(ref))
    assert torch.equal(out.view(torch.int32)[~nan], ref.view(torch.int32)[~nan])


def test_torch_cuda_warp_follows_the_current_stream(dev):
    """K2 under ``torch.cuda.stream(s)`` launches on ``s``: it reads a
    volume that ``s`` rewrites after a long sleep."""
    src, mt, _, _ = _tile_case(dev, "affine_staged")
    new = torch.randn_like(src)
    want = k2.warp_plain(new, mt=mt)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    torch.cuda.current_stream().synchronize()
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        src.copy_(new)
        out = k2.warp_affine_launch(src, mt)
        done = torch.cuda.Event()
        done.record(s)
    assert not done.query()
    s.synchronize()
    assert done.query() and torch.equal(out, want)


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("ci,co,shape", [(1, 8, (9, 12, 13)), (8, 8, (7, 10, 40)),
                                         (16, 32, (5, 27, 35)), (32, 16, (6, 19, 8)),
                                         (3, 11, (4, 70, 33)), (1, 9, (12, 30, 35))])
@pytest.mark.parametrize("N", [1, 2])
def test_torch_cuda_conv3d_matches_plain(dev, ci, co, shape, N):
    """K3 forward (raw launch) and the Function's dx (K3 with padding 2) and
    dw (the weight-gradient kernel) against the plain version and autograd
    through it, cuDNN with TF32 off: f32 sums in another order, 1e-5 of the
    largest value. Co = 11 and the Sobel filter's Co = 9 pad the MMA's N with
    zeros; the shapes leave ragged tiles in y and x."""
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
    assert (k3.dgrad_launches, k3.wgrad_launches) == (1, 1)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_torch_cuda_conv3d_bf16_and_bad_inputs(dev):
    """bf16 in and out, summed in f32 and rounded once: one bf16 rounding
    (2^-7 of the largest value) from the plain version, with bf16 weights and
    with f32 ones. The launcher refuses other dtypes, strided input and mixed
    devices."""
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((1, 8, 6, 20, 37), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, 3, 8, 8), generator=gen, device=dev) / 15).to(torch.bfloat16)
    out, ref = k3.conv_launch(x, w), k3.conv3x3x3_plain(x, w)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=2.0**-7 * float(ref.float().abs().max()))
    # f32 weights with bf16 x: the f32 path on x widened, rounded once
    w32 = w.float() * 1.001
    out, ref = k3.conv_launch(x, w32), k3.conv3x3x3_plain(x, w32)
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
    """The U-Net flow stage on the card at 48³ launches K3 forward, dgrad and
    the weight gradient and ends finite, with quality near the same run on the CPU (Adam's
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
    assert k3.fwd_launches > 0 and k3.dgrad_launches > 0 and k3.wgrad_launches > 0
    assert gpu.flow.is_cuda and bool(torch.isfinite(gpu.warped).all())
    q_gpu = flow_truth_metrics(gpu, *(a.to(dev) for a in pair))
    q_cpu = flow_truth_metrics(cpu, *pair)
    assert abs(q_gpu[0] - q_cpu[0]) <= 3.0, (q_gpu, q_cpu)


# every convolution of the U-Net cascade's 120³ level (n=8, depth 2) and of
# Register's 240³ network (n=32, depth 4, on z-slabs of 10 planes), as
# chip_smoke.py's K3_CASES: (Ci, Co, edge, z)
UNET_K3 = ([(ci, co, e, e) for ci, co, e in conv3x3x3_shapes(120, 8, 2)]
           + [(ci, co, e, 10) for ci, co, e in conv3x3x3_shapes(240, 32, 4)])


def _k3_case(dev, ci, co, edge, z, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, ci, z, edge, edge), generator=gen, device=dev).to(dtype)
    w = (torch.randn((3, 3, 3, ci, co), generator=gen, device=dev) / (27 * ci) ** 0.5).to(dtype)
    g = torch.randn((1, co, z - 2, edge - 2, edge - 2), generator=gen, device=dev).to(dtype)
    return x, w, g, w.flip((0, 1, 2)).transpose(3, 4)


def _close(got, want, rel):
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * float(want.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co,edge,z", UNET_K3,
                         ids=[f"{ci}-{co}-e{e}-z{z}" for ci, co, e, z in UNET_K3])
def test_torch_cuda_conv3d_kernels_match_plain_at_unet_shapes(dev, ci, co, edge, z, dtype):
    """K3's three launches at every U-Net convolution against their plain
    versions (cuDNN with TF32 off; 27 f32 matmuls): the forward and the input
    gradient (padding 2 on the cotangent) at 1e-5 of the largest value in
    f32 (sums in another order), one bf16 rounding (2^-7) in bf16 (both sum
    in f32 and round once); the weight gradient, f32 out of exact bf16
    products too, at 1e-5."""
    torch.backends.cudnn.allow_tf32 = False
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    x, w, g, w_t = _k3_case(dev, ci, co, edge, z, dtype, ci * co + edge)
    rel = 1e-5 if dtype == torch.float32 else 2.0**-7
    out = k3.conv_launch(x, w)
    assert out.dtype == dtype
    _close(out, k3.conv3x3x3_plain(x, w), rel)
    dx = k3.conv_launch(g, w_t, pad=2)
    assert dx.dtype == dtype and dx.shape == x.shape
    _close(dx, k3.conv3x3x3_plain(g, w_t, pad=2), rel)
    dw = k3.wgrad_launch(x, g)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    _close(dw, k3.wgrad_plain(x, g), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co,edge,z", [(1, 9, 44, 12), (8, 8, 40, 40), (32, 16, 30, 30)])
def test_torch_cuda_conv3d_kernels_repeat_to_the_bit(dev, ci, co, edge, z, dtype):
    """Each of K3's launches, three times on the same inputs: the same bits
    (no float atomics; partial sums combined in a fixed order)."""
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    x, w, g, w_t = _k3_case(dev, ci, co, edge, z, dtype, 7 * ci + co)
    for fn in (lambda: k3.conv_launch(x, w), lambda: k3.conv_launch(g, w_t, pad=2),
               lambda: k3.wgrad_launch(x, g)):
        runs = [fn() for _ in range(3)]
        assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_cuda_conv3d_dgrad_zero_halo_matches_padded_copy(dev, dtype):
    """The input gradient reads the cotangent's halo as zeros: bit for bit
    the valid convolution of the cotangent zero-padded by 2 (the copy the
    kernel no longer makes), ragged tiles included."""
    import torch.nn.functional as F

    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    for ci, co, edge, z in ((8, 16, 37, 9), (16, 8, 21, 21), (2, 1, 50, 6)):
        _, _, g, w_t = _k3_case(dev, ci, co, edge, z, dtype, ci + co)
        k3.reset_counts()
        dx = k3.conv_launch(g, w_t, pad=2)
        assert (k3.fwd_launches, k3.dgrad_launches) == (0, 1)
        assert torch.equal(dx, k3.conv_launch(F.pad(g, (2, 2) * 3).contiguous(), w_t))


def test_torch_cuda_conv3d_wgrad_rejects_bad_inputs(dev):
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    x = torch.randn((1, 2, 6, 7, 8), device=dev)
    g = torch.randn((1, 3, 4, 5, 6), device=dev)
    k3.reset_counts()
    with pytest.raises(ValueError, match="g \\[N, Co, Z-2, H-2, W-2\\]"):
        k3.wgrad_launch(x, g[..., 1:])
    with pytest.raises(TypeError):
        k3.wgrad_launch(x.half(), g.half())
    with pytest.raises(ValueError, match="contiguous g"):
        k3.wgrad_launch(x, g.transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError, match="x's dtype"):
        k3.wgrad_launch(x.to(torch.bfloat16), g)
    with pytest.raises(ValueError, match="same CUDA device"):
        k3.wgrad_launch(x, g.cpu())
    assert k3.wgrad_launches == 0


# (pairs, Ci, Co, edge, z): the U-Net cohort's first layer, a 120³-level
# layer, the bottleneck's widest and a decoder's, ragged tiles
K3_PAIRS = [(3, 1, 8, 30, 9), (2, 8, 8, 40, 12), (4, 16, 32, 20, 20), (2, 32, 16, 26, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,ci,co,edge,z", K3_PAIRS,
                         ids=[f"{b}x{ci}-{co}-e{e}" for b, ci, co, e, _ in K3_PAIRS])
def test_torch_cuda_conv3d_weight_set_per_pair(dev, B, ci, co, edge, z, dtype):
    """K3 with a weight set per pair, one launch each of the forward, the
    input gradient and the weight gradient: each pair equal to a launch on
    that pair alone to the bit, and against the plain versions (a call a
    pair) at the single launches' tolerances; counted as one launch each
    and as a per-pair launch."""
    torch.backends.cudnn.allow_tf32 = False
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    gen = torch.Generator(device=dev).manual_seed(B * 100 + ci + co)
    x = torch.randn((B, ci, z, edge, edge), generator=gen, device=dev).to(dtype)
    w = (torch.randn((B, 3, 3, 3, ci, co), generator=gen, device=dev)
         / (27 * ci) ** 0.5).to(dtype)
    g = torch.randn((B, co, z - 2, edge - 2, edge - 2), generator=gen, device=dev).to(dtype)
    w_t = w.flip((1, 2, 3)).transpose(4, 5)
    k3.reset_counts()
    out, dx, dw = k3.conv_launch(x, w), k3.conv_launch(g, w_t, pad=2), k3.wgrad_launch(
        x, g, per_pair=True)
    assert (k3.fwd_launches, k3.dgrad_launches, k3.wgrad_launches) == (1, 1, 1)
    assert (k3.fwd_pairs_launches, k3.dgrad_pairs_launches, k3.wgrad_pairs_launches) == (
        1, 1, 1)
    assert dw.shape == w.shape and dw.dtype == torch.float32
    for b in range(B):
        one = slice(b, b + 1)
        assert torch.equal(out[one], k3.conv_launch(x[one], w[b]))
        assert torch.equal(dx[one], k3.conv_launch(g[one], w_t[b], pad=2))
        assert torch.equal(dw[b], k3.wgrad_launch(x[one], g[one]))
    rel = 1e-5 if dtype == torch.float32 else 2.0**-7
    _close(out, k3.conv3x3x3_plain(x, w), rel)
    _close(dx, k3.conv3x3x3_plain(g, w_t, pad=2), rel)
    _close(dw, k3.wgrad_plain(x, g, per_pair=True), 1e-5)
    # the autograd Function takes the per-pair weights through the same launches
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    fx, fw = torch.autograd.grad(k3.conv3x3x3(xs, ws), (xs, ws), g)
    assert torch.equal(fx, dx) and torch.equal(fw, dw.to(dtype))


def test_torch_cuda_unet_cohort_pairs_against_single_runs(dev):
    """The U-Net cohort on the card at 32³ (RECIPE_UNET reduced, flow stage
    at two levels): ``make_cascade_batch_fn`` on 2 pairs launches K3 with a
    weight set per pair and each pair stays within 2 steps a level and 0.5
    points of its own ``make_cascade_fn`` run; ``register_cohort`` U-Net
    mode each pair's flow and losses equal to ``flow_register`` on that pair
    with the same draws to the bit."""
    from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn, make_cascade_fn
    from torchregister_tpu_torch.engines.flow import flow_register
    from torchregister_tpu_torch.ops.cuda import conv3d as k3
    from torchregister_tpu_torch.parallel import register_cohort
    from torchregister_tpu_torch.synthetic import (RECIPE_UNET, flow_truth_metrics,
                                                   make_flow_truth_pair)

    recipe = {**RECIPE_UNET, "stages": ("flow",), "flow_epochs": 40, "flow_lr": 0.01}
    cases = [make_flow_truth_pair((32, 32, 32), seed=s, max_disp=3.0, rigid=(0.0,) * 6,
                                  device=dev) for s in (1, 2)]
    movings, targets = torch.cat([c[0] for c in cases]), torch.cat([c[1] for c in cases])
    k3.reset_counts()
    res = make_cascade_batch_fn(**recipe)(movings, targets)
    assert k3.fwd_pairs_launches > 0 and k3.dgrad_pairs_launches > 0
    assert k3.wgrad_pairs_launches > 0
    single = make_cascade_fn(**recipe)
    for b, case in enumerate(cases):
        want = single(case[0], case[1])
        for a, c in zip(res.steps["flow"][b], want.steps["flow"]):
            assert abs(a - c) <= 2, (b, res.steps, want.steps)
        mine = res._replace(warped=res.warped[b], flow=res.flow[b], theta=res.theta[b])
        q, q_ref = flow_truth_metrics(mine, *case), flow_truth_metrics(want, *case)
        assert abs(q[0] - q_ref[0]) <= 0.5, (b, q, q_ref)
    kw = dict(lr=1e-3, criterions=["mse"], n=32, depth=1, optimizer="sgd")
    cres = register_cohort(movings, targets, mode="flow", epochs=5, flow_model="unet",
                           smooth=0.0, seed=4, **kw)
    gen = torch.Generator().manual_seed(4)
    for b in range(2):
        _, solo = flow_register(movings[b:b + 1], targets[b:b + 1], max_epochs=5,
                                generator=gen, **kw)
        assert torch.equal(cres.flow[b], solo.flow) and torch.equal(cres.losses[b],
                                                                    solo.losses)


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
    """``nmi_loss`` (binned path, the splat kernel) on the card against the
    CPU: value within 3e-5 and gradient within 3e-4 of its largest entry. The
    loss is 1000 |NMI - 1|, a difference of near-equal f32 numbers, and the
    card's splat sums the histogram in another order (the CPU tests hold
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


COPY_CASES = {"p2": (64, 64, 256), "p4": (64, 64, 256), "slab_big": (240, 240, 256),
              "slab_unaligned": (64, 64, 256), "slab_x_not_4": (40, 36, 250),
              "p5": (32, 32, 256), "slice_big": (240, 240, 256),
              "slice_unaligned": (32, 32, 256), "slice_x_not_4": (32, 32, 250),
              "slice_L_not_4": (32, 32, 256), "slice_big_L_not_4": (240, 240, 256)}


def _copy_case(dev, case):
    """(kernel, plain, inputs) of a case of the redesigned probe copies: the
    probes' sizes, the device-bound sizes (P3's 240 x 240 x 256 volume), a
    volume whose data pointer is 4 bytes past a 16-byte boundary, an x
    extent that is not a multiple of 4, x starts at every residue mod 4 and
    ``lanes`` that is not a multiple of 4; each kernel's block shapes at
    both the few slabs or tiles of a probe and the many of the others."""
    import numpy as np

    from torchregister_tpu_torch.probes import checked_index
    from torchregister_tpu_torch.probes import hatgather as hg

    gen = torch.Generator(device=dev).manual_seed(len(case))
    Z, Y, X = COPY_CASES[case]
    if case.endswith("unaligned"):
        buf = torch.rand(Z * Y * X + 1, generator=gen, device=dev)
        vol = buf[1:].view(Z, Y, X)
        assert vol.is_contiguous() and vol.data_ptr() % 16 == 4
    else:
        vol = torch.rand((Z, Y, X), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    if case.startswith(("p2", "p4", "slab")):
        # the probes' few slabs (one element a thread) or many (four), plus 2
        n = {"p2": 4, "p4": 3, "slab_unaligned": 4}.get(case, 40)
        Bz, By = (16, 16) if case == "p4" else (14, 16)
        orgs = (hg.p3_origins(Z, 1728) if case == "slab_big" else
                np.stack([rng.integers(0, Z - Bz + 1, n), rng.integers(0, Y - By + 1, n)], -1))
        orgs = np.concatenate([orgs, [[Z - Bz, Y - By], [0, 0]]]).astype(np.int32)
        orgs = checked_index(orgs, (0, 1), (Z - Bz, Y - By), "orgs", dev)
        return hg.slab_gather_launch, hg.slab_gather_plain, (vol, orgs, Bz, By)
    Bz, By, CW = 14, 16, 16
    lanes = 230 if case.endswith("L_not_4") else 256
    # tiles: 4096 take 256-thread blocks, fewer than 264 take 1024-thread ones
    n = 4096 if case.startswith("slice_big") else 5 if case == "p5" else 64
    starts = np.stack([rng.integers(0, Z - Bz + 1, n), rng.integers(0, Y - By + 1, n),
                       rng.integers(0, X - CW + 1, n)], axis=-1)
    starts[:4, 2] = [1, 2, 3, 4]  # every residue of x mod 4
    starts[4] = [Z - Bz, Y - By, X - CW]
    starts = checked_index(starts, (0, 1, 2), (Z - Bz, Y - By, X - CW), "starts", dev)
    return hg.slice_transpose_launch, hg.slice_transpose_plain, (vol, starts, Bz, By, CW, lanes)


@pytest.mark.parametrize("case", list(COPY_CASES))
def test_torch_cuda_probe_copies_match_plain_to_the_bit(dev, case):
    """``slab_gather`` (float4 runs where X % 4 == 0 and both pointers are
    16-byte aligned, floats otherwise) and ``slice_transpose`` (float4 stores
    along r where lanes % 4 == 0) equal their plain versions to the bit."""
    launch, plain, args = _copy_case(dev, case)
    out, ref = launch(*args), plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref)


def test_torch_cuda_launch_follows_the_current_stream(dev):
    """A launch under ``torch.cuda.stream(s)`` goes to ``s``: it reads a
    volume that ``s`` rewrites after a long sleep, and only ``s`` is
    synchronised before the check (a launch on another stream would read
    the old volume)."""
    from torchregister_tpu_torch.probes import checked_index
    from torchregister_tpu_torch.probes import hatgather as hg

    vol = torch.rand((64, 64, 256), device=dev)
    new = torch.rand_like(vol)
    orgs = checked_index([[0, 0], [50, 48], [7, 9]], (0, 1), (50, 48), "orgs", dev)
    want = hg.slab_gather_plain(new, orgs, 14, 16)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    torch.cuda.current_stream().synchronize()
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        vol.copy_(new)
        out = hg.slab_gather_launch(vol, orgs, 14, 16)
        done = torch.cuda.Event()
        done.record(s)
    assert not done.query()  # still behind the sleep on s
    s.synchronize()
    assert done.query() and torch.equal(out, want)


def test_torch_cuda_launch_on_another_device(dev):
    """A tensor on another device than the current one launches on its own
    device, and the current device stays as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from torchregister_tpu_torch.probes import checked_index
    from torchregister_tpu_torch.probes import hatgather as hg

    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        vol = torch.rand((64, 64, 256), device=other)
        orgs = checked_index([[0, 0], [50, 48]], (0, 1), (50, 48), "orgs", other)
        out = hg.slab_gather_launch(vol, orgs, 14, 16)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    assert out.device == other and torch.equal(out, hg.slab_gather_plain(vol, orgs, 14, 16))


# ---------------------------------------------------- the two-stage sums, splat

# (kernel, volume shape, slabs or tiles, unaligned): P3 at X = 256 (float4)
# and X = 100 (floats), one slab, more values of oy than its sort takes, an
# unaligned volume; the fetch at one, two
# and three folds a lane, one tile, an unaligned volume
SUM_CASES = {"slab_sum_256": ("slab_sum", (60, 52, 256), 40, False),
             "slab_sum_unsorted": ("slab_sum", (20, 4120, 8), 40, False),
             "slab_sum_x100": ("slab_sum", (60, 52, 100), 40, False),
             "slab_sum_one": ("slab_sum", (30, 31, 256), 1, False),
             "slab_sum_unaligned": ("slab_sum", (30, 31, 256), 40, True),
             "fetch_128": ("roi_fetch", (61, 54, 128), 40, False),
             "fetch_256": ("roi_fetch", (61, 54, 256), 40, False),
             "fetch_384": ("roi_fetch", (61, 54, 384), 40, False),
             "fetch_one": ("roi_fetch", (48, 48, 256), 1, False),
             "fetch_unaligned": ("roi_fetch", (48, 48, 256), 40, True)}


def _sum_case(dev, case):
    """(launch, ordered, plain, args, atol): origins from ``default_rng`` with
    the last valid one (the last plane and row, the last block) put first,
    so the one-slab and one-tile cases take it."""
    import math

    import numpy as np

    from torchregister_tpu_torch.probes import checked_index
    from torchregister_tpu_torch.probes import hatgather as hg
    from torchregister_tpu_torch.probes import roi_stages as rs

    kernel, shape, n, unaligned = SUM_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    if unaligned:
        vol = torch.rand(math.prod(shape) + 1, generator=gen, device=dev)[1:].view(shape)
        assert vol.is_contiguous() and vol.data_ptr() % 16 == 4
    else:
        vol = torch.rand(shape, generator=gen, device=dev)
    rng = np.random.default_rng(n)
    if kernel == "slab_sum":
        Z, Y, _ = shape
        hi = (Z - 14, Y - 16)
        orgs = np.stack([rng.integers(0, hi[0] + 1, n), rng.integers(0, hi[1] + 1, n)], -1)
        orgs[0] = hi
        orgs = checked_index(orgs.astype(np.int32), (0, 1), hi, "orgs", dev)
        return (hg.slab_sum_launch, hg.slab_sum_ordered, hg.slab_sum_plain,
                (vol, orgs, 14, 16), hg.P3_ATOL)
    hi = (shape[0] // 8 - 3, shape[1] // 8 - 3)
    scal = np.zeros((n, 5), np.int32)
    scal[:, 0], scal[:, 1] = rng.integers(0, hi[0] + 1, n), rng.integers(0, hi[1] + 1, n)
    scal[0, :2] = hi
    return (rs.roi_fetch_launch, rs.roi_fetch_ordered, rs.roi_fetch_plain,
            (vol, rs.check_scalars(vol, scal)), rs.FETCH_ATOL)


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_torch_cuda_sums_match_their_order_and_plain(dev, case):
    """The two-stage ``slab_sum`` and ROI fetch equal their order in torch ops
    (``slab_sum_ordered``, ``roi_fetch_ordered``, which the CPU tests hold to
    the one-pass kernels' per-lane loops) to the bit, and their plain
    versions within ``P3_ATOL`` and ``FETCH_ATOL``; two launches equal to
    the bit. ``slab_sum_unsorted`` has more than 4096 values of oy, so its
    slabs run in their own order, not sorted by oy."""
    launch, ordered, plain, args, atol = _sum_case(dev, case)
    out, again = launch(*args), launch(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, again)
    assert torch.equal(out, ordered(*args))
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_torch_cuda_slab_sum_w_past_2_31(dev):
    """``slab_sum``'s scratch ``W [Z, Y - 15, X]`` with more than 2^31
    elements (2050 x 4096 x 256), as has the volume: slabs on the last valid
    plane and row, and elsewhere, equal the torch order on the slab's own
    sub-volume to the bit (``W``'s rows there depend only on those planes
    and rows)."""
    import numpy as np

    from torchregister_tpu_torch.probes import checked_index
    from torchregister_tpu_torch.probes import hatgather as hg

    Z, Y, X = 2050, 4096 + 15, 256
    assert Z * (Y - 15) * X > 2**31
    vol = torch.rand((Z, Y, X), generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    orgs = np.array([[Z - 14, Y - 16], [Z - 14, 0], [0, Y - 16], [1021, 2047]], np.int32)
    out = hg.slab_sum_launch(vol, checked_index(orgs, (0, 1), (Z - 14, Y - 16), "orgs", dev),
                             14, 16)
    torch.cuda.synchronize()
    for t, (oz, oy) in enumerate(orgs):
        sub = vol[oz:oz + 14, oy:oy + 16].contiguous()
        want = hg.slab_sum_ordered(sub, torch.zeros((1, 2), dtype=torch.int32, device=dev),
                                   14, 16)
        assert torch.equal(out[t:t + 1], want), (oz, oy)
    del vol, out
    torch.cuda.empty_cache()


def _splat_inputs(dev, kind):
    """``(idx, f)`` as ``nmi_loss`` splats them at its default patch (the
    image resized to 200³, 8 patches of 100³: 1 M samples a row, not a whole
    number of the kernel's blocks): ``make_pair``'s moving image at 96³, or
    a constant image (every sample in one bin, the kernel's worst case), on
    the joint range of the pair."""
    import importlib

    from torchregister_tpu_torch.ops.resize import nearest_resize
    from torchregister_tpu_torch.synthetic import make_pair

    mov, tgt = make_pair((96,) * 3, device=dev)
    img = mov if kind == "make_pair" else torch.full_like(mov, 0.37)
    s = nearest_resize(img, (200,) * 3).reshape(8, -1)
    lo, hi = torch.minimum(mov.min(), tgt.min()), torch.maximum(mov.max(), tgt.max())
    # the package's ``losses`` exports a function named ``nmi`` over the module
    tn = importlib.import_module("torchregister_tpu_torch.losses.nmi")
    return tn._splat_weights(s, hi, lo)


@pytest.mark.parametrize("kind", ["make_pair", "constant"])
def test_torch_cuda_splat_matches_its_order_and_plain(dev, kind):
    """The splat kernel equals its order in torch ops (``splat_ordered``) to
    the bit, two launches equal each other, and the plain version (two
    ``scatter_add``, atomics) lies within ``2 n u`` of each bin's mass (the
    bound of any order of f32 additions of the bin's n terms, twice)."""
    from torchregister_tpu_torch.ops.cuda import splat as ks

    idx, f = _splat_inputs(dev, kind)
    assert f.shape == (8, 10**6) and 10**6 % ks.CHUNK
    out, again = ks.splat_launch(idx, f), ks.splat_launch(idx, f)
    ref = ks.splat_plain(idx, f)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, ks.splat_ordered(idx, f))
    i = idx.long()
    n = torch.zeros_like(out).scatter_add(1, i, torch.ones_like(f)).scatter_add(
        1, i + 1, torch.ones_like(f))
    mass = torch.zeros_like(out).scatter_add(1, i, 1.0 - f).scatter_add(1, i + 1, f)
    assert bool(((out - ref).abs() <= 2.0 * n * 2.0**-24 * mass * 1.001).all())
    if kind == "constant":
        assert int((out > 0).sum()) <= 16


def test_torch_cuda_nmi_loss_repeats_to_the_bit(dev):
    """The binned ``nmi_loss`` on the card launches the splat kernel (never
    ``scatter_add``) and gives the same value and gradient twice, bit for
    bit."""
    from torchregister_tpu_torch.losses.nmi import nmi_loss
    from torchregister_tpu_torch.ops.cuda import splat as ks
    from torchregister_tpu_torch.synthetic import make_pair

    mov, tgt = make_pair((64,) * 3, device=dev)
    out = []
    ks.reset_counts()
    for _ in range(2):
        p = (mov * mov).clone().requires_grad_(True)
        loss = nmi_loss(tgt, p, bandwidth=0.05)
        loss.backward()
        out.append((loss.detach(), p.grad))
    assert ks.launches == 4  # two marginals a call
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


# ------------------------------------------- step graphs and make_cascade_fn


def _bits_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.int32),
                                b.contiguous().view(torch.int32)))
    return a == b


@pytest.mark.parametrize("model", ["field", "unet"])
def test_torch_cuda_cascade_fn_equals_register_cascade(dev, model):
    """The factory captures each engine level's step once and replays it;
    its results equal ``register_cascade``'s to the bit, on the first call
    (capture) and on a second call with new inputs of the same shapes
    (copy in, replay only)."""
    from torchregister_tpu_torch.engines.cascade import make_cascade_fn, register_cascade
    from torchregister_tpu_torch.synthetic import RECIPE, RECIPE_UNET, make_flow_truth_pair

    base = RECIPE if model == "field" else RECIPE_UNET
    recipe = {**base, "rigid_epochs": 60, "affine_epochs": 30, "flow_epochs": 40,
              "levels": 2, "matrix_levels": 2, "flow_levels": 2,
              **({"flow_smooth": (0.5, 0.25)} if model == "field" else {})}
    fn = make_cascade_fn(**recipe)
    for seed in (0, 1):
        mov, tgt = make_flow_truth_pair((32, 32, 32), seed=seed, device=dev)[:2]
        want = register_cascade(mov, tgt, **recipe)
        got = fn(mov, tgt)
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None and b is None) or _bits_equal(a, b), (seed, name)
    counts = fn.graphs.counts()
    assert set(counts) == {"rigid/level0", "rigid/level1", "affine/level0",
                           "affine/level1", "flow/level0", "flow/level1"}
    assert all(c == 1 and r > 0 for c, r in counts.values()), counts


def test_torch_cuda_cascade_batch_fn_pairs_equal_their_single_runs(dev):
    """``make_cascade_batch_fn`` on the card: one graph a level for the
    batch, the pairs' launches of K1 with a table per pair, and each pair
    equal to ``make_cascade_fn`` on it alone to the bit (steps, theta, flow,
    image, losses), on the capturing call and on a replaying one."""
    from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn, make_cascade_fn
    from torchregister_tpu_torch.synthetic import RECIPE, make_flow_truth_pair, make_pair

    recipe = {**RECIPE, "rigid_epochs": 60, "affine_epochs": 30, "flow_epochs": 40,
              "levels": 2, "matrix_levels": 2, "flow_levels": 2, "flow_smooth": (0.5, 0.25)}
    pairs = [make_pair((32, 32, 32), seed=0, device=dev),
             make_flow_truth_pair((32, 32, 32), seed=1, device=dev)[:2],
             make_pair((32, 32, 32), seed=2, device=dev)]
    movings, targets = torch.cat([m for m, _ in pairs]), torch.cat([t for _, t in pairs])
    fn, single = make_cascade_batch_fn(**recipe), make_cascade_fn(**recipe)
    k1.reset_counts()
    for call in range(2):
        res = fn(movings, targets)
        for b, (m, t) in enumerate(pairs):
            want = single(m, t)
            assert {k: v[b] for k, v in res.steps.items()} == want.steps, (call, b)
            for name in ("warped", "theta", "flow", "rigid_losses", "affine_losses",
                         "flow_losses"):
                assert _bits_equal(getattr(res, name)[b], getattr(want, name)), (call, b, name)
    assert k1.fwd_modes["pairs"] > 0 and k1.bwd_modes["pairs"] > 0
    assert k1.fwd_modes["dense"] == k1.bwd_modes["dense"] == 0
    assert all(c == 1 and r > 0 for c, r in fn.graphs.counts().values())


def test_torch_cuda_register_cohort_equals_single_runs(dev):
    """``register_cohort`` rigid and field-mode flow on the card: each pair's
    steps, thetas and field equal its single-pair engine's to the bit, the
    pairs stopping at different steps."""
    from torchregister_tpu_torch.cohort_driver import cohort
    from torchregister_tpu_torch.engines.flow import flow_register
    from torchregister_tpu_torch.engines.rigid import rigid_register
    from torchregister_tpu_torch.parallel import register_cohort

    movings, targets, _ = cohort(4, (28, 28, 28), device=dev)
    kw = dict(lr=5e-3, epochs=150, criterions=["mse", "ncc"], optimizer="adam",
              init="identity", stop_rel=1e-3, patience=10)
    res = register_cohort(movings, targets, mode="rigid", **kw)
    assert len(set(res.steps)) > 1, res.steps
    for b in range(4):
        _, solo = rigid_register(movings[b:b + 1], targets[b:b + 1], grad_edges=False, **kw)
        assert solo.steps == res.steps[b] and _bits_equal(res.best_theta[b], solo.best_theta)
    fkw = dict(lr=0.3, criterions=["mse"], optimizer="adam", flow_model="field", smooth=0.5,
               stop_rel=1e-3, patience=5, max_disp=4)
    fres = register_cohort(movings, targets, mode="flow", epochs=60, **fkw)
    for b in range(4):
        _, solo = flow_register(movings[b:b + 1], targets[b:b + 1], max_epochs=60, **fkw)
        assert solo.steps == fres.steps[b] and _bits_equal(fres.flow[b], solo.flow)


def test_torch_cuda_register_cohort_arrays_and_default_criteria(dev):
    """Numpy inputs go to the card (``register_cohort`` takes no device, as
    JAX's runs on its accelerator), equal to the same pairs given as CUDA
    tensors; the default criteria (MSE + NCC + NMI, each pair's NMI on its
    own range and density path) leave each pair equal to its single-pair
    run to the bit."""
    from torchregister_tpu_torch.cohort_driver import cohort
    from torchregister_tpu_torch.engines.rigid import rigid_register
    from torchregister_tpu_torch.parallel import register_cohort

    movings, targets, _ = cohort(2, (28, 28, 28), device=dev)
    kw = dict(mode="rigid", lr=1e-4, epochs=6, optimizer="sgd", init="identity")
    res = register_cohort(movings.cpu().numpy(), targets.cpu().numpy(), **kw)
    assert res.best_theta.device.type == "cuda"
    want = register_cohort(movings, targets, **kw)
    assert res.steps == want.steps and _bits_equal(res.best_theta, want.best_theta)
    for b in range(2):
        _, solo = rigid_register(movings[b:b + 1], targets[b:b + 1], grad_edges=False,
                                 **{k: v for k, v in kw.items() if k != "mode"})
        assert solo.steps == res.steps[b] and _bits_equal(res.best_theta[b], solo.best_theta)
        assert _bits_equal(res.losses[b], solo.losses)


def _graphed_flow_grad(dev, steps):
    """A step graph of one separable flow warp and its gradient to the
    field, whose K1 backward launches from autograd's thread."""
    from torchregister_tpu_torch.engines import graph
    from torchregister_tpu_torch.ops.separable import warp_flow_separable

    gen = torch.Generator(device=dev).manual_seed(5)
    src0 = torch.rand((1, 1, 12, 13, 14), generator=gen, device=dev)
    flow0 = 2 * torch.rand((1, 3, 12, 13, 14), generator=gen, device=dev) - 1
    graphs = graph.StepGraphs()
    with graph.graphed(graphs), graph.level("warp"):
        sess = graph.session()
        src, flow = sess.static("src", src0), sess.static("flow", flow0)
        flow.requires_grad_(True)
        out = sess.static("grad", torch.zeros_like(flow0))

        def step():
            (g,) = torch.autograd.grad(warp_flow_separable(src, flow, 3).square().sum(), flow)
            with torch.no_grad():
                out.add_(g)

        sess.run(step, steps)
    return graphs.level("warp"), src, flow, out, step


def _eager_flow_grad(src, flow):
    from torchregister_tpu_torch.ops.separable import warp_flow_separable

    f = flow.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(warp_flow_separable(src, f, 3).square().sum(), f)
    return g


def test_torch_cuda_graph_backward_on_the_capture_stream(dev):
    """K1's backward, launched from autograd's thread, lands in the graph:
    replays after new values are copied into the captured source follow
    them, equal to the eager gradient to the bit."""
    level, src, flow, out, step = _graphed_flow_grad(dev, 1)
    assert level.captures == 1
    torch.testing.assert_close(out, _eager_flow_grad(src, flow), rtol=0, atol=0)
    with torch.no_grad():
        src.copy_(src.flip(2))
        out.zero_()
    level.run(step, 1)
    assert level.captures == 1 and level.replays == 2
    torch.testing.assert_close(out, _eager_flow_grad(src, flow), rtol=0, atol=0)


def test_torch_cuda_launch_counts_count_replays(dev):
    """The capture counts nothing; each replay adds one step's launches (3
    flow-form forward and 3 backward passes); the warm-up steps ran and
    count."""
    from torchregister_tpu_torch.engines import graph

    k1.reset_counts()
    level, _, _, _, step = _graphed_flow_grad(dev, 5)
    assert level.launches[("torchregister_tpu_torch.ops.cuda.sweep", "fwd_modes", "flow")] == 3
    assert k1.fwd_modes["flow"] == k1.bwd_modes["flow"] == 3 * (graph.WARMUP + 5)
    level.run(step, 4)
    assert k1.fwd_modes["flow"] == k1.bwd_modes["flow"] == 3 * (graph.WARMUP + 9)
    assert k1.fwd_modes["dense"] == k1.bwd_modes["dense"] == 0


def test_torch_cuda_adam_near_torch_optim_foreach(dev):
    """The tensor-op Adam against ``torch.optim.Adam``'s default form on the
    card (foreach) over 100 steps of the same gradients: m and v to the bit,
    the parameters within 4 ulps of lr a step (the last op: foreach fuses
    ``p + s * (m / d)``, the port computes ``p + (s * m) / d``)."""
    from torchregister_tpu_torch.engines.common import make_optimizer

    gen = torch.Generator(device=dev).manual_seed(3)
    p0 = torch.randn((1, 3, 20, 21, 22), generator=gen, device=dev)
    ref = p0.clone().requires_grad_(True)
    opt_ref = torch.optim.Adam([ref], lr=0.3)
    ours = p0.clone()
    opt = make_optimizer("adam", ours, 0.3, 100)
    on = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(100):
        g = torch.randn(p0.shape, generator=gen, device=dev)
        ref.grad = g.clone()
        opt_ref.step()
        opt.step(g, on)
    st = opt_ref.state[ref]
    assert torch.equal(opt.state["m"], st["exp_avg"])
    assert torch.equal(opt.state["v"], st["exp_avg_sq"])
    assert float((ours - ref.detach()).abs().max()) <= 100 * 0.3 * 2.0**-21


# ------------------------------------------------- second order (the LM engines)


def _bwd2_case(dev, shape, axis, per_item, dtype, seed, flip=False):
    """One affine pass's inputs and the cotangents of its backward: a table
    ``[d, d+1]`` (or one a pair) near a shift along ``axis`` (``flip``: a
    reflection, whose floor index decreases along the axis), g and ubar in
    the image dtype, rbar f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = len(shape) - 2
    lead = (shape[0],) if per_item else ()
    coef = torch.zeros(lead + (d,), device=dev)
    coef[..., axis] = -1.0 if flip else 1.0
    coef = coef + 0.15 * (torch.rand(lead + (d,), generator=gen, device=dev) - 0.5)
    offset = 3.0 * (torch.rand(lead, generator=gen, device=dev) - 0.5) + (
        shape[2 + axis] - 1.0 if flip else 0.3)
    table = torch.zeros(lead + (d, d + 1), device=dev)
    table[..., 0, :d], table[..., 0, d] = coef, offset
    src, g, ubar = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    rbar = torch.randn(lead + (d + 1,), generator=gen, device=dev)
    return src, table, coef, offset, g, ubar, rbar


BWD2_CASES = [((1, 1, 40, 37, 45), 0, 8), ((1, 1, 40, 37, 45), 1, 8), ((1, 1, 40, 37, 45), 2, 8),
              ((2, 3, 20, 18, 70), 2, 30), ((1, 1, 50, 61), 0, 5), ((1, 2, 50, 61), 1, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,axis,K", BWD2_CASES)
@pytest.mark.parametrize("flip", [False, True], ids=["fold-free", "folded"])
def test_torch_cuda_sweep_bwd2_matches_plain(dev, shape, axis, K, dtype, flip):
    """K1's second order (``sweep_bwd2``) against ``sweep_bwd2_plain``:
    gbar, sbar (f32: 1e-5 of the largest entry; bf16: 2^-7, an image output
    rounded once) and the row's gradient (1e-4: sums over the image in
    other orders); two launches equal to the bit; fold-free and folded
    coordinates (sbar's two gathers), a window past the chunk (whole
    rows)."""
    src, table, coef, offset, g, ubar, rbar = _bwd2_case(dev, shape, axis, False, dtype, K)
    runs = [k1.affine_bwd2(g, src, table, 0, axis, K, ubar, rbar) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    gbar, sbar, drow = runs[0]
    ref = k1.sweep_bwd2_plain(g, src, ubar, rbar, coef, offset, axis, K)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for got, want in ((gbar, ref[0]), (sbar, ref[1])):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * float(want.float().abs().max()))
    torch.testing.assert_close(drow, ref[2], rtol=0, atol=1e-4 * float(ref[2].abs().max()))
    # no ubar (pass 0's cotangent when the image needs no gradient)
    gbar0, _, drow0 = k1.affine_bwd2(g, src, table, 0, axis, K, None, rbar, need_src=False)
    ref0 = k1.sweep_bwd2_plain(g, src, None, rbar, coef, offset, axis, K)
    torch.testing.assert_close(gbar0.float(), ref0[0].float(), rtol=0,
                               atol=tol * float(ref0[0].float().abs().max()))
    assert not bool(drow0.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,axis,K", [((4, 1, 24, 26, 30), 1, 8), ((3, 1, 40, 44), 0, 6),
                                          ((8, 1, 60, 60, 60), 2, 15)])
def test_torch_cuda_sweep_bwd2_table_per_pair(dev, shape, axis, K, dtype):
    """A table per pair: each pair's gbar, sbar and row gradient equal a
    single-table launch on that pair alone, to the bit."""
    src, table, _, _, g, ubar, rbar = _bwd2_case(dev, shape, axis, True, dtype, 3)
    gbar, sbar, drow = k1.affine_bwd2(g, src, table, 0, axis, K, ubar, rbar)
    for b in range(shape[0]):
        one = k1.affine_bwd2(g[b:b + 1], src[b:b + 1], table[b], 0, axis, K, ubar[b:b + 1],
                             rbar[b])
        assert torch.equal(one[0], gbar[b:b + 1]) and torch.equal(one[1], sbar[b:b + 1])
        assert torch.equal(one[2], drow[b])


@pytest.mark.parametrize("kind", ["make_pair", "constant"])
def test_torch_cuda_splat_signed_matches_its_order_and_plain(dev, kind):
    """The splat's signed mode (the transpose of its backward) equals its
    order in torch ops to the bit, repeats, and lies within rounding of the
    plain version (``scatter_add`` of -w and w); a second derivative of the
    binned NMI launches it."""
    from torchregister_tpu_torch.ops.cuda import splat as ks

    idx, f = _splat_inputs(dev, kind)
    w = f - 0.5
    out, again = ks.splat_launch(idx, w, signed=True), ks.splat_launch(idx, w, signed=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, ks.splat_ordered(idx, w, signed=True))
    ref = ks.splat_plain(idx, w, signed=True)
    i = idx.long()
    n = torch.zeros_like(out).scatter_add(1, i, torch.ones_like(w)).scatter_add(
        1, i + 1, torch.ones_like(w))
    mass = torch.zeros_like(out).scatter_add(1, i, w.abs()).scatter_add(1, i + 1, w.abs())
    assert bool(((out - ref).abs() <= 2.0 * n * 2.0**-24 * mass * 1.001).all())
    # through autograd: the gather's transpose
    g = torch.randn(out.shape, device=dev, requires_grad=True)
    ks.reset_counts()
    fr = f.clone().requires_grad_(True)
    (gf,) = torch.autograd.grad((ks.splat(idx, fr) * g).sum(), fr, create_graph=True)
    (gg,) = torch.autograd.grad((gf * w).sum(), g)
    assert ks.signed_launches == 1 and torch.equal(gg, out)


@pytest.mark.parametrize("kind", ["ragged", "constant", "signed"])
def test_torch_cuda_splat_ragged_rows_match_their_order(dev, kind):
    """The splat kernel equals ``splat_ordered`` to the bit on rows whose
    length is not a whole number of blocks, warps, batches or int4 vectors
    (odd: rows after the first start off a 16-byte boundary, the kernel's
    scalar loads), on a constant row (one bin) and in the signed mode."""
    from torchregister_tpu_torch.ops.cuda import splat as ks

    gen = torch.Generator(device=dev).manual_seed(31)
    N, L = 3, 3 * ks.CHUNK + 5 * 2048 + 37 * 4 + 3
    x = torch.linspace(0.0, 1.0, L, device=dev).repeat(N, 1)
    s = (x + 0.05 * torch.rand((N, L), generator=gen, device=dev)).clamp(0.0, 1.0)
    if kind == "constant":
        s = torch.full((N, L), 0.6180339, device=dev)
    p = s * (ks.BINS - 1)
    i0 = torch.floor(p).clamp(0, ks.BINS - 2)
    idx, f = i0.to(torch.int32).contiguous(), (p - i0).contiguous()
    signed = kind == "signed"
    w = f - 0.5 if signed else f
    out, again = ks.splat_launch(idx, w, signed=signed), ks.splat_launch(idx, w, signed=signed)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, ks.splat_ordered(idx, w, signed=signed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,axis,K", [((2, 1, 12, 10, 300), 2, 8),
                                          ((2, 1, 300, 9, 14), 0, 5),
                                          ((2, 1, 240, 24, 20), 0, 60),
                                          ((2, 1, 60, 60, 60), 1, 11)])
def test_torch_cuda_sweep_bwd2_tile_edges(dev, shape, axis, K, dtype):
    """``sweep_bwd2``'s tiles at their edges: rows of 300 (two chunks of
    256 with the window between them, the last one short), a window of 60
    over rows of 240 (wider than a chunk of 64 was), and 60³ with K = 11 (a
    tile cut to fewer columns to fill the card): gbar and sbar against
    ``sweep_bwd2_plain`` (f32 1e-5, bf16 2^-7 of the largest entry), the row
    gradients at 1e-4, two launches equal, and with a table per pair each
    pair equal to its single-table launch to the bit."""
    src, table, coef, offset, g, ubar, rbar = _bwd2_case(dev, shape, axis, True, dtype, K)
    runs = [k1.affine_bwd2(g, src, table, 0, axis, K, ubar, rbar) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    gbar, sbar, drow = runs[0]
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for b in range(shape[0]):
        one = k1.affine_bwd2(g[b:b + 1], src[b:b + 1], table[b], 0, axis, K, ubar[b:b + 1],
                             rbar[b])
        assert torch.equal(one[0], gbar[b:b + 1]) and torch.equal(one[1], sbar[b:b + 1])
        assert torch.equal(one[2], drow[b])
        ref = k1.sweep_bwd2_plain(g[b:b + 1], src[b:b + 1], ubar[b:b + 1], rbar[b], coef[b],
                                  offset[b], axis, K)
        for got, want in ((one[0], ref[0]), (one[1], ref[1])):
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=tol * float(want.float().abs().max()))
        torch.testing.assert_close(one[2], ref[2], rtol=0,
                                   atol=1e-4 * float(ref[2].abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [0.3, 2.7, 0.0])
@pytest.mark.parametrize("shape,axis,K", [((1, 1, 9, 10, 70), 2, 12), ((1, 1, 40, 6, 5), 0, 9),
                                          ((1, 1, 5, 300, 4), 1, 20)])
def test_torch_cuda_sweep_bwd2_zooms(dev, shape, axis, K, dtype, scale):
    """``sweep_bwd2`` where the swept axis's coefficient is far from 1 (a
    zoom out, a zoom in, a constant coordinate): several x, or none, hit a
    position, so sbar's walk and its window of four candidates meet their
    edge cases; gbar and sbar against ``sweep_bwd2_plain`` (f32 1e-5, bf16
    2^-7 of the largest entry), the row gradient at 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.zeros((3, 4), device=dev)
    table[0, axis] = scale
    if scale:
        table[0, :3] += 0.1 * (torch.rand(3, generator=gen, device=dev) - 0.5)
    table[0, 3] = 3.3
    src, g, ubar = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    rbar = torch.randn(4, generator=gen, device=dev)
    got = k1.affine_bwd2(g, src, table, 0, axis, K, ubar, rbar)
    ref = k1.sweep_bwd2_plain(g, src, ubar, rbar, table[0, :3], table[0, 3], axis, K)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * float(b.float().abs().max()))
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-4 * float(ref[2].abs().max()))


def _rigid_loss(dev, criteria, dtype, size=32):
    from torchregister_tpu_torch.losses import pair_loss, resolve_criteria
    from torchregister_tpu_torch.ops.separable import _warp_affine_separable
    from torchregister_tpu_torch.ops.transforms import rigid_theta
    from torchregister_tpu_torch.synthetic import make_pair

    mov, tgt = make_pair((size,) * 3, device=dev)
    loss = pair_loss(*resolve_criteria(criteria, None), 1)
    p0 = torch.tensor([[0.03, -0.02, 0.04, 0.05, -0.03, 0.02]], device=dev)

    def fn(p, device):
        m, t = mov.to(device).to(dtype), tgt.to(device).to(dtype)
        return loss(t, _warp_affine_separable(rigid_theta(p), m, max_shift=8, twice=True))

    return fn, p0


@pytest.mark.parametrize("criteria,dtype", [(["mse", "ncc"], torch.float32),
                                            (["mse", "ncc"], torch.bfloat16),
                                            (None, torch.float32)],
                         ids=["mse-ncc", "mse-ncc-bf16", "default"])
def test_torch_cuda_val_grad_hess_through_the_kernels(dev, criteria, dtype):
    """The LM Hessian through K1's kernels (``_AffinePass``, ``sweep_bwd2``)
    and, with the default criteria, the NMI splat's signed mode, against
    the same on the CPU through the plain versions: a Hessian that missed a
    kernel's second order would differ by its whole warp terms, not by
    rounding (gradient and Hessian within 1e-3 of their largest entry: the
    criteria's sums in other orders; bf16 images 3e-2). Twice, equal to the
    bit."""
    from torchregister_tpu_torch.engines.second_order import val_grad_hess
    from torchregister_tpu_torch.ops.cuda import splat as ks

    fn, p0 = _rigid_loss(dev, criteria, dtype)
    k1.reset_counts()
    ks.reset_counts()
    runs = [val_grad_hess(lambda p: fn(p, dev), p0.clone().requires_grad_(True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert k1.bwd2_launches == 2 * 6 * 3 and k1.fwd_modes["dense"] == 0
    if criteria is None:
        assert ks.signed_launches > 0
    cpu = val_grad_hess(lambda p: fn(p, "cpu"), p0.cpu().clone().requires_grad_(True))
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for got, want in zip(runs[0][1:], cpu[1:]):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=tol * float(want.abs().max()))


def test_torch_cuda_second_derivative_through_once_differentiable_raises(dev):
    """The kernel Functions that are differentiable once raise on a second
    derivative instead of returning zeros: K1's dense form, its whole-warp
    Functions (affine, flow) and K3."""
    from torchregister_tpu_torch.ops.cuda import conv3d as k3
    from torchregister_tpu_torch.ops.separable import _warp_affine_separable
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    gen = torch.Generator(device=dev).manual_seed(0)
    src = torch.rand((1, 1, 12, 13, 14), generator=gen, device=dev)
    q = torch.rand(src.shape, generator=gen, device=dev) * 10
    flow = torch.rand((1, 3, 12, 13, 14), generator=gen, device=dev)
    p = torch.tensor([0.02, 0.01, -0.03, 0.1, 0.0, 0.05], device=dev)
    cases = {
        "dense": (q, lambda q: k1.sweep(src, q, 4, 3)),
        "affine": (p, lambda p: _warp_affine_separable(rigid_theta(p), src, max_shift=4)),
        "flow": (flow, lambda u: k1.sweep_flow_passes(src, u, 3)),
        "conv3d": (src, lambda x: k3.conv3x3x3(x, torch.ones((3, 3, 3, 1, 2), device=dev))),
    }
    for name, (x, fn) in cases.items():
        x = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x).square().sum(), x, create_graph=True)
        with pytest.raises(RuntimeError, match="is differentiable once"):
            torch.autograd.grad(g.sum(), x)


def test_torch_cuda_nearest_resize_double_backward_repeats_to_the_bit(dev):
    """The NMI term's nearest resize (torch ops in its backward) taken twice
    by autograd on the card: the same bits on every run."""
    from torchregister_tpu_torch.ops.resize import nearest_resize

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1, 1, 30, 31, 29), generator=gen, device=dev)
    w = torch.randn((1, 1, 20, 20, 20), generator=gen, device=dev)
    v = torch.randn(x.shape, generator=gen, device=dev)
    out = []
    for _ in range(3):
        xs = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((nearest_resize(xs, (20, 20, 20)) ** 2 * w).sum(), xs,
                                   create_graph=True)
        out.append(torch.autograd.grad((g * v).sum(), xs)[0])
    assert all(torch.equal(o, out[0]) for o in out[1:])


def test_torch_cuda_lm_cascade_fn_and_cohort_equal_single_runs(dev):
    """LM on the card: ``make_cascade_fn(matrix_optimizer='lm')`` captures
    each matrix level's LM step (gradient, Hessian passes, Cholesky, trial)
    once and equals ``register_cascade`` to the bit; ``register_cohort``
    with LM gives each pair its single run to the bit; the LM engines
    launch K1's second order."""
    from torchregister_tpu_torch.engines.cascade import make_cascade_fn, register_cascade
    from torchregister_tpu_torch.engines.rigid import rigid_register
    from torchregister_tpu_torch.parallel.cohort import register_cohort
    from torchregister_tpu_torch.synthetic import RECIPE, make_pair

    recipe = {**RECIPE, "stages": ("rigid", "affine"), "levels": 2, "matrix_levels": 2,
              "matrix_optimizer": "lm", "rigid_epochs": 24, "affine_epochs": 16,
              "matrix_patience": 3, "matrix_stop_rel": 1e-3}
    mov, tgt = make_pair((40, 40, 40), device=dev)
    fn = make_cascade_fn(**recipe)
    k1.reset_counts()
    for _ in range(2):
        want, got = register_cascade(mov, tgt, **recipe), fn(mov, tgt)
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None and b is None) or _bits_equal(a, b), name
    assert k1.bwd2_launches > 0 and k1.fwd_modes["dense"] == 0
    assert all(c == 1 and r > 0 for c, r in fn.graphs.counts().values())
    movs = torch.cat([make_pair((32,) * 3, seed=s, device=dev)[0] for s in range(3)])
    tgts = torch.cat([make_pair((32,) * 3, seed=s, device=dev)[1] for s in range(3)])
    kw = dict(epochs=20, criterions=["mse", "ncc"], optimizer="lm", stop_rel=1e-3, patience=3,
              max_shift=8)
    res = register_cohort(movs, tgts, mode="rigid", **kw)
    for b in range(3):
        _, one = rigid_register(movs[b:b + 1], tgts[b:b + 1], grad_edges=False,
                                init="identity", **kw)
        assert one.steps == res.steps[b]
        for name in ("losses", "best_params", "param_history", "best_loss"):
            assert _bits_equal(getattr(one, name), getattr(res, name)[b]), (b, name)


# ------------------------------------------------ the exact KDE (csrc/kde.cu)


def _kde_case(dev, N, L, P, scale, seed, points="descending"):
    """Rows ``s [N, L]`` uniform on ``[0, scale)``, ``P`` points over their
    range (``descending`` as ``losses/nmi``'s, ``ascending``, or
    ``shuffled``: not monotone), cotangents ``g [N, P]`` and weights ``w``;
    ``constant``: every sample (so every point) one value; ``nonfinite``:
    one NaN and one inf sample in the first row, the points over the finite
    samples' range."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.rand((N, L), generator=gen, device=dev) * scale
    if points == "constant":
        s = torch.full_like(s, 1234.5)
    hi, lo = s.max(), s.min()
    xis = torch.linspace(0.0, 1.0, P, device=dev) * (lo - hi) + hi
    if points == "ascending":
        xis = xis.flip(0).contiguous()
    elif points == "shuffled":
        xis = xis[torch.randperm(P, generator=gen, device=dev)].contiguous()
    elif points == "nonfinite":
        s[0, L // 7] = float("nan")
        s[0, L // 2] = float("inf")
    g = torch.randn((N, P), generator=gen, device=dev)
    w = torch.randn((N, L), generator=gen, device=dev)
    return s, xis, g, w


# (N, L, P, scale, points) at bandwidth 3, whose cut is 42: rows of several
# of kde_sum's 4096-sample blocks and a ragged tail; P past a block's 256
# threads; one short row; rows longer than kde_dot's 1024 blocks of 256
# samples, the second row's zeros not 16-byte aligned (scale 40: no term
# past the cut). Scale 4000: the kernels drop terms, on a ragged row past
# one 4096-sample block; ascending and shuffled (not monotone) points; a
# constant row; a row with a NaN and an inf sample.
KDE_CASES = [(3, 10000, 64, 40.0, "descending"), (2, 300, 300, 40.0, "descending"),
             (1, 5, 7, 40.0, "descending"), (2, 300001, 16, 40.0, "descending"),
             (2, 4096 + 1234, 256, 4000.0, "descending"), (2, 10000, 256, 4000.0, "ascending"),
             (2, 10000, 300, 4000.0, "shuffled"), (2, 5000, 64, 4000.0, "constant"),
             (2, 9000, 256, 4000.0, "nonfinite")]


def _same_nonfinite(out, ref):
    return torch.equal(out.isnan(), ref.isnan()) and torch.equal(out.isinf(), ref.isinf())


@pytest.mark.parametrize("binned", [0, 1], ids=["exact", "binned"])
@pytest.mark.parametrize("N,L,P,scale,points", KDE_CASES,
                         ids=[f"{n}-{l}-{p}-{s:g}-{k}" for n, l, p, s, k in KDE_CASES])
def test_torch_cuda_kde_kernels_match_plain(dev, N, L, P, scale, points, binned):
    """Each mode of ``kde_sum`` (phi; w and phi') and ``kde_dot`` (phi',
    phi'') against its plain version within 1e-5 of the largest entry
    (other orders of the f32 sums; the kernels' are compensated, and drop
    only terms below f32's smallest normal), NaN and inf where the plain
    version has them, two launches equal to the bit; on the binned flag,
    zeros."""
    from torchregister_tpu_torch.ops.cuda import kde

    s, xis, g, w = _kde_case(dev, N, L, P, scale, N * L + P, points)
    h = 3.0
    flag = torch.full((1,), binned, dtype=torch.int32, device=dev)
    cases = {
        "sum phi": (lambda: kde.kde_sum_launch(s, xis, h, flag),
                    lambda: kde.kde_sum_plain(s, xis, h)),
        "sum w phi'": (lambda: kde.kde_sum_launch(s, xis, h, flag, w=w, deriv=1),
                       lambda: kde.kde_sum_plain(s, xis, h, w=w, deriv=1)),
        "dot phi'": (lambda: kde.kde_dot_launch(g, s, xis, h, flag, deriv=1),
                     lambda: kde.kde_dot_plain(g, s, xis, h, deriv=1)),
        "dot phi''": (lambda: kde.kde_dot_launch(g, s, xis, h, flag, deriv=2),
                      lambda: kde.kde_dot_plain(g, s, xis, h, deriv=2)),
    }
    for name, (launch, plain) in cases.items():
        out, again = launch(), launch()
        assert torch.equal(out.nan_to_num(), again.nan_to_num()), name
        assert _same_nonfinite(out, again), name
        if binned:
            assert not out.any(), name
            continue
        ref = plain()
        assert _same_nonfinite(out, ref), name
        finite = torch.isfinite(ref)
        if points == "nonfinite":
            assert not finite.all(), name
        torch.testing.assert_close(out[finite], ref[finite], rtol=0,
                                   atol=1e-5 * float(ref[finite].abs().max()), msg=name)


def test_torch_cuda_kde_double_backward_matches_autograd_plain(dev):
    """The exact KDE through its Functions on the card (``kde_acc``): the
    gradient and a Hessian-vector product of a nonlinear read-out against
    autograd over the plain version on the card, within 1e-4 of their
    largest entry (the second order's sums in other orders); zeros on the
    binned flag; a third derivative raises."""
    from torchregister_tpu_torch.ops.cuda import kde

    s0, xis, w1, _ = _kde_case(dev, 2, 9000, 48, 30.0, 5)
    v = torch.randn(s0.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    h = 2.0
    out = {}
    for name, binned in (("kernel", 0), ("kernel", 1), ("plain", 0)):
        flag = torch.full((1,), binned, dtype=torch.int32, device=dev)
        a = s0.clone().requires_grad_(True)
        acc = (kde.kde_acc(a, xis, h, flag) if name == "kernel"
               else kde.kde_sum_plain(a, xis, h))
        f = torch.sum(w1 * acc + acc * acc / 100.0)
        (g1,) = torch.autograd.grad(f, a, create_graph=True)
        (hv,) = torch.autograd.grad(torch.sum(g1 * v), a, create_graph=True)
        out[name, binned] = (a, g1, hv)
    for got, want in zip(out["kernel", 0][1:], out["plain", 0][1:]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    a, g1, hv = out["kernel", 1]
    assert not g1.any() and not hv.any()
    with pytest.raises(RuntimeError, match="is differentiable once"):
        torch.autograd.grad(out["kernel", 0][2].sum(), out["kernel", 0][0])


def test_torch_cuda_cascade_fn_default_criteria_equals_register_cascade(dev):
    """``make_cascade_fn(criterions=None)`` (MSE + NCC + NMI, NMI's branch
    picked on the device) at 32³ captures every level and equals
    ``register_cascade`` to the bit, on a unit-range pair (the binned path)
    and on the same pair times 1000 (every NMI call on the exact path,
    through the KDE kernels)."""
    import importlib

    from torchregister_tpu_torch.engines.cascade import make_cascade_fn, register_cascade
    from torchregister_tpu_torch.ops.cuda import kde
    from torchregister_tpu_torch.synthetic import RECIPE, make_pair

    nmi_mod = importlib.import_module("torchregister_tpu_torch.losses.nmi")
    recipe = {**RECIPE, "criterions": None, "rigid_epochs": 30, "affine_epochs": 16,
              "flow_epochs": 12, "levels": 2, "matrix_levels": 2, "flow_levels": 2,
              "flow_smooth": (0.5, 0.25)}
    fn = make_cascade_fn(**recipe)
    mov, tgt = make_pair((32, 32, 32), device=dev)
    for scale, branch in ((1.0, "binned"), (1000.0, "exact")):
        m, t = mov * scale, tgt * scale
        want = register_cascade(m, t, **recipe)
        nmi_mod.branch_calls.reset()
        kde.reset_counts()
        got = fn(m, t)
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None and b is None) or _bits_equal(a, b), (branch, name)
        calls = dict(nmi_mod.branch_calls)
        assert calls[branch] > 0 and sum(calls.values()) == calls[branch], (branch, calls)
        assert (kde.sum_launches > 0) and (kde.dot_launches > 0)
    assert all(c == 1 and r > 0 for c, r in fn.graphs.counts().values()), fn.graphs.counts()
