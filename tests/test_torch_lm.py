"""The port's Levenberg-Marquardt optimizer (``engines/second_order.py``)
against the JAX package's, on the CPU, inputs made with numpy from a seed.

- ``val_grad_hess`` (reverse over reverse) against JAX's ``_val_grad_hess``
  (forward over reverse) for rigid (3, 6) and affine (6, 12) parameters,
  2-D 48² and 3-D 16³, with MSE, NCC and LNCC: gradient and Hessian within
  1e-4 of their largest entry. The point lies off the integer grid: at the
  identity every coordinate is an integer, a kink of linear interpolation,
  where the packages take different one-sided derivatives (the gradient
  there differs by ~4 %). JAX's ``_val_grad_hess`` cannot differentiate NMI
  (its binned splat is a ``custom_vjp``, which has no forward mode, and the
  ``lax.cond`` between the branches traces both), so for NMI the reference
  is JAX's reverse over reverse, ``jacrev(grad)``, on both KDE branches, held
  to ``tests/test_torch_nmi.py``'s NMI gradient tolerance, 3e-4 of the
  largest entry (1000 |NMI - 1| is a difference of near-equal f32 numbers).
- K1's second order: :func:`sweep_bwd2_plain`'s three formulas against
  autograd's double backward through ``sweep_affine_plain``, and the chain
  of ``_AffinePass`` Functions (the card's LM warp) with its launches done
  by the plain versions: its Hessian equals the plain warp's.
- The engines against JAX's LM on ``tests/test_second_order.py``'s cases at
  reduced size: steps and accept decisions equal, losses within the
  engines' tolerance (rtol 1e-3 / atol 3e-4), best parameters within 1e-4.
  From the identity (``test_lm_2d_rigid``) the first step starts at the
  kink above, so there the trajectories differ by ~1 % until they meet at
  the optimum: steps, the first loss and the best parameters are compared.
- The cohort against JAX's and each pair against its single run to the bit.
- The Cholesky of a system that is not positive definite gives NaN and the
  trial is rejected.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from functools import partial

from torchregister_tpu.engines import second_order as jso
from torchregister_tpu.engines.affine import affine_register as j_affine
from torchregister_tpu.engines.rigid import rigid_register as j_rigid
from torchregister_tpu.losses import resolve_criteria as j_resolve, weighted_loss as j_weighted
from torchregister_tpu.losses.nmi import nmi_loss as j_nmi_loss
from torchregister_tpu.ops.resample import warp_affine as j_warp_affine
from torchregister_tpu.ops.separable import _warp_affine_separable as j_sep
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu.parallel.cohort import register_cohort as j_register_cohort
from torchregister_tpu_torch.engines import second_order as so
from torchregister_tpu_torch.engines.affine import affine_register as t_affine, affine_theta
from torchregister_tpu_torch.engines.common import make_optimizer
from torchregister_tpu_torch.engines.rigid import rigid_register as t_rigid
from torchregister_tpu_torch.losses import pair_loss, resolve_criteria as t_resolve
from torchregister_tpu_torch.losses.nmi import nmi_loss as t_nmi_loss
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.separable import (_warp_affine_separable as t_sep,
                                                   affine_to_index_map, factor_passes)
from torchregister_tpu_torch.ops.transforms import rigid_theta as t_rigid_theta
from torchregister_tpu_torch.parallel.cohort import register_cohort

LOSS_TOL = dict(rtol=1e-3, atol=3e-4)
HESS_TOL, NMI_TOL = 1e-4, 3e-4


def _blobs(shape, seed=0, k=6):
    """``tests/test_second_order.py``'s blob volume, numpy ``[1, 1, *S]``."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape],
                        indexing="ij")
    vol = np.zeros(shape, np.float32)
    for _ in range(k):
        c = rng.uniform(-0.5, 0.5, len(shape))
        w = rng.uniform(0.15, 0.3)
        vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2)).astype(
            np.float32)
    return vol[None, None]


def _warped(mov, params):
    """``mov`` under the exact warp of the rigid ``params``, as JAX's tests
    make their targets."""
    return np.asarray(j_warp_affine(j_rigid_theta(jnp.asarray(params, jnp.float32))[None],
                                    jnp.asarray(mov)))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ------------------------------------------------------------ val_grad_hess

# the sweep's window: the point moves each voxel by under a voxel, and JAX
# unrolls 2K + 2 shifts a pass, which its compile time follows
WINDOW = 2
# (criterion, engine, shape, reference): the point is off the integer grid
HESS_CASES = [
    ("mse", "rigid", (48, 48), "linearize"),
    ("ncc", "affine", (16, 16, 16), "linearize"),
    ("lncc", "rigid", (16, 16, 16), "linearize"),
    ("mse", "affine", (48, 48), "linearize"),
    ("nmi-binned", "affine", (48, 48), "jacrev"),
    ("nmi-exact", "rigid", (12, 12, 12), "jacrev"),
]


def _criteria(name):
    """Both packages' criterion stacks for ``name``; NMI at a patch that
    covers the image, the binned branch at the default bandwidth, the exact
    one at a bandwidth below 4 fine bins of the unit range."""
    if not name.startswith("nmi"):
        return j_resolve([name], None), t_resolve([name], None)
    kw = dict(patch_size=8, bandwidth=3.0 if name == "nmi-binned" else 1e-3)
    return (j_resolve([partial(j_nmi_loss, **kw)], None),
            t_resolve([partial(t_nmi_loss, **kw)], None))


@pytest.mark.parametrize("crit,engine,shape,ref", HESS_CASES,
                         ids=[f"{c[0]}-{c[1]}-{len(c[2])}d" for c in HESS_CASES])
def test_torch_val_grad_hess_matches_jax(crit, engine, shape, ref):
    d = len(shape)
    scale = 100.0 if crit == "nmi-binned" else 1.0  # the default bandwidth's range
    mov = _blobs(shape, seed=3) * scale
    tgt = _warped(mov, [0.08, -0.05, 0.04] if d == 2 else [0.06, -0.04, 0.05, 0.2, -0.15, 0.1])
    rng = np.random.default_rng(11)
    if engine == "rigid":
        p0 = (0.02 * rng.standard_normal(3 if d == 2 else 6)).astype(np.float32)
        j_theta, t_theta = (lambda p: j_rigid_theta(p)[None]), t_rigid_theta
    else:
        eye = np.concatenate([np.eye(d), np.zeros((d, 1))], 1)
        p0 = (eye + 0.02 * rng.standard_normal((d, d + 1))).astype(np.float32).ravel()
        j_theta, t_theta = (lambda p: p.reshape(1, d, d + 1)), affine_theta
    (jc, jw), (tc, tw) = _criteria(crit)
    jl, tl = j_weighted(jc, jw), pair_loss(tc, tw, 1)

    def jf(p):
        return jl(jnp.asarray(tgt), j_sep(j_theta(p), jnp.asarray(mov), max_shift=WINDOW))

    if ref == "linearize":
        jv, jg, jh = jax.jit(lambda p: jso._val_grad_hess(jf, p))(jnp.asarray(p0))
    else:
        jv, jg, jh = jax.jit(lambda p: (*jax.value_and_grad(jf)(p),
                                        jax.jacrev(jax.grad(jf))(p)))(jnp.asarray(p0))
    tv, tg, th = so.val_grad_hess(
        lambda p: tl(torch.from_numpy(tgt), t_sep(t_theta(p), torch.from_numpy(mov),
                                                  max_shift=WINDOW)),
        torch.from_numpy(p0)[None].requires_grad_(True))
    tol = NMI_TOL if crit.startswith("nmi") else HESS_TOL
    np.testing.assert_allclose(float(tv[0]), float(jv), **LOSS_TOL)
    _close(tg[0].numpy(), np.asarray(jg), tol)
    # JAX's H[i] is the tangent of the gradient along e_i, a column
    _close(th[0].numpy(), np.asarray(jh).T, tol)
    assert np.abs(np.asarray(jh)).max() > 0


# ------------------------------------------------------------ K1's second order


def _pass_case(shape, axis, per_item, seed):
    gen = torch.Generator().manual_seed(seed)
    d = len(shape) - 2
    src = torch.rand(shape, generator=gen)
    B = shape[0] if per_item else None
    lead = (B,) if per_item else ()
    coef = torch.zeros(lead + (d,))
    coef[..., axis] = 1.0
    coef = coef + 0.15 * (torch.rand(lead + (d,), generator=gen) - 0.5)
    offset = 2.0 * (torch.rand(lead, generator=gen) - 0.5) + 0.3
    g, ubar = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    rbar = torch.randn(lead + (d + 1,), generator=gen)
    return src, coef, offset, g, ubar, rbar


@pytest.mark.parametrize("shape,axis,per_item", [
    ((1, 1, 10, 12), 1, False), ((1, 2, 10, 12), 0, False), ((1, 1, 6, 7, 9), 0, False),
    ((1, 1, 6, 7, 9), 2, False), ((3, 1, 6, 7, 9), 1, True)])
def test_torch_sweep_bwd2_plain_matches_double_backward(shape, axis, per_item):
    """gbar, sbar and the row's gradient: the formulas against autograd
    through the plain pass (f32, the same taps; sums in other orders)."""
    src, coef, offset, g, ubar, rbar = _pass_case(shape, axis, per_item, 5 + axis)
    K = 3
    s = src.clone().requires_grad_(True)
    c, o = coef.clone().requires_grad_(True), offset.clone().requires_grad_(True)
    gg = g.clone().requires_grad_(True)
    out = k1.sweep_affine_plain(s, c, o, axis, K)
    ds, dc, do = torch.autograd.grad(out, (s, c, o), gg, create_graph=True)
    dr = torch.cat([dc, do[..., None]], dim=-1)
    ref = torch.autograd.grad((ds * ubar).sum() + (dr * rbar).sum(), (gg, s, c, o),
                              retain_graph=True)
    gbar, sbar, drow = k1.sweep_bwd2_plain(g, src, ubar, rbar, coef, offset, axis, K)
    _close(gbar.numpy(), ref[0].numpy(), 1e-6)
    _close(sbar.numpy(), ref[1].numpy(), 1e-6)
    _close(drow.numpy(), torch.cat([ref[2], ref[3][..., None]], dim=-1).numpy(), 1e-5)
    # no ubar: the terms of v alone
    gbar0, _, drow0 = k1.sweep_bwd2_plain(g, src, None, rbar, coef, offset, axis, K)
    ref0 = torch.autograd.grad((dr * rbar).sum(), (gg, c), allow_unused=True)
    _close(gbar0.numpy(), ref0[0].numpy(), 1e-6)
    assert ref0[1] is None and not drow0.any()  # D(q)src is constant in q


def _emulate_launches(monkeypatch):
    """The raw launches of K1's affine form done by the plain versions, on
    CPU tensors, so the card's Functions run here."""

    def row(table, p):
        return table[..., p, :-1], table[..., p, -1]

    def fwd(src, table, p, axis, K):
        return k1.sweep_affine_plain(src, *row(table, p), axis, K)

    def bwd(g, src, table, p, axis, K, need_src, dtable, work=None):
        s = src.clone().requires_grad_(True)
        coef, offset = (t.detach().clone().requires_grad_(True) for t in row(table, p))
        with torch.enable_grad():  # a Function's forward runs without
            ds, dc, do = torch.autograd.grad(k1.sweep_affine_plain(s, coef, offset, axis, K),
                                             (s, coef, offset), g)
        if dtable is not None:
            dtable[..., p, :] = torch.cat([dc, do[..., None]], dim=-1)
        return ds if need_src else None

    def bwd2(g, src, table, p, axis, K, ubar, rbar, need_g, need_src, dtable, work=None):
        gbar, sbar, drow = k1.sweep_bwd2_plain(g, src, ubar, rbar[..., p, :], *row(table, p),
                                               axis, K)
        if dtable is not None:
            dtable[..., p, :] = drow
        return gbar if need_g else None, sbar if need_src else None

    monkeypatch.setattr(k1, "_fwd_affine", fwd)
    monkeypatch.setattr(k1, "_bwd_affine", bwd)
    monkeypatch.setattr(k1, "_bwd2_affine", bwd2)
    monkeypatch.setattr(k1, "_affine_work", lambda *a: None)
    monkeypatch.setattr(k1, "_validate_table", lambda *a: None)  # CPU tensors


@pytest.mark.parametrize("pairs", [1, 2])
def test_torch_affine_pass_chain_hessian(monkeypatch, pairs):
    """The card's twice-differentiable warp (``_AffinePass`` a pass, its
    backward a Function whose backward is K1's second order) with each
    launch done by its plain version: the Hessian of an MSE through a 3-pass
    warp equals the one through the plain passes (the intermediates depend
    on the table through the earlier passes), with a table per pair too."""
    mov = torch.from_numpy(np.concatenate([_blobs((10, 11, 12), seed=s) for s in range(pairs)]))
    tgt = torch.roll(mov, 1, dims=-1)
    p0 = torch.tensor([[0.05, -0.03, 0.04, 0.1, -0.08, 0.05]] * pairs)
    p0[-1] *= -1.0
    loss = pair_loss(*t_resolve(["mse"], None), pairs)

    def fn(p):
        return loss(tgt, t_sep(t_rigid_theta(p), mov, max_shift=4, twice=True))

    ref = so.val_grad_hess(fn, p0.clone().requires_grad_(True))
    _emulate_launches(monkeypatch)

    def chain(p):
        theta = t_rigid_theta(p)
        M, t = affine_to_index_map(theta if pairs > 1 else theta[0], tuple(mov.shape[2:]))
        table, axes = k1.pass_table(factor_passes(M, t))
        return loss(tgt, k1.affine_chain(mov, table, axes, (4, 4, 4)))

    got = so.val_grad_hess(chain, p0.clone().requires_grad_(True))
    for a, b in zip(got, ref):
        _close(a.numpy(), b.numpy(), 1e-5)
    assert ref[2].abs().max() > 0


def test_torch_second_derivative_through_a_once_differentiable_kernel_raises(monkeypatch):
    """A Hessian through a kernel Function that is differentiable once
    raises, though another path reaches the parameters (the table's own
    ops), where ``torch.autograd.function.once_differentiable`` would leave
    the kernel's terms out in silence: K1's whole-warp Function (its launches
    done by the plain versions), the chain's third derivative, and K3 (which
    runs on the CPU through its plain versions)."""
    from torchregister_tpu_torch.ops.cuda import conv3d as k3

    _emulate_launches(monkeypatch)
    mov = torch.from_numpy(_blobs((10, 11, 12), seed=1))
    p0 = torch.tensor([[0.05, -0.03, 0.04, 0.1, -0.08, 0.05]])

    def warp(p, fn):
        M, t = affine_to_index_map(t_rigid_theta(p)[0], tuple(mov.shape[2:]))
        table, axes = k1.pass_table(factor_passes(M, t))
        return fn(mov, table, axes, (4, 4, 4))

    whole = lambda p: warp(p, k1._SeparableAffine.apply).square().mean()[None]  # noqa: E731
    with pytest.raises(RuntimeError, match="_SeparableAffine is differentiable once"):
        so.val_grad_hess(whole, p0.clone().requires_grad_(True))
    p = p0.clone().requires_grad_(True)
    loss = warp(p, k1.affine_chain).square().mean()
    (g,) = torch.autograd.grad(loss, p, create_graph=True)
    (h,) = torch.autograd.grad(g[0, 0], p, create_graph=True)
    with pytest.raises(RuntimeError, match="_AffinePassBwd is differentiable once"):
        torch.autograd.grad(h[0, 1], p)
    x = torch.rand((1, 1, 6, 6, 6), requires_grad=True)
    w = torch.rand((3, 3, 3, 1, 2), requires_grad=True)
    (gx,) = torch.autograd.grad((k3.conv3x3x3(x, w) ** 2).sum() + (w ** 2).sum(), w,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="_Conv3x3x3 is differentiable once"):
        torch.autograd.grad(gx.sum(), w)


# ------------------------------------------------------------ the LM step


def test_torch_cholesky_non_pd_nan_and_rejected_trial():
    A = torch.tensor([[[4.0, 2.0], [2.0, 3.0]], [[1.0, 2.0], [2.0, 1.0]]])
    L = so.cholesky(A)
    np.testing.assert_allclose((L[0] @ L[0].T).numpy(), A[0].numpy(), rtol=1e-6)
    assert bool(torch.isnan(L[1]).any()) and not bool(torch.isnan(L[0]).any())
    x = so.cho_solve(L, torch.tensor([[1.0, 2.0], [1.0, 2.0]]))
    np.testing.assert_allclose(x[0].numpy(), np.linalg.solve(A[0].numpy(), [1.0, 2.0]),
                               rtol=1e-6)
    assert bool(torch.isnan(x[1]).all())
    # a saddle: the Newton system at lam 1 is not positive definite, the
    # trial is NaN and rejected, lam grows by 4, the parameters stay
    p = torch.zeros((1, 2), requires_grad=True)
    opt = make_optimizer("lm", p, 0.0, 5)

    def saddle(q):
        return (q[:, 0] + 0.1) ** 2 - 10.0 * (q[:, 1] - 0.2) ** 2

    val, grad, hess = so.val_grad_hess(saddle, p)
    with torch.no_grad():
        trial, val_new, accept = opt.step(saddle, val, grad, hess, torch.ones(1, dtype=bool))
    assert bool(torch.isnan(trial).any()) and not bool(accept[0])
    assert torch.equal(p.detach(), torch.zeros((1, 2)))
    assert float(opt.state["lam"][0]) == 4.0


def _accepts(losses, steps):
    """Each iteration's decision as its next loss shows it: a rejected step
    leaves the parameters, so the loss repeats."""
    return np.diff(np.asarray(losses)[:steps]) != 0


def _same_decisions(tl, jl, steps):
    """The accept decisions equal up to the first tie: an iteration where
    either package accepted a decrease within 1e-4 of the loss, which the
    packages' rounding (their losses differ by up to ~1e-5 relative) may
    decide either way near convergence."""
    ties = [np.flatnonzero((np.diff(x[:steps]) != 0) & (
        np.abs(np.diff(x[:steps])) <= 1e-4 * np.abs(x[:steps - 1]))) for x in (tl, jl)]
    end = min([t[0] for t in ties if t.size], default=steps - 1)
    np.testing.assert_array_equal(_accepts(tl, steps)[:end], _accepts(jl, steps)[:end])
    return end


C = np.array([0.3, -0.2, 0.5, 0.1], np.float32)


def test_torch_optimize_lm_matches_jax():
    """A non-convex toy loss, where LM rejects steps: the losses, hence the
    accept decisions (a rejected step repeats its loss), the parameter
    history and the best pick, under the plateau stop and without it. The
    packages' f32 sines differ in the last bit; without the stop, iteration
    6 takes a step of 1.4 along a direction whose damped curvature is near
    0 (an indefinite Hessian), which grows that to 1.8e-5 in the parameters
    and 1.5e-4 two steps on: losses at the engines' tolerance, parameters
    to 1e-3 (measured 1.5e-4)."""
    def jloss(p):
        return jnp.sum((p - C) ** 2) + 0.05 * jnp.sum(jnp.sin(20.0 * p)) + 1.0

    def tloss(p):
        return torch.sum((p - torch.from_numpy(C)) ** 2) + 0.05 * torch.sum(
            torch.sin(20.0 * p)) + 1.0

    p0 = np.array([0.9, -0.7, -0.4, 0.6], np.float32)
    for stop_rel in (1e-4, None):
        j = jso.optimize_lm(jloss, jnp.asarray(p0), 30, stop_rel=stop_rel, patience=3)
        t = so.optimize_lm(tloss, torch.from_numpy(p0), 30, stop_rel=stop_rel, patience=3)
        steps = int(j[5])
        assert t[5] == steps
        jl, tl = np.asarray(j[3]), t[3].numpy()
        np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
        np.testing.assert_allclose(tl[:steps], jl[:steps], **LOSS_TOL)
        end = _same_decisions(tl, jl, steps)
        assert not _accepts(jl, end + 1).all()  # a rejected step before any tie
        np.testing.assert_allclose(t[4].numpy()[:steps], np.asarray(j[4])[:steps], atol=1e-3)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-3)
        assert float(t[2]) == pytest.approx(float(j[2]), rel=1e-5)


# ------------------------------------------------------------ engines


def test_torch_lm_2d_rigid_matches_jax():
    """``test_lm_2d_rigid``: 48², MSE, from the identity."""
    mov = _blobs((48, 48), seed=5)
    true_p = np.array([0.1, 0.08, -0.06], np.float32)
    tgt = _warped(mov, true_p)
    kw = dict(epochs=40, criterions=["mse"], grad_edges=False, optimizer="lm",
              init="identity", stop_rel=1e-3, patience=3)
    _, j = j_rigid(jnp.asarray(mov), jnp.asarray(tgt), **kw)
    _, t = t_rigid(torch.from_numpy(mov), torch.from_numpy(tgt), **kw)
    assert int(j.steps) < 40
    _cmp_from_identity(t, j)
    np.testing.assert_allclose(t.best_params.numpy(), true_p, atol=5e-3)


def _cmp_from_identity(t, j):
    """A run from the identity, the kink of the first step: steps, the first
    loss, the NaN padding and the best parameters."""
    assert t.steps == int(j.steps)
    np.testing.assert_allclose(t.losses.numpy()[0], np.asarray(j.losses)[0], **LOSS_TOL)
    np.testing.assert_array_equal(np.isnan(t.losses.numpy()), np.isnan(np.asarray(j.losses)))
    np.testing.assert_allclose(t.best_params.numpy(), np.asarray(j.best_params), atol=1e-4)


def _cmp_lm(t, j):
    steps = int(j.steps)
    assert t.steps == steps
    tl, jl = t.losses.numpy(), np.asarray(j.losses)
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    np.testing.assert_allclose(tl[:steps], jl[:steps], **LOSS_TOL)
    _same_decisions(tl, jl, steps)
    np.testing.assert_allclose(t.best_params.numpy(), np.asarray(j.best_params), atol=1e-4)
    np.testing.assert_allclose(t.param_history.numpy()[:steps],
                               np.asarray(j.param_history)[:steps], atol=1e-4)
    np.testing.assert_allclose(float(t.best_loss), float(j.best_loss), **LOSS_TOL)


def test_torch_lm_rigid_hard_start_matches_jax():
    """``test_lm_rejects_bad_steps_on_hard_start`` in 2-D (JAX's 3-D LM
    engine takes minutes to compile on a CPU): from a far-off init the first
    proposals overshoot and are rejected; the loop stays finite and
    descends."""
    mov = _blobs((40, 40), seed=9)
    tgt = _warped(mov, [0.06, 0.1, -0.08])
    init = np.array([0.45, -0.3, 0.35], np.float32)
    kw = dict(epochs=20, criterions=["mse"], grad_edges=False, optimizer="lm",
              stop_rel=1e-3, patience=5, max_shift=12, check_window=False)
    _, j = j_rigid(jnp.asarray(mov), jnp.asarray(tgt), init_params=jnp.asarray(init), **kw)
    _, t = t_rigid(torch.from_numpy(mov), torch.from_numpy(tgt),
                   init_params=torch.from_numpy(init), **kw)
    _cmp_lm(t, j)
    valid = t.losses.numpy()[:t.steps]
    assert np.isfinite(valid).all() and float(t.best_loss) < valid[0]
    assert not _accepts(valid, t.steps).all()  # a rejected step


def test_torch_lm_affine_monotone_history_matches_jax():
    """``test_lm_monotone_best_and_history`` with the affine engine, in 2-D,
    no plateau stop, 12 iterations: the history is finite, the best loss its
    running minimum."""
    mov = _blobs((40, 40), seed=7)
    tgt = _warped(mov, [0.08, 0.05, -0.04])
    eye = np.concatenate([np.eye(2), np.zeros((2, 1))], 1)
    init = (eye + 0.01 * np.random.default_rng(2).standard_normal((2, 3))).astype(np.float32)
    kw = dict(epochs=12, criterions=["mse"], grad_edges=False, optimizer="lm", max_shift=4,
              check_window=False)
    _, j = j_affine(jnp.asarray(mov), jnp.asarray(tgt), init_theta=jnp.asarray(init)[None], **kw)
    _, t = t_affine(torch.from_numpy(mov), torch.from_numpy(tgt),
                    init_theta=torch.from_numpy(init)[None], **kw)
    _cmp_lm(t, j)
    losses = t.losses.numpy()
    assert np.isfinite(losses).all() and t.param_history.shape == (12, 6)
    assert float(t.best_loss) <= losses.min()


def test_torch_lm_cohort_matches_jax_and_single_runs():
    """``register_cohort(optimizer='lm')`` on 3 pairs of 2-D blobs, each
    under its own rigid offset, MSE with a plateau stop: each pair against JAX's
    cohort (from the identity, the cohort's start) and to the bit against
    the port's single run."""
    movs = np.concatenate([_blobs((40, 40), seed=20 + b) for b in range(3)])
    offs = [[0.05, 0.06, -0.04], [-0.08, 0.02, 0.05], [0.02, -0.05, -0.03]]
    tgts = np.concatenate([_warped(movs[b:b + 1], offs[b]) for b in range(3)])
    kw = dict(mode="rigid", epochs=30, criterions=["mse"], optimizer="lm",
              stop_rel=1e-3, patience=3, max_shift=8)
    j = j_register_cohort(jnp.asarray(movs), jnp.asarray(tgts), **kw)
    t = register_cohort(torch.from_numpy(movs), torch.from_numpy(tgts), **kw)
    for b in range(3):
        one = jax.tree.map(lambda x: x[b], j)
        _cmp_from_identity(type(t)(*(x[b] for x in t)), one)
        _, single = t_rigid(torch.from_numpy(movs[b:b + 1]), torch.from_numpy(tgts[b:b + 1]),
                            epochs=30, criterions=["mse"], grad_edges=False,
                            optimizer="lm", init="identity", stop_rel=1e-3, patience=3,
                            max_shift=8)
        assert single.steps == t.steps[b]
        for name in ("losses", "best_params", "final_params", "param_history", "best_loss"):
            np.testing.assert_array_equal(getattr(single, name).numpy(),
                                          getattr(t, name)[b].numpy(), err_msg=name)

