"""Engines of the PyTorch port against the JAX package, on the CPU.

Under SGD the two packages follow the same trajectory up to f32 rounding
order, so executed steps and the best pick are compared exactly. The losses
carry NCC's alpha = 100, which turns the ~1e-6 relative difference of two f32
reduction orders in the correlation into ~1e-4 absolute: losses are held to
rtol 1e-3 / atol 3e-4, parameters to atol 1e-4. Adam is compared by step
counts in the cascade tests (``torch.optim.Adam`` and ``optax.adam`` drift by
~1e-5 over tens of steps).
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import bench
from torchregister_tpu.engines import common as jc
from torchregister_tpu.engines.affine import affine_register as j_affine
from torchregister_tpu.engines.flow import flow_register as j_flow
from torchregister_tpu.engines.rigid import rigid_register as j_rigid
from torchregister_tpu.models.attention_unet import AttentionUNet as JUNet
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu_torch import convert, synthetic
from torchregister_tpu_torch.engines import common as tc
from torchregister_tpu_torch.engines.affine import affine_register as t_affine
from torchregister_tpu_torch.engines.flow import _diffusion_energy, flow_register as t_flow
from torchregister_tpu_torch.engines.rigid import init_rigid_params, rigid_register as t_rigid
from torchregister_tpu_torch.synthetic import make_pair

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def pair():
    mov, tgt = make_pair(SHAPE, seed=0)
    return mov.numpy(), tgt.numpy()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------ optimize_scan

C = np.array([0.3, -0.2, 0.5, 0.1], np.float32)


def _jloss(p):
    return jnp.sum((p - C) ** 2) + 0.05 * jnp.sum(jnp.sin(20.0 * p)) + 1.0


def _tloss(p):
    c = torch.from_numpy(C)
    return torch.sum((p - c) ** 2) + 0.05 * torch.sum(torch.sin(20.0 * p)) + 1.0


@pytest.mark.parametrize("stop_rel", [None, 1e-3], ids=["scan", "plateau"])
def test_torch_optimize_scan_matches_jax(stop_rel):
    """Losses, pre-update param history, best pick (strict <), NaN padding
    and executed steps against ``engines/common.optimize_scan``."""
    p0 = np.zeros(4, np.float32)
    epochs = 60
    jf, jb, jbl, jl, jh, js = jc.optimize_scan(_jloss, jnp.asarray(p0), optax.sgd(0.05),
                                               epochs, stop_rel=stop_rel, patience=5)
    tf, tb, tbl, tl, th, ts = tc.optimize_scan(_tloss, _t(p0), "sgd", 0.05, epochs,
                                               stop_rel=stop_rel, patience=5)
    assert ts == int(js)
    if stop_rel is not None:
        assert ts < epochs  # the plateau stop fired
    np.testing.assert_array_equal(np.isnan(tl.numpy()), np.isnan(np.asarray(jl)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    assert float(tbl) == pytest.approx(float(jbl), rel=1e-6)
    best_i = int(np.nanargmin(tl.numpy()))
    np.testing.assert_array_equal(tb.numpy(), th.numpy()[best_i])


def test_torch_make_optimizer():
    p = torch.zeros(2, requires_grad=True)
    assert isinstance(tc.make_optimizer("SGD", p, 0.1, 10), tc.SGD)
    assert isinstance(tc.make_optimizer("adam", p, 0.1, 10), tc.Adam)
    with pytest.raises(NotImplementedError, match="item 14"):
        tc.make_optimizer("lm", p, 0.1, 10)
    with pytest.raises(ValueError):
        tc.make_optimizer("rmsprop", p, 0.1, 10)


# ------------------------------------------------------------ windows


@pytest.mark.parametrize("angle", [0.05, 0.5, 1.4])
def test_torch_window_helpers(angle):
    from torchregister_tpu.ops.transforms import rigid_theta_np

    spatial = (20, 24, 28)
    theta = rigid_theta_np(np.array([angle, 0.1, -0.05, 0.6, -0.4, 0.2]))
    assert tc.resolve_sweep_windows(theta, spatial, None) == jc.resolve_sweep_windows(
        theta, spatial, None)
    assert tc.resolve_sweep_windows(theta, spatial, [4, 5, 6]) == (4, 5, 6)
    req = (3, 40, 9)
    assert tc.windows_from_required(req, spatial) == jc.windows_from_required(req, spatial)
    for used in (None, 4, (30, 30, 30)):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            tc.check_sweep_windows(theta, spatial, used, "t")
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jc.check_sweep_windows(jnp.asarray(theta, jnp.float32), spatial, used, "j")
        assert len(tw) == len(jw)


# ------------------------------------------------------------ rigid / affine


def test_torch_init_rigid_params():
    assert torch.equal(init_rigid_params(3, init="identity"), torch.zeros(6))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a, b = init_rigid_params(3, g1), init_rigid_params(3, g2)
    assert a.shape == (6,) and torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())
    assert init_rigid_params(2, init="identity").shape == (3,)


LOSS_TOL = dict(rtol=1e-3, atol=3e-4)


def _cmp_matrix_results(tres, jres):
    steps = int(jres.steps)
    assert tres.steps == steps
    tl, jl = tres.losses.numpy(), np.asarray(jres.losses)
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    np.testing.assert_allclose(tl[:steps], jl[:steps], **LOSS_TOL)
    assert int(np.nanargmin(tl)) == int(np.nanargmin(jl))
    np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                               atol=1e-4)
    np.testing.assert_allclose(tres.param_history.numpy()[:steps],
                               np.asarray(jres.param_history)[:steps], atol=1e-4)


def test_torch_rigid_register_sgd_matches_jax(pair):
    mov, tgt = pair
    init = np.array([0.0, 0.0, 0.0, 0.05, -0.05, 0.02], np.float32)
    kw = dict(lr=2e-3, epochs=40, criterions=["mse", "ncc"], grad_edges=False,
              optimizer="sgd", init="identity", max_shift=6, stop_rel=1e-3,
              patience=5, check_window=False)
    jw, jres = j_rigid(jnp.asarray(mov), jnp.asarray(tgt), init_params=jnp.asarray(init), **kw)
    tw, tres = t_rigid(_t(mov), _t(tgt), init_params=convert.rigid_params(init), **kw)
    _cmp_matrix_results(tres, jres)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)


def test_torch_affine_register_sgd_matches_jax(pair):
    """Warm-started from a JAX theta carried across by ``convert.theta``."""
    mov, tgt = pair
    init = np.asarray(j_rigid_theta(
        jnp.asarray([0.02, -0.01, 0.03, 0.04, -0.02, 0.01], jnp.float32)))[None]
    kw = dict(lr=1e-4, epochs=30, criterions=["mse", "ncc"], grad_edges=False,
              optimizer="sgd", max_shift=6, stop_rel=1e-3, patience=5,
              check_window=False)
    _, jres = j_affine(jnp.asarray(mov), jnp.asarray(tgt), init_theta=jnp.asarray(init), **kw)
    _, tres = t_affine(_t(mov), _t(tgt), init_theta=convert.theta(init), **kw)
    _cmp_matrix_results(tres, jres)


@pytest.mark.parametrize("engine", ["rigid", "affine"])
def test_torch_matrix_engines_accept_and_drop_per(pair, engine):
    """``per=`` as the JAX engines take it (after ``epochs``, by keyword and
    by position), accepted and unused: the call with ``per=0.3`` equals the
    call without it to the bit (steps, losses, parameters, warped image),
    and the JAX engine takes the same call."""
    mov, tgt = pair
    tfn, jfn = (t_rigid, j_rigid) if engine == "rigid" else (t_affine, j_affine)
    kw = dict(criterions=["mse"], grad_edges=False, optimizer="sgd", max_shift=6,
              check_window=False, **({"init": "identity"} if engine == "rigid" else {}))
    w0, r0 = tfn(_t(mov), _t(tgt), lr=2e-3, epochs=6, **kw)
    w1, r1 = tfn(_t(mov), _t(tgt), lr=2e-3, epochs=6, per=0.3, **kw)
    w2, r2 = tfn(_t(mov), _t(tgt), 2e-3, 6, 0.3, **kw)
    for w, r in ((w1, r1), (w2, r2)):
        assert r.steps == r0.steps == 6
        assert torch.equal(w, w0)
        for name in ("losses", "best_params", "final_params", "param_history"):
            assert torch.equal(getattr(r, name), getattr(r0, name)), name
    _, jres = jfn(jnp.asarray(mov), jnp.asarray(tgt), lr=2e-3, epochs=6, per=0.3, **kw)
    assert int(jres.steps) == r1.steps


def test_torch_rigid_register_bf16_images(pair):
    """bf16 images (the recipe's matrix stages): the JAX sweep and its
    autodiff round every partial sum to bf16, the port's sums run in f32 and
    round once, so each step's gradient differs by ~1 %: loss trajectories
    are held to 3 %, the recovered theta to 2e-3, steps to within 2."""
    mov, tgt = pair
    kw = dict(lr=2e-3, epochs=30, criterions=["mse", "ncc"], grad_edges=False,
              optimizer="sgd", init="identity", max_shift=6, stop_rel=1e-3,
              patience=5, check_window=False)
    _, jres = j_rigid(jnp.asarray(mov).astype(jnp.bfloat16),
                      jnp.asarray(tgt).astype(jnp.bfloat16), **kw)
    _, tres = t_rigid(_t(mov).to(torch.bfloat16), _t(tgt).to(torch.bfloat16), **kw)
    assert abs(tres.steps - int(jres.steps)) <= 2
    n = min(tres.steps, int(jres.steps))
    np.testing.assert_allclose(tres.losses.numpy()[:n], np.asarray(jres.losses)[:n],
                               rtol=3e-2)
    np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                               atol=2e-3)


def test_torch_engine_options_not_ported(pair):
    """The engine options that raised before the edge filter and NMI were
    ported run and follow the JAX engines under SGD: ``grad_edges=True``
    registers the two Sobel masks (rigid separable, affine exact), and the
    default criteria (``criterions=None``) add NMI to MSE and NCC. Steps,
    losses and thetas at the tolerances above. The default NMI patch (100)
    resizes its input to 200 voxels a side, whose splat in 3D is slow in the
    JAX package on the CPU, so the default stack runs on the pair's middle
    plane."""
    mov, tgt = pair
    cases = [(j_rigid, t_rigid, dict(criterions=["mse", "ncc"], grad_edges=True, lr=2e-3,
                                     epochs=15, init="identity", max_shift=6)),
             (j_affine, t_affine, dict(criterions=["mse", "ncc"], grad_edges=True, lr=1e-4,
                                       epochs=15, method="exact")),
             (j_rigid, t_rigid, dict(grad_edges=False, lr=2e-3, epochs=10, init="identity",
                                     max_shift=6))]
    for i, (jfn, tfn, kw) in enumerate(cases):
        if i == 2:
            mov, tgt = mov[:, :, 8], tgt[:, :, 8]
        kw = dict(kw, optimizer="sgd", check_window=False)
        jw, jres = jfn(jnp.asarray(mov), jnp.asarray(tgt), **kw)
        tw, tres = tfn(_t(mov), _t(tgt), **kw)
        _cmp_matrix_results(tres, jres)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)
        if kw["grad_edges"]:  # the warped best is the warped moving mask
            assert float(tw.min()) >= -1e-5 and float(tw.max()) <= 1.0 + 1e-5


# ------------------------------------------------------------- flow (U-Net)


def _flow_truth_pairs(shape, max_disp):
    """``bench.py``'s deformable-truth pair without its rigid part, and the
    port's (the same numpy draws)."""
    rigid = (0.0,) * 6
    return (bench.make_flow_truth_pair(shape, max_disp=max_disp, rigid=rigid),
            synthetic.make_flow_truth_pair(shape, max_disp=max_disp, rigid=rigid))


def test_torch_flow_register_unet_sgd_matches_jax():
    """24³, depth 1, SGD from JAX's own initial weights with the flow head
    zeroed (the cascade's residual start: the field begins at 0, inside the
    sweep window): every step's loss, the executed steps (plateau stop), the
    flow and the trained weights. Losses rtol 3e-4: the frameworks' gradients
    differ by their f32 rounding (JAX's tap path is the coarser, ~1e-4 of the
    largest gradient), measured 1.1e-4 here; the flow within 1e-3 of its
    largest value (measured 2e-4)."""
    (jm, jt, _, _), (tm, tt, _, _) = _flow_truth_pairs((24, 24, 24), 2.0)
    net = JUNet(ndim=3, n=8, depth=1)
    params = jax.tree.map(np.asarray, jax.jit(net.init)(jax.random.key(3), jm)["params"])
    for k in ("out_kernel", "out_bias"):
        params[k] = np.zeros_like(params[k])
    kw = dict(lr=5e-3, max_epochs=15, criterions=["mse", "ncc"], optimizer="sgd", n=8,
              depth=1, stop_rel=1e-3, patience=4, max_disp=4, check_disp=False)
    jw, jres = j_flow(jm, jt, init_params=params, **kw)
    tw, tres = t_flow(tm, tt, init_params=convert.unet_params(params), **kw)
    assert tres.steps == int(jres.steps) == 15
    tl, jl = tres.losses.numpy(), np.asarray(jres.losses)
    np.testing.assert_allclose(tl, jl, rtol=3e-4)
    assert jl[-1] < 0.95 * jl[0]  # the weights moved
    scale = float(np.max(np.abs(np.asarray(jres.flow))))
    np.testing.assert_allclose(tres.flow.numpy(), np.asarray(jres.flow), rtol=0,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-4)
    # FlowResult.params is the trained state, and carries back to a JAX tree
    ref = convert._flatten(jax.tree.map(np.asarray, jres.params))
    for k, v in convert._flatten(convert.unet_tree(tres.params)).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_torch_flow_register_unet_options():
    """Port-side U-Net options at 16³: ``remat`` recomputes the same numbers,
    a bf16 network keeps an f32 flow, ``zero_head`` starts from the identity
    (the first loss is the unwarped pair's), a volume too small for any depth
    raises, and a ``generator`` fixes the initial weights."""
    m, t = make_pair((16, 16, 16), seed=2)
    kw = dict(lr=1e-2, max_epochs=3, criterions=["mse", "ncc"], optimizer="sgd", n=16,
              max_disp=4, check_disp=False)
    _, plain = t_flow(m, t, **kw)
    _, remat = t_flow(m, t, remat=True, **kw)
    torch.testing.assert_close(remat.losses, plain.losses, rtol=0, atol=0)
    _, again = t_flow(m, t, generator=torch.Generator().manual_seed(0), **kw)
    torch.testing.assert_close(again.flow, plain.flow, rtol=0, atol=0)
    _, bf = t_flow(m, t, dtype="bfloat16", **kw)
    assert bf.flow.dtype == torch.float32 and bool(torch.isfinite(bf.flow).all())
    _, zero = t_flow(m, t, zero_head=True, **dict(kw, max_epochs=1))
    with pytest.warns(RuntimeWarning, match="barely moves a direct field"):
        _, field0 = t_flow(m, t, flow_model="field", **dict(kw, max_epochs=1, lr=0.0))
    torch.testing.assert_close(zero.losses, field0.losses, rtol=0, atol=0)
    assert set(plain.params) >= {"enc1.Conv_0.kernel", "out_kernel", "out_bias"}
    with pytest.raises(ValueError, match="too small"):
        t_flow(m[..., :8, :8, :8], t[..., :8, :8, :8], **kw)
    with pytest.raises(ValueError, match="flow_model"):
        t_flow(m, t, flow_model="mlp", **kw)


# ------------------------------------------------------------ flow (field)


def test_torch_diffusion_energy():
    from torchregister_tpu.engines.flow import _diffusion_energy as jd

    f = np.random.default_rng(0).normal(size=(1, 3, 6, 7, 8)).astype(np.float32)
    assert float(_diffusion_energy(_t(f))) == pytest.approx(float(jd(jnp.asarray(f))),
                                                            rel=1e-6)


@pytest.mark.parametrize("warm", [False, True], ids=["zero_init", "warm_start"])
def test_torch_flow_register_sgd_matches_jax(pair, warm):
    """Field mode: losses, steps (plateau stop on the step's loss), the
    recovered field and the final warp."""
    mov, tgt = pair
    init = None
    if warm:
        init = (0.3 * np.random.default_rng(1).normal(size=(1, 3) + SHAPE)).astype(np.float32)
    kw = dict(lr=0.5, max_epochs=40, criterions=["mse", "ncc"], optimizer="sgd",
              flow_model="field", smooth=0.5, stop_rel=5e-3, patience=3, max_disp=4,
              check_disp=False)
    jw, jres = j_flow(jnp.asarray(mov), jnp.asarray(tgt),
                      init_params=None if init is None else jnp.asarray(init), **kw)
    tw, tres = t_flow(_t(mov), _t(tgt),
                      init_params=None if init is None else convert.field(init), **kw)
    assert tres.steps == int(jres.steps)
    assert tres.converged == bool(jres.converged)
    tl, jl = tres.losses.numpy(), np.asarray(jres.losses)
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    np.testing.assert_allclose(tl[:tres.steps], jl[:tres.steps], **LOSS_TOL)
    np.testing.assert_allclose(tres.flow.numpy(), np.asarray(jres.flow), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-3, atol=1e-4)
    assert float(tres.max_disp) == pytest.approx(float(jres.max_disp), rel=1e-3)


def test_torch_flow_register_bf16_images(pair):
    """``dtype='bfloat16'`` casts the image side only: the field stays f32.
    Loss trajectories agree to 3 % (bf16 sums and cotangents in JAX, f32
    sums rounded once here; see the rigid bf16 test)."""
    mov, tgt = pair
    kw = dict(lr=0.5, max_epochs=10, criterions=["mse", "ncc"], optimizer="sgd",
              flow_model="field", smooth=0.5, max_disp=4, dtype="bfloat16",
              check_disp=False)
    _, jres = j_flow(jnp.asarray(mov), jnp.asarray(tgt), **kw)
    _, tres = t_flow(_t(mov), _t(tgt), **kw)
    assert tres.flow.dtype == torch.float32
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=3e-2)


def test_torch_flow_register_warns_on_window_overflow(pair):
    mov, tgt = (_t(a) for a in pair)
    init = torch.full((1, 3) + SHAPE, 6.0)
    with pytest.warns(RuntimeWarning, match="max_disp=4"):
        t_flow(mov, tgt, lr=0.5, max_epochs=1, criterions=["mse"], optimizer="adam",
               flow_model="field", max_disp=4, init_params=init)
