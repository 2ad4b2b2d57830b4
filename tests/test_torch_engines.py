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

from torchregister_tpu.engines import common as jc
from torchregister_tpu.engines.affine import affine_register as j_affine
from torchregister_tpu.engines.flow import flow_register as j_flow
from torchregister_tpu.engines.rigid import rigid_register as j_rigid
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu_torch import convert
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
    p = [torch.zeros(2, requires_grad=True)]
    assert isinstance(tc.make_optimizer("SGD", p, 0.1), torch.optim.SGD)
    assert isinstance(tc.make_optimizer("adam", p, 0.1), torch.optim.Adam)
    with pytest.raises(NotImplementedError, match="item 10"):
        tc.make_optimizer("lm", p, 0.1)
    with pytest.raises(ValueError):
        tc.make_optimizer("rmsprop", p, 0.1)


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
    mov, tgt = (_t(a) for a in pair)
    with pytest.raises(NotImplementedError, match="item 10"):
        t_rigid(mov, tgt, criterions=["mse"], grad_edges=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        t_affine(mov, tgt, criterions=["mse"], grad_edges=True, method="exact")
    with pytest.raises(NotImplementedError, match="item 10"):
        t_rigid(mov, tgt, grad_edges=False)  # the default stack includes NMI
    with pytest.raises(NotImplementedError, match="item 11"):
        t_flow(mov, tgt, criterions=["mse"], flow_model="unet")


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
