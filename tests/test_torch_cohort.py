"""The port's cohort registration (``parallel/cohort.register_cohort``) against
the JAX package's (no mesh) and against the port's own single-pair engines,
on the CPU.

The JAX cases are the unsharded ones of ``tests/test_parallel.py`` on the same
numpy pairs. Per pair, the executed steps are equal and the losses within
``tests/test_torch_engines.py``'s tolerance (rtol 1e-3 / atol 3e-4). Those
cases run Adam, whose
steps turn the frameworks' ~1e-7 gradient rounding into full-size moves of a
parameter whose gradient is near zero (the port's single-pair engine differs
from JAX's by as much), so there thetas and fields are held to the Adam
tolerance of ``tests/test_torch_cascade.py``: 1e-2 (of the field's largest
value for fields). Under SGD (rigid, and the field mode, pairs that stop at
different steps) the cohort is held to ``tests/test_torch_engines.py``'s
tolerances: thetas and the parameter history to atol 1e-4, the field to
rtol 1e-3 / atol 1e-4. Against the port's own
single-pair run each pair takes the same steps and equals it to the bit: each
criterion runs on each pair's own slice (``losses.per_pair``), and every
other op of a step is elementwise or per pair.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchregister_tpu_torch as tr
from torchregister_tpu.ops.resample import warp_affine as j_warp_affine
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu.parallel.cohort import register_cohort as j_register_cohort
from torchregister_tpu_torch.engines.common import check_sweep_windows_batch
from torchregister_tpu_torch.engines.flow import flow_register
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.parallel.cohort import register_cohort

LOSS_TOL = dict(rtol=1e-3, atol=3e-4)
SELF_TOL = dict(rtol=0, atol=0)  # to the bit
ADAM_ATOL = 1e-2


def _close_field(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL * float(np.abs(want).max()))


def _blobs(batch, shape, seed=0):
    """``tests/test_parallel.py``'s blobs, numpy ``[B, 1, *S]``."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    vols = []
    for _ in range(batch):
        vol = np.zeros(shape, np.float32)
        for _ in range(4):
            c = rng.uniform(-0.4, 0.4, len(shape))
            w = rng.uniform(0.15, 0.3)
            vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2))
        vols.append(vol)
    return np.stack(vols)[:, None]


def _same_losses(got, want):
    """A pair's losses against its single-pair run's, NaN padding included."""
    np.testing.assert_allclose(got, want, **SELF_TOL)


def _both(movings, targets, **kw):
    jres = j_register_cohort(jnp.asarray(movings), jnp.asarray(targets), **kw)
    tres = register_cohort(torch.from_numpy(movings), torch.from_numpy(targets), **kw)
    return jres, tres


def _check_steps_and_losses(jres, tres):
    jsteps = [int(s) for s in np.asarray(jres.steps)]
    assert tres.steps == jsteps
    jl, tl = np.asarray(jres.losses), tres.losses.numpy()
    for b, n in enumerate(jsteps):
        np.testing.assert_allclose(tl[b, :n], jl[b, :n], **LOSS_TOL)
        assert np.isnan(tl[b, n:]).all()


def _rigid_case():
    movings = _blobs(3, (20, 20))
    thetas = [j_rigid_theta(jnp.asarray(p, jnp.float32))[None]
              for p in ([0.05, 0.1, 0.0], [-0.04, 0.0, 0.08], [0.02, -0.06, 0.03])]
    targets = np.concatenate([np.asarray(j_warp_affine(t, jnp.asarray(movings[i:i + 1])))
                              for i, t in enumerate(thetas)])
    return movings, targets, np.stack([np.asarray(t) for t in thetas])


RIGID_KW = dict(mode="rigid", lr=5e-3, epochs=120, criterions=["mse"], optimizer="adam",
                init="identity")


def test_torch_cohort_rigid_matches_jax_and_per_pair():
    """``tests/test_parallel.py:33``: 3 pairs at 20², each recovers its own
    rigid transform, as the JAX cohort does, and each equals the port's
    single-pair ``rigid_register``."""
    movings, targets, truth = _rigid_case()
    jres, tres = _both(movings, targets, **RIGID_KW)
    assert tres.best_theta.shape == (3, 1, 2, 3)
    _check_steps_and_losses(jres, tres)
    np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                               atol=ADAM_ATOL)
    np.testing.assert_allclose(tres.best_theta.numpy(), truth, atol=0.06)
    for b in range(3):
        _, solo = rigid_register(torch.from_numpy(movings[b:b + 1]),
                                 torch.from_numpy(targets[b:b + 1]), lr=5e-3, epochs=120,
                                 criterions=["mse"], optimizer="adam", init="identity",
                                 grad_edges=False)
        assert solo.steps == tres.steps[b]
        np.testing.assert_allclose(tres.best_theta[b].numpy(), solo.best_theta.numpy(),
                                   **SELF_TOL)
        _same_losses(tres.losses[b].numpy(), solo.losses.numpy())


def test_torch_cohort_grad_edges_per_sample():
    """``tests/test_parallel.py:157``: a 100x pair beside pair 0 changes
    nothing of pair 0, which equals its registration alone (the edge
    filter's min-max normalization is per pair)."""
    m0, t0 = _blobs(1, (16, 16), seed=11), _blobs(1, (16, 16), seed=12)
    movings = np.concatenate([m0, 100.0 * _blobs(1, (16, 16), seed=13)])
    targets = np.concatenate([t0, 100.0 * _blobs(1, (16, 16), seed=14)])
    kw = dict(lr=1e-3, epochs=8, criterions=["mse"], optimizer="adam")
    jres, tres = _both(movings, targets, mode="rigid", grad_edges=True, init="identity", **kw)
    _check_steps_and_losses(jres, tres)
    np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                               atol=ADAM_ATOL)
    _, solo = rigid_register(torch.from_numpy(m0), torch.from_numpy(t0), grad_edges=True,
                             init="identity", **kw)
    np.testing.assert_allclose(tres.best_theta[0].numpy(), solo.best_theta.numpy(), **SELF_TOL)


def test_torch_cohort_affine_matches_jax():
    """``tests/test_parallel.py:77``'s unsharded cohort (affine, 8 pairs at
    12²)."""
    movings, targets = _blobs(8, (12, 12), seed=3), _blobs(8, (12, 12), seed=4)
    jres, tres = _both(movings, targets, mode="affine", lr=1e-3, epochs=15,
                       criterions=["mse"], optimizer="adam")
    assert tres.best_theta.shape == (8, 1, 2, 3)
    _check_steps_and_losses(jres, tres)
    np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                               atol=ADAM_ATOL)


def test_torch_cohort_flow_defaults_match_jax():
    """``tests/test_parallel.py:191``: the default flow cohort is the field
    model under Adam at lr 0.3 with smooth 0.5, and it moves the loss."""
    movings = _blobs(2, (16, 16), seed=21)
    targets = np.roll(movings, -1, axis=2)
    jres, tres = _both(movings, targets, mode="flow", epochs=40, criterions=["mse"], max_disp=3)
    assert tres.flow.shape == (2, 1, 2, 16, 16)
    _check_steps_and_losses(jres, tres)
    _close_field(tres.flow.numpy(), np.asarray(jres.flow))
    losses = tres.losses.numpy()
    last = losses[np.arange(2), np.asarray(tres.steps) - 1]
    assert (last < 0.5 * losses[:, 0]).all()


FIELD_KW = dict(mode="flow", lr=0.5, epochs=120, criterions=["mse"], optimizer="adam",
                flow_model="field", smooth=0.2, max_disp=4, stop_rel=1e-4, patience=40)


def _field_case():
    """``tests/test_parallel.py:208``'s pairs, and a third whose target is
    its moving image: its loss starts at 0, under ``stop_crit``, so it stops
    after one step."""
    movings = _blobs(3, (24, 24), seed=7)
    targets = np.roll(movings, -2, axis=2)
    targets[2] = movings[2]
    return movings, targets


def test_torch_cohort_field_mode_stops_each_pair_on_its_own():
    """Field mode with ``stop_rel``: each pair stops at its own step, the
    same step as under the JAX cohort and as in its single-pair run, and
    the shifted pairs recover their ~2-voxel displacement."""
    movings, targets = _field_case()
    jres, tres = _both(movings, targets, **FIELD_KW)
    assert len(set(tres.steps)) > 1, tres.steps
    _check_steps_and_losses(jres, tres)
    _close_field(tres.flow.numpy(), np.asarray(jres.flow))
    assert tres.converged == [bool(c) for c in np.asarray(jres.converged)]
    _close_field(tres.max_disp.numpy(), np.asarray(jres.max_disp))
    interior = tres.flow.numpy()[:2, 0, 0, 8:-8, 8:-8]
    assert abs(interior.mean() - 2.0) < 0.5
    kw = {k: v for k, v in FIELD_KW.items() if k not in ("mode", "epochs")}
    for b in range(3):
        _, solo = flow_register(torch.from_numpy(movings[b:b + 1]),
                                torch.from_numpy(targets[b:b + 1]), max_epochs=120, **kw)
        assert solo.steps == tres.steps[b]
        np.testing.assert_allclose(tres.flow[b].numpy(), solo.flow.numpy(), **SELF_TOL)
        _same_losses(tres.losses[b].numpy(), solo.losses.numpy())


def test_torch_cohort_matrix_plateau_stops_each_pair_on_its_own():
    """The matrix engines' plateau stop per pair: pairs that stop at
    different steps, each the step of its single-pair run."""
    movings, targets, _ = _rigid_case()
    targets = targets.copy()
    targets[1] = movings[1] + 0.05  # an offset no transform removes: an early plateau
    kw = dict(lr=5e-3, epochs=120, criterions=["mse"], optimizer="adam", init="identity",
              stop_rel=1e-3, patience=10)
    jres, tres = _both(movings, targets, mode="rigid", **kw)
    assert len(set(tres.steps)) > 1, tres.steps
    _check_steps_and_losses(jres, tres)
    np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                               atol=ADAM_ATOL)
    for b in range(3):
        _, solo = rigid_register(torch.from_numpy(movings[b:b + 1]),
                                 torch.from_numpy(targets[b:b + 1]), grad_edges=False, **kw)
        assert solo.steps == tres.steps[b]
        np.testing.assert_allclose(tres.best_theta[b].numpy(), solo.best_theta.numpy(),
                                   **SELF_TOL)


SGD_CASES = {
    "rigid": dict(mode="rigid", lr=0.1, epochs=120, criterions=["mse"], optimizer="sgd",
                  init="identity", stop_rel=1e-3, patience=5),
    "field": dict(mode="flow", lr=5.0, epochs=80, criterions=["mse"], optimizer="sgd",
                  flow_model="field", smooth=0.2, max_disp=4, stop_rel=1e-2, patience=3),
}


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_torch_cohort_sgd_matches_jax_at_the_engines_tolerances(case):
    """SGD, pairs that stop at different steps (rigid: a plateau at step 6
    beside two runs to the epoch limit; field: a plateau, the epoch limit
    and ``stop_crit`` after one step): steps equal to JAX's, losses at
    LOSS_TOL, thetas and the parameter history (rigid) or the field within
    ``tests/test_torch_engines.py``'s tolerances, and each pair equal to its
    single-pair run to the bit."""
    kw = SGD_CASES[case]
    if case == "rigid":
        movings, targets, _ = _rigid_case()
        targets = targets.copy()
        targets[1] = movings[1] + 0.05  # an offset no transform removes: an early plateau
    else:
        movings, targets = _field_case()
    jres, tres = _both(movings, targets, **kw)
    assert len(set(tres.steps)) > 1, tres.steps
    _check_steps_and_losses(jres, tres)
    single = {k: v for k, v in kw.items() if k not in ("mode", "epochs")}
    if case == "rigid":
        np.testing.assert_allclose(tres.best_theta.numpy(), np.asarray(jres.best_theta),
                                   atol=1e-4)
        jh = np.asarray(jres.param_history)
        for b, n in enumerate(tres.steps):
            np.testing.assert_allclose(tres.param_history[b, :n].numpy(), jh[b, :n], atol=1e-4)
    else:
        np.testing.assert_allclose(tres.flow.numpy(), np.asarray(jres.flow), rtol=1e-3,
                                   atol=1e-4)
        assert tres.converged == [bool(c) for c in np.asarray(jres.converged)]
    for b in range(3):
        m, t = torch.from_numpy(movings[b:b + 1]), torch.from_numpy(targets[b:b + 1])
        if case == "rigid":
            _, solo = rigid_register(m, t, epochs=kw["epochs"], grad_edges=False, **single)
            got, want = tres.best_theta[b], solo.best_theta
        else:
            _, solo = flow_register(m, t, max_epochs=kw["epochs"], **single)
            got, want = tres.flow[b], solo.flow
        assert solo.steps == tres.steps[b]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SELF_TOL)
        _same_losses(tres.losses[b].numpy(), solo.losses.numpy())


def test_torch_cohort_default_criteria_equal_single_runs():
    """``criterions=None`` is MSE + NCC + NMI: each pair's NMI samples its
    own range and takes its own density path, so each pair takes the steps
    of its single-pair run and equals it to the bit."""
    movings, targets, _ = _rigid_case()
    targets = targets.copy()
    targets[1] = movings[1] + 0.05
    kw = dict(lr=1e-4, epochs=12, optimizer="sgd", init="identity", stop_rel=1e-3,
              patience=3)
    tres = register_cohort(torch.from_numpy(movings), torch.from_numpy(targets),
                           mode="rigid", **kw)
    for b in range(3):
        _, solo = rigid_register(torch.from_numpy(movings[b:b + 1]),
                                 torch.from_numpy(targets[b:b + 1]), grad_edges=False, **kw)
        assert solo.steps == tres.steps[b]
        np.testing.assert_allclose(tres.best_theta[b].numpy(), solo.best_theta.numpy(),
                                   **SELF_TOL)
        _same_losses(tres.losses[b].numpy(), solo.losses.numpy())


def test_torch_cohort_arrays_go_to_the_card():
    """Inputs that are not tensors run on the card, as the JAX package's do
    on its accelerator: without one they raise (CPU tensors run on the
    CPU)."""
    movings = _blobs(2, (16, 16))
    if torch.cuda.is_available():
        res = register_cohort(movings, movings, mode="rigid", epochs=1, criterions=["mse"])
        assert res.best_theta.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_cohort(movings, movings, mode="rigid", epochs=1, criterions=["mse"])


def test_torch_cohort_validation():
    """``tests/test_parallel.py:304``: unknown and misplaced inits raise."""
    movings = torch.zeros((2, 1, 16, 16))
    with pytest.raises(ValueError, match="init must be"):
        register_cohort(movings, movings, mode="rigid", epochs=1, criterions=["mse"],
                        init="Identity")
    with pytest.raises(ValueError, match="only meaningful"):
        register_cohort(movings, movings, mode="affine", epochs=1, criterions=["mse"],
                        init="random")
    with pytest.raises(ValueError, match="unknown mode"):
        register_cohort(movings, movings, mode="spline", epochs=1, criterions=["mse"])


def test_torch_cohort_refuses_a_mesh_and_a_unet_batch():
    """A mesh raises. A U-Net cohort, which the port refused before it had
    K3 with a weight set per pair, runs: each pair trains its own net, drawn
    pair after pair from ``seed``, and equals ``flow_register`` on that pair
    alone with the same draws to the bit (its parity with the JAX package's
    cohort: ``tests/test_torch_cohort_unet_jax.py``)."""
    movings = torch.from_numpy(_blobs(2, (16, 16)))
    targets = torch.from_numpy(_blobs(2, (16, 16), seed=1))
    with pytest.raises(ValueError, match="mesh is not supported"):
        register_cohort(movings, movings, mode="rigid", mesh=object(), epochs=1)
    res = register_cohort(movings, targets, mode="flow", flow_model="unet", epochs=2,
                          criterions=["mse"], n=32, depth=1, seed=3)
    assert res.flow.shape == (2, 1, 2, 16, 16) and res.steps == [2, 2]
    assert all(v.shape[0] == 2 for v in res.params.values())
    gen = torch.Generator().manual_seed(3)
    for b in range(2):
        _, solo = flow_register(movings[b:b + 1], targets[b:b + 1], lr=1e-5, max_epochs=2,
                                criterions=["mse"], n=32, depth=1, generator=gen)
        torch.testing.assert_close(res.flow[b], solo.flow, **SELF_TOL)
        _same_losses(res.losses[b].numpy(), solo.losses.numpy())
    with pytest.raises(ValueError, match="mesh and spatial_axis"):
        tr.make_cascade_batch_fn(spatial_axis=0, stages=("rigid",))
    assert tr.register_cohort is register_cohort


def test_torch_cohort_random_init_from_a_generator():
    """``init='random'`` draws each pair's params from ``seed`` (an int or
    a ``torch.Generator``): the same draws for the same seed."""
    movings = torch.from_numpy(_blobs(2, (16, 16)))
    kw = dict(mode="rigid", epochs=2, criterions=["mse"], init="random", optimizer="adam",
              lr=1e-3)
    a = register_cohort(movings, movings, seed=3, **kw)
    b = register_cohort(movings, movings, seed=torch.Generator().manual_seed(3), **kw)
    torch.testing.assert_close(a.param_history[:, 0], b.param_history[:, 0], rtol=0, atol=0)
    assert not torch.equal(a.param_history[0, 0], a.param_history[1, 0])


def test_torch_check_sweep_windows_batch_names_the_pairs():
    """One warning naming each pair whose theta outgrew the windows; none
    when every pair fits."""
    spatial = (32, 32)
    ok = np.asarray(j_rigid_theta(jnp.asarray([0.02, 0.01, 0.0], jnp.float32)))
    far = np.asarray(j_rigid_theta(jnp.asarray([0.1, 0.9, 0.0], jnp.float32)))
    thetas = torch.from_numpy(np.stack([ok, far, ok, far])[:, None])
    with pytest.warns(RuntimeWarning, match=r"2 of 4 recovered transforms.*#1 needs.*#3 needs"):
        check_sweep_windows_batch(thetas, spatial, None, "register_cohort (rigid)")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_sweep_windows_batch(thetas[[0, 2]], spatial, None, "register_cohort (rigid)")


def test_torch_cohort_driver_on_the_cpu():
    """``python -m torchregister_tpu_torch.cohort_driver --device cpu``: the
    JAX driver's synthetic cohort and exit check, in 2-D and 3-D."""
    from torchregister_tpu_torch import cohort_driver

    assert cohort_driver.main(["--device", "cpu", "--batch", "3", "--epochs", "200"]) == 0
    assert cohort_driver.main(["--device", "cpu", "--batch", "2", "--size", "16", "--ndim",
                               "3", "--epochs", "150"]) == 0
