"""The cascade options of the user surface against the JAX package, on the
CPU: ``final_warp='exact'`` (the CLI's), the principal-axes init
``moment_init='pa'`` and the residual rebase ``flow_rebase=True``, in one run
of the reduced recipe of ``tests/_torch_cascade_case.py`` on both 24³ pairs
(f32 matrix stages).

Thetas, steps and map errors are held to ``tests/test_torch_cascade.py``'s
tolerances. The image RMSE reductions are held to 1 point, not 0.5 (measured
here: 0.12 and 0.62; 2.8 for the rigid pair without the rebase): Adam moves
the field in flat background by near-full steps whatever the gradient, so the
two frameworks' fields differ there by up to ~3.5 voxels, and the exact final
warp samples wherever such a field points (the separable warp zeroes what
lies beyond its window). The exact warp itself is held to 1e-5 on the JAX
run's own (theta, flow).

The blob pairs' principal axes are too close to isotropic for a rotation, so
``'pa'`` falls back to the centre of mass there (with its wider coarse
window); the rotation branch is held on a volume of four blobs below.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_cascade_case import SHAPE, assert_close, reduced_recipe, run_case
from torchregister_tpu.ops import moments as jm
from torchregister_tpu_torch.ops import moments as tm
from torchregister_tpu_torch.ops.blocked import warp_affine_fast, warp_flow_fast
from torchregister_tpu_torch.ops.resample import warp_affine
from torchregister_tpu_torch.ops.transforms import rigid_theta

OPTIONS = dict(matrix_dtype="float32", final_warp="exact", moment_init="pa",
               flow_rebase=True, flow_residual_disp=3)


@pytest.fixture(scope="module")
def case():
    return run_case(reduced_recipe(**OPTIONS))


def test_torch_cascade_exact_pa_rebase_match_jax(case):
    assert_close(case, theta_atol=1e-2, steps_tol=2, rmse_tol=1.0, truth_rmse_tol=1.0,
                 vox_tol=0.05)


def test_torch_cascade_exact_final_warp_matches_jax_on_its_transform(case):
    """K2's warps (the plain version here) of the JAX run's returned (theta,
    flow) against the JAX run's own exact output."""
    from torchregister_tpu_torch import synthetic

    pairs = (synthetic.make_pair(SHAPE), synthetic.make_flow_truth_pair(SHAPE))
    for jres, (mov, *_) in zip(case["jax"]["results"], pairs):
        got = warp_flow_fast(warp_affine_fast(torch.tensor(np.asarray(jres.theta)), mov),
                             torch.tensor(np.asarray(jres.flow)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jres.warped), rtol=1e-5,
                                   atol=1e-5)


def test_torch_cascade_exact_final_warp_is_the_apply_path(case):
    """The exact cascade's output is K2's affine warp then K2's flow warp of
    the moving image by the returned (theta, flow), to the bit: what the CLI's
    ``apply`` computes from the saved transform."""
    from torchregister_tpu_torch import synthetic

    pairs = (synthetic.make_pair(SHAPE), synthetic.make_flow_truth_pair(SHAPE))
    for res, (mov, *_) in zip(case["torch"]["results"], pairs):
        again = warp_flow_fast(warp_affine_fast(res.theta, mov), res.flow)
        torch.testing.assert_close(res.warped, again, rtol=0, atol=0)
        assert [len(res.steps[k]) for k in ("rigid", "affine", "flow")] == [2, 2, 2]


def _four_blobs(shape=(24, 26, 28)):
    """Four blobs of different sizes, not coplanar: distinct principal axes
    (relative eigengaps 0.13 and 0.56) and skew on each (>= 0.2 of lam^1.5)."""
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    vol = np.zeros(shape, np.float32)
    for c, w, a in (((-0.4, -0.1, -0.3), 0.2, 1.0), ((0.1, 0.4, 0.0), 0.14, 0.7),
                    ((0.4, -0.3, 0.4), 0.1, 0.5), ((0.2, 0.1, -0.4), 0.1, 0.6)):
        vol += a * np.exp(-sum((gi - ci) ** 2 for gi, ci in zip(g, c)) / (2 * w ** 2))
    return vol[None, None]


def test_torch_pa_rigid_params_rotation_branch_matches_jax():
    mov = _four_blobs()
    theta = rigid_theta(torch.tensor([0.2, -0.15, 0.1, 0.1, -0.05, 0.02]))
    tgt = warp_affine(theta[None], torch.from_numpy(mov)).numpy()
    want = np.asarray(jm.pa_rigid_params(jnp.asarray(mov), jnp.asarray(tgt)))
    got = tm.pa_rigid_params(torch.from_numpy(mov), torch.from_numpy(tgt)).numpy()
    assert np.abs(want[:3]).max() > 0.1  # the rotation branch, not the CoM fallback
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    for a, b in zip(tm.coordinate_moments(torch.from_numpy(mov)),
                    jm.coordinate_moments(jnp.asarray(mov))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    m2, t2 = mov[:, :, 12], tgt[:, :, 12]
    np.testing.assert_allclose(
        tm.pa_rigid_params(torch.from_numpy(m2), torch.from_numpy(t2)).numpy(),
        np.asarray(jm.pa_rigid_params(jnp.asarray(m2), jnp.asarray(t2))), rtol=1e-3,
        atol=1e-4)
