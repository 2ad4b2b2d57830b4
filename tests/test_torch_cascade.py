"""The whole slice in f32: the port's ``register_cascade`` against the JAX
package's on the 24³ rigid and deformable-truth pairs, with ``bench.RECIPE``
reduced to 2 levels and 60/30/60 epochs and f32 matrix stages.

Both packages run Adam, whose update divides by the root of the squared
gradient: where the field has almost no gradient (flat background) the
~1e-7 rounding differences of the two frameworks become full-size steps.
So thetas are held to 1e-2, executed steps per stage to 2, the rigid gate to
0.5 points, the deformable gate to 0.5 points and the map errors to
0.05 voxel (measured here: 2.7e-3, 0, 0.12, 0.001 and 0.005).
"""
import numpy as np
import pytest
import torch

from _torch_cascade_case import SHAPE, assert_close, reduced_recipe, run_case
from torchregister_tpu_torch.engines.cascade import register_cascade


@pytest.fixture(scope="module")
def case():
    return run_case(reduced_recipe(matrix_dtype="float32"))


def test_torch_cascade_f32_matches_jax(case):
    assert_close(case, theta_atol=1e-2, steps_tol=2, rmse_tol=0.5, truth_rmse_tol=0.5,
                 vox_tol=0.05)


def test_torch_cascade_result_layout(case):
    """Shapes, finiteness, NaN padding of the loss histories and the
    per-level step record."""
    for res in case["torch"]["results"]:
        assert res.warped.shape == (1, 1) + SHAPE
        assert bool(torch.isfinite(res.warped).all())
        assert res.theta.shape == (1, 3, 4) and res.flow.shape == (1, 3) + SHAPE
        assert [len(res.steps[k]) for k in ("rigid", "affine", "flow")] == [2, 2, 2]
        for k in ("rigid", "affine", "flow"):
            losses = getattr(res, f"{k}_losses").numpy()
            assert int(np.sum(~np.isnan(losses))) == sum(res.steps[k])


@pytest.mark.parametrize("option,item", [
    (dict(flow_model="unet"), "item 11"),
    (dict(flow_depth=2), "item 11"),
    (dict(flow_compose=False), "item 11"),
    (dict(flow_remat=True), "item 11"),
    (dict(matrix_optimizer="lm"), "item 10"),
])
def test_torch_cascade_unported_options_raise(option, item):
    vol = torch.zeros((1, 1, 16, 16, 16))
    with pytest.raises(NotImplementedError, match=item):
        register_cascade(vol, vol, **dict(reduced_recipe(), **option))


def test_torch_cascade_rejects_bad_options():
    vol = torch.zeros((1, 1, 16, 16, 16))
    with pytest.raises(ValueError, match="moment_init"):
        register_cascade(vol, vol, **dict(reduced_recipe(), moment_init="PA"))
    with pytest.raises(ValueError, match="matrix_levels"):
        register_cascade(vol, vol, **dict(reduced_recipe(), matrix_levels=0))
    with pytest.raises(ValueError, match="final_warp"):
        register_cascade(vol, vol, **dict(reduced_recipe(), final_warp="blocked"))
    with pytest.raises(ValueError, match="flow_residual_disp"):
        register_cascade(vol, vol, **dict(reduced_recipe(), flow_rebase=True,
                                          flow_residual_disp=9))
