"""The whole slice in f32: the port's ``register_cascade`` against the JAX
package's on the 24³ rigid and deformable-truth pairs, with ``bench.RECIPE``
reduced to 2 levels and 60/30/60 epochs and f32 matrix stages.

Both packages run Adam, whose update divides by the root of the squared
gradient: where the field has almost no gradient (flat background) the
~1e-7 rounding differences of the two frameworks become full-size steps.
So thetas are held to 1e-2, executed steps per stage to 2, the rigid gate to
0.5 points, the deformable gate to 0.5 points and the map errors to
0.05 voxel (measured here: 2.7e-3, 0, 0.12, 0.001 and 0.005). The U-Net
options run under SGD on a 2D pair (their test says why), the LM matrix
optimizer on the same 2D pair (JAX's 3-D LM engines take minutes to compile
on a CPU).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_cascade_case import (SHAPE, assert_close, carry_jax_unet_init, reduced_recipe,
                                 run_case)
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


def _pair_2d(S):
    """Six Gaussian blobs and the same blobs moved by up to 1.5 pixels and
    widened by up to 10 %: a 2D pair both packages read from numpy."""
    rng = np.random.default_rng(4)
    g = np.meshgrid(*[np.linspace(-1, 1, S, dtype=np.float32)] * 2, indexing="ij")
    mov, tgt = np.zeros((S, S), np.float32), np.zeros((S, S), np.float32)
    for _ in range(6):
        c, w = rng.uniform(-0.5, 0.5, 2), rng.uniform(0.12, 0.3)
        d, k = rng.uniform(-1.5, 1.5, 2) * 2 / S, rng.uniform(1.0, 1.1)
        mov += np.exp(-((g[0] - c[0]) ** 2 + (g[1] - c[1]) ** 2) / (2 * w**2))
        tgt += np.exp(-((g[0] - c[0] - d[0]) ** 2 + (g[1] - c[1] - d[1]) ** 2)
                      / (2 * (k * w) ** 2))
    return mov[None, None], tgt[None, None]


# (edge, flow levels, epochs) where the U-Net fits and the option matters:
# 2 levels of 16² and 32² (depth 1) for the composition and its warm-start
# alternative, one 96² level for an explicit depth below the default (3),
# one 24² level for remat. Without composition the net keeps its random
# head (a first loss of 6.4, not 0.4), whose flow reaches far past the
# window: the frameworks' rounding grows about tenfold a step from step 5
# (2.5 % apart by step 7), so that case runs 4 + 2 steps.
UNET_CASES = {"flow_model": (32, 2, 12), "flow_depth": (96, 1, 12),
              "flow_compose": (32, 2, 6), "flow_remat": (24, 1, 12)}


@pytest.mark.parametrize("option,item", [
    (dict(flow_model="unet"), "item 11"),
    (dict(flow_depth=2), "item 11"),
    (dict(flow_compose=False), "item 11"),
    (dict(flow_remat=True), "item 11"),
    pytest.param(dict(matrix_optimizer="lm"), "item 14", id="option4-item 10"),
])
def test_torch_cascade_unported_options_raise(option, item, monkeypatch):
    """The options of ROADMAP queue 1 items 11 and 14, each held against the
    JAX package's cascade on a 2D pair. The U-Net options (item 11): U-Net
    flow stage only, SGD at lr 0.01, every fresh network starting from JAX's
    initial weights for the seed: the executed steps, every loss within the
    engines' tolerance (rtol 1e-3, atol 3e-4: NCC's alpha turns the
    frameworks' f32 rounding into ~1e-4) and the flow within 1e-2 of its
    largest value. The LM matrix optimizer (item 14): the matrix stages of
    the reduced recipe (f32) with ``benchmarks/tune_lm.py``'s LM settings:
    the steps of each stage and level equal; each level starts from the
    identity, where every coordinate is an integer, a kink of linear
    interpolation at which the packages take different one-sided
    derivatives, so the trajectories differ by up to ~0.3 % before they
    meet: losses within 1e-2, the composed theta within 2e-3 (measured
    3.2e-3 relative and 6.3e-4)."""
    from torchregister_tpu.engines.cascade import register_cascade as j_cascade

    if item == "item 14":
        mov, tgt = _pair_2d(48)
        recipe = {**reduced_recipe(matrix_dtype="float32", rigid_epochs=24, affine_epochs=16,
                                   matrix_patience=3, matrix_stop_rel=1e-3),
                  "stages": ("rigid", "affine"), **option}
        jres = j_cascade(jnp.asarray(mov), jnp.asarray(tgt), **recipe)
        tres = register_cascade(torch.from_numpy(mov), torch.from_numpy(tgt), **recipe)
        for k in ("rigid", "affine"):
            jl, tl = np.asarray(getattr(jres, f"{k}_losses")), getattr(tres, f"{k}_losses").numpy()
            np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))  # steps of each level
            np.testing.assert_allclose(tl, jl, rtol=1e-2)
        assert sum(tres.steps["rigid"]) < recipe["rigid_epochs"]  # LM's plateau stop
        np.testing.assert_allclose(tres.theta.numpy(), np.asarray(jres.theta), atol=2e-3)
        return

    carry_jax_unet_init(monkeypatch)
    S, levels, epochs = UNET_CASES[next(iter(option))]
    mov, tgt = _pair_2d(S)
    recipe = {**dict(stages=("flow",), flow_model="unet", flow_levels=levels,
                     flow_epochs=epochs, flow_lr=0.01, optimizer="sgd", n=16,
                     criterions=("mse", "ncc"), flow_max_disp=4), **option}
    jres = j_cascade(jnp.asarray(mov), jnp.asarray(tgt), **recipe)
    tres = register_cascade(torch.from_numpy(mov), torch.from_numpy(tgt), **recipe)
    jl, tl = np.asarray(jres.flow_losses), tres.flow_losses.numpy()
    assert len(tres.steps["flow"]) == levels and sum(tres.steps["flow"]) == epochs
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=3e-4)
    assert np.nanmin(jl) < 0.99 * jl[0]  # the networks trained
    scale = float(np.max(np.abs(np.asarray(jres.flow))))
    np.testing.assert_allclose(tres.flow.numpy(), np.asarray(jres.flow), rtol=0,
                               atol=1e-2 * scale)


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
    with pytest.raises(ValueError, match="flow_rebase=True requires"):
        register_cascade(vol, vol, **dict(reduced_recipe(), flow_rebase=True,
                                          flow_model="unet"))
    with pytest.raises(ValueError, match="flow_model"):
        register_cascade(vol, vol, **dict(reduced_recipe(), flow_model="mlp"))
