"""The yardstick's counts, by hand."""
import pytest

from portbench import roofline

V240 = 240.0**3


def test_k1_flow_bytes_a_voxel():
    assert roofline.k1_flow(V240, 4, backward=False)[0] / V240 == 20.0
    assert roofline.k1_flow(V240, 4, backward=True, need_src=True)[0] / V240 == 36.0
    assert roofline.k1_flow(V240, 4, backward=True)[0] / V240 == 32.0  # no source gradient


def test_k1_affine_bytes_a_voxel():
    assert roofline.k1_affine(V240, 2, backward=False)[0] / V240 == 4.0  # bf16 in, out
    assert roofline.k1_affine(V240, 2, backward=True)[0] / V240 == 4.0  # g and src in


def test_k1_flow_least_time_at_240():
    """20 B a voxel of 240^3 at 3.35 TB/s: 0.0825 ms for the whole warp
    (PERF.md's K1 row bounds one pass, 12 B a voxel, at 0.050 ms)."""
    assert roofline.least_s(*roofline.k1_flow(V240, 4, False)) == pytest.approx(
        20 * V240 / 3.35e12)
    assert roofline.least_s(*roofline.k1_flow(V240, 4, False)) * 1e3 == pytest.approx(
        0.0825, abs=1e-4)


def test_cascade_levels_of_the_recipe():
    from portbench.run import _recipe
    from portbench import registry

    recipe = _recipe(registry.cell("field240.pairs")["config_data"])
    levels = roofline.cascade_levels(recipe, (240, 240, 240))
    assert levels == {"rigid/level0": (60**3, "affine", 2), "rigid/level1": (120**3, "affine", 2),
                      "affine/level0": (60**3, "affine", 2),
                      "affine/level1": (120**3, "affine", 2),
                      "flow/level0": (60**3, "flow", 4), "flow/level1": (120**3, "flow", 4),
                      "flow/level2": (240**3, "flow", 4)}
