"""The port's ``make_cascade_fn`` against its own ``register_cascade`` and
the JAX package's factory, on the CPU.

On the CPU the factory runs the cascade's loops without graphs, so its
results must equal ``register_cascade``'s to the bit. Against the JAX
package's single-program cascade (``tests/test_cascade_pyramid.py``'s
config on the same numpy pair) theta is held to the tolerance of
``tests/test_torch_cascade.py``, 1e-2, and the executed steps per stage to
2: both run Adam, whose rounding differs between the frameworks; the
default criteria (NMI included, its branch picked on the device) against
the JAX factory given the same stack, steps per stage and level. The LM
matrix optimizer runs through every cascade entry point (``CascadeConfig``,
the factories), each equal to ``register_cascade`` to the bit.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchregister_tpu_torch as tr
from torchregister_tpu.engines.cascade import make_cascade_fn as j_make_cascade_fn
from torchregister_tpu_torch import synthetic
from torchregister_tpu_torch.engines import cascade
from torchregister_tpu_torch.engines.cascade import make_cascade_fn, register_cascade

# tests/test_cascade_pyramid.py's single-program case
CFG = dict(stages=("rigid", "affine"), levels=2, rigid_epochs=30, rigid_lr=3e-3,
           affine_epochs=20, affine_lr=1e-3, criterions=("mse",), optimizer="adam")
# CFG's matrix budgets per level (the cascade's geometric split of 30 and 20)
BUDGETS = {"rigid": (20, 10), "affine": (13, 7)}
# NMI at a patch of 8 (the default, 100, resizes every input to 200^d)
NMI8 = tr.get_criterion("nmi", patch_size=8)
# the recipe reduced as in tests/_torch_cascade_case.py, at 16³
RECIPE = {**synthetic.RECIPE, "rigid_epochs": 60, "affine_epochs": 30, "flow_epochs": 60,
          "levels": 2, "matrix_levels": 2, "flow_levels": 2, "flow_smooth": (0.5, 0.25)}


def _blob(shape, seed):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    vol = np.zeros(shape, np.float32)
    for _ in range(6):
        c = rng.uniform(-0.4, 0.4, len(shape))
        w = rng.uniform(0.15, 0.35)
        vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2))
    return vol[None, None]


def _same(a, b) -> bool:
    """Equal to the bit, NaN padding included."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.int32),
                                b.contiguous().view(torch.int32)))
    return a == b


def test_torch_cascade_fn_is_cached_on_its_config():
    fn = make_cascade_fn(**CFG)
    assert make_cascade_fn(**CFG) is fn
    assert make_cascade_fn(**dict(reversed(list(CFG.items())))) is fn
    assert make_cascade_fn(**{**CFG, "rigid_epochs": 31}) is not fn
    assert tr.make_cascade_fn is make_cascade_fn


@pytest.mark.parametrize("case", ["matrix_2d", "recipe_3d"])
def test_torch_cascade_fn_equals_register_cascade(case):
    if case == "matrix_2d":
        cfg, (m, t) = CFG, (torch.from_numpy(_blob((32, 32), s)) for s in (3, 4))
    else:
        cfg, (m, t) = RECIPE, synthetic.make_flow_truth_pair((16, 16, 16))[:2]
    got = make_cascade_fn(**cfg)(m, t)
    want = register_cascade(m, t, **cfg)
    for name in want._fields:
        assert _same(getattr(got, name), getattr(want, name)) or (
            name.endswith("losses") and getattr(want, name) is None), name
    if case == "recipe_3d":
        assert [len(got.steps[k]) for k in ("rigid", "affine", "flow")] == [2, 2, 2]


def test_torch_cascade_fn_matches_jax_factory():
    m, t = _blob((32, 32), 3), _blob((32, 32), 4)
    jres = j_make_cascade_fn(**CFG)(jnp.asarray(m), jnp.asarray(t))
    tres = make_cascade_fn(**CFG)(torch.from_numpy(m), torch.from_numpy(t))
    np.testing.assert_allclose(tres.theta.numpy(), np.asarray(jres.theta), atol=1e-2)
    for stage in ("rigid", "affine"):
        j_steps = int(np.sum(~np.isnan(np.asarray(getattr(jres, f"{stage}_losses")))))
        assert abs(sum(tres.steps[stage]) - j_steps) <= 2, (stage, tres.steps, j_steps)


def test_torch_cascade_config_jitted_is_the_factory():
    cfg = tr.CascadeConfig(**CFG)
    fn = cfg.jitted()
    assert cfg.jitted() is fn
    assert fn is make_cascade_fn(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)})
    assert cfg.jitted(rigid_epochs=7) is cfg.jitted(rigid_epochs=7) is not fn
    assert fn.config["rigid_epochs"] == 30


@pytest.mark.parametrize("spec", [dict(criterions=("mse", NMI8)), dict(criterions=None),
                                  dict(flow_criterions=("NMI",))],
                         ids=["criterions", "default_stack", "flow_criterions"])
def test_torch_cascade_fn_takes_nmi(spec):
    """NMI picks its KDE branch on the device, so the factory takes every
    NMI criterion, the default stack included, and equals
    ``register_cascade`` to the bit (the default stack at shorter budgets:
    its NMI resizes each input to 200²)."""
    cfg = {**CFG, **spec}
    if spec.get("criterions", ()) is None:
        cfg.update(rigid_epochs=8, affine_epochs=6)
    m, t = (torch.from_numpy(_blob((32, 32), s)) for s in (3, 4))
    got = make_cascade_fn(**cfg)(m, t)
    assert make_cascade_fn(**cfg) is cascade._CASCADE_CACHE[tuple(sorted(cfg.items()))]
    want = register_cascade(m, t, **cfg)
    assert got.steps == want.steps
    for name in ("warped", "theta", "rigid_losses", "affine_losses"):
        assert _same(getattr(got, name), getattr(want, name)), name


def _level_steps(losses, budgets):
    """Executed steps per level of a stage's NaN-padded losses."""
    losses = np.asarray(losses)
    bounds = np.cumsum((0,) + budgets)
    return [int(np.sum(~np.isnan(losses[a:b]))) for a, b in zip(bounds[:-1], bounds[1:])]


def test_torch_cascade_fn_default_stack_matches_jax_factory():
    """The default stack through the factory, against the JAX package's
    jitted factory given the same stack as a list (its cascade takes no
    ``None``): MSE + NCC(100) + NMI(1000) at weights 0.33, with a plateau
    stop, on a shifted copy. Steps per stage and level within 2, theta
    within 1e-2 (the tolerances of the factory parity test above)."""
    cfg = {**CFG, "rigid_lr": 1e-2, "affine_lr": 3e-3, "matrix_stop_rel": 1e-3,
           "matrix_patience": 3}
    m = _blob((32, 32), 3)
    t = np.roll(m, (2, -1), axis=(-2, -1))
    jres = j_make_cascade_fn(**{**cfg, "criterions": ("mse", "ncc", "nmi"),
                                "weights": (0.33,) * 3})(jnp.asarray(m), jnp.asarray(t))
    tres = make_cascade_fn(**{**cfg, "criterions": None})(torch.from_numpy(m),
                                                          torch.from_numpy(t))
    np.testing.assert_allclose(tres.theta.numpy(), np.asarray(jres.theta), atol=1e-2)
    for stage, budgets in BUDGETS.items():
        losses = getattr(jres, f"{stage}_losses")
        assert losses.shape == (sum(budgets),)
        j_steps = _level_steps(losses, budgets)
        assert _level_steps(getattr(tres, f"{stage}_losses").numpy(), budgets) == (
            tres.steps[stage])
        assert all(abs(a - b) <= 2 for a, b in zip(tres.steps[stage], j_steps)), (
            stage, tres.steps, j_steps)
    assert sum(tres.steps["rigid"]) < sum(BUDGETS["rigid"])  # the stop ended a level


def test_torch_lm_cascade_entry_points_agree():
    """``matrix_optimizer='lm'`` through ``CascadeConfig.run``/``.jitted``
    and ``make_cascade_fn`` equals ``register_cascade`` to the bit (on the
    CPU the factory runs the same loops without graphs), and
    ``make_cascade_batch_fn`` gives each of 2 pairs its single run to the
    bit; the LM stop ends each matrix level early."""
    from torchregister_tpu_torch.config import CascadeConfig
    from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn

    recipe = dict(stages=("rigid", "affine"), levels=2, rigid_epochs=16, affine_epochs=10,
                  criterions=("mse", "ncc"), matrix_optimizer="lm", matrix_patience=3,
                  matrix_stop_rel=1e-3, residual_shift=4)
    movs = [torch.from_numpy(_blob((32, 32), 30 + b)) for b in range(2)]
    tgts = [torch.roll(m, (1, -1), dims=(-2, -1)) for m in movs]
    want = register_cascade(movs[0], tgts[0], **recipe)
    cfg = CascadeConfig(**recipe)
    for got in (cfg.run(movs[0], tgts[0]), cfg.jitted()(movs[0], tgts[0]),
                make_cascade_fn(**recipe)(movs[0], tgts[0])):
        assert got.steps == want.steps
        for name in ("warped", "theta", "rigid_losses", "affine_losses"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy())
    assert sum(want.steps["rigid"]) < recipe["rigid_epochs"]
    batch = make_cascade_batch_fn(**recipe)(torch.cat(movs), torch.cat(tgts))
    for b in range(2):
        one = register_cascade(movs[b], tgts[b], **recipe)
        assert {k: v[b] for k, v in batch.steps.items()} == one.steps
        for name in ("warped", "theta", "rigid_losses", "affine_losses"):
            np.testing.assert_array_equal(getattr(batch, name)[b].numpy(),
                                          getattr(one, name).numpy())
