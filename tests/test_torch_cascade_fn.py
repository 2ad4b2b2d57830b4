"""The port's ``make_cascade_fn`` against its own ``register_cascade`` and
the JAX package's factory, on the CPU.

On the CPU the factory runs the cascade's loops without graphs, so its
results must equal ``register_cascade``'s to the bit. Against the JAX
package's single-program cascade (``tests/test_cascade_pyramid.py``'s
config on the same numpy pair) theta is held to the tolerance of
``tests/test_torch_cascade.py``, 1e-2, and the executed steps per stage to
2: both run Adam, whose rounding differs between the frameworks.
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


@pytest.mark.parametrize("spec", [dict(criterions=("mse", "nmi")), dict(criterions=None),
                                  dict(flow_criterions=("NMI",))],
                         ids=["criterions", "default_stack", "flow_criterions"])
def test_torch_cascade_fn_refuses_nmi(spec):
    """NMI picks its KDE branch on the host each step: the factory names it
    and the ROADMAP item instead of running the step ungraphed."""
    cascade._CASCADE_CACHE.clear()
    with pytest.raises(ValueError, match=r"includes 'nmi'.*item 16"):
        make_cascade_fn(**{**CFG, **spec})
    assert not cascade._CASCADE_CACHE
