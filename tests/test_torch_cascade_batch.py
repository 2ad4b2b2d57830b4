"""The port's ``make_cascade_batch_fn`` against the JAX package's and against
the port's own ``make_cascade_fn`` on each pair, on the CPU.

The JAX cases are ``tests/test_cascade_batch.py``'s unsharded ones on the same
numpy pairs. As ``tests/test_torch_cascade_fn.py`` holds the single factory,
theta is held to 1e-2 and the executed steps per stage to 2 (both run Adam,
whose rounding differs between the frameworks). Against the port's single
factory each pair takes the same steps at every level and its theta, flow and
image equal it to the bit: each criterion runs on each pair's own slice
(``losses.per_pair``).
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchregister_tpu_torch as tr
from torchregister_tpu.engines.cascade import make_cascade_batch_fn as j_make_batch_fn
from torchregister_tpu_torch import synthetic
from torchregister_tpu_torch.engines import cascade
from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn, make_cascade_fn

SELF_TOL = dict(rtol=0, atol=0)  # to the bit

# tests/test_cascade_batch.py's configs
CFG = dict(stages=("rigid", "affine"), levels=2, rigid_epochs=20, rigid_lr=3e-3,
           affine_epochs=10, affine_lr=1e-3, criterions=("mse",), optimizer="adam")
FLOW_CFG = dict(stages=("rigid", "flow"), levels=2, rigid_epochs=6, rigid_lr=3e-3,
                flow_epochs=4, flow_lr=1e-3, criterions=("mse",), optimizer="adam", n=32)
# the recipe reduced as in tests/test_torch_cascade_fn.py, at 16³, with plateau
# stops that fire at different steps for different pairs
RECIPE = {**synthetic.RECIPE, "rigid_epochs": 60, "affine_epochs": 30, "flow_epochs": 60,
          "levels": 2, "matrix_levels": 2, "flow_levels": 2, "flow_smooth": (0.5, 0.25)}


def _blobs(batch, shape, seed=0):
    """``tests/test_cascade_batch.py``'s blobs, numpy ``[B, 1, *S]``."""
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


def _each_pair_equals_its_own(res, movings, targets, cfg):
    """Every pair of the batch against ``make_cascade_fn(**cfg)`` on it."""
    single = make_cascade_fn(**cfg)
    for b in range(movings.shape[0]):
        ref = single(movings[b:b + 1], targets[b:b + 1])
        assert res.steps is not None and {k: v[b] for k, v in res.steps.items()} == ref.steps
        for name in ("theta", "warped", "flow"):
            want = getattr(ref, name)
            if want is None:
                assert getattr(res, name) is None
                continue
            np.testing.assert_allclose(getattr(res, name)[b].numpy(), want.numpy(), **SELF_TOL,
                                       err_msg=name)
        for name in ("rigid_losses", "affine_losses", "flow_losses"):
            want = getattr(ref, name)
            if want is not None:
                np.testing.assert_allclose(getattr(res, name)[b].numpy(), want.numpy(),
                                           **SELF_TOL, err_msg=name)


def test_torch_cascade_batch_matches_jax_and_per_pair():
    """``tests/test_cascade_batch.py:31``: 3 pairs at 24²."""
    movings, targets = _blobs(3, (24, 24), seed=1), _blobs(3, (24, 24), seed=2)
    jres = j_make_batch_fn(**CFG)(jnp.asarray(movings), jnp.asarray(targets))
    res = make_cascade_batch_fn(**CFG)(torch.from_numpy(movings), torch.from_numpy(targets))
    assert res.theta.shape == (3, 1, 2, 3)
    assert res.warped.shape == (3, 1, 1, 24, 24)
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta), atol=1e-2)
    for stage in ("rigid", "affine"):
        j_losses = np.asarray(getattr(jres, f"{stage}_losses"))
        assert getattr(res, f"{stage}_losses").shape == j_losses.shape
        for b in range(3):
            j_steps = int(np.sum(~np.isnan(j_losses[b])))
            assert abs(sum(res.steps[stage][b]) - j_steps) <= 2, (stage, b, res.steps)
    _each_pair_equals_its_own(res, torch.from_numpy(movings), torch.from_numpy(targets), CFG)


def test_torch_cascade_batch_with_flow():
    """``tests/test_cascade_batch.py:55``: rigid then flow, 2 pairs at 24²."""
    movings, targets = _blobs(2, (24, 24), seed=5), _blobs(2, (24, 24), seed=6)
    jres = j_make_batch_fn(**FLOW_CFG)(jnp.asarray(movings), jnp.asarray(targets))
    res = make_cascade_batch_fn(**FLOW_CFG)(torch.from_numpy(movings),
                                            torch.from_numpy(targets))
    assert res.flow.shape == (2, 1, 2, 24, 24) == np.asarray(jres.flow).shape
    assert np.isfinite(res.warped.numpy()).all()
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta), atol=1e-2)
    # an Adam step moves an element by about lr whatever its gradient, so a
    # near-zero gradient whose sign the frameworks' rounding flips differs by
    # up to lr a step, doubled by the upsample between the two levels
    np.testing.assert_allclose(res.flow.numpy(), np.asarray(jres.flow), rtol=0,
                               atol=2 * FLOW_CFG["flow_lr"] * FLOW_CFG["flow_epochs"])
    _each_pair_equals_its_own(res, torch.from_numpy(movings), torch.from_numpy(targets),
                              FLOW_CFG)


def test_torch_cascade_batch_recipe_pairs_stop_on_their_own():
    """The benchmark recipe (reduced, 16³) on three pairs of different
    kinds: each takes its own plateau steps, which equal its single run's,
    and a batch of one equals the single factory to the bit."""
    pairs = [synthetic.make_pair((16, 16, 16), seed=0),
             synthetic.make_flow_truth_pair((16, 16, 16), seed=1)[:2],
             synthetic.make_pair((16, 16, 16), seed=2)]
    movings = torch.cat([m for m, _ in pairs])
    targets = torch.cat([t for _, t in pairs])
    res = make_cascade_batch_fn(**RECIPE)(movings, targets)
    per_pair = [tuple(map(tuple, (res.steps[k][b] for k in res.steps))) for b in range(3)]
    assert len(set(per_pair)) > 1, res.steps
    _each_pair_equals_its_own(res, movings, targets, RECIPE)
    one = make_cascade_batch_fn(**RECIPE)(movings[:1], targets[:1])
    ref = make_cascade_fn(**RECIPE)(movings[:1], targets[:1])
    assert one.steps == {k: [v] for k, v in ref.steps.items()}
    for name in ("warped", "theta", "flow", "rigid_losses", "affine_losses", "flow_losses"):
        got, want = getattr(one, name), getattr(ref, name)
        assert got.shape == (1,) + want.shape
        assert torch.equal(got[0].nan_to_num(-1.0), want.nan_to_num(-1.0)), name


def test_torch_cascade_batch_fn_is_cached_and_refuses_unet():
    fn = make_cascade_batch_fn(**CFG)
    assert make_cascade_batch_fn(**dict(reversed(list(CFG.items())))) is fn
    assert fn is not make_cascade_fn(**CFG)
    assert tr.make_cascade_batch_fn is make_cascade_batch_fn
    cascade._BATCH_CACHE.clear()
    with pytest.raises(ValueError, match="spatial_axis"):
        make_cascade_batch_fn(spatial_axis=0, **CFG)
    assert not cascade._BATCH_CACHE
    # a mesh, which the port refused before it had parallel/mesh.py, splits
    # the batch over its data axis: each pair equal to the unsharded call's
    mesh = tr.make_mesh(devices=["cpu"] * 2)
    sharded = make_cascade_batch_fn(mesh=mesh, **CFG)
    assert sharded is make_cascade_batch_fn(mesh=mesh, **CFG) and sharded is not fn
    movings = torch.from_numpy(_blobs(2, (16, 16), seed=5))
    targets = torch.from_numpy(_blobs(2, (16, 16), seed=6))
    got, want = sharded(movings, targets), make_cascade_batch_fn(**CFG)(movings, targets)
    assert got.steps == want.steps
    for name in ("warped", "theta", "rigid_losses", "affine_losses"):
        assert torch.equal(getattr(got, name).nan_to_num(-1.0),
                           getattr(want, name).nan_to_num(-1.0)), name
    # a U-Net batch, which the port refused before it had K3 with a weight
    # set per pair, runs: each pair equal to its single factory run (its
    # parity with the JAX package's: tests/test_torch_cascade_batch_unet.py)
    movings = torch.from_numpy(_blobs(2, (32, 32)))
    targets = torch.from_numpy(_blobs(2, (32, 32), seed=1))
    unet = {**FLOW_CFG, "flow_model": "unet"}
    res = make_cascade_batch_fn(**unet)(movings, targets)
    assert res.flow.shape == (2, 1, 2, 32, 32)
    _each_pair_equals_its_own(res, movings, targets, unet)


def test_torch_cascade_batch_nmi_pairs_take_their_own_branch():
    """NMI in a batch: each pair's call picks its own density path on the
    device. The second pair, scaled by 1000 (a CT-like range), takes the
    exact KDE at the default bandwidth, the first the binned one; each pair
    equals its single ``make_cascade_fn`` run to the bit."""
    nmi_mod = importlib.import_module("torchregister_tpu_torch.losses.nmi")
    cfg = {**CFG, "criterions": ("mse", tr.get_criterion("nmi", patch_size=8))}
    movings = _blobs(2, (16, 16), seed=9)
    targets = np.roll(movings, (1, -1), axis=(-2, -1))
    movings[1] *= 1000.0
    targets[1] *= 1000.0
    movings, targets = torch.from_numpy(movings), torch.from_numpy(targets)
    before = dict(nmi_mod.branch_calls)
    res = make_cascade_batch_fn(**cfg)(movings, targets)
    took = {k: nmi_mod.branch_calls[k] - before[k] for k in before}
    # each step calls NMI on every pair (a stopped pair's steps are masked)
    steps = sum(max(sum(p) for p in v) for v in res.steps.values())
    assert took == {"binned": steps, "exact": steps}, (took, res.steps)
    _each_pair_equals_its_own(res, movings, targets, cfg)


def test_torch_cascade_batch_warns_naming_the_pairs():
    """The end-of-run checks read the host once and name the pairs: a final
    window of 1 voxel that the second pair's flow outgrows."""
    movings = _blobs(2, (16, 16), seed=8)
    targets = movings.copy()
    targets[1] = np.roll(movings[1], -3, axis=2)
    cfg = dict(stages=("flow",), levels=1, flow_epochs=30, flow_lr=0.5,
               criterions=("mse",), optimizer="adam", flow_max_disp=1)
    with pytest.warns(RuntimeWarning, match=r"1 of 2 recovered flows reach #1: "):
        make_cascade_batch_fn(**cfg)(torch.from_numpy(movings), torch.from_numpy(targets))
