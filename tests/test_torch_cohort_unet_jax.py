"""``register_cohort(mode='flow', flow_model='unet')`` against the JAX
package's on the CPU (``tests/test_parallel.py:178``: 2 pairs, ``n=32``,
``depth=1``), in 2-D and in 3-D (K3 with a weight set per pair), and each
pair against the port's own single-pair run.

Both packages start from the same per-pair weights: the JAX cohort's
``vmap(model.init)`` over ``split(key(seed), B)``, carried into the port by
``convert.unet_params`` (``_torch_cascade_case.carry_jax_unet_init``). The
JAX U-Net runs its tap path; the port's 3D convolutions run K3's Function,
on the CPU its plain version (a call a pair). Under SGD the executed steps
are equal, the losses within ``tests/test_torch_engines.py``'s rtol 1e-3 /
atol 3e-4 and the flow within 1e-3 of its largest value. With the port's
own draws (pair after pair from the seed) each pair equals
``flow_register`` on it alone to the bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_cascade_case import carry_jax_unet_init
from torchregister_tpu.parallel.cohort import register_cohort as j_register_cohort
from torchregister_tpu_torch import convert
from torchregister_tpu_torch.engines.flow import flow_register
from torchregister_tpu_torch.parallel.cohort import register_cohort

LOSS_TOL = dict(rtol=1e-3, atol=3e-4)


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


@pytest.mark.parametrize("shape", [(20, 20), (16, 16, 16)], ids=["2d_20", "3d_16"])
def test_torch_cohort_unet_matches_jax_and_single_runs(monkeypatch, shape):
    """``tests/test_parallel.py:178`` (2 pairs, SGD lr 1e-3, 3 epochs, MSE,
    ``n=32``, ``depth=1``), in 2-D and in 3-D (K3 with a weight set per
    pair): flow ``[B, 1, d, *S]``, stacked params, the steps equal and each
    pair's losses and flow against JAX's from the same per-pair weights; with
    the port's own draws each pair equal to ``flow_register`` on it alone
    drawing from the same generator."""
    carry_jax_unet_init(monkeypatch)
    movings, targets = _blobs(2, shape, seed=5), _blobs(2, shape, seed=6)
    kw = dict(mode="flow", lr=1e-3, epochs=3, criterions=["mse"], n=32, depth=1,
              flow_model="unet", optimizer="sgd", smooth=0.0, seed=7)
    jres = j_register_cohort(jnp.asarray(movings), jnp.asarray(targets), **kw)
    tm, tt = torch.from_numpy(movings), torch.from_numpy(targets)
    res = register_cohort(tm, tt, **kw)
    assert res.flow.shape == (2, 1, len(shape)) + shape
    assert set(res.params) == set(convert._flatten(jax.tree.map(np.asarray, jres.params)))
    assert all(v.shape[0] == 2 for v in res.params.values())
    assert res.steps == [int(s) for s in np.asarray(jres.steps)]
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses), **LOSS_TOL)
    jflow = np.asarray(jres.flow)
    np.testing.assert_allclose(res.flow.numpy(), jflow, rtol=0,
                               atol=1e-3 * float(np.abs(jflow).max()))
    monkeypatch.undo()  # the port's own draws: pair after pair from the seed
    res = register_cohort(tm, tt, **kw)
    gen = torch.Generator().manual_seed(7)
    for b in range(2):
        _, solo = flow_register(tm[b:b + 1], tt[b:b + 1], lr=1e-3, max_epochs=3,
                                criterions=["mse"], n=32, depth=1, optimizer="sgd",
                                generator=gen)
        assert solo.steps == res.steps[b]
        torch.testing.assert_close(res.flow[b], solo.flow, rtol=0, atol=0)
        torch.testing.assert_close(res.losses[b], solo.losses, rtol=0, atol=0, equal_nan=True)
