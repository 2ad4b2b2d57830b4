"""``make_cascade_batch_fn(flow_model='unet')`` against the JAX package's
(its ``vmap`` of the cascade) on the CPU, and each pair against the port's
own ``make_cascade_fn`` run.

Every pair's net starts from the config's seed, as JAX's ``vmap`` gives
every pair the same key: JAX's ``init(key(seed))``, carried into the port by
``convert.unet_params`` (``_torch_cascade_case.carry_jax_unet_init``). Both
run Adam, so as ``tests/test_torch_cascade_batch.py`` holds the field mode:
theta to 1e-2, the executed steps per stage to 2, the flow to 2 x lr x
epochs (Adam turns the frameworks' rounding into near-full steps where a
gradient is near zero). Against the port's single factory each pair is
equal to the bit.
"""
import numpy as np
import jax.numpy as jnp
import torch

from _torch_cascade_case import carry_jax_unet_init
from torchregister_tpu.engines.cascade import make_cascade_batch_fn as j_make_batch_fn
from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn, make_cascade_fn


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


# tests/test_cascade_batch.py:55 with the U-Net flow stage, at 32² (the
# coarsest flow level 16², depth 1)
UNET_BATCH_CFG = dict(stages=("rigid", "flow"), levels=2, rigid_epochs=6, rigid_lr=3e-3,
                      flow_epochs=4, flow_lr=1e-3, criterions=("mse",), optimizer="adam",
                      n=32, flow_model="unet")


def test_torch_cascade_batch_unet_matches_jax_and_single_runs(monkeypatch):
    """``make_cascade_batch_fn`` in U-Net mode: every pair's net from the
    config's seed (JAX: ``vmap`` of the cascade, one key for all), its
    theta, steps and flow against JAX's, and each pair equal to
    ``make_cascade_fn`` on it alone to the bit."""
    carry_jax_unet_init(monkeypatch)
    movings, targets = _blobs(2, (32, 32), seed=5), _blobs(2, (32, 32), seed=6)
    jres = j_make_batch_fn(**UNET_BATCH_CFG)(jnp.asarray(movings), jnp.asarray(targets))
    tm, tt = torch.from_numpy(movings), torch.from_numpy(targets)
    res = make_cascade_batch_fn(**UNET_BATCH_CFG)(tm, tt)
    assert res.flow.shape == (2, 1, 2, 32, 32) and res.warped.shape == (2, 1, 1, 32, 32)
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta), atol=1e-2)
    for stage in ("rigid", "flow"):
        jl = np.asarray(getattr(jres, f"{stage}_losses"))
        for b in range(2):
            assert abs(sum(res.steps[stage][b]) - int(np.sum(~np.isnan(jl[b])))) <= 2
    bound = 2 * UNET_BATCH_CFG["flow_lr"] * UNET_BATCH_CFG["flow_epochs"]
    np.testing.assert_allclose(res.flow.numpy(), np.asarray(jres.flow), rtol=0, atol=bound)
    single = make_cascade_fn(**UNET_BATCH_CFG)
    for b in range(2):
        ref = single(tm[b:b + 1], tt[b:b + 1])
        assert {k: v[b] for k, v in res.steps.items()} == ref.steps
        for name in ("theta", "warped", "flow"):
            torch.testing.assert_close(getattr(res, name)[b], getattr(ref, name), rtol=0,
                                       atol=0)
