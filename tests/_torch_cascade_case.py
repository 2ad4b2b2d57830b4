"""Shared case for the whole-slice parity tests (``test_torch_cascade*.py``):
``bench.RECIPE`` reduced in epochs and levels, run on the same 24³ pairs by
the JAX package's ``register_cascade`` and by the port's; and
:func:`carry_jax_unet_init`, which starts the port's U-Nets (single, or one
weight set a pair) from the JAX package's initial weights."""
import functools

import numpy as np
import jax.numpy as jnp

import bench
from torchregister_tpu.engines.cascade import register_cascade as j_cascade
from torchregister_tpu_torch import synthetic
from torchregister_tpu_torch.engines.cascade import register_cascade as t_cascade

SHAPE = (24, 24, 24)


def reduced_recipe(**over):
    return {**bench.RECIPE, "rigid_epochs": 60, "affine_epochs": 30, "flow_epochs": 60,
            "levels": 2, "matrix_levels": 2, "flow_levels": 2, "flow_smooth": (0.5, 0.25),
            **over}


def jax_steps(res):
    """Executed steps per stage: the non-NaN entries of the loss history."""
    return {k: int(np.sum(~np.isnan(np.asarray(getattr(res, f"{k}_losses")))))
            for k in ("rigid", "affine", "flow")}


def run_case(recipe):
    """Both pairs through both packages: the rigid pair's RMSE reduction and
    the deformable pair's three truth metrics, thetas and steps."""
    jm, jt = bench.make_pair(SHAPE)
    jf = bench.make_flow_truth_pair(SHAPE)
    tm, tt = synthetic.make_pair(SHAPE)
    tf = synthetic.make_flow_truth_pair(SHAPE)
    out = {}
    jr, jfr = j_cascade(jm, jt, **recipe), j_cascade(jf[0], jf[1], **recipe)
    r0 = jnp.sqrt(jnp.mean((jm - jt) ** 2))
    out["jax"] = dict(
        rmse=float(100 * (1 - jnp.sqrt(jnp.mean((jr.warped - jt) ** 2)) / r0)),
        truth=bench.flow_truth_metrics(jfr, *jf),
        theta=(np.asarray(jr.theta), np.asarray(jfr.theta)),
        steps=(jax_steps(jr), jax_steps(jfr)),
        results=(jr, jfr),
    )
    tr, tfr = t_cascade(tm, tt, **recipe), t_cascade(tf[0], tf[1], **recipe)
    out["torch"] = dict(
        rmse=synthetic.rmse_reduction_pct(tr.warped, tm, tt),
        truth=synthetic.flow_truth_metrics(tfr, *tf),
        theta=(tr.theta.numpy(), tfr.theta.numpy()),
        steps=tuple({k: sum(v) for k, v in r.steps.items()} for r in (tr, tfr)),
        results=(tr, tfr),
    )
    return out


def assert_close(out, theta_atol, steps_tol, rmse_tol, truth_rmse_tol, vox_tol):
    j, t = out["jax"], out["torch"]
    for a, b in zip(t["theta"], j["theta"]):
        np.testing.assert_allclose(a, b, atol=theta_atol)
    for a, b in zip(t["steps"], j["steps"]):
        for stage in ("rigid", "affine", "flow"):
            assert abs(a[stage] - b[stage]) <= steps_tol, (stage, a, b)
    assert abs(t["rmse"] - j["rmse"]) <= rmse_tol, (t["rmse"], j["rmse"])
    (tr, te, to), (jr, je, jo) = t["truth"], j["truth"]
    assert abs(tr - jr) <= truth_rmse_tol, (tr, jr)
    assert abs(te - je) <= vox_tol, (te, je)
    assert abs(to - jo) <= vox_tol, (to, jo)


@functools.lru_cache(maxsize=None)
def _jax_unet_init(ndim, in_c, n, depth, use_attention, use_norm, seed, pairs=None):
    """flax's init of the JAX U-Net from ``key(seed)``; with ``pairs`` the
    JAX cohort's stacked init, ``vmap(init)`` over ``split(key(seed),
    pairs)``."""
    import jax

    from torchregister_tpu.models.attention_unet import AttentionUNet as JUNet
    from torchregister_tpu.models.attention_unet import max_depth_for

    edge = next(s for s in range(8, 512) if max_depth_for((s,) * ndim) >= depth)
    net = JUNet(ndim=ndim, in_c=in_c, n=n, depth=depth, use_attention=use_attention,
                use_norm=use_norm)
    x = jnp.zeros((1, in_c) + (edge,) * ndim, jnp.float32)
    if pairs is None:
        return jax.tree.map(np.asarray, jax.jit(net.init)(jax.random.key(seed), x)["params"])
    init = jax.jit(jax.vmap(lambda k: net.init(k, x)["params"]))
    return jax.tree.map(np.asarray, init(jax.random.split(jax.random.key(seed), pairs)))


def carry_jax_unet_init(monkeypatch):
    """Make every fresh port U-Net start from the JAX package's initial
    weights for the same seed: ``AttentionUNet.reset_parameters`` loads
    ``flax init(jax.random.key(seed))`` (the key the JAX engines use; the
    values depend on the architecture, not on the input's size). A pair-mode
    net given one generator a pair (the batched cascade: JAX's ``vmap`` of
    it gives every pair the config's key) loads that init for each pair;
    given one generator (the cohort) it loads the JAX cohort's ``vmap(init)``
    over ``split(key(seed), B)``."""
    import jax

    from torchregister_tpu_torch import convert
    from torchregister_tpu_torch.models.attention_unet import AttentionUNet

    def reset(self, generator=None):
        args = (self.ndim, self.in_c, float(self.n), self.depth, self.use_attention,
                self.use_norm)
        if isinstance(generator, (list, tuple)):
            trees = [_jax_unet_init(*args, g.initial_seed()) for g in generator]
            params = jax.tree.map(lambda *leaves: np.stack(leaves), *trees)
        else:
            seed = 0 if generator is None else generator.initial_seed()
            params = _jax_unet_init(*args, seed, self.pairs)
        self.load_state_dict(convert.unet_params(params, model=self))

    monkeypatch.setattr(AttentionUNet, "reset_parameters", reset)
