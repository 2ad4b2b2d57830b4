"""The U-Net cohort's layers on the CPU: K3 with a weight set per pair and
the pair-mode U-Net against the JAX package's (its ``vmap`` over the pairs,
stacked parameters), the pair-mode draws and stacked trees, and the flow
engine's pairs against the port's own single-pair runs. The whole slice
against JAX's ``register_cohort`` and ``make_cascade_batch_fn`` is in
``tests/test_torch_cohort_unet_jax.py`` and
``tests/test_torch_cascade_batch_unet.py``.

The JAX U-Net starts from its own ``vmap(model.init)`` weights, carried into
the port by ``convert.unet_params``. It runs its tap path (its default off
the TPU) and K3 in interpret mode; the port's convolutions run K3's
Function, on the CPU its plain version (a call a pair).

Tolerances. K3 as ``tests/test_torch_conv3d.py`` holds it: forward rtol
1e-5, gradients rtol 1e-4. The whole net as ``tests/test_torch_unet.py``:
the flow rtol 1e-4 (atol 1e-4 of its largest value), parameter gradients
rtol 1e-4 plus 2e-4 of the largest gradient. Against the port's own
single-pair run every pair is equal to the bit: each op of a pair's step is
that pair's alone.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torchregister_tpu.models.attention_unet import AttentionUNet as JUNet
from torchregister_tpu.ops.pallas.conv3d import conv3x3x3 as j_conv
from torchregister_tpu_torch import convert
from torchregister_tpu_torch.engines.flow import flow_pairs, flow_register
from torchregister_tpu_torch.models.attention_unet import AttentionUNet
from torchregister_tpu_torch.ops.cuda import conv3d as k3


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


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


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------- K3


@pytest.mark.parametrize("ci,co", [(1, 8), (4, 6)])
def test_torch_conv3x3x3_weight_set_per_pair_matches_jax_vmap(ci, co):
    """Values, dx and dw of K3 with a weight set per pair against JAX's
    Pallas ``conv3x3x3`` under ``vmap`` over the pair axis (interpret mode,
    its custom VJP); each pair equal to a single-pair call to the bit."""
    B = 2
    x = _rand((B, ci, 6, 8, 10), 1 + ci)
    w = _rand((B, 3, 3, 3, ci, co), 2 + co, 0.2)
    t = _rand((B, co, 4, 6, 8), 3)

    def loss_jax(x_, w_):
        return jnp.sum((jax.vmap(j_conv)(x_, w_) - t) ** 2)

    jout = np.asarray(jax.vmap(j_conv)(jnp.asarray(x), jnp.asarray(w)))
    jgx, jgw = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = k3.conv3x3x3(tx, tw)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-5)
    ((out - torch.from_numpy(t)) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-4)
    for b in range(B):
        xs = torch.from_numpy(x[b:b + 1]).requires_grad_(True)
        ws = torch.from_numpy(w[b]).requires_grad_(True)
        one = k3.conv3x3x3(xs, ws)
        torch.testing.assert_close(out[b:b + 1].detach(), one.detach(), rtol=0, atol=0)
        ((one - torch.from_numpy(t[b:b + 1])) ** 2).sum().backward()
        torch.testing.assert_close(tx.grad[b:b + 1], xs.grad, rtol=0, atol=0)
        torch.testing.assert_close(tw.grad[b], ws.grad, rtol=0, atol=0)


def test_torch_conv3x3x3_weight_set_per_pair_checks():
    """The per-pair plain versions loop over the items; shapes are checked,
    and a CPU tensor launches nothing."""
    x = torch.from_numpy(_rand((2, 2, 5, 6, 7), 4))
    w = torch.from_numpy(_rand((2, 3, 3, 3, 2, 3), 5, 0.2))
    g = torch.from_numpy(_rand((2, 3, 3, 4, 5), 6))
    k3.reset_counts()
    dw = k3.wgrad_plain(x, g, per_pair=True)
    assert dw.shape == (2, 3, 3, 3, 2, 3)
    for b in range(2):
        torch.testing.assert_close(dw[b], k3.wgrad_plain(x[b:b + 1], g[b:b + 1]), rtol=0,
                                   atol=0)
        torch.testing.assert_close(k3.conv3x3x3_plain(x, w)[b:b + 1],
                                   k3.conv3x3x3_plain(x[b:b + 1], w[b]), rtol=0, atol=0)
    assert (k3.fwd_pairs_launches, k3.dgrad_pairs_launches, k3.wgrad_pairs_launches) == (
        0, 0, 0)
    with pytest.raises(ValueError, match="a set per item"):
        k3.conv3x3x3(x, w[:1])
    with pytest.raises(ValueError, match="CUDA"):
        k3.conv_launch(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        k3.wgrad_launch(x, g, per_pair=True)


# ------------------------------------------------------------ the U-Net


@pytest.mark.parametrize("nd,S", [(3, 16)], ids=["3d_16"])
def test_torch_pair_mode_unet_matches_jax_vmap(nd, S):
    """The pair-mode net (2 weight sets, depth 1) against JAX's
    ``vmap(model.apply)`` over the stacked weights carried by ``convert``:
    the flow, the gate maps and every parameter's gradient of sum(flow²);
    each pair equal to a single net with its weights to the bit."""
    B, n = 2, 32
    x = _rand((B, 1) + (S,) * nd, 10 + nd)
    jm = JUNet(ndim=nd, n=n, depth=1)
    params = jax.vmap(lambda k: jm.init(k, jnp.asarray(x[:1]))["params"])(
        jax.random.split(jax.random.key(3), B))

    def loss(p):
        flow, atts = jax.vmap(lambda q, xb: jm.apply({"params": q}, xb[None], out_att=True))(
            p, jnp.asarray(x))
        return jnp.sum(flow**2), (flow[:, 0], [a[:, 0] for a in atts])

    (_, (jflow, jatts)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jgrads = convert._flatten(_np_tree(jgrads))
    state = convert.unet_params(_np_tree(params))
    tm = AttentionUNet(ndim=nd, n=n, depth=1, pairs=B)
    tm.load_state_dict(state)
    assert all(v.shape[0] == B for v in state.values())
    flow, atts = tm(torch.from_numpy(x), out_att=True)
    scale = float(np.max(np.abs(jflow)))
    np.testing.assert_allclose(flow.detach().numpy(), np.asarray(jflow), rtol=1e-4,
                               atol=1e-4 * scale)
    for a, b in zip(atts, jatts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    (flow**2).sum().backward()
    gmax = max(np.max(np.abs(v)) for v in jgrads.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=1e-4,
                                   atol=2e-4 * gmax, err_msg=name)
    for b in range(B):
        one = AttentionUNet(ndim=nd, n=n, depth=1)
        one.load_state_dict({k: v[b] for k, v in state.items()})
        fb = one(torch.from_numpy(x[b:b + 1]))
        torch.testing.assert_close(flow[b:b + 1].detach(), fb.detach(), rtol=0, atol=0)
        (fb**2).sum().backward()
        for (name, p), q in zip(tm.named_parameters(), one.parameters()):
            torch.testing.assert_close(p.grad[b], q.grad, rtol=0, atol=0, msg=name)


def test_torch_pair_mode_unet_draws_and_stacked_trees():
    """Fresh pair-mode weights are drawn pair after pair from one generator
    (a sequence gives each pair its own); ``convert`` reads a stacked tree's
    pair count and round-trips it."""
    one = [AttentionUNet(ndim=3, n=32, depth=1) for _ in range(2)]
    gen = torch.Generator().manual_seed(5)
    for m in one:
        m.reset_parameters(gen)
    pm = AttentionUNet(ndim=3, n=32, depth=1, pairs=2)
    pm.reset_parameters(torch.Generator().manual_seed(5))
    same = AttentionUNet(ndim=3, n=32, depth=1, pairs=2)
    same.reset_parameters([torch.Generator().manual_seed(5) for _ in range(2)])
    for k, v in pm.state_dict().items():
        for b in range(2):
            torch.testing.assert_close(v[b], one[b].state_dict()[k], rtol=0, atol=0)
            torch.testing.assert_close(same.state_dict()[k][b], one[0].state_dict()[k],
                                       rtol=0, atol=0)
    tree = convert.unet_tree(pm.state_dict())
    assert tree["out_kernel"].shape == (2, 2, 3)
    back = convert.unet_params(tree)  # the pair count read off the flow head
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generators for 2 pairs"):
        pm.reset_parameters([gen])
    with pytest.raises(ValueError, match="runs 2 items"):
        pm(torch.zeros((3, 1, 16, 16, 16)))


# ------------------------------------------------- the flow engine's pairs


def test_torch_flow_pairs_unet_stops_each_pair_and_warm_starts():
    """Pair-mode U-Net steps under a plateau stop: each pair stops at its own
    step and equals its single run to the bit; the stacked ``params`` warm
    start the next call as the single runs' do."""
    movings = torch.from_numpy(_blobs(2, (16, 16, 16), seed=11))
    targets = torch.from_numpy(np.roll(_blobs(2, (16, 16, 16), seed=11), (0, 0, 1), (2, 3, 4)))
    targets[1] = torch.from_numpy(_blobs(1, (16, 16, 16), seed=12)[0])
    kw = dict(lr=0.05, criterions=["mse"], n=32, depth=1, optimizer="adam", stop_rel=0.05,
              patience=2, max_epochs=30)
    _, res = flow_pairs(movings, targets, generator=torch.Generator().manual_seed(2), **kw)
    assert len(set(res.steps)) > 1, res.steps
    gen = torch.Generator().manual_seed(2)
    solos = [flow_register(movings[b:b + 1], targets[b:b + 1], generator=gen, **kw)[1]
             for b in range(2)]
    for b, solo in enumerate(solos):
        assert solo.steps == res.steps[b]
        torch.testing.assert_close(res.flow[b:b + 1], solo.flow, rtol=0, atol=0)
    _, warm = flow_pairs(movings, targets, init_params=res.params, **{**kw, "max_epochs": 2})
    for b, solo in enumerate(solos):
        _, one = flow_register(movings[b:b + 1], targets[b:b + 1], init_params=solo.params,
                               **{**kw, "max_epochs": 2})
        torch.testing.assert_close(warm.flow[b:b + 1], one.flow, rtol=0, atol=0)
