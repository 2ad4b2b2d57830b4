"""The port's counterpart of ``__graft_entry__.py`` (``torchregister_tpu_torch/
dryrun.py``) on the CPU, against the JAX package.

- ``dryrun_multichip`` on meshes that name the CPU 8 and 2 times prints the
  ok line of ``__graft_entry__.py`` (``loss=50.125000``: the constant batch's
  MSE + NCC, as JAX's).
- The train step on a ``(4, 2)`` ``data x space`` mesh on a blob batch
  (``dryrun.blob_batch``: four pairs, each blob scaled and rolled), with
  JAX's initial weights carried across by ``convert.unet_params``, against
  JAX's ``train_step`` (``__graft_entry__.py:157-166``) unsharded: each updated
  weight within 1e-6 of JAX's wherever its gradient exceeds 1e-5 of that
  weight's largest entry and within 2 lr elsewhere (Adam's first step moves
  each weight by about lr times the sign of its gradient, so a gradient near
  zero may flip the step's sign; measured 1.5e-8); the loss within rtol 2e-4
  and each weight's gradient within 5e-3 of its own largest entry. Those two
  are the frameworks' own gap at this input, the port's unsharded step's as
  much as the mesh's (measured 1.49e-4 and 3.3e-3): JAX's f32 NCC of its own
  warped images is 1.06e-4 off a float64 evaluation (the port's 1e-7); and
  where the initial net's flow is exactly 0 (dead ReLUs, zero biases) the
  sample lands on a grid point, where ``F.grid_sample`` and JAX's
  multilinear sample take different one-sided derivatives (there dL/dflow
  parts by 1.4 % of its largest entry, elsewhere by 4e-11), which the flow
  head's bias sums over the volume. Against the port's unsharded step at the
  same weights: the loss within rtol 5e-6, each gradient within 5e-5 of its
  own largest entry (measured 8.7e-7 and 1.25e-5: the slabs' partial sums).
- ``entry()``'s forward against JAX's at 32³ (the smallest cube the depth-2
  net takes; JAX's compile at 40³ is slower), the port's weights carried to
  JAX by ``convert.unet_tree``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchregister_tpu.losses import weighted_loss as j_weighted_loss
from torchregister_tpu.losses.similarity import mse as j_mse, ncc as j_ncc
from torchregister_tpu.models.attention_unet import AttentionUNet as JUNet
from torchregister_tpu.ops.resample import warp_flow as j_warp_flow
from torchregister_tpu_torch import convert, dryrun
from torchregister_tpu_torch.models.attention_unet import AttentionUNet
from torchregister_tpu_torch.parallel import mesh as M

B, S = 4, dryrun.TRAIN_SIZE


@pytest.mark.parametrize("n,mesh", [(8, "{'data': 4, 'space': 2}"), (2, "{'data': 2}")])
def test_torch_dryrun_multichip_prints_ok(n, mesh, capsys):
    line = dryrun.dryrun_multichip(n, devices=["cpu"] * n)
    out = capsys.readouterr().out
    assert line in out and line.startswith(f"dryrun_multichip ok: mesh={mesh} loss=50.125000 ")
    halo = " sweep-halo-exchange=ok" if n == 8 else ""
    assert line.endswith(f"cascade-sharded=ok{halo}")


def test_torch_dryrun_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()


@pytest.fixture(scope="module")
def steps():
    """JAX's unsharded train step and the port's, unsharded and on a ``(4,
    2)`` mesh, from JAX's initial weights on the blob batch."""
    mov, tgt = dryrun.blob_batch(B)
    jmodel = JUNet(ndim=3, in_c=1, n=64, depth=1)
    jparams = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 1, S, S, S)))["params"]
    loss = j_weighted_loss((j_mse, j_ncc), (0.5, 0.5))
    tx = optax.adam(dryrun.TRAIN_LR)

    def loss_fn(p, m, t):
        return loss(t, j_warp_flow(m, jmodel.apply({"params": p}, m)))

    @jax.jit
    def step(p, m, t):
        val, g = jax.value_and_grad(loss_fn)(p, m, t)
        updates, _ = tx.update(g, tx.init(p), p)
        return val, g, optax.apply_updates(p, updates)

    jloss, jgrads, jnew = step(jparams, jnp.asarray(mov.numpy()), jnp.asarray(tgt.numpy()))
    out = {"jax": (float(jloss), convert.unet_params(jgrads), convert.unet_params(jnew))}
    mesh, _ = dryrun.dryrun_mesh(8, ["cpu"] * 8)
    sh = dryrun.batch_layout(mesh)
    for name, (m, t) in (("whole", (mov, tgt)), ("mesh", (M.shard(mov, sh), M.shard(tgt, sh)))):
        model = AttentionUNet(**dryrun.TRAIN_NET)
        model.load_state_dict(convert.unet_params(jparams))
        params, opt = dryrun.init_train_state(model)
        val, grads = dryrun.make_loss_and_grads(model)(params, m, t)
        params, opt, val2 = dryrun.make_train_step(model)(params, opt, m, t)
        assert float(val2) == float(val)
        out[name] = (float(val), grads, {k: v.detach().clone()
                                         for k, v in model.named_parameters()})
    return out


def _per_weight(got: dict, want: dict, tol: float) -> None:
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=tol * float(w.abs().max()), err_msg=k)


def test_torch_dryrun_train_step_matches_jax(steps):
    jloss, jgrads, jnew = steps["jax"]
    loss, grads, new = steps["mesh"]
    assert loss == pytest.approx(jloss, rel=2e-4)
    _per_weight(grads, jgrads, 5e-3)
    lr = dryrun.TRAIN_LR
    for k, w in jnew.items():
        small = (jgrads[k].abs() <= 1e-5 * float(jgrads[k].abs().max())).numpy()
        err = (new[k] - w).abs().numpy()
        assert (err[~small] <= 1e-6).all(), k
        assert (err[small] <= 2 * lr).all(), k


def test_torch_dryrun_train_step_on_the_mesh_matches_unsharded(steps):
    loss, grads, _ = steps["mesh"]
    uloss, ugrads, _ = steps["whole"]
    assert loss == pytest.approx(uloss, rel=5e-6)
    _per_weight(grads, ugrads, 5e-5)


def test_torch_dryrun_entry_matches_jax():
    """``entry()``'s step (``__graft_entry__.py:19-33``: the U-Net, then
    ``warp_flow``) against JAX's, the port's initial weights carried to JAX
    by ``convert.unet_tree``."""
    fn, (params, moving) = dryrun.entry(device="cpu")
    assert tuple(moving.shape) == (1, 1, 40, 40, 40)
    jmodel = JUNet(**dryrun.ENTRY_NET)
    x = np.random.default_rng(21).random((1, 1, 32, 32, 32)).astype(np.float32)
    jw, jflow = jax.jit(lambda p, m: (lambda f: (j_warp_flow(m, f), f))(
        jmodel.apply({"params": p}, m)))(convert.unet_tree(params), jnp.asarray(x))
    w, flow = fn(params, torch.from_numpy(x))
    jflow, jw = np.asarray(jflow), np.asarray(jw)
    np.testing.assert_allclose(flow.detach().numpy(), jflow, rtol=0,
                               atol=1e-4 * np.abs(jflow).max())
    np.testing.assert_allclose(w.detach().numpy(), jw, rtol=0, atol=1e-4)
