"""The port's Attention U-Net (``models/attention_unet.py``) and its helpers
against the JAX package's, with JAX's own initial weights carried across by
``convert.unet_params``.

The JAX U-Net runs its tap-decomposed convolutions (its default off the TPU);
the port's 3D convolutions run K3's Function, on the CPU its plain version.
Tolerances: outputs rtol 1e-4 (f32, sums in another order through up to 12
convolutions and 6 instance norms); parameter gradients rtol 1e-4 plus 2e-4
of the largest gradient of the network. That floor is the JAX side's: at 48³
its f32 tap-path gradients sit up to 1.05e-4 of the largest gradient from a
float64 evaluation of the same network, the port's f32 gradients 1.1e-6
(measured on this CPU); elements where the sums cancel keep only that
rounding.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torchregister_tpu.models import attention_unet as J
from torchregister_tpu.ops.pad import pad_like as j_pad_like
from torchregister_tpu.ops.pad import pad_nd as j_pad_nd
from torchregister_tpu.ops.pad import pad_spatial as j_pad_spatial
from torchregister_tpu.ops.resize import axis_nearest_resize as j_nearest
from torchregister_tpu_torch import convert
from torchregister_tpu_torch.models import attention_unet as T
from torchregister_tpu_torch.ops.pad import pad_like, pad_nd, pad_spatial
from torchregister_tpu_torch.ops.resize import axis_nearest_resize


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------ pad, resize


@pytest.mark.parametrize("target", [(9, 12, 7), (5, 8, 4), (6, 12, 3), (7, 10, 8)],
                         ids=["pad", "crop_even", "mixed", "identity_odd"])
def test_torch_pad_spatial_matches_jax(target):
    """Pads split floor/ceil; a negative delta crops ceil(|delta|/2) from
    the leading side."""
    x = _rand((2, 3, 7, 10, 8), 0)
    ours = pad_spatial(torch.from_numpy(x), target, first_axis=2).numpy()
    ref = np.asarray(j_pad_spatial(jnp.asarray(x), target, first_axis=2))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(pad_nd(torch.from_numpy(x), target).numpy(),
                                  np.asarray(j_pad_nd(jnp.asarray(x), target)))
    like = np.zeros((1, 1) + target, np.float32)
    np.testing.assert_array_equal(
        pad_like(torch.from_numpy(x), torch.from_numpy(like), value=2.0).numpy(),
        np.asarray(j_pad_like(jnp.asarray(x), jnp.asarray(like), value=2.0)))


def test_torch_pad_spatial_first_axis_and_errors():
    x = _rand((4, 5, 6), 1)
    ours = pad_spatial(torch.from_numpy(x), (8, 3), first_axis=1, value=-1.0).numpy()
    ref = j_pad_spatial(jnp.asarray(x), (8, 3), 1, value=-1.0)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    with pytest.raises(ValueError, match="pad_nd"):
        pad_nd(torch.from_numpy(x), (8, 3))


@pytest.mark.parametrize("in_size,out_size", [(4, 11), (7, 7), (9, 4), (5, 13)])
def test_torch_axis_nearest_resize_matches_jax(in_size, out_size):
    x = _rand((2, 3, in_size, 5), 2)
    for axis in (2,):
        ours = axis_nearest_resize(torch.from_numpy(x), axis, out_size)
        ref = np.asarray(j_nearest(jnp.asarray(x), axis, out_size))
        np.testing.assert_array_equal(ours.numpy(), ref)
    bf = axis_nearest_resize(torch.from_numpy(x).to(torch.bfloat16), 3, out_size)
    assert bf.dtype == torch.bfloat16 and bf.shape[3] == out_size


# ------------------------------------------------------------- the blocks


def test_torch_instance_norm_matches_jax():
    x = _rand((2, 3, 9, 8, 7), 3, 4.0) + 2.0
    ours = T.instance_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(J.instance_norm(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    flat = T.instance_norm(torch.full((1, 2, 4, 4), 3.0))  # zero variance: clamped
    assert bool(torch.isfinite(flat).all()) and float(flat.abs().max()) == 0.0
    bf = T.instance_norm(torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("nd", [2, 3])
def test_torch_conv_transpose_2x_matches_jax(nd):
    x = _rand((1, 4) + (5, 6, 7)[:nd], 4)
    mod = J.TapConvTranspose2x(features=3, ndim=nd)
    params = _np_tree(mod.init(jax.random.key(1), jnp.asarray(x))["params"])
    params["bias"] = _rand((3,), 5)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ours = T.TapConvTranspose2x(4, 3, nd)
    ours.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    out = ours(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape == (1, 3) + tuple(2 * s for s in x.shape[2:])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_spatial,g_spatial", [
    ((10, 11, 13), (5, 3, 4)),    # a's last dim (5) > b's (4): b padded/cropped to a
    ((9, 9, 7), (2, 5, 4)),       # a's last dim (3) < b's (4): a padded/cropped to b
    ((9, 10, 12), (3, 4, 4)),     # last dims equal: no reconciliation at all
], ids=["pad_b", "pad_a", "equal_last"])
def test_torch_attention_gate_matches_jax(x_spatial, g_spatial):
    """Only the last spatial dim decides which tensor is reconciled; it is
    then padded or cropped to the other's whole shape (reference
    utils.py:395-399)."""
    x = _rand((1, 4) + x_spatial, 6)
    g = _rand((1, 5) + g_spatial, 7)
    mod = J.AttentionGate(inter_features=3, ndim=3)
    params = _np_tree(mod.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(g))["params"])
    params["gate_bias"] = _rand((3,), 8)
    params["psi_bias"] = _rand((1,), 9)
    ref_gated, ref_w = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(g))
    ours = T.AttentionGate(4, 5, 3, 3)
    ours.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    gated, w = ours(torch.from_numpy(x), torch.from_numpy(g))
    assert w.shape == (1,) + x_spatial
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref_w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gated.detach().numpy(), np.asarray(ref_gated),
                               rtol=1e-4, atol=1e-5)


def test_torch_level_channels_and_max_depth_match_jax():
    for depth in (1, 2, 4):
        for n in (1, 8, 32, 128, 2.5):
            assert T.level_channels(depth, n) == J.level_channels(depth, n)
    for spatial in [(240, 240, 240), (128, 128, 128), (120,) * 3, (60,) * 3, (48, 40),
                    (24, 24, 24), (16, 16), (12, 12, 12), (256, 256), (64, 70, 80)]:
        assert T.max_depth_for(spatial) == J.max_depth_for(spatial), spatial
    assert T.max_depth_for((240,) * 3) == 4 and T.max_depth_for((60,) * 3) == 2
    assert T.max_depth_for((12,) * 3) == 0


# ---------------------------------------------------------- the whole net


def _jax_forward_and_grads(model, params, x):
    """One compiled program: the flow, the gate maps and the gradient of
    sum(flow²) with respect to every parameter."""

    def loss(p):
        flow, atts = model.apply({"params": p}, x, out_att=True)
        return jnp.sum(flow**2), (flow, atts)

    (_, (flow, atts)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(flow), [np.asarray(a) for a in atts], convert._flatten(_np_tree(grads))


@pytest.mark.parametrize("nd,S,depth", [(2, 64, None), (3, 48, 2)], ids=["2d_64", "3d_48"])
def test_torch_attention_unet_matches_jax(nd, S, depth):
    depth = J.max_depth_for((S,) * nd) if depth is None else depth
    x = _rand((1, 1) + (S,) * nd, 10)
    jm = J.AttentionUNet(ndim=nd, n=8, depth=depth)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))["params"]
    jflow, jatts, jgrads = _jax_forward_and_grads(jm, params, jnp.asarray(x))

    state = convert.unet_params(_np_tree(params))
    tm = T.AttentionUNet(ndim=nd, n=8, depth=depth)
    tm.load_state_dict(state)
    flow, atts = tm(torch.from_numpy(x), out_att=True)
    scale = np.max(np.abs(jflow))
    np.testing.assert_allclose(flow.detach().numpy(), jflow, rtol=1e-4, atol=1e-4 * scale)
    assert len(atts) == len(jatts) == depth
    for a, b in zip(atts, jatts):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4, atol=1e-5)
    (flow**2).sum().backward()
    gmax = max(np.max(np.abs(v)) for v in jgrads.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=1e-4,
                                   atol=2e-4 * gmax, err_msg=name)
    # the default call returns the flow alone, the same values
    torch.testing.assert_close(tm(torch.from_numpy(x)), flow, rtol=0, atol=0)


def test_torch_unet_params_round_trip_and_checks():
    tm = T.AttentionUNet(ndim=3, n=16, depth=2, use_attention=False)
    tm.reset_parameters(torch.Generator().manual_seed(3))
    tree = convert.unet_tree(tm.state_dict())
    assert set(tree) == {"enc1", "enc2", "bottleneck", "up0", "up1", "dec1", "dec2",
                         "out_kernel", "out_bias"}
    assert tree["enc1"]["Conv_0"]["kernel"].shape == (3, 3, 3, 1, 4)
    state = convert.unet_params(tree)  # the architecture read off the tree
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    bad = convert.unet_tree(tm.state_dict())
    bad["enc1"]["Conv_0"]["kernel"] = np.zeros((3, 3, 3, 1, 5), np.float32)
    with pytest.raises(ValueError):
        convert.unet_params(bad, model=tm)
    del bad["out_bias"]
    with pytest.raises(ValueError, match="keys differ"):
        convert.unet_params(bad, model=tm)


def test_torch_unet_init_is_flax_lecun_normal():
    """Kernels: a normal truncated at ±2σ' with std sqrt(1/fan_in), fan_in =
    Ci·k^d (convolutions) or Ci (1x1); biases zero; a seed fixes them."""
    tm = T.AttentionUNet(ndim=3, n=1, depth=1)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    k = tm.bottleneck.Conv_1.kernel.detach()  # [3, 3, 3, 128, 128]
    fan_in = 27 * 128
    assert float(k.std()) == pytest.approx(fan_in**-0.5, rel=0.02)
    bound = 2 * fan_in**-0.5 / T._TRUNC_STD
    assert float(k.abs().max()) <= bound * (1 + 1e-6)
    assert float(tm.skip1.input_kernel.detach().std()) == pytest.approx(64**-0.5, rel=0.1)
    assert all(float(p.abs().max()) == 0.0 for n, p in tm.named_parameters()
               if n.endswith("bias"))
    again = T.AttentionUNet(ndim=3, n=1, depth=1)
    again.reset_parameters(torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.bottleneck.Conv_1.kernel, tm.bottleneck.Conv_1.kernel,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="depth"):
        T.AttentionUNet(ndim=3, depth=0)
