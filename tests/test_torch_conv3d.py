"""K3's autograd Function (``ops/cuda/conv3d.py``) on the CPU, where it runs
its plain versions, against the JAX package's valid 3x3x3 convolution in both
of its forms: the Pallas kernel ``conv3x3x3`` (interpret mode here, with its
custom VJP) and ``TapConv``'s tap decomposition; its input gradient (the plain
convolution with padding 2) and its weight gradient (``wgrad_plain``) against
the JAX VJP's and ``_wgrad_xla``.

Tolerances: f32 forwards rtol 1e-5 (both sum 27·Ci f32 products, in another
order); gradients rtol 1e-4, as the JAX package's own VJP test holds them;
bf16 one bf16 rounding (2^-7 of the largest value): both sum bf16 products in
f32 and round once.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torchregister_tpu.models.attention_unet import TapConv as JTapConv
from torchregister_tpu.ops.pallas.conv3d import _wgrad_xla
from torchregister_tpu.ops.pallas.conv3d import conv3x3x3 as j_conv
from torchregister_tpu_torch.ops.cuda import conv3d as k3

# the shapes of tests/test_pallas_conv3d.py (first layer, odd sizes, W past
# 128, large H), each also at N=2
SHAPES = [((8, 12, 13), 1, 8), ((7, 10, 18), 8, 8), ((6, 9, 130), 4, 6),
          ((6, 140, 140), 8, 8)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tap(x, w):
    """The tap path of the JAX U-Net's TapConv (no bias), x [N, Ci, *S]."""
    conv = JTapConv(features=w.shape[-1], ndim=3, use_bias=False, use_pallas=False)
    return np.asarray(conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x)))


@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("shape,ci,co", SHAPES, ids=["first", "odd", "w130", "large_h"])
def test_torch_conv3x3x3_forward_matches_jax(shape, ci, co, N):
    x = _rand((N, ci) + shape, 1)
    w = _rand((3, 3, 3, ci, co), 2, 0.2)
    ours = k3.conv3x3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert ours.shape == (N, co) + tuple(s - 2 for s in shape)
    pallas = np.stack([np.asarray(j_conv(jnp.asarray(x[n]), jnp.asarray(w)))
                       for n in range(N)])
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, _tap(x, w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [1, 2])
def test_torch_conv3x3x3_grads_match_jax_vjp(N):
    """dx (the plain version on the cotangent padded by 2, weights flipped
    and Ci/Co swapped) and dw (27 contractions) against JAX's custom VJP."""
    ci, co = 4, 6
    x = _rand((N, ci, 8, 10, 12), 5)
    w = _rand((3, 3, 3, ci, co), 6, 0.2)
    t = _rand((N, co, 6, 8, 10), 7)

    def loss_jax(x_, w_):
        out = jnp.stack([j_conv(x_[n], w_) for n in range(N)])
        return jnp.sum((out - t) ** 2)

    jgx, jgw = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ((k3.conv3x3x3(tx, tw) - torch.from_numpy(t)) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-4)


def test_torch_conv3x3x3_bf16_matches_jax():
    """bf16 input and weights: the output is bf16, one rounding from the
    JAX kernel's; the gradients keep the operands' dtypes."""
    ci, co = 8, 8
    x = _rand((1, ci, 8, 10, 12), 8)
    w = _rand((3, 3, 3, ci, co), 9, 0.2)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    ref = np.asarray(j_conv(jx[0], jw), np.float32)[None]
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    out = k3.conv3x3x3(tx, tw)
    assert out.dtype == torch.bfloat16
    err = np.max(np.abs(out.detach().float().numpy() - ref))
    assert err <= 2.0**-7 * np.max(np.abs(ref))
    out.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16


def test_torch_conv3x3x3_cpu_runs_the_plain_version():
    """On the CPU the Function takes the plain version: no launch counted,
    and the same values as ``conv3x3x3_plain``; the raw launcher refuses
    CPU tensors and bad shapes."""
    x = torch.from_numpy(_rand((1, 2, 5, 6, 7), 10))
    w = torch.from_numpy(_rand((3, 3, 3, 2, 3), 11, 0.2))
    k3.reset_counts()
    torch.testing.assert_close(k3.conv3x3x3(x, w), k3.conv3x3x3_plain(x, w), rtol=0, atol=0)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    k3.conv3x3x3(xs, ws).sum().backward()
    assert (k3.fwd_launches, k3.dgrad_launches, k3.wgrad_launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        k3.conv_launch(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        k3.wgrad_launch(x, torch.zeros((1, 3, 3, 4, 5)))
    with pytest.raises(ValueError, match="g \\[N, Co, Z-2, H-2, W-2\\]"):
        k3.wgrad_plain(x, torch.zeros((1, 3, 3, 4, 4)))
    with pytest.raises(ValueError, match="padding 0"):
        k3.conv3x3x3_plain(x, w, pad=1)
    with pytest.raises(ValueError, match="w \\[3, 3, 3, 2, Co\\]"):
        k3.conv3x3x3(x, w[:, :, :, :1])
    with pytest.raises(ValueError, match=">= 3"):
        k3.conv3x3x3(x[:, :, :2], w)


# the U-Net's (Ci, Co) pairs: the Sobel filter's 1 -> 9, the first layers'
# 1 -> 8 and 1 -> 2, the 120³ level's, the bottleneck's 16 -> 32 and the
# decoder's 32 -> 16
UNET_PAIRS = [(1, 9), (1, 8), (1, 2), (8, 8), (8, 16), (16, 32), (32, 16)]


@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("ci,co", UNET_PAIRS)
def test_torch_wgrad_plain_matches_jax_wgrad_xla(ci, co, N):
    """``wgrad_plain`` (27 f32 matmuls, the weight-gradient kernel's plain
    version) against ``_wgrad_xla`` summed over the batch."""
    x = _rand((N, ci, 6, 7, 9), 20 + ci)
    g = _rand((N, co, 4, 5, 7), 30 + co)
    ours = k3.wgrad_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert ours.shape == (3, 3, 3, ci, co) and ours.dtype == np.float32
    ref = sum(np.asarray(_wgrad_xla(jnp.asarray(x[n]), jnp.asarray(g[n]))) for n in range(N))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ci,co", UNET_PAIRS)
def test_torch_conv3x3x3_dgrad_padding_2_matches_jax_vjp(ci, co):
    """The Function's backward formulas as the card runs them, on the CPU:
    dx is the convolution with padding 2 of the cotangent itself (no padded
    copy), weights flipped in space and Ci, Co swapped; dw the weight
    gradient. Both against JAX's custom VJP of the Pallas kernel."""
    x = _rand((ci, 5, 6, 8), 40 + ci)
    w = _rand((3, 3, 3, ci, co), 50 + co, 0.2)
    g = _rand((co, 3, 4, 6), 60 + ci + co)
    _, vjp = jax.vjp(j_conv, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    w_t = torch.from_numpy(w).flip((0, 1, 2)).transpose(3, 4)
    dx = k3._conv(torch.from_numpy(g)[None], w_t, 2)[0].numpy()
    assert dx.shape == x.shape
    np.testing.assert_allclose(dx, jdx, rtol=1e-4, atol=1e-4)
    gp = torch.from_numpy(np.pad(g, ((0, 0),) + ((2, 2),) * 3))[None]
    np.testing.assert_allclose(dx, k3.conv3x3x3_plain(gp, w_t)[0].numpy(), rtol=0, atol=1e-6)
    dw = k3._wgrad(torch.from_numpy(x)[None], torch.from_numpy(g)[None]).numpy()
    np.testing.assert_allclose(dw, jdw, rtol=1e-4, atol=1e-4)


def test_torch_wgrad_splits():
    """The weight-gradient kernel's split of the voxels: about 264 blocks
    (two on each of the H100's 132 SMs) over its chunks of 8 input and up to
    32 output channels, at least one, never more than the 4 x 32 output tiles."""
    assert k3.wgrad_splits(1, 8, 8, 118, 118, 118) == 264
    assert k3.wgrad_splits(1, 32, 16, 54, 54, 54) == 66
    assert k3.wgrad_splits(1, 16, 32, 27, 27, 27) == 132
    assert k3.wgrad_splits(1, 1, 8, 5, 6, 7) == 3
    assert k3.wgrad_splits(2, 1024, 1024, 5, 5, 5) == 1
