"""K3's autograd Function (``ops/cuda/conv3d.py``) on the CPU, where it runs
its plain version, against the JAX package's valid 3x3x3 convolution in both
of its forms: the Pallas kernel ``conv3x3x3`` (interpret mode here, with its
custom VJP) and ``TapConv``'s tap decomposition.

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
    assert (k3.fwd_launches, k3.dgrad_launches) == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        k3.conv_launch(x, w)
    with pytest.raises(ValueError, match="w \\[3, 3, 3, 2, Co\\]"):
        k3.conv3x3x3(x, w[:, :, :, :1])
    with pytest.raises(ValueError, match=">= 3"):
        k3.conv3x3x3(x[:, :, :2], w)
