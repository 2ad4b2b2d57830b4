"""The image filters of the PyTorch port against the JAX package, on the CPU,
on the same seeded numpy inputs: the Sobel edge filter (``grad_edges``), the
pad modes, LNCC's box filter and the resizing ops.

The edge mask thresholds a normalized magnitude at 0.2 and 0.9, so a
rounding difference of 1e-7 flips a voxel that lies on a threshold: the
magnitude is compared at rtol 1e-5, and the mask everywhere except within
1e-5 of a threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close_grad, pair, value_and_grad

from torchregister_tpu.losses import similarity as jsim
from torchregister_tpu.ops import edge as jedge
from torchregister_tpu.ops import pad as jpad
from torchregister_tpu.ops import resize as jresize
from torchregister_tpu_torch.losses import similarity as tsim
from torchregister_tpu_torch.ops import edge as tedge
from torchregister_tpu_torch.ops import pad as tpad
from torchregister_tpu_torch.ops import resize as tresize


# ------------------------------------------------------------------ edges


def _jax_magnitude(img):
    """The JAX filter's normalized magnitude, before its thresholds
    (``torchregister_tpu/ops/edge.py:edge_filter``, lines 117-141)."""
    d = img.ndim - 2
    B, C = img.shape[:2]
    spatial = img.shape[2:]
    bank = jnp.asarray(jedge.sobel_kernels_3d() if d == 3 else jedge.sobel_kernels_2d())[:, None]
    padded = jnp.pad(img, [(0, 0), (0, 0)] + [(1, 1)] * d, mode="reflect")
    x = padded.reshape((B * C, 1) + tuple(s + 2 for s in spatial))
    resp = jax.lax.conv_general_dilated(x, bank, (1,) * d, "VALID")
    resp = resp.reshape((B, C, bank.shape[0]) + spatial)
    chan_sum = jnp.sum(resp + jedge.EPSILON, axis=1)
    mag = (1.0 / C) * jnp.sqrt(jnp.sum(chan_sum**2 + jedge.EPSILON, axis=1))
    return np.asarray(jedge._minmax_norm(mag.reshape((B, 1) + spatial)))


def test_torch_sobel_banks_match_jax():
    np.testing.assert_array_equal(tedge.sobel_kernels_3d(), jedge.sobel_kernels_3d())
    np.testing.assert_array_equal(tedge.sobel_kernels_3d(1, 3, 1.5),
                                  jedge.sobel_kernels_3d(1, 3, 1.5))
    np.testing.assert_array_equal(tedge.sobel_kernels_2d(2, 1), jedge.sobel_kernels_2d(2, 1))


@pytest.mark.parametrize("shape", [(2, 3, 10, 11, 12), (1, 1, 14, 9, 13), (3, 2, 20, 17),
                                   (1, 1, 25, 21)], ids=["3d-b2-c3", "3d", "2d-b3-c2", "2d"])
def test_torch_edge_filter_matches_jax(shape):
    """Magnitude at rtol 1e-5 against the JAX filter's, the mask equal away
    from the thresholds, a {0, 1} f32 mask with no gradient."""
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    x = x + np.linspace(0, 3, shape[-1], dtype=np.float32)  # a ramp: edges of all strengths
    want = _jax_magnitude(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    mag = tedge.edge_magnitude(tx).numpy()
    np.testing.assert_allclose(mag, want, rtol=1e-5, atol=1e-6)
    mask = tedge.edge_filter(tx)
    assert mask.dtype == torch.float32 and not mask.requires_grad
    assert mask.shape == (shape[0], 1) + shape[2:]
    jmask = np.asarray(jedge.edge_filter(jnp.asarray(x)))
    away = (np.abs(want - 0.2) > 1e-5) & (np.abs(want - 0.9) > 1e-5)
    np.testing.assert_array_equal(mask.numpy()[away], jmask[away])
    assert 0.0 < jmask.mean() < 1.0


def test_torch_edge_filter_samples_are_independent():
    """Per-sample normalization: a batch gives each sample's own mask, even
    beside a sample of a thousand times the range."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, 9, 10, 11)).astype(np.float32)
    x[1] *= 1000.0
    t = torch.from_numpy(x)
    both = tedge.edge_filter(t)
    for i in range(2):
        torch.testing.assert_close(both[i:i + 1], tedge.edge_filter(t[i:i + 1]), rtol=0, atol=0)
        np.testing.assert_array_equal(both[i:i + 1].numpy(),
                                      np.asarray(jedge.edge_filter(jnp.asarray(x[i:i + 1]))))
    with pytest.raises(ValueError, match="2D/3D"):
        tedge.edge_filter(torch.zeros((1, 1, 8)))


# ------------------------------------------------------------------ pad modes


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "wrap"])
@pytest.mark.parametrize("shape,target", [((1, 2, 5, 6, 7), (9, 4, 12)),
                                          ((2, 1, 3, 4), (11, 13))], ids=["3d-mixed", "2d-wide"])
def test_torch_pad_modes_match_jax(mode, shape, target):
    """``F.pad``'s modes under ``jnp.pad``'s names, through the JAX
    ``pad_nd``: padding, cropping, and (2d-wide) padding past the axis
    length."""
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    kw = dict(value=2.5) if mode == "constant" else {}
    got = tpad.pad_nd(torch.from_numpy(x), target, mode=mode, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpad.pad_nd(jnp.asarray(x), target, mode=mode, **kw)))
    like = np.zeros((1, 1) + tuple(target), np.float32)
    np.testing.assert_array_equal(
        tpad.pad_like(torch.from_numpy(x), torch.from_numpy(like), mode=mode, **kw).numpy(),
        got.numpy())
    ours = tpad.pad_spatial(torch.from_numpy(x), target[1:], first_axis=3, mode=mode, **kw)
    np.testing.assert_array_equal(
        ours.numpy(),
        np.asarray(jpad.pad_spatial(jnp.asarray(x), target[1:], 3, mode=mode, **kw)))


def test_torch_pad_mode_gradient_and_errors():
    """A non-constant pad is a gather: its gradient sums into the sources."""
    x = torch.arange(4.0).reshape(1, 1, 4).requires_grad_(True)
    tpad.pad_nd(x, (8,), mode="reflect").sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jpad.pad_nd(a, (8,), mode="reflect")))(
        jnp.arange(4.0).reshape(1, 1, 4))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    for mode in ("mean", "symmetric"):
        with pytest.raises(ValueError, match="mode"):
            tpad.pad_nd(x, (8,), mode=mode)


# ------------------------------------------------------------------ lncc


@pytest.mark.parametrize("win", [4, 5, 9])
@pytest.mark.parametrize("shape", [(1, 1, 12, 11, 10), (2, 1, 17, 15)], ids=["3d", "2d"])
def test_torch_lncc_matches_jax(shape, win):
    """``reduce_window``'s SAME padding is asymmetric for an even window
    ((win-1)//2 before, win//2 after): pinned by win 4. Values and gradients
    at 1e-5 (both within 2e-6 of a float64 evaluation here); with an offset
    of 50 on the intensities (the global-mean centring) the value only: the
    f32 mean of values near 50 costs the JAX gradient up to 1.2e-4 of its
    largest entry against float64 (the port's 1.6e-5)."""
    y, yp = pair(shape, seed=7)
    (jl, jg), (tl, tg) = value_and_grad(lambda a, b: jsim.lncc(a, b, win=win),
                                         lambda a, b: tsim.lncc(a, b, win=win), y, yp)
    assert tl == pytest.approx(jl, rel=1e-5)
    close_grad(tg, jg, 1e-5)
    off = float(tsim.lncc(torch.from_numpy(y + 50.0), torch.from_numpy(yp + 50.0), win=win))
    assert off == pytest.approx(float(jsim.lncc(jnp.asarray(y + 50.0), jnp.asarray(yp + 50.0),
                                                win=win)), rel=1e-5)
    ones = jnp.ones((1, 1, 7, 6))
    np.testing.assert_array_equal(tsim._box_filter(torch.ones(1, 1, 7, 6), win).numpy(),
                                  np.asarray(jsim._box_filter(ones, win)))


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out", [((1, 2, 9, 7, 5), (12, 7, 3)), ((2, 1, 16, 10), (5, 21))])
def test_torch_nearest_resize_and_max_pool(shape, out, dtype):
    """Both select values, so they agree exactly, in the input's dtype."""
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tresize.nearest_resize(tx, out)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jresize.nearest_resize(jx, out)).astype(np.float32))
    for k, stride in ((2, None), (3, 2)):
        got = tresize.max_pool(tx, k, stride)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(jresize.max_pool(jx, k, stride)).astype(np.float32))
    with pytest.raises(ValueError, match="dims"):
        tresize.nearest_resize(tx, out[:-1])
