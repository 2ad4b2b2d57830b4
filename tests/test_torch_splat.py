"""The binned NMI's splat (``ops/cuda/splat.py``) on the CPU: its plain
version against the JAX package's ``_binned_histogram``, the kernel's order
of additions (``splat_ordered``) against the plain version, and the
backward's gather against autograd through the plain version.

Tolerance of two splats against each other: each bin within ``2 n u`` of its
mass (the sum of its terms' absolute values), n the bin's count of terms and
u = 2^-24. Any order of f32 additions of n terms lies within (n - 1) u of the
mass from the exact sum, so two orders lie within twice that; a bin that
takes every sample (a constant image at a fractional bin) makes the rounding
of a serial sum systematic, and there the difference does approach the
bound, which no fixed relative tolerance would hold at every L.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchregister_tpu_torch.ops.cuda import splat as ks

# the packages' ``losses`` export a function named ``nmi`` over the module
jn = importlib.import_module("torchregister_tpu.losses.nmi")
tn = importlib.import_module("torchregister_tpu_torch.losses.nmi")

U = 2.0**-24


def _bound(idx, f):
    """``2 n u`` times each bin's mass: ``[N, BINS]``."""
    idx = idx.long()
    ones = torch.ones_like(f, dtype=torch.float64)
    n = torch.zeros((f.shape[0], ks.BINS), dtype=torch.float64)
    n = n.scatter_add(1, idx, ones).scatter_add(1, idx + 1, ones)
    f64 = f.double()
    mass = torch.zeros_like(n).scatter_add(1, idx, 1.0 - f64).scatter_add(1, idx + 1, f64)
    return 2.0 * n * U * mass


def _close(a, b, bound):
    d = (a.double() - b.double()).abs()
    assert bool((d <= bound).all()), float((d - bound).max())


def _signals(kind, N, L, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((N, L), dtype=np.float32)
    if kind == "one_bin":  # every sample at one fractional bin position
        return np.full((N, L), 0.3141, np.float32)
    # a background that takes half the samples, the rest spread
    s = rng.random((N, L), dtype=np.float32) ** 2
    s[:, ::2] = 0.0
    return s


@pytest.mark.parametrize("kind", ["uniform", "one_bin", "background"])
@pytest.mark.parametrize("L", [4096, 10001])
def test_torch_splat_plain_matches_jax_binned_histogram(kind, L):
    """The port's ``_binned_histogram`` on the CPU (the plain splat) against
    the JAX package's (one-hot products, chunks of 4096: ``L = 10001``
    leaves a ragged tail) on the joint range ``[1, 0]``, at ``2 n u`` of
    each bin's mass, and its gradient in the signals against JAX's VJP at
    that of the cotangent's largest entry."""
    s = _signals(kind, 2, L, L)
    x0, xe = np.float32(1.0), np.float32(0.0)
    want = np.asarray(jn._binned_histogram(jnp.asarray(s), x0, xe))
    st = torch.from_numpy(s).requires_grad_(True)
    got = tn._binned_histogram(st, torch.tensor(x0), torch.tensor(xe))
    delta = (xe - x0) / np.float32(ks.BINS - 1)
    p = np.clip((s - x0) / delta, 0.0, ks.BINS - 1.0)
    i0 = np.clip(np.floor(p), 0.0, ks.BINS - 2.0)
    _close(got.detach(), torch.from_numpy(want),
           _bound(torch.from_numpy(i0.astype(np.int32)), torch.from_numpy(p - i0)))
    g = np.random.default_rng(1).standard_normal((2, ks.BINS)).astype(np.float32)
    got.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x: jn._binned_histogram(x, x0, xe), jnp.asarray(s))
    (jg,) = vjp(jnp.asarray(g))
    # JAX's backward is one default-precision product (its module says
    # ~2e-3 relative); the port's an f32 gather
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=4e-3 * np.abs(g).max() / abs(float(delta)))


@pytest.mark.parametrize("kind", ["uniform", "one_bin", "background"])
def test_torch_splat_ordered_matches_plain(kind):
    """The kernel's order (``splat_ordered``: blocks of ``CHUNK``, warps,
    steps, the ``1 - f`` terms then the ``f`` terms in lane order) against
    the plain version at ``2 n u`` of each bin's mass, on three rows whose
    length leaves a ragged block and a ragged warp; a constant row with f = 0
    sums exactly in any order."""
    N, L = 3, 2 * ks.CHUNK + 3 * 2048 + 37
    s = torch.from_numpy(_signals(kind, N, L, 5))
    p = (s * (ks.BINS - 1)).clamp(0, ks.BINS - 1.0)
    i0 = torch.floor(p).clamp(0, ks.BINS - 2.0)
    idx, f = i0.to(torch.int32), p - i0
    got = ks.splat_ordered(idx, f)
    want = ks.splat_plain(idx, f)
    _close(got, want, _bound(idx, f))
    zero = torch.zeros((1, L))
    ones = ks.splat_ordered(torch.full((1, L), 7, dtype=torch.int32), zero)
    assert float(ones[0, 7]) == L and float(ones.sum()) == L


def test_torch_splat_grad_is_autograd_of_the_plain_version():
    """The Function's backward, ``g[idx + 1] - g[idx]``, equals autograd
    through the two ``scatter_add`` to the bit."""
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, ks.BINS - 1, (4, 3000)).astype(np.int32))
    f = torch.from_numpy(rng.random((4, 3000), dtype=np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((4, ks.BINS)).astype(np.float32))
    ks.splat_plain(idx, f).backward(g)
    assert torch.equal(ks.splat_grad(g, idx), f.grad)


def test_torch_splat_dispatch_and_checks():
    """A CPU tensor takes the plain version; a device with no path raises;
    the launcher checks shapes, dtypes and the device before any build."""
    idx = torch.zeros((2, 5), dtype=torch.int32)
    f = torch.full((2, 5), 0.25)
    assert torch.equal(ks.splat(idx, f), ks.splat_plain(idx, f))
    with pytest.raises(RuntimeError, match="no path"):
        ks.splat(idx.to("meta"), f.to("meta"))
    with pytest.raises(ValueError, match="one shape"):
        ks.splat_launch(idx[:, :4], f)
    with pytest.raises(TypeError):
        ks.splat_launch(idx.long(), f)
    with pytest.raises(ValueError, match="CUDA"):
        ks.splat_launch(idx, f)
