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


def _dyadic_row(case, rng):
    """``(idx, f)`` of one row of ``3 * 2048 + 77`` samples (a ragged block
    and warp) whose weights are multiples of 2^-10, so that every bin's sum is
    exact in any order: ``sorted``, bins that never decrease along the row
    (every step already sorted); ``one_bin``, every sample in bin 300;
    ``reversed``, each step's bins falling in lane order (the kernel's full
    sort)."""
    L = 3 * 2048 + 77
    f = torch.from_numpy(rng.integers(0, 1024, L).astype(np.float32) / 1024.0)
    if case == "sorted":
        idx = np.sort(rng.integers(0, ks.BINS - 1, L))
    elif case == "one_bin":
        idx = np.full(L, 300)
    else:  # each step of 32 lanes holds 32 - lane (plus the step's own offset)
        pos = np.arange(L)
        idx = 40 + (pos // 32) % 100 + (31 - pos % 32) * 7
    return torch.from_numpy(idx.astype(np.int32))[None], f[None]


@pytest.mark.parametrize("case", ["sorted", "one_bin", "reversed", "signed"])
def test_torch_splat_ordered_exact_on_dyadic_weights(case):
    """With weights that are multiples of 2^-10 and small counts every order
    of additions is exact, so the kernel's order (sorted runs, the scan's
    tree) equals the plain version to the bit: on steps already sorted, on
    one bin, on steps in reverse lane order, and in the signed mode."""
    rng = np.random.default_rng(17)
    idx, f = _dyadic_row("reversed" if case == "signed" else case, rng)
    signed = case == "signed"
    got = ks.splat_ordered(idx, f, signed=signed)
    assert torch.equal(got, ks.splat_plain(idx, f, signed=signed))
    if case == "one_bin":
        assert float(got[0, 300] + got[0, 301]) == f.shape[1]


def _tree(x, a, t):
    """The scan's sum at sorted lane ``t`` of a run starting at lane ``a``,
    written as its tree: after the round of distance d a lane holds its own
    value plus, where lane - d is still in the run, that lane's."""
    def val(lane, level):
        if level == 0:
            return x[lane]
        d = 1 << (level - 1)
        if lane - d >= a:
            return np.float32(val(lane - d, level - 1) + val(lane, level - 1))
        return val(lane, level - 1)
    return val(t, 5)


def _direct_warp(steps_bin, steps_w0, steps_w1):
    """One warp's histogram, then the block's and the row's sums, written
    per step and bin without a sort or a scan: a bin's lanes in ascending
    lane order take the sorted lanes after every lane of a smaller bin, and
    its sum is :func:`_tree` over them; each bin's ``w0`` sum goes into the
    bin, then each bin's ``w1`` sum into the next."""
    h = np.zeros(ks.BINS, np.float32)
    for bins, w0, w1 in zip(steps_bin, steps_w0, steps_w1):
        s0, s1 = {}, {}
        for b in sorted(set(bins.tolist())):
            lanes = [lane for lane in range(32) if bins[lane] == b]
            a = int((bins < b).sum())
            x0 = {a + k: np.float32(w0[lane]) for k, lane in enumerate(lanes)}
            x1 = {a + k: np.float32(w1[lane]) for k, lane in enumerate(lanes)}
            t = a + len(lanes) - 1
            s0[b], s1[b] = _tree(x0, a, t), _tree(x1, a, t)
        for b, v in s0.items():
            h[b] = np.float32(h[b] + v)
        for b, v in s1.items():
            h[b + 1] = np.float32(h[b + 1] + v)
    part = np.float32(0.0) + h  # warp 0; the block's other warps hold zeros
    for _ in range(ks.WARPS - 1):
        part = part + np.float32(0.0)
    return np.float32(0.0) + part


def test_torch_splat_run_sums_match_a_direct_tree():
    """The kernel's order of one warp (``splat_ordered`` on a row of 2048
    samples: one warp of one block) against :func:`_direct_warp` on
    hand-made 32-lane steps with weights of full precision, to the bit:
    one bin, a few bins scattered over the lanes, reverse lane order, two
    alternating bins, a step already sorted, distinct bins, runs at both
    ends."""
    rng = np.random.default_rng(23)
    lane = np.arange(32)
    made = [np.full(32, 5), rng.integers(10, 14, 32), 900 - 3 * lane, 20 + (lane % 2),
            np.sort(rng.integers(0, 60, 32)), 100 + lane, np.where(lane < 3, 7, 600)]
    steps = [made[s % len(made)] + (s // len(made)) for s in range(ks.STEPS)]
    bins = np.stack(steps).astype(np.int64)
    w1 = rng.random((ks.STEPS, 32), dtype=np.float32)
    w0 = np.float32(1.0) - w1
    # a warp's steps are its 32 consecutive samples at a time
    idx, f = bins.reshape(-1).astype(np.int32), w1.reshape(-1)
    got = ks.splat_ordered(torch.from_numpy(idx)[None], torch.from_numpy(f)[None])
    want = _direct_warp(bins, w0, w1)
    assert np.array_equal(got[0].numpy(), want)
    assert not np.array_equal(got[0].numpy(), ks.splat_plain(
        torch.from_numpy(idx)[None], torch.from_numpy(f)[None])[0].numpy())
