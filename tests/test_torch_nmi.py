"""The NMI stack of the PyTorch port against the JAX package, on the CPU, on
the same seeded numpy inputs.

Tolerances, measured against a float64 evaluation of the port's formulas on
these inputs:

- densities (``get_pdf``, the exact KDE and the binned one) and the NMI and
  MI values themselves: rtol 1e-6 on the exact path, 1e-5 on the binned one
  (the splat sums in another order than the JAX one-hot products);
- ``nmi_loss`` is ``1000 |NMI - 1|``, a difference of near-equal f32
  numbers: f32 rounding of the entropies (~1e-7) becomes ~1e-5 of the loss
  (float64 against the JAX package 1.4e-6, against the port 9.4e-6 on the
  binned path), so the loss is held to rtol 3e-5 and its gradient to 3e-4 of
  its largest entry (float64 against the JAX gradient 1.8e-4, against the
  port's 5.3e-5).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close_grad, pair, value_and_grad

# the packages' ``losses`` export a function named ``nmi`` over the module
jn = importlib.import_module("torchregister_tpu.losses.nmi")
tn = importlib.import_module("torchregister_tpu_torch.losses.nmi")


# ------------------------------------------------------------------ nmi


# (shape, intensity scale, bandwidth, branch): bandwidth 0.05 on the unit range
# resolves the fine grid (binned); 0.002 does not (exact); on a 0-1000 range
# the default bandwidth 3.0 takes the exact path
NMI_CASES = [((2, 1, 10, 9, 8), 1.0, 0.002, "exact"), ((3, 2, 14, 13), 1.0, 0.05, "binned"),
             ((1, 1, 9, 8, 7), 1000.0, 3.0, "exact")]


@pytest.mark.parametrize("shape,scale,bw,branch", NMI_CASES,
                         ids=[f"{c[3]}-{len(c[0]) - 2}d-{c[1]:g}" for c in NMI_CASES])
def test_torch_nmi_values_and_grads(shape, scale, bw, branch):
    y, yp = pair(shape, scale, seed=1)
    both = np.concatenate([y.ravel(), yp.ravel()])
    assert tn._binned_ok(bw, torch.tensor(both.min()), torch.tensor(both.max())) == (
        branch == "binned")
    def jfn(p):
        v, m = jn.nmi(jnp.asarray(y), p, bins=64, bandwidth=bw)
        return jnp.sum(v), (v, m)

    (_, (jv, jm)), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(yp))
    p = torch.from_numpy(yp).requires_grad_(True)
    calls = dict(tn.branch_calls)
    tv, tm = tn.nmi(torch.from_numpy(y), p, bins=64, bandwidth=bw)
    calls[branch] += 1
    assert tn.branch_calls == calls  # the branch taken, counted once
    torch.sum(tv).backward()
    rtol = 1e-5 if branch == "binned" else 1e-6
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=rtol)
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), rtol=10 * rtol)
    close_grad(p.grad.numpy(), np.asarray(jg), 3e-4)


@pytest.mark.parametrize("patch,bw", [(4, 0.05), (6, 0.002)])
def test_torch_nmi_loss_matches_jax(patch, bw):
    """``nmi_loss`` with the raw-buffer patches at small patch sizes on a 3D
    pair, both branches."""
    y, yp = pair((1, 1, 16, 16, 16), seed=2)
    kw = dict(patch_size=patch, bandwidth=bw)
    (jl, jg), (tl, tg) = value_and_grad(lambda a, b: jn.nmi_loss(a, b, **kw),
                                         lambda a, b: tn.nmi_loss(a, b, **kw), y, yp)
    assert tl == pytest.approx(jl, rel=3e-5)
    close_grad(tg, jg, 3e-4)


def test_torch_nmi_loss_default_patch_2d():
    """The defaults (patch 100, bandwidth 3, alpha 1000) on a 2D image with
    intensities up to 255: resized to 200², four patches, binned path."""
    y, yp = pair((1, 1, 60, 50), scale=255.0, seed=3)
    (jl, jg), (tl, tg) = value_and_grad(jn.nmi_loss, tn.nmi_loss, y, yp)
    assert tl == pytest.approx(jl, rel=3e-5)
    close_grad(tg, jg, 3e-4)


def test_torch_nmi_bf16_input_sums_in_f32():
    """bf16 images are upcast before the KDE, as in the JAX package."""
    y, yp = pair((2, 1, 12, 10), seed=4)
    jv, _ = jn.nmi(jnp.asarray(y).astype(jnp.bfloat16), jnp.asarray(yp).astype(jnp.bfloat16),
                   bins=32, bandwidth=0.05)
    tv, _ = tn.nmi(torch.from_numpy(y).bfloat16(), torch.from_numpy(yp).bfloat16(), bins=32,
                   bandwidth=0.05)
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)


@pytest.mark.parametrize("method", ["auto", "exact"])
def test_torch_get_pdf_matches_jax(method):
    """Densities and their gradients on both paths ('auto' takes the binned
    one here, as 'binned' would); 8500 voxels a row, so the exact KDE runs
    its checkpointed chunk (8192) and a remainder."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(2, 8500)).astype(np.float32)
    binned = method != "exact"
    jp = np.asarray(jn.get_pdf(jnp.asarray(data), steps=48, bandwidth=0.3, method=method))
    tp = tn.get_pdf(torch.from_numpy(data), steps=48, bandwidth=0.3, method=method).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5 if binned else 1e-6,
                               atol=1e-7 * np.abs(jp).max())
    w = rng.normal(size=(2, 48)).astype(np.float32)
    jg = np.asarray(jax.grad(lambda d: jnp.sum(jn.get_pdf(d, 48, 0.3, method) * w))(
        jnp.asarray(data)))
    d = torch.from_numpy(data).requires_grad_(True)
    torch.sum(tn.get_pdf(d, 48, 0.3, method) * torch.from_numpy(w)).backward()
    # binned: each voxel's gradient is the bins' cotangents (the kernel
    # contraction's transpose, summed in another order) times 1/delta
    close_grad(d.grad.numpy(), jg, 1e-4 if binned else 1e-5)
    if binned:
        torch.testing.assert_close(tn.get_pdf(torch.from_numpy(data), 48, 0.3, "binned"),
                                   torch.from_numpy(tp), rtol=0, atol=0)
    with pytest.raises(ValueError, match="method"):
        tn.get_pdf(torch.from_numpy(data), method="fast")


def test_torch_kde_pdf_and_sample_points():
    """The exact KDE at given sample points, and the descending sample
    points of ``jnp.linspace`` reproduced to the bit."""
    rng = np.random.default_rng(6)
    s = rng.random((3, 500)).astype(np.float32)
    xis = np.linspace(1.0, 0.0, 33).astype(np.float32)
    np.testing.assert_allclose(
        tn.kde_pdf(torch.from_numpy(s), torch.from_numpy(xis), 0.1, chunk=128).numpy(),
        np.asarray(jn.kde_pdf(jnp.asarray(s), jnp.asarray(xis), 0.1, chunk=128)), rtol=1e-6)
    for n in (2, 64, 256, 1024):
        np.testing.assert_array_equal(tn._unit_linspace(n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_torch_clip_splits_a_tie_gradient_like_jax():
    """``_clip`` (its bounds filled on the input's device, no host copy)
    against ``jnp.clip``: values and gradients, half the gradient at each
    bound where the input equals it."""
    x = np.array([-1.0, 0.0, 0.5, 3.0, 4.0], np.float32)
    jv, jg = jax.value_and_grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 3.0) * jnp.arange(1.0, 6.0)))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = torch.sum(tn._clip(t, 0.0, 3.0) * torch.arange(1.0, 6.0))
    tv.backward()
    assert float(tv.detach()) == float(jv)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert t.grad[1] == 1.0 and t.grad[3] == 2.0  # halves of 2 and 4


# the range past which the binned test fails, (G - 1) bandwidth / 4, for each bandwidth
FLIP = {3.0: 767.25, 0.1: 25.575}


@pytest.mark.parametrize("side", [-2, -1, 0, 1, 2])
@pytest.mark.parametrize("bw", sorted(FLIP))
def test_torch_binned_ok_flips_where_jax_does(bw, side):
    """``_binned_ok`` is JAX's f32 predicate ``bandwidth >= 4 |range| /
    (G - 1)`` as a device tensor: equal to it a few ulps either side of the
    range where it flips (``nmi``'s form, ``get_pdf``'s operand order too)."""
    hi = np.float32(FLIP[bw])
    for _ in range(abs(side)):
        hi = np.nextafter(hi, np.float32(np.inf if side > 0 else -np.inf), dtype=np.float32)
    lo = np.float32(0.0)
    want = bool(float(bw) >= 4.0 * (jnp.abs(jnp.float32(lo) - jnp.float32(hi)) / 1023))
    got = tn._binned_ok(bw, torch.tensor(hi), torch.tensor(lo))
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want
    assert bool(tn._binned_ok(bw, torch.tensor(lo), torch.tensor(hi))) == want


def test_torch_binned_ok_threshold_has_both_sides():
    """The cases above straddle the flip: some take the binned path, some not."""
    took = {bool(tn._binned_ok(bw, torch.tensor(np.float32(0.0)), torch.tensor(np.float32(r))))
            for bw, flip in FLIP.items() for r in (flip * 0.999, flip * 1.001)}
    assert took == {True, False}


def test_torch_nmi_device_counter_counts_one_branch_a_call():
    """``branch_calls`` adds each call's flag on the device: one count a
    call, on the branch it took; ``reset`` zeroes it."""
    y, yp = pair((2, 1, 8, 8), seed=7)
    counter = tn.branch_calls
    before = dict(counter)
    tn.nmi(torch.from_numpy(y), torch.from_numpy(yp), bins=16, bandwidth=0.05)
    tn.nmi(torch.from_numpy(y), torch.from_numpy(yp), bins=16, bandwidth=0.05)
    tn.nmi(torch.from_numpy(y * 1000), torch.from_numpy(yp * 1000), bins=16, bandwidth=0.05)
    assert {k: counter[k] - before[k] for k in before} == {"binned": 2, "exact": 1}
    assert set(counter) == {"binned", "exact"} and len(counter) == 2
    counter.reset()
    assert dict(counter) == {"binned": 0, "exact": 0}


def test_torch_kde_second_order_matches_jax_hessian():
    """The plain exact KDE (the CPU path), twice differentiated by autograd
    through its checkpointed chunks and remainder, against ``jax.hessian``
    of the JAX package's ``kde_pdf`` under a nonlinear read-out (so both
    second-order terms count)."""
    rng = np.random.default_rng(8)
    s = rng.random((2, 12)).astype(np.float32)
    xis = np.linspace(1.0, 0.0, 16).astype(np.float32)
    w = rng.normal(size=(2, 16)).astype(np.float32)

    def jf(a):
        p = jn.kde_pdf(a, jnp.asarray(xis), 0.2, chunk=8)
        return jnp.sum(w * p + p * p)

    jh = np.asarray(jax.hessian(jf)(jnp.asarray(s)))

    def tf(a):
        p = tn.kde_pdf(a, torch.from_numpy(xis), 0.2, chunk=8)
        return torch.sum(torch.from_numpy(w) * p + p * p)

    th = torch.autograd.functional.hessian(tf, torch.from_numpy(s)).numpy()
    close_grad(th, jh, 1e-5)
