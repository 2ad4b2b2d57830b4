"""The exact KDE's cut (``ops/cuda/kde.CUT``) on the CPU.

The kernels (``csrc/kde.cu``) compute only the terms within ``|u| <= 14``
and run only on the card (``tests/test_torch_cuda.py``). Here: every term
past the cut is below f32's smallest normal, for each of phi, phi' and
phi'', in f64 and in f32; ``kde_terms_needed`` (the count behind
``chip_smoke.py``'s bound) against a brute-force count; the points that
``losses/nmi`` hands the KDE are non-increasing (the order the kernels'
window search is fast for), checked against the JAX package's points; and
on a dense ``[N, L, P]`` evaluation the terms the cut drops sum to below
1e-30, the plain version's sum with and without them equal within rounding.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchregister_tpu_torch.ops.cuda import kde

tnmi = importlib.import_module("torchregister_tpu_torch.losses.nmi")

FLT_MIN = float(np.finfo(np.float32).tiny)
DERIVS = {"phi": 0, "dphi": 1, "d2phi": 2}


def _psi(u: torch.Tensor, deriv: int) -> torch.Tensor:
    """psi(u) through the plain version's terms (s = u h, xi = 0, h = 1)."""
    return kde._terms(u[None, :], torch.zeros(1, dtype=u.dtype), 1.0, deriv)[0, :, 0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("deriv", DERIVS.values(), ids=DERIVS.keys())
def test_torch_kde_cut_terms_below_flt_min(deriv, dtype):
    """For 14 <= |u| <= 1e19 (past 1e19 u^2 overflows f32 and phi'' is
    NaN, which the kernels keep), |psi(u)| < FLT_MIN; at |u| = 13 phi is
    still a normal, so the cut drops nothing that f32 holds as one."""
    fine = np.linspace(CUT := kde.CUT, 40.0, 200001)
    u = np.concatenate([fine, np.geomspace(40.0, 1e19, 2001)])
    u = torch.from_numpy(np.concatenate([u, -u])).to(dtype)
    assert float(u.abs().min()) >= CUT
    vals = _psi(u, deriv)
    assert bool(torch.isfinite(vals).all())
    assert float(vals.abs().max()) < FLT_MIN
    assert float(_psi(torch.tensor([13.0], dtype=dtype), 0)) > FLT_MIN


def _brute_count(s: torch.Tensor, xis: torch.Tensor, h: float) -> int:
    s64, x64 = s.double().reshape(-1, 1), xis.double().reshape(1, -1)
    near = (s64 - x64).abs() <= kde.CUT * h
    nonfinite = ~torch.isfinite(s64) | ~torch.isfinite(x64)
    return int((near | nonfinite).sum())


def _rows(seed, N=3, L=2000, scale=4000.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((N, L)) * scale).astype(np.float32))


def _count_case(name):
    s = _rows(7)
    lin = torch.linspace(float(s.max()), float(s.min()), 256)
    h = 3.0
    if name == "descending":
        return s, lin, h
    if name == "ascending":
        return s, lin.flip(0), h
    if name == "constant":
        s = torch.full((2, 500), 77.25)
        return s, torch.full((64,), 77.25), h
    if name == "one_point":
        return s, torch.tensor([1999.0]), h
    if name == "wide_bandwidth":
        return s, lin, 1000.0
    if name == "sparse":
        return s, torch.linspace(float(s.max()), float(s.min()), 8), 0.5
    if name == "nonfinite_samples":
        s = s.clone()
        s[0, 3], s[1, 10], s[2, 99] = float("nan"), float("inf"), -float("inf")
        return s, lin, h
    raise KeyError(name)


COUNT_CASES = ["descending", "ascending", "constant", "one_point", "wide_bandwidth", "sparse",
               "nonfinite_samples"]


@pytest.mark.parametrize("name", COUNT_CASES)
def test_torch_kde_terms_needed_matches_brute_force(name):
    """``kde_terms_needed`` equals a brute-force count over every pair:
    descending and ascending linspace points, a constant row (every point
    equal: every pair), one point, a bandwidth wider than the range
    (nothing dropped), points spaced far wider than the cut (nearly
    everything dropped), NaN and inf samples (never dropped)."""
    s, xis, h = _count_case(name)
    got = kde.kde_terms_needed(s, xis, h)
    assert got == _brute_count(s, xis, h)
    dense = s.numel() * xis.numel()
    if name in ("constant", "wide_bandwidth"):
        assert got == dense
    if name == "sparse":
        assert got < s.numel() * 2
    if name == "nonfinite_samples":
        assert got >= 3 * xis.numel()
    if name in ("descending", "ascending"):
        assert got < dense // 10  # the cut drops most terms at this spacing


def test_torch_kde_terms_needed_bandwidth_not_positive():
    """A bandwidth that is not positive and finite drops nothing."""
    s, xis, _ = _count_case("descending")
    for h in (0.0, -1.0, float("inf"), float("nan")):
        assert kde.kde_terms_needed(s, xis, h) == s.numel() * xis.numel()


def _tied_rows(seed, N=4, L=3000):
    """Rows with many ties (integers in a small range) and one constant row."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, size=(N, L)).astype(np.float32) * 25.0
    a[-1] = 300.0
    return a


def _captured_points(monkeypatch, call):
    """The ``xis`` each ``kde_acc`` call of ``call()`` receives."""
    seen = []
    real = kde.kde_acc

    def spy(s, xis, h, binned=None, chunk=kde.PLAIN_CHUNK):
        seen.append(xis.detach().clone())
        return real(s, xis, h, binned, chunk)

    with monkeypatch.context() as mp:
        mp.setattr(kde, "kde_acc", spy)
        call()
    return seen


def _non_increasing(x: torch.Tensor) -> bool:
    return bool((x[1:] <= x[:-1]).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_kde_points_non_increasing(seed, monkeypatch):
    """``_sample_points`` and the points ``get_pdf`` and ``nmi`` hand the
    KDE are non-increasing for random rows with ties (and a constant row),
    and equal the JAX package's points to the bit."""
    a = _tied_rows(seed)
    for row in (a, a[-1:]):
        pts = tnmi._sample_points(torch.from_numpy(row), 256)
        assert _non_increasing(pts)
        j = jnp.asarray(row)  # the JAX package's points (losses/nmi.py: get_pdf, nmi)
        want = np.asarray(jnp.linspace(0.0, 1.0, 256, dtype=j.dtype) * (j.min() - j.max())
                          + j.max())
        np.testing.assert_array_equal(pts.numpy(), want)
    t = torch.from_numpy(a)
    seen = _captured_points(monkeypatch, lambda: tnmi.get_pdf(t, 256, 3.0, method="exact"))
    seen += _captured_points(monkeypatch, lambda: tnmi.nmi(t[:, :1500], t[:, 1500:], 256, 3.0))
    assert len(seen) == 4
    for pts in seen:
        assert pts.shape == (256,) and _non_increasing(pts)


@pytest.mark.parametrize("deriv", DERIVS.values(), ids=DERIVS.keys())
def test_torch_kde_dropped_terms_sum_below_1e30(deriv):
    """On a dense evaluation of rows at a CT-like range (bandwidth 3, 256
    points), the terms past the cut sum to below 1e-30 in absolute value,
    and the plain reductions with them and without them agree within f32
    rounding: what the kernels drop cannot move their sums."""
    s = _rows(3, N=2, L=4000)
    xis = torch.linspace(float(s.max()), float(s.min()), 256)
    h = 3.0
    terms = kde._terms(s, xis, h, deriv)  # [N, L, P], f32
    past = (s.double()[:, :, None] - xis.double()[None, None, :]).abs() > kde.CUT * h
    assert float(past.double().mean()) > 0.9
    assert float(terms[past].abs().double().sum()) < 1e-30
    kept = torch.where(past, torch.zeros_like(terms), terms)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 256)).astype(np.float32))
    for full, cut in ((terms.sum(1), kept.sum(1)), ((g[:, None] * terms).sum(2),
                                                    (g[:, None] * kept).sum(2))):
        np.testing.assert_allclose(cut.numpy(), full.numpy(), rtol=0,
                                   atol=1e-6 * float(full.abs().max()))
    assert kde.kde_terms_needed(s, xis, h) == int((~past).sum())
