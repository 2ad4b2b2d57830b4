"""The exact KDE's module (``ops/cuda/kde``) on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``). Here: the
plain versions of ``kde_sum`` and ``kde_dot`` against autograd over the plain
forward (the backward and the second order are those reductions); the
autograd Functions ``_KDE`` and ``_KDEGrad`` with their launches emulated by
the plain versions, on both values of the branch flag, against autograd's
first and second derivatives; the third derivative raising; the CPU
dispatch reading the flag; the launchers' checks before any build.

Tolerances: the plain versions and autograd sum the same f32 terms in other
orders and with other roundings of ``phi'`` and ``phi''`` (autograd's
chain of ``exp``, products and the division's backward): 1e-5 of the largest
entry.
"""
import numpy as np
import pytest
import torch

from torchregister_tpu_torch.ops.cuda import kde

H = 0.15
TOL = 1e-5


def _inputs(n=2, L=37, P=12, seed=0):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.random((n, L)).astype(np.float32))
    xis = torch.from_numpy(np.linspace(1.0, 0.0, P).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(n, P)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, L)).astype(np.float32))
    return s, xis, w1, v


def _close(got, want, tol=TOL):
    got, want = got.detach(), want.detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * float(want.abs().max()))


def _readout(acc, w1):
    """A nonlinear read-out, so the second order has both terms."""
    return torch.sum(w1 * acc + acc * acc)


@pytest.mark.parametrize("chunk", [8, 64])
def test_torch_kde_plain_reductions_are_autograd_derivatives(chunk):
    """``kde_dot_plain(g, phi') / h`` is the gradient of ``kde_sum_plain``;
    ``kde_sum_plain(w, phi') / h`` the gradient of ``sum(g * ds)`` in ``g``;
    ``v kde_dot_plain(g, phi'') / h^2`` its gradient in ``s`` (chunked rows
    and a remainder, and one chunk)."""
    s, xis, g, v = _inputs()
    sr = s.clone().requires_grad_(True)
    acc = kde.kde_sum_plain(sr, xis, H, chunk=chunk)
    gr = g.clone().requires_grad_(True)
    (ds,) = torch.autograd.grad(acc, sr, gr, create_graph=True)
    _close(kde.kde_dot_plain(g, s, xis, H, deriv=1, chunk=chunk) / H, ds)
    gbar, sbar = torch.autograd.grad(ds, (gr, sr), v)
    _close(kde.kde_sum_plain(s, xis, H, w=v, deriv=1, chunk=chunk) / H, gbar)
    _close(v * kde.kde_dot_plain(g, s, xis, H, deriv=2, chunk=chunk) / (H * H), sbar)


def _emulate(monkeypatch):
    """The launchers replaced by the plain versions, zeros when the flag is
    set (what the kernels compute)."""

    def sum_launch(s, xis, h, binned, w=None, deriv=0):
        out = kde.kde_sum_plain(s, xis, h, w=w, deriv=deriv)
        return torch.zeros_like(out) if bool(binned) else out

    def dot_launch(g, s, xis, h, binned, deriv=1):
        out = kde.kde_dot_plain(g, s, xis, h, deriv=deriv)
        return torch.zeros_like(out) if bool(binned) else out

    monkeypatch.setattr(kde, "kde_sum_launch", sum_launch)
    monkeypatch.setattr(kde, "kde_dot_launch", dot_launch)


@pytest.mark.parametrize("binned", [0, 1])
def test_torch_kde_functions_differentiate_twice(binned, monkeypatch):
    """``_KDE`` and ``_KDEGrad`` with emulated launches: the value, the
    gradient and a Hessian-vector product of a nonlinear read-out equal
    autograd over the plain version; on the binned flag every one is zero.
    A third derivative raises."""
    _emulate(monkeypatch)
    s, xis, w1, v = _inputs(seed=1)
    flag = torch.tensor([binned], dtype=torch.int32)
    derivs = []
    for fn in (lambda a: kde._KDE.apply(a, xis, H, flag),
               lambda a: kde.kde_sum_plain(a, xis, H)):
        a = s.clone().requires_grad_(True)
        f = _readout(fn(a), w1)
        (g1,) = torch.autograd.grad(f, a, create_graph=True)
        (hv,) = torch.autograd.grad(torch.sum(g1 * v), a, create_graph=True)
        derivs.append((a, f, g1, hv))
    (a, f, g1, hv), want = derivs
    if binned:
        assert float(f.detach()) == 0.0
        assert not g1.detach().any() and not hv.detach().any()
    else:
        for got, ref in zip((f, g1, hv), want[1:]):
            _close(got, ref)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(hv.sum(), a)


def test_torch_kde_acc_cpu_reads_the_flag():
    """On the CPU ``kde_acc`` is the plain version (the exact KDE's sum as
    before the kernels), zeros without a graph when the flag is set, and
    other devices raise."""
    s, xis, _, _ = _inputs(L=20000)
    torch.testing.assert_close(kde.kde_acc(s, xis, H), kde.kde_sum_plain(s, xis, H),
                               rtol=0, atol=0)
    z = kde.kde_acc(s.requires_grad_(True), xis, H, torch.tensor(True))
    assert z.shape == (2, 12) and not z.any() and z.grad_fn is None
    assert kde.kde_acc(s, xis, H, torch.tensor(0, dtype=torch.int32)).grad_fn is not None
    with pytest.raises(RuntimeError, match="no path for device meta"):
        kde.kde_acc(s.detach().to("meta"), xis.to("meta"), H)


@pytest.mark.parametrize("case", ["cpu", "dtype", "flag_dtype", "non_contiguous", "shape"])
def test_torch_kde_launch_checks_raise_before_any_build(case, monkeypatch):
    """Each launcher checks its operands before the library is built."""

    def fail():
        raise AssertionError("the library was built before the inputs were checked")

    monkeypatch.setattr(kde.LIB, "build", fail)
    monkeypatch.setattr(kde.LIB, "_fns", None)
    s, xis = torch.zeros((2, 64)), torch.zeros(8)
    g, flag = torch.zeros((2, 8)), torch.zeros(1, dtype=torch.int32)
    err, match = ValueError, "one CUDA device"
    if case == "dtype":
        s, err, match = s.double(), TypeError, "float32"
    elif case == "flag_dtype":
        flag, err, match = flag.long(), TypeError, "int32"
    elif case == "non_contiguous":
        s, match = torch.zeros((64, 2)).T, "contiguous"
    elif case == "shape":
        g, match = torch.zeros((2, 9)), r"g \[N, P\]"
    with pytest.raises(err, match=match):
        kde.kde_dot_launch(g, s, xis, H, flag)
    if case != "shape":
        with pytest.raises(err, match=match):
            kde.kde_sum_launch(s, xis, H, flag)
