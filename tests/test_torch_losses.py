"""Criteria and the criterion registry of the PyTorch port against the JAX
package, on the CPU (f32 and bf16 inputs; both upcast to f32 before
reducing, so the only difference is the reduction order: rtol 1e-5, and
1e-4 for NCC, whose alpha = 100 scales ``1 - r``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchregister_tpu import losses as jl
from torchregister_tpu_torch import losses as tl


def _pair(dtype, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(1, 1, 9, 10, 11)).astype(np.float32)
    yp = (0.8 * y + 0.3 * rng.normal(size=y.shape)).astype(np.float32)
    jy, jyp = jnp.asarray(y), jnp.asarray(yp)
    ty, typ = torch.from_numpy(y), torch.from_numpy(yp)
    if dtype == "bfloat16":
        jy, jyp = jy.astype(jnp.bfloat16), jyp.astype(jnp.bfloat16)
        ty, typ = ty.to(torch.bfloat16), typ.to(torch.bfloat16)
    return (jy, jyp), (ty, typ)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,rtol", [("mse", 1e-5), ("ssd", 1e-5), ("ncc", 1e-4)])
def test_torch_similarity(name, rtol, dtype):
    (jy, jyp), (ty, typ) = _pair(dtype)
    got = getattr(tl, name)(ty, typ)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(getattr(jl, name)(jy, jyp)), rel=rtol)


def test_torch_similarity_grads():
    (jy, jyp), (ty, typ) = _pair("float32", seed=1)
    import jax

    for name in ("mse", "ncc"):
        jg = np.asarray(jax.grad(lambda p: getattr(jl, name)(jy, p))(jyp))
        p = typ.clone().requires_grad_(True)
        getattr(tl, name)(ty, p).backward()
        np.testing.assert_allclose(p.grad.numpy(), jg, rtol=1e-4, atol=1e-7)


def test_torch_weighted_loss_and_resolve():
    (jy, jyp), (ty, typ) = _pair("float32", seed=2)
    tc, tw = tl.resolve_criteria(["mse", "ncc"], None)
    jc, jw = jl.resolve_criteria(["mse", "ncc"], None)
    assert tw == jw == (0.5, 0.5)
    got = tl.weighted_loss(tc, tw)(ty, typ)
    assert float(got) == pytest.approx(float(jl.weighted_loss(jc, jw)(jy, jyp)), rel=1e-4)
    assert tl.resolve_criteria("mse", [2.0])[1] == (2.0,)
    with pytest.raises(ValueError):
        tl.resolve_criteria(["mse", "ncc"], [1.0])
    with pytest.raises(ValueError):
        tl.weighted_loss([tl.mse], [1.0, 2.0])


def test_torch_get_criterion():
    assert tl.get_criterion("MSE") is tl.mse
    a = tl.get_criterion("ncc", alpha=10.0)
    assert a is tl.get_criterion("ncc", alpha=10.0)  # identity-stable
    (jy, jyp), (ty, typ) = _pair("float32", seed=3)
    assert float(a(ty, typ)) == pytest.approx(
        float(jl.get_criterion("ncc", alpha=10.0)(jy, jyp)), rel=1e-4)
    fn = lambda y, yp: torch.sum(y)  # noqa: E731
    assert tl.get_criterion(fn) is fn
    with pytest.raises(KeyError):
        tl.get_criterion("nope")
    with pytest.raises(TypeError):
        tl.get_criterion(3)


@pytest.mark.parametrize("name", ["nmi", "lncc"])
def test_torch_unported_criteria_raise(name):
    """The names that raised before NMI and LNCC were ported resolve to the
    port's functions and agree with the JAX package's by name, with and
    without keywords (NMI at patch 4, bandwidth 0.05 on the unit range: its
    binned path; a small patch keeps the JAX splat quick)."""
    assert tl.get_criterion(name) is getattr(tl, "nmi_loss" if name == "nmi" else name)
    kw = dict(patch_size=4, bandwidth=0.05) if name == "nmi" else dict(win=4)
    (jy, jyp), (ty, typ) = _pair("float32", seed=5)
    jy, jyp, ty, typ = (jnp.abs(jy), jnp.abs(jyp), ty.abs(), typ.abs())
    got = float(tl.get_criterion(name, **kw)(ty, typ))
    assert got == pytest.approx(float(jl.get_criterion(name, **kw)(jy, jyp)), rel=3e-5)


def test_torch_default_stack_raises_until_nmi_is_ported():
    """``None`` is the reference stack MSE, NCC(100), NMI(1000) with weights
    0.33 each, as in the JAX package."""
    crits, w = tl.resolve_criteria(None, None)
    jcrits, jw = jl.resolve_criteria(None, None)
    assert crits == tl.default_criteria() == (tl.mse, tl.ncc, tl.nmi_loss)
    assert w == jw == tl.DEFAULT_WEIGHTS
    assert [c.__name__ for c in crits] == [c.__name__ for c in jcrits]
    assert tl.resolve_criteria(None, [1.0, 2.0, 3.0])[1] == (1.0, 2.0, 3.0)
