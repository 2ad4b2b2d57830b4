"""Helpers of the PyTorch port's parity tests that hold a criterion or filter
against the JAX package on the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import torch


def pair(shape, scale=1.0, seed=0):
    """A random image in ``[0, scale)`` and a noisy copy of it, f32 numpy."""
    rng = np.random.default_rng(seed)
    y = (rng.random(shape) * scale).astype(np.float32)
    yp = (0.7 * y + 0.3 * scale * rng.random(shape)).astype(np.float32)
    return y, yp


def value_and_grad(jfn, tfn, y, yp):
    """Both packages' ``fn(y, yp)`` (a scalar) and its gradient in ``yp``."""
    jv, jg = jax.value_and_grad(lambda p: jfn(jnp.asarray(y), p))(jnp.asarray(yp))
    p = torch.from_numpy(yp).requires_grad_(True)
    tv = tfn(torch.from_numpy(y), p)
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), p.grad.numpy())


def close_grad(got, want, tol):
    """``got`` within ``tol`` of the largest entry of ``want``."""
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
