"""K1's affine and flow forms in the PyTorch port against the JAX package.

On the CPU a separable warp takes K1's plain versions: one affine pass is
``sweep_affine_plain`` (the dense grid of ``_axis_coord_grid``, then the
plain sweep), one flow pass is ``sweep_flow_plain`` (``flow[:, a] +
ident``, then the plain sweep). Each is held against the JAX package's
``_axis_coord_grid`` + ``sweep_resample_axis`` and the pass of its
``warp_flow_separable``, on the same numpy inputs: every axis, 2-D and 3-D,
one and three channels, displacements across the window's edges; values,
and gradients to the image, the pass's (coef, offset) and the field.
Tolerances: f32 values rtol 1e-5 / atol 2e-5, parameter gradients rtol 1e-4
(sums of per-voxel terms in another order), as ``tests/test_torch_ops.py``
states; bf16 images atol 0.05 (the JAX sweep rounds its partial sums to
bf16, the port rounds once), as ``test_torch_warp_affine_separable_bf16``.

The launchers' validation (device, table shape, channel count, dtype) runs
before the kernels' library is built, so it is tested here too.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torchregister_tpu.ops import separable as js
from torchregister_tpu.utils import pyramid as jp
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.utils import pyramid as tp

SPATIAL = {3: (9, 10, 11), 2: (13, 12)}
K = 3
CASES = [(d, a, C) for d in (3, 2) for a in range(d) for C in (1, 3)]
IDS = [f"{d}d-axis{a}-C{C}" for d, a, C in CASES]


def _image(d, C, seed, N=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, C) + SPATIAL[d]).astype(np.float32)


def _affine_row(d, axis, seed):
    """(coef, offset) of one pass whose displacement q - o_axis runs across
    the window and 2 voxels past it, with fractional parts: the slope along
    the swept axis near 1, another axis carrying the spread."""
    rng = np.random.default_rng(seed)
    S = SPATIAL[d]
    coef = rng.uniform(-0.05, 0.05, size=d).astype(np.float32)
    coef[axis] += 1.0
    other = (axis + 1) % d
    coef[other] = (2 * K + 4) / (S[other] - 1)
    offset = np.float32(-(K + 2) + 0.37)
    return coef, offset


def _close_grad(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("d,axis,C", CASES, ids=IDS)
def test_torch_sweep_affine_plain_matches_jax(d, axis, C):
    src = _image(d, C, 10 + axis)
    coef, offset = _affine_row(d, axis, 20 + axis)
    w = _image(d, C, 30 + axis)

    def jloss(s, c, o):
        q = js._axis_coord_grid(c, o, SPATIAL[d])
        out = js.sweep_resample_axis(s, q, axis, K)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(src), jnp.asarray(coef), jnp.float32(offset))
    s = torch.from_numpy(src).requires_grad_(True)
    c = torch.from_numpy(coef).requires_grad_(True)
    o = torch.tensor(offset).requires_grad_(True)
    out = k1.sweep_affine_plain(s, c, o, axis, K)
    torch.sum(out * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgrads[0]), rtol=1e-5, atol=2e-5)
    _close_grad(c.grad.numpy(), np.asarray(jgrads[1]))
    _close_grad(o.grad.numpy(), np.asarray(jgrads[2]))


@pytest.mark.parametrize("d,axis,C", CASES, ids=IDS)
def test_torch_sweep_flow_plain_matches_jax(d, axis, C):
    src = _image(d, C, 40 + axis, N=2)
    rng = np.random.default_rng(50 + axis)
    flow = rng.uniform(-K - 2, K + 2, size=(2, d) + SPATIAL[d]).astype(np.float32)
    w = _image(d, C, 60 + axis, N=2)
    S = SPATIAL[d]

    def jloss(s, f):
        ident = jnp.arange(S[axis], dtype=jnp.float32).reshape(
            tuple(S[axis] if i == axis else 1 for i in range(d)))
        out = js.sweep_resample_axis(s, f[:, axis][:, None] + ident, axis, K)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), (jgs, jgf) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(src), jnp.asarray(flow))
    s = torch.from_numpy(src).requires_grad_(True)
    f = torch.from_numpy(flow).requires_grad_(True)
    out = k1.sweep_flow_plain(s, f, axis, K)
    torch.sum(out * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgs), rtol=1e-5, atol=2e-5)
    _close_grad(f.grad.numpy(), np.asarray(jgf))


@pytest.mark.parametrize("d", [3, 2])
def test_torch_sweep_modes_bf16_images(d):
    """bf16 images with an f32 (coef, offset) and an f32 field, every pass:
    within 0.05 of the JAX sweep on the same bf16 image."""
    src = np.abs(_image(d, 1, 70 + d))
    jsrc = jnp.asarray(src).astype(jnp.bfloat16)
    tsrc = torch.from_numpy(src).to(torch.bfloat16)
    flow = np.random.default_rng(80 + d).uniform(-K - 2, K + 2, size=(1, d) + SPATIAL[d])
    flow = flow.astype(np.float32)
    S = SPATIAL[d]
    for axis in range(d):
        coef, offset = _affine_row(d, axis, 90 + axis)
        jout = js.sweep_resample_axis(
            jsrc, js._axis_coord_grid(jnp.asarray(coef), jnp.float32(offset), S), axis, K)
        out = k1.sweep_affine_plain(tsrc, torch.from_numpy(coef), torch.tensor(offset), axis, K)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                                   atol=0.05)
        ident = jnp.arange(S[axis], dtype=jnp.float32).reshape(
            tuple(S[axis] if i == axis else 1 for i in range(d)))
        jout = js.sweep_resample_axis(jsrc, jnp.asarray(flow)[:, axis][:, None] + ident,
                                      axis, K)
        out = k1.sweep_flow_plain(tsrc, torch.from_numpy(flow), axis, K)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                                   atol=0.05)


def test_torch_compose_flows_separable_matches_jax():
    """The 3-channel composition (the field-rebase cascade's fold), values
    and the gradient to both fields."""
    rng = np.random.default_rng(5)
    first = rng.uniform(-2.0, 2.0, size=(1, 3) + SPATIAL[3]).astype(np.float32)
    second = rng.uniform(-2.5, 2.5, size=(1, 3) + SPATIAL[3]).astype(np.float32)
    w = rng.normal(size=first.shape).astype(np.float32)

    def jloss(a, b):
        out = jp.compose_flows_separable(a, b, max_disp=K)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), (ja, jb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(first), jnp.asarray(second))
    a = torch.from_numpy(first).requires_grad_(True)
    b = torch.from_numpy(second).requires_grad_(True)
    out = tp.compose_flows_separable(a, b, max_disp=K)
    torch.sum(out * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ja), rtol=1e-5, atol=2e-5)
    _close_grad(b.grad.numpy(), np.asarray(jb))


def test_torch_sweep_passes_on_cpu_are_the_plain_compositions():
    """The whole-warp dispatch on the CPU is the per-pass plain version,
    bit for bit, and launches nothing."""
    src = torch.from_numpy(_image(3, 2, 7))
    passes = [(a, (torch.from_numpy(c), torch.tensor(o)))
              for a, (c, o) in ((a, _affine_row(3, a, a)) for a in (2, 1, 0))]
    flow = torch.from_numpy(np.random.default_rng(8).uniform(
        -4, 4, size=(1, 3) + SPATIAL[3]).astype(np.float32))
    k1.reset_counts()
    got = k1.sweep_affine_passes(src, passes, (K, K + 1, K + 2))
    want = src
    for (a, (c, o)), Ka in zip(passes, (K, K + 1, K + 2)):
        want = k1.sweep_affine_plain(want, c, o, a, Ka)
    assert torch.equal(got, want)
    got = k1.sweep_flow_passes(src, flow, K)
    want = src
    for a in (2, 1, 0):
        want = k1.sweep_flow_plain(want, flow, a, K)
    assert torch.equal(got, want)
    assert (k1.fwd_launches, k1.bwd_launches) == (0, 0)
    assert set(k1.fwd_modes.values()) == set(k1.bwd_modes.values()) == {0}


def test_torch_sweep_passes_refuse_other_devices():
    src = torch.empty((1, 1, 4, 4, 4), device="meta")
    with pytest.raises(RuntimeError, match="no path for device"):
        k1.sweep_flow_passes(src, torch.empty((1, 3, 4, 4, 4), device="meta"), 2)
    passes = [(a, (torch.zeros(3, device="meta"), torch.zeros((), device="meta")))
              for a in (2, 1, 0)]
    with pytest.raises(RuntimeError, match="no path for device"):
        k1.sweep_affine_passes(src, passes, (2, 2, 2))


def _no_build(monkeypatch):
    def fail():
        raise AssertionError("the library was built before the inputs were checked")

    monkeypatch.setattr(k1.LIB, "build", fail)
    monkeypatch.setattr(k1.LIB, "_fns", None)


@pytest.mark.parametrize("case", ["cpu", "table_shape", "table_dtype", "image_dtype",
                                  "axes", "row"])
def test_torch_sweep_affine_launchers_validate_first(case, monkeypatch):
    _no_build(monkeypatch)
    src = torch.zeros((1, 1, 5, 6, 7))
    table = torch.zeros((3, 4))
    axes, windows = (2, 1, 0), (2, 2, 2)
    err, match = ValueError, "CUDA device"
    if case == "table_shape":
        table, match = torch.zeros((3, 3)), r"table \[3, 4\]"
    elif case == "table_dtype":
        table, err, match = table.double(), TypeError, "float32 table"
    elif case == "image_dtype":
        src, err, match = src.half(), TypeError, "float32 or bfloat16"
    elif case == "axes":
        axes, match = (2, 1, 3), "axis in range"
    p = 3 if case == "row" else 0
    if case == "row":  # out of the table: checked first, never an address
        match = r"the row in range\(3\)"
    else:
        with pytest.raises(err, match=match):
            k1._SeparableAffine.apply(src, table, axes, windows)
    with pytest.raises(err, match=match):
        k1.affine_fwd(src, table, p, axes[-1], 2)
    with pytest.raises(err, match=match):
        k1.affine_bwd(src, src, table, p, axes[-1], 2)


@pytest.mark.parametrize("case", ["cpu", "channels", "field_dtype", "field_shape",
                                  "window", "axis"])
def test_torch_sweep_flow_launchers_validate_first(case, monkeypatch):
    _no_build(monkeypatch)
    src = torch.zeros((2, 3, 5, 6, 7))
    flow = torch.zeros((2, 3, 5, 6, 7))
    K, err, match = 2, ValueError, "CUDA device"
    if case == "channels":
        flow, match = torch.zeros((2, 2, 5, 6, 7)), "field with 3 channels"
    elif case == "field_dtype":
        flow, err, match = flow.to(torch.bfloat16), TypeError, "float32 field"
    elif case == "field_shape":
        flow, match = torch.zeros((1, 3, 5, 6, 7)), r"field \[N, 3, \*S\]"
    elif case == "window":
        K, match = -1, "window must be >= 0"
    axis = 3 if case == "axis" else 0
    if case == "axis":  # out of the field: checked first, never an address
        match = r"the axis in range\(3\)"
    else:
        with pytest.raises(err, match=match):
            k1._SeparableFlow.apply(src, flow, K)
    with pytest.raises(err, match=match):
        k1.flow_fwd(src, flow, axis, K)
    with pytest.raises(err, match=match):
        k1.flow_bwd(src, src, flow, axis, K)


def test_torch_sweep_source_entry_points_and_no_float_atomics():
    """K1's source exports its launches' entry points, and its sums take a
    fixed order: no atomic adds (only integer min/max of a k range)."""
    text = k1.SOURCE.read_text()
    for entry in ("int sweep_fwd(", "int sweep_bwd(", "long long sweep_bwd_work("):
        assert f'extern "C" {entry}' in text
    assert "atomicAdd" not in text
