"""K2 (the exact trilinear warp) and the port's ``ops/blocked`` and
``ops/resample`` against the JAX package, on the CPU.

On a CPU tensor the port runs K2's plain version, ``warp_plain``. It is held
to the JAX package's exact warps (``ops/resample.warp_affine`` /
``warp_flow``), its blocked warps (``ops/blocked.warp_affine_fast`` /
``warp_flow_fast``) and the Pallas kernel itself in interpret mode
(``warp_affine_roi``, as ``tests/test_roigather.py`` runs it), at 1e-4 (the
JAX bench selftest's tolerance, ``bench.py:88``): the coordinates are
computed in another order than the normalized-grid path, which moves a value
by ~1e-5 where the image is rough. Inputs are numpy draws from a seed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchregister_tpu.ops import blocked as jb
from torchregister_tpu.ops import resample as jr
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu_torch.ops import blocked as tb
from torchregister_tpu_torch.ops import grid as tg
from torchregister_tpu_torch.ops import resample as tr
from torchregister_tpu_torch.ops.cuda import warp as k2

TOL = dict(rtol=1e-4, atol=1e-4)
RIGID3 = [0.2, -0.1, 0.15, 0.05, -0.03, 0.08]


def _vol(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _theta(params):
    return np.asarray(j_rigid_theta(jnp.asarray(params, jnp.float32)))[None]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _check_affine(theta, mov, align=False, element_gather=True):
    got = tb.warp_affine_fast(_t(theta), _t(mov), align).numpy()
    refs = [jb.warp_affine_fast(jnp.asarray(theta), jnp.asarray(mov), align)]
    if element_gather:
        refs.append(jr.warp_affine(jnp.asarray(theta), jnp.asarray(mov), align))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    return got


@pytest.mark.parametrize("align", [False, True], ids=["half_pixel", "corners"])
@pytest.mark.parametrize("shape", [(20, 21, 22), (50, 47, 44)], ids=["small", "odd"])
def test_torch_warp_affine_matches_jax(shape, align):
    mov = _vol((1, 1) + shape, 1)
    got = _check_affine(_theta(RIGID3), mov, align)
    # the plain differentiable path agrees too
    np.testing.assert_allclose(tr.warp_affine(_t(_theta(RIGID3)), _t(mov), align).numpy(),
                               got, **TOL)


@pytest.mark.parametrize("align", [False, True], ids=["half_pixel", "corners"])
def test_torch_warp_affine_2d_matches_jax(align):
    mov = _vol((1, 2, 31, 26), 2)
    _check_affine(_theta([0.3, 0.1, -0.2]), mov, align)


def test_torch_warp_affine_multichannel_and_batch():
    """Channels share one map; a batch with one theta folds into channels, a
    batch with per-element thetas loops (the JAX batch rules)."""
    mov = _vol((2, 3, 16, 18, 20), 3)
    one = _theta(RIGID3)
    # (JAX's element gather takes one theta per element: blocked path only)
    _check_affine(one, mov, element_gather=False)
    two = np.concatenate([one, _theta([-0.1, 0.2, 0.05, 0.1, 0.0, -0.1])])
    _check_affine(two, mov)
    with pytest.raises(ValueError, match="thetas for a batch"):
        tb.warp_affine_fast(_t(np.concatenate([two, one])), _t(mov))


def test_torch_warp_affine_zeros_padding_at_edges():
    """Support pushed past the volume on every axis: zeros, as grid_sample."""
    mov = np.ones((1, 1, 24, 24, 24), np.float32)
    theta = np.asarray([[[1.0, 0, 0, 0.9], [0, 1.0, 0, -0.8], [0, 0, 1.0, 0.5]]],
                       np.float32)
    got = _check_affine(theta, mov)
    assert got.min() == 0.0 and got.max() == 1.0


@pytest.mark.parametrize("theta,spatial", [
    ([[[3.0, 0, 0, 0.0], [0, 3.0, 0, 0.0], [0, 0, 3.0, 0.0]]], (24, 24, 24)),  # zoom-out
    (None, (14, 15, 16)),  # rotation of 0.8 rad
], ids=["zoom_out", "large_rotation"])
def test_torch_warp_affine_where_jax_blocked_declines(theta, spatial):
    """Transforms whose support outgrows the JAX blocked path's largest block
    (it falls back to the element gather); K2 has no such limit."""
    theta = (np.asarray(theta, np.float32) if theta is not None
             else _theta([0.0, 0.8, 0.0, 0.0, 0.0, 0.0]))
    B = jb.required_block_affine(jnp.asarray(theta), spatial)
    assert B > min(jb._MAX_BLOCK, min(spatial))
    _check_affine(theta, _vol((1, 1) + spatial, 4))


def test_torch_warp_affine_matches_pallas_roigather_interpret():
    """K2's plain version against the Pallas kernel it replaces, run in
    interpret mode on the CPU, and against the XLA blocked path."""
    shape = (45, 50, 41)
    mov = _vol((1, 2) + shape, 5)
    theta = _theta([0.15, -0.12, 0.1, 0.12, -0.08, 0.06])
    roi = jb.warp_affine_roi(jnp.asarray(theta), jnp.asarray(mov))
    assert roi is not None
    got = tb.warp_affine_fast(_t(theta), _t(mov)).numpy()
    np.testing.assert_allclose(got, np.asarray(roi), **TOL)


@pytest.mark.parametrize("scale", [2.5, 30.0], ids=["smooth", "past_every_face"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_torch_warp_flow_matches_jax(ndim, scale):
    shape = (18, 20, 22)[:ndim]
    rng = np.random.default_rng(6)
    mov = _vol((1, 2) + shape, 7)
    flow = (scale * rng.normal(size=(1, ndim) + shape)).astype(np.float32)
    got = tb.warp_flow_fast(_t(mov), _t(flow)).numpy()
    for ref in (jr.warp_flow(jnp.asarray(mov), jnp.asarray(flow)),
                jb.warp_flow_fast(jnp.asarray(mov), jnp.asarray(flow))):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(tr.warp_flow(_t(mov), _t(flow)).numpy(), got, **TOL)


def test_torch_warp_flow_batch_rules():
    rng = np.random.default_rng(8)
    mov = _vol((2, 1, 12, 13, 14), 9)
    flow = (2.0 * rng.normal(size=(2, 3, 12, 13, 14))).astype(np.float32)
    got = tb.warp_flow_fast(_t(mov), _t(flow)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jb.warp_flow_fast(jnp.asarray(mov), jnp.asarray(flow))), **TOL)
    # max_disp, the JAX package's block bound, changes nothing on K2
    bound = float(np.ceil(np.abs(flow).max()))
    np.testing.assert_array_equal(tb.warp_flow_fast(_t(mov), _t(flow), max_disp=4).numpy(),
                                  got)
    np.testing.assert_allclose(
        tb.warp_flow_fast(_t(mov), _t(flow), max_disp=bound).numpy(),
        np.asarray(jb.warp_flow_fast(jnp.asarray(mov), jnp.asarray(flow), max_disp=bound)),
        **TOL)
    with pytest.raises(ValueError, match="batch"):
        tb.warp_flow_fast(_t(mov), _t(flow[:1]))


def test_torch_warp_plain_is_multilinear_sample():
    """The 8-corner formula at arbitrary coordinates (an index map with
    shear and coordinates past the volume) against JAX's
    ``multilinear_sample``, to f32 rounding."""
    rng = np.random.default_rng(10)
    src = _vol((3, 9, 10, 11), 11)
    M = np.eye(3, dtype=np.float32) + 0.3 * rng.normal(size=(3, 3)).astype(np.float32)
    t = rng.uniform(-4, 4, 3).astype(np.float32)
    got = k2.warp_plain(_t(src), mt=k2.pack_affine(_t(M), _t(t))).numpy()
    o = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in (9, 10, 11)],
                             indexing="ij"), -1)
    q = (o[..., None, :] * M).sum(-1) + t
    want = np.asarray(jr.multilinear_sample(jnp.asarray(src)[None], jnp.asarray(q)[None]))[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_torch_pack_affine_2d_embeds_one_plane():
    M = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    t = torch.tensor([5.0, 6.0])
    assert k2.pack_affine(M, t).tolist() == [0, 0, 0, 0, 0, 1, 2, 5, 0, 3, 4, 6]
    with pytest.raises(ValueError):
        k2.pack_affine(torch.eye(4), torch.zeros(4))


def test_torch_warp_dispatch_by_device_only():
    """A CPU tensor runs the plain version and launches nothing; bad inputs
    raise on every device; a device with no path raises."""
    k2.reset_counts()
    src = torch.rand(2, 6, 7, 8)
    mt = k2.pack_affine(torch.eye(3), torch.zeros(3))
    torch.testing.assert_close(k2.warp(src, mt=mt), src, rtol=0, atol=0)
    flow = torch.zeros(3, 6, 7, 8)
    torch.testing.assert_close(k2.warp(src, flow=flow), src, rtol=0, atol=0)
    assert (k2.affine_launches, k2.flow_launches) == (0, 0)
    with pytest.raises(TypeError):
        k2.warp(src.double(), mt=mt)
    with pytest.raises(TypeError):
        k2.warp(src, flow=flow.double())
    with pytest.raises(ValueError, match="exactly one"):
        k2.warp(src, mt=mt, flow=flow)
    with pytest.raises(ValueError, match="flow"):
        k2.warp(src, flow=flow[:2])
    with pytest.raises(RuntimeError, match="no path"):
        k2.warp(src.to("meta"), mt=mt.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):  # the raw launcher needs the card
        k2.warp_affine_launch(src, mt)


def test_torch_grid_helpers_match_jax():
    from torchregister_tpu.ops import grid as jg

    theta = _theta(RIGID3)
    for ac in (False, True):
        np.testing.assert_allclose(tg.normalized_grid((4, 5, 6), ac).numpy(),
                                   np.asarray(jg.normalized_grid((4, 5, 6), ac)), rtol=1e-6)
        np.testing.assert_allclose(
            tg.affine_grid(_t(theta), (4, 5, 6), ac).numpy(),
            np.asarray(jg.affine_grid(jnp.asarray(theta), (4, 5, 6), ac)), rtol=1e-6,
            atol=1e-7)
        coords = np.random.default_rng(12).uniform(-1, 1, (3, 4, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tg.normalized_to_index(_t(coords), (4, 5, 6), ac).numpy(),
            np.asarray(jg.normalized_to_index(jnp.asarray(coords), (4, 5, 6), ac)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tg.identity_index_grid((3, 4)).numpy(),
                                  np.asarray(jg.identity_index_grid((3, 4))))
    np.testing.assert_array_equal(tg.normalized_grid((1, 3), True).numpy()[..., 1], 0.0)
