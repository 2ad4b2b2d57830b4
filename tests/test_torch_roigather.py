"""K2b's plain version and the ROI route of the PyTorch port against the JAX
package, on the CPU: the Pallas ROI gather in interpret mode (bit for bit),
the host window origins of ``_roi_supports``, and the compact form of the
route, ``warp_affine_roi`` (``ROIGATHER_FUSED`` patched to ``False`` on the
JAX side; the port's ``warp_affine_roi`` is the compact form, its fused form
is ``warp_affine_fast``'s own K2 call), on the shapes and cases of
``tests/test_roigather.py``.

The warps are compared at that file's tolerances (rtol 1e-4, atol 3e-5):
both packages compute each output's source coordinate in f32 from the same
rounded index map, but XLA on the CPU contracts its products and sums into
FMAs, so the coordinates differ by up to an ulp of the coordinate (~1e-5
voxel), which the random images' slopes (~2 per voxel) turn into ~3e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchregister_tpu.ops.blocked as jb
from torchregister_tpu.ops.pallas.roigather import roigather as j_roigather
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu_torch.ops import blocked as tb
from torchregister_tpu_torch.ops.cuda import roigather as k2b
from torchregister_tpu_torch.ops.cuda import warp as k2

THETA = (0.2, -0.1, 0.15, 0.05, -0.03, 0.08)
TOL = dict(rtol=1e-4, atol=3e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _theta(params=THETA):
    return np.array(j_rigid_theta(jnp.asarray(params, jnp.float32)))[None]


@pytest.fixture
def compact(monkeypatch):
    """The JAX package's ``warp_affine_roi`` on the compact form of the
    route (the Pallas ROI gather and the hats), the port's only form."""
    monkeypatch.setattr(jb, "ROIGATHER_FUSED", False)


def test_torch_roigather_plain_matches_pallas():
    """The JAX test's case (random windows in a 48x48x128 padded volume)
    and the route's own windows at 45x50x41 on its padded volume: equal to
    the bit, and the unpadded volume gives the same values."""
    volp = _rand((48, 48, 128), 1)
    rng = np.random.default_rng(2)
    orgz, orgy = rng.integers(0, 24, 5), rng.integers(0, 24, 5)
    ox = rng.integers(0, 128 - k2b.CW, 5)
    scal = np.stack([orgz // 8, orgy // 8, orgz % 8, orgy % 8, ox], -1).astype(np.int32)
    shape = (45, 50, 41)
    vol = _rand(shape, 3)
    scal2 = tb._roi_supports(_theta()[0].astype(np.float64), shape, False)[0]
    # as the JAX wrapper pads: z and y by 8 past a multiple of 8, x to 128
    pad = [(0, 8 * -(-n // 8) + 16 - n) for n in shape[:2]] + [(0, 128 - shape[2])]
    for v, s in ((volp, scal), (np.pad(vol, pad), scal2)):
        got = k2b.roigather(torch.from_numpy(v), torch.from_numpy(s))
        assert got.shape == (s.shape[0], k2b.CW, k2b.AW * k2b.BW)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_roigather(jnp.asarray(v), jnp.asarray(s))))
    np.testing.assert_array_equal(
        k2b.roigather(torch.from_numpy(vol), torch.from_numpy(scal2)).numpy(),
        k2b.roigather(torch.from_numpy(np.pad(vol, pad)), torch.from_numpy(scal2)).numpy())


def test_torch_roigather_plain_contract_and_errors():
    """``out[t, c, ab] = vol[8 zq + zr + ab // 16, 8 yq + yr + ab % 16, ox +
    c]``, 0 where an index leaves the volume; f32 volumes and int32
    scalars only."""
    vol = _rand((20, 18, 22), 4)
    scal = np.array([[0, 0, 1, 2, 3], [1, 0, 7, 0, 10], [-1, 2, 3, 5, -4]], np.int32)
    got = k2b.roigather(torch.from_numpy(vol), torch.from_numpy(scal)).numpy()
    for t, (zq, yq, zr, yr, ox) in enumerate(scal):
        for c in range(16):
            for ab in (0, 17, 100, 255):
                z, y, x = 8 * zq + zr + ab // 16, 8 * yq + yr + ab % 16, ox + c
                inside = 0 <= z < 20 and 0 <= y < 18 and 0 <= x < 22
                assert got[t, c, ab] == (vol[z, y, x] if inside else 0.0)
    with pytest.raises(TypeError):
        k2b.roigather(torch.from_numpy(vol).to(torch.bfloat16), torch.from_numpy(scal))
    with pytest.raises(TypeError):
        k2b.roigather(torch.from_numpy(vol), torch.from_numpy(scal).long())
    with pytest.raises(ValueError):
        k2b.roigather(torch.from_numpy(vol), torch.from_numpy(scal[:, :4]))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("shape", [(48, 48, 48), (45, 50, 41)])
def test_torch_roi_supports_match_jax(shape, align):
    theta = _theta()[0].astype(np.float64)
    ours, theirs = tb._roi_supports(theta, shape, align), jb._roi_supports(theta, shape, align)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("shape", [(48, 48, 48), (45, 50, 41)])
def test_torch_compact_route_matches_jax(shape, align, compact):
    moving = _rand((1, 1) + shape, 3)
    theta = _theta()
    k2b.reset_counts()
    ours = tb.warp_affine_roi(torch.from_numpy(theta), torch.from_numpy(moving), align)
    assert k2b.launches == 0  # a CPU tensor runs the plain version
    ref = jb.warp_affine_roi(jnp.asarray(theta), jnp.asarray(moving), align)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_torch_compact_route_zeros_and_channels(compact):
    """A support pushed outside the volume (``grid_sample``'s zeros), and
    three channels, each gathered and contracted on its own."""
    theta = np.asarray([[[1.0, 0, 0, 0.9], [0, 1.0, 0, -0.8], [0, 0, 1.0, 0.5]]], np.float32)
    ones = np.ones((1, 1, 48, 48, 48), np.float32)
    ours = tb.warp_affine_roi(torch.from_numpy(theta), torch.from_numpy(ones))
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jb.warp_affine_roi(jnp.asarray(theta), jnp.asarray(ones))), **TOL)
    assert float(ours.min()) == 0.0
    moving = _rand((1, 3, 40, 44, 36), 4)
    theta = _theta((0.1, 0.05, -0.08, 0.1, 0.0, -0.05))
    ours = tb.warp_affine_roi(torch.from_numpy(theta), torch.from_numpy(moving))
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jb.warp_affine_roi(jnp.asarray(theta), jnp.asarray(moving))),
        **TOL)


def test_torch_roi_route_declines_and_fused_form(monkeypatch):
    """A 2x zoom outgrows the 16-wide windows: None, as in the JAX package,
    and so do a 2D image, a batch and a 31-voxel edge. The route agrees with
    K2's plain version (``warp_affine_fast`` on the CPU); ``warp_affine_fast``
    takes the route on a CUDA tensor only, so an enabled route launches
    nothing here and changes no value."""
    moving = torch.from_numpy(_rand((1, 1, 48, 48, 48), 5))
    zoom = np.asarray([[[2.0, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, 2.0, 0]]], np.float32)
    assert tb._roi_supports(zoom[0].astype(np.float64), (48,) * 3, False) is None
    assert jb.warp_affine_roi(jnp.asarray(zoom), jnp.asarray(moving.numpy())) is None
    theta = torch.from_numpy(_theta())
    assert tb.warp_affine_roi(torch.from_numpy(zoom), moving) is None
    assert tb.warp_affine_roi(theta, moving[:, :, 0]) is None
    assert tb.warp_affine_roi(theta, moving.expand(2, -1, -1, -1, -1)) is None
    assert tb.warp_affine_roi(theta, moving[:, :, :31]) is None
    roi = tb.warp_affine_roi(theta, moving)
    np.testing.assert_allclose(roi.numpy(), tb.warp_affine_fast(theta, moving).numpy(), **TOL)
    k2.reset_counts()
    k2b.reset_counts()
    monkeypatch.setattr(tb, "ROIGATHER_ENABLED", True)
    monkeypatch.setattr(tb, "ROIGATHER_FUSED", False)
    out = tb.warp_affine_fast(theta, moving)
    assert (k2.affine_launches, k2b.launches) == (0, 0)
    torch.testing.assert_close(out, tb.warp_affine_fast(theta, moving), rtol=0, atol=0)
