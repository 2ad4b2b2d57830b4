"""NMI and LNCC on a volume split into slabs (the ``space`` axis), on the
CPU (a mesh that names the CPU several times), and the engines with the
reference's default criteria on slabs.

Against the port's unsharded call: each NMI patch is assembled on the slab
that owns it and the patches' densities run as one row group a slab
(``losses/nmi.py``: ``patch_nmi_slabs``, ``nmi_groups``), so each patch's
NMI equals its unsharded value to the bit, and so does the loss (its
patches averaged in the same order; held here at rtol 1e-6). LNCC's windows
read a halo of ``(win-1)//2`` rows before and ``win//2`` after; its loss
adds the slabs' sums in ascending order, so it is held to rtol 1e-6. Each
slab's gradient within 1e-6 of the gradient's largest entry. Against the JAX
function on the whole volume: ``tests/test_torch_nmi.py``'s tolerances for
NMI (the loss at rtol 3e-5, its gradient 3e-4 of its largest entry) and
``tests/test_torch_edge.py``'s for LNCC's gradient (1e-5; its value
within 3e-5, see the test).

Cases: 24³ on 2, 3, 4 and 6 slabs along the first spatial dim, 2 along the
second, and a 2-D image on 4; patch sizes whose resize drops rows (``2p <
24``) and repeats them (``2p > 24``); the binned branch (unit range,
bandwidth 0.05) and the exact one (the range x 1000, the default bandwidth
3). The unit-range pair at the default bandwidth, where NMI is 1 to within
rounding and the loss is rounding alone, is held to the bit against the
unsharded call.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close_grad, pair

from torchregister_tpu.losses import similarity as jsim
from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.losses import similarity as tsim
from torchregister_tpu_torch.parallel import halo
from torchregister_tpu_torch.parallel import mesh as M

# the packages' ``losses`` export a function named ``nmi`` over the module
jn = importlib.import_module("torchregister_tpu.losses.nmi")
tn = importlib.import_module("torchregister_tpu_torch.losses.nmi")

# (shape, slabs, split spatial dim, patch size, intensity scale, bandwidth)
CASES = [((1, 1, 24, 24, 24), 2, 0, 8, 1.0, 0.05),
         ((1, 1, 24, 24, 24), 3, 0, 13, 1000.0, 3.0),
         ((2, 1, 24, 24, 24), 4, 0, 10, 1.0, 0.05),
         ((1, 1, 24, 24, 24), 6, 0, 13, 1000.0, 3.0),
         ((1, 1, 24, 24, 24), 2, 1, 8, 1000.0, 3.0),
         ((1, 1, 24, 20), 4, 0, 8, 1.0, 0.05)]
IDS = [f"{len(c[0]) - 2}d-{c[1]}slabs-dim{c[2]}-p{c[3]}-x{c[4]:g}" for c in CASES]


def _sharding(shape, n, dim):
    mesh = M.make_mesh((n,), ("space",), devices=["cpu"] * n)
    return M.volume_sharding(mesh, dim, ndim=len(shape) - 2)


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _on_slabs(fn, y, yp, sh):
    """``fn`` of the pair split by ``sh``, and its gradient in ``yp`` put
    back together from the slabs' gradients."""
    ps = M.shard(torch.from_numpy(yp), sh)
    for s in ps.shards:
        s.requires_grad_(True)
    v = fn(M.shard(torch.from_numpy(y), sh), ps)
    gs = torch.autograd.grad(v, ps.shards)
    dim, _ = ps.slab_axis()
    return float(v), torch.cat(gs, dim).numpy()


def _whole(fn, y, yp):
    p = torch.from_numpy(yp).requires_grad_(True)
    v = fn(torch.from_numpy(y), p)
    (g,) = torch.autograd.grad(v, p)
    return float(v), g.numpy()


@pytest.mark.parametrize("shape,n,dim,patch,scale,bw", CASES, ids=IDS)
def test_torch_mesh_criteria_nmi_on_slabs(shape, n, dim, patch, scale, bw):
    """``nmi_loss`` on slabs: each patch's NMI equal to the unsharded call's
    to the bit, the loss (rtol 1e-6) and each slab's gradient against the
    unsharded call and against JAX's on the whole volume; the branch counted
    once a call."""
    y, yp = pair(shape, scale, seed=11)
    sh = _sharding(shape, n, dim)
    kw = dict(patch_size=patch, bandwidth=bw)
    calls = dict(tn.branch_calls)
    got = tn.patch_nmi_slabs(M.shard(torch.from_numpy(y), sh), M.shard(torch.from_numpy(yp), sh),
                             **kw)
    branch = "exact" if scale > 1 else "binned"
    calls[branch] += 1
    assert dict(tn.branch_calls) == calls
    want, _ = tn.nmi(tn._patch_rows(torch.from_numpy(y), patch),
                     tn._patch_rows(torch.from_numpy(yp), patch), bandwidth=bw)
    assert _same(got, want)
    loss = lambda a, b: tn.nmi_loss(a, b, **kw)  # noqa: E731
    (sv, sg), (uv, ug) = _on_slabs(loss, y, yp, sh), _whole(loss, y, yp)
    assert sv == pytest.approx(uv, rel=1e-6)
    close_grad(sg, ug, 1e-6)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jn.nmi_loss(jnp.asarray(y), p, **kw)))(
        jnp.asarray(yp))
    assert sv == pytest.approx(float(jv), rel=3e-5)
    close_grad(sg, np.asarray(jg), 3e-4)


@functools.lru_cache(maxsize=None)
def _jax_lncc(shape, win):
    """JAX's LNCC of the pair at ``shape`` and its gradient (the cases that
    share a shape share it)."""
    y, yp = pair(shape, seed=12)
    return jax.value_and_grad(lambda p: jsim.lncc(jnp.asarray(y), p, win=win))(
        jnp.asarray(yp))


@pytest.mark.parametrize("win", [9, 4])
@pytest.mark.parametrize("shape,n,dim", [c[:3] for c in CASES], ids=IDS)
def test_torch_mesh_criteria_lncc_on_slabs(shape, n, dim, win):
    """``lncc`` on slabs (the halo may span several slabs: 4 rows of 6-row
    slabs at win 9) against the unsharded call (rtol 1e-6, each slab's
    gradient 1e-6 of the largest entry) and JAX's: the gradient within 1e-5
    of its largest entry, the value within rtol 3e-5 (at 24³, win 4, JAX's
    value is 1.7e-5 off a float64 evaluation of the same formula, the
    port's 4.8e-7)."""

    y, yp = pair(shape, seed=12)
    sh = _sharding(shape, n, dim)
    loss = lambda a, b: tsim.lncc(a, b, win=win)  # noqa: E731
    (sv, sg), (uv, ug) = _on_slabs(loss, y, yp, sh), _whole(loss, y, yp)
    assert sv == pytest.approx(uv, rel=1e-6)
    close_grad(sg, ug, 1e-6)
    jv, jg = _jax_lncc(shape, win)
    assert sv == pytest.approx(float(jv), rel=3e-5)
    close_grad(sg, np.asarray(jg), 1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_mesh_criteria_nmi_defaults_to_the_bit(n):
    """The defaults (patch 100, bandwidth 3) on a unit-range 3-D pair: NMI is
    1 to within rounding, so the loss is rounding alone; on slabs it equals
    the unsharded loss to the bit, and each slab's gradient within 1e-6 of
    the largest entry."""
    y, yp = pair((1, 1, 16, 16, 16), seed=13)
    sh = _sharding(y.shape, n, 0)
    (sv, sg), (uv, ug) = _on_slabs(tn.nmi_loss, y, yp, sh), _whole(tn.nmi_loss, y, yp)
    assert sv == uv
    close_grad(sg, ug, 1e-6)


def test_torch_mesh_criteria_patch_owners():
    """Which slab assembles each patch: split along the first spatial dim,
    the slab of the patch's first source row (at 240³ on 4 z-slabs each
    patch's source rows lie in one slab: nothing is copied between slabs);
    along another dim, dealt out in order."""
    assert tn.patch_owners((240, 240, 240), 0, 4, 100) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert tn.patch_owners((24, 24, 24), 0, 6, 16) == [0, 0, 1, 2, 3, 3, 4, 5]
    assert tn.patch_owners((24, 24, 24), 1, 2, 8) == [0, 0, 0, 0, 1, 1, 1, 1]
    assert tn.patch_owners((24, 20), 0, 4, 8) == [0, 1, 2, 3]
    y = torch.arange(240 ** 3, dtype=torch.float32).reshape(1, 1, 240, 240, 240)
    ys = M.shard(y, _sharding(y.shape, 4, 0))
    halo.reset_counts()
    groups = tn._owner_patches(ys, 100, tn.patch_owners((240,) * 3, 0, 4, 100), 0)
    assert halo.copied_bytes == 0 and halo.calls == 1
    assert torch.equal(torch.cat([r for _, r, _ in groups]), tn._patch_rows(y, 100))


def test_torch_mesh_criteria_rigid_default_criteria_on_slabs():
    """``rigid_register(criterions=None)`` (MSE + NCC + NMI, the Sobel edge
    masks) on 2 slabs against its unsharded run: the same steps, theta
    within 1e-4 of its largest entry."""
    vol, tgt = pair((1, 1, 16, 16, 16), seed=14)
    sh = _sharding(vol.shape, 2, 0)
    kw = dict(lr=1e-2, epochs=3, criterions=None, optimizer="sgd", max_shift=8,
              init="identity")
    _, res = rigid_register(M.shard(torch.from_numpy(vol), sh),
                            M.shard(torch.from_numpy(tgt), sh), **kw)
    _, ref = rigid_register(torch.from_numpy(vol), torch.from_numpy(tgt), **kw)
    assert res.steps == ref.steps
    theta, want = res.best_theta.numpy(), ref.best_theta.numpy()
    np.testing.assert_allclose(theta, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("crit", ["nmi", "lncc"])
def test_torch_mesh_criteria_lm_on_slabs(crit):
    """LM differentiates NMI and LNCC on slabs twice (the fetch's backward
    and the resize's are torch ops): 2-D on 2 slabs against unsharded, the
    same steps, theta within 1e-4 of its largest entry."""
    vol, tgt = pair((1, 1, 32, 32), seed=15)
    sh = _sharding(vol.shape, 2, 0)
    kw = dict(epochs=3, criterions=[crit], optimizer="lm", grad_edges=False, max_shift=8,
              init="identity")
    _, res = rigid_register(M.shard(torch.from_numpy(vol), sh),
                            M.shard(torch.from_numpy(tgt), sh), **kw)
    _, ref = rigid_register(torch.from_numpy(vol), torch.from_numpy(tgt), **kw)
    assert res.steps == ref.steps
    theta, want = res.best_theta.numpy(), ref.best_theta.numpy()
    np.testing.assert_allclose(theta, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_torch_mesh_criteria_cascade_default_criteria_on_a_2x2_mesh():
    """``make_cascade_batch_fn(spatial_axis=0, criterions=None)`` on a ``(2,
    2)`` ``data x space`` mesh (2-D, 4 pairs): each pair equal to its own run
    on one row of slabs to the bit."""
    from test_torch_mesh_batch import DRYRUN, _dryrun_pairs, _mesh, \
        _pairs_equal_their_row_runs

    cfg = {**DRYRUN, "criterions": None, "levels": 1, "flow_levels": 1, "rigid_epochs": 3,
           "affine_epochs": 2, "flow_epochs": 3}
    mov, tgt = _dryrun_pairs(B=4, ndim=2, size=24)
    mov, tgt = torch.from_numpy(mov), torch.from_numpy(tgt)
    res = make_cascade_batch_fn(mesh=_mesh(2, 2), spatial_axis=0, **cfg)(mov, tgt)
    _pairs_equal_their_row_runs(res, mov, tgt, cfg, 0)
