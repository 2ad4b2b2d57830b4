"""The port's meshes (``parallel/mesh.py``, ``parallel/halo.py``,
``parallel/data.py``) on the CPU, a mesh that names the CPU eight times,
against the JAX package's on its eight forced CPU devices
(``tests/conftest.py``) and against the port's own unsharded calls.

The ``space`` axis: the separable affine warp of a volume split into
z-slabs (K1's slab mode, its plain version here) equals the unsharded warp
to the bit, forward and dsrc, and JAX's sharded warp within
``tests/test_parallel.py:82``'s tolerance; the table's gradient, summed over
the slabs, within 1e-6 of its largest entry; the rigid engine on slabs
against JAX's space-sharded engine (``tests/test_parallel.py:235``) and the
port's unsharded run. The ``data`` axis: ``register_cohort(mesh=)`` and
``make_cascade_batch_fn(mesh=)``, each pair equal to the unsharded call's
to the bit. Halos of slabs of one and three rows, reaching three
neighbours and past the volume's edges; the refusals.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchregister_tpu_torch as tr
from torchregister_tpu.engines.rigid import _build_rigid_fn
from torchregister_tpu.losses.similarity import mse as j_mse
from torchregister_tpu.ops.resample import warp_affine as j_warp_affine
from torchregister_tpu.ops.separable import warp_affine_separable as j_warp_separable
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu.parallel import mesh as jmesh
from torchregister_tpu.parallel.cohort import register_cohort as j_register_cohort
from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.edge import edge_filter
from torchregister_tpu_torch.ops.separable import (affine_to_index_map, factor_passes,
                                                   warp_affine_separable)
from torchregister_tpu_torch.ops.transforms import rigid_theta
from torchregister_tpu_torch.parallel import halo
from torchregister_tpu_torch.parallel import mesh as M
from torchregister_tpu_torch.parallel.cohort import register_cohort

CPU8 = ["cpu"] * 8
# tests/test_parallel.py:86's transform of the 32^3 warp, :243's of the engine
WARP_PARAMS = [0.05, -0.04, 0.03, 0.1, -0.1, 0.05]
ENGINE_PARAMS = [0.06, -0.04, 0.05, 0.08, -0.06, 0.04]


def _blobs(batch, shape, seed=0):
    """``tests/test_parallel.py``'s blobs, numpy ``[B, 1, *S]``."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    vols = []
    for _ in range(batch):
        vol = np.zeros(shape, np.float32)
        for _ in range(4):
            c = rng.uniform(-0.4, 0.4, len(shape))
            w = rng.uniform(0.15, 0.3)
            vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2))
        vols.append(vol)
    return np.stack(vols)[:, None]


def _space(n=8, dim=0, ndim=3):
    return M.volume_sharding(M.make_mesh((n,), ("space",), devices=["cpu"] * n), dim,
                             ndim=ndim)


def _same(a, b) -> bool:
    """Equal to the bit, NaNs included."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


# ---------------------------------------------------------------- the mesh


def test_torch_mesh_make_mesh_and_shardings():
    """``make_mesh``'s names, shapes and placements as the JAX module's; a
    mesh may name a device more than once; without devices it takes the
    CUDA devices, and raises without one (never the CPU)."""
    mesh = M.make_mesh(devices=CPU8)
    assert mesh.shape == {"data": 8} and mesh.axis_names == ("data",)
    grid = M.make_mesh((4, 2), ("data", "space"), devices=CPU8)
    assert grid.shape == {"data": 4, "space": 2}
    assert M.cohort_sharding(grid, 3, 0).spec == ("data", None, "space", None, None)
    assert M.batch_sharding(mesh).spec == ("data",)
    assert M.volume_sharding(grid, 1, ndim=2).spec == (None, None, None, "space")
    assert M.make_mesh((3,), devices=CPU8).size == 3
    with pytest.raises(ValueError, match="needs 9 devices"):
        M.make_mesh((9,), devices=CPU8)
    with pytest.raises(ValueError, match="not found in mesh"):
        M.batch_sharding(M.make_mesh((8,), ("space",), devices=CPU8))
    assert tr.make_mesh is M.make_mesh and tr.batch_sharding is M.batch_sharding
    assert tr.volume_sharding is M.volume_sharding
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh()


@pytest.mark.parametrize("shape,spec", [((8, 1, 4, 4), "batch"), ((16, 1, 4, 4), "batch"),
                                        ((6, 1, 4, 4), "batch"), ((12, 1, 4, 4), "batch"),
                                        ((1, 1, 32, 4, 4), "space"),
                                        ((1, 1, 30, 4, 4), "space"),
                                        ((1, 1, 4, 4, 4), "space"), ((1, 1, 9, 4, 4), "space")])
def test_torch_mesh_shard_splits_as_jax_does(shape, spec):
    """A split that JAX's ``device_put`` accepts on its eight devices the
    port accepts, block by block the same values, and ``gather`` puts them
    back; one JAX refuses (not a multiple of the axis) raises the same
    ``ValueError``."""
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    axis = "data" if spec == "batch" else "space"
    jm = jmesh.make_mesh((8,), (axis,))
    pm = M.make_mesh((8,), (axis,), devices=CPU8)
    jsh = jmesh.batch_sharding(jm) if spec == "batch" else jmesh.volume_sharding(jm)
    psh = M.batch_sharding(pm) if spec == "batch" else M.volume_sharding(pm)
    try:
        jx = jax.device_put(jnp.asarray(x), jsh)
    except ValueError as e:
        with pytest.raises(ValueError, match="should be divisible by 8"):
            M.shard(torch.from_numpy(x), psh)
        assert "divisible by 8" in str(e)
        return
    px = M.shard(torch.from_numpy(x), psh)
    blocks = sorted(jx.addressable_shards, key=lambda s: s.device.id)
    for block, shard in zip(blocks, px.shards):
        np.testing.assert_array_equal(np.asarray(block.data), shard.numpy())
    assert torch.equal(M.gather(px), torch.from_numpy(x))


@pytest.mark.parametrize("m,n,before,after", [(1, 8, 3, 3), (3, 8, 4, 4), (3, 4, 7, 2),
                                              (4, 8, 9, 9)])
@pytest.mark.parametrize("mode", ["zeros", "reflect"])
def test_torch_mesh_halo_rows(m, n, before, after, mode):
    """Each buffer holds the volume's rows ``[k m - before, (k+1) m +
    after)``: slabs of one and three rows, halos over up to three
    neighbours, zeros (or the reflected rows) past the volume's edges; the
    bytes counted are the rows read from other slabs."""
    S = n * m
    vol = torch.arange(2 * S * 3, dtype=torch.float32).reshape(1, 2, S, 3) + 1.0
    slabs = list(torch.split(vol, m, dim=2))
    halo.reset_counts()
    bufs = halo.fetch(slabs, 2, before, after, mode)
    moved = 0
    for k, buf in enumerate(bufs):
        for r in range(k * m - before, (k + 1) * m + after):
            row = buf[:, :, r - (k * m - before)]
            src = r if 0 <= r < S else None if mode == "zeros" else (
                -r if r < 0 else 2 * (S - 1) - r)
            want = torch.zeros_like(row) if src is None else vol[:, :, src]
            moved += (src is not None and src // m != k) * row.numel() * 4
            assert torch.equal(row, want), (k, r)
    assert halo.copied_bytes == moved == halo.bytes_of(slabs[0].shape, 2, n, before, after, 4,
                                                        mode)
    assert halo.calls == 1


# ------------------------------------------------------ the space axis: K1


def _passes(params, S, requires_grad=False):
    theta = rigid_theta(torch.tensor(params, dtype=torch.float32))[None]
    theta.requires_grad_(requires_grad)
    return theta, factor_passes(*affine_to_index_map(theta[0], (S, S, S)))


def test_torch_mesh_sharded_warp_matches_jax_and_unsharded():
    """``tests/test_parallel.py:82``: the 32^3 warp of a volume split into 8
    z-slabs of 4 rows (``max_shift=8``: each pass along z reads a halo of 9
    rows a side, over three neighbours) equals the unsharded warp to the
    bit and JAX's warp of its sharded volume within rtol 1e-5 / atol 1e-6."""
    vol = _blobs(1, (32, 32, 32), seed=9)
    theta = rigid_theta(torch.tensor(WARP_PARAMS))[None]
    sh = _space()
    halo.reset_counts()
    out = warp_affine_separable(theta, M.shard(torch.from_numpy(vol), sh), max_shift=8)
    assert isinstance(out, M.Sharded) and halo.calls == 1
    assert halo.copied_bytes == halo.bytes_of((1, 1, 4, 32, 32), 2, 8, 9, 9, 4)
    ref = warp_affine_separable(theta, torch.from_numpy(vol), max_shift=8)
    assert _same(M.gather(out), ref)
    jm = jmesh.make_mesh((8,), ("space",))
    jtheta = j_rigid_theta(jnp.asarray(WARP_PARAMS, jnp.float32))[None]
    jvol = jax.device_put(jnp.asarray(vol), jmesh.volume_sharding(jm))
    jout = jax.jit(lambda t, v: j_warp_separable(t, v, max_shift=8))(jtheta, jvol)
    np.testing.assert_allclose(M.gather(out).numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,n,K,dtype", [(32, 8, 8, torch.float32), (24, 8, 2, torch.float32),
                                         (24, 8, 5, torch.bfloat16), (18, 6, 3, torch.float32)],
                         ids=["32-8-slabs-K8", "24-slabs-of-3-K2", "24-bf16-K5",
                              "18-slabs-of-3-K3"])
def test_torch_mesh_sharded_warp_backward(S, n, K, dtype):
    """The backward on slabs: dsrc (gathered from the upstream gradient's
    halo) equals the unsharded warp's to the bit; the theta gradient (each
    slab's row gradients summed in ascending order) within 1e-6 of its
    largest entry, 2^-7 in bf16."""
    vol = torch.from_numpy(_blobs(1, (S, S, S), seed=S + n)).to(dtype)
    g = torch.from_numpy(_blobs(1, (S, S, S), seed=S - n)).to(dtype) - 0.5

    def grads(src):
        theta, passes = _passes(WARP_PARAMS, S, requires_grad=True)
        if isinstance(src, M.Sharded):
            for s in src.shards:
                s.requires_grad_(True)
            out = k1.sweep_affine_passes(src, passes, (K,) * 3)
            gs = M.shard(g, src.sharding).shards
            *ds, dth = torch.autograd.grad(out.shards, [*src.shards, theta], gs)
            return torch.cat(ds, 2), dth
        src = src.clone().requires_grad_(True)
        out = k1.sweep_affine_passes(src, passes, (K,) * 3)
        return torch.autograd.grad(out, (src, theta), g)

    ref_src, ref_theta = grads(vol)
    got_src, got_theta = grads(M.shard(vol, _space(n)))
    assert _same(got_src, ref_src)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got_theta.numpy(), ref_theta.numpy(), rtol=0,
                               atol=tol * float(ref_theta.abs().max()))


def test_torch_mesh_slab_plain_pass_against_the_unsharded_pass():
    """K1's plain slab pass on each slab's buffer (its origin applied) equals
    the unsharded plain pass's rows to the bit, for every pass of the warp,
    along and across the split axis, with one table and a table per item."""
    S, n, K = 16, 4, 5
    m = S // n
    vol = torch.from_numpy(_blobs(2, (S, S, S), seed=4))
    for per_item in (False, True):
        theta = rigid_theta(torch.tensor([WARP_PARAMS, ENGINE_PARAMS]))
        if not per_item:
            theta = theta[:1]
        M_, t = affine_to_index_map(theta if per_item else theta[0], (S, S, S))
        for axis, (coef, offset) in factor_passes(M_, t):
            ref = k1.sweep_affine_plain(vol, coef, offset, axis, K)
            slabs = list(torch.split(vol, m, dim=2))
            h = k1.slab_halo(K)
            bufs = halo.fetch(slabs, 2, h, h) if axis == 0 else slabs
            for k in range(n):
                got = k1.sweep_affine_slab_plain(bufs[k], coef, offset, axis, K,
                                                 k1.SlabGeo(0, k * m, S), slabs[k].shape)
                assert _same(got, ref[:, :, k * m:(k + 1) * m]), (per_item, axis, k)


def test_torch_mesh_slab_launchers_check_their_inputs():
    """The slab launchers check shapes before any build (a buffer without
    its halo, a slab outside the volume), as the other K1 launchers do."""
    slab = torch.zeros((1, 1, 4, 8, 8))
    table = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="source buffer"):
        k1.affine_slab_fwd(slab, table, 2, 0, 3, k1.SlabGeo(0, 4, 16), slab.shape)
    with pytest.raises(ValueError, match="not inside"):
        k1.affine_slab_fwd(slab, table, 0, 2, 3, k1.SlabGeo(0, 14, 16), slab.shape)
    with pytest.raises(ValueError, match="CUDA"):
        k1.affine_slab_fwd(slab, table, 0, 2, 3, k1.SlabGeo(0, 4, 16), slab.shape)


# ------------------------------------------------- the space axis: engines


def _engine_case():
    vol = _blobs(1, (24, 24, 24), seed=30)
    jtheta = j_rigid_theta(jnp.asarray(ENGINE_PARAMS, jnp.float32))[None]
    tgt = np.array(j_warp_affine(jtheta, jnp.asarray(vol)))
    return vol, tgt


@pytest.mark.parametrize("grad_edges", [False, True], ids=["images", "grad_edges"])
def test_torch_mesh_rigid_engine_on_slabs(grad_edges):
    """``tests/test_parallel.py:235``: a complete rigid optimization (MSE,
    Adam, 40 steps, windows of 8) on a 24^3 pair split into 8 z-slabs of 3
    rows: ``best_theta`` within ``tests/test_parallel.py:258``'s rtol 1e-4 /
    atol 1e-5 and the losses within its rtol 1e-4 / atol 1e-6 of the port's
    unsharded run, as JAX's sharded engine is held to its unsharded one;
    against JAX's engine on its space-sharded pair, the engines' tolerances
    across the frameworks (theta atol 1e-4, ``tests/test_torch_engines.py``;
    losses rtol 1e-3 / atol 3e-4), since Adam turns the frameworks' ~1e-7
    gradient rounding into ~4e-5 of theta here, sharded or not
    (``grad_edges``: the edge masks of both, K3's plain version on each
    slab's halo, equal to the unsharded filter's to the bit; JAX's engine on
    JAX's masks). The warped image comes back split alike."""
    vol, tgt = _engine_case()
    jm = jmesh.make_mesh((8,), ("space",))
    jsh = jmesh.volume_sharding(jm)
    jvol, jtgt = jnp.asarray(vol), jnp.asarray(tgt)
    if grad_edges:
        from torchregister_tpu.ops.edge import edge_filter as j_edge_filter

        jvol, jtgt = j_edge_filter(jvol), j_edge_filter(jtgt)
    fns = _build_rigid_fn((j_mse,), (1.0,), 2e-3, 40, "adam", 3, "separable", 8, None, 25)
    jres = fns.run(jax.device_put(jvol, jsh), jax.device_put(jtgt, jsh),
                   jnp.zeros((6,), jnp.float32))
    kw = dict(lr=2e-3, epochs=40, criterions=["mse"], optimizer="adam", init="identity",
              max_shift=8, grad_edges=grad_edges)
    sh = _space()
    warped, res = rigid_register(M.shard(torch.from_numpy(vol), sh),
                                 M.shard(torch.from_numpy(tgt), sh), **kw)
    assert isinstance(warped, M.Sharded) and res.steps == 40
    np.testing.assert_allclose(res.best_theta.numpy(), np.asarray(jres.best_theta), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses), rtol=1e-3,
                               atol=3e-4)
    ref_warped, ref = rigid_register(torch.from_numpy(vol), torch.from_numpy(tgt), **kw)
    np.testing.assert_allclose(res.best_theta.numpy(), ref.best_theta.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.losses.numpy(), ref.losses.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(M.gather(warped).numpy(), ref_warped.numpy(), atol=1e-4)
    if grad_edges:
        masks = edge_filter(M.shard(torch.from_numpy(vol), sh))
        assert _same(M.gather(masks), edge_filter(torch.from_numpy(vol)))


def test_torch_mesh_affine_engine_and_criteria_on_slabs():
    """``affine_register`` on slabs (MSE + NCC) against its unsharded run;
    MSE, SSD and NCC of sharded pairs against the whole volume's, values and
    gradients."""
    vol, tgt = _engine_case()
    sh = _space()
    kw = dict(lr=1e-3, epochs=15, criterions=["mse", "ncc"], weights=[1.0, 0.01],
              optimizer="adam", grad_edges=False, max_shift=8)
    _, res = tr.affine_register(M.shard(torch.from_numpy(vol), sh),
                                M.shard(torch.from_numpy(tgt), sh), **kw)
    _, ref = tr.affine_register(torch.from_numpy(vol), torch.from_numpy(tgt), **kw)
    np.testing.assert_allclose(res.best_theta.numpy(), ref.best_theta.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.losses.numpy(), ref.losses.numpy(), rtol=1e-4, atol=1e-6)
    y, yp = torch.from_numpy(vol), torch.from_numpy(tgt)
    for crit in (tr.mse, tr.ssd, tr.ncc):
        p = yp.clone().requires_grad_(True)
        want = crit(y, p)
        (gw,) = torch.autograd.grad(want, p)
        ps = M.shard(yp, sh)
        for s in ps.shards:
            s.requires_grad_(True)
        got = crit(M.shard(y, sh), ps)
        gs = torch.autograd.grad(got, ps.shards)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        np.testing.assert_allclose(torch.cat(gs, 2).numpy(), gw.numpy(), rtol=0,
                                   atol=1e-6 * float(gw.abs().max()))


def test_torch_mesh_space_axis_refusals():
    """A batch split over ``data`` is not a volume split into slabs;
    ``spatial_axis`` without a mesh raises JAX's ``ValueError``. (The exact
    method, a batch of pairs over ``data x space`` and NMI and LNCC on
    slabs run: ``tests/test_torch_mesh_exact.py``,
    ``tests/test_torch_mesh_batch.py``, ``tests/test_torch_mesh_criteria.py``;
    one exact step runs here.)"""
    vol, tgt = _engine_case()
    sh = _space()
    y, yp = M.shard(torch.from_numpy(vol), sh), M.shard(torch.from_numpy(tgt), sh)
    warped, res = rigid_register(y, yp, epochs=1, criterions=["mse"], method="exact")
    assert isinstance(warped, M.Sharded) and res.steps == 1
    with pytest.raises(ValueError, match="requires a mesh with a 'space' axis"):
        make_cascade_batch_fn(spatial_axis=0, flow_model="field")
    batch = M.shard(torch.zeros((8, 1, 8, 8)), M.batch_sharding(M.make_mesh(devices=CPU8)))
    passes = factor_passes(*affine_to_index_map(rigid_theta(torch.zeros(3)), (8, 8)))
    with pytest.raises(ValueError, match="spatial dim"):
        k1.sweep_affine_slabs(batch, passes, (2, 2))


# ------------------------------------------------------------- the data axis


def _results_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert _same(x, y), name
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), name
            for k in x:
                assert _same(x[k], y[k]) if isinstance(x[k], torch.Tensor) else x[k] == y[k], k
        else:
            assert x == y, name


@pytest.mark.parametrize("case", ["rigid", "affine", "flow"])
def test_torch_mesh_cohort_on_the_data_axis(case):
    """``register_cohort(mesh=)`` over 8 shards of one pair: every pair
    equal to the unsharded call's to the bit (rigid: random inits drawn for
    the whole batch first, and ``grad_edges``; flow: the field mode). Against
    JAX's sharded cohort (``tests/test_parallel.py:69``'s cases) the pairs
    are held to ``tests/test_torch_cohort.py``'s tolerances across the
    frameworks under Adam: 1e-2 of theta (Adam turns the ~1e-7 gradient
    rounding into ~3e-3 of theta here, as in the unsharded cohort), the
    field to 1e-2 of its largest value."""
    mesh = M.make_mesh(devices=CPU8)
    kw = {"rigid": dict(mode="rigid", lr=1e-3, epochs=10, criterions=["mse"],
                        optimizer="adam", init="random", seed=2, grad_edges=True),
          "affine": dict(mode="affine", lr=1e-3, epochs=15, criterions=["mse"],
                         optimizer="adam"),
          "flow": dict(mode="flow", epochs=12, criterions=["mse"], max_disp=3)}[case]
    size = (16, 16) if case == "rigid" else (12, 12)
    movings, targets = _blobs(8, size, seed=3), _blobs(8, size, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = register_cohort(torch.from_numpy(movings), torch.from_numpy(targets), **kw)
        got = register_cohort(torch.from_numpy(movings), torch.from_numpy(targets), mesh=mesh,
                              **kw)
    _results_equal(got, ref)
    if case == "rigid":  # JAX draws its random inits from its own key
        return
    jres = j_register_cohort(jnp.asarray(movings), jnp.asarray(targets),
                             mesh=jmesh.make_mesh((8,), ("data",)), **kw)
    if case == "affine":
        np.testing.assert_allclose(got.best_theta.numpy(), np.asarray(jres.best_theta),
                                   rtol=0, atol=1e-2)
    else:
        want = np.asarray(jres.flow)
        np.testing.assert_allclose(got.flow.numpy(), want, rtol=0,
                                   atol=1e-2 * float(np.abs(want).max()))


def test_torch_mesh_cohort_unet_and_uneven_batch():
    """A U-Net cohort over 2 shards (every pair's weights drawn first, pair
    after pair): each pair equal to the unsharded call's to the bit. A batch
    that does not split evenly raises JAX's ``ValueError``, as
    ``examples/cohort_driver.py:75`` refuses it."""
    movings = torch.from_numpy(_blobs(4, (16, 16)))
    targets = torch.from_numpy(_blobs(4, (16, 16), seed=1))
    kw = dict(mode="flow", flow_model="unet", epochs=2, criterions=["mse"], n=32, depth=1,
              seed=3)
    mesh = M.make_mesh(devices=["cpu"] * 2)
    _results_equal(register_cohort(movings, targets, mesh=mesh, **kw),
                   register_cohort(movings, targets, **kw))
    with pytest.raises(ValueError, match="should be divisible by 8"):
        register_cohort(movings[:3].repeat(2, 1, 1, 1), targets[:3].repeat(2, 1, 1, 1),
                        mesh=M.make_mesh(devices=CPU8), mode="rigid", epochs=1)
    with pytest.raises(ValueError, match="should be divisible by 8"):
        make_cascade_batch_fn(mesh=M.make_mesh(devices=CPU8), stages=("rigid",))(
            movings[:2], targets[:2])


CASCADE = dict(levels=2, matrix_levels=2, flow_levels=2, rigid_epochs=30, affine_epochs=15,
               flow_epochs=10, criterions=("mse",), flow_max_disp=3)


@pytest.mark.parametrize("flow_model", ["field", "unet"])
def test_torch_mesh_cascade_batch_on_the_data_axis(flow_model):
    """``make_cascade_batch_fn(mesh=)`` over 2 shards, field and U-Net flow:
    every field of the result equal to the unsharded call's to the bit (one
    factory for the device, its shards one after another); cached on the
    config and the mesh; ``spatial_axis`` on a mesh without a ``space`` axis
    raises ``ValueError``."""
    cfg = {**CASCADE, "flow_model": flow_model}
    if flow_model == "unet":
        cfg.update(n=16, flow_depth=1)
    movings = torch.from_numpy(_blobs(2, (32, 32)))
    targets = torch.from_numpy(_blobs(2, (32, 32), seed=1))
    mesh = M.make_mesh(devices=["cpu"] * 2)
    fn = make_cascade_batch_fn(mesh=mesh, **cfg)
    assert make_cascade_batch_fn(mesh=mesh, **cfg) is fn
    assert fn is not make_cascade_batch_fn(**cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _results_equal(fn(movings, targets), make_cascade_batch_fn(**cfg)(movings, targets))
    assert len(fn.fns) == 1
    with pytest.raises(ValueError, match="space is not found in mesh"):
        make_cascade_batch_fn(mesh=mesh, spatial_axis=0, **cfg)
