"""The cascade over a ``data x space`` mesh (``make_cascade_batch_fn(mesh=,
spatial_axis=)``) and the pieces it runs on a batch of pairs split into
slabs, on the CPU (a mesh that names the CPU several times; the JAX package
on its eight forced CPU devices, ``tests/conftest.py``).

JAX's own multichip dry run (``__graft_entry__.py:184-196``'s config, 24³,
the shifted blob pair, 4 pairs on a ``(4, 2)`` mesh) in both packages: the
same steps per stage, theta within 1e-2 and the field within ``2 lr
epochs`` (``tests/test_torch_cascade_batch.py``'s tolerances: both run Adam,
whose normalized steps turn the frameworks' rounding of near-zero gradients
into steps of about lr), the warped images within 0.25 of the images' unit
peak (what those fields' differences move), and each matrix stage's loss at
every step within 2e-2 of JAX's (a fifth of the least drop of a stage's
loss over its steps, 0.098: a stage that did not move fails). Each pair of
a batch on a row of slabs equals its own run on one row of the same slabs
to the bit, field and U-Net; the field cascade on slabs against the port's
unsharded batch, held to the spread that one ulp of input gives that batch;
the pyramid, the moments, the criteria and the flow
compositions on slabs with two pairs against the unsharded calls; the
per-pair second order's plain version against single-table calls; the
layout against JAX's ``cohort_sharding``; the refusals.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchregister_tpu.engines.cascade import make_cascade_batch_fn as j_make_batch_fn
from torchregister_tpu.parallel import mesh as jmesh
from torchregister_tpu_torch.engines.cascade import make_cascade_batch_fn
from torchregister_tpu_torch.losses import pair_loss, resolve_criteria
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.moments import com_rigid_params, pa_rigid_params
from torchregister_tpu_torch.ops.resize import downsample_avg
from torchregister_tpu_torch.parallel import mesh as M
from torchregister_tpu_torch.utils.pyramid import (build_pyramid, compose_flows,
                                                   compose_flows_separable)

S = 24
# __graft_entry__.py:184-196
DRYRUN = dict(stages=("rigid", "affine", "flow"), levels=2, rigid_epochs=6, rigid_lr=3e-3,
              affine_epochs=4, affine_lr=1e-3, flow_epochs=6, flow_lr=0.3,
              criterions=("mse", "ncc"), optimizer="adam", flow_model="field",
              flow_smooth=0.5, flow_max_disp=2, residual_shift=4, flow_levels=2)
# a U-Net cascade with a composition, in 2-D (48², a coarse level of 24²)
UNET = {**DRYRUN, "flow_model": "unet", "n": 16, "flow_depth": 1, "flow_lr": 1e-3,
        "flow_smooth": None}


def _mesh(data, space):
    return M.make_mesh((data, space), ("data", "space"), devices=["cpu"] * (data * space))


def _dryrun_pairs(B=4, ndim=3, size=S):
    """``__graft_entry__.py:186-193``'s blob and its shift by 2 along the
    first spatial axis, each pair's moving image varied (scaled, rolled) so
    the pairs differ."""
    ax = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    grids = np.meshgrid(*[ax] * ndim, indexing="ij")
    blob = np.exp(-sum(g ** 2 for g in grids) / 0.18).astype(np.float32)
    mov = np.stack([blob * (1.0 + 0.1 * b) for b in range(B)])[:, None]
    for b in range(B):
        mov[b] = np.roll(mov[b], b % 3 - 1, axis=1 + b % ndim)
    return mov, np.roll(mov, 2, axis=2)


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _pairs_equal_their_row_runs(res, movings, targets, cfg, spatial_axis, space=2):
    """Each pair of ``res`` against its own run on a ``(1, space)`` mesh."""
    one = make_cascade_batch_fn(mesh=_mesh(1, space), spatial_axis=spatial_axis, **cfg)
    warped, flow = M.gather(res.warped), M.gather(res.flow)
    for b in range(movings.shape[0]):
        r = one(movings[b:b + 1], targets[b:b + 1])
        assert {k: v[0] for k, v in r.steps.items()} == {k: v[b] for k, v in res.steps.items()}
        assert _same(r.theta[0], res.theta[b])
        assert _same(M.gather(r.warped)[0], warped[b])
        assert _same(M.gather(r.flow)[0], flow[b])
        for name in ("rigid_losses", "affine_losses", "flow_losses"):
            assert torch.equal(getattr(r, name)[0].nan_to_num(-1.0),
                               getattr(res, name)[b].nan_to_num(-1.0)), name


@pytest.fixture(scope="module")
def dryrun():
    """JAX's and the port's dry-run cascade on a ``(4, 2)`` mesh, once."""
    mov, tgt = _dryrun_pairs()
    jm = jmesh.make_mesh((4, 2), ("data", "space"))
    jres = j_make_batch_fn(mesh=jm, spatial_axis=0, **DRYRUN)(jnp.asarray(mov),
                                                               jnp.asarray(tgt))
    m, t = torch.from_numpy(mov), torch.from_numpy(tgt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = make_cascade_batch_fn(mesh=_mesh(4, 2), spatial_axis=0, **DRYRUN)(m, t)
    return jres, res, m, t


def test_torch_mesh_batch_dryrun_matches_jax(dryrun):
    """The port's result laid out as JAX's (``warped [B, 1, 1, *S]`` split
    over ``data`` and ``space``), the steps per stage JAX's, theta, the
    field and the image within the module note's tolerances."""
    jres, res, _, _ = dryrun
    assert isinstance(res.warped, M.Sharded) and res.warped.shape == (4, 1, 1, S, S, S)
    assert res.warped.sharding.spec == ("data", None, None, "space", None, None)
    assert res.flow.sharding.spec == ("data", None, None, "space", None, None)
    assert res.theta.shape == (4, 1, 3, 4)
    for stage in ("rigid", "affine", "flow"):
        j_losses = np.asarray(getattr(jres, f"{stage}_losses"))
        for b in range(4):
            assert sum(res.steps[stage][b]) == int(np.sum(~np.isnan(j_losses[b]))), stage
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta), rtol=0, atol=1e-2)
    np.testing.assert_allclose(M.gather(res.flow).numpy(), np.asarray(jres.flow), rtol=0,
                               atol=2 * DRYRUN["flow_lr"] * DRYRUN["flow_epochs"])
    np.testing.assert_allclose(M.gather(res.warped).numpy(), np.asarray(jres.warped), rtol=0,
                               atol=0.25)
    for stage in ("rigid", "affine"):
        np.testing.assert_allclose(getattr(res, f"{stage}_losses").numpy(),
                                   np.asarray(getattr(jres, f"{stage}_losses")), rtol=0,
                                   atol=2e-2, equal_nan=True, err_msg=stage)


def _ulp(x, to):
    return torch.nextafter(x, torch.full_like(x, to))


def _rms(a, b) -> float:
    return float(((a - b) ** 2).mean().sqrt())


def _field_near_unsharded(res, m, t):
    """``res`` (the field cascade on slabs) against the unsharded batch: the
    same steps; each pair's field (RMS over its voxels) and theta within
    twice the most that one ulp of input moves that pair's unsharded run
    (moving up, moving down, target up), theta within 1e-6 at least; each
    pair's field's limit below the RMS of its field, so a field left at
    zero fails."""
    flat = make_cascade_batch_fn(**DRYRUN)
    want = flat(m, t)
    ulps = [flat(_ulp(m, np.inf), t), flat(_ulp(m, -np.inf), t), flat(m, _ulp(t, np.inf))]
    assert res.steps == want.steps
    flow = M.gather(res.flow)
    for b in range(m.shape[0]):
        limit = 2 * max(_rms(u.flow[b], want.flow[b]) for u in ulps)
        assert _rms(flow[b], want.flow[b]) <= limit < _rms(want.flow[b], 0.0), b
        lim = max(2 * max(float((u.theta[b] - want.theta[b]).abs().max()) for u in ulps), 1e-6)
        assert float((res.theta[b] - want.theta[b]).abs().max()) <= lim, b


@pytest.mark.parametrize("case", ["field", "unet"])
def test_torch_mesh_batch_pairs_equal_their_row_runs(dryrun, case):
    """Each pair of a batch of 2 pairs a row (a ``(2, 2)`` mesh) equals its
    own run on a ``(1, 2)`` mesh to the bit (every field, the steps, the
    losses): the field cascade at 24³ split along z (and the ``(4, 2)``
    run's pairs likewise; the ``(2, 2)`` run near the unsharded batch as
    ``_field_near_unsharded`` holds it), the U-Net cascade (a net a pair, composed across
    two levels) at 48² split along x, its final warp exact."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if case == "field":
            _, res4, m, t = dryrun
            _pairs_equal_their_row_runs(res4, m, t, DRYRUN, 0)
            res = make_cascade_batch_fn(mesh=_mesh(2, 2), spatial_axis=0, **DRYRUN)(m, t)
            _pairs_equal_their_row_runs(res, m, t, DRYRUN, 0)
            _field_near_unsharded(res, m, t)
            return
        mov, tgt = _dryrun_pairs(ndim=2, size=48)
        m, t = torch.from_numpy(mov), torch.from_numpy(tgt)
        cfg = {**UNET, "final_warp": "exact"}
        res = make_cascade_batch_fn(mesh=_mesh(2, 2), spatial_axis=1, **cfg)(m, t)
        _pairs_equal_their_row_runs(res, m, t, cfg, 1)
        want = make_cascade_batch_fn(**cfg)(m, t)
    assert res.steps == want.steps
    np.testing.assert_allclose(M.gather(res.flow).numpy(), want.flow.numpy(), rtol=0,
                               atol=1e-4)


def test_torch_mesh_batch_ops_on_slabs_equal_unsharded():
    """Two pairs on 2 z-slabs against the unsharded calls: the pyramid and
    both flow compositions to the bit; the CoM and principal-axes inits
    within 1e-6 (the slabs' partial sums added in order), each pair's MSE +
    NCC within 1e-6 relative, and each pair's value on the batch's slabs
    equal to the same pair alone on them to the bit. A pool whose windows
    straddle the slabs (factor 3 on slabs of 16 rows) fetches the row it
    needs; one whose output does not split evenly raises."""
    rng = np.random.default_rng(0)
    mov = torch.from_numpy(rng.random((2, 1, 32, S, S), dtype=np.float32))
    tgt = torch.from_numpy(rng.random((2, 1, 32, S, S), dtype=np.float32))
    sh = M.volume_sharding(M.make_mesh((2,), ("space",), devices=["cpu"] * 2), 0)
    ms, ts = M.shard(mov, sh), M.shard(tgt, sh)
    for a, b in zip(build_pyramid(ms, 3), build_pyramid(mov, 3)):
        assert _same(M.gather(a), b)
    assert _same(M.gather(downsample_avg(ms, 3)), downsample_avg(mov, 3))
    with pytest.raises(ValueError, match="do not split evenly"):
        downsample_avg(M.shard(mov[:, :, :30], sh), 2)
    for fn in (com_rigid_params, pa_rigid_params):
        for b, (m1, t1) in enumerate(zip(ms.chunk(2), ts.chunk(2))):
            np.testing.assert_allclose(fn(m1, t1).numpy(), fn(mov[b:b + 1], tgt[b:b + 1]).numpy(),
                                       rtol=0, atol=1e-6)
    loss = pair_loss(*resolve_criteria(("mse", "ncc"), None), 2)
    got, want = loss(ts, ms), loss(tgt, mov)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    one = pair_loss(*resolve_criteria(("mse", "ncc"), None), 1)
    alone = M.shard(mov[1:], sh), M.shard(tgt[1:], sh)
    assert _same(one(alone[1], alone[0]), got[1:])
    f1 = torch.from_numpy(rng.normal(0, 1.5, (2, 3, 32, S, S)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(0, 1.5, (2, 3, 32, S, S)).astype(np.float32))
    s1, s2 = M.shard(f1, sh), M.shard(f2, sh)
    assert _same(M.gather(compose_flows_separable(s1, s2, 4)),
                 compose_flows_separable(f1, f2, 4))
    assert _same(M.gather(compose_flows(s1, s2)), compose_flows(f1, f2))


@pytest.mark.parametrize("split", [0, 2])
def test_torch_mesh_batch_bwd2_per_pair_plain(split):
    """The plain version of ``sweep_slab_bwd2`` with a table per pair (LM on
    a batch of pairs on slabs) equals two single-table calls to the bit:
    gbar, sbar and each pair's row gradient."""
    from torchregister_tpu_torch.ops.separable import affine_to_index_map, factor_passes
    from torchregister_tpu_torch.ops.transforms import rigid_theta

    n, K, B = 2, 3, 2
    rng = np.random.default_rng(split)
    src, g, u = (torch.from_numpy(rng.standard_normal((B, 1, 12, 12, 12), dtype=np.float32))
                 for _ in range(3))
    p = torch.tensor([[0.05, -0.04, 0.03, 0.1, -0.1, 0.05], [0.0, 0.1, -0.05, -0.1, 0.0, 0.2]])
    table, axes = k1.pass_table(factor_passes(*affine_to_index_map(rigid_theta(p), (12,) * 3)))
    rbar = torch.from_numpy(rng.standard_normal((B, 3, 4), dtype=np.float32))
    geos = tuple(k1.SlabGeo(split, k * 6, 12) for k in range(n))
    slab = tuple(6 if i == 2 + split else s for i, s in enumerate(src.shape))
    for q, axis in enumerate(axes):
        bufs = [k1._halo_of(list(torch.split(x, 6, 2 + split)), axis, K, geos)
                for x in (src, g, u)]
        for k in range(n):
            args = [x[k] for x in (bufs[1], bufs[0], bufs[2])]
            dt = torch.zeros_like(table)
            gbar, sbar = k1._slab_bwd2(*args, table, q, axis, K, geos[k], slab, rbar, True, True,
                                       dt, None)
            for b in range(B):
                dt1 = torch.zeros_like(table[b])
                g1, s1 = k1._slab_bwd2(*(a[b:b + 1] for a in args), table[b], q, axis, K,
                                       geos[k], (1, *slab[1:]), rbar[b], True, True, dt1, None)
                assert _same(gbar[b:b + 1], g1) and _same(sbar[b:b + 1], s1)
                assert _same(dt[b], dt1)


def test_torch_mesh_batch_layout_and_refusals():
    """``shard(x, cohort_sharding(mesh, spatial_axis=0))`` on a ``(4, 2)``
    mesh gives JAX's ``device_put`` blocks, one a (data, space) position;
    ``space_rows`` takes each data position's row of slabs and ``join_rows``
    puts them back. ``spatial_axis`` without a mesh raises JAX's
    ``ValueError``; a mesh without a ``space`` axis raises as
    ``cohort_sharding`` does; an uneven batch as ``device_put`` does."""
    x = np.arange(8 * 1 * 8 * 2 * 2, dtype=np.float32).reshape(8, 1, 8, 2, 2)
    jx = jax.device_put(jnp.asarray(x), jmesh.cohort_sharding(
        jmesh.make_mesh((4, 2), ("data", "space")), spatial_axis=0))
    mesh = _mesh(4, 2)
    px = M.shard(torch.from_numpy(x), M.cohort_sharding(mesh, spatial_axis=0))
    blocks = sorted(jx.addressable_shards, key=lambda s: s.device.id)
    for block, shard in zip(blocks, px.shards):
        np.testing.assert_array_equal(np.asarray(block.data), shard.numpy())
    rows = M.space_rows(px, M.row_meshes(mesh))
    assert len(rows) == 4 and rows[1].shape == (2, 1, 8, 2, 2)
    assert torch.equal(M.gather(rows[1]), torch.from_numpy(x[2:4]))
    back = M.join_rows(rows, mesh)
    assert back.sharding.spec == px.sharding.spec and torch.equal(M.gather(back), M.gather(px))
    with pytest.raises(ValueError) as want:
        j_make_batch_fn(spatial_axis=0, **DRYRUN)
    with pytest.raises(ValueError) as got:
        make_cascade_batch_fn(spatial_axis=0, **DRYRUN)
    assert str(got.value) == str(want.value)
    m, t = map(torch.from_numpy, _dryrun_pairs(B=2, size=8))
    with pytest.raises(ValueError, match="not found in mesh"):
        make_cascade_batch_fn(mesh=M.make_mesh(devices=["cpu"] * 2), spatial_axis=0,
                              **DRYRUN)(m, t)
    with pytest.raises(ValueError, match="should be divisible by 4"):
        make_cascade_batch_fn(mesh=_mesh(4, 2), spatial_axis=0, **DRYRUN)(m, t)
