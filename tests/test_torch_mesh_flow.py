"""The port's flow engine and LM on a volume split into slabs over the
``space`` axis, on the CPU, a mesh that names the CPU up to eight times,
against the JAX package on its eight forced CPU devices
(``tests/conftest.py``) and against the port's own unsharded calls.

- K1's flow form in the slab mode (its plain version here): the warp and
  dsrc equal to the unsharded plain passes to the bit, the field's gradient
  too; ``sweep_bwd2``'s slab mode likewise (gbar and sbar to the bit, the
  row's gradient within f32 rounding of its sum over the slabs).
- ``halo.fetch_rows`` on uneven partitions (empty slabs, buffers spanning
  several neighbours, every mode), its backward summing each owner's rows
  in ascending slab order.
- The diffusion term and ``upsample_flow`` on slabs against unsharded.
- ``flow_register(flow_model='field')`` on 8 slabs against JAX's
  ``_build_flow_fn(..., flow_model='field')`` on a space-sharded array and
  the port unsharded; JAX's own U-Net case (``tests/test_parallel.py:273``)
  with JAX's init carried in by ``convert.unet_params``.
- LM on slabs: 2-D against JAX's LM unsharded, 3-D against the port
  unsharded.
- Dropping a cascade factory's step graphs frees them with ``gc`` off.
"""
import gc
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchregister_tpu_torch as tr
from torchregister_tpu.engines.flow import _build_flow_fn
from torchregister_tpu.engines.rigid import rigid_register as j_rigid
from torchregister_tpu.losses.similarity import mse as j_mse, ncc as j_ncc
from torchregister_tpu.ops.resample import warp_affine as j_warp_affine
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu.parallel import mesh as jmesh
from torchregister_tpu_torch import convert
from torchregister_tpu_torch.engines import flow as tflow
from torchregister_tpu_torch.engines import graph
from torchregister_tpu_torch.engines.affine import affine_register
from torchregister_tpu_torch.engines.cascade import CascadeFn
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.separable import warp_flow_separable
from torchregister_tpu_torch.parallel import halo
from torchregister_tpu_torch.parallel import mesh as M
from torchregister_tpu_torch.utils.pyramid import upsample_flow


def _blobs(shape, seed=0):
    """``tests/test_parallel.py``'s blobs, numpy ``[1, 1, *S]``."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    vol = np.zeros(shape, np.float32)
    for _ in range(4):
        c = rng.uniform(-0.4, 0.4, len(shape))
        w = rng.uniform(0.15, 0.3)
        vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2))
    return vol[None, None]


def _space(n=8, dim=0, ndim=3):
    return M.volume_sharding(M.make_mesh((n,), ("space",), devices=["cpu"] * n), dim,
                             ndim=ndim)


def _same(a, b) -> bool:
    """Equal to the bit, NaNs included."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _jax_space(x):
    mesh = jmesh.make_mesh((8,), ("space",))
    return jax.device_put(jnp.asarray(x), jmesh.volume_sharding(mesh, spatial_axis=0,
                                                                 mesh_axis="space", ndim=3))


# -------------------------------------------------------------- the kernels


# (edge, slabs, K, split dim, channels): 8 slabs of 3 rows under a window
# whose halo (K + 1 = 9 rows) reaches 3 neighbours; 4 slabs split along x
@pytest.mark.parametrize("S,n,K,dim,C", [(24, 8, 8, 0, 1), (24, 8, 8, 0, 3), (32, 4, 3, 2, 1),
                                         (32, 4, 3, 2, 3)])
def test_torch_mesh_flow_slab_warp_equals_the_unsharded_passes(S, n, K, dim, C):
    """The flow warp on slabs (K1's flow form: the pass along the split axis
    in the slab mode, its plain version here) against the unsharded plain
    passes: the warp, dsrc and the field's gradient to the bit."""
    rng = np.random.default_rng(S + C)
    src = torch.from_numpy(rng.standard_normal((1, C, S, S, S)).astype(np.float32))
    flow = torch.from_numpy((2.5 * rng.standard_normal((1, 3, S, S, S))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, C, S, S, S)).astype(np.float32))
    s0, f0 = src.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    ref = k1.sweep_flow_passes(s0, f0, K)
    dsrc, dflow = torch.autograd.grad(ref, (s0, f0), g)
    sh = _space(n, dim)
    ss, fs = M.shard(src, sh), M.shard(flow, sh)
    for t in ss.shards + fs.shards:
        t.requires_grad_(True)
    out = warp_flow_separable(ss, fs, max_disp=K)
    grads = torch.autograd.grad(out.shards, ss.shards + fs.shards, M.shard(g, sh).shards)
    assert isinstance(out, M.Sharded) and out.sharding is ss.sharding
    assert _same(M.gather(out), ref.detach())
    assert _same(torch.cat(grads[:n], 2 + dim), dsrc)
    assert _same(torch.cat(grads[n:], 2 + dim), dflow)


def test_torch_mesh_flow_slab_pass_checks_its_inputs():
    """The flow form's slab launchers check the buffer, the field and the
    pass before any build (a pass across the split axis is slab-local)."""
    geo = k1.SlabGeo(0, 4, 16)
    shape = (1, 1, 4, 8, 8)
    buf = torch.zeros((1, 1, 4 + 2 * k1.slab_halo(2), 8, 8))
    with pytest.raises(ValueError, match="sweeps the split axis"):
        k1.flow_slab_fwd(buf, torch.zeros((1, 3, 4, 8, 8)), 1, 2, geo, shape)
    with pytest.raises(ValueError, match="source buffer"):
        k1.flow_slab_fwd(buf[:, :, 1:], torch.zeros((1, 3, 4, 8, 8)), 0, 2, geo, shape)
    with pytest.raises(ValueError, match="float32 field"):
        k1.flow_slab_bwd(buf, buf, torch.zeros((1, 3, 4, 8, 8)), 0, 2, geo, shape)
    with pytest.raises(ValueError, match="CUDA"):
        k1.flow_slab_fwd(buf, torch.zeros((1, 3, 4, 8, 8)), 0, 2, geo, shape)


@pytest.mark.parametrize("S,n,K,split,axis", [(24, 8, 3, 0, 0), (24, 4, 8, 0, 0),
                                              (16, 4, 2, 1, 1), (16, 4, 2, 0, 2)])
def test_torch_mesh_bwd2_slab_plain_equals_the_unsharded(S, n, K, split, axis):
    """``sweep_bwd2``'s slab mode, its plain version: gbar and sbar of each
    slab (from the halos of g, src and ubar) equal to the unsharded plain
    version to the bit; the slabs' row gradients, summed in ascending
    order, within 1e-6 of its largest entry (another order of sums)."""
    rng = np.random.default_rng(S * K)
    shape = (1, 1, S, S, S)
    src, g, u = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(3))
    coef = torch.tensor([0.02, -0.03, 0.01])
    coef[axis] = 0.97
    offset = torch.tensor(1.3)
    rbar = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    gbar, sbar, drow = k1.sweep_bwd2_plain(g, src, u, rbar, coef, offset, axis, K)
    m = S // n
    geos = [k1.SlabGeo(split, k * m, S) for k in range(n)]

    def bufs(x):
        return k1._halo_of(list(torch.split(x, m, 2 + split)), axis, K, geos)

    slab = list(torch.split(src, m, 2 + split))[0].shape
    outs = [k1.sweep_bwd2_slab_plain(gb, b, ub, rbar, coef, offset, axis, K, geo, slab)
            for gb, b, ub, geo in zip(bufs(g), bufs(src), bufs(u), geos)]
    assert _same(torch.cat([o[0] for o in outs], 2 + split), gbar)
    assert _same(torch.cat([o[1] for o in outs], 2 + split), sbar)
    total = M.ordered_sum([o[2] for o in outs], "cpu")
    np.testing.assert_allclose(total.numpy(), drow.numpy(), rtol=0,
                               atol=1e-6 * float(drow.abs().max()))


# ------------------------------------------------------------------ halos


@pytest.mark.parametrize("mode", halo.MODES)
def test_torch_mesh_flow_uneven_halo_fetch(mode):
    """``fetch_rows`` on an uneven partition with empty slabs: each buffer
    the volume's rows it asks for (rows past the volume by ``mode``), and
    its backward each owner row's sum of the buffer rows that read it, in
    ascending slab order, to the bit against that sum written out."""
    rng = np.random.default_rng(7)
    vol = torch.from_numpy(rng.standard_normal((1, 2, 10, 3)).astype(np.float32))
    parts = ((0, 3), (3, 3), (3, 7), (7, 8), (8, 10))
    wants = ((-2, 5), (0, 0), (2, 9), (6, 13), (7, 10))
    slabs = [vol[:, :, a:b].clone().requires_grad_(True) for a, b in parts]
    bufs = halo.fetch_rows(slabs, parts, 2, wants, mode)
    S = 10

    def src(r):
        if 0 <= r < S:
            return r
        if mode == "zeros":
            return None
        if mode == "edge":
            return min(max(r, 0), S - 1)
        return -r if r < 0 else 2 * (S - 1) - r

    for buf, (a, b) in zip(bufs, wants):
        assert buf.shape[2] == b - a
        for i, r in enumerate(range(a, b)):
            s = src(r)
            want = torch.zeros_like(vol[:, :, 0]) if s is None else vol[:, :, s]
            assert _same(buf[:, :, i].detach(), want)
    gs = [torch.from_numpy(rng.standard_normal(tuple(b.shape)).astype(np.float32))
          for b in bufs]
    grads = torch.autograd.grad(bufs, slabs, gs)
    want = torch.zeros_like(vol)
    for g, (a, b) in zip(gs, wants):  # ascending slabs, ascending rows
        for i, r in enumerate(range(a, b)):
            s = src(r)
            if s is not None:
                want[:, :, s] += g[:, :, i]
    assert _same(torch.cat(grads, 2), want)


# ------------------------------------------------------- the flow engine's ops


def test_torch_mesh_flow_diffusion_and_upsample_on_slabs():
    """The diffusion term on 8 slabs (the split axis's differences from a
    one-row buffer after each slab) within 1e-6 of the unsharded term, its
    gradient within 1e-6 of its largest entry; ``upsample_flow`` on slabs
    (linear at the volume's half-pixel coordinates along the split axis)
    within 1e-6 of the largest entry of the unsharded call, each split
    axis."""
    rng = np.random.default_rng(3)
    flow = torch.from_numpy(rng.standard_normal((1, 3, 16, 16, 16)).astype(np.float32))
    f0 = flow.clone().requires_grad_(True)
    ref = tflow._diffusion_energy(f0)
    (gref,) = torch.autograd.grad(ref.sum(), f0)
    fs = M.shard(flow, _space())
    for t in fs.shards:
        t.requires_grad_(True)
    got = tflow._diffusion_energy(fs)
    grads = torch.autograd.grad(got.sum(), fs.shards)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(torch.cat(grads, 2).numpy(), gref.numpy(), rtol=0,
                               atol=1e-6 * float(gref.abs().max()))
    for dim, n in ((0, 8), (1, 4), (2, 2)):
        want = upsample_flow(flow, (32, 32, 32))
        up = upsample_flow(M.shard(flow, _space(n, dim)), (32, 32, 32))
        assert isinstance(up, M.Sharded) and up.shape == want.shape
        np.testing.assert_allclose(M.gather(up).numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


# ------------------------------------------------------------ the engines

# the field mode at the recipe's fine flow level's options, cut to 24³ and 8
# steps (Adam at lr 0.3 normalizes each entry's step, so last-bit gradient
# differences move the field by up to ~1e-3 of its largest value here)
FIELD = dict(lr=0.3, optimizer="adam", criterions=["mse", "ncc"], weights=[0.5, 0.5],
             smooth=0.25, max_disp=4, max_epochs=8, stop_crit=1e-6)
FIELD_TOL = 1e-2  # of the field's largest value (tests/test_torch_mesh.py's cohort field)


@pytest.fixture(scope="module")
def field_case():
    mov, tgt = _blobs((24,) * 3, seed=31), _blobs((24,) * 3, seed=32)
    run, *_ = _build_flow_fn((j_mse, j_ncc), (0.5, 0.5), 0.3, 8, 1e-6, "adam", 3, 1, 1, 1,
                             max_disp=4, flow_model="field", smooth=0.25)
    p0 = jnp.zeros((1, 3, 24, 24, 24), jnp.float32)
    jflow, _, jlosses, jsteps, *_ = run(_jax_space(mov), _jax_space(tgt), p0)
    return mov, tgt, np.asarray(jflow), np.asarray(jlosses), int(jsteps)


def test_torch_mesh_flow_field_engine_on_slabs(field_case):
    """``flow_register(flow_model='field')`` on 8 z-slabs: the same steps as
    JAX's space-sharded run and the port's unsharded run, the field within
    ``FIELD_TOL`` of its largest value of each, the losses within 1e-4
    (relative) of JAX's and 1e-5 of the unsharded run's; the results come
    back split (``Sharded``), the field and Adam's state on each slab."""
    mov, tgt, jflow, jlosses, jsteps = field_case
    sh = _space()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        w0, r0 = tr.flow_register(torch.from_numpy(mov), torch.from_numpy(tgt),
                                  flow_model="field", **FIELD)
        w1, r1 = tr.flow_register(M.shard(torch.from_numpy(mov), sh),
                                  M.shard(torch.from_numpy(tgt), sh), flow_model="field",
                                  **FIELD)
    assert isinstance(r1.flow, M.Sharded) and isinstance(w1, M.Sharded)
    assert r1.steps == r0.steps == jsteps
    flow = M.gather(r1.flow).numpy()
    scale = float(np.abs(jflow).max())
    np.testing.assert_allclose(flow, jflow, rtol=0, atol=FIELD_TOL * scale)
    np.testing.assert_allclose(flow, r0.flow.numpy(), rtol=0, atol=FIELD_TOL * scale)
    np.testing.assert_allclose(r1.losses.numpy(), jlosses, rtol=1e-4)
    np.testing.assert_allclose(r1.losses.numpy(), r0.losses.numpy(), rtol=1e-5)
    np.testing.assert_allclose(M.gather(w1).numpy(), w0.numpy(), rtol=0,
                               atol=FIELD_TOL * float(w0.abs().max()))
    np.testing.assert_allclose(float(r1.max_disp), float(np.abs(flow).max()), rtol=0)


@pytest.fixture(scope="module")
def unet_case():
    """``tests/test_parallel.py:273``: U-Net depth 1, ``n=32``, 24³, 6 Adam
    steps at lr 1e-3, MSE; JAX's init and its space-sharded run."""
    mov, tgt = _blobs((24,) * 3, seed=31), _blobs((24,) * 3, seed=32)
    run, _, init_fn, *_ = _build_flow_fn((j_mse,), (1.0,), 1e-3, 6, 1e-6, "adam", 3, 1, 32.0,
                                         1)
    p0 = init_fn(jax.random.key(0), jnp.asarray(mov))
    jflow = np.asarray(run(_jax_space(mov), _jax_space(tgt), p0)[0])
    state = convert.unet_params(jax.tree.map(np.asarray, p0))
    return mov, tgt, jflow, state


def test_torch_mesh_flow_unet_engine_on_slabs(unet_case):
    """JAX's case on 8 z-slabs of 3 rows (the U-Net's layers on uneven and
    empty slabs, K3's plain version on each slab's buffer), the same 6
    steps: the flow within ``tests/test_parallel.py:295``'s tolerance
    (rtol 2e-3, atol 2e-4, JAX's sharded run against its unsharded one) of
    the port's unsharded run, and within the frameworks' U-Net tolerance of
    JAX's space-sharded run (1e-3 of the largest value,
    ``tests/test_torch_engines.py``'s and ``test_torch_cohort_unet_jax.py``'s:
    the port's unsharded run is itself up to 1.6e-4 of the largest value
    from JAX's here, Adam turning the frameworks' gradient rounding into
    steps, so 2e-4 absolute fails a few voxels before any slab is cut)."""
    mov, tgt, jflow, state = unet_case
    kw = dict(lr=1e-3, max_epochs=6, stop_crit=1e-6, n=32, depth=1, criterions=["mse"],
              optimizer="adam", flow_model="unet")
    sh = _space()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, r0 = tr.flow_register(torch.from_numpy(mov), torch.from_numpy(tgt),
                                 init_params=state, **kw)
        w1, r1 = tr.flow_register(M.shard(torch.from_numpy(mov), sh),
                                  M.shard(torch.from_numpy(tgt), sh), init_params=state, **kw)
    assert r1.steps == r0.steps == 6
    flow = M.gather(r1.flow).numpy()
    np.testing.assert_allclose(flow, r0.flow.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(flow, jflow, rtol=0, atol=1e-3 * float(np.abs(jflow).max()))
    assert isinstance(w1, M.Sharded)


def test_torch_mesh_flow_unet_cohort_on_slabs_refused():
    """The U-Net cohort (a net a pair) on slabs, refused until ROADMAP item
    19, runs: the net in pair mode on 2 slabs equals each pair's single net
    on the same slabs to the bit, forward and each weight's gradient; and
    ``flow_pairs`` on a batch of 2 pairs split into slabs equals each pair
    run alone on them to the bit."""
    from torchregister_tpu_torch.models.attention_unet import AttentionUNet, forward_slabs
    from torchregister_tpu_torch.parallel.rows import Rows

    net = AttentionUNet(3, 1, 32, 1, pairs=2)
    net.reset_parameters([torch.Generator().manual_seed(s) for s in (1, 2)])
    x = torch.from_numpy(np.random.default_rng(0).random((2, 1, 24, 24, 24), dtype=np.float32))
    parts = ((0, 12), (12, 24))
    out = forward_slabs(net, Rows(list(torch.split(x, 12, 2)), parts, 2)).blocks
    g = torch.autograd.grad(sum(o.square().sum() for o in out), list(net.parameters()))
    for b in range(2):
        one = AttentionUNet(3, 1, 32, 1)
        with torch.no_grad():
            for p, q in zip(one.parameters(), net.parameters()):
                p.copy_(q[b])
        ref = forward_slabs(one, Rows(list(torch.split(x[b:b + 1], 12, 2)), parts, 2)).blocks
        assert all(_same(o[b:b + 1], r) for o, r in zip(out, ref))
        g1 = torch.autograd.grad(sum(r.square().sum() for r in ref), list(one.parameters()))
        assert all(_same(a[b], c) for a, c in zip(g, g1))
    sh = _space(2)
    vol, tgt = M.shard(x, sh), M.shard(x.flip(3), sh)
    kw = dict(max_epochs=2, criterions=["mse"], n=32, depth=1, optimizer="adam")
    _, res = tflow.flow_pairs(vol, tgt, generator=[torch.Generator().manual_seed(s)
                                                   for s in (1, 2)], **kw)
    for b, (v1, t1) in enumerate(zip(vol.chunk(2), tgt.chunk(2))):
        _, r1 = tflow.flow_pairs(v1, t1, generator=torch.Generator().manual_seed(b + 1), **kw)
        assert _same(M.gather(r1.flow), M.gather(res.flow)[b:b + 1])


def test_torch_mesh_flow_lm_2d_on_slabs_matches_jax():
    """Rigid LM (``tests/test_torch_lm.py``'s 2-D case, 48², MSE, from the
    identity) on 8 row slabs against JAX's LM unsharded (JAX's 3-D LM
    engines take minutes to compile): the same iterations, the best
    parameters within 1e-4 (``test_torch_lm.py``'s tolerance), the first
    loss within 1e-5; and the affine LM (MSE + NCC) on 4 slabs split along x
    against the port unsharded (:func:`_same_run`)."""
    rng = np.random.default_rng(5)
    grids = np.meshgrid(*[np.linspace(-1, 1, 48, dtype=np.float32)] * 2, indexing="ij")
    mov = np.zeros((48, 48), np.float32)
    for _ in range(6):
        c, w = rng.uniform(-0.5, 0.5, 2), rng.uniform(0.15, 0.3)
        mov += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w**2)).astype(
            np.float32)
    mov = mov[None, None]
    tgt = np.asarray(j_warp_affine(j_rigid_theta(jnp.asarray([0.1, 0.08, -0.06]))[None],
                                   jnp.asarray(mov)))
    kw = dict(epochs=40, criterions=["mse"], grad_edges=False, optimizer="lm",
              init="identity", stop_rel=1e-3, patience=3)
    _, j = j_rigid(jnp.asarray(mov), jnp.asarray(tgt), **kw)
    sh = _space(8, 0, ndim=2)
    ms, ts = M.shard(torch.from_numpy(mov), sh), M.shard(torch.from_numpy(tgt), sh)
    warped, t = rigid_register(ms, ts, **kw)
    assert isinstance(warped, M.Sharded)
    assert t.steps == int(j.steps) < 40
    np.testing.assert_allclose(t.best_params.numpy(), np.asarray(j.best_params), atol=1e-4)
    np.testing.assert_allclose(t.losses.numpy()[0], np.asarray(j.losses)[0], rtol=1e-5)
    kw = dict(epochs=6, criterions=["mse", "ncc"], grad_edges=False, optimizer="lm",
              max_shift=4, check_window=False)
    _, a0 = affine_register(torch.from_numpy(mov), torch.from_numpy(tgt), **kw)
    sh = _space(4, 1, ndim=2)
    _, a1 = affine_register(M.shard(torch.from_numpy(mov), sh),
                            M.shard(torch.from_numpy(tgt), sh), **kw)
    _same_run(a1, a0)


def _same_run(got, want):
    """An LM run on slabs against the unsharded one: the same iterations,
    each iteration's parameters within 1e-6 and its loss within 1e-5 of the
    first loss: the criteria's slab sums and the row gradients summed over
    the slabs round apart (NCC's ``1 - ratio`` keeps that rounding absolute
    as the loss falls). The best pick is not compared: two iterations whose
    losses differ by less than that rounding may swap."""
    assert got.steps == want.steps
    np.testing.assert_allclose(got.param_history.numpy(), want.param_history.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.losses.numpy(), want.losses.numpy(), rtol=0,
                               atol=1e-5 * float(want.losses[0]))


def test_torch_mesh_flow_lm_3d_on_slabs_matches_unsharded():
    """Rigid and affine LM on 4 z-slabs of a 16³ pair (MSE + NCC, the edge
    filter on slabs for the rigid engine) against the unsharded runs
    (:func:`_same_run`)."""
    mov = _blobs((16,) * 3, seed=2)
    tgt = np.roll(mov, 1, axis=2)
    sh = _space(4)
    for engine, extra in ((rigid_register, dict(init="identity", grad_edges=True)),
                          (affine_register, dict(grad_edges=False))):
        kw = dict(epochs=4, criterions=["mse", "ncc"], optimizer="lm", max_shift=4,
                  check_window=False, **extra)
        _, r0 = engine(torch.from_numpy(mov), torch.from_numpy(tgt), **kw)
        _, r1 = engine(M.shard(torch.from_numpy(mov), sh), M.shard(torch.from_numpy(tgt), sh),
                       **kw)
        _same_run(r1, r0)


# ------------------------------------------- the step graphs, the counters


def test_torch_mesh_flow_launch_counts_under_threads():
    """Threads that count launches at once (``parallel/data.run_shards``
    over several devices) lose none: every counter changes through
    ``native.bump``, under one lock."""
    from concurrent.futures import ThreadPoolExecutor

    k1.reset_counts()
    halo.reset_counts()
    slabs = [torch.zeros((1, 1, 2, 2))] * 4

    def work(_):
        for _ in range(2000):
            k1._count(True, "slab_flow")
            k1._count(False, "slab_flow")
        for _ in range(50):
            halo.fetch(slabs, 2, 1, 1)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(work, range(8)))
    assert k1.fwd_launches == k1.fwd_modes["slab_flow"] == 16000
    assert k1.bwd_launches == k1.bwd_modes["slab_flow"] == 16000
    assert halo.calls == 400
    assert halo.copied_bytes == 400 * halo.bytes_of((1, 1, 2, 2), 2, 4, 1, 1, 4)
    k1.reset_counts()


def test_torch_mesh_flow_dropped_step_graphs_are_freed_without_gc():
    """A factory's step graphs refer to their owner weakly: dropping the
    owner frees it and its levels at once, with the cycle collector off."""
    was = gc.isenabled()
    gc.disable()
    try:
        graphs = graph.StepGraphs()
        level = graphs.level("flow/level0")
        owner, lvl = weakref.ref(graphs), weakref.ref(level)
        del graphs, level
        assert owner() is None and lvl() is None
        fn = CascadeFn({"mode": "rigid"})
        fn.graphs.level("rigid/level0")
        ref = weakref.ref(fn.graphs)
        del fn
        assert ref() is None
    finally:
        if was:
            gc.enable()
