"""The exact warps on a volume split into slabs (ROADMAP item 22), on the
CPU: K2's slab mode (its plain version here, ``ops/cuda/warp.py``) and the
user-facing exact warps on slabs (``ops/blocked.py``) against the unsharded
plain K2 to the bit; the differentiable exact warps (``ops/resample.py``) on
slabs against JAX's on its eight forced CPU devices (``tests/conftest.py``),
values and gradients; and ``method='exact'`` in the matrix and flow engines
on slabs against the port's unsharded runs.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchregister_tpu_torch as tr
from torchregister_tpu.ops.resample import warp_affine as j_warp_affine
from torchregister_tpu.ops.resample import warp_flow as j_warp_flow
from torchregister_tpu.ops.transforms import rigid_theta as j_rigid_theta
from torchregister_tpu.parallel import mesh as jmesh
from torchregister_tpu_torch.ops import blocked
from torchregister_tpu_torch.ops import resample
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.ops.transforms import rigid_theta
from torchregister_tpu_torch.parallel import halo
from torchregister_tpu_torch.parallel import mesh as M

PARAMS = [0.05, -0.04, 0.03, 0.1, -0.1, 0.05]


def _space(n, axis=0, ndim=3):
    return M.volume_sharding(M.make_mesh((n,), ("space",), devices=["cpu"] * n), axis,
                             ndim=ndim)


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _smooth_flow(spatial, amp, seed=0):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in spatial], indexing="ij")
    return np.stack([amp * np.sin(2.0 * g + rng.uniform(0, 3)) for g in grids])[None].astype(
        np.float32)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("spatial,axis,n", [((20, 24, 16), 0, 4), ((20, 24, 16), 1, 3),
                                            ((20, 24, 16), 2, 4), ((24, 20), 0, 3),
                                            ((24, 20), 1, 4)],
                         ids=["z", "y", "x", "2d-y", "2d-x"])
def test_torch_mesh_exact_k2_slabs_equal_unsharded(spatial, axis, n, C):
    """``warp_affine_fast`` and ``warp_flow_fast`` on slabs (K2's slab mode
    on the buffers ``ops/blocked.py`` fetches, plain here) equal the
    unsharded plain K2 to the bit, each item by its own theta and by one
    theta for the batch, the flow from its bound and from ``max_disp``; a
    zoom out reaches past the slabs' neighbours; the fetched bytes are
    counted. One slab's launch equals ``warp_plain`` on the volume's rows."""
    rng = np.random.default_rng(C + axis)
    d = len(spatial)
    src = torch.from_numpy(rng.random((2, C, *spatial), dtype=np.float32))
    p = [PARAMS, [0.0, 0.1, -0.1, 0.0, 0.2, -0.1]] if d == 3 else [[0.2, 0.1, -0.1],
                                                                  [-0.1, 0.0, 0.2]]
    theta = rigid_theta(torch.tensor(p))
    flow = torch.from_numpy(np.concatenate([_smooth_flow(spatial, 3.0, s) for s in (0, 1)]))
    sh = _space(n, axis, d)
    ss, fs = M.shard(src, sh), M.shard(flow, sh)
    halo.reset_counts()
    for th in (theta, theta[:1], 1.7 * theta[:1]):
        assert _same(M.gather(blocked.warp_affine_fast(th, ss)), blocked.warp_affine_fast(th, src))
    assert halo.copied_bytes > 0
    want = blocked.warp_flow_fast(src, flow)
    assert _same(M.gather(blocked.warp_flow_fast(ss, fs)), want)
    assert _same(M.gather(blocked.warp_flow_fast(ss, fs, max_disp=3.0)), want)
    m = spatial[axis] // n
    blk = tuple(m if a == axis else s for a, s in enumerate(spatial))
    origin = tuple(m if a == axis else 0 for a in range(d))
    mt = k2.pack_affine(*blocked.affine_to_index_map(theta[0], spatial))
    got = k2.warp_slab(src[0], blk, origin, (0,) * d, spatial, mt=mt)
    assert _same(got, k2.warp(src[0], mt=mt).narrow(1 + axis, m, m))


def test_torch_mesh_exact_flow_slabs_past_max_disp():
    """A field whose displacement along the split axis is far past the
    caller's ``max_disp`` still warps on slabs as unsharded, to the bit:
    the rows a slab fetches come from the field, not from the bound."""
    spatial = (24, 12, 10)
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.random((1, 2, *spatial), dtype=np.float32))
    flow = torch.from_numpy(_smooth_flow(spatial, 7.0, 2))
    assert float(flow[:, 0].abs().max()) > 5.0
    sh = _space(4)
    ss, fs = M.shard(src, sh), M.shard(flow, sh)
    want = blocked.warp_flow_fast(src, flow)
    assert _same(want, blocked.warp_flow_fast(src, flow, max_disp=1.0))
    assert _same(M.gather(blocked.warp_flow_fast(ss, fs, max_disp=1.0)), want)


def _jax_space(n=8):
    return jmesh.volume_sharding(jmesh.make_mesh((n,), ("space",)))


def test_torch_mesh_exact_resample_on_slabs_matches_jax():
    """``ops/resample.warp_affine`` and ``warp_flow`` on 8 z-slabs against
    JAX's on ``volume_sharding`` (``tests/test_parallel.py:82``'s 32³ case
    and a smooth field): the values equal the port's unsharded warps to the
    bit (each slab samples the fetched whole volume) and JAX's within 1e-5;
    the gradients of a weighted sum with respect to theta, the field and
    the source within 1e-4 of their largest entries of JAX's (the slabs' sums
    add in another order)."""
    rng = np.random.default_rng(3)
    S = 32
    vol = rng.random((1, 1, S, S, S), dtype=np.float32)
    wgt = rng.standard_normal((1, 1, S, S, S)).astype(np.float32)
    flow = _smooth_flow((S,) * 3, 2.5)
    jsh = _jax_space()

    def jloss_affine(p, v):
        return jnp.sum(j_warp_affine(j_rigid_theta(p)[None], v) * wgt)

    def jloss_flow(f, v):
        return jnp.sum(j_warp_flow(v, f) * wgt)

    jv = jax.device_put(jnp.asarray(vol), jsh)
    jf = jax.device_put(jnp.asarray(flow), jsh)
    jp = jnp.asarray(PARAMS, jnp.float32)
    j_aff = (j_warp_affine(j_rigid_theta(jp)[None], jv),
             *jax.grad(jloss_affine, argnums=(0, 1))(jp, jv))
    j_flow = (j_warp_flow(jv, jf), *jax.grad(jloss_flow, argnums=(0, 1))(jf, jv))
    sh = _space(8)
    for kind, want in (("affine", j_aff), ("flow", j_flow)):
        vs = M.shard(torch.from_numpy(vol), sh)
        for b in vs.shards:
            b.requires_grad_(True)
        if kind == "affine":
            arg = torch.tensor(PARAMS, requires_grad=True)
            out = resample.warp_affine(rigid_theta(arg)[None], vs)
            ref = resample.warp_affine(rigid_theta(arg.detach())[None], torch.from_numpy(vol))
        else:
            arg = M.shard(torch.from_numpy(flow), sh)
            for b in arg.shards:
                b.requires_grad_(True)
            out = resample.warp_flow(vs, arg)
            ref = resample.warp_flow(torch.from_numpy(vol), torch.from_numpy(flow))
        assert isinstance(out, M.Sharded) and _same(M.gather(out).detach(), ref)
        np.testing.assert_allclose(M.gather(out).detach().numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-5)
        total = sum(torch.sum(o * w) for o, w in zip(
            out.shards, torch.split(torch.from_numpy(wgt), S // 8, 2)))
        wrt = [arg] if kind == "affine" else list(arg.shards)
        grads = torch.autograd.grad(total, wrt + list(vs.shards))
        g_arg = grads[0] if kind == "affine" else torch.cat(grads[:8], 2)
        g_vol = torch.cat(grads[-8:], 2)
        for got, ref_g in ((g_arg, want[1]), (g_vol, want[2])):
            ref_g = np.asarray(ref_g)
            np.testing.assert_allclose(got.numpy(), ref_g, rtol=0,
                                       atol=1e-4 * float(np.abs(ref_g).max()))


def _pair(S=24):
    rng = np.random.default_rng(30)
    grids = np.meshgrid(*[np.linspace(-1, 1, S)] * 3, indexing="ij")
    vol = np.zeros((S,) * 3, np.float32)
    for _ in range(4):
        c, w = rng.uniform(-0.4, 0.4, 3), rng.uniform(0.15, 0.3)
        vol += np.exp(-sum((g - ci) ** 2 for g, ci in zip(grids, c)) / (2 * w ** 2))
    m = torch.from_numpy(vol)[None, None]
    t = resample.warp_affine(rigid_theta(torch.tensor(PARAMS))[None], m)
    return m, t


@pytest.mark.parametrize("engine", ["rigid", "flow"])
def test_torch_mesh_exact_engines_on_slabs(engine):
    """``method='exact'`` on 4 z-slabs against the port's unsharded run:
    ``rigid_register`` (MSE, Adam, 15 steps) with the same steps, best theta
    within ``tests/test_torch_mesh.py``'s rigid tolerance (rtol 1e-4, atol
    1e-5) and the losses within rtol 1e-4, its ``warped_best`` (K2 on slabs)
    the unsharded K2's at the same theta to the bit;
    ``flow_register(flow_model='field')`` (SGD at lr 10, MSE, the diffusion
    term, 6 steps: linear in the slab sums' rounding) with the field within
    1e-5 of its largest value and the warp (the exact ``warp_flow`` on
    slabs) within 1e-5."""
    m, t = _pair()
    sh = _space(4)
    ms, ts = M.shard(m, sh), M.shard(t, sh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if engine == "rigid":
            kw = dict(lr=3e-3, epochs=15, criterions=["mse"], optimizer="adam",
                      init="identity", grad_edges=False, method="exact")
            w0, r0 = tr.rigid_register(m, t, **kw)
            w1, r1 = tr.rigid_register(ms, ts, **kw)
            assert r1.steps == r0.steps and isinstance(w1, M.Sharded)
            np.testing.assert_allclose(r1.best_theta.numpy(), r0.best_theta.numpy(), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(r1.losses.numpy(), r0.losses.numpy(), rtol=1e-4)
            assert _same(M.gather(w1), blocked.warp_affine_fast(r1.best_theta, m))
            return
        kw = dict(flow_model="field", lr=10.0, optimizer="sgd", criterions=["mse"], smooth=0.25,
                  max_epochs=6, method="exact")
        w0, r0 = tr.flow_register(m, t, **kw)
        w1, r1 = tr.flow_register(ms, ts, **kw)
    assert r1.steps == r0.steps and isinstance(w1, M.Sharded)
    np.testing.assert_allclose(M.gather(r1.flow).numpy(), r0.flow.numpy(), rtol=0,
                               atol=1e-5 * float(r0.flow.abs().max()))
    np.testing.assert_allclose(M.gather(w1).numpy(), w0.numpy(), rtol=0, atol=1e-5)


def test_torch_mesh_exact_degenerate_theta_on_slabs():
    """A theta whose per-axis factorization is degenerate (a 90° rotation)
    sends ``warp_affine_separable`` to the exact resampler, on slabs too
    (with the same warning): the warp equals the unsharded one to the bit."""
    from torchregister_tpu_torch.ops.separable import warp_affine_separable

    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.random((1, 1, 16, 16, 16), dtype=np.float32))
    theta = rigid_theta(torch.tensor([np.pi / 2, 0.0, 0.0, 0.0, 0.0, 0.0]))[None]
    with pytest.warns(RuntimeWarning, match="degenerate"):
        got = warp_affine_separable(theta, M.shard(vol, _space(4)))
    with pytest.warns(RuntimeWarning, match="degenerate"):
        want = warp_affine_separable(theta, vol)
    assert isinstance(got, M.Sharded) and _same(M.gather(got), want)
