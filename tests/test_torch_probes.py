"""The benchmark probes' port (``torchregister_tpu_torch/probes/``) against
the JAX probes on the CPU.

P1, P2 and P5 run the JAX probe functions themselves
(``benchmarks/probe_hatgather.py``, loaded as a file) with ``pallas_call`` in
interpret mode; each call's inputs go through the port's plain version,
which must give the same values to the bit (P5: lanes ``:224``, the ones the
Pallas kernel writes). P4's ``BoundedSlice`` is refused by interpret mode on
the CPU (``ValueError: Unsupported block dim type: BoundedSlice``), and P3 is
the 240³ bench fetch, so both are held against the probes' own XLA oracles
(``dynamic_slice`` stacks) on the probes' inputs, P3 on a reduced volume.
The ROI fetch is held against its definition written in ``jnp`` on the
scalars of the JAX package's ``_roi_supports``.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torchregister_tpu.ops import blocked as jblocked
from torchregister_tpu.ops.transforms import rigid_theta as jrigid_theta
from torchregister_tpu_torch.ops import blocked as tblocked
from torchregister_tpu_torch.probes import checked_index
from torchregister_tpu_torch.probes import hatgather as hg
from torchregister_tpu_torch.probes import roi_stages as rs

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "probe_hatgather", ROOT / "benchmarks" / "probe_hatgather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(monkeypatch, fn):
    """Run the JAX probe ``fn`` with ``pallas_call`` in interpret mode;
    return each call's (inputs, output) as numpy."""
    calls, original = [], pl.pallas_call

    def interpreted(kernel, **kw):
        call = original(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            calls.append(([np.array(a) for a in args], np.array(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    fn()
    assert len(calls) == 1
    return calls[0]


def test_torch_probe_p1_matches_pallas_interpret(probe, monkeypatch):
    (order, x), want = _recorded(monkeypatch, probe.p1_scalar_block_index)
    got = hg.block_permute_add(torch.from_numpy(x), order)
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_probe_p2_matches_pallas_interpret(probe, monkeypatch):
    (orgs, vol), want = _recorded(monkeypatch, probe.p2_element_zy)
    got = hg.slab_gather(torch.from_numpy(vol), orgs, 14, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_probe_p5_matches_pallas_interpret(probe, monkeypatch):
    (starts, slab), want = _recorded(monkeypatch, probe.p5_inkernel_slice_restack)
    got = hg.slice_transpose(torch.from_numpy(slab), starts, 14, 16, 16, 256).numpy()
    # lanes 224-255 are uninitialized scratch in the Pallas kernel; zeros here
    np.testing.assert_array_equal(got[:, :, :224], want[:, :, :224])
    assert not got[:, :, 224:].any()


def _jax_slabs(vol, orgs, Bz, By):
    return jnp.stack([jax.lax.dynamic_slice(vol, (int(z), int(y), 0), (Bz, By, vol.shape[2]))
                      for z, y in orgs])


def test_torch_probe_p4_matches_xla_oracle():
    """P4's inputs and its oracle ``want``: the (16, 16, 256) dynamic slices."""
    Z = Y = 64
    vol = jax.random.uniform(jax.random.key(0), (Z, Y, 256), jnp.float32)
    orgs = np.asarray([[3, 5], [11, 0], [0, 23], [9, 9], [Z - 16, Y - 16]], np.int32)
    got = hg.slab_gather(torch.from_numpy(np.array(vol)), orgs, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_slabs(vol, orgs, 16, 16)))


def test_torch_probe_p3_matches_xla_oracle():
    """P3 at 40 x 40 x 256 with 64 origins from ``default_rng(0)``: each
    (14, 16) slab summed over z and y on 8 rows, against the probe's oracle
    ``dynamic_slice(...).sum(axis=(0, 1))``; atol 1e-4 (two f32 sums of 224
    terms in [0, 1) in different orders, ~112 each)."""
    size, T = 40, 64
    vol = jax.random.uniform(jax.random.key(0), (size, size, 256), jnp.float32)
    orgs = hg.p3_origins(size, T)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(orgs[:, 0], rng.integers(0, size - 14, T))
    want = np.broadcast_to(np.asarray(_jax_slabs(vol, orgs, 14, 16).sum(axis=(1, 2)))[:, None],
                           (T, 8, 256))
    got = hg.slab_sum(torch.from_numpy(np.array(vol)), orgs, 14, 16)
    assert got.shape == (T, 8, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=hg.P3_ATOL)


def _jax_fetch(volp, zq, yq):
    """The Pallas ``fetch_kernel``'s definition: per tile, the nine (8, 8, Xp)
    blocks at block origins (zq + i, yq + j), each ``reshape(-1, 128).sum(0)``,
    added."""
    Xp = volp.shape[2]

    def one(z, y):
        acc = jnp.zeros((1, 128), jnp.float32)
        for i in range(3):
            for j in range(3):
                blk = jax.lax.dynamic_slice(volp, (8 * (z + i), 8 * (y + j), 0), (8, 8, Xp))
                acc = acc + jnp.sum(blk.reshape(-1, 128), axis=0, keepdims=True)
        return acc

    return jax.jit(jax.vmap(one))(jnp.asarray(zq), jnp.asarray(yq))


def test_torch_probe_roi_fetch_matches_jax():
    """The fetch on a 48³ volume (padded to 64 x 64 x 128 as the JAX probe
    pads) at the scalars of the JAX package's ``_roi_supports`` for the
    probe's theta, which the port's ``_roi_supports`` reproduces; atol
    ``FETCH_ATOL`` (f32 sums of 576 terms in [0, 1) in different orders)."""
    size = 48
    theta = np.asarray(jrigid_theta(jnp.asarray(rs.THETA, jnp.float32)), np.float64)
    jscal = jblocked._roi_supports(theta, (size,) * 3, False)[0]
    tscal = tblocked._roi_supports(theta, (size,) * 3, False)[0]
    assert tscal.dtype == np.int32 and np.array_equal(tscal, jscal)
    vol, _, scal, volp = rs.stage_inputs(size, torch.device("cpu"))
    assert volp.shape == (64, 64, 128) and torch.equal(volp[:size, :size, :size], vol)
    got = rs.roi_fetch(volp, jscal)
    want = np.asarray(_jax_fetch(jnp.asarray(volp.numpy()), jscal[:, 0], jscal[:, 1]))
    assert got.shape == want.shape == (jscal.shape[0], 1, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rs.FETCH_ATOL)


def test_torch_probe_functions_run_on_cpu(capsys):
    """Every probe function end to end on the CPU at a small size (the plain
    versions): the JAX probes' lines, every check OK."""
    for fn in (hg.p1_scalar_block_index, hg.p2_element_zy, hg.p4_bounded_slice,
               hg.p5_inkernel_slice_restack):
        assert fn(device="cpu") == 0.0
    assert hg.p3_fetch_throughput(device="cpu", size=40, iters=1) > 0
    times = rs.stages(device="cpu", size=48, iters=1)
    assert set(times) == {"restack (compact kernel)", "fused warp kernel",
                          "fetch only (9-block reads)"}
    out = capsys.readouterr().out
    assert out.count("OK") == 6 and "CPU, host clock" in out


def test_torch_probe_functions_need_the_card():
    """Without a device argument the probe functions run on the card, and raise
    where there is none; never on the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (hg.p1_scalar_block_index, hg.p2_element_zy, hg.p3_fetch_throughput,
               hg.p4_bounded_slice, hg.p5_inkernel_slice_restack, rs.stages, rs.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hg.main(["p1"])
    with pytest.raises(SystemExit, match="unknown probes"):
        hg.main(["p9"])


def test_torch_probe_index_checks():
    """Index data is host data, checked before any read: one origin out of
    range raises, the last valid one passes."""
    vol = torch.zeros((64, 64, 256))
    assert hg.slab_gather(vol, [[50, 48]], 14, 16).shape == (1, 14, 16, 256)
    for bad in ([[51, 0]], [[0, 49]], [[-1, 0]]):
        with pytest.raises(ValueError, match="leaves"):
            hg.slab_gather(vol, bad, 14, 16)
    with pytest.raises(ValueError, match="leaves"):
        hg.block_permute_add(torch.zeros((16, 256)), [0, 2])
    with pytest.raises(ValueError, match="leaves"):
        hg.slice_transpose(vol[:32, :32], [[19, 0, 0]])
    with pytest.raises(ValueError, match="leaves"):
        rs.roi_fetch(torch.zeros((64, 64, 128)), [[5, 6, 0, 0, 0]])
    with pytest.raises(TypeError):
        checked_index(np.zeros((2, 2), np.float32), (0,), (1,), "x", torch.device("cpu"))
    with pytest.raises(TypeError, match="multiple of 128"):
        rs.roi_fetch(torch.zeros((64, 64, 100)), [[0, 0, 0, 0, 0]])


@pytest.mark.parametrize("X", [256, 250])
def test_torch_probe_slab_gather_plain_matches_dynamic_slices(X):
    """``slab_gather``'s plain version against ``dynamic_slice`` stacks at
    origins from ``default_rng(3)`` with the last valid one appended, for an
    x extent that is a multiple of 4 and one that is not (the kernel's two
    branches)."""
    Z, Y = 40, 36
    vol = jax.random.uniform(jax.random.key(1), (Z, Y, X), jnp.float32)
    rng = np.random.default_rng(3)
    orgs = np.concatenate([np.stack([rng.integers(0, Z - 14 + 1, 9),
                                     rng.integers(0, Y - 16 + 1, 9)], axis=-1),
                           [[Z - 14, Y - 16]]]).astype(np.int32)
    got = hg.slab_gather(torch.from_numpy(np.array(vol)), orgs, 14, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_slabs(vol, orgs, 14, 16)))


def _jax_slice_transpose(slab, starts, Bz, By, CW, lanes):
    """P5's function: each (Bz, By, CW) window as Bz*By rows, transposed to
    ``[CW, Bz*By]``, zeros up to ``lanes``."""
    outs = []
    for dz, dy, ox in starts:
        win = jax.lax.dynamic_slice(slab, (int(dz), int(dy), int(ox)), (Bz, By, CW))
        outs.append(jnp.pad(win.reshape(Bz * By, CW).T, ((0, 0), (0, lanes - Bz * By))))
    return jnp.stack(outs)


@pytest.mark.parametrize("X, lanes", [(256, 256), (250, 256), (256, 230)])
def test_torch_probe_slice_transpose_plain_matches_dynamic_slices(X, lanes):
    """``slice_transpose``'s plain version against ``dynamic_slice``: x starts
    at 0, 1, 2 and 3 mod 4 (the kernel's window reads are element-granular),
    an x extent that is not a multiple of 4, and ``lanes`` that is not (the
    kernel's scalar stores)."""
    SZ, SY, Bz, By, CW = 32, 32, 14, 16, 16
    slab = jax.random.uniform(jax.random.key(2), (SZ, SY, X), jnp.float32)
    starts = np.asarray([[0, 0, 0], [3, 5, 1], [9, 13, 6], [18, 16, 11], [7, 2, X - CW]],
                        np.int32)
    assert sorted(starts[:4, 2] % 4) == [0, 1, 2, 3]
    got = hg.slice_transpose(torch.from_numpy(np.array(slab)), starts, Bz, By, CW, lanes)
    want = _jax_slice_transpose(slab, starts, Bz, By, CW, lanes)
    assert got.shape == (5, CW, lanes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------ the two-stage sums' order of adds


def _fetch_parent_loop(volp, scal):
    """The one-pass fetch kernel's per-lane loop (before the two stages), in
    torch ops over every tile and lane at once: for each of the nine blocks
    in the order (i, j), its z planes, each plane's y rows and each row's
    folds, each add an f32 add."""
    T, Xp = scal.shape[0], volp.shape[2]
    zq, yq = scal[:, 0].long(), scal[:, 1].long()
    acc = torch.zeros((T, 128))
    for i in range(3):
        for j in range(3):
            blk = torch.zeros((T, 128))
            for z in range(8):
                plane = torch.zeros((T, 128))
                for y in range(8):
                    row = volp[8 * (zq + i) + z, 8 * (yq + j) + y]
                    for h in range(Xp // 128):
                        plane = plane + row[:, 128 * h:128 * (h + 1)]
                blk = blk + plane
            acc = acc + blk
    return acc[:, None, :]


@pytest.mark.parametrize("Xp", [128, 256, 384])
def test_torch_probe_fetch_two_stages_keep_the_one_pass_order(Xp):
    """``roi_fetch_ordered`` (block sums, then each tile's nine) equals the
    one-pass kernel's per-lane loop to the bit, at one, two and three folds
    a lane, on a volume whose z and y extents are not whole blocks, with
    tiles at block origin (0, 0), at the last valid one and in between; and
    it stays within ``FETCH_ATOL`` of the plain version."""
    gen = torch.Generator().manual_seed(Xp)
    volp = torch.rand((61, 54, Xp), generator=gen)
    rng = np.random.default_rng(Xp)
    scal = np.zeros((23, 5), np.int32)
    scal[:, 0] = rng.integers(0, 61 // 8 - 3 + 1, 23)
    scal[:, 1] = rng.integers(0, 54 // 8 - 3 + 1, 23)
    scal[0, :2], scal[-1, :2] = (0, 0), (61 // 8 - 3, 54 // 8 - 3)
    scal = rs.check_scalars(volp, scal)
    got = rs.roi_fetch_ordered(volp, scal)
    assert torch.equal(got, _fetch_parent_loop(volp, scal))
    torch.testing.assert_close(got, rs.roi_fetch_plain(volp, scal), rtol=0,
                               atol=rs.FETCH_ATOL)


def test_torch_probe_fetch_two_stages_at_the_probes_scalars():
    """The same to the bit on the probe's own scalars at 48³ (the JAX
    package's ``_roi_supports`` of its rigid theta)."""
    _, _, scal, volp = rs.stage_inputs(48, torch.device("cpu"))
    scal = rs.check_scalars(volp, scal)
    assert torch.equal(rs.roi_fetch_ordered(volp, scal), _fetch_parent_loop(volp, scal))


def _slab_sum_parent_loop(vol, orgs, Bz, By, rows=8):
    """The one-pass ``slab_sum`` kernel's per-lane loop, in torch ops over
    every slab and lane at once: each z plane's By rows in ascending y, the
    planes in ascending z."""
    oz, oy = orgs[:, 0].long(), orgs[:, 1].long()
    acc = torch.zeros((orgs.shape[0], vol.shape[2]))
    for z in range(Bz):
        plane = torch.zeros_like(acc)
        for y in range(By):
            plane = plane + vol[oz + z, oy + y]
        acc = acc + plane
    return acc[:, None, :].expand(-1, rows, -1)


@pytest.mark.parametrize("X, Bz, By", [(256, 14, 16), (100, 14, 16), (36, 3, 5)])
def test_torch_probe_slab_sum_two_stages_keep_the_one_pass_order(X, Bz, By):
    """``slab_sum_ordered`` (``W`` at every (z, oy), then each slab's Bz rows
    of it) equals the one-pass kernel's per-lane loop to the bit, with slabs
    at (0, 0), on the last valid plane and row, and at ``default_rng``
    origins; and it stays within ``P3_ATOL`` of the plain version."""
    Z, Y = 30, 41
    gen = torch.Generator().manual_seed(X + By)
    vol = torch.rand((Z, Y, X), generator=gen)
    orgs = np.concatenate([hg.p3_origins(Z, 29, Bz, By) % [Z - Bz + 1, Y - By + 1],
                           [[0, 0], [Z - Bz, Y - By], [Z - Bz, 0]]]).astype(np.int32)
    orgs = checked_index(orgs, (0, 1), (Z - Bz, Y - By), "orgs", torch.device("cpu"))
    got = hg.slab_sum_ordered(vol, orgs, Bz, By)
    assert got.shape == (32, 8, X)
    assert torch.equal(got, _slab_sum_parent_loop(vol, orgs, Bz, By))
    torch.testing.assert_close(got, hg.slab_sum_plain(vol, orgs, Bz, By), rtol=0,
                               atol=hg.P3_ATOL)
