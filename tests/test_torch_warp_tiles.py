"""K2's tiles, boxes and routes on the CPU, through ``tile_boxes``, the plain
mirror of the kernel's box rule (``ops/cuda/warp.py``).

The kernel stages a tile's source box in shared memory and gathers every
corner of its voxels from there without a range test, so the box must hold
every corner of every voxel whose coordinate is a number, and lie where
``f + 1`` is exact. These tests hold the mirror to that, over seeded affine
maps, fields, 2-D images, ragged sizes, NaN and far-out coordinates, with
``warp_plain``'s own coordinates. Inputs are numpy draws from a seed.
"""
import re

import numpy as np
import pytest
import torch

from torchregister_tpu_torch import profile_warp as pw
from torchregister_tpu_torch import warp_cases as wc
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.ops.transforms import rigid_theta


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _rigid(params, spatial):
    return wc.index_map(rigid_theta(torch.tensor(params))[None], spatial)


def _affine(seed, spatial, spread):
    rng = np.random.default_rng(seed)
    M = np.eye(3) + spread * rng.normal(size=(3, 3))
    t = 3.0 * rng.normal(size=3)
    return k2.pack_affine(_t(M), _t(t))


def _flow(seed, spatial, scale, smooth):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(3,) + spatial)
    if smooth:  # a running mean along each axis: a field that bends, not tears
        for a in (1, 2, 3):
            f = sum(np.roll(f, k, axis=a) for k in range(-3, 4)) / 7.0
    return _t(scale * f)


def _far(spatial):
    """A small field with a NaN, +-1e30 and 3e7 (finite, past 2^13)."""
    f = _flow(7, spatial, 0.4, False)
    for (s, z, y, x), v in FAR_VOXELS.items():
        f[s, z, y, x] = v
    return f


# (channel, z, y, x) of the field in _far: a NaN in the flow mode's 8 x 8 x
# 32 tile (0, 0, 0), and three coordinates past 2^13 in tiles (4, 0, 0),
# (0, 4, 0), (2, 2, 0)
FAR_VOXELS = {(0, 1, 2, 3): float("nan"), (1, 33, 0, 5): 1e30, (2, 4, 33, 18): -1e30,
              (2, 20, 20, 9): 3e7}


CASES = {
    "affine_rigid_48": ((1, 48, 48, 48), lambda s: dict(mt=_rigid(wc.SELFTEST_THETA, s[1:]))),
    "affine_seed1_ragged": ((1, 33, 29, 40), lambda s: dict(mt=_affine(1, s[1:], 0.2))),
    "affine_seed2_shear": ((1, 40, 21, 35), lambda s: dict(mt=_affine(2, s[1:], 0.6))),
    "affine_nan_map": ((1, 20, 20, 20), lambda s: dict(
        mt=torch.tensor([1.0, 0, 0, float("nan")] + [0, 1.0, 0, 0] + [0, 0, 1.0, 2.0]))),
    # a shift far down z and 3.6 along x (a box 3 floats past a 16-byte
    # boundary): just inside +-2^13, staged; near -2^14, direct
    "affine_far_staged": ((1, 48, 40, 48), lambda s: dict(
        mt=k2.pack_affine(torch.eye(3), torch.tensor([-8150.3, 0.7, 3.6])))),
    "affine_far_direct": ((1, 48, 40, 48), lambda s: dict(
        mt=k2.pack_affine(torch.eye(3), torch.tensor([-16380.3, 0.7, 3.6])))),
    "flow_smooth_ragged": ((1, 50, 47, 44), lambda s: dict(flow=_flow(3, s[1:], 4.0, True))),
    "flow_rough": ((1, 24, 40, 36), lambda s: dict(flow=_flow(4, s[1:], 9.0, False))),
    "flow_nan_far": ((1, 34, 35, 19), lambda s: dict(flow=_far(s[1:]))),
    "image_2d_affine": ((2, 1, 45, 70), lambda s: dict(mt=_rigid((0.3, 0.1, -0.2), s[2:]))),
    "image_2d_flow": ((1, 1, 70, 41), lambda s: dict(flow=torch.cat(
        [torch.zeros((1, 1, 70, 41)), _flow(5, (1, 70, 41), 3.0, True)[1:]]))),
}


def _tiles_of(boxes, spatial):
    """Each voxel's tile index ``[Z, Y, X]`` per axis."""
    return [torch.arange(n).div(t, rounding_mode="floor").view(
        [n if a == b else 1 for b in range(3)]).expand(spatial)
        for a, (n, t) in enumerate(zip(spatial, boxes["tile"]))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_warp_tile_boxes_hold_every_corner(case):
    """Every in-range corner that ``warp_plain`` reads lies in its tile's
    box; in a staged tile every corner of every voxel whose coordinate is a
    number does (the kernel reads them unguarded from shared memory), the
    box lies within +-2^13 and fits the shared memory's box."""
    shape, aux = CASES[case]
    kw = aux(shape)
    spatial = shape[1:]
    boxes = k2.tile_boxes(shape, **kw)
    q = k2._coords(spatial, torch.device("cpu"), kw.get("mt"), kw.get("flow"))
    tz, ty, tx = _tiles_of(boxes, spatial)
    lo, hi, staged = (boxes[k][tz, ty, tx] for k in ("lo", "hi", "staged"))
    assert staged.shape == spatial
    for s in range(3):
        f = torch.floor(q[s])
        for corner in (f, f + 1.0):
            inside = (corner >= 0) & (corner <= spatial[s] - 1)
            assert bool(((lo[..., s] <= corner) & (corner <= hi[..., s]))[inside].all()), s
        number = ~torch.isnan(f) & staged
        assert bool((lo[..., s] <= f)[number].all() and (f + 1.0 <= hi[..., s])[number].all())
    st = boxes["staged"]
    ext = (boxes["hi"] - boxes["lo"] + 1.0)[st]
    assert bool((boxes["lo"][st] >= -k2.FAR).all() and (boxes["hi"][st] <= k2.FAR).all())
    bz, by, bx = k2.BOX
    assert bool((ext[:, 0] <= bz).all() and (ext[:, 1] <= by).all() and
                (ext[:, 2] + 3 <= bx).all())
    assert k2._tiles(spatial, "flow" in kw) == st.numel()


def test_torch_warp_tile_boxes_routes():
    """The selftest's rigid map stages every 16³ tile (boxes of 21³ at
    most); make_pair's does too, and so does a shift just inside -2^13; a
    90° rotation with a zoom by 2 (boxes of 32³), a NaN map and a shift past
    2^13 take the direct route everywhere, and so do every field and every
    2-D image; a field's boxes still hold its corners, a NaN skipped and a
    far coordinate's tile unbounded."""
    cube = (1, 48, 48, 48)
    sel = k2.tile_boxes(cube, mt=_rigid(wc.SELFTEST_THETA, cube[1:]))
    assert sel["tile"] == (16, 16, 16) and bool(sel["staged"].all())
    assert float((sel["hi"] - sel["lo"] + 1).max()) == 21.0
    assert bool(k2.tile_boxes(cube, mt=_rigid(wc.PAIR_RIGID, cube[1:]))["staged"].all())
    for mt in (wc.index_map(wc.rot90_zoom2(), cube[1:]), CASES["affine_nan_map"][1](0)["mt"],
               k2.pack_affine(torch.eye(3), torch.tensor([2e4, 0.0, 0.0]))):
        assert not bool(k2.tile_boxes(cube, mt=mt)["staged"].any())
    for case, route in (("affine_far_staged", True), ("affine_far_direct", False)):
        shape, aux = CASES[case]
        boxes = k2.tile_boxes(shape, **aux(shape))
        assert bool(boxes["staged"].all()) if route else not bool(boxes["staged"].any()), case
        assert float(boxes["lo"][..., 2].min()) == 3.0  # a box x starting at 3 mod 4
    img = k2.tile_boxes((1, 1, 70, 70), mt=_rigid((0.3, 0.1, -0.2), (70, 70)))
    assert img["tile"] == (1, 8, 32) and not bool(img["staged"].any())
    shape = CASES["flow_nan_far"][0]
    far = k2.tile_boxes(shape, flow=_far(shape[1:]))
    assert not bool(far["staged"].any())
    wide = {tuple(int(i) for i in tile)
            for tile in torch.nonzero(((far["hi"] - far["lo"]).abs() > 1e6).any(-1))}
    assert far["tile"] == (8, 8, 32) and wide == {(4, 0, 0), (0, 4, 0), (2, 2, 0)}
    assert bool(torch.isfinite(far["lo"][0, 0, 0]).all())  # the NaN's tile (1, 2, 3)


@pytest.mark.parametrize("case", [c for c in sorted(CASES) if "affine" in c])
def test_torch_warp_affine_box_from_the_tile_corners(case):
    """The affine mode takes a tile's box from its 8 corners: each
    coordinate is a chain of round-to-nearest products and sums, monotone in
    z, y and x, so its floor's least and greatest values over a (ragged)
    tile sit at the corners. Equal to ``tile_boxes``'s box over every voxel,
    with ``warp_plain``'s rounding."""
    shape, aux = CASES[case]
    mt = aux(shape)["mt"]
    spatial = shape[1:]
    boxes = k2.tile_boxes(shape, mt=mt)
    f = torch.stack([torch.floor(qs) for qs in k2._coords(spatial, mt.device, mt, None)], -1)
    for tile in np.ndindex(*boxes["staged"].shape):
        ends = [(t * n, min((t + 1) * n, size) - 1)
                for t, n, size in zip(tile, boxes["tile"], spatial)]
        corners = torch.stack([f[z, y, x] for z in ends[0] for y in ends[1] for x in ends[2]])
        if bool(torch.isnan(corners).any()):
            assert not bool(boxes["staged"][tile])
            continue
        assert torch.equal(corners.amin(0), boxes["lo"][tile])
        assert torch.equal(corners.amax(0) + 1.0, boxes["hi"][tile])


def test_torch_warp_tile_boxes_match_the_kernel_source():
    """``csrc/warp.cu`` exports both modes with the staged counter, and
    each of the A/B's ablations changes lines the source holds once."""
    source = k2.SOURCE.read_text()
    for name in ("warp_affine", "warp_flow"):
        assert re.search(r'extern "C" int ' + name + r'\([^)]*void\* staged, void\* stream\)',
                         source)
    for name, lines in pw.ABLATIONS.items():
        text = pw.variant(name, source)
        assert text != source and all(new in text for new in lines.values()), name
    with pytest.raises(ValueError, match="part1"):
        pw.variant("part1", source.replace("kStageAffine = true;", ""))


def test_torch_warp_cpu_leaves_the_counters():
    """On a CPU tensor ``warp`` runs the plain version and counts nothing."""
    k2.reset_counts()
    src = _t(np.random.default_rng(0).normal(size=(1, 9, 8, 7)))
    out = k2.warp(src, mt=_rigid(wc.SELFTEST_THETA, (9, 8, 7)))
    assert out.shape == src.shape
    assert (k2.affine_launches, k2.flow_launches, k2.tiles_launched, k2.staged_blocks()) == \
        (0, 0, 0, 0)


def test_torch_profile_warp_reads_the_warp_resources():
    """The K2 A/B keeps the warp kernels' registers and spill from ptxas's
    report; the parent's interface (no counter) binds 8 arguments."""
    from torchregister_tpu_torch import device_ab as ab

    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111warp_kernelILb0EiLi16E"
        "Li16ELi16EEEvPKfPfS3_S3_iiiibPi' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_18other_fnEv' for 'sm_90a'\n"
        "ptxas info    : Used 8 registers\n")
    got = ab.resources(report, ("warp",))
    assert list(got.values()) == ["40 registers, 0 bytes spill"]
    assert len(pw.entries(False)["warp_affine"][1]) == 8
    assert pw.entries(True) is k2.LIB.entries
    assert pw.takes_counter(k2.SOURCE)


def test_torch_profile_warp_cases_take_their_routes():
    """The K2 A/B's cases, at 48³ on the CPU: the rigid maps stage every
    tile, the 90° zoom, the fields and the 2-D image stage none; the bound
    counts the source, the field and the output once."""
    want = {"affine_selftest": True, "affine_pair": True, "affine_c3": True,
            "affine_rot90_zoom2": False, "flow_smooth": False, "flow_past_faces": False,
            "affine_2d": False}
    cases = pw.cases(torch.device("cpu"), S=48)
    assert set(cases) == set(want)
    for case, (mode, src, aux) in cases.items():
        staged = k2.tile_boxes(src.shape, **{"mt" if mode == "affine" else "flow": aux})["staged"]
        assert bool(staged.all()) if want[case] else not bool(staged.any()), case
    mode, src, _ = cases["flow_smooth"]
    assert pw.bound_ms(mode, src) == 1e3 * 4.0 * 5 * 48**3 / pw.HBM_BYTES_PER_S


def test_torch_warp_sample_plain_on_the_last_planes():
    """A check of a few output planes (``chip_smoke.py``'s field of 3 * 1100³
    elements) samples them with ``sample_plain`` at their own coordinates:
    the same bits as ``warp_plain``'s planes."""
    rng = np.random.default_rng(12)
    src = _t(rng.random((2, 14, 11, 9)))
    flow = _t(3.0 * rng.normal(size=(3, 14, 11, 9)))
    z0, S = 10, src.shape[1:]
    p = [torch.arange(a, n, dtype=torch.float32) for a, n in zip((z0, 0, 0), S)]
    p = [v.view([-1 if a == b else 1 for b in range(3)]) for a, v in enumerate(p)]
    got = k2.sample_plain(src, [p[s] + flow[s, z0:] for s in range(3)])
    assert torch.equal(got, k2.warp_plain(src, flow=flow)[:, z0:])
