"""Peaks of one NVIDIA H100 SXM and the least work of the cascade's kernels.

A kernel's least time is the larger of the bytes its algorithm must move
(each input read once, each output written once) over the HBM rate and its
operations over their peak. The counts are the algorithm's, per warp, not
the launch layout's: a kernel that fuses passes or launches does not make
them stale.
"""
from __future__ import annotations

import math

# NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# ~6 operations an output voxel of a 1-D linear pass, ~10 a voxel of its adjoint
_PASS_FWD_OPS, _PASS_BWD_OPS = 6, 10


def least_s(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S) -> float:
    """Seconds the card needs at least for ``nbytes`` and ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def k1_affine(voxels: float, itemsize: int, backward: bool) -> tuple:
    """``(bytes, flops)`` of one 3-pass affine warp of ``voxels`` voxels in
    images of ``itemsize`` bytes: forward reads the source and writes the
    output; backward reads the cotangent and the source for theta's
    gradient (the engines' images need none)."""
    if not backward:
        return 2.0 * itemsize * voxels, 3.0 * _PASS_FWD_OPS * voxels
    return 2.0 * itemsize * voxels, 3.0 * _PASS_BWD_OPS * voxels


def k1_flow(voxels: float, itemsize: int, backward: bool, need_src: bool = False) -> tuple:
    """``(bytes, flops)`` of one 3-pass flow warp: forward reads the source
    and the f32 field (12 B a voxel) and writes the output; backward reads
    the cotangent, the source and the field and writes the field's gradient
    and, with ``need_src``, the source's (f32: 20 B a voxel forward, 32 or
    36 backward)."""
    if not backward:
        return (2.0 * itemsize + 12.0) * voxels, 3.0 * _PASS_FWD_OPS * voxels
    return ((2.0 + need_src) * itemsize + 24.0) * voxels, 3.0 * _PASS_BWD_OPS * voxels


def _itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


def cascade_levels(recipe: dict, shape) -> dict:
    """``{level: (voxels, kind, itemsize)}`` of a field-mode cascade's
    engine levels (``rigid/level0``, ..., ``flow/level2``) on a cube."""
    S = max(shape)
    levels = recipe.get("levels", 3)
    m_levels = min(recipe.get("matrix_levels") or levels, levels)
    m_item = _itemsize(recipe.get("matrix_dtype", "float32"))
    out = {}
    for stage in ("rigid", "affine"):
        if stage in recipe.get("stages", ()):
            for i in range(m_levels):
                out[f"{stage}/level{i}"] = ((S >> (levels - 1 - i)) ** 3, "affine", m_item)
    s = S
    while s > recipe.get("flow_max_size", 160):
        s //= 2
    fl = min(recipe.get("flow_levels") or min(2, levels),
             max(1, int(math.log2(max(1, s // 8))) + 1))
    f_item = _itemsize(recipe.get("flow_dtype", "float32"))
    for i in range(fl):
        out[f"flow/level{i}"] = ((s >> (fl - 1 - i)) ** 3, "flow", f_item)
    return out


def k1_cascade_least_s(recipe: dict, shape, replays: dict, calls: int, replay_pairs: int,
                       call_pairs: int) -> float:
    """The least time of K1's work in ``calls`` cascade calls of
    ``call_pairs`` pairs each, whose engine levels replayed their step
    ``replays[level]`` times in all, ``replay_pairs`` pairs a replay: each
    replay an engine step's warp and its backward (the level's input needs
    no gradient) for each of its pairs, stopped or not; each call, every pair's
    re-warps outside the steps: a matrix level's input warped by the theta so
    far (every level but the first rigid one), the full-resolution matrix
    warp (f32) and the final flow warp (f32)."""
    total = 0.0
    levels = cascade_levels(recipe, shape)
    form = {"affine": k1_affine, "flow": k1_flow}
    for name, (vox, kind, item) in levels.items():
        n = replays.get(name, 0) * replay_pairs
        for backward in (False, True):
            b, f = form[kind](vox, item, backward)
            total += n * least_s(b, f)
        if kind == "affine" and name != "rigid/level0":
            total += calls * call_pairs * least_s(*k1_affine(vox, item, False))
    full = float(math.prod(shape))
    total += calls * call_pairs * least_s(*k1_affine(full, 4, False))
    if any(kind == "flow" for _, kind, _ in levels.values()):
        total += calls * call_pairs * least_s(*k1_flow(full, 4, False))
    return total
