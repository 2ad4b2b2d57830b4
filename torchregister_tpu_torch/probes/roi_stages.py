"""Port of ``benchmarks/probe_roi_stages.py``: the fetch kernel
(``csrc/roi_fetch.cu``), its plain version, and the function that times the
three stages of the exact affine warp's ROI route side by side.

    python -m torchregister_tpu_torch.probes.roi_stages

At 240^3 with the JAX probe's rigid transform, ``ops/blocked._roi_supports``
gives one row of K2b scalars ``(zq, yq, zr, yr, ox)`` per 10^3 output tile
(T = 13824). The stages, each one launch on the volume padded as the JAX
probe pads it (256^3):

- "restack": K2b, the compact ROI gather (``ops/cuda/roigather.roigather``);
- "fused": K2's affine mode, the whole warp (``ops/blocked.warp_affine_fast``);
- "fetch only": :func:`roi_fetch`, K2b's quantized fetch without the
  restack: per tile, the nine (8, 8, Xp) blocks at block origins
  ``(zq + i, yq + j)``, ``i, j < 3``, summed and folded to 128 lanes. The
  kernel sums each block once, then adds each tile's nine block sums
  (:func:`roi_fetch_ordered` is its order in torch ops).

:func:`roi_fetch` checks ``(zq, yq)`` on the host and dispatches by device:
the plain version for a CPU tensor, the kernel for a CUDA tensor, otherwise
it raises. ``launches`` counts kernel launches; :func:`reset_counts` zeroes
it. :func:`stages` runs on the card unless given ``device='cpu'``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import native
from ..api import _resolve_device
from ..ops import blocked
from ..ops.cuda import roigather as k2b
from ..ops.transforms import rigid_theta
from . import checked_index, clock_name, time_ms

SOURCE = native.PKG / "csrc" / "roi_fetch.cu"
QB = k2b.QB  # block edge along z and y
NB = 3  # blocks along z and y
LANES = 128
# the JAX probe's rigid transform (probe_roi_stages.py:33-35)
THETA = (0.12, -0.08, 0.1, 0.15, -0.1, 0.08)
# the fetch's tolerance against its plain version: both sum 9 * 64 * Xp/128
# terms (1152 at Xp = 256, each in [0, 1)) in f32 in different orders
FETCH_ATOL = 5e-4

launches = 0
native.count_launches(__name__, "launches")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "roi_fetch", {"roi_fetch": (_I, [_P] * 4 + [_I] * 4 + [_P])})


def reset_counts() -> None:
    global launches
    launches = 0


def roi_fetch_launch(volp: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on ``volp [Zp, Yp, Xp]`` (f32, CUDA) with scalars
    ``[T, 5]`` already checked by :func:`check_scalars`."""
    global launches
    native.check_operands("roi_fetch", (volp, torch.float32), (scal, torch.int32))
    T = scal.shape[0]
    Zp, Yp, Xp = volp.shape
    blk = volp.new_empty(((Zp // QB) * (Yp // QB) * LANES,))  # stage 1's block sums
    out = volp.new_empty((T, 1, LANES))
    LIB.launch("roi_fetch", volp, volp.data_ptr(), scal.data_ptr(), blk.data_ptr(),
               out.data_ptr(), T, Zp, Yp, Xp)
    launches += 1
    return out


def roi_fetch_plain(volp: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the nine blocks gathered one at a time, each
    summed over z and y, added, then folded to 128 lanes."""
    T, Xp = scal.shape[0], volp.shape[2]
    zq, yq = scal[:, 0].long(), scal[:, 1].long()
    r = torch.arange(QB, device=volp.device)
    acc = torch.zeros((T, Xp), dtype=torch.float32, device=volp.device)
    for i in range(NB):
        for j in range(NB):
            z = (QB * (zq + i))[:, None] + r
            y = (QB * (yq + j))[:, None] + r
            acc = acc + volp[z[:, :, None], y[:, None, :]].sum(dim=(1, 2))
    return acc.reshape(T, Xp // LANES, LANES).sum(dim=1)[:, None, :]


def roi_fetch_ordered(volp: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """The kernel's two stages in torch ops, each add an f32 add of the
    kernel's, in its order: every 8-block's sum (each z plane's y rows, each
    row's folds in order, then the planes in z order), then each tile's nine
    block sums in the order (i, j). Equal to the kernel to the bit on any
    device."""
    Zp, Yp, Xp = volp.shape
    nbz, nby, folds = Zp // QB, Yp // QB, Xp // LANES
    v = volp[:nbz * QB, :nby * QB].reshape(nbz, QB, nby, QB, folds, LANES)
    plane = torch.zeros((nbz, QB, nby, LANES), dtype=torch.float32, device=volp.device)
    for y in range(QB):
        for h in range(folds):
            plane = plane + v[:, :, :, y, h]
    blk = torch.zeros((nbz, nby, LANES), dtype=torch.float32, device=volp.device)
    for z in range(QB):
        blk = blk + plane[:, z]
    zq, yq = scal[:, 0].long(), scal[:, 1].long()
    acc = torch.zeros((scal.shape[0], LANES), dtype=torch.float32, device=volp.device)
    for i in range(NB):
        for j in range(NB):
            acc = acc + blk[zq + i, yq + j]
    return acc[:, None, :]


def check_scalars(volp: torch.Tensor, scal) -> torch.Tensor:
    """The host scalars ``[T, 5]`` with ``(zq, yq)`` checked against
    ``volp``'s blocks, on ``volp``'s device."""
    if volp.dtype != torch.float32 or volp.ndim != 3 or volp.shape[2] % LANES:
        raise TypeError(f"roi_fetch takes a float32 [Zp, Yp, Xp] with Xp a multiple of "
                        f"{LANES}, got {volp.dtype} {tuple(volp.shape)}")
    Zp, Yp, _ = volp.shape
    return checked_index(scal, (0, 1), (Zp // QB - NB, Yp // QB - NB), "roi_fetch scalars",
                         volp.device)


def roi_fetch(volp: torch.Tensor, scal) -> torch.Tensor:
    """Per tile, the nine (8, 8, Xp) blocks of ``volp`` at block origins
    ``(zq + i, yq + j)``, ``i, j < 3``, summed and folded to 128 lanes:
    ``[T, 1, 128]`` from host scalars ``[T, 5]`` (``zq, yq`` in columns 0, 1)."""
    scal = check_scalars(volp, scal)
    if volp.is_cuda:
        return roi_fetch_launch(volp.contiguous(), scal)
    if volp.device.type == "cpu":
        return roi_fetch_plain(volp, scal)
    raise RuntimeError(f"roi_fetch has no path for device {volp.device}")


def stage_inputs(size: int, device: torch.device):
    """The probe's inputs at ``size^3``: the volume (U[0, 1) from an explicit
    CPU generator, seed 0), the rigid theta ``[1, 3, 4]``, the host scalars
    of ``_roi_supports`` and the volume padded as the JAX probe pads it
    (z and y to whole 8-blocks plus two, x to whole 128-lanes)."""
    gen = torch.Generator().manual_seed(0)
    vol = torch.rand((size,) * 3, generator=gen, dtype=torch.float32).to(device)
    theta = rigid_theta(torch.tensor(THETA, dtype=torch.float32))[None]
    sup = blocked._roi_supports(theta[0].double().numpy(), (size,) * 3, False)
    if sup is None:
        raise ValueError(f"the probe's theta outgrows the ROI windows at {size}^3")
    Zp = QB * -(-size // QB) + 2 * QB
    Xp = LANES * -(-size // LANES)
    volp = F.pad(vol, (0, Xp - size, 0, Zp - size, 0, Zp - size))
    return vol, theta.to(device), sup[0], volp


def stages(device=None, size: int = 240, iters: int = 20) -> dict:
    """Each stage once through its public entry, then one launch of each
    timed (mean of ``iters``), and three tiles of the fetch checked against
    its plain version. Returns ``{stage: ms}``."""
    dev = _resolve_device(device, "roi_stages.stages")
    vol, theta, scal_np, volp = stage_inputs(size, dev)
    scal = check_scalars(volp, scal_np)
    T = scal.shape[0]
    mov = vol[None, None]
    fetch = roi_fetch(volp, scal_np)
    k2b.roigather(volp, scal)
    blocked.warp_affine_fast(theta, mov)
    fetch_run = roi_fetch_launch if dev.type == "cuda" else roi_fetch_plain
    runs = {"restack (compact kernel)": lambda: k2b.roigather(volp, scal),
            "fused warp kernel": lambda: blocked.warp_affine_fast(theta, mov),
            "fetch only (9-block reads)": lambda: fetch_run(volp, scal)}
    print(f"ROI stages at {size}^3, T={T} tiles, volp {tuple(volp.shape)} "
          f"({clock_name(dev)}, mean of {iters}):", flush=True)
    times = {}
    for name, fn in runs.items():
        times[name] = time_ms(fn, dev, iters)
        print(f"{name:<28} {times[name]:8.4f} ms", flush=True)
    for t in (0, T // 2, T - 1):
        want = roi_fetch_plain(volp, scal[t:t + 1])
        err = float(torch.max(torch.abs(fetch[t:t + 1] - want)))
        if not err < FETCH_ATOL:
            raise AssertionError(f"fetch tile {t}: err {err:.3e} >= {FETCH_ATOL:g}")
    print("fetch values OK", flush=True)
    return times


def main() -> None:
    """The three stages at 240^3 on the card."""
    dev = _resolve_device(None, "probes.roi_stages")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    stages(dev)


if __name__ == "__main__":
    main()
