"""Port of ``benchmarks/probe_hatgather.py``: the probes' four kernels
(``csrc/hatgather.cu``), their plain versions and the probe functions P1-P5.

    python -m torchregister_tpu_torch.probes.hatgather [p1 p2 p3 p4 p5]

The JAX probes asked whether Mosaic lowers the data-dependent fetches of a
fused exact-warp kernel on a TPU; their kernels compute plain functions,
which the kernels here compute directly (see ``csrc/hatgather.cu``):

- :func:`block_permute_add` (P1): row block ``i`` of ``x`` is ``order[i]``'s,
  plus 1;
- :func:`slab_gather` (P2 and P4): the ``(Bz, By, X)`` slabs of a volume at
  element-granular ``(z, y)`` origins;
- :func:`slab_sum` (P3): each slab summed over ``z`` and ``y``, broadcast to
  ``rows`` rows (the kernel first sums By rows at every (z, oy), then each
  slab's Bz of those, the slabs of one oy side by side;
  :func:`slab_sum_ordered` is its order in torch ops);
- :func:`slice_transpose` (P5): a ``(Bz, By)`` slice of a slab as
  ``Bz*By`` rows, its ``CW`` x-columns from ``ox`` transposed to
  ``[CW, lanes]``, zeros past ``Bz*By``.

Each public function checks its index data on the host (the probes' origins
are host data) and dispatches by device: the plain version for a CPU tensor,
the kernel for a CUDA tensor, otherwise it raises. ``*_launch`` launches on
index data already checked by :func:`..checked_index` (the tensors' dtypes,
contiguity and device checked again, each raising), launches through the
port's one launch path (``native.Library.launch``) and counts the launch in
``launches``; :func:`reset_counts` zeroes the counts. f32 only.

Each probe function runs on the card unless given ``device='cpu'`` and
raises when its check fails: on the card a failure is a fault (the JAX
``main`` caught exceptions to learn whether Mosaic lowers a feature).
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..api import _resolve_device
from . import checked_index, clock_name, time_ms

SOURCE = native.PKG / "csrc" / "hatgather.cu"
KERNELS = ("block_permute_add", "slab_gather", "slab_sum", "slice_transpose")
# P3's tolerance against its plain version: both sum 224 terms in [0, 1) in
# f32 in different orders (the kernel each plane's 16 rows, then the planes)
P3_ATOL = 1e-4
F32, I32 = torch.float32, torch.int32

launches = dict.fromkeys(KERNELS, 0)
native.count_launches(__name__, "launches")

_P, _I = ctypes.c_void_p, ctypes.c_int
# each entry: the inputs', the scratch's (slab_sum) and the output's
# pointers, its ints, the stream
LIB = native.Library(SOURCE, "hatgather", {
    **{name: (_I, [_P] * n_ptr + [_I] * n_int + [_P])
       for name, n_ptr, n_int in zip(KERNELS, (3, 3, 5, 3), (3, 5, 7, 7))},
    "empty_launch": (_I, [_I, _P]),  # the launch floor (chip_smoke.py's launch path)
})


def reset_counts() -> None:
    for name in KERNELS:
        launches[name] = 0


def _launch(name: str, out_shape, vol: torch.Tensor, idx: torch.Tensor, ints) -> torch.Tensor:
    """Check ``vol`` (f32) and ``idx`` (int32), allocate the f32 output on
    their device and launch ``name``."""
    native.check_operands(name, (vol, F32), (idx, I32))
    out = vol.new_empty(out_shape)
    LIB.launch(name, vol, vol.data_ptr(), idx.data_ptr(), out.data_ptr(), *ints)
    native.bump(__name__, launches={name: 1})
    return out


def _volume(vol: torch.Tensor, what: str) -> None:
    if vol.dtype != torch.float32 or vol.ndim != 3:
        raise TypeError(f"{what} takes a float32 [Z, Y, X], got {vol.dtype} "
                        f"{tuple(vol.shape)}")


def _dispatch(launch, plain, x: torch.Tensor, *args):
    if x.is_cuda:
        return launch(x.contiguous(), *args)
    if x.device.type == "cpu":
        return plain(x, *args)
    raise RuntimeError(f"the probe kernels have no path for device {x.device}")


# P1 -------------------------------------------------------------------------

def block_permute_add_launch(x: torch.Tensor, order: torch.Tensor,
                             rows: int = 8) -> torch.Tensor:
    n, W = order.shape[0], x.shape[1]
    return _launch("block_permute_add", (n * rows, W), x, order, (n, rows, W))


def block_permute_add_plain(x: torch.Tensor, order: torch.Tensor,
                            rows: int = 8) -> torch.Tensor:
    return x.reshape(-1, rows, x.shape[1])[order.long()].reshape(-1, x.shape[1]) + 1.0


def block_permute_add(x: torch.Tensor, order, rows: int = 8) -> torch.Tensor:
    """``out[i*rows + r] = x[order[i]*rows + r] + 1`` for ``x [nb*rows, W]``
    (f32) and the host block order ``order [n]``."""
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[0] % rows:
        raise TypeError(f"P1 takes a float32 [nb * {rows}, W], got {x.dtype} "
                        f"{tuple(x.shape)}")
    nb = x.shape[0] // rows
    order = checked_index(order, (0,), (nb - 1,), "P1 block order", x.device)[:, 0]
    return _dispatch(block_permute_add_launch, block_permute_add_plain, x, order, rows)


# P2 and P4 ------------------------------------------------------------------

def slab_gather_launch(vol: torch.Tensor, orgs: torch.Tensor, Bz: int, By: int) -> torch.Tensor:
    T, (_, Y, X) = orgs.shape[0], vol.shape
    return _launch("slab_gather", (T, Bz, By, X), vol, orgs, (T, Y, X, Bz, By))


def _slab_index(orgs: torch.Tensor, Bz: int, By: int):
    o = orgs.long()
    z = o[:, 0, None] + torch.arange(Bz, device=o.device)
    y = o[:, 1, None] + torch.arange(By, device=o.device)
    return z[:, :, None], y[:, None, :]


def slab_gather_plain(vol: torch.Tensor, orgs: torch.Tensor, Bz: int, By: int) -> torch.Tensor:
    return vol[_slab_index(orgs, Bz, By)]


def _slab_origins(vol: torch.Tensor, orgs, Bz: int, By: int, what: str) -> torch.Tensor:
    _volume(vol, what)
    Z, Y, _ = vol.shape
    return checked_index(orgs, (0, 1), (Z - Bz, Y - By), f"{what} origins", vol.device)


def slab_gather(vol: torch.Tensor, orgs, Bz: int, By: int) -> torch.Tensor:
    """``out[t, z, y] = vol[orgs[t, 0] + z, orgs[t, 1] + y]``: ``[T, Bz, By, X]``
    from ``vol [Z, Y, X]`` (f32) at host origins ``orgs [T, 2]``."""
    orgs = _slab_origins(vol, orgs, Bz, By, "slab_gather")
    return _dispatch(slab_gather_launch, slab_gather_plain, vol, orgs, Bz, By)


# P3 -------------------------------------------------------------------------

def slab_sum_launch(vol: torch.Tensor, orgs: torch.Tensor, Bz: int, By: int,
                    rows: int = 8) -> torch.Tensor:
    """The two-stage kernel; its scratch, ``W [Z, Y - By + 1, X]`` (the
    By-row sums at every (z, oy)) and the slabs' order by oy ``[T]``, is
    allocated here."""
    T, (Z, Y, X) = orgs.shape[0], vol.shape
    native.check_operands("slab_sum", (vol, F32), (orgs, I32))
    W = vol.new_empty((Z, Y - By + 1, X))
    order = orgs.new_empty((T,))
    out = vol.new_empty((T, rows, X))
    LIB.launch("slab_sum", vol, vol.data_ptr(), orgs.data_ptr(), W.data_ptr(), order.data_ptr(),
               out.data_ptr(), T, Z, Y, X, Bz, By, rows)
    native.bump(__name__, launches={"slab_sum": 1})
    return out


def slab_sum_plain(vol: torch.Tensor, orgs: torch.Tensor, Bz: int, By: int,
                   rows: int = 8) -> torch.Tensor:
    s = slab_gather_plain(vol, orgs, Bz, By).sum(dim=(1, 2))
    return s[:, None, :].expand(-1, rows, -1).contiguous()


def slab_sum_ordered(vol: torch.Tensor, orgs: torch.Tensor, Bz: int, By: int,
                     rows: int = 8) -> torch.Tensor:
    """The kernel's two stages in torch ops, each add an f32 add of the
    kernel's, in its order: ``W[z, oy]``, the By rows from ``oy`` in
    ascending y, at every (z, oy); then each slab's Bz rows of ``W`` in
    ascending z. Equal to the kernel to the bit on any device."""
    Z, Y, X = vol.shape
    Yo = Y - By + 1
    W = torch.zeros((Z, Yo, X), dtype=torch.float32, device=vol.device)
    for y in range(By):
        W = W + vol[:, y:y + Yo]
    oz, oy = orgs[:, 0].long(), orgs[:, 1].long()
    acc = torch.zeros((orgs.shape[0], X), dtype=torch.float32, device=vol.device)
    for z in range(Bz):
        acc = acc + W[oz + z, oy]
    return acc[:, None, :].expand(-1, rows, -1).contiguous()


def slab_sum(vol: torch.Tensor, orgs, Bz: int, By: int, rows: int = 8) -> torch.Tensor:
    """Each ``(Bz, By, X)`` slab of ``vol [Z, Y, X]`` (f32) at host origins
    ``orgs [T, 2]`` summed over z and y, on each of ``rows`` rows:
    ``[T, rows, X]``."""
    orgs = _slab_origins(vol, orgs, Bz, By, "slab_sum")
    return _dispatch(slab_sum_launch, slab_sum_plain, vol, orgs, Bz, By, rows)


# P5 -------------------------------------------------------------------------

def slice_transpose_launch(slab: torch.Tensor, starts: torch.Tensor, Bz: int, By: int,
                           CW: int, lanes: int) -> torch.Tensor:
    T, (_, SY, X) = starts.shape[0], slab.shape
    return _launch("slice_transpose", (T, CW, lanes), slab, starts,
                   (T, SY, X, Bz, By, CW, lanes))


def slice_transpose_plain(slab: torch.Tensor, starts: torch.Tensor, Bz: int, By: int,
                          CW: int, lanes: int) -> torch.Tensor:
    s = starts.long()
    r = torch.arange(Bz * By, device=s.device)
    z = s[:, 0, None] + r // By
    y = s[:, 1, None] + r % By
    x = s[:, 2, None] + torch.arange(CW, device=s.device)
    vals = slab[z[:, None, :], y[:, None, :], x[:, :, None]]  # [T, CW, Bz*By]
    return F.pad(vals, (0, lanes - Bz * By))


def slice_transpose(slab: torch.Tensor, starts, Bz: int = 14, By: int = 16, CW: int = 16,
                    lanes: int = 256) -> torch.Tensor:
    """``out[t, c, r] = slab[dz + r // By, dy + r % By, ox + c]`` for
    ``r < Bz*By`` and 0 for ``r < lanes``, from ``slab [SZ, SY, X]`` (f32) at
    host starts ``(dz, dy, ox)`` ``[T, 3]``: ``[T, CW, lanes]``."""
    _volume(slab, "slice_transpose")
    if lanes < Bz * By:
        raise ValueError(f"slice_transpose: {lanes} lanes hold no {Bz}x{By} slice")
    SZ, SY, X = slab.shape
    starts = checked_index(starts, (0, 1, 2), (SZ - Bz, SY - By, X - CW),
                           "slice_transpose starts", slab.device)
    return _dispatch(slice_transpose_launch, slice_transpose_plain, slab, starts, Bz, By, CW,
                     lanes)


# the probes -----------------------------------------------------------------

def _uniform(shape, seed: int, device: torch.device) -> torch.Tensor:
    """U[0, 1) f32 from an explicit CPU generator: the same volume on any device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=gen, dtype=torch.float32).to(device)


def _report(label: str, out: torch.Tensor, want: torch.Tensor) -> float:
    if out.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(out.shape)}, not {tuple(want.shape)}")
    err = float(torch.max(torch.abs(out - want)))
    ok = err == 0
    print(f"{label}: err={err:.1e} {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees with its oracle: {err:.3e}")
    return err


def p1_scalar_block_index(device=None) -> float:
    """P1: the rows of ``[16, 256]`` in the row-block order ``[1, 0]``, plus 1."""
    dev = _resolve_device(device, "p1_scalar_block_index")
    x = torch.arange(16 * 256, dtype=torch.float32, device=dev).reshape(16, 256)
    out = block_permute_add(x, [1, 0])
    return _report("P1 scalar-prefetch block index", out, torch.cat([x[8:], x[:8]]) + 1.0)


def p2_element_zy(device=None, Bz: int = 14, By: int = 16) -> float:
    """P2: six (Bz, By, 256) slabs at element-granular (z, y) origins of a
    [64, 64, 256] volume, the last at the far corner."""
    dev = _resolve_device(device, "p2_element_zy")
    Z, Y, X = 64, 64, 256
    vol = _uniform((Z, Y, X), 0, dev)
    orgs = [[3, 5], [11, 0], [0, 23], [9, 9], [Z - Bz, Y - By], [17, 31]]
    out = slab_gather(vol, orgs, Bz, By)
    want = torch.stack([vol[z:z + Bz, y:y + By] for z, y in orgs])
    return _report(f"P2 element z/y starts (Bz={Bz}, By={By})", out, want)


def p3_origins(size: int, T: int, Bz: int = 14, By: int = 16) -> np.ndarray:
    """P3's slab origins: ``numpy.random.default_rng(0)``, as the JAX probe."""
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, size - Bz, T), rng.integers(0, size - By, T)],
                    axis=-1).astype(np.int32)


def p3_fetch_throughput(device=None, size: int = 240, lanes: int = 256, tile: int = 10,
                        iters: int = 20) -> float:
    """P3: one slab (14, 16, lanes) per output tile of a ``size``-cube warp
    (``(size // tile)^3`` slabs, 13824 at 240) at random origins of a
    [size, size, lanes] volume, each summed over z and y into 8 rows; one
    launch timed (mean of ``iters``), three slabs checked. Returns ms."""
    dev = _resolve_device(device, "p3_fetch_throughput")
    Bz, By = 14, 16
    T = (size // tile) ** 3
    vol = _uniform((size, size, lanes), 0, dev)
    orgs_np = p3_origins(size, T, Bz, By)
    out = slab_sum(vol, orgs_np, Bz, By)
    orgs = _slab_origins(vol, orgs_np, Bz, By, "slab_sum")
    run = slab_sum_launch if dev.type == "cuda" else slab_sum_plain
    ms = time_ms(lambda: run(vol, orgs, Bz, By), dev, iters)
    gb = T * Bz * By * lanes * 4 / 1e9
    print(f"P3 fetch {T} x [{Bz},{By},{lanes}] blocks ({gb:.2f} GB): {ms:.4f} ms a launch "
          f"({clock_name(dev)}, mean of {iters}); {gb / ms:.2f} TB/s of slab reads",
          flush=True)
    for i in (0, 7, T - 1):
        z, y = (int(v) for v in orgs_np[i])
        want = vol[z:z + Bz, y:y + By].sum(dim=(0, 1))
        err = float(torch.max(torch.abs(out[i] - want[None])))
        if not err < P3_ATOL:
            raise AssertionError(f"P3 tile {i}: err {err:.3e} >= {P3_ATOL:g}")
    print("P3 values OK", flush=True)
    return ms


def p4_bounded_slice(device=None) -> float:
    """P4: five (16, 16, 256) slabs at (z, y) origins of [64, 64, 256]."""
    dev = _resolve_device(device, "p4_bounded_slice")
    Z, Y, X = 64, 64, 256
    SZ = SY = 16
    vol = _uniform((Z, Y, X), 0, dev)
    orgs = [[3, 5], [11, 0], [0, 23], [9, 9], [Z - SZ, Y - SY]]
    out = slab_gather(vol, orgs, SZ, SY)
    want = torch.stack([vol[z:z + SZ, y:y + SY] for z, y in orgs])
    return _report("P4 BoundedSlice z/y starts", out, want)


def p5_inkernel_slice_restack(device=None) -> float:
    """P5: three (14, 16) slices of a [32, 32, 256] slab, each as 224 rows,
    16 x-columns transposed to [16, 256] (lanes 224-255 zero)."""
    dev = _resolve_device(device, "p5_inkernel_slice_restack")
    SZ, SY, X = 32, 32, 256
    Bz, By, CW = 14, 16, 16
    slab = _uniform((SZ, SY, X), 1, dev)
    starts = [[0, 0, 3], [9, 13, 240 - CW], [18, 16, 0]]
    out = slice_transpose(slab, starts, Bz, By, CW, 256)
    want = torch.zeros_like(out)
    for i, (dz, dy, ox) in enumerate(starts):
        blk = slab[dz:dz + Bz, dy:dy + By].reshape(Bz * By, X)
        want[i, :, :Bz * By] = blk[:, ox:ox + CW].T
    return _report("P5 in-kernel slice+restack", out, want)


PROBES = {"p1": p1_scalar_block_index, "p2": p2_element_zy, "p3": p3_fetch_throughput,
          "p4": p4_bounded_slice, "p5": p5_inkernel_slice_restack}


def main(argv=None) -> None:
    """Run the named probes on the card (default ``p1 p2 p3``), in order."""
    which = list(sys.argv[1:] if argv is None else argv) or ["p1", "p2", "p3"]
    unknown = sorted(set(which) - set(PROBES))
    if unknown:
        raise SystemExit(f"unknown probes {unknown}; choose from {sorted(PROBES)}")
    dev = _resolve_device(None, "probes.hatgather")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for name in PROBES:
        if name in which:
            PROBES[name]()


if __name__ == "__main__":
    main()
