"""Volume I/O (counterpart of ``torchregister_tpu/utils/volio.py``): NIfTI-1
read and write, cohort batch loading and min-max normalization.

The native runtime is the repository's shared ``csrc/volio.cpp``, built with
``g++`` into the port's ``_build/`` at first use and loaded with ``ctypes``.
Where it cannot be built (no toolchain or zlib), the numpy NIfTI reader and
writer below serve, as in the JAX package. Host file I/O only.
"""
from __future__ import annotations

import ctypes
import gzip
import struct
from typing import Optional, Sequence

import numpy as np

from .. import native

SOURCE = native.PKG.parent / "csrc" / "volio.cpp"
GXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _get_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None where it cannot be built or loaded."""
    global _lib, _lib_tried
    if _lib is None and not _lib_tried:
        _lib_tried = True
        if not SOURCE.exists():
            return None
        try:
            lib = ctypes.CDLL(str(native.build_library(SOURCE, "volio", GXX,
                                                       ("-lz", "-lpthread"))))
        except (RuntimeError, OSError):
            return None
        f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        lib.volio_nifti_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.volio_read_nifti.argtypes = [ctypes.c_char_p, f32p, i64]
        lib.volio_write_nifti.argtypes = [ctypes.c_char_p, f32p, ctypes.POINTER(i64),
                                          ctypes.c_int]
        lib.volio_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                         f32p, i64, ctypes.c_int]
        lib.volio_normalize_minmax.argtypes = [f32p, i64, ctypes.c_int]
        for fn in (lib.volio_nifti_shape, lib.volio_read_nifti, lib.volio_write_nifti,
                   lib.volio_load_batch, lib.volio_normalize_minmax):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# --------------------------------------------------------- numpy NIfTI-1 path

_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                 64: np.float64, 256: np.int8, 512: np.uint16}


def _np_read_nifti(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if struct.unpack_from("<i", raw, 0)[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", raw, 40)
    shape = dim[1:1 + dim[0]]
    datatype = struct.unpack_from("<h", raw, 70)[0]
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0]) or 352
    slope, inter = struct.unpack_from("<2f", raw, 112)
    dt = _NIFTI_DTYPES.get(datatype)
    if dt is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    data = np.frombuffer(raw, dt, count=int(np.prod(shape)),
                         offset=vox_offset).astype(np.float32)
    # NIfTI-1: scl_slope == 0 means no scaling (scl_inter is ignored too)
    if slope != 0.0 and (slope != 1.0 or inter != 0.0):
        data = data * slope + inter
    # the file stores the first axis fastest: Fortran order gives [x, y, z]
    return data.reshape(shape, order="F")


def _np_write_nifti(path: str, data: np.ndarray) -> None:
    data = np.asarray(data, np.float32)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *([data.ndim] + list(data.shape)
                                       + [1] * (7 - data.ndim)))
    struct.pack_into("<h", hdr, 70, 16)  # float32
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<8f", hdr, 76, 0, *([1.0] * 7))
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, 1, 0, 0, 0)
    struct.pack_into("<4f", hdr, 296, 0, 1, 0, 0)
    struct.pack_into("<4f", hdr, 312, 0, 0, 1, 0)
    hdr[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(np.asfortranarray(data).tobytes(order="F"))


# ---------------------------------------------------------------- public API


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_volume(path: str) -> np.ndarray:
    """Read a NIfTI-1 volume (``.nii``/``.nii.gz``) as float32."""
    lib = _get_lib()
    if lib is not None:
        shape = (ctypes.c_int64 * 8)()
        nd = ctypes.c_int()
        if lib.volio_nifti_shape(path.encode(), shape, ctypes.byref(nd)) == 0:
            dims = tuple(shape[i] for i in range(nd.value))
            out = np.empty(int(np.prod(dims)), np.float32)
            if lib.volio_read_nifti(path.encode(), _f32p(out), out.size) == 0:
                return out.reshape(dims, order="F")
    return _np_read_nifti(path)


def write_volume(path: str, data) -> None:
    """Write a float32 volume as uncompressed ``.nii``."""
    data = np.asarray(data, np.float32)
    lib = _get_lib()
    if lib is not None and not path.endswith(".gz"):
        fdata = np.asfortranarray(data).reshape(-1, order="F").copy()
        shape = (ctypes.c_int64 * data.ndim)(*data.shape)
        if lib.volio_write_nifti(path.encode(), _f32p(fdata), shape, data.ndim) == 0:
            return
    _np_write_nifti(path, data)


def load_batch(paths: Sequence[str], volume_shape, nthreads: int = 8) -> np.ndarray:
    """Load same-shaped volumes into one contiguous ``[B, *volume_shape]``
    float32 array (the native loader reads them in parallel)."""
    shape = tuple(volume_shape)
    d = len(shape)
    n = int(np.prod(shape))
    out = np.zeros((len(paths), n), np.float32)
    lib = _get_lib()
    loaded = False
    if lib is not None:
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        loaded = lib.volio_load_batch(arr, len(paths), _f32p(out), n,
                                      nthreads) == len(paths)
    if not loaded:
        for i, p in enumerate(paths):
            out[i] = read_volume(p).reshape(-1, order="F")
    # rows hold each volume in file (Fortran) order: view as reversed dims
    # (C order) and transpose back to [B, *shape]
    return np.ascontiguousarray(
        out.reshape((len(paths),) + shape[::-1]).transpose((0,) + tuple(range(d, 0, -1))))


def normalize_minmax_(data: np.ndarray, nthreads: int = 8) -> np.ndarray:
    """In-place min-max normalization of a C-contiguous float32 array to
    [0, 1]."""
    if data.dtype != np.float32 or not data.flags["C_CONTIGUOUS"]:
        raise ValueError("normalize_minmax_ takes a C-contiguous float32 array")
    lib = _get_lib()
    if lib is not None:
        lib.volio_normalize_minmax(_f32p(data), data.size, nthreads)
        return data
    lo, hi = data.min(), data.max()
    data -= lo
    data /= (hi - lo) + 1e-9
    return data
