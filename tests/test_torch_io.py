"""Transform and volume files of the PyTorch port against the JAX package:
the treedef bytes are JAX's, and files cross both ways."""
import gzip
import struct

import jax
import numpy as np
import pytest
import torch

from torchregister_tpu.utils import io as jio
from torchregister_tpu.utils import volio as jvolio
from torchregister_tpu_torch.utils import io as tio
from torchregister_tpu_torch.utils import volio as tvolio

KEY_SETS = [[], ["theta"], ["mode", "theta"], ["flow", "mode", "theta"],
            [f"k{i:03d}" for i in range(130)], ["é", "z"]]


@pytest.mark.parametrize("keys", KEY_SETS, ids=["empty", "one", "two", "three", "130",
                                                 "unicode"])
def test_torch_treedef_bytes_are_jax(keys):
    _, treedef = jax.tree.flatten({k: np.zeros(1) for k in keys})
    want = treedef.serialize_using_proto()
    assert tio.encode_dict_treedef(sorted(keys)) == want
    assert tio.decode_dict_treedef(want) == sorted(keys)


@pytest.mark.parametrize("tree", [{"a": {"b": 1}}, [1, 2], (1,), {"a": None}],
                         ids=["nested", "list", "tuple", "none"])
def test_torch_treedef_rejects_other_trees(tree):
    _, treedef = jax.tree.flatten(tree)
    with pytest.raises(ValueError):
        tio.decode_dict_treedef(treedef.serialize_using_proto())


def test_torch_save_pytree_rejects_non_flat(tmp_path):
    with pytest.raises(ValueError):
        tio.save_pytree(str(tmp_path / "x"), {"a": {"b": np.zeros(1)}})
    with pytest.raises(ValueError):
        tio.save_pytree(str(tmp_path / "x"), [np.zeros(1)])
    with pytest.raises(ValueError, match="truncated"):
        tio.decode_dict_treedef(b"\n\x02\x10")


def _transform():
    rng = np.random.default_rng(0)
    return {"mode": np.asarray("cascade"),
            "theta": rng.normal(size=(1, 3, 4)).astype(np.float32),
            "flow": rng.normal(size=(1, 3, 5, 6, 7)).astype(np.float32)}


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_torch_pytree_files_cross_both_ways(tmp_path):
    tree = _transform()
    port_file = tio.save_pytree(str(tmp_path / "port"), {**tree, "theta": torch.tensor(
        tree["theta"])})
    assert port_file.endswith(".npz")
    _same(jio.load_pytree(port_file), tree)
    jax_file = jio.save_pytree(str(tmp_path / "jax.npz"), tree)
    _same(tio.load_pytree(jax_file), tree)
    # byte-identical archives members: same leaves, same treedef
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["__treedef__"].tobytes() == b["__treedef__"].tobytes()


class _Reg:
    def __init__(self, mode, theta=None, device=None):
        self.mode, self.theta, self.device = mode, theta, device


def test_torch_save_and_load_transform_guards(tmp_path):
    theta = torch.tensor(_transform()["theta"])
    path = tio.save_transform(str(tmp_path / "r.npz"), _Reg("rigid", theta))
    assert str(jio.load_pytree(path)["mode"]) == "rigid"
    aff = _Reg("affine")
    tio.load_transform(path, aff)  # rigid <-> affine interchange is fine
    torch.testing.assert_close(aff.theta, theta, rtol=0, atol=0)
    with pytest.raises(ValueError, match="misapply"):
        tio.load_transform(path, _Reg("flow"))
    flow = torch.tensor(_transform()["flow"])
    fpath = tio.save_transform(str(tmp_path / "f.npz"), _Reg("flow", flow))
    assert "flow" in jio.load_pytree(fpath)
    with pytest.raises(ValueError, match="misapply"):
        tio.load_transform(fpath, _Reg("rigid"))
    both = jio.save_pytree(str(tmp_path / "c.npz"), _transform())
    with pytest.raises(ValueError, match="composite"):
        tio.load_transform(both, _Reg("flow"))
    with pytest.raises(ValueError, match="no fitted"):
        tio.save_transform(str(tmp_path / "n.npz"), _Reg("rigid"))
    # a mode-less file written by the JAX package: the payload decides
    bare = jio.save_pytree(str(tmp_path / "b.npz"), {"flow": _transform()["flow"]})
    reg = _Reg("flow")
    tio.load_transform(bare, reg)
    assert reg.theta.dtype == torch.float32 and reg.theta.shape == flow.shape


# ---------------------------------------------------------------- volumes


def test_torch_volio_native_lib_builds():
    assert tvolio._get_lib() is not None


@pytest.mark.parametrize("shape", [(7, 9, 11), (6, 5)], ids=["3d", "2d"])
def test_torch_volumes_cross_both_ways(tmp_path, shape):
    vol = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    p, q = str(tmp_path / "port.nii"), str(tmp_path / "jax.nii")
    tvolio.write_volume(p, vol)
    jvolio.write_volume(q, vol)
    for path in (p, q):
        for reader in (tvolio.read_volume, jvolio.read_volume, tvolio._np_read_nifti):
            back = reader(path)
            assert back.shape == shape
            np.testing.assert_array_equal(back, vol)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()


def test_torch_volio_numpy_path_and_gzip(tmp_path):
    vol = np.random.default_rng(2).normal(size=(5, 6, 4)).astype(np.float32)
    p = str(tmp_path / "v.nii")
    tvolio._np_write_nifti(p, vol)
    np.testing.assert_array_equal(jvolio.read_volume(p), vol)
    gz = str(tmp_path / "v.nii.gz")
    with open(p, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    np.testing.assert_array_equal(tvolio.read_volume(gz), vol)
    np.testing.assert_array_equal(tvolio._np_read_nifti(gz), vol)


def test_torch_volio_int16_scaling(tmp_path):
    data = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, 2, 3, 4, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 4)  # int16
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 2.0, 10.0)
    hdr[344:348] = b"n+1\x00"
    p = str(tmp_path / "i16.nii")
    with open(p, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4)
        f.write(np.asfortranarray(data).tobytes(order="F"))
    want = data.astype(np.float32) * 2 + 10
    np.testing.assert_allclose(tvolio.read_volume(p), want)
    np.testing.assert_allclose(tvolio._np_read_nifti(p), want)


def test_torch_volio_load_batch_and_normalize(tmp_path):
    rng = np.random.default_rng(4)
    vols = [rng.normal(size=(6, 7, 8)).astype(np.float32) for _ in range(3)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(str(tmp_path / f"v{i}.nii"))
        jvolio.write_volume(paths[-1], v)
    batch = tvolio.load_batch(paths, (6, 7, 8), nthreads=2)
    np.testing.assert_array_equal(batch, jvolio.load_batch(paths, (6, 7, 8), nthreads=2))
    np.testing.assert_array_equal(batch, np.stack(vols))
    x = (rng.normal(size=(32, 32)) * 10 + 3).astype(np.float32)
    y = tvolio.normalize_minmax_(x.copy())
    np.testing.assert_allclose(y, jvolio.normalize_minmax_(x.copy()), atol=1e-6)
    assert abs(float(y.min())) < 1e-6 and abs(float(y.max()) - 1.0) < 1e-5
    with pytest.raises(ValueError):
        tvolio.normalize_minmax_(x.astype(np.float64))
