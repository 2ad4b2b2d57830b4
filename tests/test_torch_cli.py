"""The PyTorch port's CLI (``python -m torchregister_tpu_torch``) on the CPU:
the cases of ``tests/test_cli.py`` with ``--device cpu``, the bit-exact
register/apply round trip, and transforms crossing between the two
packages' CLIs."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchregister_tpu.__main__ import main as jmain
from torchregister_tpu.ops.resample import warp_affine
from torchregister_tpu.ops.transforms import rigid_theta
from torchregister_tpu.utils.io import load_pytree as j_load_pytree
from torchregister_tpu_torch.__main__ import main
from torchregister_tpu_torch.utils.io import load_pytree
from torchregister_tpu_torch.utils.volio import read_volume, write_volume

CPU = ["--device", "cpu"]


@pytest.fixture()
def pair(tmp_path):
    rng = np.random.default_rng(0)
    g = np.meshgrid(*[np.linspace(-1, 1, 32)] * 2, indexing="ij")
    vol = sum(
        np.exp(-((g[0] - c0) ** 2 + (g[1] - c1) ** 2) / 0.08)
        for c0, c1 in rng.uniform(-0.4, 0.4, (4, 2))
    ).astype(np.float32)
    target = warp_affine(rigid_theta(jnp.asarray([0.08, 0.04, -0.03], jnp.float32))[None],
                         jnp.asarray(vol[None, None]))
    mp, tp = str(tmp_path / "m.nii"), str(tmp_path / "t.nii")
    write_volume(mp, vol)
    write_volume(tp, np.asarray(target)[0, 0])
    return mp, tp, tmp_path


def test_torch_cli_register_rigid_and_apply(pair, capsys):
    mp, tp, tmp = pair
    out, trf = str(tmp / "warped.nii"), str(tmp / "trf.npz")
    assert main(["register", mp, tp, "--mode", "rigid", "--epochs", "120", "--lr", "5e-3",
                 "--criterion", "mse", "-o", out, "--save-transform", trf, *CPU]) == 0
    msg = capsys.readouterr().out
    assert "reduction" in msg
    reduction = float(msg.split("(")[1].split("%")[0])
    assert reduction > 80.0, msg
    warped = read_volume(out)
    assert warped.shape == (32, 32)
    out2 = str(tmp / "warped2.nii")
    assert main(["apply", mp, trf, "-o", out2, *CPU]) == 0
    np.testing.assert_array_equal(read_volume(out2), warped)


def test_torch_cli_register_cascade_round_trip_is_bit_exact(pair, capsys):
    """The cascade's exact final warp and ``apply`` run the same K2 warps."""
    mp, tp, tmp = pair
    out, trf = str(tmp / "c.nii"), str(tmp / "c.npz")
    assert main(["register", mp, tp, "--mode", "cascade", "--epochs", "40", "--levels", "2",
                 "--criterion", "mse", "--flow-dtype", "float32", "-o", out,
                 "--save-transform", trf, *CPU]) == 0
    assert "reduction" in capsys.readouterr().out
    tr_ = load_pytree(trf)
    assert str(tr_["mode"]) == "cascade" and {"theta", "flow"} <= set(tr_)
    applied = str(tmp / "ca.nii")
    assert main(["apply", mp, trf, "-o", applied, *CPU]) == 0
    np.testing.assert_array_equal(read_volume(applied), read_volume(out))


def test_torch_cli_shape_mismatch_errors(pair, tmp_path):
    mp, tp, tmp = pair
    bad = str(tmp_path / "bad.nii")
    write_volume(bad, np.zeros((16, 16), np.float32))
    with pytest.raises(SystemExit):
        main(["register", mp, bad, "--mode", "rigid", *CPU])


def test_torch_cli_register_flow_and_apply_roundtrip(pair):
    mp, tp, tmp = pair
    out, tr_path = str(tmp / "fwarped.nii"), str(tmp / "ft.npz")
    assert main(["register", mp, tp, "--mode", "flow", "--epochs", "6", "--lr", "1e-3",
                 "--criterion", "mse", "-o", out, "--save-transform", tr_path, *CPU]) == 0
    tr_ = load_pytree(tr_path)
    assert "flow" in tr_ and "theta" not in tr_
    applied = str(tmp / "fapplied.nii")
    assert main(["apply", mp, tr_path, "-o", applied, *CPU]) == 0
    np.testing.assert_array_equal(read_volume(applied), read_volume(out))


def test_torch_cli_save_transform_without_npz_suffix(pair, capsys):
    mp, tp, tmp = pair
    trf = str(tmp / "bare_transform")
    assert main(["register", mp, tp, "--mode", "rigid", "--epochs", "4", "--criterion", "mse",
                 "--save-transform", trf, *CPU]) == 0
    assert os.path.exists(trf + ".npz") and trf + ".npz" in capsys.readouterr().out
    assert main(["apply", mp, trf + ".npz", "-o", str(tmp / "ap.nii"), *CPU]) == 0


def test_torch_cli_transform_carries_mode_manifest(pair):
    mp, tp, tmp = pair
    trf = str(tmp / "moded.npz")
    assert main(["register", mp, tp, "--mode", "rigid", "--epochs", "4", "--criterion", "mse",
                 "--save-transform", trf, *CPU]) == 0
    assert str(load_pytree(trf)["mode"]) == "rigid"
    assert str(j_load_pytree(trf)["mode"]) == "rigid"


def test_torch_cli_accepts_trailing_singleton_4d(pair, tmp_path):
    mp, tp, tmp = pair
    mp4 = str(tmp_path / "m4.nii")
    write_volume(mp4, read_volume(mp)[..., None])
    assert main(["register", mp4, tp, "--mode", "rigid", "--epochs", "4", "--criterion", "mse",
                 "-o", str(tmp_path / "w4.nii"), *CPU]) == 0


def test_torch_cli_device_cuda_needs_a_card(pair):
    mp, tp, tmp = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["register", mp, tp, "--mode", "rigid"],
                 ["apply", mp, str(tmp / "none.npz"), "-o", str(tmp / "x.nii")]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)


def test_torch_cli_apply_rejects_bad_files(pair, tmp_path):
    mp, tp, tmp = pair
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"not a zip")
    with pytest.raises(SystemExit, match="not a torchregister-tpu transform"):
        main(["apply", mp, str(junk), "-o", str(tmp_path / "x.nii"), *CPU])
    empty = tmp_path / "empty.npz"
    from torchregister_tpu_torch.utils.io import save_pytree

    save_pytree(str(empty), {"mode": np.asarray("rigid")})
    with pytest.raises(SystemExit, match="no theta/flow"):
        main(["apply", mp, str(empty), "-o", str(tmp_path / "x.nii"), *CPU])


@pytest.mark.parametrize("mode", ["rigid", "cascade"])
def test_torch_cli_transforms_cross_packages(pair, mode):
    """A transform saved by one package's CLI and applied by the other's
    gives the same volume to 1e-4."""
    mp, tp, tmp = pair
    args = ["--mode", mode, "--epochs", "20" if mode == "cascade" else "30",
            "--levels", "2", "--criterion", "mse"]
    jt, tt = str(tmp / "j.npz"), str(tmp / "t.npz")
    assert jmain(["register", mp, tp, *args, "--save-transform", jt]) == 0
    assert main(["register", mp, tp, *args, "--save-transform", tt, *CPU]) == 0
    for trf in (jt, tt):
        a, b = str(tmp / "a.nii"), str(tmp / "b.nii")
        assert jmain(["apply", mp, trf, "-o", a]) == 0
        assert main(["apply", mp, trf, "-o", b, *CPU]) == 0
        np.testing.assert_allclose(read_volume(b), read_volume(a), rtol=1e-4, atol=1e-4)
