"""``Register`` and ``norm`` of the PyTorch port against the JAX package's,
on the CPU.

Under SGD from the identity the two packages take the same steps up to f32
rounding order, so executed steps are equal and thetas agree to
``tests/test_torch_engines.py``'s 1e-4 (fields to rtol 1e-3 / atol 1e-4);
the warped images come from the exact warps (K2's plain version here, the
JAX blocked path there) and agree to 1e-4.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchregister_tpu as jtr
import torchregister_tpu_torch as ttr
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.synthetic import make_pair

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def pair():
    mov, tgt = make_pair(SHAPE, seed=0)
    return mov.numpy(), tgt.numpy()


def _both(mode, pair, opt_kw, **kw):
    mov, tgt = pair
    regs = []
    for pkg, conv in ((jtr, jnp.asarray), (ttr, torch.from_numpy)):
        reg = pkg.Register(mode=mode, **kw, **({"device": "cpu"} if pkg is ttr else {}))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # SGD on a field
            reg.optim(conv(mov), conv(tgt), **opt_kw)
        regs.append(reg)
    return regs


MATRIX = dict(criterion=["mse", "ncc"], optimizer="sgd", init="identity", max_shift=6)


@pytest.mark.parametrize("mode,method", [("rigid", "separable"), ("affine", "separable"),
                                         ("rigid", "exact")])
def test_torch_register_matrix_matches_jax(pair, mode, method):
    jreg, treg = _both(mode, pair, dict(lr=2e-3 if mode == "rigid" else 1e-4,
                                        max_epochs=25), method=method, **MATRIX)
    assert int(treg.result.steps) == int(jreg.result.steps) == 25
    assert treg.theta.shape == (1, 3, 4)
    np.testing.assert_allclose(treg.theta.numpy(), np.asarray(jreg.theta), atol=1e-4)
    np.testing.assert_allclose(treg.losses.numpy(), np.asarray(jreg.losses),
                               rtol=1e-3, atol=3e-4)
    mov = pair[0]
    np.testing.assert_allclose(treg(torch.from_numpy(mov)).numpy(),
                               np.asarray(jreg(jnp.asarray(mov))), rtol=1e-4, atol=1e-4)


def test_torch_register_flow_matches_jax(pair):
    jreg, treg = _both("flow", pair, dict(lr=0.5, max_epochs=15),
                       criterion=["mse", "ncc"], optimizer="sgd", max_disp=4)
    assert int(treg.result.steps) == int(jreg.result.steps)
    np.testing.assert_allclose(treg.theta.numpy(), np.asarray(jreg.theta), rtol=1e-3,
                               atol=1e-4)
    mov = pair[0]
    np.testing.assert_allclose(treg(torch.from_numpy(mov)).numpy(),
                               np.asarray(jreg(jnp.asarray(mov))), rtol=1e-4, atol=1e-4)


def test_torch_register_call_runs_k2_plain_on_cpu(pair):
    """``__call__`` is the exact warp on every channel at once; on a CPU
    tensor it is K2's plain version, with no launch."""
    mov, tgt = (torch.from_numpy(a) for a in pair)
    reg = ttr.Register(mode="rigid", init="identity", device="cpu",
                       **{k: v for k, v in MATRIX.items() if k != "init"})
    reg.optim(mov, tgt, lr=2e-3, max_epochs=5)
    k2.reset_counts()
    three = torch.cat([mov, 2 * mov, -mov], dim=1)
    out = reg(three)
    assert out.shape == three.shape and (k2.affine_launches, k2.flow_launches) == (0, 0)
    torch.testing.assert_close(out[:, 1:2], 2 * out[:, :1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[:, :1], ttr.warp_affine_fast(reg.theta, mov), rtol=0,
                               atol=0)


def test_torch_register_devices_and_inputs(pair):
    mov, tgt = pair
    reg = ttr.Register(mode="rigid", criterion=["mse"], init="identity", max_shift=6,
                       device="cpu")
    reg.optim(mov.astype(np.float64), tgt, lr=1e-3, max_epochs=2)  # numpy -> CPU, f32
    assert reg.theta.device.type == "cpu" and reg.theta.dtype == torch.float32
    assert reg(mov).device.type == "cpu"
    with pytest.raises(RuntimeError, match="optim"):
        ttr.Register(mode="affine", device="cpu")(mov)
    with pytest.raises(ValueError):
        ttr.Register(mode="bogus")
    with pytest.raises(ValueError):
        ttr.Register(method="blocked")
    if not torch.cuda.is_available():
        # device=None means the card, as the JAX package's None means its
        # accelerator: it never moves to the CPU by itself
        for device in ("cuda", None):
            with pytest.raises(RuntimeError, match="CUDA"):
                ttr.Register(device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            ttr.Register()


@pytest.mark.parametrize("name", ["tpu", "gpu", "GPU", "Tpu"])
def test_torch_register_accelerator_names(name, monkeypatch):
    """The JAX package's accelerator names mean the card; without one they
    raise the "no CUDA device" error that ``'cuda'`` raises (no fall-back to
    the CPU)."""
    from torchregister_tpu_torch.api import _resolve_device

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.Register(device=name)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _resolve_device(name) == torch.device("cuda")
    assert _resolve_device("cpu") == torch.device("cpu")


def test_torch_register_random_init_is_seeded(pair):
    mov, tgt = (torch.from_numpy(a) for a in pair)
    thetas = []
    for seed in (3, 3, 4):
        reg = ttr.Register(mode="rigid", criterion=["mse"], seed=seed, max_shift=16,
                           device="cpu")
        reg.optim(mov, tgt, lr=1e-5, max_epochs=1)
        thetas.append(reg.result.param_history[0])
    assert torch.equal(thetas[0], thetas[1]) and not torch.equal(thetas[0], thetas[2])
    assert bool(((thetas[0] >= 0) & (thetas[0] < 1)).all())


def test_torch_register_default_criterion_waits_for_nmi():
    """``criterion=None`` runs the reference stack MSE + NCC(100) +
    NMI(1000) at its default NMI patch size (100): on a 2D pair (a 3D one
    would splat 200³ voxels a step in the JAX package), rigid under SGD from
    the identity, against the JAX package. Tolerances of the matrix tests
    above."""
    rng = np.random.default_rng(4)
    g = np.meshgrid(np.linspace(-1, 1, 36), np.linspace(-1, 1, 40), indexing="ij")
    mov, tgt = np.zeros((2, 1, 1, 36, 40), np.float32)
    for _ in range(6):  # blobs, and the same blobs moved by up to 1.5 pixels
        c, w, d = rng.uniform(-0.5, 0.5, 2), rng.uniform(0.12, 0.3), rng.uniform(-0.08, 0.08, 2)
        mov[0, 0] += np.exp(-((g[0] - c[0]) ** 2 + (g[1] - c[1]) ** 2) / (2 * w**2))
        tgt[0, 0] += np.exp(-((g[0] - c[0] - d[0]) ** 2 + (g[1] - c[1] - d[1]) ** 2)
                            / (2 * w**2))
    jreg, treg = _both("rigid", (mov, tgt), dict(lr=2e-3, max_epochs=20), optimizer="sgd",
                       init="identity", max_shift=6)
    assert int(treg.result.steps) == int(jreg.result.steps) == 20
    np.testing.assert_allclose(treg.losses.numpy(), np.asarray(jreg.losses), rtol=1e-3,
                               atol=3e-4)
    np.testing.assert_allclose(treg.theta.numpy(), np.asarray(jreg.theta), atol=1e-4)
    assert treg.losses[-1] < treg.losses[0]


def test_torch_register_transform_round_trip(pair, tmp_path):
    """A transform saved by one package's Register loads into the other's
    and warps to the same image."""
    mov, tgt = pair
    jreg, treg = _both("rigid", pair, dict(lr=2e-3, max_epochs=5), **MATRIX)
    from torchregister_tpu.utils.io import load_transform as j_load, save_transform as j_save

    path = ttr.save_transform(str(tmp_path / "t.npz"), treg)
    other = jtr.Register(mode="affine")
    j_load(path, other)
    np.testing.assert_allclose(np.asarray(other(jnp.asarray(mov))),
                               treg(mov).numpy(), rtol=1e-4, atol=1e-4)
    j_save(str(tmp_path / "j.npz"), jreg)
    back = ttr.Register(mode="rigid", device="cpu")
    ttr.load_transform(str(tmp_path / "j.npz"), back)
    np.testing.assert_allclose(back(mov).numpy(), np.asarray(jreg(jnp.asarray(mov))),
                               rtol=1e-4, atol=1e-4)


def test_torch_register_debug_report(pair, capsys):
    reg = ttr.Register(mode="rigid", debug=True, device="cpu", **MATRIX)
    reg.optim(*pair, lr=2e-3, max_epochs=12)
    out = capsys.readouterr().out
    assert "mode=rigid epochs=12" in out and out.count("  epoch ") == 11
    freg = ttr.Register(mode="flow", criterion=["mse"], debug=True, max_disp=4,
                        device="cpu")
    freg.optim(*pair, max_epochs=3)
    assert "flow did not converge within 3 epochs" in capsys.readouterr().out


def test_torch_norm():
    x = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(ttr.norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jtr.norm(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    assert ttr.norm("not an image") is None


def test_torch_register_debug_preflight_and_progress(pair, capsys):
    """Under ``debug``: the NMI pre-flight raises on a non-finite input with
    the JAX package's message (with the user's NMI keywords), and the
    matrix and flow loops print progress at the JAX package's epochs."""
    import re

    from torchregister_tpu_torch.losses import get_criterion

    mov, tgt = pair
    bad = mov.copy()
    bad[0, 0, 3, 3, 3] = np.nan
    nmi8 = get_criterion("nmi", patch_size=8, bins=32)
    reg = ttr.Register(mode="rigid", criterion=["mse", nmi8], debug=True, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite input to NMI"):
        reg.optim(bad, tgt, max_epochs=2)
    epochs = {}
    for name, pkg, kw in (("jax", jtr, {}), ("torch", ttr, dict(device="cpu"))):
        capsys.readouterr()
        pkg.Register(mode="rigid", debug=True, **MATRIX, **kw).optim(mov, tgt, lr=2e-3,
                                                                     max_epochs=25)
        pkg.Register(mode="flow", criterion=["mse"], debug=True, max_disp=4, **kw).optim(
            mov, tgt, max_epochs=12)
        out = capsys.readouterr().out
        epochs[name] = [re.findall(rf"\[{label}\] epoch (\d+)/", out)
                        for label in ("rigid_register", "flow_register")]
    assert epochs["torch"] == epochs["jax"] == [
        [str(e) for e in (2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 25)],
        [str(e) for e in range(1, 13)]]
