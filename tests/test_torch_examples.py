"""Item 13's public surface on the CPU: the port's README driver
(``examples/readme_driver_torch.py``: its panel in 2-D and 3-D, its 2-D run
at a small size), ``Register``'s optional loss plot, the names the JAX
package's ``engines`` exports, and ``ops/resample.multilinear_sample``
against the JAX package's (rtol 1e-5 / atol 1e-6: both sum the same 2^d
corner products in f32, in another order)."""
import importlib.util
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchregister_tpu.engines as j_engines
import torchregister_tpu_torch as ttr
import torchregister_tpu_torch.engines as t_engines
from torchregister_tpu.ops.resample import multilinear_sample as j_multilinear_sample
from torchregister_tpu_torch.ops.resample import multilinear_sample

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import readme_driver_torch as driver  # noqa: E402

HAVE_MPL = importlib.util.find_spec("matplotlib") is not None


@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib not installed")
@pytest.mark.parametrize("ndim", [2, 3])
def test_torch_save_panel_writes_png(tmp_path, ndim):
    """``tests/test_examples_panel.py:25`` with the port's tensors."""
    gen = torch.Generator().manual_seed(0)
    moving, target, warped, mag = (torch.rand((1, 1) + (24,) * ndim, generator=gen)
                                   for _ in range(4))
    out = tmp_path / f"panel_{ndim}d.png"
    assert driver.save_panel(str(out), moving, target, warped, mag) is True
    assert out.exists() and out.stat().st_size > 1000


@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib not installed")
def test_torch_readme_driver_2d_runs(tmp_path, capsys):
    """The README pipeline (rigid 500, affine 200, flow 100 epochs) on the
    2-D phantom at 24² on the CPU: the cascade reduces the RMSE by more than
    half and writes its panel."""
    panel = tmp_path / "panel.png"
    rmse0, rmse = driver.main(["--dim", "2", "--size", "24", "--device", "cpu",
                               "--panel", str(panel)])
    assert rmse < 0.5 * rmse0, (rmse0, rmse)
    assert panel.exists() and panel.stat().st_size > 1000
    out = capsys.readouterr().out
    assert "rigid theta" in out and "reduction" in out


@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib not installed")
def test_torch_register_debug_plots_the_losses(monkeypatch):
    """``debug=True`` ends its report with the loss curve, as the JAX
    package's ``Register._report`` does: one line of the finite losses, then
    ``plt.show()``."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gca().lines[-1].get_ydata()))
    plt.figure()
    gen = torch.Generator().manual_seed(1)
    mov = torch.rand((1, 1, 16, 16), generator=gen)
    reg = ttr.Register(mode="rigid", criterion=["mse"], debug=True, device="cpu")
    reg.optim(mov, torch.roll(mov, 1, dims=2), lr=1e-3, max_epochs=5)
    plt.close("all")
    assert len(shown) == 1
    np.testing.assert_allclose(shown[0], reg.losses[:5].numpy(), rtol=0, atol=0)


def test_torch_engines_export_the_jax_names():
    """``torchregister_tpu_torch.engines`` re-exports the JAX package's eight
    ``engines`` names, each the port's own object."""
    assert sorted(t_engines.__all__) == sorted(j_engines.__all__)
    from torchregister_tpu_torch.engines import (FlowResult, RegistrationResult,  # noqa: F401
                                                 affine_register, flow_register,
                                                 init_rigid_params, make_optimizer,
                                                 optimize_scan, rigid_register)
    from torchregister_tpu_torch.engines import common, flow, rigid

    assert rigid_register is ttr.rigid_register and flow_register is flow.flow_register
    assert init_rigid_params is rigid.init_rigid_params
    assert make_optimizer is common.make_optimizer and optimize_scan is common.optimize_scan
    assert RegistrationResult is ttr.RegistrationResult and FlowResult is ttr.FlowResult


@pytest.mark.parametrize("nd", [2, 3])
def test_torch_multilinear_sample_matches_jax(nd):
    """Index coordinates inside, on the edges and past every face (their
    corners outside contribute 0), two items of two channels."""
    rng = np.random.default_rng(nd)
    spatial = (7, 9, 11)[-nd:]
    src = rng.normal(size=(2, 2) + spatial).astype(np.float32)
    out_shape = (5, 6, 4)[-nd:]
    hi = np.asarray(spatial, np.float64) + 1.0
    coords = rng.uniform(-2.0, hi, size=(2,) + out_shape + (nd,)).astype(np.float32)
    coords[0, 0] = 0.0  # a row exactly on the first voxel
    got = multilinear_sample(torch.from_numpy(src), torch.from_numpy(coords)).numpy()
    want = np.asarray(j_multilinear_sample(jnp.asarray(src), jnp.asarray(coords)))
    assert got.shape == (2, 2) + out_shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.any(want == 0.0) and np.any(np.abs(want) > 0.1)
