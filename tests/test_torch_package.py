"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and ``chip_smoke.py`` refuses to report without a GPU or without
the repository around it."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import setuptools
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "torchregister_tpu_torch"


def _run(code_or_args, cwd=ROOT):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_torch_port_imports_without_jax():
    """Import every module of the port in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torchregister_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'torchregister_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_torch_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|torchregister_tpu)\b",
                     re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "examples" / "readme_driver_torch.py"]:
        assert not pat.search(path.read_text()), path


def test_torch_readme_driver_imports_no_jax():
    """The port's README driver, imported in a fresh interpreter, loads
    neither JAX nor the JAX package."""
    code = (
        "import runpy, sys\n"
        "runpy.run_path('examples/readme_driver_torch.py', run_name='not_main')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'torchregister_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'torchregister_tpu_torch' in sys.modules\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_torch_kernel_source_ships_with_the_package():
    for source in ("sweep.cu", "warp.cu", "conv3d.cu", "roigather.cu", "hatgather.cu",
                   "roi_fetch.cu"):
        assert (PKG / "csrc" / source).is_file()
    # K3's source holds its three launches' entry points: the convolution
    # (forward and input gradient) and the weight gradient
    conv3d = (PKG / "csrc" / "conv3d.cu").read_text()
    for entry in ("conv3x3x3(", "conv3x3x3_wgrad("):
        assert f'extern "C" int {entry}' in conv3d
    assert "torchregister_tpu_torch" in setuptools.find_packages(str(ROOT),
                                                                 exclude=("tests",))
    setup_py = (ROOT / "setup.py").read_text()
    assert '"torchregister_tpu_torch": ["csrc/*.cu"]' in setup_py


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: chip_smoke.py runs in full")
def test_torch_chip_smoke_refuses_without_gpu():
    """Without a CUDA device: non-zero exit and no result line."""
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_torch_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
