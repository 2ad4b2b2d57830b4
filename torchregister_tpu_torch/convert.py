"""State carried across from the JAX package: its parameters, as numpy
arrays, turned into the port's tensors.

The layouts are the same in both packages (rigid params ``[6]``/``[3]``,
affine params ``[d(d+1)]``, theta ``[1, d, d+1]``, field ``[1, d, *S]``), so
conversion is shape and dtype checking plus ``torch.from_numpy``. The U-Net's
flax parameter tree maps onto ``models/attention_unet.AttentionUNet``'s state,
key ``a/b/c`` to ``a.b.c``, arrays unchanged (:func:`unet_params`,
:func:`unet_tree`).
"""
from __future__ import annotations

import numpy as np
import torch

from .models.attention_unet import AttentionUNet


def _tensor(a, name: str, ok: bool, expect: str, device) -> torch.Tensor:
    arr = np.asarray(a)
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"{name}: expected a float array, got {arr.dtype}")
    if not ok:
        raise ValueError(f"{name}: expected shape {expect}, got {arr.shape}")
    return torch.tensor(arr, dtype=torch.float32, device=device)  # a copy: JAX arrays are read-only


def rigid_params(a, device="cpu") -> torch.Tensor:
    """Raw rigid parameters ``[6]`` (3D) or ``[3]`` (2D)."""
    shape = np.shape(a)
    return _tensor(a, "rigid_params", shape in ((6,), (3,)), "(6,) or (3,)", device)


def affine_params(a, device="cpu") -> torch.Tensor:
    """Flat affine parameters ``[12]`` (3D) or ``[6]`` (2D)."""
    shape = np.shape(a)
    return _tensor(a, "affine_params", shape in ((12,), (6,)), "(12,) or (6,)", device)


def theta(a, device="cpu") -> torch.Tensor:
    """Affine matrix ``[1, d, d+1]``."""
    shape = np.shape(a)
    ok = shape in ((1, 3, 4), (1, 2, 3))
    return _tensor(a, "theta", ok, "(1, 3, 4) or (1, 2, 3)", device)


def field(a, device="cpu") -> torch.Tensor:
    """Displacement field ``[1, d, *S]`` in voxels."""
    shape = np.shape(a)
    ok = len(shape) in (4, 5) and shape[0] == 1 and shape[1] == len(shape) - 2
    return _tensor(a, "field", ok, "(1, d, *S)", device)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def unet_params(tree, model: AttentionUNet | None = None, device="cpu") -> dict:
    """The JAX package's U-Net parameter tree (nested dicts of arrays, flax
    names) as the state of ``model``: ``{'enc1.Conv_0.kernel': tensor, ...}``,
    f32 on ``device``. Without ``model`` the architecture is read off the
    tree (``ndim`` from the flow head, ``depth`` from the encoders, ``in_c``
    and the width divisor ``n = 64 / base width`` from ``enc1``, attention
    from the ``skip`` gates). Every key and shape is checked against that
    model's state; a mismatch raises ``ValueError``."""
    flat = _flatten(tree)
    if model is None:
        try:
            base = np.shape(flat["enc1.Conv_0.kernel"])
            model = AttentionUNet(
                ndim=np.shape(flat["out_kernel"])[1], in_c=base[-2], n=64 / base[-1],
                depth=sum(1 for k in flat if k.startswith("enc") and k.endswith(
                    ".Conv_0.kernel")),
                use_attention=any(k.startswith("skip") for k in flat))
        except (KeyError, IndexError) as e:
            raise ValueError(f"unet_params: not a U-Net parameter tree ({e})") from None
    expect = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if set(flat) != set(expect):
        raise ValueError(f"unet_params: keys differ from the model's: missing "
                         f"{sorted(set(expect) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(expect))}")
    return {k: _tensor(v, k, np.shape(v) == expect[k], str(expect[k]), device)
            for k, v in flat.items()}


def unet_tree(state: dict) -> dict:
    """The reverse of :func:`unet_params`: a U-Net state (``FlowResult.params``)
    as the JAX package's nested parameter tree of f32 numpy arrays."""
    tree: dict = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().to("cpu", torch.float32).numpy()
    return tree
