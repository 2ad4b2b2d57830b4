"""Per-mode configuration dataclasses (counterpart of
``torchregister_tpu/config.py``): the engines' default sets, made explicit.

- ``RigidConfig`` / ``AffineConfig`` / ``FlowConfig`` carry the engine
  defaults, including ``grad_edges=True`` for the matrix engines;
- ``API_GRAD_EDGES = False`` records the ``Register`` layer's override;
- ``CascadeConfig`` holds the cascade's defaults.

``tests/test_torch_config.py`` pins each dataclass to its engine's signature
by introspection, and to the JAX package's dataclass. The fields are the
port's engine arguments: the JAX engines' unused ``per`` is not a field here,
nor are the engines' random generators, which stand where the JAX engines
take a ``key``.

Usage::

    cfg = RigidConfig(lr=3e-3, epochs=500, optimizer="adam")
    warped, result = cfg.run(moving, target)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

# The Register layer's grad_edges default, which wins over the engines'.
API_GRAD_EDGES = False


def _kwargs(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@dataclass(frozen=True)
class RigidConfig:
    """Defaults of :func:`engines.rigid.rigid_register`."""

    lr: float = 1e-5
    epochs: int = 1000
    criterions: Any = None  # None -> the reference MSE+NCC+NMI stack
    weights: Any = None
    grad_edges: bool = True  # engine-layer default
    optimizer: str = "sgd"
    init: str = "random"
    method: str = "separable"
    max_shift: Union[int, Tuple[int, ...], None] = None  # None -> from the init
    check_window: bool = True
    stop_rel: Optional[float] = None  # plateau early stop
    patience: int = 25
    progress_every: Optional[int] = None  # print progress every N epochs

    def run(self, moving, target, **overrides):
        from .engines.rigid import rigid_register

        return rigid_register(moving, target, **{**_kwargs(self), **overrides})


@dataclass(frozen=True)
class AffineConfig:
    """Defaults of :func:`engines.affine.affine_register`."""

    lr: float = 1e-5
    epochs: int = 1000
    criterions: Any = None
    weights: Any = None
    grad_edges: bool = True  # engine-layer default
    optimizer: str = "sgd"
    method: str = "separable"
    max_shift: Union[int, Tuple[int, ...], None] = None
    check_window: bool = True
    stop_rel: Optional[float] = None
    patience: int = 25
    progress_every: Optional[int] = None

    def run(self, moving, target, **overrides):
        from .engines.affine import affine_register

        return affine_register(moving, target, **{**_kwargs(self), **overrides})


@dataclass(frozen=True)
class FlowConfig:
    """Defaults of :func:`engines.flow.flow_register`."""

    lr: float = 1e-3
    max_epochs: int = 2000
    stop_crit: float = 1e-4
    n: float = 1  # U-Net width divisor
    in_c: int = 1
    criterions: Any = None
    weights: Any = None
    grad_edges: bool = False
    optimizer: str = "sgd"
    depth: Optional[int] = None  # None -> max_depth_for the volume
    method: str = "separable"
    max_disp: int = 8
    dtype: str = "float32"
    remat: bool = False  # recompute the U-Net forward in the backward
    check_disp: bool = True
    use_attention: bool = True
    use_norm: bool = True
    flow_model: str = "unet"  # 'field' = direct dense-field optimization
    smooth: float = 0.0  # field-mode diffusion weight
    stop_rel: Optional[float] = None
    patience: int = 25
    zero_head: bool = False  # zero-init U-Net flow head
    progress_every: Optional[int] = None

    def run(self, moving, target, **overrides):
        from .engines.flow import flow_register

        return flow_register(moving, target, **{**_kwargs(self), **overrides})


@dataclass(frozen=True)
class CascadeConfig:
    """Defaults of :func:`engines.cascade.register_cascade`."""

    stages: Tuple[str, ...] = ("rigid", "affine", "flow")
    levels: int = 3
    rigid_epochs: int = 500
    rigid_lr: float = 1e-5
    affine_epochs: int = 200
    affine_lr: float = 1e-5
    flow_epochs: int = 100
    flow_lr: float = 1e-3
    criterions: Any = ("mse", "ncc")
    weights: Any = None
    optimizer: str = "adam"
    n: float = 8
    flow_depth: Optional[int] = None
    seed: int = 0
    residual_shift: int = 8
    final_warp: str = "separable"
    flow_max_size: int = 160
    flow_dtype: str = "float32"
    level_decay: float = 2.0
    flow_remat: bool = False
    flow_max_disp: int = 8
    matrix_dtype: str = "float32"
    flow_attention: bool = True
    flow_norm: bool = True
    matrix_stop_rel: Optional[float] = None
    matrix_patience: int = 25
    matrix_levels: Optional[int] = None  # rigid/affine on the coarsest N levels
    matrix_optimizer: Optional[str] = None  # None -> `optimizer`
    moment_init: Union[bool, str] = False  # True/'com' = centre of mass, 'pa' = axes
    flow_model: str = "field"
    flow_smooth: Optional[float] = None  # None -> 0.5 field, 0.0 unet
    flow_stop_rel: Optional[float] = None
    flow_patience: int = 25
    flow_compose: bool = True
    flow_levels: Optional[int] = None  # None -> min(2, levels)
    flow_criterions: Any = None  # None -> criterions
    flow_rebase: bool = False
    flow_residual_disp: int = 4

    def run(self, moving, target, **overrides):
        from .engines.cascade import register_cascade

        return register_cascade(moving, target, **{**_kwargs(self), **overrides})
