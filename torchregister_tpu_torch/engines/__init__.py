"""Registration engines: rigid, affine, direct-field flow and the cascade.
The names the JAX package's ``engines`` exports."""
from .affine import affine_register
from .common import RegistrationResult, make_optimizer, optimize_scan
from .flow import FlowResult, flow_register
from .rigid import init_rigid_params, rigid_register

__all__ = [
    "affine_register",
    "rigid_register",
    "flow_register",
    "init_rigid_params",
    "RegistrationResult",
    "FlowResult",
    "make_optimizer",
    "optimize_scan",
]
