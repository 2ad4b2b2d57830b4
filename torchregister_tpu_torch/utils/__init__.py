from .io import load_pytree, load_transform, save_pytree, save_transform
from .profiling import Throughput, device_trace, trace
from .pyramid import build_pyramid, compose_flows, upsample_flow

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_transform",
    "load_transform",
    "build_pyramid",
    "upsample_flow",
    "compose_flows",
    "Throughput",
    "trace",
    "device_trace",
]
