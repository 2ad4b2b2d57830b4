"""K3: the valid 3x3x3 convolution kernel (``csrc/conv3d.cu``), its autograd
Function and its plain version.

Counterpart of ``torchregister_tpu/ops/pallas/conv3d.py`` (``conv3x3x3``
and its custom VJP), in the JAX package's weight layout:
``x [N, Ci, Z, H, W]`` (f32 or bf16) and ``w [3, 3, 3, Ci, Co]`` give
``[N, Co, Z-2, H-2, W-2]`` in ``x``'s dtype, summed in f32, no bias.

:func:`conv3x3x3` is a ``torch.autograd.Function`` on any device:

- forward: the kernel on a CUDA tensor, :func:`conv3x3x3_plain` on a CPU one;
- dx: the same on the cotangent zero-padded by 2, with the weights flipped in
  space and Ci, Co swapped (a stride-1 transposed convolution);
- dw: :func:`wgrad`, 27 whole-volume contractions in f32 (torch matmuls,
  TF32 off), as the JAX package leaves ``_wgrad_xla`` to XLA.

So the CPU tests run the Function's own dx and dw formulas. On a CUDA tensor
the wrapper launches the kernel or raises; there is no fallback.

``fwd_launches`` and ``dgrad_launches`` count kernel launches of the forward
and of the input gradient; :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from ... import native

SOURCE = native.PKG / "csrc" / "conv3d.cu"

fwd_launches = 0
dgrad_launches = 0

_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    global fwd_launches, dgrad_launches
    fwd_launches = 0
    dgrad_launches = 0


def build() -> Path:
    """Compile ``csrc/conv3d.cu`` into ``_build/`` and return its path."""
    return native.build_cuda(SOURCE, "conv3d")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3x3.argtypes = [ptr, ptr, ptr] + [i32] * 7 + [ptr]
        lib.conv3x3x3.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 5 or min(x.shape[2:]) < 3:
        raise ValueError(f"K3 takes x [N, Ci, Z, H, W] with every spatial size >= 3, "
                         f"got {tuple(x.shape)}")
    if w.ndim != 5 or tuple(w.shape[:4]) != (3, 3, 3, x.shape[1]):
        raise ValueError(f"K3 needs w [3, 3, 3, {x.shape[1]}, Co], got {tuple(w.shape)}")


def conv_launch(x: torch.Tensor, w: torch.Tensor, dgrad: bool = False) -> torch.Tensor:
    """Launch the kernel on ``x [N, Ci, Z, H, W]`` (contiguous, CUDA, f32 or
    bf16) with ``w [3, 3, 3, Ci, Co]``; counts a forward or a dgrad launch."""
    global fwd_launches, dgrad_launches
    _check_shapes(x, w)
    if x.dtype not in _DTYPES:
        raise TypeError(f"K3 takes float32 or bfloat16 x, got {x.dtype}")
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("K3 needs x and w on the same CUDA device")
    if not x.is_contiguous():
        raise ValueError("K3 needs a contiguous x")
    N, Ci, Z, H, W = x.shape
    Co = w.shape[-1]
    w27 = w.to(torch.float32).reshape(27, Ci, Co).contiguous()
    out = torch.empty((N, Co, Z - 2, H - 2, W - 2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().conv3x3x3(x.data_ptr(), w27.data_ptr(), out.data_ptr(), N, Ci, Co,
                              Z, H, W, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc} (x {tuple(x.shape)}, "
                           f"Co {Co})")
    if dgrad:
        dgrad_launches += 1
    else:
        fwd_launches += 1
    return out


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: ``F.conv3d`` in f32 on the weights
    permuted to ``[Co, Ci, 3, 3, 3]``, rounded once to ``x``'s dtype. (On the
    card it runs in cuDNN, full f32 only with ``torch.backends.cudnn.
    allow_tf32 = False``, which ``models/attention_unet.py`` sets.)"""
    _check_shapes(x, w)
    wt = w.to(torch.float32).permute(4, 3, 0, 1, 2)
    return F.conv3d(x.to(torch.float32), wt).to(x.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, dgrad: bool) -> torch.Tensor:
    if x.is_cuda:
        return conv_launch(x.contiguous(), w, dgrad)
    if x.device.type == "cpu":
        return conv3x3x3_plain(x, w)
    raise RuntimeError(f"K3 has no path for device {x.device}")


def wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw[dz, dy, dx, ci, co] = sum x[n, ci, z+dz, y+dy, x+dx] * g[n, co,
    z, y, x]`` in f32: one ``[Ci, M] @ [M, Co]`` matmul per tap (counterpart
    of ``_wgrad_xla``)."""
    N, Ci = x.shape[:2]
    Co, Zo, Ho, Wo = g.shape[1:]
    g2 = g.to(torch.float32).transpose(0, 1).reshape(Co, -1)
    taps = []
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                xs = x[:, :, dz:dz + Zo, dy:dy + Ho, dx:dx + Wo].to(torch.float32)
                taps.append(xs.transpose(0, 1).reshape(Ci, -1) @ g2.T)
    return torch.stack(taps).reshape(3, 3, 3, Ci, Co)


class _Conv3x3x3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w, dgrad=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gp = F.pad(g, (2, 2) * 3)
            w_t = w.flip((0, 1, 2)).transpose(3, 4)
            dx = _conv(gp, w_t.to(gp.dtype), dgrad=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = wgrad(x, g).to(w.dtype)
        return dx, dw


def conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid 3x3x3 convolution ``[N, Ci, Z, H, W] x [3, 3, 3, Ci, Co] ->
    [N, Co, Z-2, H-2, W-2]``, differentiable in both operands."""
    _check_shapes(x, w)
    return _Conv3x3x3.apply(x, w)
