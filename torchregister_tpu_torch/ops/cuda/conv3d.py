"""K3: the 3x3x3 convolution kernel and its weight-gradient kernel
(``csrc/conv3d.cu``), their autograd Function and their plain versions.

Counterpart of ``torchregister_tpu/ops/pallas/conv3d.py`` (``conv3x3x3``
and its custom VJP), in the JAX package's weight layout:
``x [N, Ci, Z, H, W]`` (f32 or bf16) and ``w [3, 3, 3, Ci, Co]`` give
``[N, Co, Z-2, H-2, W-2]`` in ``x``'s dtype, summed in f32, no bias.

:func:`conv3x3x3` is a ``torch.autograd.Function`` on any device:

- forward: the kernel with padding 0 on a CUDA tensor,
  :func:`conv3x3x3_plain` on a CPU one;
- dx: the same with padding 2 (reads outside the cotangent are zero), with
  the weights flipped in space and Ci, Co swapped (a stride-1 transposed
  convolution);
- dw: the weight-gradient kernel on a CUDA tensor, :func:`wgrad_plain` (27
  whole-volume contractions in f32, as the JAX package leaves
  ``_wgrad_xla`` to XLA) on a CPU one.

So the CPU tests run the Function's own dx and dw formulas. On a CUDA tensor
each wrapper launches its kernel or raises; there is no fallback.

A weight set per item: ``w [N, 3, 3, 3, Ci, Co]`` convolves item n of ``x``
with set n (the U-Net cohort, where each pair trains its own net: the JAX
package's ``vmap`` of the Pallas kernel over a batched weight operand), and
its gradient is each item's own ``dw [N, 3, 3, 3, Ci, Co]``. On the card
that is one launch of each kernel, each item's result equal to a launch on
that item alone to the bit; the plain versions loop over the items.

``fwd_launches``, ``dgrad_launches`` and ``wgrad_launches`` count kernel
launches of the forward, the input gradient and the weight gradient, a
launch with a weight set per item among them; ``fwd_pairs_launches``,
``dgrad_pairs_launches`` and ``wgrad_pairs_launches`` count those alone.
:func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ... import native

SOURCE = native.PKG / "csrc" / "conv3d.cu"

fwd_launches = 0
dgrad_launches = 0
wgrad_launches = 0
fwd_pairs_launches = 0
dgrad_pairs_launches = 0
wgrad_pairs_launches = 0
native.count_launches(__name__, "fwd_launches", "dgrad_launches", "wgrad_launches",
                      "fwd_pairs_launches", "dgrad_pairs_launches", "wgrad_pairs_launches")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the weight gradient's blocks: two on each of the H100's 132 SMs
WGRAD_BLOCKS = 264
# csrc/conv3d.cu: a weight-gradient block takes 8 input channels and up to
# 32 output channels, and walks output tiles of 4 rows by 32 x (the split only
# balances the blocks: the kernel works out each block's range itself)
_WGRAD_CI, _WGRAD_CO, _WGRAD_TILE = 8, 32, (4, 32)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = native.Library(SOURCE, "conv3d", {"conv3x3x3": (_I, [_P] * 3 + [_I] * 9 + [_P]),
                                        "conv3x3x3_wgrad": (_I, [_P] * 4 + [_I] * 9 + [_P])})


def reset_counts() -> None:
    global fwd_launches, dgrad_launches, wgrad_launches
    global fwd_pairs_launches, dgrad_pairs_launches, wgrad_pairs_launches
    fwd_launches = dgrad_launches = wgrad_launches = 0
    fwd_pairs_launches = dgrad_pairs_launches = wgrad_pairs_launches = 0


def _check_shapes(x: torch.Tensor, w: torch.Tensor, pad: int = 0) -> None:
    if pad not in (0, 2):
        raise ValueError(f"K3 takes padding 0 (forward) or 2 (input gradient), got {pad}")
    least = 3 if pad == 0 else 1
    if x.ndim != 5 or min(x.shape[2:]) < least:
        raise ValueError(f"K3 takes x [N, Ci, Z, H, W] with every spatial size >= {least}, "
                         f"got {tuple(x.shape)}")
    lead = (x.shape[0],) if w.ndim == 6 else ()
    if w.ndim not in (5, 6) or tuple(w.shape[:-1]) != lead + (3, 3, 3, x.shape[1]):
        raise ValueError(f"K3 needs w [3, 3, 3, {x.shape[1]}, Co] or a set per item "
                         f"[{x.shape[0]}, 3, 3, 3, {x.shape[1]}, Co], got {tuple(w.shape)}")


def _check_cuda(name: str, x: torch.Tensor, other: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 x, got {x.dtype}")
    if not (x.is_cuda and other.is_cuda and x.device == other.device):
        raise ValueError(f"{name} needs its operands on the same CUDA device")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")


def conv_launch(x: torch.Tensor, w: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Launch the kernel on ``x [N, Ci, Z, H, W]`` (contiguous, CUDA, f32 or
    bf16) with ``w [3, 3, 3, Ci, Co]`` (or a set per item, ``[N, 3, 3, 3, Ci,
    Co]``) and ``pad`` voxels of zeros around ``x``; counts a forward
    (``pad=0``) or a dgrad (``pad=2``) launch. bf16 ``x`` with weights of
    another dtype runs the f32 path on ``x`` widened (exact) and rounds the
    output once."""
    global fwd_launches, dgrad_launches, fwd_pairs_launches, dgrad_pairs_launches
    _check_shapes(x, w, pad)
    _check_cuda("K3", x, w)
    if x.dtype == torch.bfloat16 and w.dtype != torch.bfloat16:
        return conv_launch(x.float(), w, pad).to(x.dtype)
    N, Ci, Z, H, W = x.shape
    Co = w.shape[-1]
    per_pair = w.ndim == 6
    wk = w.to(x.dtype).reshape(w.shape[:-5] + (27, Ci, Co)).contiguous()
    out = torch.empty((N, Co) + tuple(s - 2 + 2 * pad for s in (Z, H, W)), dtype=x.dtype,
                      device=x.device)
    LIB.launch("conv3x3x3", x, x.data_ptr(), wk.data_ptr(), out.data_ptr(), N, Ci, Co, Z, H, W,
               pad, int(per_pair), _DTYPES[x.dtype])
    if pad:
        dgrad_launches += 1
        dgrad_pairs_launches += per_pair
    else:
        fwd_launches += 1
        fwd_pairs_launches += per_pair
    return out


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3: ``F.conv3d`` in f32 on the weights
    permuted to ``[Co, Ci, 3, 3, 3]``, with ``pad`` voxels of zeros, rounded
    once to ``x``'s dtype; with a weight set per item, one call an item.
    (On the card it runs in cuDNN, full f32 only with
    ``torch.backends.cudnn.allow_tf32 = False``, which
    ``models/attention_unet.py`` sets.)"""
    _check_shapes(x, w, pad)
    if w.ndim == 6:
        return torch.cat([conv3x3x3_plain(x[n:n + 1], w[n], pad) for n in range(x.shape[0])])
    wt = w.to(torch.float32).permute(4, 3, 0, 1, 2)
    return F.conv3d(x.to(torch.float32), wt, padding=pad).to(x.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    if x.is_cuda:
        return conv_launch(x.contiguous(), w, pad)
    if x.device.type == "cpu":
        return conv3x3x3_plain(x, w, pad)
    raise RuntimeError(f"K3 has no path for device {x.device}")


def _check_wgrad_shapes(x: torch.Tensor, g: torch.Tensor) -> None:
    if (x.ndim != 5 or g.ndim != 5 or min(x.shape[2:]) < 3 or g.shape[0] != x.shape[0]
            or tuple(g.shape[2:]) != tuple(s - 2 for s in x.shape[2:])):
        raise ValueError(f"K3's weight gradient takes x [N, Ci, Z, H, W] (every spatial "
                         f"size >= 3) and g [N, Co, Z-2, H-2, W-2], got {tuple(x.shape)} "
                         f"and {tuple(g.shape)}")


def wgrad_splits(N: int, Ci: int, Co: int, Z: int, H: int, W: int) -> int:
    """The weight-gradient kernel's blocks along the voxels: about
    ``WGRAD_BLOCKS`` in all, never more than the output tiles."""
    ty, tx = _WGRAD_TILE
    tiles = N * (Z - 2) * -(-(H - 2) // ty) * -(-(W - 2) // tx)
    per_chunk = min(_WGRAD_CO, 8 * -(-Co // 8))
    chunks = -(-Ci // _WGRAD_CI) * -(-Co // per_chunk)
    return max(1, min(tiles, WGRAD_BLOCKS // chunks))


def wgrad_launch(x: torch.Tensor, g: torch.Tensor, per_pair: bool = False) -> torch.Tensor:
    """Launch the weight-gradient kernel: ``dw [3, 3, 3, Ci, Co]`` in f32 of
    ``x [N, Ci, Z, H, W]`` and ``g [N, Co, Z-2, H-2, W-2]`` (contiguous, CUDA,
    both f32 or both bf16), summed over the N items, or with ``per_pair``
    each item's own, ``[N, 3, 3, 3, Ci, Co]`` (each split as a launch on that
    item alone splits it); counts a wgrad launch."""
    global wgrad_launches, wgrad_pairs_launches
    _check_wgrad_shapes(x, g)
    _check_cuda("K3's weight gradient", x, g)
    if g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"K3's weight gradient needs a contiguous g of x's dtype "
                         f"{x.dtype}, got {g.dtype}")
    N, Ci, Z, H, W = x.shape
    Co = g.shape[1]
    lead = (N,) if per_pair else ()
    splits = wgrad_splits(1 if per_pair else N, Ci, Co, Z, H, W)
    ws = torch.empty(lead + (splits, 27, Ci, Co), dtype=torch.float32, device=x.device)
    dw = torch.empty(lead + (3, 3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    LIB.launch("conv3x3x3_wgrad", x, x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
               N, Ci, Co, Z, H, W, splits, int(per_pair), _DTYPES[x.dtype])
    wgrad_launches += 1
    wgrad_pairs_launches += per_pair
    return dw


def wgrad_plain(x: torch.Tensor, g: torch.Tensor, per_pair: bool = False) -> torch.Tensor:
    """``dw[dz, dy, dx, ci, co] = sum x[n, ci, z+dz, y+dy, x+dx] * g[n, co,
    z, y, x]`` in f32: one ``[Ci, M] @ [M, Co]`` matmul per tap (counterpart
    of ``_wgrad_xla``); with ``per_pair`` each item's own, stacked."""
    _check_wgrad_shapes(x, g)
    if per_pair:
        return torch.stack([wgrad_plain(x[n:n + 1], g[n:n + 1]) for n in range(x.shape[0])])
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


def _wgrad(x: torch.Tensor, g: torch.Tensor, per_pair: bool = False) -> torch.Tensor:
    if x.is_cuda:
        return wgrad_launch(x.contiguous(), g.contiguous(), per_pair)
    if x.device.type == "cpu":
        return wgrad_plain(x, g, per_pair)
    raise RuntimeError(f"K3's weight gradient has no path for device {x.device}")


class _Conv3x3x3(torch.autograd.Function):
    """Differentiable once: a second derivative through it raises."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w, 0)

    @staticmethod
    @native.differentiable_once
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the spatial axes and Ci, Co of [(N,) 3, 3, 3, Ci, Co]
            w_t = w.flip((-5, -4, -3)).transpose(-2, -1)
            dx = _conv(g, w_t.to(g.dtype), 2).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _wgrad(x, g, w.ndim == 6).to(w.dtype)
        return dx, dw


def conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid 3x3x3 convolution ``[N, Ci, Z, H, W] x [3, 3, 3, Ci, Co] ->
    [N, Co, Z-2, H-2, W-2]``, differentiable in both operands; ``w [N, 3, 3,
    3, Ci, Co]`` convolves each item with its own weights."""
    _check_shapes(x, w)
    return _Conv3x3x3.apply(x, w)
