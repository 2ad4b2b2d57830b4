"""Attention U-Net flow-field model (counterpart of
``torchregister_tpu/models/attention_unet.py``; reference ``Attention_UNet``,
utils.py:409-559, and ``attention_grid``, utils.py:368-406).

Channel-first ``[N, C, *S]`` throughout. Parameters keep the flax layout and
names of the JAX package (conv kernels ``[*k, Ci, Co]``, 1x1 kernels
``[Ci, Co]``, keys such as ``enc1.Conv_0.kernel`` or ``skip1.input_kernel``),
so ``convert.unet_params`` carries a JAX parameter tree over unchanged.

Every 3D 3x3x3 convolution runs ``ops/cuda/conv3d.conv3x3x3``: kernel K3 on a
CUDA tensor, its plain version on a CPU one. The JAX package routes its
convolutions to the Pallas kernel only under ``use_pallas=True``; that gate is
a TPU matter (XLA fuses the tap path's backward there) and has no counterpart.
The 2D convolutions, the transposed convolution and the 1x1 contractions are
torch ops, as they are XLA ops in the JAX package. cuDNN's TF32 is switched
off at import (``torch.backends.cudnn.allow_tf32 = False``), as
``ops/transforms.py`` does for matmuls, so an f32 U-Net computes in f32, and
cuDNN is held to its deterministic algorithms
(``torch.backends.cudnn.deterministic = True``): the transposed
convolution's weight gradient may otherwise take one that sums with atomics,
and a U-Net run would not repeat to the bit.

``dtype`` is the compute dtype (parameters stay f32). Initial weights come
from :meth:`AttentionUNet.reset_parameters` with a ``torch.Generator``: flax's
``lecun_normal`` (a normal truncated at ±2σ, σ = sqrt(1/fan_in)/0.87962566)
and zero biases, drawn on the CPU so a seed gives the same weights on any
device (not the JAX package's numbers).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.conv3d import conv3x3x3
from ..ops.pad import pad_spatial
from ..ops.resize import axis_nearest_resize

torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

# flax's truncated-normal variance correction: the std of a standard normal
# truncated at ±2
_TRUNC_STD = 0.87962566103423978


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine InstanceNorm over the spatial axes of ``[N, C, *S]``: one-pass
    moments ``E[x²] - E[x]²`` clamped at 0, statistics in f32."""
    axes = tuple(range(2, x.ndim))
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=axes, keepdim=True)
    mean2 = torch.mean(xf * xf, dim=axes, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _max_pool_cf(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[x.ndim - 2]
    return pool(x, kernel_size=k, stride=k)


def _contract_1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pointwise channel contraction: x ``[N, Ci, *S]``, w ``[Ci, Co]`` ->
    ``[N, Co, *S]``."""
    return torch.einsum("nc...,co->no...", x, w)


def _bcast(b: torch.Tensor, ndim: int) -> torch.Tensor:
    return b.reshape((1, -1) + (1,) * ndim)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32))


class TapConv(nn.Module):
    """Valid k^d convolution with bias (flax ``nn.Conv`` layout). A 3D 3x3x3
    convolution runs K3 (``conv3x3x3``); any other is ``F.conv{d}d``."""

    def __init__(self, cin: int, features: int, ndim: int, ksize: int = 3,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ndim, self.ksize, self.dtype = ndim, ksize, dtype
        self.kernel = _param(*((ksize,) * ndim + (cin, features)))
        self.bias = _param(features) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        kernel = self.kernel.to(self.dtype)
        if self.ndim == 3 and self.ksize == 3:
            out = conv3x3x3(x, kernel)
        else:
            conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[self.ndim]
            perm = (self.ndim + 1, self.ndim) + tuple(range(self.ndim))
            out = conv(x, kernel.permute(perm))
        if self.bias is not None:
            out = out + _bcast(self.bias.to(self.dtype), self.ndim)
        return out


class TapConvTranspose2x(nn.Module):
    """ConvTranspose(k=2, s=2), ``y[2i+d] = sum_ci x[i] W[d]`` (flax
    ``nn.ConvTranspose`` layout ``[*k, Ci, Co]``)."""

    def __init__(self, cin: int, features: int, ndim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ndim, self.dtype = ndim, dtype
        self.kernel = _param(*((2,) * ndim + (cin, features)))
        self.bias = _param(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_t = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
                  3: F.conv_transpose3d}[self.ndim]
        perm = (self.ndim, self.ndim + 1) + tuple(range(self.ndim))
        y = conv_t(x.to(self.dtype), self.kernel.to(self.dtype).permute(perm), stride=2)
        return y + _bcast(self.bias.to(self.dtype), self.ndim)


class DoubleConv(nn.Module):
    """(Conv k3 valid -> ReLU -> InstanceNorm) x2 (utils.py:414-415)."""

    def __init__(self, cin: int, features: int, ndim: int, use_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_norm = use_norm
        self.Conv_0 = TapConv(cin, features, ndim, dtype=dtype)
        self.Conv_1 = TapConv(features, features, ndim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.Conv_0, self.Conv_1):
            x = F.relu(conv(x))
            if self.use_norm:
                x = instance_norm(x)
        return x


class UpBlock(nn.Module):
    """ConvTranspose(k2, s2) -> ReLU -> InstanceNorm (utils.py:441)."""

    def __init__(self, cin: int, features: int, ndim: int, use_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_norm = use_norm
        self.TapConvTranspose2x_0 = TapConvTranspose2x(cin, features, ndim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.TapConvTranspose2x_0(x))
        return instance_norm(x) if self.use_norm else x


class AttentionGate(nn.Module):
    """Attention-gated skip (``attention_grid``, utils.py:368-406): a 1x1
    stride-3 conv on the skip input, a 1x1 conv on the gate,
    ``sigmoid(psi(relu(a + b)))`` upsampled (nearest) to the skip's size,
    multiplied in, instance-normed. Returns ``(gated, w)`` with the weight
    map ``w [N, *S]``."""

    def __init__(self, cx: int, cg: int, inter: int, ndim: int, stride: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ndim, self.stride, self.dtype = ndim, stride, dtype
        self.input_kernel = _param(cx, inter)
        self.gate_kernel = _param(cg, inter)
        self.gate_bias = _param(inter)
        self.psi_kernel = _param(inter, 1)
        self.psi_bias = _param(1)

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        dt, nd = self.dtype, self.ndim
        sub = (slice(None), slice(None)) + (slice(None, None, self.stride),) * nd
        a = _contract_1x1(x[sub].to(dt), self.input_kernel.to(dt))
        b = _contract_1x1(g.to(dt), self.gate_kernel.to(dt)) + _bcast(
            self.gate_bias.to(dt), nd)
        # the reference compares only the last spatial dim (utils.py:395-399)
        # and pads the smaller tensor to the other's whole shape
        if a.shape[-1] < b.shape[-1]:
            a = pad_spatial(a, b.shape[2:], first_axis=2)
        elif a.shape[-1] > b.shape[-1]:
            b = pad_spatial(b, a.shape[2:], first_axis=2)
        w = torch.sigmoid(_contract_1x1(F.relu(a + b), self.psi_kernel.to(dt))[:, 0]
                          + self.psi_bias.to(dt)[0])
        for axis, s_out in enumerate(x.shape[2:]):
            w = axis_nearest_resize(w, 1 + axis, s_out)
        return instance_norm(x * w[:, None]), w


def level_channels(depth: int, n: float) -> list[int]:
    """Encoder channels ``int(64 * 2^i / n)`` for i in [0, depth], floored at
    1 (utils.py:414-441 with the ``n`` width divisor)."""
    return [max(1, int(64 * (2**i) / n)) for i in range(depth + 1)]


def conv3x3x3_shapes(edge: int, n: float, depth: int, in_c: int = 1) -> list:
    """``(Ci, Co, input edge)`` of every 3x3x3 convolution of the forward on a
    cube of ``edge`` voxels: each double conv eats 4 voxels, max pooling
    halves, a decoder level convolves at its skip's size."""
    ch = level_channels(depth, n)
    out, skips, s, c = [], [], edge, in_c
    for i in range(depth):
        out += [(c, ch[i], s), (ch[i], ch[i], s - 2)]
        s -= 4
        skips.append(s)
        s //= 2
        c = ch[i]
    out += [(c, ch[depth], s), (ch[depth], ch[depth], s - 2)]
    for j in range(depth - 1, -1, -1):
        out += [(2 * ch[j], ch[j], skips[j]), (ch[j], ch[j], skips[j] - 2)]
    return out


def max_depth_for(spatial: Sequence[int], max_depth: int = 4) -> int:
    """Deepest U-Net depth whose bottleneck double conv still sees >= 5 voxels
    per spatial dim (valid k3 convs eat 4; MaxPool halves with floor)."""
    depth = 0
    for d in range(1, max_depth + 1):
        sizes = list(spatial)
        ok = True
        for _ in range(d):
            sizes = [s - 4 for s in sizes]
            if min(sizes) < 2:
                ok = False
                break
            sizes = [s // 2 for s in sizes]
        if ok and min(sizes) >= 5:
            depth = d
    return depth


class AttentionUNet(nn.Module):
    """Flow-field U-Net: ``[N, in_c, *S]`` -> flow ``[N, ndim, *S]`` in voxels,
    channel ``i`` along spatial dim ``i``. ``depth=4`` is the reference
    topology."""

    def __init__(self, ndim: int, in_c: int = 1, n: float = 1, depth: int = 4,
                 use_attention: bool = True, use_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth < 1:
            raise ValueError(f"AttentionUNet needs depth >= 1 (got {depth})")
        self.ndim, self.in_c, self.n, self.depth = ndim, in_c, n, depth
        self.use_attention, self.use_norm, self.dtype = use_attention, use_norm, dtype
        chans = level_channels(depth, n)
        args = dict(ndim=ndim, use_norm=use_norm, dtype=dtype)
        for i in range(depth):
            self.add_module(f"enc{i + 1}",
                            DoubleConv(in_c if i == 0 else chans[i - 1], chans[i], **args))
        self.bottleneck = DoubleConv(chans[depth - 1], chans[depth], **args)
        self.up0 = UpBlock(chans[depth], chans[depth - 1], **args)
        for j in range(depth - 1, -1, -1):
            if use_attention:
                self.add_module(f"skip{j + 1}", AttentionGate(chans[j], chans[j], chans[j],
                                                             ndim, dtype=dtype))
            self.add_module(f"dec{j + 1}", DoubleConv(2 * chans[j], chans[j], **args))
            if j > 0:
                self.add_module(f"up{depth - j}", UpBlock(chans[j], chans[j - 1], **args))
        self.out_kernel = _param(chans[0], ndim)
        self.out_bias = _param(ndim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax ``lecun_normal`` kernels (fan_in = all but the output axis)
        and zero biases, drawn on the CPU from ``generator``."""
        for name, p in self.named_parameters():
            if name.split(".")[-1].endswith("bias"):
                p.zero_()
                continue
            fan_in = p.numel() // p.shape[-1]
            t = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

    def forward(self, x: torch.Tensor, out_att: bool = False):
        """``out_att=True`` also returns the decoder gates' weight maps,
        coarsest first (the reference's unused ``out_att`` flag,
        utils.py:522)."""
        in_spatial = x.shape[2:]
        y = x.to(self.dtype)
        skips, atts = [], []
        for i in range(self.depth):
            y = getattr(self, f"enc{i + 1}")(y)
            skips.append(y)
            y = _max_pool_cf(y)
        y = self.up0(self.bottleneck(y))
        for j in range(self.depth - 1, -1, -1):
            if self.use_attention:
                gated, att = getattr(self, f"skip{j + 1}")(skips[j], y)
                atts.append(att)
            else:
                gated = skips[j]
            y = pad_spatial(y, gated.shape[2:], first_axis=2)
            y = getattr(self, f"dec{j + 1}")(torch.cat([gated, y.to(gated.dtype)], dim=1))
            if j > 0:
                y = getattr(self, f"up{self.depth - j}")(y)
        y = pad_spatial(y, in_spatial, first_axis=2)
        # the flow head in f32: sub-voxel displacements
        flow = _contract_1x1(y.to(torch.float32), self.out_kernel) + _bcast(
            self.out_bias, self.ndim)
        return (flow, tuple(atts)) if out_att else flow
