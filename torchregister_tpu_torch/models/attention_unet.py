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

Pair mode (``pairs=B``, the U-Net cohort: the JAX package's ``vmap`` of
``model.apply`` over stacked parameters): every weight carries a leading
pair axis and item b of ``x [B, in_c, *S]`` runs through weight set b. The
3D 3x3x3 convolutions take the sets in one launch of K3 (a weight set per
item). Every op that reduces within an item, forward or backward (the
instance norms, the bias adds, whose gradient sums over the volume, the
attention gates, the other convolutions, the transposed convolutions, the
flow head) runs one torch call a pair on that pair's slice, so each pair
sums in a single net's order and equals it to the bit on the card as on
the CPU (torch's CUDA reductions pick their thread layout from the number
of outputs); the elementwise ops, pooling, padding and concatenation run on
the batch. ``pairs=None`` (the default) is the single net, no pair axis.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.conv3d import conv3x3x3
from ..ops.pad import pad_spatial
from ..ops.resize import axis_nearest_resize, axis_take

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


def _param(pairs: int | None, *shape: int) -> nn.Parameter:
    lead = () if pairs is None else (pairs,)
    return nn.Parameter(torch.zeros(lead + shape, dtype=torch.float32))


def _per_pair(pairs: int | None, fn, x: torch.Tensor, *ws: torch.Tensor):
    """``fn(x, *ws)``; in pair mode ``fn`` on each item of ``x`` with its own
    slice of each of ``ws`` (leading pair axis), the items' results (a
    tensor or a tuple of them) concatenated. A reduction over an item (a
    norm's moments, a bias's gradient) then has a single net's shape, so
    each pair sums in a single net's order on the card too."""
    if pairs is None:
        return fn(x, *ws)
    outs = [fn(x[b:b + 1], *(w[b] for w in ws)) for b in range(x.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


class TapConv(nn.Module):
    """Valid k^d convolution with bias (flax ``nn.Conv`` layout). A 3D 3x3x3
    convolution runs K3 (``conv3x3x3``; in pair mode one launch, a weight
    set per item); any other is ``F.conv{d}d``."""

    def __init__(self, cin: int, features: int, ndim: int, ksize: int = 3,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 pairs: int | None = None):
        super().__init__()
        self.ndim, self.ksize, self.dtype, self.pairs = ndim, ksize, dtype, pairs
        self.kernel = _param(pairs, *((ksize,) * ndim + (cin, features)))
        self.bias = _param(pairs, features) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        kernel = self.kernel.to(self.dtype)
        if self.ndim == 3 and self.ksize == 3:
            out = conv3x3x3(x, kernel)
        else:
            conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[self.ndim]
            perm = (self.ndim + 1, self.ndim) + tuple(range(self.ndim))
            out = _per_pair(self.pairs, lambda xb, kb: conv(xb, kb.permute(perm)), x, kernel)
        if self.bias is not None:
            out = _per_pair(self.pairs, lambda o, b: o + _bcast(b, self.ndim), out,
                            self.bias.to(self.dtype))
        return out


class TapConvTranspose2x(nn.Module):
    """ConvTranspose(k=2, s=2), ``y[2i+d] = sum_ci x[i] W[d]`` (flax
    ``nn.ConvTranspose`` layout ``[*k, Ci, Co]``)."""

    def __init__(self, cin: int, features: int, ndim: int,
                 dtype: torch.dtype = torch.float32, pairs: int | None = None):
        super().__init__()
        self.ndim, self.dtype, self.pairs = ndim, dtype, pairs
        self.kernel = _param(pairs, *((2,) * ndim + (cin, features)))
        self.bias = _param(pairs, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_t = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
                  3: F.conv_transpose3d}[self.ndim]
        perm = (self.ndim, self.ndim + 1) + tuple(range(self.ndim))

        def one(xb, kb, bb):
            return conv_t(xb, kb.permute(perm), stride=2) + _bcast(bb, self.ndim)
        return _per_pair(self.pairs, one, x.to(self.dtype), self.kernel.to(self.dtype),
                         self.bias.to(self.dtype))


class DoubleConv(nn.Module):
    """(Conv k3 valid -> ReLU -> InstanceNorm) x2 (utils.py:414-415)."""

    def __init__(self, cin: int, features: int, ndim: int, use_norm: bool = True,
                 dtype: torch.dtype = torch.float32, pairs: int | None = None):
        super().__init__()
        self.use_norm, self.pairs = use_norm, pairs
        self.Conv_0 = TapConv(cin, features, ndim, dtype=dtype, pairs=pairs)
        self.Conv_1 = TapConv(features, features, ndim, dtype=dtype, pairs=pairs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.Conv_0, self.Conv_1):
            x = F.relu(conv(x))
            if self.use_norm:
                x = _per_pair(self.pairs, instance_norm, x)
        return x


class UpBlock(nn.Module):
    """ConvTranspose(k2, s2) -> ReLU -> InstanceNorm (utils.py:441)."""

    def __init__(self, cin: int, features: int, ndim: int, use_norm: bool = True,
                 dtype: torch.dtype = torch.float32, pairs: int | None = None):
        super().__init__()
        self.use_norm, self.pairs = use_norm, pairs
        self.TapConvTranspose2x_0 = TapConvTranspose2x(cin, features, ndim, dtype, pairs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.TapConvTranspose2x_0(x))
        return _per_pair(self.pairs, instance_norm, x) if self.use_norm else x


class AttentionGate(nn.Module):
    """Attention-gated skip (``attention_grid``, utils.py:368-406): a 1x1
    stride-3 conv on the skip input, a 1x1 conv on the gate,
    ``sigmoid(psi(relu(a + b)))`` upsampled (nearest) to the skip's size,
    multiplied in, instance-normed. Returns ``(gated, w)`` with the weight
    map ``w [N, *S]``."""

    def __init__(self, cx: int, cg: int, inter: int, ndim: int, stride: int = 3,
                 dtype: torch.dtype = torch.float32, pairs: int | None = None):
        super().__init__()
        self.ndim, self.stride, self.dtype, self.pairs = ndim, stride, dtype, pairs
        self.input_kernel = _param(pairs, cx, inter)
        self.gate_kernel = _param(pairs, cg, inter)
        self.gate_bias = _param(pairs, inter)
        self.psi_kernel = _param(pairs, inter, 1)
        self.psi_bias = _param(pairs, 1)

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        ws = tuple(w.to(self.dtype) for w in (self.input_kernel, self.gate_kernel,
                                               self.gate_bias, self.psi_kernel, self.psi_bias))
        if self.pairs is None:
            return self._gate(x, g, *ws)
        # the gate signal g is one item a pair, as x is
        return _per_pair(self.pairs, lambda xb, gb, *wb: self._gate(xb, gb[None], *wb), x, g,
                         *ws)

    def _gate(self, x, g, input_kernel, gate_kernel, gate_bias, psi_kernel, psi_bias):
        dt, nd = self.dtype, self.ndim
        sub = (slice(None), slice(None)) + (slice(None, None, self.stride),) * nd
        a = _contract_1x1(x[sub].to(dt), input_kernel)
        b = _contract_1x1(g.to(dt), gate_kernel) + _bcast(gate_bias, nd)
        # the reference compares only the last spatial dim (utils.py:395-399)
        # and pads the smaller tensor to the other's whole shape
        if a.shape[-1] < b.shape[-1]:
            a = pad_spatial(a, b.shape[2:], first_axis=2)
        elif a.shape[-1] > b.shape[-1]:
            b = pad_spatial(b, a.shape[2:], first_axis=2)
        w = torch.sigmoid(_contract_1x1(F.relu(a + b), psi_kernel)[:, 0] + psi_bias[0])
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
                 dtype: torch.dtype = torch.float32, pairs: int | None = None):
        super().__init__()
        if depth < 1:
            raise ValueError(f"AttentionUNet needs depth >= 1 (got {depth})")
        if pairs is not None and pairs < 1:
            raise ValueError(f"AttentionUNet needs pairs >= 1 or None (got {pairs})")
        self.ndim, self.in_c, self.n, self.depth = ndim, in_c, n, depth
        self.use_attention, self.use_norm, self.dtype = use_attention, use_norm, dtype
        self.pairs = pairs
        chans = level_channels(depth, n)
        args = dict(ndim=ndim, use_norm=use_norm, dtype=dtype, pairs=pairs)
        for i in range(depth):
            self.add_module(f"enc{i + 1}",
                            DoubleConv(in_c if i == 0 else chans[i - 1], chans[i], **args))
        self.bottleneck = DoubleConv(chans[depth - 1], chans[depth], **args)
        self.up0 = UpBlock(chans[depth], chans[depth - 1], **args)
        for j in range(depth - 1, -1, -1):
            if use_attention:
                self.add_module(f"skip{j + 1}", AttentionGate(chans[j], chans[j], chans[j],
                                                             ndim, dtype=dtype, pairs=pairs))
            self.add_module(f"dec{j + 1}", DoubleConv(2 * chans[j], chans[j], **args))
            if j > 0:
                self.add_module(f"up{depth - j}", UpBlock(chans[j], chans[j - 1], **args))
        self.out_kernel = _param(pairs, chans[0], ndim)
        self.out_bias = _param(pairs, ndim)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """flax ``lecun_normal`` kernels (fan_in = all but the output axis)
        and zero biases, drawn on the CPU from ``generator``. In pair mode
        the sets are drawn one pair after another, pair 0 first, each as a
        single net draws its weights; ``generator`` may also be a sequence of
        one generator a pair."""
        if self.pairs is None:
            self._draw(lambda p: p, generator)
            return
        gens = (list(generator) if isinstance(generator, (list, tuple))
                else [generator] * self.pairs)
        if len(gens) != self.pairs:
            raise ValueError(f"reset_parameters: {len(gens)} generators for {self.pairs} "
                             "pairs")
        for b, gen in enumerate(gens):
            self._draw(lambda p: p[b], gen)

    def _draw(self, part, generator) -> None:
        for name, p in self.named_parameters():
            p = part(p)
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
        utils.py:522). In pair mode ``x`` holds one item a pair."""
        if self.pairs is not None and x.shape[0] != self.pairs:
            raise ValueError(f"a U-Net of {self.pairs} weight sets runs {self.pairs} items, "
                             f"got {x.shape[0]}")
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
        flow = _per_pair(self.pairs, lambda yb, k, b: _contract_1x1(yb, k) + _bcast(
            b, self.ndim), y.to(torch.float32), self.out_kernel, self.out_bias)
        return (flow, tuple(atts)) if out_att else flow


# ------------------------------------------------------------------- slabs
# The net on a volume split into slabs along one spatial dim (the engine's
# ``space`` axis, ``engines/flow.py``): each layer on each slab's rows, the
# partitions derived layer by layer (``parallel/rows.py``). Every op is the
# single net's, on a slab's block or on a buffer of the rows it reads; a
# reduction over the volume (the instance norms' moments) adds each slab's
# f32 partial sums in ascending slab order, and each weight's gradient sums
# its slabs' copies in ascending slab order. The 3D 3x3x3 convolutions are
# K3 launches on each slab's buffer (its rows and the 2 after them). In pair
# mode (the U-Net cohort on a row of a ``data x space`` mesh) K3 takes every
# pair's weight set in one launch a slab, and every other op that reduces
# within an item (the bias adds, the norms, the transposed convolutions, the
# attention gates, the flow head) runs one call a pair on that pair's
# blocks, as the pair mode does unsharded, so each pair equals its single
# net on the same slabs to the bit.


def _tap_conv(x, kernel, bias, ndim, dtype, pairs=None):
    """:class:`TapConv`'s forward (k = 3) on a block (in pair mode a
    weight set per item)."""
    x, kernel = x.to(dtype), kernel.to(dtype)
    if ndim == 3:
        out = conv3x3x3(x, kernel)
    else:
        conv = {1: F.conv1d, 2: F.conv2d}[ndim]
        out = _per_pair(pairs, lambda xb, kb: conv(
            xb, kb.permute((ndim + 1, ndim) + tuple(range(ndim)))), x, kernel)
    return _per_pair(pairs, lambda o, b: o + _bcast(b.to(dtype), ndim), out, bias)


def _conv_t(x, kernel, bias, ndim, dtype):
    """:class:`TapConvTranspose2x`'s forward of one net on a block."""
    conv_t = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}[ndim]
    perm = (ndim, ndim + 1) + tuple(range(ndim))
    return conv_t(x.to(dtype), kernel.to(dtype).permute(perm), stride=2) + _bcast(
        bias.to(dtype), ndim)


def _pair_rows(y, b: int):
    """Pair ``b``'s blocks of a tensor split into slabs."""
    return y._replace(blocks=[blk[b:b + 1] for blk in y.blocks])


def _cat_rows(parts: list):
    """The pairs' tensors (alike split) as one, slab by slab."""
    return parts[0]._replace(blocks=[torch.cat([p.blocks[k] for p in parts])
                                     for k in range(len(parts[0].blocks))])


def _norm_rows(y, pairs=None, eps: float = 1e-5):
    """:func:`instance_norm` of a tensor split into slabs: the moments from
    each slab's f32 partial sums, added in ascending slab order (in pair
    mode each pair's own)."""
    from ..parallel import rows

    if pairs is not None:
        return _cat_rows([_norm_rows(_pair_rows(y, b), None, eps) for b in range(pairs)])
    axes = tuple(range(2, y.blocks[0].ndim))
    n = math.prod(y.shape()[2:])
    xf = [b.to(torch.float32) for b in y.blocks]
    mean = rows.total([torch.sum(b, dim=axes, keepdim=True) for b in xf]) / n
    mean2 = rows.total([torch.sum(b * b, dim=axes, keepdim=True) for b in xf]) / n
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps)
    return y._replace(blocks=[((b - mean.to(b.device)) * scale.to(b.device)).to(blk.dtype)
                              for b, blk in zip(xf, y.blocks)])


def _pad_rows(y, target_spatial, parts):
    """:func:`pad_spatial` (a centre pad or crop) of a tensor split into
    slabs to ``target_spatial``, laid out by ``parts``: a row shift along
    the split dim, the block's own pad or crop across it."""
    from ..parallel import rows

    split = y.dim - 2
    delta = target_spatial[split] - y.extent
    offset = -(delta // 2) if delta >= 0 else (-delta + 1) // 2
    y = rows.shift(y, offset, parts)
    return y.map(lambda k, b: pad_spatial(b, tuple(
        b.shape[2 + i] if i == split else t for i, t in enumerate(target_spatial)), 2))


def forward_slabs(net: AttentionUNet, x, weights: dict | None = None):
    """:meth:`AttentionUNet.forward` on a volume split into slabs (``x`` a
    ``parallel.rows.Rows`` of ``[N, in_c, *S]`` along a spatial dim, each
    block on its slab's device; in pair mode one item a pair): the flow
    ``[N, ndim, *S]`` laid out as ``x`` (see the section note). ``weights``
    gives each weight's copy a slab (``{name: [copy, ...]}``, a wider
    ``parallel.rows.replicate``'s share, whose backward then sums the
    copies); by default each weight is replicated over the slabs here."""
    from ..parallel import rows

    nd, dt, dim, P = net.ndim, net.dtype, x.dim, net.pairs
    if P is not None and x.shape()[0] != P:
        raise ValueError(f"a U-Net of {P} weight sets runs {P} items, got {x.shape()[0]}")
    devices = [b.device for b in x.blocks]
    W = weights if weights is not None else {
        name: rows.replicate(p, devices) for name, p in net.named_parameters()}

    def conv(y, prefix):
        kern, bias = W[prefix + ".kernel"], W[prefix + ".bias"]
        return rows.window(y, lambda k, b: F.relu(_tap_conv(b, kern[k], bias[k], nd, dt, P)),
                           3, 1, y.extent - 2)

    def double(y, name):
        for i in (0, 1):
            y = conv(y, f"{name}.Conv_{i}")
            if net.use_norm:
                y = _norm_rows(y, P)
        return y

    def up(y, name):
        kern, bias = (W[f"{name}.TapConvTranspose2x_0.{w}"] for w in ("kernel", "bias"))
        y = rows.local(y, lambda k, b: F.relu(_per_pair(
            P, lambda xb, kb, bb: _conv_t(xb, kb, bb, nd, dt), b, kern[k], bias[k])), 2)
        return _norm_rows(y, P) if net.use_norm else y

    def gate(x, g, name, pair=None):
        if P is not None and pair is None:
            return _cat_rows([gate(_pair_rows(x, b), _pair_rows(g, b), name, b)
                              for b in range(P)])
        ik, gk, gb, pk, pb = ([w if pair is None else w[pair] for w in W[f"{name}.{v}"]]
                              for v in ("input_kernel", "gate_kernel", "gate_bias",
                                        "psi_kernel", "psi_bias"))
        sub = (slice(None), slice(None)) + tuple(
            slice(None) if 2 + a == dim else slice(None, None, 3) for a in range(nd))
        a = rows.stride(x, 3).map(lambda k, b: _contract_1x1(b[sub].to(dt), ik[k].to(dt)))
        b = g.map(lambda k, t: _contract_1x1(t.to(dt), gk[k].to(dt))
                  + _bcast(gb[k].to(dt), nd))
        sa, sb = a.shape(), b.shape()
        # the reference compares only the last spatial dim and pads the
        # smaller tensor to the other's whole shape
        if sa[-1] < sb[-1]:
            a = _pad_rows(a, sb[2:], b.parts)
        elif sa[-1] > sb[-1]:
            b = _pad_rows(b, sa[2:], a.parts)
        else:
            a = rows.shift(a, 0, b.parts)
        w = rows.Rows([torch.sigmoid(_contract_1x1(F.relu(ab + bb), pk[k].to(dt))[:, 0]
                                     + pb[k].to(dt)[0])
                       for k, (ab, bb) in enumerate(zip(a.blocks, b.blocks))], b.parts, dim - 1)
        for axis, s_out in enumerate(x.shape()[2:]):
            if 2 + axis == dim:
                w = rows.resize(w, x.parts, lambda t, idx: axis_take(t, dim - 1, idx))
            else:
                w = w.map(lambda k, t, a=axis, s=s_out: axis_nearest_resize(t, 1 + a, s))
        gated = rows.Rows([xb * wb[:, None] for xb, wb in zip(x.blocks, w.blocks)], x.parts, dim)
        return _norm_rows(gated)

    in_spatial, in_parts = x.shape()[2:], x.parts
    y = x.map(lambda k, b: b.to(dt))
    skips = []
    for i in range(net.depth):
        y = double(y, f"enc{i + 1}")
        skips.append(y)
        y = rows.window(y, lambda k, b: _max_pool_cf(b), 2, 2, y.extent // 2)
    y = up(double(y, "bottleneck"), "up0")
    for j in range(net.depth - 1, -1, -1):
        gated = gate(skips[j], y, f"skip{j + 1}") if net.use_attention else skips[j]
        y = _pad_rows(y, gated.shape()[2:], gated.parts)
        y = double(rows.Rows([torch.cat([gb, yb.to(gb.dtype)], dim=1)
                              for gb, yb in zip(gated.blocks, y.blocks)], gated.parts, dim),
                   f"dec{j + 1}")
        if j > 0:
            y = up(y, f"up{net.depth - j}")
    y = _pad_rows(y, in_spatial, in_parts)
    ok, ob = W["out_kernel"], W["out_bias"]
    return y.map(lambda k, b: _per_pair(P, lambda yb, kb, bb: _contract_1x1(
        yb.to(torch.float32), kb) + _bcast(bb, nd), b, ok[k], ob[k]))
