"""Building blocks of the stacked-hourglass encoder.

Counterpart of ``chore_tpu/models/layers.py``, in NCHW inside. Module and
parameter names follow the reference torch code that
``chore_tpu/train/torch_import.py`` maps from (``bn1``, ``conv1``, ...,
``downsample.2``), so a reference checkpoint loads with ``load_state_dict``.

Mixed precision casts where ``chore_tpu``'s flax modules cast: a conv of
compute dtype ``dtype`` (``nn.Conv(dtype=...)``) casts its input, weight and
bias to it and returns it; GroupNorm computes in float32 and returns
float32 (flax promotes to its f32 parameters); sums follow type promotion
(bf16 + f32 -> f32, as in jnp). Parameters are always float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def group_norm(num_channels):
    """GroupNorm(min(32, C), C), eps 1e-5."""
    return nn.GroupNorm(min(32, num_channels), num_channels, eps=1e-5)


def conv3x3(in_planes, out_planes):
    return nn.Conv2d(in_planes, out_planes, 3, stride=1, padding=1,
                     bias=False)


def conv(m, x, dtype=torch.float32):
    """``m(x)`` computed in ``dtype``: input, weight and bias cast to it, the
    result in it (the casts are no-ops at float32)."""
    bias = None if m.bias is None else m.bias.to(dtype)
    return F.conv2d(x.to(dtype), m.weight.to(dtype), bias, m.stride,
                    m.padding, m.dilation, m.groups)


def norm(m, x):
    """GroupNorm ``m`` in float32 (returns float32)."""
    return m(x.float())


class ConvBlock(nn.Module):
    """3-branch dense residual block:
    out = cat(conv1(x), conv2(.), conv3(.)) + (x or 1x1-projected x), each
    conv preceded by norm + relu; channel split out/2 + out/4 + out/4.

    ``bn4`` exists in every block, as in the reference constructor, but only
    blocks that change width use it (through ``downsample``, which shares
    it as ``downsample.0``)."""

    def __init__(self, in_planes, out_planes, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        half, quarter = out_planes // 2, out_planes // 4
        self.conv1 = conv3x3(in_planes, half)
        self.conv2 = conv3x3(half, quarter)
        self.conv3 = conv3x3(quarter, quarter)
        self.bn1 = group_norm(in_planes)
        self.bn2 = group_norm(half)
        self.bn3 = group_norm(quarter)
        self.bn4 = group_norm(in_planes)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(
                self.bn4, nn.ReLU(),
                nn.Conv2d(in_planes, out_planes, 1, stride=1, bias=False))

    def forward(self, x):
        dt = self.dtype
        out1 = conv(self.conv1, F.relu(norm(self.bn1, x)), dt)
        out2 = conv(self.conv2, F.relu(norm(self.bn2, out1)), dt)
        out3 = conv(self.conv3, F.relu(norm(self.bn3, out2)), dt)
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x
        if self.downsample is not None:
            residual = conv(self.downsample[2],
                            F.relu(norm(self.downsample[0], x)), dt)
        return out + residual


def _cubic_kernel(x, a=-0.75):
    """Keys cubic convolution kernel (the a=-0.75 variant torch uses)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache()
def bicubic_upsample_matrix(in_size, out_size):
    """(out, in) 1D bicubic align_corners=True interpolation matrix, edge
    pixels replicated (``chore_tpu``'s, copied)."""
    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        w[0, 0] = 1.0
        return w
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        fl = int(np.floor(src))
        t = src - fl
        idx = np.clip(np.array([fl - 1, fl, fl + 1, fl + 2]), 0, in_size - 1)
        wts = _cubic_kernel(np.array([-1.0, 0.0, 1.0, 2.0]) - t)
        for j, k in zip(idx, wts):
            w[i, j] += k
    return w


def bicubic_upsample_2x(x, cache=None):
    """NCHW bicubic x2 upsample with align_corners=True (a=-0.75, edge
    pixels replicated). Float32 maps go through ``F.interpolate``; a
    lower-precision map through ``chore_tpu``'s two interpolation matmuls
    with the matrices cast to its dtype (each matmul rounds to it).
    ``cache``: a dict keeping the matrices on the device per shape, dtype
    and device (a host-to-device copy each call would stall the stream)."""
    if x.dtype == torch.float32:
        return F.interpolate(x, scale_factor=2, mode="bicubic",
                             align_corners=True)
    H, W = x.shape[-2:]
    key = (H, W, x.dtype, x.device)
    mats = None if cache is None else cache.get(key)
    if mats is None:
        mats = tuple(torch.as_tensor(bicubic_upsample_matrix(n, 2 * n)).to(
            x.device, x.dtype) for n in (H, W))
        if cache is not None:
            cache[key] = mats
    wh, ww = mats
    x = torch.einsum("oh,bchw->bcow", wh, x)
    return torch.einsum("ow,bchw->bcho", ww, x)


def avg_pool_2x(x):
    """2x2 stride-2 average pool, NCHW."""
    return F.avg_pool2d(x, 2, 2)


def one_hot_ce(logits, labels):
    """Per-element softmax cross-entropy via a one-hot multiply.

    logits (..., C), labels (...) int -> (...) CE values. The one-hot is
    built with a compare, so a label outside [0, C) gives a zero row (and a
    zero loss), as ``jax.nn.one_hot`` does; ``F.one_hot`` would raise."""
    logp = F.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[..., None] == classes).to(logp.dtype)
    return -(logp * onehot).sum(-1)


def normal_init_(module, generator, std=0.02):
    """PIFu-style init, seeded: conv/linear weights ~ N(0, 0.02), biases 0,
    norm scales 1 (``chore_tpu``'s ``conv_init`` and flax defaults)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                w = torch.randn(m.weight.shape, generator=generator) * std
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module
