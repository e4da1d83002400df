"""Building blocks of the stacked-hourglass encoder.

Counterpart of ``chore_tpu/models/layers.py``, in NCHW inside. Module and
parameter names follow the reference torch code that
``chore_tpu/train/torch_import.py`` maps from (``bn1``, ``conv1``, ...,
``downsample.2``), so a reference checkpoint loads with ``load_state_dict``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def group_norm(num_channels):
    """GroupNorm(min(32, C), C), eps 1e-5."""
    return nn.GroupNorm(min(32, num_channels), num_channels, eps=1e-5)


def conv3x3(in_planes, out_planes):
    return nn.Conv2d(in_planes, out_planes, 3, stride=1, padding=1,
                     bias=False)


class ConvBlock(nn.Module):
    """3-branch dense residual block:
    out = cat(conv1(x), conv2(.), conv3(.)) + (x or 1x1-projected x), each
    conv preceded by norm + relu; channel split out/2 + out/4 + out/4.

    ``bn4`` exists in every block, as in the reference constructor, but only
    blocks that change width use it (through ``downsample``, which shares
    it as ``downsample.0``)."""

    def __init__(self, in_planes, out_planes):
        super().__init__()
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
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


def bicubic_upsample_2x(x):
    """NCHW bicubic x2 upsample with align_corners=True (a=-0.75, edge
    pixels replicated) -- what ``chore_tpu``'s explicit interpolation
    matrices reproduce."""
    return F.interpolate(x, scale_factor=2, mode="bicubic",
                         align_corners=True)


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
