"""Stacked-hourglass image encoder.

Counterpart of ``chore_tpu/models/hourglass.py``: recursive U-modules with
avg-pool down / bicubic align-corners up, a 7x7 stride-2 stem with
ConvBlocks and an avg-pool, then ``num_stack`` hourglasses with
intermediate outputs and residual re-injection. NCHW throughout; module
names are the reference torch names (``m{i}``, ``b1_{lv}``, ``top_m_{i}``,
``conv_last{i}``, ``bn_end{i}``, ``l{i}``, ``bl{i}``, ``al{i}``).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from chore_tpu_torch.models.layers import (
    ConvBlock,
    avg_pool_2x,
    bicubic_upsample_2x,
    group_norm,
)


class HourGlass(nn.Module):
    """Recursive U-module of depth ``depth`` at ``features`` channels."""

    def __init__(self, depth, features):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(features, features))
            self.add_module(f"b2_{lv}", ConvBlock(features, features))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}", ConvBlock(features, features))
            self.add_module(f"b3_{lv}", ConvBlock(features, features))

    def _level(self, lv, inp):
        up1 = self._modules[f"b1_{lv}"](inp)
        low1 = self._modules[f"b2_{lv}"](avg_pool_2x(inp))
        if lv > 1:
            low2 = self._level(lv - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{lv}"](low1)
        low3 = self._modules[f"b3_{lv}"](low2)
        return up1 + bicubic_upsample_2x(low3)

    def forward(self, x):
        return self._level(self.depth, x)


class HGFilter(nn.Module):
    """Stem + ``num_stack`` hourglass stages. Release: 5 stacks, depth 2,
    256 features, 5-channel input."""

    def __init__(self, num_stack=5, depth=2, features=256, out_dim=256,
                 in_channels=5):
        super().__init__()
        self.num_stack = num_stack
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = group_norm(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, features)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(depth, features))
            self.add_module(f"top_m_{i}", ConvBlock(features, features))
            self.add_module(f"conv_last{i}", nn.Conv2d(features, features, 1))
            self.add_module(f"bn_end{i}", group_norm(features))
            self.add_module(f"l{i}", nn.Conv2d(features, out_dim, 1))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", nn.Conv2d(features, features, 1))
                self.add_module(f"al{i}", nn.Conv2d(out_dim, features, 1))

    def forward(self, x, train=True):
        """x (B, C, H, W) -> (outputs list, tmpx, normx), NCHW; eval
        (``train=False``) keeps only the last stack's output."""
        x = F.relu(self.bn1(self.conv1(x)))
        tmpx = x
        x = avg_pool_2x(self.conv2(x))
        normx = x
        x = self.conv4(self.conv3(x))
        previous = x
        outputs = []
        m = self._modules
        for i in range(self.num_stack):
            hg = m[f"m{i}"](previous)
            ll = m[f"conv_last{i}"](m[f"top_m_{i}"](hg))
            ll = F.relu(m[f"bn_end{i}"](ll))
            tmp_out = m[f"l{i}"](ll)
            outputs.append(tmp_out)
            if i < self.num_stack - 1:
                previous = previous + m[f"bl{i}"](ll) + m[f"al{i}"](tmp_out)
        if not train:
            outputs = outputs[-1:]
        return outputs, tmpx.detach(), normx
