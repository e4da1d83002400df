"""Stacked-hourglass image encoder.

Counterpart of ``chore_tpu/models/hourglass.py``: recursive U-modules with
avg-pool down / bicubic align-corners up, a 7x7 stride-2 stem with
ConvBlocks and an avg-pool, then ``num_stack`` hourglasses with
intermediate outputs and residual re-injection. NCHW throughout; module
names are the reference torch names (``m{i}``, ``b1_{lv}``, ``top_m_{i}``,
``conv_last{i}``, ``bn_end{i}``, ``l{i}``, ``bl{i}``, ``al{i}``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chore_tpu_torch.models.layers import (
    ConvBlock,
    avg_pool_2x,
    bicubic_upsample_2x,
    conv,
    group_norm,
    norm,
)


class HourGlass(nn.Module):
    """Recursive U-module of depth ``depth`` at ``features`` channels."""

    def __init__(self, depth, features, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        self._interp = {}  # bf16 interpolation matrices on the device
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(features, features, dtype))
            self.add_module(f"b2_{lv}", ConvBlock(features, features, dtype))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}",
                                ConvBlock(features, features, dtype))
            self.add_module(f"b3_{lv}", ConvBlock(features, features, dtype))

    def _level(self, lv, inp):
        up1 = self._modules[f"b1_{lv}"](inp)
        low1 = self._modules[f"b2_{lv}"](avg_pool_2x(inp))
        if lv > 1:
            low2 = self._level(lv - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{lv}"](low1)
        low3 = self._modules[f"b3_{lv}"](low2)
        return up1 + bicubic_upsample_2x(low3, self._interp)

    def forward(self, x):
        return self._level(self.depth, x)


class HGFilter(nn.Module):
    """Stem + ``num_stack`` hourglass stages. Release: 5 stacks, depth 2,
    256 features, 5-channel input. ``dtype`` is every conv's compute dtype
    (bfloat16 in the release "mixed" precision); norms run in float32.
    ``remat``: each hourglass keeps only its input for the backward pass
    and recomputes the rest there (``chore_tpu``'s ``nn.remat``; less
    activation memory for about a third more encoder work).
    ``grouped_heads``: the HGFilterGConv variant (unused by the release
    config): each stack's head ``l{i}`` and re-injection convs
    ``bl{i}``/``al{i}`` are grouped 1x1 convs with one group per feature
    channel; ``out_dim`` must be a multiple of ``features``."""

    def __init__(self, num_stack=5, depth=2, features=256, out_dim=256,
                 in_channels=5, dtype=torch.float32, remat=False,
                 grouped_heads=False):
        super().__init__()
        if grouped_heads and out_dim % features:
            raise ValueError(
                "grouped_heads requires out_dim % features == 0 "
                f"(got {out_dim} % {features})")
        groups = features if grouped_heads else 1
        self.num_stack = num_stack
        self.dtype = dtype
        self.remat = remat
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = group_norm(64)
        self.conv2 = ConvBlock(64, 128, dtype)
        self.conv3 = ConvBlock(128, 128, dtype)
        self.conv4 = ConvBlock(128, features, dtype)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(depth, features, dtype))
            self.add_module(f"top_m_{i}", ConvBlock(features, features, dtype))
            self.add_module(f"conv_last{i}", nn.Conv2d(features, features, 1))
            self.add_module(f"bn_end{i}", group_norm(features))
            self.add_module(f"l{i}", nn.Conv2d(features, out_dim, 1,
                                               groups=groups))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", nn.Conv2d(features, features, 1,
                                                    groups=groups))
                self.add_module(f"al{i}", nn.Conv2d(out_dim, features, 1,
                                                    groups=groups))

    def forward(self, x, train=True):
        """x (B, C, H, W) -> (outputs list, tmpx, normx), NCHW; eval
        (``train=False``) keeps only the last stack's output. Under bf16
        the outputs and normx are bf16, tmpx (after a norm) float32."""
        dt = self.dtype
        x = F.relu(norm(self.bn1, conv(self.conv1, x, dt)))
        tmpx = x
        x = avg_pool_2x(self.conv2(x))
        normx = x
        x = self.conv4(self.conv3(x))
        previous = x
        outputs = []
        m = self._modules
        for i in range(self.num_stack):
            if self.remat and torch.is_grad_enabled():
                hg = checkpoint(m[f"m{i}"], previous, use_reentrant=False)
            else:
                hg = m[f"m{i}"](previous)
            ll = conv(m[f"conv_last{i}"], m[f"top_m_{i}"](hg), dt)
            ll = F.relu(norm(m[f"bn_end{i}"], ll))
            tmp_out = conv(m[f"l{i}"], ll, dt)
            outputs.append(tmp_out)
            if i < self.num_stack - 1:
                previous = (previous + conv(m[f"bl{i}"], ll, dt)
                            + conv(m[f"al{i}"], tmp_out, dt))
        if not train:
            outputs = outputs[-1:]
        return outputs, tmpx.detach(), normx
