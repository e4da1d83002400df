"""Pixel-aligned bilinear feature sampling.

Counterpart of ``chore_tpu/ops/grid_sample.py``: ``F.grid_sample`` with
``align_corners=True`` and zero padding (-1 -> pixel 0 centre, +1 -> pixel
W-1 centre; out-of-range corners contribute zeros). Feature maps are NHWC at
this interface, like the JAX package's; a map that is a permuted view of an
NCHW tensor (what ``CHOREField.encode`` returns) goes to ``grid_sample``
without a copy.
"""
from __future__ import annotations

import torch.nn.functional as F


def bilinear_sample(feat, uv):
    """feat (B, H, W, C), uv (B, N, 2) in [-1, 1] (uv[..., 0] indexes
    width) -> (B, N, C)."""
    out = F.grid_sample(feat.permute(0, 3, 1, 2), uv[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2)  # (B, C, 1, N) -> (B, N, C)


def bilinear_sample_frozen(feat, uv):
    """``bilinear_sample`` on a frozen feature map: the same forward values,
    gradients only to ``uv`` (the fitting and point-generation loops
    differentiate with respect to the points alone)."""
    return bilinear_sample(feat.detach(), uv)
