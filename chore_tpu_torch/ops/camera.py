"""Perspective camera with crop-local normalization.

Counterpart of ``chore_tpu/ops/camera.py``: normalized Kinect intrinsics
scaled to a 4:3 image, pin-hole projection, then re-centring on a crop
square of ``crop_size`` pixels mapped to [-1, 1]. Points stay channels-last
(B, N, 3).
"""
from __future__ import annotations

import dataclasses

import torch

# Kinect color-camera intrinsics normalized by the 2048 px image width
KINECT_FX = 979.7844 / 2048.0
KINECT_FY = 979.840 / 2048.0
KINECT_CX = 1018.952 / 2048.0
KINECT_CY = 779.486 / 2048.0
DEFAULT_IMAGE_SIZE = 2048
DEFAULT_CROP_SIZE = 1200
# fixed SMPL-centre depth every training example is rescaled to
Z0 = 2.2


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Pin-hole camera with normalized intrinsics + crop bookkeeping."""

    crop_size: float = DEFAULT_CROP_SIZE
    fx: float = KINECT_FX
    fy: float = KINECT_FY
    cx: float = KINECT_CX
    cy: float = KINECT_CY
    image_size: int = DEFAULT_IMAGE_SIZE

    @property
    def width(self) -> int:
        return self.image_size

    @property
    def height(self) -> int:
        return int(self.image_size * 0.75)

    def project_screen(self, points, crop_center=None):
        """(..., N, 3) camera-space points -> (px, py), each (..., N, 1), in
        original-image pixels, re-centred on the crop when ``crop_center``
        (B, 2) is given."""
        x = points[..., 0:1]
        y = points[..., 1:2]
        z = points[..., 2:3]
        # guard the perspective division: a point pushed through z = 0 by an
        # optimizer transient gives huge-but-finite pixels (the in-image
        # mask rejects them), never inf/nan gradients
        z = torch.where(z.abs() < 1e-6,
                        torch.where(z < 0, -1e-6, 1e-6).to(z.dtype), z)
        px = (self.fx * self.image_size) * x / z + self.cx * self.image_size
        py = (self.fy * self.image_size) * y / z + self.cy * self.image_size
        if crop_center is not None:
            px = self.crop_size / 2.0 + px - crop_center[..., 0:1][..., None, :]
            py = self.crop_size / 2.0 + py - crop_center[..., 1:2][..., None, :]
        return px, py

    def normalize_crop(self, px, py, crop_center):
        """Original-image pixels -> crop-local [-1, 1] coordinates."""
        px = self.crop_size / 2.0 + px - crop_center[..., 0:1][..., None, :]
        py = self.crop_size / 2.0 + py - crop_center[..., 1:2][..., None, :]
        nx = 2.0 * px / self.crop_size - 1.0
        ny = 2.0 * py / self.crop_size - 1.0
        return nx, ny

    def project_points(self, points, crop_center=None):
        """(B, N, 3) points -> (B, N, 3) [nx, ny, z] normalized coords."""
        px, py = self.project_screen(points)
        if crop_center is None:
            nx = 2.0 * px / self.width - 1.0
            ny = 2.0 * py / self.height - 1.0
        else:
            nx, ny = self.normalize_crop(px, py, crop_center)
        return torch.cat([nx, ny, points[..., 2:3]], dim=-1)
