"""The CHORE field network: pixel-aligned implicit UDF/part/pose fields.

Counterpart of ``chore_tpu/models/chore.py``: a stacked-hourglass encoder
over the 5-channel masked-RGB input and four per-point decoder heads
  df      (2)  human/object unsigned distance fields
  pca     (9)  object rotation as 3 PCA axes
  parts   (14) SMPL part logits
  centers (6)  SMPL centre xyz + object centre offset xyz

Public layouts are the JAX package's: NHWC images and feature maps, (B, N, 3)
points, (B, N, F) point features. The encoder runs NCHW inside and hands
back NHWC views of its NCHW outputs (no copies). The heads are the
reference's 1x1 Conv1d stacks (``df.0/2/4/6`` ...), applied as per-point
linear layers on (B, N, F).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from chore_tpu_torch import resolve_device
from chore_tpu_torch.models.hourglass import HGFilter
from chore_tpu_torch.models.layers import normal_init_
from chore_tpu_torch.ops.camera import PerspectiveCamera
from chore_tpu_torch.ops.grid_sample import bilinear_sample, bilinear_sample_frozen


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static model configuration (release values; the training-loss
    fields of ``chore_tpu``'s FieldConfig come with the training slice)."""

    num_stack: int = 5
    num_hourglass: int = 2  # hourglass depth
    hourglass_dim: int = 256
    hidden_dim: int = 128
    num_parts: int = 14
    input_channels: int = 5  # RGBM3
    crop_size: int = 1200  # loadSize
    z0: float = 2.2
    out_dist: float = 5.0  # df for points outside the image

    @property
    def feature_size(self):
        # 256 hourglass + 3 xyz z-feature + 64 stem skip
        return self.hourglass_dim + 3 + 64


def make_decoder(in_dim, hidden, out):
    """Per-point MLP in -> h -> h -> h -> out with ReLU, as the reference's
    Conv1d(kernel 1) stack (indices 0, 2, 4, 6)."""
    return nn.Sequential(
        nn.Conv1d(in_dim, hidden, 1), nn.ReLU(),
        nn.Conv1d(hidden, hidden, 1), nn.ReLU(),
        nn.Conv1d(hidden, hidden, 1), nn.ReLU(),
        nn.Conv1d(hidden, out, 1),
    )


def apply_decoder(dec, x):
    """(B, N, F) -> (B, N, out): each 1x1 Conv1d as a linear layer."""
    convs = [m for m in dec if isinstance(m, nn.Conv1d)]
    for k, conv in enumerate(convs):
        x = F.linear(x, conv.weight[..., 0], conv.bias)
        if k < len(convs) - 1:
            x = F.relu(x)
    return x


class CHOREField(nn.Module):
    """Encoder + 4 decoder heads. ``encode`` once per image, then ``query``
    (or ``query_last``) any number of times."""

    def __init__(self, cfg: FieldConfig = FieldConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.image_filter = HGFilter(num_stack=c.num_stack,
                                     depth=c.num_hourglass, features=256,
                                     out_dim=c.hourglass_dim,
                                     in_channels=c.input_channels)
        f = c.feature_size
        self.df = make_decoder(f, c.hidden_dim, 2)
        self.pca_predictor = make_decoder(f, c.hidden_dim, 9)
        self.part_predictor = make_decoder(f, c.hidden_dim, c.num_parts)
        self.center_predictor = make_decoder(f, c.hidden_dim, 6)
        self.camera = PerspectiveCamera(crop_size=c.crop_size)

    def encode(self, images, train: bool = True):
        """images (B, H, W, 5) -> (list of (B, Hf, Wf, C) stack outputs,
        (B, Ht, Wt, 64) stem skip feature). Integer images are scaled by
        1/255. ``train=False`` keeps only the last stack."""
        if not torch.is_floating_point(images):
            images = images.to(torch.float32) / 255.0
        x = images.permute(0, 3, 1, 2).contiguous()
        outputs, tmpx, _ = self.image_filter(x, train=train)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return [nhwc(o) for o in outputs], nhwc(tmpx)

    def decode(self, features):
        """(B, N, F) point features -> dict of head outputs."""
        pca = apply_decoder(self.pca_predictor, features)
        return {
            "df": apply_decoder(self.df, features),
            "pca": pca.reshape(*pca.shape[:-1], 3, 3),
            "parts": apply_decoder(self.part_predictor, features),
            "centers": apply_decoder(self.center_predictor, features),
        }

    def _point_inputs(self, points, crop_center):
        xyz = self.camera.project_points(points, crop_center)
        xy = xyz[..., :2]
        z_feat = torch.cat([points[..., 0:2], points[..., 2:3] - self.cfg.z0],
                           dim=-1)
        in_img = ((xy[..., 0] >= -1.0) & (xy[..., 0] <= 1.0)
                  & (xy[..., 1] >= -1.0) & (xy[..., 1] <= 1.0))
        return xy, z_feat, in_img

    def _decode_masked(self, sampled, z_feat, tmpx_local, in_img):
        preds = self.decode(torch.cat([sampled, z_feat, tmpx_local], dim=-1))
        preds["df"] = torch.where(in_img[..., None], preds["df"],
                                  torch.full_like(preds["df"],
                                                  self.cfg.out_dist))
        return preds

    def query(self, feats, tmpx, points, crop_center,
              frozen_features: bool = False):
        """Query the fields at (B, N, 3) camera-space points; one head dict
        per stack in ``feats``. ``df`` of out-of-image points is OUT_DIST.
        ``frozen_features``: gradients flow to ``points`` only."""
        sample = bilinear_sample_frozen if frozen_features else bilinear_sample
        xy, z_feat, in_img = self._point_inputs(points, crop_center)
        tmpx_local = sample(tmpx, xy)
        return [self._decode_masked(sample(f, xy), z_feat, tmpx_local, in_img)
                for f in feats]

    def query_last(self, feats, tmpx, points, crop_center,
                   frozen_features: bool = True):
        """``query(...)[-1]`` computed alone: samples only the last stack's
        channels (plus ``tmpx``) and decodes once. The fitting and
        point-generation loops read only the last stack; XLA drops the
        others as dead code, eager PyTorch would run them all."""
        sample = bilinear_sample_frozen if frozen_features else bilinear_sample
        xy, z_feat, in_img = self._point_inputs(points, crop_center)
        return self._decode_masked(sample(feats[-1], xy), z_feat,
                                   sample(tmpx, xy), in_img)

    def forward(self, images, points, crop_center, train: bool = True):
        feats, tmpx = self.encode(images, train=train)
        return self.query(feats, tmpx, points, crop_center)


def build_field(cfg: FieldConfig = FieldConfig(), device=None, seed=0,
                state_dict=None):
    """A CHOREField on ``device`` (the card unless ``device="cpu"``), in
    eval mode with frozen weights: from ``state_dict`` when given (e.g.
    ``convert.params_from_jax`` or a reference checkpoint), else a seeded
    N(0, 0.02) init."""
    device = resolve_device(device)
    model = CHOREField(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        normal_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)
