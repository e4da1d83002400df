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
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chore_tpu_torch import resolve_device
from chore_tpu_torch.models.convert import trained_names
from chore_tpu_torch.models.hourglass import HGFilter
from chore_tpu_torch.models.layers import normal_init_, one_hot_ce
from chore_tpu_torch.ops.camera import PerspectiveCamera
from chore_tpu_torch.ops.grid_sample import bilinear_sample, bilinear_sample_frozen


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static model and loss configuration (release values)."""

    num_stack: int = 5
    num_hourglass: int = 2  # hourglass depth
    hourglass_dim: int = 256
    hidden_dim: int = 128
    num_parts: int = 14
    input_channels: int = 5  # RGBM3
    crop_size: int = 1200  # loadSize
    net_img_size: int = 512
    z0: float = 2.2
    out_dist: float = 5.0  # df for points outside the image
    clamp_thres: float = 0.1
    # slope of the df loss above clamp_thres (0.0 is the reference's hard
    # clamp, whose gradient is zero above the threshold)
    df_leak: float = 0.05
    remat: bool = False  # recompute each hourglass in the backward pass
    # weights for [df_h, df_o, parts, pca, obj_center, smpl_center]
    loss_weights: Sequence[float] = (1.0, 1.0, 0.006, 500.0, 1000.0, 1000.0)

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
    (or ``query_last``) any number of times.

    Mixed precision (``encoder_dtype=torch.bfloat16``, the release
    config): every encoder conv runs in bf16 while GroupNorm statistics and
    the decoder heads stay float32; feature maps are sampled from their
    bf16-rounded values with float32 weights, as ``chore_tpu``'s gathers in
    the encoder dtype do. Parameters are always float32."""

    def __init__(self, cfg: FieldConfig = FieldConfig(),
                 encoder_dtype=torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.encoder_dtype = encoder_dtype
        self.image_filter = HGFilter(num_stack=c.num_stack,
                                     depth=c.num_hourglass, features=256,
                                     out_dim=c.hourglass_dim,
                                     in_channels=c.input_channels,
                                     dtype=encoder_dtype, remat=c.remat)
        f = c.feature_size
        self.df = make_decoder(f, c.hidden_dim, 2)
        self.pca_predictor = make_decoder(f, c.hidden_dim, 9)
        self.part_predictor = make_decoder(f, c.hidden_dim, c.num_parts)
        self.center_predictor = make_decoder(f, c.hidden_dim, 6)
        self.camera = PerspectiveCamera(crop_size=c.crop_size)

    def encode(self, images, train: bool = True):
        """images (B, H, W, 5) -> (list of (B, Hf, Wf, C) stack outputs,
        (B, Ht, Wt, 64) stem skip feature). Integer images are scaled by
        1/255. ``train=False`` keeps only the last stack. Under bf16 the
        stack outputs are bf16 and the skip feature float32."""
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

    def _sampled(self, sample, feat, xy):
        """``sample`` of a map rounded to the encoder dtype, in float32 (a
        no-op cast under float32)."""
        return sample(feat.to(self.encoder_dtype).float(), xy)

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
        tmpx_local = self._sampled(sample, tmpx, xy)
        return [self._decode_masked(self._sampled(sample, f, xy), z_feat,
                                    tmpx_local, in_img)
                for f in feats]

    def query_last(self, feats, tmpx, points, crop_center,
                   frozen_features: bool = True):
        """``query(...)[-1]`` computed alone: samples only the last stack's
        channels (plus ``tmpx``) and decodes once. The fitting and
        point-generation loops read only the last stack; XLA drops the
        others as dead code, eager PyTorch would run them all."""
        sample = bilinear_sample_frozen if frozen_features else bilinear_sample
        xy, z_feat, in_img = self._point_inputs(points, crop_center)
        return self._decode_masked(self._sampled(sample, feats[-1], xy),
                                   z_feat, self._sampled(sample, tmpx, xy),
                                   in_img)

    def forward(self, images, points, crop_center, train: bool = True):
        feats, tmpx = self.encode(images, train=train)
        return self.query(feats, tmpx, points, crop_center)


def chore_losses(preds_list, batch, cfg: FieldConfig):
    """Training losses, averaged over stacks (``chore_tpu``'s
    ``chore_losses``).

    batch: df_h (B, N), df_o (B, N), parts (B, N) int, pca (B, 3, 3) or
    (B, N, 3, 3), body_center (B, 3), obj_center (B, 3) (relative to the
    body centre). Returns (total, dict of the 6 weighted parts)."""
    w = cfg.loss_weights
    clamp = cfg.clamp_thres
    names = ["df_h", "df_o", "parts", "pca", "smpl_center", "obj_center"]
    totals = {k: 0.0 for k in names}
    df_h_gt = batch["df_h"].clamp(max=clamp)
    df_o_gt = batch["df_o"].clamp(max=clamp)
    mask_o = (batch["df_o"] < 0.05).float()  # (B, N)
    mask_h = (batch["df_h"] < 0.05).float()
    pca_gt = batch["pca"]
    if pca_gt.dim() == 3:  # one (3, 3) per image, broadcast over points
        pca_gt = pca_gt[:, None]
    labels = batch["parts"].long()

    def leaky_clip(x):
        # min(x, clamp) with a small slope above it, so an overshooting df
        # channel still gets a gradient
        return torch.minimum(x, torch.tensor(clamp, dtype=x.dtype,
                                             device=x.device)) \
            + cfg.df_leak * F.relu(x - clamp)

    for preds in preds_list:
        df = preds["df"]  # (B, N, 2)
        # clamped L1, summed over points, mean over the batch
        loss_h = (leaky_clip(df[..., 0]) - df_h_gt).abs().sum(-1).mean()
        loss_o = (leaky_clip(df[..., 1]) - df_o_gt).abs().sum(-1).mean()
        loss_parts = one_hot_ce(preds["parts"], labels).sum(-1).mean()
        # masked means over ALL elements, the masked-out ones included
        loss_pca = ((preds["pca"] - pca_gt) ** 2
                    * mask_o[..., None, None]).mean()
        loss_oc = ((preds["centers"][..., 3:]
                    - batch["obj_center"][:, None, :]) ** 2
                   * mask_o[..., None]).mean()
        loss_sc = ((preds["centers"][..., :3]
                    - batch["body_center"][:, None, :]) ** 2
                   * mask_h[..., None]).mean()
        totals["df_h"] += loss_h * w[0]
        totals["df_o"] += loss_o * w[1]
        totals["parts"] += loss_parts * w[2]
        totals["pca"] += loss_pca * w[3]
        totals["obj_center"] += loss_oc * w[4]
        totals["smpl_center"] += loss_sc * w[5]
    n = len(preds_list)
    totals = {k: v / n for k, v in totals.items()}
    return sum(totals.values()), totals


def build_field(cfg: FieldConfig = FieldConfig(), device=None, seed=0,
                state_dict=None, encoder_dtype=torch.float32,
                trainable=False):
    """A CHOREField on ``device`` (the card unless ``device="cpu"``): from
    ``state_dict`` when given (e.g. ``convert.params_from_jax`` or a
    reference checkpoint), else a seeded N(0, 0.02) init.
    ``encoder_dtype``: torch.bfloat16 for the release "mixed" precision.

    By default in eval mode with frozen weights (the fitter's field).
    ``trainable=True``: train mode, and gradients on every parameter that
    ``chore_tpu``'s field has, i.e. all but the unused ``bn4`` of the
    equal-width ConvBlocks (``convert.trained_names``)."""
    device = resolve_device(device)
    model = CHOREField(cfg, encoder_dtype=encoder_dtype)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        normal_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    if not trainable:
        return model.eval().requires_grad_(False)
    keep = set(trained_names(model.state_dict()))
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
    return model.train()
