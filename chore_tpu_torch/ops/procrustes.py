"""Procrustes similarity alignment (scale, rotation, translation),
batched over leading dimensions: the counterpart of
``chore_tpu/ops/procrustes.py``. The 3x3 SVD runs on the points' device
(``torch.linalg.svd``: cuSOLVER on the card, with a host synchronisation).
Matmuls need full f32 (``use_full_f32``).
"""
from __future__ import annotations

import torch

from chore_tpu_torch.ops.rotation import _newton_schulz_orthogonalize


def similarity_transform(src, ref):
    """(scale, R, t) minimizing || scale * R @ src + t - ref ||^2.

    Args:
      src, ref: (..., N, 3) corresponding point sets.

    Returns:
      (R (..., 3, 3), t (..., 1, 3), scale (..., 1, 1)) such that
      aligned = scale * src @ R^T + t. A reflection is turned into a
      rotation through sign(det) on the last singular direction.
    """
    mu1 = src.mean(dim=-2, keepdim=True)
    mu2 = ref.mean(dim=-2, keepdim=True)
    x1 = src - mu1
    x2 = ref - mu2
    var1 = (x1 * x1).sum(dim=(-1, -2), keepdim=True)  # (..., 1, 1)
    k = x1.transpose(-1, -2) @ x2  # (..., 3, 3)
    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    det = torch.sign(torch.linalg.det(u @ v.transpose(-1, -2)))
    z = torch.eye(3, dtype=src.dtype, device=src.device).expand(
        k.shape).clone()
    z[..., 2, 2] = det
    r = _newton_schulz_orthogonalize(v @ z @ u.transpose(-1, -2))
    scale = torch.diagonal(r @ k, dim1=-2, dim2=-1).sum(-1)[
        ..., None, None] / var1
    t = mu2 - scale * (mu1 @ r.transpose(-1, -2))
    return r, t, scale


def align_points(src, ref):
    """Procrustes-align ``src`` onto ``ref``; returns the aligned points."""
    r, t, scale = similarity_transform(src, ref)
    return apply_transform(src, r, t, scale)


def apply_transform(points, r, t, scale):
    """Apply a transform from :func:`similarity_transform` to any point set
    (align SMPL + object jointly, then move each part)."""
    return scale * (points @ r.transpose(-1, -2)) + t
