"""Differentiable soft silhouette.

Counterpart of ``chore_tpu/ops/rasterizer.py`` (``project_unit_k``,
``COVERAGE_CUTOFF``, ``soft_silhouette``) in the edge-coefficient form of
its Pallas path (``chore_tpu/ops/pallas/silhouette.py``): per-face edge and
box coefficients from ``ops.silhouette.edge_coeffs``, raw per-pixel coverage
sums from ``ops.silhouette.coverage_sums`` (kernels K2/K3 for CUDA tensors,
their plain versions for CPU tensors), clipped to [0, 1].

Conventions: intrinsics in unit image coordinates, photo-oriented v (+y in
camera space maps to larger v, and v = -1 is row 0), pixel centres at
(2i+1)/S - 1 in NDC.
"""
from __future__ import annotations

import torch

from chore_tpu_torch.ops.silhouette import (  # noqa: F401
    COVERAGE_CUTOFF,
    coverage_sums,
    edge_coeffs,
)


def project_unit_k(verts, K, eps=1e-9):
    """Project (B, V, 3) camera-space verts with (B, 3, 3) unit-coordinate
    intrinsics -> (B, V, 3) NDC [u, v, z], photo-oriented."""
    x = verts[..., 0] / (verts[..., 2] + eps)
    y = verts[..., 1] / (verts[..., 2] + eps)
    u = K[..., 0:1, 0] * x + K[..., 0:1, 2]
    v = K[..., 1:2, 1] * y + K[..., 1:2, 2]
    return torch.stack([2.0 * u - 1.0, 2.0 * v - 1.0, verts[..., 2]], dim=-1)


class _Clip01(torch.autograd.Function):
    """clip(x, 0, 1) with the JAX package's gradient: ``jnp.clip`` is
    max-then-min, whose ties split the gradient evenly, so the gradient is
    0.5 at exactly 0 and at exactly 1 (``torch.clamp`` gives 1 there). Raw
    coverage is exactly 0 on culled background and can be exactly 1.0 in
    f32 deep inside a face."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x > 0.0) & (x < 1.0)
        tie = (x == 0.0) | (x == 1.0)
        return torch.where(inside, g, torch.where(tie, 0.5 * g,
                                                  torch.zeros_like(g)))


def soft_silhouette(verts_ndc, faces, image_size=256, sigma=None):
    """Differentiable silhouette.

    Args:
      verts_ndc: (B, V, 3) projected verts (see :func:`project_unit_k`).
      faces: (F, 3) integer tensor on the verts' device.
      image_size: output resolution S.
      sigma: coverage sigmoid softness in NDC units (default half a pixel);
        a runtime value, so each anneal level is the same kernel.

    Returns:
      (B, S, S) silhouette in [0, 1].
    """
    if sigma is None:
        sigma = 0.5 * (2.0 / image_size)
    e = edge_coeffs(verts_ndc, faces, sigma)
    raw = coverage_sums(e, image_size, 1.0 / sigma)
    return _Clip01.apply(raw).reshape(-1, image_size, image_size)
