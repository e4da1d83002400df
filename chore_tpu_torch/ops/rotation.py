"""SO(3) utilities: SVD projection, Rodrigues, pseudo-inverse alignment.

Counterpart of ``chore_tpu/ops/rotation.py``. The JAX package polishes its
SVD projection with Newton-Schulz steps because the TPU's f32 SVD is
approximate (~1e-3); ``torch.linalg.svd`` is exact to f32 on the CPU and the
card, and at an orthogonal matrix the polish's Jacobian is the projection
onto the tangent space, which the SVD projection's gradient already lies
in -- so the polish changes neither values (beyond rounding) nor gradients
and is left out. Matmuls here need full f32 (``use_full_f32``).
"""
from __future__ import annotations

import torch


def project_so3(mat):
    """Project (..., 3, 3) matrices onto SO(3): U diag(1, 1, det(U V^T)) V^T
    (the det fix keeps a proper rotation)."""
    u, _, vt = torch.linalg.svd(mat, full_matrices=False)
    det = torch.linalg.det(u @ vt)[..., None, None]
    vt_fixed = torch.cat([vt[..., :2, :], vt[..., 2:, :] * det], dim=-2)
    return u @ vt_fixed


def project_so3_jittered(mat, generator=None, noise=None):
    """SO(3) projection after a 1e-4 * U[0, 1) jitter that keeps the SVD
    away from degenerate (repeated singular value) inputs. ``generator``
    lives on ``mat``'s device; ``noise`` overrides the draw."""
    if noise is None:
        noise = 1e-4 * torch.rand(mat.shape, generator=generator,
                                  device=mat.device, dtype=mat.dtype)
    return project_so3(mat + noise)


def pseudo_inverse(mat):
    """Left pseudo-inverse (A^T A)^-1 A^T of (..., 3, 3) matrices."""
    mt = mat.transpose(-1, -2)
    return torch.linalg.inv(mt @ mat) @ mt


def init_object_orientation(tgt_axis, src_axis):
    """Rotation taking template PCA axes to predicted PCA axes, projected to
    SO(3)."""
    return project_so3(pseudo_inverse(src_axis) @ tgt_axis)


def axis_angle_to_matrix(axisang):
    """Batched Rodrigues through the quaternion route:
    (..., 3) axis-angle -> (..., 3, 3)."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    w = torch.cos(half)[..., 0]
    xyz = torch.sin(half) * axis
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            ww + xx - yy - zz, 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), ww - xx + yy - zz, 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), ww - xx - yy + zz,
        ],
        dim=-1,
    )
    return rot.reshape(axisang.shape[:-1] + (3, 3))
