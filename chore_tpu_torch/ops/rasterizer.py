"""Differentiable soft silhouette and hard z-buffer rasterization.

Counterpart of ``chore_tpu/ops/rasterizer.py``:

* ``project_unit_k``, ``COVERAGE_CUTOFF``, ``soft_silhouette`` in the
  edge-coefficient form of its Pallas path
  (``chore_tpu/ops/pallas/silhouette.py``): per-face edge and box
  coefficients from ``ops.silhouette.edge_coeffs``, raw per-pixel coverage
  sums from ``ops.silhouette.coverage_sums`` (kernels K2/K3 for CUDA
  tensors, their plain versions for CPU tensors), clipped to [0, 1];
* ``hard_rasterize``, the overlays' z-buffer (an XLA scan over face tiles
  in the JAX package, no Pallas kernel): stock torch ops on the verts'
  device, tiled over faces and chunked over pixels so no (pixels x faces)
  temporary outgrows a fixed budget.

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


def _edge(px, py, p0, p1):
    """Signed edge values (pixels x faces) of edge p0 -> p1 (T, 2)."""
    d = p1 - p0
    return (d[None, :, 0] * (py[:, None] - p0[None, :, 1])
            - d[None, :, 1] * (px[:, None] - p0[None, :, 0]))


def _tile_depth(px, py, tri3, zf, lo, hi, far):
    """Depth and barycentrics of pixels (P,) against one face tile: the
    JAX package's scan body, (P, T) depth (``far`` where not covered) and
    the three (P, T) barycentric weights."""
    tri = tri3[..., :2]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    e_ab = _edge(px, py, a, b)
    e_bc = _edge(px, py, b, c)
    e_ca = _edge(px, py, c, a)
    area = e_ab + e_bc + e_ca
    # all three >= 0 or all three <= 0 (a NaN fails both, as in JAX)
    inside = ((torch.minimum(torch.minimum(e_ab, e_bc), e_ca) >= 0)
              | (torch.maximum(torch.maximum(e_ab, e_bc), e_ca) <= 0))
    inside &= ((px[:, None] >= lo[None, :, 0]) & (px[:, None] <= hi[None, :, 0])
               & (py[:, None] >= lo[None, :, 1])
               & (py[:, None] <= hi[None, :, 1]))
    den = torch.where(area.abs() < 1e-12, 1.0, area)
    w_a, w_b, w_c = e_bc / den, e_ca / den, e_ab / den
    zinv = w_a / zf[None, :, 0] + w_b / zf[None, :, 1] + w_c / zf[None, :, 2]
    z = 1.0 / torch.clamp(zinv, min=1e-9)
    return torch.where(inside, z, far), (w_a, w_b, w_c)


# pixels x faces per step of hard_rasterize, which sets a band's height
_MAX_PAIRS = {"cuda": 1 << 23, "cpu": 1 << 20}


@torch.no_grad()
def hard_rasterize(verts_ndc, faces, image_size=256, face_tile=512,
                   far=100.0):
    """Hard z-buffer rasterization (non-differentiable; for overlays).

    Args:
      verts_ndc: (B, V, 3) projected verts (see :func:`project_unit_k`).
      faces: (F, 3) integer tensor on the verts' device.
      image_size: output resolution S.
      face_tile: faces per step.
      far: depth of the background; a pixel whose nearest depth is at or
        beyond it is background.

    Per pixel, per face: the edge values of (ab, bc, ca); inside when all
    three share a sign and the pixel lies in the face's bbox; barycentrics
    (w_bc, w_ca, w_ab) / area (area 1 where |area| < 1e-12), depth
    perspective-correct (1 / sum(w / max(z, 1e-9)), floored at 1e-9); a
    face counts only with all three z > 0. The lowest face index wins a
    tie in depth (the first minimum in a tile, a strictly smaller depth
    across tiles, tiles in index order).

    Each band of rows takes only the faces with all z > 0 whose bbox meets
    it (a face outside the band's rows fails the bbox test at every pixel
    of it), in index order, so no result depends on ``face_tile`` or on
    the band's height (``_MAX_PAIRS`` pixel-face pairs per step, by the
    device's type). Choosing them costs one wait for the device per call.

    Returns (face_index (B, S, S) int32 [-1 = background],
             depth (B, S, S), bary (B, S, S, 3)).
    """
    dev = verts_ndc.device
    S = image_size
    max_pairs = _MAX_PAIRS.get(dev.type, _MAX_PAIRS["cpu"])
    band = max(1, min(S, max_pairs // face_tile // S))  # rows per band
    n_bands = -(-S // band)
    c = (2.0 * torch.arange(S, dtype=torch.float32, device=dev)
         + 1.0) / S - 1.0
    faces = faces.to(device=dev, dtype=torch.long)
    r0 = torch.arange(n_bands, device=dev) * band
    y_lo, y_hi = c[r0], c[torch.clamp(r0 + band - 1, max=S - 1)]
    out_i, out_z, out_w = [], [], []
    for verts in verts_ndc:
        tris = verts[faces]  # (F, 3, 3)
        lo, hi = tris[..., :2].amin(1), tris[..., :2].amax(1)  # (F, 2) bbox
        zf = torch.clamp(tris[..., 2], min=1e-9)
        meets = (((tris[..., 2] > 0).all(-1) & (hi[:, 0] >= c[0])
                  & (lo[:, 0] <= c[-1]))[None]
                 & (lo[None, :, 1] <= y_hi[:, None])
                 & (hi[None, :, 1] >= y_lo[:, None]))  # (bands, F)
        meets = meets.cpu()  # the call's one wait for the device
        counts = meets.sum(1).tolist()
        # band-major, faces in index order
        chosen = meets.nonzero()[:, 1].to(dev)
        best_z = torch.full((S, S), far, device=dev)
        best_i = torch.full((S, S), -1, dtype=torch.long, device=dev)
        best_w = torch.zeros((S, S, 3), device=dev)
        at = 0
        for b, n in enumerate(counts):
            sel_b, at = chosen[at:at + n], at + n
            rows = slice(b * band, min(S, (b + 1) * band))
            py = c[rows, None].expand(-1, S).reshape(-1)
            px = c[None, :].expand(py.numel() // S, -1).reshape(-1)
            bz = best_z[rows].view(-1)
            bi = best_i[rows].view(-1)
            bw = best_w[rows].view(-1, 3)
            for t0 in range(0, n, face_tile):
                sel = sel_b[t0:t0 + face_tile]
                z, w = _tile_depth(px, py, tris[sel], zf[sel], lo[sel],
                                   hi[sel], far)
                k = torch.argmin(z, dim=-1, keepdim=True)  # first minimum
                tz = z.gather(1, k)[:, 0]
                upd = tz < bz
                bi.copy_(torch.where(upd, sel[k[:, 0]], bi))
                bw.copy_(torch.where(upd[:, None], torch.cat(
                    [x.gather(1, k) for x in w], 1), bw))
                bz.copy_(torch.minimum(bz, tz))
        out_i.append(torch.where(best_z >= far, -1, best_i).int())
        out_z.append(best_z)
        out_w.append(best_w)
    return torch.stack(out_i), torch.stack(out_z), torch.stack(out_w)
