"""Exact point-to-mesh unsigned distance, dense and tiled (the counterpart
of ``chore_tpu/ops/point_mesh.py``), plus the nearest mesh vertex used for
part-label transfer.

The closest point on each triangle is Ericson's region test ("Real-Time
Collision Detection" 5.1.5), evaluated branch-free over (points x faces)
tiles in stock torch ops: it is no Pallas kernel in the JAX package either.
The nearest-vertex index goes through the 1-NN kernel K1 (``nn_sqdist``:
one launch on the card, its plain version on the CPU).
"""
from __future__ import annotations

import torch

from chore_tpu_torch.ops.chamfer import nn_sqdist


def closest_point_on_triangles(p, a, b, c):
    """Closest point on each triangle to each query point.

    Args:
      p: (N, 3) query points.
      a, b, c: (T, 3) triangle vertices.

    Returns:
      (N, T, 3) closest points.
    """
    ab = (b - a)[None]  # (1, T, 3)
    ac = (c - a)[None]
    ap = p[:, None, :] - a[None]  # (N, T, 3)

    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)

    bp = p[:, None, :] - b[None]
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)

    cp = p[:, None, :] - c[None]
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    eps = 1e-30
    one = torch.ones((), dtype=p.dtype, device=p.device)

    def safe(den):
        return torch.where(den.abs() < eps, one, den)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # edge AB
    v_ab = d1 / safe(d1 - d3)
    pt_ab = a[None] + v_ab.clamp(0.0, 1.0)[..., None] * ab
    # edge AC
    w_ac = d2 / safe(d2 - d6)
    pt_ac = a[None] + w_ac.clamp(0.0, 1.0)[..., None] * ac
    # edge BC
    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = (d4 - d3) / safe(denom_bc)
    pt_bc = b[None] + w_bc.clamp(0.0, 1.0)[..., None] * ((c - b)[None])
    # interior
    denom = safe(va + vb + vc)
    v = vb / denom
    w = vc / denom
    pt_in = a[None] + v[..., None] * ab + w[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    out = pt_in
    out = torch.where(on_bc[..., None], pt_bc, out)
    out = torch.where(on_ac[..., None], pt_ac, out)
    out = torch.where(on_ab[..., None], pt_ab, out)
    out = torch.where(in_c[..., None], c[None], out)
    out = torch.where(in_b[..., None], b[None], out)
    out = torch.where(in_a[..., None], a[None], out)
    return out


def default_tile(device):
    """Query points per tile: 512 on the CPU (the JAX package's tile), 4,096
    on the card (the (tile, F) temporaries of one tile at F = 13,776 are
    ~225 MB each)."""
    return 4096 if torch.device(device).type == "cuda" else 512


def point_mesh_udf(points, verts, faces, tile=None):
    """Unsigned distance from each point to a triangle mesh, and the nearest
    mesh vertex.

    Args:
      points: (N, 3) query points.
      verts: (V, 3) mesh vertices.
      faces: (F, 3) integer vertex indices.
      tile: query points per tile (memory: tile x F x 3 floats per
        temporary); ``default_tile`` of the points' device when None. Rows
        are independent, so the tile changes no result.

    Returns:
      (udf (N,), nearest_vertex_index (N,) int64).
    """
    tile = tile or default_tile(points.device)
    faces = faces.long()
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    d2 = torch.empty(points.shape[0], dtype=points.dtype,
                     device=points.device)
    for s in range(0, points.shape[0], tile):
        pb = points[s:s + tile]
        cp = closest_point_on_triangles(pb, a, b, c)  # (tile, F, 3)
        d2[s:s + tile] = ((pb[:, None, :] - cp) ** 2).sum(-1).amin(1)
    udf = torch.sqrt(d2.clamp_min(0.0))
    # nearest vertex (what the label transfer needs; K1 on the card)
    _, vidx = nn_sqdist(points[None], verts[None])
    return udf, vidx[0]
