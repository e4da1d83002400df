"""Implicit-surface extraction: dense grid evaluation + marching tetrahedra.

Counterpart of ``chore_tpu/utils/marching.py`` (numpy, the same code):
``create_grid`` + chunked ``batch_eval`` of a field over the grid, then
surface extraction at a level set by marching *tetrahedra* (each cube
split into 6 tets, 16 trivially derivable cases) -- no 256-entry lookup
tables, fully vectorized, and watertight on consistent fields.
"""
from __future__ import annotations

import numpy as np

# 6-tetrahedra decomposition of the unit cube (corner indices).
# Cube corners: bit order (x, y, z): 0=(0,0,0) 1=(1,0,0) 2=(0,1,0)
# 3=(1,1,0) 4=(0,0,1) 5=(1,0,1) 6=(0,1,1) 7=(1,1,1)
_TETS = np.array([
    [0, 5, 1, 3],
    [0, 5, 3, 7],
    [0, 5, 7, 4],
    [0, 7, 3, 2],
    [0, 7, 2, 6],
    [0, 7, 6, 4],
])

_CORNER_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
])


def create_grid(res, bmin, bmax):
    """(res^3, 3) grid coordinates + per-axis linspaces."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    axes = [np.linspace(bmin[i], bmax[i], res, dtype=np.float32)
            for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return pts, axes


def batch_eval(points, eval_fn, chunk=100000):
    """Evaluate a field over many points in bounded-memory chunks."""
    out = []
    for i in range(0, len(points), chunk):
        out.append(np.asarray(eval_fn(points[i:i + chunk])))
    return np.concatenate(out, 0)


def _tet_triangles(p, v, level):
    """Triangles from one batch of tetrahedra.

    p: (T, 4, 3) corner positions; v: (T, 4) field values.
    Returns (M, 3, 3) triangle vertices where the level set crosses.
    """
    inside = v < level  # (T, 4)
    code = (inside[:, 0].astype(int) | (inside[:, 1].astype(int) << 1)
            | (inside[:, 2].astype(int) << 2) | (inside[:, 3].astype(int) << 3))

    def interp(i, j, mask):
        """Level-crossing point on edge (i, j) for masked tets."""
        vi, vj = v[mask, i], v[mask, j]
        t = (level - vi) / np.where(np.abs(vj - vi) < 1e-12, 1.0, vj - vi)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return p[mask, i] * (1 - t) + p[mask, j] * t

    tris = []
    # single-corner cases (1 triangle); corner c inside, others out (or inv)
    single = {1: (0, (1, 2, 3)), 2: (1, (0, 3, 2)), 4: (2, (0, 1, 3)),
              8: (3, (0, 2, 1))}
    for code_in, (c, (a, b, d)) in single.items():
        for cc in (code_in, 15 ^ code_in):
            m = code == cc
            if not m.any():
                continue
            t0 = interp(c, a, m)
            t1 = interp(c, b, m)
            t2 = interp(c, d, m)
            tris.append(np.stack([t0, t1, t2], axis=1))
    # two-corner cases (quad -> 2 triangles)
    double = {3: ((0, 1), (2, 3)), 5: ((0, 2), (1, 3)), 9: ((0, 3), (1, 2)),
              6: ((1, 2), (0, 3)), 10: ((1, 3), (0, 2)), 12: ((2, 3), (0, 1))}
    for cc, ((i, j), (k, l)) in double.items():
        m = code == cc
        if not m.any():
            continue
        e_ik = interp(i, k, m)
        e_il = interp(i, l, m)
        e_jk = interp(j, k, m)
        e_jl = interp(j, l, m)
        tris.append(np.stack([e_ik, e_il, e_jl], axis=1))
        tris.append(np.stack([e_ik, e_jl, e_jk], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, 0)


def marching_tetrahedra(values, bmin, bmax, level=0.5):
    """Extract the level-set surface of a (R, R, R) scalar grid.

    Returns (verts (V, 3), faces (F, 3)) with deduplicated vertices.
    """
    res = values.shape[0]
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    step = (bmax - bmin) / (res - 1)

    # active cells: sign change among corners
    cell = values[:-1, :-1, :-1]
    crossing = np.zeros_like(cell, bool)
    for dx, dy, dz in _CORNER_OFFSETS:
        c = values[dx:res - 1 + dx, dy:res - 1 + dy, dz:res - 1 + dz]
        crossing |= (c < level) != (cell < level)
    ix, iy, iz = np.nonzero(crossing)
    if len(ix) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    base = np.stack([ix, iy, iz], 1)  # (C, 3)

    corner_idx = base[:, None, :] + _CORNER_OFFSETS[None]  # (C, 8, 3)
    cv = values[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    cp = bmin + corner_idx.astype(np.float32) * step

    all_tris = []
    for tet in _TETS:
        p = cp[:, tet]  # (C, 4, 3)
        v = cv[:, tet]
        all_tris.append(_tet_triangles(p, v, level))
    tris = np.concatenate(all_tris, 0)  # (M, 3, 3)

    # deduplicate vertices on a quantized lattice
    flat = tris.reshape(-1, 3)
    key = np.round(flat / (step.min() * 1e-4)).astype(np.int64)
    _, uniq_idx, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[uniq_idx]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]


def reconstruction(eval_fn, res, bmin, bmax, level=0.5, chunk=100000,
                   coarse_stride=4, band=None):
    """Field -> mesh with a coarse pre-pass: evaluate at ``coarse_stride``,
    then only evaluate fine points within ``band`` of the level set
    (everything else keeps the coarse value).
    """
    pts, _ = create_grid(res, bmin, bmax)
    if coarse_stride > 1:
        coarse_res = (res + coarse_stride - 1) // coarse_stride
        cpts, _ = create_grid(coarse_res, bmin, bmax)
        cvals = batch_eval(cpts, eval_fn, chunk).reshape(
            coarse_res, coarse_res, coarse_res
        )
        # upsample coarse values to the fine grid (nearest)
        idx = np.minimum(
            (np.arange(res) * (coarse_res - 1) // max(res - 1, 1)),
            coarse_res - 1,
        )
        vals = cvals[np.ix_(idx, idx, idx)].reshape(-1)
        if band is None:
            # the nearest-upsampled coarse value can be off by ~ the local
            # gradient x the coarse cell diagonal; estimate the gradient
            # scale from neighboring coarse cells and widen generously --
            # a too-small band skips fine evaluation near the surface and
            # extracts a blocky piecewise-constant mesh
            cell = (bmax - bmin) / max(coarse_res - 1, 1)
            grad = max(
                float(np.abs(np.diff(cvals, axis=a)).max())
                for a in range(3)
            )
            band = 2.0 * (grad + 1e-3) * float(np.linalg.norm(cell) /
                                               np.min(cell))
        near = np.abs(vals - level) < band
        if near.any():
            vals[near] = batch_eval(pts[near], eval_fn, chunk)
    else:
        vals = batch_eval(pts, eval_fn, chunk)
    grid = vals.reshape(res, res, res)
    return marching_tetrahedra(grid, bmin, bmax, level)
