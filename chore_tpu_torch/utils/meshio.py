"""Mesh utilities the fitter needs (numpy), copied from
``chore_tpu/utils/meshio.py`` so the port's outputs are identical: seeded
area-weighted surface sampling, PCA axes, and the octasphere stand-in mesh.
"""
from __future__ import annotations

import numpy as np


def sample_surface(verts, faces, n, seed=0):
    """Area-weighted uniform surface sampling (trimesh.sample equivalent)."""
    rng = np.random.RandomState(seed)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    fid = rng.choice(len(faces), n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return ((1 - r1) * v0[fid] + r1 * (1 - r2) * v1[fid]
            + r1 * r2 * v2[fid]).astype(np.float32)


def pca_axes(points):
    """(3, 3) principal axes, rows sorted by decreasing variance
    (sklearn PCA .components_ equivalent)."""
    x = points - points.mean(0)
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    return vt.astype(np.float32)


def octasphere(radius=0.2, center=(0, 0, 0), subdiv=2):
    """Subdivided octahedron projected to a sphere -- a dependency-free
    test/stand-in mesh."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(subdiv):
        new_faces = []
        verts = list(verts)
        cache = {}

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = np.asarray(new_faces)
        verts = np.asarray(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return (verts * radius + np.asarray(center)).astype(np.float32), faces.astype(np.int32)
