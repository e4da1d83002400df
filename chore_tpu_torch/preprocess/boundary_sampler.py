"""GT generation: boundary-sampled unsigned distance fields (the
counterpart of ``chore_tpu/preprocess/boundary_sampler.py``).

Per sigma: sample the combined human + object surface, perturb with
Gaussian noise, add uniform grid samples in the fixed scene bounds, then
compute the exact UDF to the SMPL mesh and to the object mesh, the 14-way
part label of each sample through its nearest SMPL vertex, and the object's
PCA axes, the SMPL centre (pelvis) and the object centre. The random stream
is the reference's ``np.random.RandomState``, drawn in the same order, so
the same seed gives the same points.

Backends for the UDF and the label: ``"native"`` (the triangle BVH and
vertex KD-tree of ``native.py`` on the host), ``"device"`` (the dense tiled
``ops.point_mesh.point_mesh_udf`` on the sampler's device: the card unless
``device="cpu"``; its nearest vertex through the 1-NN kernel K1) or
``"auto"``, which follows the device: the device backend on the card, and
on the CPU the reference's rule (native when the library builds here, else
device).
"""
from __future__ import annotations

import numpy as np
import torch

from chore_tpu_torch import native, resolve_device
from chore_tpu_torch.ops.point_mesh import point_mesh_udf
from chore_tpu_torch.smpl.assets import (
    load_landmark_regressors,
    load_part_labels,
)
from chore_tpu_torch.smpl.const import BODY25_PELVIS
from chore_tpu_torch.utils.meshio import pca_axes, sample_surface

# fixed scene bounds
BOUNDS_MIN = np.array([-3.0, -0.9, 0.2])
BOUNDS_MAX = np.array([3.0, 1.80, 4.0])

# left <-> right part swap for mirrored data
_FLIP_MAP = {1: 6, 2: 7, 3: 8, 4: 9, 5: 10, 12: 13,
             6: 1, 7: 2, 8: 3, 9: 4, 10: 5, 13: 12}


def flip_part_labels(parts):
    out = parts.copy()
    for src, dst in _FLIP_MAP.items():
        out[parts == src] = dst
    return out


class BoundarySampler:
    def __init__(self, assets_dir=None, seed=0, backend="auto", device=None):
        """backend: "native", "device" or "auto" (module docstring);
        device: where the device backend runs (the card unless "cpu")."""
        self.part_labels = load_part_labels(assets_dir)  # (6890,)
        self.body25_reg = load_landmark_regressors(assets_dir)["body25"]
        self.rng = np.random.RandomState(seed)
        if backend not in ("native", "device", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = resolve_device(device) if backend != "native" else None
        if backend == "auto":
            backend = ("device" if self.device.type == "cuda"
                       or not native.available() else "native")
        if backend == "native":
            native.build()  # raises with the compiler's output
            self.device = None
        self.backend = backend

    def _udf(self, samples, verts, faces):
        if self.backend == "native":
            return native.point_mesh_udf(samples, verts, faces)
        t = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, dt)).to(self.device)
        d, vidx = point_mesh_udf(t(samples, np.float32),
                                 t(verts, np.float32), t(faces, np.int64))
        return d.cpu().numpy(), vidx.cpu().numpy()

    def boundary_sampling(self, smpl_v, smpl_f, obj_v, obj_f, sigma,
                          sample_num, grid_ratio=0.01):
        """One sigma level -> (points, d_h, d_o, parts)."""
        # surface samples of the combined mesh, area-weighted
        comb_v = np.concatenate([smpl_v, obj_v], 0)
        comb_f = np.concatenate([obj_f + len(smpl_v), smpl_f], 0)
        seed = int(self.rng.randint(1 << 31))
        surf = sample_surface(comb_v, comb_f, sample_num, seed=seed)
        pts = surf + sigma * self.rng.randn(sample_num, 3).astype(np.float32)
        n_grid = int(grid_ratio * sample_num)
        grid = (self.rng.rand(n_grid, 3)
                * (BOUNDS_MAX - BOUNDS_MIN) + BOUNDS_MIN).astype(np.float32)
        samples = np.concatenate([pts, grid], 0)

        d_h, vidx = self._udf(samples, smpl_v, smpl_f)
        d_o, _ = self._udf(samples, obj_v, obj_f)
        parts = self.part_labels[np.asarray(vidx)]
        return samples, np.asarray(d_h), np.asarray(d_o), parts

    def boundary_sample_all(self, smpl_v, smpl_f, obj_v, obj_f, sigmas,
                            ratios, sample_num, grid_ratio=1 / 16.0,
                            flip=False, min_samples=10000):
        """All sigma levels, PCA axes and centres -> an npz-ready dict."""
        out_points, out_dh, out_do, out_parts = {}, {}, {}, {}
        for s, r in zip(sigmas, ratios):
            n = max(int(r * sample_num), min_samples)
            pts, dh, do, parts = self.boundary_sampling(
                smpl_v, smpl_f, obj_v, obj_f, s, n, grid_ratio)
            if flip:
                parts = flip_part_labels(parts)
            key = f"sigma{s}"
            out_points[key] = pts.astype(np.float32)
            out_dh[key] = dh.astype(np.float32)
            out_do[key] = do.astype(np.float32)
            out_parts[key] = parts.astype(np.uint8)

        body_kpts = self.body25_reg @ smpl_v  # (25, 3)
        return {
            "points": out_points,
            "dist_h": out_dh,
            "dist_o": out_do,
            "parts": out_parts,
            "pca_axis": pca_axes(obj_v),
            "smpl_center": body_kpts[BODY25_PELVIS].astype(np.float32),
            "body_kpts": body_kpts.astype(np.float32),
            "obj_center": obj_v.mean(0).astype(np.float32),
        }
