"""Debug visualization during fitting (counterpart of
``chore_tpu/utils/viewer.py``).

``FitMonitor`` snapshots the fit after each stage (point clouds, SMPL fit,
object fit): front + side renders of the current meshes and point clouds
written to ``{outdir}/{seq:02d}_{stage}.jpg``, scalars appended to
``{outdir}/losses.jsonl``. ``interactive=True`` asks for a live window as
the JAX package does; the port has no window toolkit, so it behaves as the
JAX package does where cv2 cannot open one: ``_display_ok()`` is False and
only the files are written.
"""
from __future__ import annotations

import json
import os

import numpy as np

from chore_tpu_torch.data.imageio import imwrite


class FitMonitor:
    """Stage-by-stage visual monitor for ReconFitter.

    Usage:
        mon = FitMonitor("debug_out")
        fitter.fit_batch(..., monitor=mon)

    Each snapshot renders front + side views of the current meshes/point
    clouds with utils.render.render_meshes on the device ``snapshot`` is
    given (``fit_batch`` passes the fitter's; the card if None).
    """

    SMPL_COLOR = (0.2, 0.7, 0.3)
    OBJ_COLOR = (0.8, 0.3, 0.2)
    PC_COLORS = {"human": (0.4, 0.9, 0.9), "object": (0.9, 0.8, 0.3)}

    def __init__(self, outdir=None, interactive=False, image_size=512,
                 point_radius=0.006):
        self.outdir = outdir
        self.image_size = image_size
        self.point_radius = point_radius
        self.seq = 0
        self.interactive = interactive and self._display_ok()
        if outdir:
            os.makedirs(outdir, exist_ok=True)

    @staticmethod
    def _display_ok():
        """No window toolkit in the port: never a live window."""
        return False

    # ------------------------------------------------------------------ #
    def _point_mesh(self, points):
        """Tiny octahedron per point: renders clouds through the same mesh
        rasterizer."""
        r = self.point_radius
        offs = np.array([[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, -r, 0],
                         [0, 0, r], [0, 0, -r]], np.float32)
        tris = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
                        np.int32)
        pts = np.asarray(points, np.float32)
        verts = (pts[:, None] + offs[None]).reshape(-1, 3)
        faces = (tris[None] + 6 * np.arange(len(pts))[:, None, None]
                 ).reshape(-1, 3)
        return verts, faces.astype(np.int32)

    def snapshot(self, stage, meshes=None, pclouds=None, losses=None,
                 max_points=800, device=None):
        """Render and persist the current state.

        Args:
          stage: name, e.g. 'pclouds', 'smpl', 'object:joint'.
          meshes: list of (verts, faces, color) in camera space.
          pclouds: dict name -> (N, 3) points (subsampled to max_points).
          losses: dict of scalars for losses.jsonl.
          device: where the z-buffer runs (the card unless "cpu").

        Returns the (S, 2S, 3) uint8 RGB frame, or None when there is
        nothing to render.
        """
        from chore_tpu_torch.utils.render import look_at_side, render_meshes

        mesh_list, colors = [], []
        for v, f, c in (meshes or []):
            mesh_list.append((np.asarray(v), np.asarray(f)))
            colors.append(c)
        for name, pts in (pclouds or {}).items():
            pts = np.asarray(pts)
            if len(pts) > max_points:
                pts = pts[:: max(1, len(pts) // max_points)]
            mesh_list.append(self._point_mesh(pts))
            colors.append(self.PC_COLORS.get(name, (0.8, 0.8, 0.8)))
        if not mesh_list:
            return None

        front, _ = render_meshes(mesh_list, colors,
                                 image_size=self.image_size, device=device)
        allv = np.concatenate([v for v, _ in mesh_list], 0)
        center = allv.mean(0)
        side_list = [(look_at_side(v, 90.0, center), f)
                     for v, f in mesh_list]
        side, _ = render_meshes(side_list, colors,
                                image_size=self.image_size, device=device)
        frame = np.concatenate([front, side], axis=1)
        frame8 = (np.clip(frame, 0, 1) * 255).astype(np.uint8)

        if self.outdir:
            path = os.path.join(self.outdir,
                                f"{self.seq:02d}_{stage.replace(':', '_')}.jpg")
            imwrite(path, np.ascontiguousarray(frame8[..., ::-1]))
            if losses:
                with open(os.path.join(self.outdir, "losses.jsonl"), "a") as f:
                    f.write(json.dumps(
                        {"seq": self.seq, "stage": stage,
                         **{k: float(v) for k, v in losses.items()}}) + "\n")
        self.seq += 1
        return frame8
