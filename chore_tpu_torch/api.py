"""One-call reconstruction API (counterpart of ``chore_tpu/api.py``).

Wraps model loading, per-image preparation, fitting and rendering into one
object:

    from chore_tpu_torch.api import Reconstructor
    rec = Reconstructor("chore-release", obj_name="basketball")
    out = rec.reconstruct("photo/k1.color.jpg")   # needs masks+mocap+kpts
    rec.save(out, "result_dir")                   # plys + overlay

Runs on the card unless ``device="cpu"``; the overlay's z-buffer runs on
the same device. Data-parallel reconstruction runs one process per card,
each with ``Reconstructor(mesh=parallel.make_mesh())`` (under ``torchrun``):
every rank passes the same list of images, prepares and fits its own slice,
and returns the whole result.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.cli.common import (
    load_object_template,
    load_smplh,
    load_trained,
)
from chore_tpu_torch.config import ChoreConfig, load_config
from chore_tpu_torch.data import TestImagePrep, collate
from chore_tpu_torch.data.imageio import imwrite, read_bgr_or_none
from chore_tpu_torch.parallel.mesh import (
    all_gather_batch,
    all_gather_object,
    is_main_process,
    local_batch_slice,
)
from chore_tpu_torch.recon import losses as L
from chore_tpu_torch.recon.fitter import ReconFitter
from chore_tpu_torch.utils.meshio import save_ply
from chore_tpu_torch.utils.render import align_to_input, render_meshes

def _numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree


class Reconstructor:
    """Joint human + object reconstruction from single images.

    Args:
      exp_name_or_cfg: experiment name (loads configs/{name}.json when
        present) or a ChoreConfig.
      obj_name: BEHAVE object category (template lookup; sphere stand-in
        when templates are unavailable).
      coco: in-the-wild mode (mean-centre restaging + COCO weights).
      exp_root: checkpoint search root.
      fit_cfg / sampler_cfg: schedule overrides (default: release).
      crop_info_dir: where the per-image crop info is written (default:
        next to the image).
      device: the card unless "cpu" (the mesh's device with a mesh).
      mesh: optional ``parallel.Mesh`` for data-parallel fitting, one
        process per device: the batch is padded to a multiple of the ranks
        by repeating its last frame, each rank prepares and fits its slice,
        and every rank returns the whole (trimmed) result.
    """

    def __init__(self, exp_name_or_cfg="chore-release", obj_name="basketball",
                 coco=False, exp_root="experiments", fit_cfg=None,
                 sampler_cfg=None, gender="male", crop_info_dir=None,
                 device=None, mesh=None):
        if isinstance(exp_name_or_cfg, ChoreConfig):
            cfg = exp_name_or_cfg
        else:
            try:
                cfg = load_config(exp_name_or_cfg)
            except FileNotFoundError:
                cfg = ChoreConfig(exp_name=exp_name_or_cfg)
        self.cfg = cfg
        self.coco = coco
        if (fit_cfg is not None
                and fit_cfg.net_in_size != cfg.net_img_size[0]):
            raise ValueError(
                f"fit_cfg.net_in_size={fit_cfg.net_in_size} must match "
                f"cfg.net_img_size={cfg.net_img_size[0]}: the image prep "
                "scales keypoints into net-input pixels with one and the "
                "keypoint loss rescales with the other")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.model = load_trained(cfg, exp_root=exp_root, device=self.device)
        self.smplh = load_smplh(gender, device=self.device)
        self.template_verts, self.template_faces = \
            load_object_template(obj_name)
        self.fitter = ReconFitter(
            self.model, self.smplh, self.template_verts, self.template_faces,
            weights=L.COCO_WEIGHTS if coco else L.BEHAVE_WEIGHTS,
            cfg=fit_cfg if fit_cfg is not None else cfg.fit_config(),
            sampler_cfg=(sampler_cfg if sampler_cfg is not None
                         else cfg.sampler_config()),
            mesh=mesh, device=self.device,
        )
        self.prep = TestImagePrep(
            image_size=tuple(cfg.net_img_size), crop_size=cfg.loadSize,
            use_mean_center=coco, crop_info_dir=crop_info_dir,
        )

    # ------------------------------------------------------------------ #
    def reconstruct(self, rgb_files, use_silhouette=True, generator=None,
                    draws=None, monitor=None):
        """Fit one image or a list of images (one batch).

        Each ``rgb_file`` needs the reference's sidecar files next to it
        (person/object masks, openpose ``.color.json``, FrankMocap
        ``.mocap.{ply,json}``). ``generator``: a torch.Generator on the
        fitter's device for the fit's random draws (seed 0 if None);
        ``draws``: injected point-generation draws (tests); ``monitor``: a
        ``utils.viewer.FitMonitor`` that snapshots each stage of the fit.

        Returns a dict of numpy arrays (batch first, aligned with the
        input): smpl_verts (B,V,3), smpl_faces, obj_verts (B,Vt,3),
        obj_faces, smpl_params, obj_params, obj_R, pclouds, crop_info,
        paths. With a mesh, every rank passes the same files (and the
        draws of the padded global batch) and gets the whole result; the
        monitor watches rank 0's first frame.
        """
        single = isinstance(rgb_files, (str, os.PathLike))
        files = [rgb_files] if single else list(rgb_files)
        mesh = self.fitter.mesh
        n = mesh.size if mesh is not None else 1
        # pad to a multiple of the ranks by repeating the last frame; a
        # padding copy writes no crop info, so no two ranks write one file
        padded = files + [files[-1]] * (-len(files) % n)
        mine = (range(len(padded)) if mesh is None
                else range(len(padded))[local_batch_slice(len(padded), n,
                                                          mesh.rank)])
        items = [self.prep.prepare(str(padded[i]),
                                   save_crop_info=i < len(files))
                 for i in mine]
        batch = collate(items)
        result = self.fitter.fit_batch(
            batch["images"], batch["crop_center"], batch["mocap_pose"],
            batch["mocap_betas"], batch["kpts"], generator=generator,
            use_silhouette=use_silhouette, draws=draws,
            monitor=monitor if is_main_process() else None, local_batch=True,
        )
        result["smpl_verts"] = self.smplh.verts(result["smpl_params"])
        result["obj_verts"] = self.fitter.transform_obj(
            result["obj_params"], points=self.fitter.template_verts)
        keys = ("smpl_verts", "obj_verts", "smpl_params", "obj_params",
                "obj_R", "pclouds")
        out = {k: _numpy(all_gather_batch(result[k], mesh)) for k in keys}
        trim = lambda t: ({k: trim(v) for k, v in t.items()}  # noqa: E731
                          if isinstance(t, dict) else t[:len(files)])
        out = {k: trim(v) for k, v in out.items()}
        crop_info = [c for part in all_gather_object(
            [it["crop_info"] for it in items], mesh) for c in part]
        return {
            **out,
            "smpl_faces": np.asarray(self.smplh.faces),
            "obj_faces": self.template_faces,
            "crop_info": crop_info[:len(files)],
            "paths": files,
        }

    # ------------------------------------------------------------------ #
    def save(self, out, result_dir, overlay=True, render_size=512):
        """Write frameNNNN/smpl.ply and object.ply for every frame of a
        ``reconstruct`` result, and overlay.jpg (the meshes rendered at
        ``render_size`` and pasted onto the photo) when ``overlay`` and the
        photo is readable; returns the frame directories. With a mesh,
        only rank 0 writes (every rank holds the whole result)."""
        stems = [os.path.join(result_dir, f"frame{i:04d}")
                 for i in range(out["smpl_verts"].shape[0])]
        if self.fitter.mesh is not None and not is_main_process():
            return stems
        os.makedirs(result_dir, exist_ok=True)
        written = []
        for i, stem in enumerate(stems):
            os.makedirs(stem, exist_ok=True)
            save_ply(os.path.join(stem, "smpl.ply"), out["smpl_verts"][i],
                     out["smpl_faces"])
            save_ply(os.path.join(stem, "object.ply"), out["obj_verts"][i],
                     out["obj_faces"])
            orig = (read_bgr_or_none(str(out["paths"][i])) if overlay
                    else None)
            if orig is not None:
                meshes = [(out["smpl_verts"][i], out["smpl_faces"]),
                          (out["obj_verts"][i], out["obj_faces"])]
                colors = [(0.2, 0.7, 0.3), (0.8, 0.3, 0.2)]
                front, mask = render_meshes(meshes, colors,
                                            image_size=render_size,
                                            device=self.device)
                ov = align_to_input(front[..., ::-1], mask, orig,
                                    out["crop_info"][i],
                                    use_mean_center=self.coco, alpha=0.85)
                imwrite(os.path.join(stem, "overlay.jpg"), ov)
            written.append(stem)
        return written
