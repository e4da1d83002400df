"""Multi-phase joint SMPL + object fitting against the neural fields.

Counterpart of ``chore_tpu/recon/fitter.py`` on its staged path
(``fit_batch`` -> encode -> point generation -> SMPL chain -> object chain),
with the phase schedule kept exactly:

  SMPL:   'global' (top betas + trans, lr .02)
          -> 'smpl all pose' + 'kpts' as ONE phase (all pose + betas +
             trans, lr .006; j2d switches on and the decay becomes it/3 at
             the kpts boundary without resetting Adam)
  object: 'object only' x20 (R, t, s; lr .006)
          -> 'joint' x<=110 (t, s only; +contact +collision; lr .002,
             early stop, decay (it+1)/5 continuing the global schedule)

This slice runs the no-silhouette schedule (``use_silhouette=False``); the
50-iteration 'sil' phase between 'object only' and 'joint' is not ported
yet and asking for it raises. ``chore_tpu``'s ``fused_pipeline`` (one XLA
program per fit, a TPU dispatch workaround) has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.ops.camera import PerspectiveCamera, Z0
from chore_tpu_torch.ops.rotation import (
    init_object_orientation,
    project_so3,
    project_so3_jittered,
)
from chore_tpu_torch.recon import losses as L
from chore_tpu_torch.recon.generator import Generator, SamplerConfig
from chore_tpu_torch.recon.optimize import PhaseSpec, freeze_all_except, run_phase
from chore_tpu_torch.smpl.assets import load_part_labels
from chore_tpu_torch.smpl.model import SMPLH, init_params, pack_pose
from chore_tpu_torch.smpl.priors import make_body_prior, make_hand_prior
from chore_tpu_torch.utils.meshio import pca_axes, sample_surface
from chore_tpu_torch.utils.profiling import StepTimer


@dataclasses.dataclass(frozen=True)
class FitConfig:
    # phase iteration budgets
    iter_betas: int = 1
    iter_pose: int = 1
    iter_kpts: int = 1  # extends the kpts budget
    iter_kpts_max: int = 150
    iter_obj: int = 20
    iter_joint: int = 10  # extends the joint budget
    iter_joint_max: int = 100
    steps_per_iter: int = 10
    obj_samples: int = 3000  # template surface samples
    net_in_size: int = 512
    z0: float = Z0
    obj_scale: float = 1.0
    contact_thresh: float = 0.08
    crop_size: int = 1200
    # 1e-4 uniform jitter on the optimized rotation before each SVD
    # projection; off for deterministic parity tests
    svd_jitter: bool = True


class ReconFitter:
    """Fits SMPL-H + object 6DoF/scale to the neural fields of one batch.

    Args:
      model: a CHOREField (weights included); moved to ``device`` and frozen.
      smplh: SMPLH on the same device.
      template_verts/template_faces: canonical object template (numpy).
      weights: loss weight table (L.BEHAVE_WEIGHTS by default).
      record_traces: fit results carry the per-step loss traces of every
        phase under 'smpl_trace'/'obj_trace' (debugging and parity tests).
      device: the card unless ``device="cpu"``.
    """

    def __init__(self, model, smplh: SMPLH, template_verts, template_faces,
                 weights=None, cfg: FitConfig = FitConfig(),
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 assets_dir=None, record_traces=False, device=None):
        self.device = dev = resolve_device(device)
        if smplh.device != dev:
            raise ValueError(f"smplh lives on {smplh.device}, fitter on {dev}")
        self.generator = Generator(model, sampler_cfg, device=dev)
        self.model = self.generator.model
        self.smplh = smplh
        self.cfg = cfg
        self.weights = weights if weights is not None else L.BEHAVE_WEIGHTS
        tv = np.asarray(template_verts, np.float32)
        tv = tv - tv.mean(0)  # centre the template
        self.template_verts = tv
        self.template_faces = np.asarray(template_faces, np.int32)
        self.pca_init = torch.as_tensor(pca_axes(tv), device=dev)
        self.obj_points = torch.as_tensor(
            sample_surface(tv, self.template_faces, cfg.obj_samples),
            device=dev)
        self.assets_dir = assets_dir
        self.part_labels = torch.as_tensor(
            load_part_labels(assets_dir), dtype=torch.int64, device=dev)
        self.smpl_faces = torch.as_tensor(smplh.faces, dtype=torch.int64,
                                          device=dev)
        self.body_prior = make_body_prior(assets_dir, dev)
        self.hand_prior = make_hand_prior(assets_dir, dev)
        self.camera = PerspectiveCamera(crop_size=cfg.crop_size)
        self.record_traces = record_traces
        self.timer = StepTimer()  # per-stage wall time, see timer.summary()

    # ------------------------------------------------------------------ #
    def _query(self, feats, tmpx, points, crop_center):
        """Last-stack field query; the net is frozen, gradients flow to the
        points only."""
        return self.model.query_last(feats, tmpx, points, crop_center,
                                     frozen_features=True)

    def smpl_height(self, smpl_params):
        v = self.smplh.verts(smpl_params)
        return v[..., 1].max(-1).values - v[..., 1].min(-1).values  # (B,)

    def _run(self, loss_fn, params, spec, generator, prev_loss, traces,
             iters, name):
        """run_phase, keeping the iteration count and, when record_traces,
        the per-step trace."""
        out = run_phase(loss_fn, params, spec, generator, prev_loss=prev_loss,
                        record=self.record_traces)
        if self.record_traces:
            traces[name] = out[3]
        iters[name] = out[2]
        return out[0], out[1]

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def fit_smpl(self, feats, tmpx, crop_center, mocap_pose, mocap_betas,
                 human_t, kpts2d, generator=None):
        """SMPL phases. Returns (smpl_params, scale, traces, iters); scale
        is the body-height ratio after/before, the object scale init."""
        cfg = self.cfg
        smpl_params = init_params(mocap_pose, mocap_betas, human_t,
                                  self.assets_dir, self.device)
        pose_init = pack_pose(smpl_params)[:, 3:72].clone()
        height_init = self.smpl_height(smpl_params)
        B = human_t.shape[0]
        labels = self.part_labels[None].expand(B, -1)

        def smpl_losses(sp, decay, kpts_w=None):
            """kpts_w: None = no j2d term (phase 'global'); else a 0/1
            weight, the kpts switch inside one phase."""
            ld = {}
            verts = self.smplh.verts(sp)
            preds = self._query(feats, tmpx, verts, crop_center)
            ld["df_h"] = L.df_h_loss(preds["df"][..., 0])
            pose = pack_pose(sp)
            ld["pose"] = self.body_prior(pose).mean()
            ld["hand"] = self.hand_prior(pose).mean()
            ld["part"] = L.part_ce_loss(preds["parts"], labels)
            joints = self.smplh.get_landmarks(sp, verts=verts)[0]
            ld["smplz"] = L.smplz_loss(joints, cfg.z0)
            ld["pinit"] = L.pinit_loss(pose, pose_init)
            if kpts_w is not None:
                ld["j2d"] = kpts_w * L.j2d_loss(joints, kpts2d, crop_center,
                                                self.camera, cfg.net_in_size)
            return L.weighted_sum(ld, self.weights, decay), ld

        traces, iters = {}, {}
        # 'global': top betas + trans at lr .02; prev_loss starts at 300
        spec = PhaseSpec(lr=0.02, n_iters=cfg.iter_betas,
                         steps_per_iter=cfg.steps_per_iter,
                         trainable=freeze_all_except(
                             smpl_params, "top_betas", "trans"))
        smpl_params, prev = self._run(
            lambda p, it, g: smpl_losses(p, 1.0), smpl_params, spec,
            generator, 300.0, traces, iters, "global")

        # 'smpl all pose' + 'kpts': one optimizer lifetime; j2d switches on
        # and decay becomes (global it)/3 at local it >= iter_pose
        spec = PhaseSpec(
            lr=0.006,
            n_iters=cfg.iter_pose + cfg.iter_kpts_max + cfg.iter_kpts,
            steps_per_iter=cfg.steps_per_iter,
            trainable=freeze_all_except(
                smpl_params, "trans", "global_pose", "body_pose",
                "top_betas", "other_betas"),
            early_stop_min_iter=0.25 * cfg.iter_kpts_max + cfg.iter_pose,
            early_stop_rel=1e-3)

        def pose_kpts_losses(p, it, g):
            in_kpts = it >= cfg.iter_pose
            decay = (it + cfg.iter_betas) / 3.0 if in_kpts else 1.0
            return smpl_losses(p, decay, kpts_w=float(in_kpts))

        smpl_params, _ = self._run(pose_kpts_losses, smpl_params, spec,
                                   generator, prev, traces, iters,
                                   "pose_kpts")
        scale = self.smpl_height(smpl_params) / height_init
        return smpl_params, scale, traces, iters

    # ------------------------------------------------------------------ #
    def transform_obj(self, obj_params, R=None):
        """scale * (samples @ R + t) of the template's surface samples; R is
        ``obj_R`` projected to SO(3) unless passed in."""
        if R is None:
            R = project_so3(obj_params["obj_R"])
        v = (torch.einsum("nd,bde->bne", self.obj_points, R)
             + obj_params["obj_t"][:, None])
        return v * obj_params["obj_s"][:, None, None]

    @torch.no_grad()
    def fit_object(self, feats, tmpx, crop_center, smpl_params,
                   obj_center_rel, obj_pca_pred, human_t, scale,
                   generator=None, use_sil=False):
        """Object init from the network's predictions, then the object
        phases. Returns (obj_params, traces, iters)."""
        if use_sil:
            raise NotImplementedError("silhouette phase: slice 2")
        cfg = self.cfg
        B = human_t.shape[0]
        obj_params = {
            "obj_R": init_object_orientation(
                obj_pca_pred, self.pca_init[None].expand(B, 3, 3)),
            "obj_t": obj_center_rel + human_t,
            "obj_s": scale,
        }
        # SMPL is frozen here: one field query at its verts serves the
        # whole chain (centre prediction and the contact loss's human side)
        smpl_verts = self.smplh.verts(smpl_params)
        normals = L.vertex_normals(smpl_verts, self.smpl_faces)
        preds_h = self._query(feats, tmpx, smpl_verts, crop_center)
        smpl_center_pred = preds_h["centers"][..., :3].mean(dim=1)

        def obj_losses(op, phase, decay, g):
            ld = {}
            # one SO(3) projection per step shared by every term
            R = (project_so3_jittered(op["obj_R"], g) if cfg.svd_jitter
                 else project_so3(op["obj_R"]))
            obj = self.transform_obj(op, R=R)
            preds_o = self._query(feats, tmpx, obj, crop_center)
            ld["object"] = L.df_o_loss(preds_o["df"][..., 1])
            ld["scale"] = L.scale_loss(op["obj_s"], cfg.obj_scale)
            obj_center_pred = smpl_center_pred + preds_o["centers"][..., 3:].mean(
                dim=1)
            ld["ocent"] = L.ocent_loss(obj, obj_center_pred)
            if phase == "joint":
                ld["contact"] = L.contact_loss(
                    smpl_verts, obj,
                    df_hum_o=preds_h["df"][..., 1],
                    df_obj_h=preds_o["df"][..., 0],
                    part_labels_h=self.part_labels,
                    part_labels_o=torch.argmax(preds_o["parts"], -1),
                    thresh=cfg.contact_thresh)
                ld["collide"] = L.collision_loss(smpl_verts, normals, obj)
            return L.weighted_sum(ld, self.weights, decay), ld

        traces, iters = {}, {}
        spec = PhaseSpec(lr=0.006, n_iters=cfg.iter_obj,
                         steps_per_iter=cfg.steps_per_iter)
        obj_params, prev = self._run(
            lambda p, it, g: obj_losses(p, "obj", 1.0, g), obj_params, spec,
            generator, 300.0, traces, iters, "obj")

        # 'joint': the reference's stop gate counts global iterations and
        # the phase starts at global iter_obj, so the local gate is
        # 0.25*max_iter - iter_obj; decay continues (global_it - iter_obj + 1)/5
        start, off = cfg.iter_obj, 1.0
        spec = PhaseSpec(lr=0.002, n_iters=cfg.iter_joint_max + cfg.iter_joint,
                         steps_per_iter=cfg.steps_per_iter,
                         trainable=freeze_all_except(obj_params, "obj_t",
                                                     "obj_s"),
                         early_stop_min_iter=0.25 * cfg.iter_joint_max - start,
                         early_stop_rel=1e-4)
        obj_params, _ = self._run(
            lambda p, it, g: obj_losses(p, "joint", (it + off) / 5.0, g),
            obj_params, spec, generator, prev, traces, iters, "joint")
        return obj_params, traces, iters

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def fit_batch(self, images, crop_center, mocap_poses, mocap_betas,
                  kpts2d, generator=None, use_silhouette=True,
                  block_per_stage=False, draws=None):
        """Full per-batch reconstruction.

        Args:
          images: (B, S, S, 5) net input (channels-last RGBM3).
          crop_center: (B, 2).
          mocap_poses: (B, 72) SMPL pose init; mocap_betas: (B, 10).
          kpts2d: (B, 25, 3) openpose keypoints in net-input pixels + conf.
          generator: torch.Generator on the fitter's device for every
            random draw (point generation, SVD jitter); seed 0 if None.
          use_silhouette: the 'sil' phase is not ported yet: True raises.
          block_per_stage: synchronize the card after each stage, so
            ``timer.summary()`` holds true per-stage wall times.
          draws: optional injected point-generation draws (tests).

        Returns dict with smpl params, object params, obj_R, the generated
        point clouds, the scale init, and the iterations run per phase.
        """
        if use_silhouette:
            raise NotImplementedError("silhouette phase: slice 2")
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def sync():
            if block_per_stage and dev.type == "cuda":
                torch.cuda.synchronize(dev)

        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
            dtype=torch.float32, device=dev)
        crop_center = f32(crop_center)
        with self.timer.phase("encode"):
            feats, tmpx = self.generator.encode(f32(images))
            sync()
        with self.timer.phase("generate_pclouds"):
            pc = self.generator.generate_from_feats(
                feats, tmpx, crop_center, generator, draws)
            sync()

        human_t = pc["human"]["centers"][:, :3].clone()
        human_t[:, 2] = self.cfg.z0
        with self.timer.phase("optimize_smpl"):
            smpl_params, scale, smpl_trace, iters = self.fit_smpl(
                feats, tmpx, crop_center, f32(mocap_poses), f32(mocap_betas),
                human_t, f32(kpts2d), generator)
            sync()
        with self.timer.phase("optimize_object"):
            obj_params, obj_trace, obj_iters = self.fit_object(
                feats, tmpx, crop_center, smpl_params,
                pc["object"]["centers"][:, 3:], pc["object"]["pca_axis"],
                human_t, scale, generator)
            sync()
        out = {
            "smpl_params": smpl_params,
            "obj_params": obj_params,
            "obj_R": project_so3(obj_params["obj_R"]),
            "pclouds": pc,
            "scale": scale,
            "iters": {**iters, **obj_iters},
        }
        if self.record_traces:
            out["smpl_trace"] = smpl_trace
            out["obj_trace"] = obj_trace
        return out
