"""Multi-phase joint SMPL + object fitting against the neural fields.

Counterpart of ``chore_tpu/recon/fitter.py`` on its staged path
(``fit_batch`` -> encode -> point generation -> SMPL chain -> object chain),
with the phase schedule kept exactly:

  SMPL:   'global' (top betas + trans, lr .02)
          -> 'smpl all pose' + 'kpts' as ONE phase (all pose + betas +
             trans, lr .006; j2d switches on and the decay becomes it/3 at
             the kpts boundary without resetting Adam)
  object: 'object only' x20 (R, t, s; lr .006)
          -> 'sil' x50 (R, t, s; silhouette + trans/scale regs; lr .006,
             no early stop; kernels K2/K3 render every step)
          -> 'joint' x<=110 (t, s only; +contact +collision; lr .002,
             early stop, decay (it+1)/5 continuing the global schedule)

``fit_batch(use_silhouette=False)`` skips the 'sil' phase. With a ``mesh``
(``parallel.make_mesh()``, one process per device) the frames of a batch are
split over the ranks: the field is replicated, each rank fits its own slice,
every loss term becomes the rank's share of the global batch's value, each
optimizer step sums the loss over the ranks, and every random draw is made at
the global batch's shape from the same seeded generator on every rank, each
rank keeping its slice -- so the ranks compute what one process computes on
the whole batch, up to the rounding of float sums taken in another order or
by kernels chosen for another shape. ``chore_tpu``'s
``fused_pipeline`` (one XLA program per fit, a TPU dispatch workaround) has
no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.ops.camera import PerspectiveCamera, Z0
from chore_tpu_torch.ops.chamfer import nn_sqdist_multi
from chore_tpu_torch.ops.rotation import (
    init_object_orientation,
    project_so3,
    project_so3_jittered,
    so3_jitter,
)
from chore_tpu_torch.parallel.mesh import local_batch_slice, replicate
from chore_tpu_torch.recon import losses as L
from chore_tpu_torch.recon.generator import (
    Generator,
    SamplerConfig,
    make_draws,
)
from chore_tpu_torch.recon.optimize import PhaseSpec, freeze_all_except, run_phase
from chore_tpu_torch.recon.silhouette import (
    SilhouetteLossROI,
    offscreen_loss,
    silhouette_loss,
)
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
    iter_sil: int = 50
    iter_joint: int = 10  # extends the joint budget
    iter_joint_max: int = 100
    steps_per_iter: int = 10
    obj_samples: int = 3000  # template surface samples
    net_in_size: int = 512
    z0: float = Z0
    obj_scale: float = 1.0
    contact_thresh: float = 0.08
    sil_rend_size: int = 256
    crop_size: int = 1200
    # 1e-4 uniform jitter on the optimized rotation before each SVD
    # projection; off for deterministic parity tests
    svd_jitter: bool = True
    # opt-in coarse-to-fine sigma annealing in the sil phase: sigma starts
    # widened by this factor and narrows geometrically to 1x over
    # `sil_anneal_levels` stages (1.0 = off, the reference schedule)
    sil_sigma_anneal: float = 1.0
    sil_anneal_levels: int = 4
    # opt-in offscreen guard in the sil phase: a hinge that keeps a badly
    # initialized object from minimizing the mask L2 by leaving the ROI
    offscreen_guard: bool = False


class ReconFitter:
    """Fits SMPL-H + object 6DoF/scale to the neural fields of one batch.

    Args:
      model: a CHOREField (weights included); moved to ``device`` and frozen.
      smplh: SMPLH on the same device.
      template_verts/template_faces: canonical object template (numpy).
      weights: loss weight table (L.BEHAVE_WEIGHTS by default).
      mesh: optional ``parallel.Mesh`` for data-parallel fitting: the
        model's weights are broadcast from rank 0, and ``fit_batch`` fits
        this rank's slice of the global batch (see the module docstring).
      record_traces: fit results carry the per-step loss traces of every
        phase under 'smpl_trace'/'obj_trace' (debugging and parity tests).
      device: the card unless ``device="cpu"``; the mesh's device by
        default when there is a mesh.
    """

    def __init__(self, model, smplh: SMPLH, template_verts, template_faces,
                 weights=None, cfg: FitConfig = FitConfig(),
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 assets_dir=None, mesh=None, record_traces=False,
                 device=None):
        if device is None and mesh is not None:
            device = mesh.device
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        if smplh.device != dev:
            raise ValueError(f"smplh lives on {smplh.device}, fitter on {dev}")
        self.generator = Generator(model, sampler_cfg, device=dev)
        self.model = replicate(self.generator.model, mesh)
        self.smplh = smplh
        self.cfg = cfg
        self.weights = weights if weights is not None else L.BEHAVE_WEIGHTS
        tv = np.asarray(template_verts, np.float32)
        tv = tv - tv.mean(0)  # centre the template
        self.template_verts = tv
        self.template_faces = np.asarray(template_faces, np.int32)
        # the sil phase renders the template mesh itself
        self.mesh_verts = torch.as_tensor(tv, device=dev)
        self.mesh_faces = torch.as_tensor(self.template_faces,
                                          dtype=torch.int64, device=dev)
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
        """run_phase under the timer phase ``phase_<name>`` (every step
        reads its loss back, so this is the phase's wall time), keeping the
        iteration count and, when record_traces, the per-step trace."""
        with self.timer.phase(f"phase_{name}"):
            out = run_phase(loss_fn, params, spec, generator,
                            prev_loss=prev_loss, record=self.record_traces,
                            mesh=self.mesh)
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
            ld = self._shares(ld)
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
    def transform_obj(self, obj_params, R=None, points=None):
        """scale * (points @ R + t), of the template's surface samples unless
        ``points`` (e.g. ``template_verts``) are given; R is ``obj_R``
        projected to SO(3) unless passed in."""
        if R is None:
            R = project_so3(obj_params["obj_R"])
        pts = (self.obj_points if points is None
               else torch.as_tensor(points, dtype=torch.float32,
                                    device=self.device))
        v = (torch.einsum("nd,bde->bne", pts, R)
             + obj_params["obj_t"][:, None])
        return v * obj_params["obj_s"][:, None, None]

    def _shares(self, ld):
        """Under a mesh, this rank's share of each term of the global
        batch's loss: a mean over the rank's equal slice divided by the
        rank count; the contact term, whose pair count is already the
        global batch's (``contact_loss(mesh=)``), as it is."""
        if self.mesh is None or self.mesh.size == 1:
            return ld
        return {k: v if k == "contact" else v / self.mesh.size
                for k, v in ld.items()}

    def _project_jittered(self, mat, generator):
        """``project_so3_jittered`` with the jitter drawn at the global
        batch's shape (this rank keeping its slice) under a mesh."""
        if self.mesh is None:
            return project_so3_jittered(mat, generator)
        n, B = self.mesh.size, mat.shape[0] * self.mesh.size
        noise = so3_jitter((B,) + mat.shape[1:], generator, mat.device,
                           mat.dtype)
        return project_so3_jittered(
            mat, noise=noise[local_batch_slice(B, n, self.mesh.rank)])

    def _sil_sigma(self, it):
        """Coverage sigma of sil-phase iteration ``it``: None (half a pixel)
        unless annealing, else level min(it*L // iter_sil, L-1) of
        base * anneal^(1 - k/(L-1)), ending at the release sigma."""
        cfg = self.cfg
        nl = cfg.sil_anneal_levels
        if not (cfg.sil_sigma_anneal > 1.0 and nl > 1):
            return None
        level = min(it * nl // max(cfg.iter_sil, 1), nl - 1)
        base = 0.5 * (2.0 / cfg.sil_rend_size)
        return base * cfg.sil_sigma_anneal ** (1.0 - level / (nl - 1))

    @torch.no_grad()
    def fit_object(self, feats, tmpx, crop_center, smpl_params,
                   obj_center_rel, obj_pca_pred, human_t, scale,
                   generator=None, sil_data=None):
        """Object init from the network's predictions, then the object
        phases; the 'sil' phase runs when ``sil_data`` (the tensors of a
        ``SilhouetteLossROI``) is given. Returns (obj_params, traces,
        iters)."""
        cfg = self.cfg
        use_sil = sil_data is not None
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

        def obj_losses(op, phase, decay, g, trans_init=None, it=0):
            """``it`` is the phase-local iteration (the sil anneal level)."""
            ld = {}
            # one SO(3) projection per step shared by every term
            R = (self._project_jittered(op["obj_R"], g) if cfg.svd_jitter
                 else project_so3(op["obj_R"]))
            if phase == "sil":
                ld["mask"], _ = silhouette_loss(
                    sil_data, self.mesh_verts, self.mesh_faces, R,
                    op["obj_t"], op["obj_s"], cfg.sil_rend_size,
                    sigma=self._sil_sigma(it))
                ld["scale"] = L.scale_loss(op["obj_s"], cfg.obj_scale)
                ld["trans"] = ((op["obj_t"] - trans_init) ** 2).mean()
                if cfg.offscreen_guard:
                    ld["offscreen"] = offscreen_loss(
                        sil_data, self.mesh_verts, R, op["obj_t"],
                        op["obj_s"])
                ld = self._shares(ld)
                return L.weighted_sum(ld, self.weights, decay), ld
            obj = self.transform_obj(op, R=R)
            preds_o = self._query(feats, tmpx, obj, crop_center)
            ld["object"] = L.df_o_loss(preds_o["df"][..., 1])
            ld["scale"] = L.scale_loss(op["obj_s"], cfg.obj_scale)
            obj_center_pred = smpl_center_pred + preds_o["centers"][..., 3:].mean(
                dim=1)
            ld["ocent"] = L.ocent_loss(obj, obj_center_pred)
            if phase == "joint":
                contact = dict(df_hum_o=preds_h["df"][..., 1],
                               df_obj_h=preds_o["df"][..., 0],
                               part_labels_h=self.part_labels,
                               part_labels_o=torch.argmax(preds_o["parts"],
                                                          -1),
                               thresh=cfg.contact_thresh)
                # contact h->o, o->h and collision o->h: one K1 launch (the
                # two o->h calls share one scan); the timer's count of
                # "joint_nn" is the number of joint steps
                with self.timer.phase("joint_nn"):
                    nn = nn_sqdist_multi(
                        L.contact_nn_calls(smpl_verts, obj, **contact)
                        + [L.collision_nn_call(smpl_verts, obj)])
                ld["contact"] = L.contact_loss(smpl_verts, obj, **contact,
                                               nn=nn[:2], mesh=self.mesh)
                ld["collide"] = L.collision_loss(smpl_verts, normals, obj,
                                                 nn=nn[2])
            ld = self._shares(ld)
            return L.weighted_sum(ld, self.weights, decay), ld

        traces, iters = {}, {}
        spec = PhaseSpec(lr=0.006, n_iters=cfg.iter_obj,
                         steps_per_iter=cfg.steps_per_iter)
        obj_params, prev = self._run(
            lambda p, it, g: obj_losses(p, "obj", 1.0, g), obj_params, spec,
            generator, 300.0, traces, iters, "obj")

        if use_sil:
            # 'sil': decay it+1 (local it), no early stop; the trans anchor
            # is taken after the object-only phase moved obj_t
            trans_init = obj_params["obj_t"].clone()
            spec = PhaseSpec(lr=0.006, n_iters=cfg.iter_sil,
                             steps_per_iter=cfg.steps_per_iter)
            obj_params, prev = self._run(
                lambda p, it, g: obj_losses(p, "sil", it + 1.0, g,
                                            trans_init, it=it),
                obj_params, spec, generator, prev, traces, iters, "sil")

        # 'joint': the reference's stop gate counts global iterations and
        # the phase starts at global iter_obj [+ iter_sil], so the local
        # gate is 0.25*max_iter - start; decay continues
        # (global_it - iter_obj + 1)/5
        start = cfg.iter_obj + (cfg.iter_sil if use_sil else 0)
        off = (cfg.iter_sil if use_sil else 0.0) + 1.0
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
    def _local_inputs(self, inputs, generator, draws, local_batch):
        """This rank's slice of the inputs, and of the point-generation
        draws made (or injected) at the global batch's shape: the human's
        draws, then the object's, the order in which one process's
        sampler draws them."""
        n, r = self.mesh.size, self.mesh.rank
        B = len(inputs[0]) * (n if local_batch else 1)
        if B % n:
            raise ValueError(f"batch {B} is not a multiple of the mesh's "
                             f"{n} ranks (pad it, as cli.recon does)")
        sl = local_batch_slice(B, n, r)
        if not local_batch:
            inputs = tuple(a[sl] for a in inputs)
        if draws is None:
            draws = {name: make_draws(self.generator.cfg, B, generator,
                                      self.device)
                     for name in ("human", "object")}
        local = {name: {k: v[sl] if k == "init_u" else v[:, sl]
                        for k, v in d.items()}
                 for name, d in draws.items()}
        return inputs + (local,)

    @torch.no_grad()
    def fit_batch(self, images, crop_center, mocap_poses, mocap_betas,
                  kpts2d, generator=None, use_silhouette=True,
                  block_per_stage=False, draws=None, monitor=None,
                  local_batch=False):
        """Full per-batch reconstruction.

        Args:
          images: (B, S, S, 5) net input (channels-last RGBM3): float in
            [0, 1], or uint8 (``BehaveTrainData``'s items) scaled by 1/255.
          crop_center: (B, 2).
          mocap_poses: (B, 72) SMPL pose init; mocap_betas: (B, 10).
          kpts2d: (B, 25, 3) openpose keypoints in net-input pixels + conf.
          generator: torch.Generator on the fitter's device for every
            random draw (point generation, SVD jitter); seed 0 if None.
          use_silhouette: run the 'sil' phase (default); its ROI prep
            reads the host copies of mask channels 3 (person) and 4
            (object).
          block_per_stage: synchronize the card after each stage, so
            ``timer.summary()`` holds true per-stage wall times.
          draws: optional injected point-generation draws (tests), of the
            global batch under a mesh.
          local_batch: under a mesh, the inputs already hold only this
            rank's slice of the global batch (each rank prepared its own
            frames); otherwise they hold the global batch and each rank
            keeps its slice.
          monitor: optional utils.viewer.FitMonitor; snapshots frame 0's
            point clouds after generation, its SMPL mesh after the SMPL
            chain, SMPL and object after the object chain (rendered on the
            fitter's device).

        Returns dict with smpl params, object params, obj_R, the generated
        point clouds, the scale init, and the iterations run per phase;
        under a mesh, of this rank's frames (``parallel.all_gather_batch``
        joins the ranks' results).
        """
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if self.mesh is not None:
            (images, crop_center, mocap_poses, mocap_betas, kpts2d,
             draws) = self._local_inputs(
                (images, crop_center, mocap_poses, mocap_betas, kpts2d),
                generator, draws, local_batch)

        def sync():
            if block_per_stage and dev.type == "cuda":
                torch.cuda.synchronize(dev)

        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
            dtype=torch.float32, device=dev)

        def net_input(a):
            """Float images as float32; integer images keep their dtype,
            the field scales them by 1/255 (a float32 cast would feed it
            0..255)."""
            a = torch.as_tensor(a, device=dev)
            return a.float() if torch.is_floating_point(a) else a

        def host(a):
            return (a.detach().cpu().numpy() if torch.is_tensor(a)
                    else np.asarray(a, np.float32))

        # host copies for the silhouette ROI prep
        images_np = host(images) if use_silhouette else None
        crop_center_np = host(crop_center)
        crop_center = f32(crop_center)
        with self.timer.phase("encode"):
            feats, tmpx = self.generator.encode(net_input(images))
            sync()
        with self.timer.phase("generate_pclouds"):
            pc = self.generator.generate_from_feats(
                feats, tmpx, crop_center, generator, draws)
            sync()
        if monitor is not None:
            monitor.snapshot("pclouds", pclouds={
                "human": host(pc["human"]["points"][0]),
                "object": host(pc["object"]["points"][0]),
            }, device=dev)

        human_t = pc["human"]["centers"][:, :3].clone()
        human_t[:, 2] = self.cfg.z0
        with self.timer.phase("optimize_smpl"):
            smpl_params, scale, smpl_trace, iters = self.fit_smpl(
                feats, tmpx, crop_center, f32(mocap_poses), f32(mocap_betas),
                human_t, f32(kpts2d), generator)
            sync()
        if monitor is not None:
            monitor.snapshot("smpl", meshes=[(
                host(self.smplh.verts(smpl_params))[0],
                np.asarray(self.smplh.faces), monitor.SMPL_COLOR)],
                device=dev)
        sil_data = None
        if use_silhouette:
            with self.timer.phase("silhouette_prep"):
                sil_data = SilhouetteLossROI(
                    images_np[..., 3], images_np[..., 4],
                    self.template_verts, self.template_faces,
                    crop_center_np,
                    rend_size=self.cfg.sil_rend_size,
                    crop_size=self.cfg.crop_size,
                    net_input=self.cfg.net_in_size,
                ).tensors(dev)
        with self.timer.phase("optimize_object"):
            obj_params, obj_trace, obj_iters = self.fit_object(
                feats, tmpx, crop_center, smpl_params,
                pc["object"]["centers"][:, 3:], pc["object"]["pca_axis"],
                human_t, scale, generator, sil_data)
            sync()
        if monitor is not None:
            monitor.snapshot("object", meshes=[
                (host(self.smplh.verts(smpl_params))[0],
                 np.asarray(self.smplh.faces), monitor.SMPL_COLOR),
                (host(self.transform_obj(
                    obj_params, points=self.template_verts))[0],
                 self.template_faces, monitor.OBJ_COLOR),
            ], device=dev)
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
