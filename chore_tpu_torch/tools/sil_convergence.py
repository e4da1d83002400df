"""Silhouette-phase convergence study at realistic template scale.
Counterpart of ``tools/sil_convergence.py``.

Measures the recovery basin of the 'sil' phase (soft-silhouette gradients,
kernels K2/K3) on a concave, multi-part, high-face-count template (the
procedural chair, ``utils.meshio.chair_mesh``) with person occlusion, run
through the production phase schedule (iter_sil=50 x 10 steps, lr .006,
decay it+1, trans/scale regularized to the perturbed init -- what a real
fit sees).

All perturbation rows run as ONE batched ``ReconFitter.fit_object`` call.

Usage:  python -m chore_tpu_torch.tools.sil_convergence [--subdiv 3]
            [--iters 50] [--rend 256] [--anneal 1.0] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

# perturbation grid: (rot deg, |trans| m, scale factor)
GRID = [(5, 0.03, 1.05), (10, 0.05, 1.05), (20, 0.08, 1.10),
        (30, 0.10, 1.10), (45, 0.15, 1.15), (60, 0.20, 1.15),
        (90, 0.25, 1.20), (15, 0.05, 0.90)]
R_GT_AXIS, R_GT_DEG = [0.2, 1.0, 0.1], 25.0
T_GT = np.array([0.10, -0.10, 2.30], np.float32)
CROP_CENTER = np.array([[1018.0, 779.0]], np.float32)


def rot_axis(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(
        np.float32)


def geodesic_deg(Ra, Rb):
    tr = np.trace(Ra.T @ Rb)
    return float(np.rad2deg(np.arccos(np.clip((tr - 1) / 2, -1, 1))))


def make_masks(chair_v, chair_f, R_gt, t_gt, s_gt, cc, net_input=512,
               device=None):
    """GT object + person masks in net-input space: chair hard-rasterized
    at the GT pose, occluded by a person stand-in sphere in front."""
    from chore_tpu_torch import resolve_device
    from chore_tpu_torch.ops.camera import PerspectiveCamera
    from chore_tpu_torch.ops.rasterizer import hard_rasterize
    from chore_tpu_torch.utils.meshio import octasphere

    dev = resolve_device(device)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev)
    cam = PerspectiveCamera()
    world = (chair_v @ R_gt + t_gt) * s_gt
    ndc = cam.project_points(t(world[None]), t(cc))
    fid_obj, _, _ = hard_rasterize(ndc, t(chair_f, torch.int64),
                                   image_size=net_input)
    sv, sf = octasphere(radius=0.22, center=(0.0, 0.0, 0.0), subdiv=3)
    sphere = sv + np.array([t_gt[0] - 0.18, t_gt[1] + 0.05, t_gt[2] - 0.25],
                           np.float32)
    ndc_p = cam.project_points(t(sphere[None]), t(cc))
    fid_per, _, _ = hard_rasterize(ndc_p, t(sf, torch.int64),
                                   image_size=net_input)
    obj = fid_obj[0].cpu().numpy() >= 0
    per = fid_per[0].cpu().numpy() >= 0
    # the detected object mask is the VISIBLE part (person in front wins)
    obj_visible = obj & ~per
    return obj_visible.astype(np.float32), per.astype(np.float32)


def perturbations(rng, R_gt, grid=GRID):
    """(R_init (B, 3, 3), t_init (B, 3), s_init (B,)) of the grid's rows,
    each rotation about a random axis and each translation along a random
    direction, drawn from ``rng``."""
    B = len(grid)
    R_init = np.stack([
        R_gt @ rot_axis(rng.randn(3), deg) for deg, _, _ in grid])
    dirs = rng.randn(B, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t_init = T_GT[None] + dirs * np.array([d for _, d, _ in grid])[:, None]
    s_init = np.array([s for _, _, s in grid], np.float32)
    return R_init, t_init, s_init


def study(subdiv=3, iters=50, rend=256, seed=0, anneal=1.0, device=None,
          grid=GRID, verbose=True):
    """The study: {"faces", "anchor": {loss, iou}, "wall_s", "rows": [...]}.
    ``wall_s`` is the batched sil run alone (the card synchronised)."""
    from chore_tpu_torch import resolve_device
    from chore_tpu_torch.models import FieldConfig, build_field
    from chore_tpu_torch.ops.rotation import project_so3
    from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
    from chore_tpu_torch.recon.silhouette import (
        SilhouetteLossROI,
        silhouette_loss,
    )
    from chore_tpu_torch.smpl import SMPLH, init_params, synthetic_smplh
    from chore_tpu_torch.utils.meshio import chair_mesh

    say = print if verbose else (lambda *a, **k: None)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    chair_v, chair_f = chair_mesh(subdiv)
    say(f"chair: {len(chair_v)} verts, {len(chair_f)} faces")

    R_gt = rot_axis(R_GT_AXIS, R_GT_DEG)
    t_gt, s_gt, cc = T_GT, 1.0, CROP_CENTER
    obj_mask, per_mask = make_masks(chair_v, chair_f, R_gt, t_gt, s_gt, cc,
                                    device=dev)
    say(f"GT mask px: obj {int(obj_mask.sum())}, person-overlap "
        f"{int((per_mask * obj_mask).sum())}, person {int(per_mask.sum())}")

    B = len(grid)
    R_init, t_init, s_init = perturbations(rng, R_gt, grid)

    # tiny random field (unused by the sil loss; the obj/joint phases are
    # disabled so only the sil schedule runs)
    model = build_field(FieldConfig(num_stack=1), device=dev)
    smplh = SMPLH(synthetic_smplh(), device=dev)
    cfg = FitConfig(iter_obj=0, iter_sil=iters, iter_joint=0,
                    iter_joint_max=0, sil_rend_size=rend,
                    sil_sigma_anneal=anneal)
    fitter = ReconFitter(model, smplh, chair_v, chair_f, cfg=cfg, device=dev)
    # so pca_pred == R_init IS the init rotation
    fitter.pca_init = torch.eye(3, device=dev)

    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=dev)
    ccB = np.tile(cc, (B, 1))
    sil = SilhouetteLossROI(
        np.tile(per_mask[None], (B, 1, 1)), np.tile(obj_mask[None], (B, 1, 1)),
        chair_v, chair_f, ccB, rend_size=rend)
    sil_t = sil.tensors(dev)
    verts_t = t(chair_v)
    faces_t = torch.as_tensor(chair_f, dtype=torch.int64, device=dev)
    human_t = np.tile(np.array([[0.0, 0.0, 2.2]], np.float32), (B, 1))
    smpl_params = init_params(np.zeros((B, 72), np.float32),
                              np.zeros((B, 10), np.float32), human_t,
                              device=dev)
    feats, tmpx = fitter.generator.encode(
        np.zeros((B, 64, 64, 5), np.float32))

    # sanity anchor: at the GT pose the rendered soft sil must match
    # image_ref nearly perfectly; if not, the study is measuring a
    # coordinate bug, not the optimizer basin
    with torch.no_grad():
        loss_gt, img_gt = silhouette_loss(
            sil_t, verts_t, faces_t, t(np.tile(R_gt[None], (B, 1, 1))),
            t(np.tile(t_gt[None], (B, 1))), t(np.full((B,), s_gt)), rend)
    img_gt = img_gt.cpu().numpy()
    ref = sil.data["image_ref"]
    inter = ((img_gt[0] > 0.5) & (ref[0] > 0.5)).sum()
    union = ((img_gt[0] > 0.5) | (ref[0] > 0.5)).sum()
    anchor = {"loss": float(loss_gt), "iou": float(inter / max(union, 1))}
    say(f"GT-pose anchor: loss {anchor['loss']:.1f}, "
        f"IoU {anchor['iou']:.3f} (must be ~>0.9)")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out, _, iters_run = fitter.fit_object(
        feats, tmpx, t(ccB), smpl_params, t(t_init - human_t), t(R_init),
        t(human_t), t(s_init),
        generator=torch.Generator(device=dev).manual_seed(1),
        sil_data=sil_t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    with torch.no_grad():
        R_fin_t = project_so3(out["obj_R"])
        _, img = silhouette_loss(sil_t, verts_t, faces_t, R_fin_t,
                                 out["obj_t"], out["obj_s"], rend)
    img = img.cpu().numpy()
    R_fin = R_fin_t.cpu().numpy()
    obj_t = out["obj_t"].cpu().numpy()
    obj_s = out["obj_s"].cpu().numpy()

    # per-example masked L2 at final vs GT pose: separates optimizer
    # failure (final > GT) from landscape failure (final < GT but wrong)
    keep = sil.data["keep_mask"]
    l2_fin = ((keep * img - ref) ** 2).sum(axis=(1, 2))
    l2_gt = ((keep * img_gt - ref) ** 2).sum(axis=(1, 2))

    say(f"\nsil phase: {iters} iters x 10 steps, {len(chair_f)} faces, "
        f"{rend}^2 render, batch {B}, wall {wall:.1f}s")
    say(f"{'pert (deg, m, s)':>22} | {'rot_err0':>8} {'rot_err':>8} "
        f"{'t_err0':>7} {'t_err':>7} {'s_err':>6} {'IoU':>5} "
        f"{'L2fin':>7} {'L2gt':>6} rec")
    rows = []
    for i, g in enumerate(grid):
        rot0 = geodesic_deg(R_init[i], R_gt)
        rot1 = geodesic_deg(R_fin[i], R_gt)
        te0 = float(np.linalg.norm(s_init[i] * t_init[i] - s_gt * t_gt))
        te1 = float(np.linalg.norm(obj_s[i] * obj_t[i] - s_gt * t_gt))
        se = abs(float(obj_s[i]) - s_gt)
        inter = ((img[i] > 0.5) & (ref[i] > 0.5)).sum()
        union = ((img[i] > 0.5) | (ref[i] > 0.5)).sum()
        iou = float(inter / max(union, 1))
        rec = rot1 < 8.0 and te1 < 0.05 and iou > 0.75
        rows.append(dict(grid=g, rot0=rot0, rot1=rot1, te0=te0, te1=te1,
                         se=se, iou=iou, l2_fin=float(l2_fin[i]),
                         l2_gt=float(l2_gt[i]), recovered=bool(rec)))
        say(f"{str(g):>22} | {rot0:8.1f} {rot1:8.1f} {te0:7.3f} "
            f"{te1:7.3f} {se:6.3f} {iou:5.2f} {l2_fin[i]:7.0f} "
            f"{l2_gt[i]:6.0f} {'YES' if rec else 'no'}")
    return {"faces": len(chair_f), "anchor": anchor, "wall_s": wall,
            "iters": iters_run, "rows": rows}


def run_study(subdiv=3, iters=50, rend=256, seed=0, anneal=1.0, device=None):
    """The per-row results of ``study`` (the reference tool's return)."""
    return study(subdiv, iters, rend, seed, anneal, device)["rows"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rend", type=int, default=256)
    ap.add_argument("--anneal", type=float, default=1.0,
                    help="coarse-to-fine start sigma multiplier "
                         "(FitConfig.sil_sigma_anneal; 1.0 = off)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the host")
    args = ap.parse_args(argv)
    run_study(args.subdiv, args.iters, args.rend, anneal=args.anneal,
              device=args.device)


if __name__ == "__main__":
    main()
