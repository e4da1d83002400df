"""Bisect the object-reconstruction pipeline on the synthetic e2e scene.
Counterpart of ``tools/diag_object.py``.

Measures every stage of the object path in isolation:

  field      mean |df_o| on the GT object surface, and the df_o profile
             along the camera ray through the GT center (where is the
             field's depth minimum vs the GT depth?)
  centers    predicted obj center (smpl_center_pred + rel offset) vs GT
  pcloud     centroid offset + chamfer of the generated object point cloud
  fit        object chamfer after the 'object only' phase alone, after the
             full schedule, and after the full schedule with a
             GT-center-corrected init (the depth-ambiguity control: if
             THIS collapses the error, the field init is the bottleneck;
             if not, the optimization drags it off)

Usage: python -m chore_tpu_torch.tools.diag_object [--epochs 40]
           [--frames 8] [--device cpu]
Prints one JSON line with every stage's numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from chore_tpu_torch.tools.e2e_synthetic import (
    build_scenes,
    train_field,
    val_item,
    zero_conf_kpts,
)


def chamfer_np(a, b):
    """Bidirectional sqrt chamfer on host (small clouds)."""
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    return d.min(1).mean() + d.min(0).mean()


def with_center(fitter, center):
    """Make ``fitter``'s object chain start at the world point ``center``:
    its ``fit_object`` is wrapped on the instance to replace the predicted
    object centre (relative to the human translation)."""
    orig = fitter.fit_object

    def fit_object(feats, tmpx, crop_center, smpl_params, obj_center_rel,
                   *rest, **kw):
        human_t = rest[1]
        rel = torch.as_tensor(
            (center[None] - human_t.cpu().numpy()).astype(np.float32),
            device=human_t.device)
        return orig(feats, tmpx, crop_center, smpl_params, rel, *rest, **kw)

    fitter.fit_object = fit_object
    return fitter


def field_report(model, images, crop_center, gt_obj_v, gt_obj_f, gt_center):
    """The field's own quality at the GT object: mean |df_o| on its
    surface, the depth of the df_o minimum along the view ray through its
    centre, and the error of the predicted centres."""
    from chore_tpu_torch.utils.meshio import sample_surface

    dev = crop_center.device
    report = {}
    with torch.no_grad():
        feats, tmpx = model.encode(images, train=False)

        def query(points):
            return model.query_last(feats, tmpx, torch.as_tensor(
                points, dtype=torch.float32, device=dev), crop_center)

        surf = sample_surface(gt_obj_v, gt_obj_f, 2000)[None]
        preds_surf = query(surf)
        report["field_df_o_on_gt_surface"] = float(
            preds_surf["df"][..., 1].abs().mean())
        # view ray through the GT center: where is the df_o minimum?
        ts = np.linspace(-0.4, 0.4, 161, dtype=np.float32)
        norm = np.linalg.norm(gt_center)
        ray = (gt_center[None] / norm)[None] * (norm + ts)[None, :, None]
        df_ray = query(ray.astype(np.float32))["df"][0, :, 1].cpu().numpy()
        report["ray_depth_offset_m"] = float(ts[int(df_ray.argmin())])
        report["ray_df_min"] = float(df_ray.min())
        # predicted centers at the GT surface (what ocent consumes)
        smpl_c = preds_surf["centers"][0, :, :3].mean(0).cpu().numpy()
        rel = preds_surf["centers"][0, :, 3:].mean(0).cpu().numpy()
    report["pred_center_err_m"] = float(
        np.linalg.norm(smpl_c + rel - gt_center))
    return report


def diagnose(model, smplh, gt0, path0, img_size, fit_cfg=None,
             sampler_cfg=None):
    """Every stage's numbers for frame 0. ``fit_cfg``: the full schedule
    (default the e2e check's); ``sampler_cfg``: the point generation's
    (default 4,000 points)."""
    from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
    from chore_tpu_torch.recon.generator import SamplerConfig
    from chore_tpu_torch.utils.meshio import sample_surface

    dev = smplh.device
    gt_obj_v, gt_obj_f = gt0["obj"]
    gt_center = gt_obj_v.mean(0)
    base = fit_cfg or FitConfig(net_in_size=img_size, sil_rend_size=128)
    samp = sampler_cfg or SamplerConfig(num_points=4000)
    item = val_item(path0, img_size)
    images = torch.as_tensor(item["images"][None], device=dev)
    crop_center = torch.as_tensor(item["crop_center"][None], device=dev)

    report = field_report(model, images, crop_center, gt_obj_v, gt_obj_f,
                          gt_center)

    # ---- stage: generated point cloud ----------------------------------
    def make(cfg):
        return ReconFitter(model, smplh, gt_obj_v - gt_obj_v.mean(0),
                           gt_obj_f, cfg=cfg, sampler_cfg=samp, device=dev)

    pc = make(base).generator.generate_pclouds(
        images, crop_center, torch.Generator(device=dev).manual_seed(1))
    opts = pc["object"]["points"][0].cpu().numpy()
    report["pcloud_n_valid"] = int(pc["object"]["n_valid"][0])
    report["pcloud_centroid_err_m"] = float(
        np.linalg.norm(opts.mean(0) - gt_center))
    gt_samp = sample_surface(gt_obj_v, gt_obj_f, 2000)
    report["pcloud_chamfer_m"] = float(chamfer_np(opts[:2000], gt_samp))

    # ---- stage: fits ----------------------------------------------------
    kpts = zero_conf_kpts(img_size)

    def run_fit(cfg, center_override=None):
        f = make(cfg)
        if center_override is not None:
            with_center(f, center_override)
        out = f.fit_batch(item["images"][None], item["crop_center"][None],
                          gt0["pose"], np.zeros((1, 10), np.float32), kpts,
                          use_silhouette=False)
        rec = f.transform_obj(out["obj_params"],
                              points=f.template_verts)[0].cpu().numpy()
        return (float(chamfer_np(sample_surface(rec, gt_obj_f, 2000),
                                 gt_samp)),
                float(np.linalg.norm(rec.mean(0) - gt_center)))

    # object-only phase (joint budget zeroed)
    cham, cerr = run_fit(dataclasses.replace(base, iter_joint=0,
                                             iter_joint_max=0))
    report["fit_objonly_chamfer_m"] = cham
    report["fit_objonly_center_err_m"] = cerr
    cham, cerr = run_fit(base)
    report["fit_full_chamfer_m"] = cham
    report["fit_full_center_err_m"] = cerr
    # full schedule with GT-center-corrected init (depth-ambiguity control)
    cham, cerr = run_fit(base, center_override=gt_center)
    report["fit_gtinit_chamfer_m"] = cham
    report["fit_gtinit_center_err_m"] = cerr
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in report.items()}


def run(args, fit_cfg=None, sampler_cfg=None):
    from chore_tpu_torch import resolve_device

    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    paths, gt0, smplh = build_scenes(args.out, args.frames, rng,
                                     device=device)
    # the same training regime as the e2e check (shared helper)
    model, _, losses = train_field(
        paths, args.out, args.epochs, num_stack=args.num_stack,
        img_size=args.img_size, verbose=False, device=device)
    print(f"trained {args.epochs} epochs, final loss {losses[-1]:.2f}",
          file=sys.stderr)
    return diagnose(model, smplh, gt0, paths[0], args.img_size, fit_cfg,
                    sampler_cfg)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="/tmp/diag_obj")
    ap.add_argument("--num-stack", type=int, default=2)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the host")
    return ap


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))))


if __name__ == "__main__":
    main()
