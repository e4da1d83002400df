"""Single-image demo: reconstruct human + object and render overlays
(counterpart of ``chore_tpu/cli/demo.py``): the in-the-wild (COCO-weight,
mean-centre) fitting variant on one image directory, then front/side
renders, the overlay on the photo, and the ply outputs.

Usage:
  python -m chore_tpu_torch.cli.demo [exp_name] -s <image_dir> \\
      [-on basketball] [-o out_dir] [--max-frames N] [--textured-obj OBJ] \\
      [--field-mesh-res R] [--device cpu]
"""
from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from glob import glob

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
from chore_tpu_torch.data.imageio import imwrite, read_bgr
from chore_tpu_torch.recon import losses as L
from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
from chore_tpu_torch.recon.generator import SamplerConfig
from chore_tpu_torch.utils.marching import reconstruction
from chore_tpu_torch.utils.meshio import save_ply
from chore_tpu_torch.utils.render import align_to_input, look_at_side, \
    render_meshes
from chore_tpu_torch.utils.textures import load_obj_textured


@torch.no_grad()
def extract_field_meshes(fitter, images, crop_center, res=128, level=0.01,
                         bounds=((-1.2, -1.2, 1.7), (1.2, 1.2, 2.7))):
    """Marching-tetrahedra meshes of the neural UDF level sets, one per
    head, queried on the fitter's device. Returns {'human': (verts, faces),
    'object': (verts, faces)}. UDFs are unsigned, so the level-set mesh is
    a thin shell around the surface at distance ``level``."""
    dev = fitter.device
    feats, tmpx = fitter.generator.encode(images)
    cc = torch.as_tensor(np.asarray(crop_center, np.float32), device=dev)

    out = {}
    for name, idx in (("human", 0), ("object", 1)):
        def eval_fn(pts, idx=idx):
            p = torch.as_tensor(np.asarray(pts, np.float32), device=dev)
            preds = fitter.model.query_last(feats, tmpx, p[None], cc)
            return preds["df"][0, :, idx].cpu().numpy()

        bmin = np.asarray(bounds[0], np.float32)
        bmax = np.asarray(bounds[1], np.float32)
        out[name] = reconstruction(eval_fn, res, bmin, bmax, level=level)
    return out


def run_demo(cfg: ChoreConfig, seq_folder, obj_name, outpath="demo_out",
             save_name="demo", max_frames=None, use_silhouette=True,
             fit_cfg: FitConfig = None, sampler_cfg: SamplerConfig = None,
             render_size=512, textured_obj=None, field_mesh_res=0,
             exp_root="experiments", device=None):
    """Fit every ``k1.color.jpg`` in ``seq_folder`` (or one level below)
    and write, per frame under OUTPATH/<frame>/<save_name>/: smpl.ply,
    object.ply, human_pc.ply, object_pc.ply, overlay.jpg (the photo's
    size) and side.jpg, plus {human,object}_field.ply when
    ``field_mesh_res``. ``textured_obj``: a textured OBJ used as the object
    template; its texture shows in the renders. ``device``: the card unless
    "cpu"; the fit and the renders run there.

    Returns the fitter; its timer holds the fit's stages and the demo's
    own: demo_prep, demo_fit, field_meshes, ply_writes, render_front,
    align_to_input, jpeg_overlay, render_side, jpeg_side."""
    dev = resolve_device(device)
    model = load_trained(cfg, exp_root=exp_root, device=dev)
    smplh = load_smplh(device=dev)
    tex_data = None
    if textured_obj:
        m = load_obj_textured(textured_obj)
        tv, tf = m["verts"], m["faces"]
        if m["texture"] is not None:
            tex_data = (m["uv_faces"], m["texture"])
    else:
        tv, tf = load_object_template(obj_name)
    fitter = ReconFitter(
        model, smplh, tv, tf, weights=L.COCO_WEIGHTS,
        cfg=fit_cfg or cfg.fit_config(),
        sampler_cfg=sampler_cfg or cfg.sampler_config(), device=dev,
    )
    prep = TestImagePrep(
        image_size=tuple(cfg.net_img_size), crop_size=cfg.loadSize,
        use_mean_center=True, crop_info_dir=outpath,
    )
    os.makedirs(outpath, exist_ok=True)
    images = sorted(glob(os.path.join(seq_folder, "k1.color.jpg"))
                    + glob(os.path.join(seq_folder, "*", "k1.color.jpg")))
    if max_frames:
        images = images[:max_frames]
    print(f"{len(images)} images to process")
    timer = fitter.timer
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731

    for rgb_file in images:
        t0 = time.time()
        with timer.phase("demo_prep"):
            item = prep.prepare(rgb_file)
            batch = collate([item])
        with timer.phase("demo_fit"):
            result = fitter.fit_batch(
                batch["images"], batch["crop_center"], batch["mocap_pose"],
                batch["mocap_betas"], batch["kpts"],
                use_silhouette=use_silhouette,
            )
            smpl_verts = host(smplh.verts(result["smpl_params"]))
            obj_verts = host(fitter.transform_obj(
                result["obj_params"], points=fitter.template_verts))
        # frame dirs in BEHAVE layouts all contain "k1.color.jpg"; key the
        # output on the parent folder in that case to avoid collisions
        name = os.path.splitext(os.path.basename(rgb_file))[0]
        parent = os.path.basename(os.path.dirname(rgb_file))
        if parent and os.path.abspath(os.path.dirname(rgb_file)) != \
                os.path.abspath(seq_folder):
            name = parent
        frame_out = os.path.join(outpath, name, save_name)
        os.makedirs(frame_out, exist_ok=True)
        with timer.phase("ply_writes"):
            save_ply(os.path.join(frame_out, "smpl.ply"), smpl_verts[0],
                     smplh.faces)
            save_ply(os.path.join(frame_out, "object.ply"), obj_verts[0], tf)
            pc = result["pclouds"]
            save_ply(os.path.join(frame_out, "human_pc.ply"),
                     host(pc["human"]["points"][0]))
            save_ply(os.path.join(frame_out, "object_pc.ply"),
                     host(pc["object"]["points"][0]))
        if field_mesh_res:
            with timer.phase("field_meshes"):
                meshes_f = extract_field_meshes(
                    fitter, batch["images"], batch["crop_center"],
                    res=field_mesh_res)
            with timer.phase("ply_writes"):
                for head, (fv, ff) in meshes_f.items():
                    save_ply(os.path.join(frame_out, f"{head}_field.ply"),
                             fv, ff)

        meshes = [(smpl_verts[0], smplh.faces), (obj_verts[0], tf)]
        colors = [(0.2, 0.7, 0.3), (0.8, 0.3, 0.2)]
        with timer.phase("render_front"):
            front, mask = render_meshes(meshes, colors,
                                        image_size=render_size,
                                        textures=[None, tex_data],
                                        device=dev)
        with timer.phase("align_to_input"):
            orig = read_bgr(rgb_file)
            overlay = align_to_input(front[..., ::-1], mask, orig,
                                     item["crop_info"], use_mean_center=True,
                                     alpha=0.85)
        with timer.phase("jpeg_overlay"):
            imwrite(os.path.join(frame_out, "overlay.jpg"), overlay)
        with timer.phase("render_side"):
            allv = np.concatenate([smpl_verts[0], obj_verts[0]], 0)
            center = allv.mean(0)
            side_meshes = [(look_at_side(v, 90.0, center), f)
                           for v, f in meshes]
            side, _ = render_meshes(side_meshes, colors,
                                    image_size=render_size,
                                    textures=[None, tex_data], device=dev)
        with timer.phase("jpeg_side"):
            imwrite(os.path.join(frame_out, "side.jpg"),
                    (side[..., ::-1] * 255).astype(np.uint8))
        print(f"{rgb_file}: done in {time.time() - t0:.1f}s -> {frame_out}")
    print("fit phase timing:", timer.summary())
    return fitter


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("exp_name", nargs="?", default="chore-release")
    parser.add_argument("-s", "--seq_folder", required=True)
    parser.add_argument("-on", "--obj_name", default="basketball")
    parser.add_argument("-o", "--outpath", default="demo_out")
    parser.add_argument("-sn", "--save_name", default="demo")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--no-sil", action="store_true")
    parser.add_argument("--textured-obj", default=None,
                        help="textured OBJ template; texture shows in the "
                        "overlay renders")
    parser.add_argument("--field-mesh-res", type=int, default=0,
                        help="also extract the UDF level sets into "
                        "{human,object}_field.ply at this grid resolution")
    parser.add_argument("--exp-root", default="experiments",
                        help="checkpoint search root")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to "
                             "run on the CPU)")
    args = parser.parse_args(argv)
    try:
        cfg = load_config(args.exp_name)
    except FileNotFoundError:
        cfg = ChoreConfig(exp_name=args.exp_name)
    run_demo(cfg, args.seq_folder, args.obj_name, args.outpath,
             args.save_name, args.max_frames,
             use_silhouette=not args.no_sil,
             textured_obj=args.textured_obj,
             field_mesh_res=args.field_mesh_res,
             exp_root=args.exp_root, device=args.device)


if __name__ == "__main__":
    main()
