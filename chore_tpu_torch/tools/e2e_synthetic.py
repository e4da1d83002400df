"""End-to-end system validation on synthetic scenes: preprocess -> train ->
reconstruct -> evaluate, with known ground truth. Counterpart of
``tools/e2e_synthetic.py``.

No BEHAVE data or SMPL model files are needed: scenes are a synthetic body
(``smpl.synthetic_smplh``) plus a sphere object at a fixed offset, ground
truth comes from the boundary sampler, and the evaluation is the reference
protocol (Procrustes-aligned bidirectional sqrt Chamfer). This exercises
every stage of the pipeline INCLUDING learning: if the field network cannot
fit the synthetic UDFs or the reconstruction cannot recover the meshes from
the learned fields, the numbers show it.

Usage:
  python -m chore_tpu_torch.tools.e2e_synthetic [--epochs 40]
      [--out /tmp/e2e_synth] [--device cpu]

Prints one JSON line with the final train loss and Chamfer errors.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

from chore_tpu_torch.tools.make_example import posed_body, sil_mask

SIGMAS = (0.08, 0.02, 0.003)
RATIOS = (0.01, 0.49, 0.5)


def build_scenes(root, n_frames, rng, obj_radius=0.18, mask_res=256,
                 vary_object=False, device=None):
    """Synthetic frames: fixed body+object, tiny pose jitter; returns
    (npz paths, GT meshes of frame 0, the SMPLH model).

    Masks are real silhouettes rendered from the GT geometry with the
    Kinect camera: the network's two mask channels are its only evidence of
    where the object is. The boundary sampler runs on ``device``'s backend
    (the native BVH with "cpu", the device backend on the card)."""
    from chore_tpu_torch import resolve_device
    from chore_tpu_torch.data.imageio import imwrite
    from chore_tpu_torch.preprocess.boundary_sampler import BoundarySampler
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere

    device = resolve_device(device)
    smplh = SMPLH(synthetic_smplh(), device=device)
    sampler = BoundarySampler(seed=0, device=device)
    proc = os.path.join(root, "processed")
    os.makedirs(proc, exist_ok=True)

    # resume guard: npz files are only reusable if they were generated
    # with the SAME scene parameters, else training data and the re-derived
    # frame-0 GT silently diverge; a parameter change or a missing manifest
    # regenerates from scratch
    manifest = {"obj_radius": obj_radius, "vary_object": bool(vary_object),
                "mask_res": mask_res}
    mpath = os.path.join(proc, "manifest.json")
    stale = glob.glob(os.path.join(proc, "*.npz"))
    if stale:
        old = None
        if os.path.isfile(mpath):
            with open(mpath) as f:
                old = json.load(f)
        if old != manifest:
            print(f"e2e_synthetic: scene parameters changed "
                  f"({old} -> {manifest}); regenerating {len(stale)} npz")
            for f in stale:
                os.remove(f)
    with open(mpath, "w") as f:
        json.dump(manifest, f)

    paths, gt0 = [], None
    for i in range(n_frames):
        frame_dir = os.path.join(root, "frames", f"t{i:04d}.000")
        os.makedirs(frame_dir, exist_ok=True)
        pose = (rng.randn(1, 72) * 0.05).astype(np.float32)
        sv = posed_body(smplh, pose, 2.2, device)
        if vary_object:
            # per-frame object placement: the field must read the mask
            # channels to localize it
            oc = (rng.uniform(0.25, 0.6), rng.uniform(-0.1, 0.3),
                  rng.uniform(2.0, 2.4))
        else:
            oc = (0.45, 0.1, 2.25)
        ov, of = octasphere(radius=obj_radius, center=oc, subdiv=2)
        rgb_file = os.path.join(frame_dir, "k1.color.jpg")
        npz = os.path.join(proc, f"t{i:04d}_k1_scale.npz")
        paths.append(npz)
        if gt0 is None:
            gt0 = {"smpl": (sv, smplh.faces), "obj": (ov, of),
                   "pose": pose, "rgb": rgb_file}
        if os.path.isfile(npz):
            # resume: the geometry above is re-derived deterministically
            continue
        out = sampler.boundary_sample_all(
            sv.astype(np.float32), smplh.faces, ov, of,
            sigmas=list(SIGMAS), ratios=list(RATIOS),
            sample_num=6000, min_samples=200,
        )
        out["smpl_center"][2] = 2.2
        pm = sil_mask(sv.astype(np.float32), smplh.faces, mask_res, device)
        om = sil_mask(ov, of, mask_res, device)
        img = np.full((1536, 2048, 3), 60, np.uint8)
        img[pm > 127] = (90, 120, 160)
        img[om > 127] = (160, 120, 90)
        imwrite(rgb_file, img)
        imwrite(os.path.join(frame_dir, "k1.person_mask.jpg"), pm)
        imwrite(os.path.join(frame_dir, "k1.obj_rend_mask.jpg"), om)
        np.savez(npz, image_file=rgb_file, **out)
    return paths, gt0, smplh


def train_field(paths, out_dir, epochs, num_stack=2, img_size=256,
                verbose=True, device=None, state_dict=None):
    """Build the CHORE field and train it on preprocessed synthetic frames
    (shared by the e2e check and ``diag_object``, so both measure the same
    training regime). ``state_dict``: start weights (default: the port's
    seeded N(0, 0.02) init). Returns (model, cfg, losses), the model on
    ``device`` in eval mode and frozen."""
    from chore_tpu_torch.data import BehaveTrainData, DataLoader
    from chore_tpu_torch.models import FieldConfig, build_field
    from chore_tpu_torch.train import Trainer

    if len(paths) < 2:
        raise SystemExit("need >= 2 frames")
    cfg = FieldConfig(num_stack=num_stack, num_hourglass=2,
                      net_img_size=img_size)
    model = build_field(cfg, device=device, state_dict=state_dict,
                        trainable=True)
    ds = BehaveTrainData(paths, phase="train", total_samplenum=4000,
                         image_size=(img_size, img_size))
    loader = DataLoader(ds, batch_size=min(4, len(paths)), shuffle=True,
                        num_workers=2, drop_last=False)
    # the LR milestones scale with the run (the release [15, 25] assumes
    # ~3000 steps an epoch; here an epoch is 2 steps)
    trainer = Trainer(model, os.path.join(out_dir, "exp"), base_lr=1e-3,
                      ck_period_min=1e9,
                      milestones=(int(epochs * 0.75), int(epochs * 0.9)))
    losses = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        trainer.set_epoch_lr(epoch)
        for batch in loader:
            batch.pop("path", None)
            loss, _ = trainer.train_step(batch)
            losses.append(float(loss))
        if verbose:
            print(f"epoch {epoch}: loss {losses[-1]:.3f}", flush=True)
        trainer.epoch += 1
    return model.eval().requires_grad_(False), cfg, losses


def zero_conf_kpts(img_size, batch=1):
    """(batch, 25, 3) keypoints at the image centre with confidence 0: the
    fit relies on the fields and the priors."""
    return np.concatenate(
        [np.full((batch, 25, 2), img_size / 2, np.float32),
         np.zeros((batch, 25, 1), np.float32)], -1)


def val_item(path, img_size):
    from chore_tpu_torch.data import BehaveTrainData

    return BehaveTrainData([path], phase="val", total_samplenum=4000,
                           image_size=(img_size, img_size))[0]


def reconstruct(model, smplh, gt0, path0, img_size, fit_cfg=None,
                sampler_cfg=None):
    """Fit frame 0 with the trained field (keypoints without confidence, no
    silhouette phase). Returns (fit result, fitter)."""
    from chore_tpu_torch.recon import losses as L
    from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
    from chore_tpu_torch.recon.generator import SamplerConfig

    tv, tf = gt0["obj"]
    fitter = ReconFitter(
        model, smplh, tv - tv.mean(0), tf, weights=L.BEHAVE_WEIGHTS,
        cfg=fit_cfg or FitConfig(net_in_size=img_size, sil_rend_size=128),
        sampler_cfg=sampler_cfg or SamplerConfig(num_points=4000),
        device=smplh.device)
    return refit(fitter, gt0, val_item(path0, img_size), img_size), fitter


def refit(fitter, gt0, item, img_size, shift=0.0):
    """``reconstruct``'s fit of ``item`` (``val_item`` of frame 0) with
    ``fitter``, the crop centre moved by ``shift`` px (how far rounding
    alone moves a fit)."""
    return fitter.fit_batch(
        item["images"][None], item["crop_center"][None] + shift,
        gt0["pose"], np.zeros((1, 10), np.float32), zero_conf_kpts(img_size),
        use_silhouette=False)


def eval_clouds(rec_smpl, rec_obj, gt0, obj_faces, device):
    """The reference protocol's inputs: one similarity (Procrustes) on SMPL
    and object vertices joined, then 5,000 surface samples of each GT and
    aligned mesh. Returns [(GT samples, reconstruction samples)] of SMPL
    and object, as (5000, 3) tensors on ``device``."""
    import torch

    from chore_tpu_torch.ops.procrustes import (
        apply_transform,
        similarity_transform,
    )
    from chore_tpu_torch.utils.meshio import sample_surface

    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    gt_smpl, gt_smpl_f = gt0["smpl"]
    gt_obj, gt_obj_f = gt0["obj"]
    r, tr, s = similarity_transform(
        t(np.concatenate([rec_smpl, rec_obj])),
        t(np.concatenate([gt_smpl, gt_obj])))
    rec_smpl_a = apply_transform(t(rec_smpl), r, tr, s).cpu().numpy()
    rec_obj_a = apply_transform(t(rec_obj), r, tr, s).cpu().numpy()
    return [(t(sample_surface(gt_smpl, gt_smpl_f, 5000)),
             t(sample_surface(rec_smpl_a, gt_smpl_f, 5000))),
            (t(sample_surface(gt_obj, gt_obj_f, 5000)),
             t(sample_surface(rec_obj_a, obj_faces, 5000)))]


def chamfer_errors(clouds):
    """The sqrt Chamfer of each (GT, reconstruction) pair of
    ``eval_clouds``, one ``chamfer_eval`` each: (SMPL, object) in metres."""
    from chore_tpu_torch.ops.chamfer import chamfer_eval

    return tuple(float(chamfer_eval(x, y)) for x, y in clouds)


def evaluate(rec_smpl, rec_obj, gt0, obj_faces, device):
    """(SMPL error, object error) in metres of a reconstruction."""
    return chamfer_errors(eval_clouds(rec_smpl, rec_obj, gt0, obj_faces,
                                      device))


def recovered_meshes(result, fitter):
    """(SMPL verts, object verts) of frame 0 of a fit, as numpy."""
    rec_smpl = fitter.smplh.verts(result["smpl_params"])[0].cpu().numpy()
    rec_obj = fitter.transform_obj(
        result["obj_params"], points=fitter.template_verts)[0].cpu().numpy()
    return rec_smpl, rec_obj


def save_recon(out, rec_smpl, rec_obj, gt0, result):
    """The six plys of a run under OUT/recon."""
    from chore_tpu_torch.utils.meshio import save_ply

    gt_smpl, gt_smpl_f = gt0["smpl"]
    gt_obj, gt_obj_f = gt0["obj"]
    dump = os.path.join(out, "recon")
    os.makedirs(dump, exist_ok=True)
    save_ply(os.path.join(dump, "rec_smpl.ply"), rec_smpl, gt_smpl_f)
    save_ply(os.path.join(dump, "rec_obj.ply"), rec_obj, gt_obj_f)
    save_ply(os.path.join(dump, "gt_smpl.ply"), gt_smpl, gt_smpl_f)
    save_ply(os.path.join(dump, "gt_obj.ply"), gt_obj, gt_obj_f)
    pc = result["pclouds"]
    save_ply(os.path.join(dump, "pc_human.ply"),
             pc["human"]["points"][0].cpu().numpy())
    save_ply(os.path.join(dump, "pc_object.ply"),
             pc["object"]["points"][0].cpu().numpy())


def report(losses, err_smpl, err_obj, result, epochs):
    """The JSON line the tool prints."""
    pc = result["pclouds"]
    return {
        "final_train_loss": losses[-1],
        "chamfer_smpl_m": round(err_smpl, 4),
        "chamfer_obj_m": round(err_obj, 4),
        "n_valid_human": int(pc["human"]["n_valid"][0]),
        "n_valid_object": int(pc["object"]["n_valid"][0]),
        "epochs": epochs,
    }


def run(args, fit_cfg=None, sampler_cfg=None, before_fit=None,
        verbose=True):
    """The whole check for parsed ``args``; the fit's configs default to
    the tool's (tests pass a cut schedule); ``before_fit()``, if given, is
    called just before the fit (e.g. to zero kernel launch counts);
    ``verbose``: print each epoch's loss.
    Returns (report, details): the details hold the fit result and its
    fitter, the losses, the trained model, the SMPL-H model, frame 0's GT,
    the scenes' npz paths, the evaluated (GT, reconstruction) clouds and
    their unrounded Chamfer errors (``chamfer_m``: SMPL, object), and the
    wall seconds of each stage (``seconds``: scenes, train, fit, eval;
    the device synchronised at the end of each)."""
    import torch

    from chore_tpu_torch import resolve_device

    device = resolve_device(args.device)
    seconds = {}
    t0 = time.perf_counter()

    def lap(stage):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[stage] = time.perf_counter() - t0
        t0 = time.perf_counter()

    paths, gt0, smplh = build_scenes(args.out, args.frames,
                                     np.random.RandomState(0),
                                     args.obj_radius,
                                     vary_object=args.vary_object,
                                     device=device)
    lap("scenes")
    train_paths = paths[1:] if args.holdout else paths
    model, _, losses = train_field(
        train_paths, args.out, args.epochs, num_stack=args.num_stack,
        img_size=args.img_size, verbose=verbose, device=device)
    lap("train")
    if before_fit is not None:
        before_fit()
    t0 = time.perf_counter()
    result, fitter = reconstruct(model, smplh, gt0, paths[0], args.img_size,
                                 fit_cfg, sampler_cfg)
    rec_smpl, rec_obj = recovered_meshes(result, fitter)
    lap("fit")
    clouds = eval_clouds(rec_smpl, rec_obj, gt0, gt0["obj"][1], device)
    err_smpl, err_obj = chamfer_errors(clouds)
    lap("eval")
    save_recon(args.out, rec_smpl, rec_obj, gt0, result)
    return (report(losses, err_smpl, err_obj, result, args.epochs),
            {"result": result, "fitter": fitter, "losses": losses,
             "model": model, "smplh": smplh, "gt0": gt0, "paths": paths,
             "clouds": clouds, "chamfer_m": (err_smpl, err_obj),
             "seconds": seconds})


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="/tmp/e2e_synth")
    ap.add_argument("--num-stack", type=int, default=2)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--obj-radius", type=float, default=0.18)
    ap.add_argument("--vary-object", action="store_true",
                    help="random object placement per frame")
    ap.add_argument("--holdout", action="store_true",
                    help="exclude frame 0 from training (generalization)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the host")
    return ap


def main(argv=None):
    rep, _ = run(parser().parse_args(argv))
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
