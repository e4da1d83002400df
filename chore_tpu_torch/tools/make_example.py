"""Generate a synthetic demo example folder (no external data).

The reference bundles ``example/000000117377/`` (photo + masks + openpose
json + FrankMocap outputs) so its demo runs out of the box. This
synthesizes an equivalent folder from the synthetic body model + a sphere
object: rendered color image, silhouette masks, projected body25
keypoints, mocap mesh + params -- everything ``python -m
chore_tpu_torch.cli.demo`` needs. Counterpart of ``tools/make_example.py``;
its output is ``chore_tpu_torch/assets/example_synth`` byte for byte.

Usage:
  python -m chore_tpu_torch.tools.make_example [--out example_synth]
      [--frames 1] [--device cpu]
  python -m chore_tpu_torch.cli.demo chore-release -s example_synth
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def sil_mask(verts, faces, mask_res, device=None):
    """(1536, 2048) uint8 silhouette of one mesh under the Kinect camera:
    rendered at ``mask_res``^2, resized as float32 (OpenCV's INTER_LINEAR)
    and thresholded at 0.5."""
    from chore_tpu_torch.data.image_ops import resize_linear
    from chore_tpu_torch.utils.render import render_meshes

    _, m = render_meshes([(verts, faces)], [(1, 1, 1)], image_size=mask_res,
                         device=device)
    m = resize_linear(m.astype(np.float32), (2048, 1536))
    return ((m > 0.5) * 255).astype(np.uint8)


def posed_body(smplh, pose, depth, device=None):
    """The synthetic body at ``pose`` (1, 72), its pelvis moved to (0, 0,
    ``depth``): float64 verts (V, 3), as the reference tools compute them."""
    from chore_tpu_torch.smpl.model import init_params

    sp = init_params(pose, np.zeros((1, 10)), np.zeros((1, 3)),
                     device=device)
    sv = smplh.verts(sp)[0].cpu().numpy()
    pelvis = smplh.pelvis(sp)[0].cpu().numpy()
    return sv + (np.array([0, 0, depth]) - pelvis)


def write_keypoints_and_mocap(frame, prep, reg, sv, faces, pose):
    """k1.color.json (projected body25 joints, confidence 1), k1.mocap.ply
    and k1.mocap.json (pose, zero betas)."""
    from chore_tpu_torch.utils.meshio import save_ply

    j2d = prep.persp_proj(reg @ sv)
    j2d[:, 2] = 1.0
    with open(os.path.join(frame, "k1.color.json"), "w") as f:
        json.dump({"body_joints": j2d.reshape(-1).tolist()}, f)
    save_ply(os.path.join(frame, "k1.mocap.ply"), sv, faces)
    with open(os.path.join(frame, "k1.mocap.json"), "w") as f:
        json.dump({"pose": pose[0].tolist(),
                   "betas": np.zeros(10).tolist()}, f)


def make_example(out_dir, n_frames=1, seed=0, device=None):
    from chore_tpu_torch import resolve_device
    from chore_tpu_torch.data.image_ops import resize_linear
    from chore_tpu_torch.data.imageio import imwrite
    from chore_tpu_torch.data.test_data import TestImagePrep
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.smpl.assets import load_landmark_regressors
    from chore_tpu_torch.utils.meshio import octasphere
    from chore_tpu_torch.utils.render import render_meshes

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    smplh = SMPLH(synthetic_smplh(), device=device)
    prep = TestImagePrep()  # only for persp_proj / camera constants
    reg = load_landmark_regressors(None)["body25"]

    frames = []
    for i in range(n_frames):
        frame = os.path.join(out_dir, f"frame{i:04d}")
        os.makedirs(frame, exist_ok=True)
        pose = (rng.randn(1, 72) * 0.1).astype(np.float32)
        sv = posed_body(smplh, pose, 2.3, device)
        ov, of = octasphere(radius=0.16, center=(0.42, 0.15, 2.35), subdiv=3)

        # rendered scene + silhouettes under the Kinect camera
        img_sq, _ = render_meshes(
            [(sv, smplh.faces), (ov, of)],
            [(0.55, 0.45, 0.4), (0.75, 0.35, 0.2)], image_size=512,
            background=np.full((512, 512, 3), 0.22, np.float32),
            device=device)
        img = resize_linear(img_sq, (2048, 1536))
        imwrite(os.path.join(frame, "k1.color.jpg"),
                (np.clip(img[..., ::-1], 0, 1) * 255).astype(np.uint8))
        imwrite(os.path.join(frame, "k1.person_mask.jpg"),
                sil_mask(sv, smplh.faces, 512, device))
        imwrite(os.path.join(frame, "k1.obj_rend_mask.jpg"),
                sil_mask(ov, of, 512, device))
        write_keypoints_and_mocap(frame, prep, reg, sv, smplh.faces, pose)
        frames.append(frame)
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="example_synth")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the renders run (default: the card)")
    args = ap.parse_args(argv)
    frames = make_example(args.out, args.frames, args.seed, args.device)
    print(f"wrote {len(frames)} frame(s) under {args.out}; run e.g.\n"
          f"  python -m chore_tpu_torch.cli.demo chore-release "
          f"-s {args.out} -on basketball")


if __name__ == "__main__":
    main()
