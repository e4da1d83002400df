"""Full CLI-chain end-to-end on a synthetic BEHAVE tree. Counterpart of
``tools/cli_e2e.py``.

Runs the four user-facing commands exactly as a user with real data would
-- as SUBPROCESSES of the CLIs, not library calls:

  1. python -m chore_tpu_torch.cli.preprocess   (GT boundary sampling)
  2. python -m chore_tpu_torch.cli.train        (training)
  3. python -m chore_tpu_torch.cli.recon        (per-frame joint fitting,
                                                 silhouette phase on)
  4. python -m chore_tpu_torch.cli.evaluate     (Procrustes + Chamfer JSON)

on a self-generated BEHAVE-format dataset (calibrations, GT fits, rendered
masks, mocap, keypoints). Zero external data; the printed JSON carries the
final Chamfer numbers. Each command gets ``--device``.

Usage:
  python -m chore_tpu_torch.tools.cli_e2e [--workdir /tmp/cli_e2e]
      [--epochs 30] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

from chore_tpu_torch.tools.make_example import (
    posed_body,
    sil_mask,
    write_keypoints_and_mocap,
)

# the directory holding the chore_tpu_torch package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEQ_NAME = "Date01_Sub01_basketball"


def build_tree(root, n_frames=3, seed=0, device=None):
    """BEHAVE-format root: calibs + one sequence with GT fits, rendered
    color/masks, mocap, keypoints. Kinect 1 is the identity camera so the
    rendered views and the stored world-space fits agree."""
    from chore_tpu_torch import resolve_device
    from chore_tpu_torch.data.imageio import imwrite
    from chore_tpu_torch.data.test_data import TestImagePrep
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.smpl.assets import load_landmark_regressors
    from chore_tpu_torch.utils.meshio import octasphere, save_ply

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    smplh = SMPLH(synthetic_smplh(), device=device)
    prep = TestImagePrep()
    reg = load_landmark_regressors(None)["body25"]

    calib = os.path.join(root, "calibs")
    for k in range(2):
        os.makedirs(os.path.join(calib, "intrinsics", str(k)), exist_ok=True)
        with open(os.path.join(calib, "intrinsics", str(k),
                               "calibration.json"), "w") as f:
            json.dump({"color": {
                "width": 2048, "height": 1536,
                "fx": prep.camera.fx_px, "fy": prep.camera.fy_px,
                "cx": prep.camera.cx_px, "cy": prep.camera.cy_px,
                "opencv": [prep.camera.fx_px, prep.camera.fy_px,
                           prep.camera.cx_px, prep.camera.cy_px]
                + [0.0] * 8,
            }}, f)
        ys, xs = np.mgrid[0:48, 0:64]  # tiny pc table (unused here)
        table = np.dstack([(xs - 32.0) / 50.0, (ys - 24.0) / 50.0])
        np.save(os.path.join(calib, "intrinsics", str(k),
                             "pointcloud_table.npy"), table)
        os.makedirs(os.path.join(calib, "config", str(k)), exist_ok=True)
        with open(os.path.join(calib, "config", str(k),
                               "config.json"), "w") as f:
            json.dump({"rotation": np.eye(3).reshape(-1).tolist(),
                       "translation": [0.0, 0.0, 0.0]}, f)

    seq = os.path.join(root, SEQ_NAME)
    os.makedirs(seq, exist_ok=True)
    with open(os.path.join(seq, "info.json"), "w") as f:
        json.dump({"cat": "basketball", "gender": "male",
                   "config": "../calibs/config",
                   "intrinsic": "../calibs/intrinsics",
                   "empty": None, "kinects": [0, 1]}, f)

    for i in range(n_frames):
        frame = os.path.join(seq, f"t{i:04d}.000")
        os.makedirs(os.path.join(frame, "person", "fit02"), exist_ok=True)
        os.makedirs(os.path.join(frame, "basketball", "fit01"),
                    exist_ok=True)
        pose = (rng.randn(1, 72) * 0.05).astype(np.float32)
        sv = posed_body(smplh, pose, 2.0, device)  # scale = 2.2/2.0 = 1.1
        ov, of = octasphere(radius=0.16, center=(0.40, 0.1, 2.05), subdiv=2)
        save_ply(os.path.join(frame, "person", "fit02", "person_fit.ply"),
                 sv, smplh.faces)
        save_ply(os.path.join(frame, "basketball", "fit01",
                              "basketball_fit.ply"), ov, of)

        pm = sil_mask(sv, smplh.faces, 256, device)
        om = sil_mask(ov, of, 256, device)
        img = np.full((1536, 2048, 3), 60, np.uint8)
        img[pm > 127] = (90, 120, 160)
        img[om > 127] = (160, 120, 90)
        imwrite(os.path.join(frame, "k1.color.jpg"), img)
        # frame discovery wants color+depth for EVERY kinect of the seq
        depth = np.full((1536, 2048), 2000, np.uint16)
        for k in range(2):
            imwrite(os.path.join(frame, f"k{k}.depth.png"), depth)
        imwrite(os.path.join(frame, "k0.color.jpg"), img)
        imwrite(os.path.join(frame, "k1.person_mask.jpg"), pm)
        imwrite(os.path.join(frame, "k1.obj_rend_mask.jpg"), om)
        imwrite(os.path.join(frame, "k1.obj_rend_full.jpg"), om)
        write_keypoints_and_mocap(frame, prep, reg, sv, smplh.faces, pose)
    return seq


def run(cmd, cwd):
    """Run one CLI as a fresh process with the package on its path; its
    output is printed if it exits non-zero, which fails the tool. Returns
    its wall seconds."""
    print("+", " ".join(cmd), flush=True)
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd, env=env, timeout=3600,
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-8000:], flush=True)
        raise SystemExit(f"command failed ({r.returncode}): {cmd}")
    return time.perf_counter() - t0


def chain(args):
    """Tree, then the four CLIs. Returns (the JSON report, {step: wall
    seconds})."""
    from chore_tpu_torch.config import ChoreConfig, save_config

    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    behave = os.path.join(wd, "behave")
    seconds = {}
    t0 = time.perf_counter()
    seq = build_tree(behave, args.frames, device=args.device)
    seconds["build_tree"] = time.perf_counter() - t0
    py = sys.executable
    dev = [] if args.device is None else ["--device", args.device]

    # 1. preprocess
    proc_dir = os.path.join(wd, "processed")
    seconds["preprocess"] = run(
        [py, "-m", "chore_tpu_torch.cli.preprocess", "-s", seq, "-o",
         proc_dir, "-k", "1", "--sample_num", "4000", *dev], cwd=ROOT)
    npzs = sorted(
        os.path.join(dp, f)
        for dp, _, fs in os.walk(proc_dir) for f in fs
        if f.endswith(".npz"))
    assert len(npzs) == args.frames, npzs
    split_file = os.path.join(wd, "split.pkl")
    with open(split_file, "wb") as f:
        pickle.dump({"train": npzs[:-1], "test": npzs[-1:]}, f)

    # 2. config + train
    cfg = ChoreConfig(
        exp_name="tiny-cli", num_stack=args.num_stack, num_hourglass=2,
        net_img_size=(args.img_size, args.img_size), batch_size=2,
        num_workers=2, num_epochs=args.epochs, split_file=split_file,
        num_samples_train=4000,
        milestones=(int(args.epochs * 0.75), int(args.epochs * 0.9)),
    )
    save_config(cfg, os.path.join(wd, "configs"))
    exp_root = os.path.join(wd, "experiments")
    seconds["train"] = run(
        [py, "-m", "chore_tpu_torch.cli.train", "tiny-cli", "--exp-root",
         exp_root, "--ck-period-min", "1e9", *dev], cwd=wd)

    # 3. recon the test frame
    recon_out = os.path.join(wd, "recon_out")
    seconds["recon"] = run(
        [py, "-m", "chore_tpu_torch.cli.recon", "tiny-cli", "-s", seq,
         "-sn", "clie2e", "-o", recon_out, "--exp-root", exp_root,
         "-fs", str(args.frames - 1), *dev], cwd=wd)

    # 4. evaluate
    results = os.path.join(wd, "results")
    seconds["evaluate"] = run(
        [py, "-m", "chore_tpu_torch.cli.evaluate", "-sn", "clie2e",
         "-r", recon_out, "-b", behave, "--seqs", seq, "--outdir", results,
         *dev], cwd=wd)
    out_json = sorted(os.listdir(results))[-1]
    with open(os.path.join(results, out_json)) as f:
        res = json.load(f)
    return {
        "cli_chain": "preprocess->train->recon->evaluate OK",
        "smpl_cm": round(res["smpl"]["mean"] * 100, 2),
        "obj_cm": round(res["obj"]["mean"] * 100, 2),
        "frames_evaluated": res["total"],
    }, seconds


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/cli_e2e")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--num-stack", type=int, default=2)
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="passed to every CLI (default: the card)")
    return ap


def main(argv=None):
    rep, _ = chain(parser().parse_args(argv))
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
