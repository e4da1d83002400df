"""BEHAVE sequence reconstruction entry point (counterpart of
``chore_tpu/cli/recon.py``): per-frame joint SMPL + object fitting over a
sequence, in sequence order, with resume support. Frames are prepared in a
4-worker ``DataLoader``, as the reference does, so the next batch's decode
and crop overlap the current fit.

Usage:
  python -m chore_tpu_torch.cli.recon <exp_name> -s SEQ -sn SAVE_NAME \\
      [-o RECON_DIR] [--coco] [-fs START -fe END] [--debug-viz DIR] \\
      [--device cpu]

``--debug-viz DIR`` writes a ``utils.viewer.FitMonitor`` snapshot of each
fit stage into DIR. ``--fused`` (a single-program TPU pipeline) is not
ported by design; ``--data-parallel`` comes with a later slice of the port.
Each exits with an error that says so.
"""
from __future__ import annotations

import dataclasses
import os
import time
from argparse import ArgumentParser

import numpy as np

from chore_tpu_torch.behave.readers import SeqInfo
from chore_tpu_torch.cli.common import (
    load_object_template,
    load_smplh,
    load_trained,
)
from chore_tpu_torch.config import ChoreConfig, load_config
from chore_tpu_torch.data import DataLoader, DataPaths, TestImagePrep
from chore_tpu_torch.recon import losses as L
from chore_tpu_torch.recon.fitter import ReconFitter
from chore_tpu_torch.recon.templates import is_done, save_outputs
from chore_tpu_torch.smpl.model import pack_betas, pack_pose
from chore_tpu_torch.utils.viewer import FitMonitor

NOT_PORTED = {
    "fused": "--fused is not ported by design: the port's fit is the staged "
             "pipeline (ROADMAP.md Queue 1, \"Not ported, by design\")",
    "data_parallel": "--data-parallel is not ported yet: data-parallel "
                     "reconstruction comes with the DDP slice (ROADMAP.md)",
}


class _PrepDataset:
    """The sequence's frames, each prepared by ``TestImagePrep.prepare``."""

    def __init__(self, files, prep):
        self.files = files
        self.prep = prep

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        return self.prep.prepare(self.files[i])


def recon_fit(cfg: ChoreConfig, seq_folder, save_name, outpath="recon_out",
              coco=False, obj_name=None, start=0, end=None, batch_size=1,
              redo=False, tid=1, use_silhouette=True,
              exp_root="experiments", fit_cfg=None, sampler_cfg=None,
              offscreen_guard=False, device=None, debug_viz=None):
    """fit_cfg/sampler_cfg override the release schedule (quick runs,
    tests); exp_root relocates the checkpoint search; offscreen_guard
    enables the sil-phase off-ROI penalty (FitConfig.offscreen_guard,
    recommended with --coco); device: the card unless "cpu"; debug_viz
    writes FitMonitor snapshots of every fit stage into that directory.
    Returns the fitter (its timer holds the per-stage times)."""
    info_file = os.path.join(seq_folder, "info.json")
    if os.path.isfile(info_file):
        info = SeqInfo(seq_folder)
        obj_name = obj_name or info.get_obj_name()
        gender = info.get_gender()
    else:
        if obj_name is None:
            raise ValueError("provide -on for non-BEHAVE folders")
        gender = "male"

    model = load_trained(cfg, exp_root=exp_root, device=device)
    smplh = load_smplh(gender, device=device)
    tv, tf = load_object_template(obj_name)
    weights = L.COCO_WEIGHTS if coco else L.BEHAVE_WEIGHTS
    fcfg = fit_cfg if fit_cfg is not None else cfg.fit_config()
    if offscreen_guard:
        fcfg = dataclasses.replace(fcfg, offscreen_guard=True)
    fitter = ReconFitter(model, smplh, tv, tf, weights=weights, cfg=fcfg,
                         sampler_cfg=sampler_cfg if sampler_cfg is not None
                         else cfg.sampler_config(), device=device)
    prep = TestImagePrep(image_size=tuple(cfg.net_img_size),
                         crop_size=cfg.loadSize, use_mean_center=coco,
                         crop_info_dir=outpath)
    files = DataPaths.get_image_paths_seq(seq_folder, tid=tid,
                                          check_occlusion=False)
    files = files[start:end if end is not None else len(files)]
    print(f"{len(files)} test frames")
    monitor = FitMonitor(debug_viz) if debug_viz else None
    # batches already written are skipped before any frame is prepared; the
    # rest keep their grouping (only whole batches, or the trailing one, go)
    todo = []
    for b in range(0, len(files), batch_size):
        paths = files[b:b + batch_size]
        if not redo and is_done(outpath, paths, save_name, tid):
            print(f"{paths[0]} already done, skipped")
        else:
            todo += paths
    # the next batch is prepared by the loader's workers while this one fits
    for batch in DataLoader(_PrepDataset(todo, prep), batch_size,
                            num_workers=4):
        paths = batch["path"]
        t0 = time.time()
        B = len(paths)
        if B < batch_size:
            # pad the trailing partial batch to the full batch size
            # by repeating the last frame (one batch shape for the
            # whole run); save_outputs writes only len(paths) frames
            pad = batch_size - B
            for k, v in list(batch.items()):
                if isinstance(v, np.ndarray):
                    batch[k] = np.concatenate([v] + [v[-1:]] * pad,
                                              axis=0)
        result = fitter.fit_batch(
            batch["images"], batch["crop_center"], batch["mocap_pose"],
            batch["mocap_betas"], batch["kpts"],
            use_silhouette=use_silhouette, monitor=monitor,
        )
        sp, op = result["smpl_params"], result["obj_params"]
        host = lambda x: x.detach().cpu().numpy()  # noqa: E731
        save_outputs(
            outpath, paths, save_name, tid,
            host(smplh.verts(sp)), smplh.faces,
            host(pack_pose(sp)), host(pack_betas(sp)),
            host(sp["trans"]),
            host(fitter.transform_obj(op,
                                      points=fitter.template_verts)),
            tf,
            host(result["obj_R"]), host(op["obj_t"]), host(op["obj_s"]),
        )
        print(f"batch done in {time.time() - t0:.1f}s")
    print("fit phase timing:", fitter.timer.summary())
    return fitter


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("exp_name", nargs="?", default="chore-release")
    parser.add_argument("-s", "--seq_folder", required=True)
    parser.add_argument("-sn", "--save_name", required=True)
    parser.add_argument("-o", "--outpath", default="recon_out")
    parser.add_argument("-on", "--obj_name", default=None)
    parser.add_argument("-t", "--tid", type=int, default=1)
    parser.add_argument("-bs", "--batch_size", type=int, default=1)
    parser.add_argument("-fs", "--start", type=int, default=0)
    parser.add_argument("-fe", "--end", type=int, default=None)
    parser.add_argument("-redo", action="store_true")
    parser.add_argument("--coco", action="store_true",
                        help="in-the-wild weights + mean-centre restaging")
    parser.add_argument("--data-parallel", action="store_true",
                        help="not ported yet (DDP slice)")
    parser.add_argument("--debug-viz", default=None, metavar="DIR",
                        help="write a snapshot of each fit stage into DIR")
    parser.add_argument("--fused", action="store_true",
                        help="not ported by design (staged pipeline only)")
    parser.add_argument("--offscreen-guard", action="store_true",
                        help="sil-phase off-ROI penalty (recommended with "
                             "--coco; see FitConfig.offscreen_guard)")
    parser.add_argument("--exp-root", default="experiments",
                        help="checkpoint search root")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to "
                             "run on the CPU)")
    args = parser.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            parser.error(why)
    try:
        cfg = load_config(args.exp_name)
    except FileNotFoundError:
        cfg = ChoreConfig(exp_name=args.exp_name)
    recon_fit(cfg, args.seq_folder, args.save_name, args.outpath,
              coco=args.coco, obj_name=args.obj_name, start=args.start,
              end=args.end, batch_size=args.batch_size, redo=args.redo,
              tid=args.tid, exp_root=args.exp_root,
              offscreen_guard=args.offscreen_guard, device=args.device,
              debug_viz=args.debug_viz)


if __name__ == "__main__":
    main()
