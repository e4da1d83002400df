"""BEHAVE sequence reconstruction entry point (counterpart of
``chore_tpu/cli/recon.py``): per-frame joint SMPL + object fitting over a
sequence, in sequence order, with resume support. Frames are prepared in a
4-worker ``DataLoader``, as the reference does, so the next batch's decode
and crop overlap the current fit.

Usage:
  python -m chore_tpu_torch.cli.recon <exp_name> -s SEQ -sn SAVE_NAME \\
      [-o RECON_DIR] [--coco] [-fs START -fe END] [--debug-viz DIR] \\
      [--device cpu]
  torchrun --nproc-per-node N -m chore_tpu_torch.cli.recon ... \\
      --data-parallel [-bs B]

``--debug-viz DIR`` writes a ``utils.viewer.FitMonitor`` snapshot of each
fit stage into DIR. ``--data-parallel`` fits each batch with one process
per card (``parallel.make_mesh``; without ``torchrun``, a one-process mesh
that writes the same files as the plain run): the batch is rounded up to a
multiple of the processes, the batches already written are listed once by
rank 0 before any fit, and each rank prepares, fits and writes its own
slice of every batch. ``--fused`` (a single-program TPU pipeline) is not
ported by design and exits with an error that says so.
"""
from __future__ import annotations

import dataclasses
import os
import time
from argparse import ArgumentParser


from chore_tpu_torch.behave.readers import SeqInfo
from chore_tpu_torch.cli.common import (
    load_object_template,
    load_smplh,
    load_trained,
)
from chore_tpu_torch.config import ChoreConfig, load_config
from chore_tpu_torch.data import DataLoader, DataPaths, TestImagePrep
from chore_tpu_torch.parallel.mesh import (
    broadcast_object,
    local_batch_slice,
    make_mesh,
)
from chore_tpu_torch.recon import losses as L
from chore_tpu_torch.recon.fitter import ReconFitter
from chore_tpu_torch.recon.templates import is_done, save_outputs
from chore_tpu_torch.smpl.model import pack_betas, pack_pose
from chore_tpu_torch.utils.viewer import FitMonitor

NOT_PORTED = {
    "fused": "--fused is not ported by design: the port's fit is the staged "
             "pipeline (ROADMAP.md Queue 1, \"Not ported, by design\")",
}


class _PrepDataset:
    """Frame slots (path, real), each prepared by ``TestImagePrep.prepare``;
    a padding copy (real False) writes no crop info."""

    def __init__(self, slots, prep):
        self.slots = slots
        self.prep = prep

    def __len__(self):
        return len(self.slots)

    def __getitem__(self, i):
        path, real = self.slots[i]
        item = self.prep.prepare(path, save_crop_info=real)
        item["real"] = real
        return item


def recon_fit(cfg: ChoreConfig, seq_folder, save_name, outpath="recon_out",
              coco=False, obj_name=None, start=0, end=None, batch_size=1,
              redo=False, tid=1, use_silhouette=True, data_parallel=False,
              exp_root="experiments", fit_cfg=None, sampler_cfg=None,
              offscreen_guard=False, device=None, debug_viz=None):
    """fit_cfg/sampler_cfg override the release schedule (quick runs,
    tests); exp_root relocates the checkpoint search; offscreen_guard
    enables the sil-phase off-ROI penalty (FitConfig.offscreen_guard,
    recommended with --coco); device: the card unless "cpu"; debug_viz
    writes FitMonitor snapshots of every fit stage into that directory
    (rank 0's under data_parallel); data_parallel fits each batch over
    ``parallel.make_mesh()``'s processes (module docstring).
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

    mesh = None
    if data_parallel:
        mesh = make_mesh(device)
        device = mesh.device
        batch_size = -(-max(batch_size, mesh.size) // mesh.size) * mesh.size
        print(f"data-parallel fitting over {mesh.size} processes, "
              f"batch {batch_size}")
    n, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    model = load_trained(cfg, exp_root=exp_root, device=device)
    smplh = load_smplh(gender, device=device)
    tv, tf = load_object_template(obj_name)
    weights = L.COCO_WEIGHTS if coco else L.BEHAVE_WEIGHTS
    fcfg = fit_cfg if fit_cfg is not None else cfg.fit_config()
    if offscreen_guard:
        fcfg = dataclasses.replace(fcfg, offscreen_guard=True)
    fitter = ReconFitter(model, smplh, tv, tf, weights=weights, cfg=fcfg,
                         sampler_cfg=sampler_cfg if sampler_cfg is not None
                         else cfg.sampler_config(), mesh=mesh,
                         device=device)
    prep = TestImagePrep(image_size=tuple(cfg.net_img_size),
                         crop_size=cfg.loadSize, use_mean_center=coco,
                         crop_info_dir=outpath)
    files = DataPaths.get_image_paths_seq(seq_folder, tid=tid,
                                          check_occlusion=False)
    files = files[start:end if end is not None else len(files)]
    print(f"{len(files)} test frames")
    monitor = FitMonitor(debug_viz) if debug_viz and rank == 0 else None
    # batches already written are skipped before any frame is prepared; the
    # rest keep their grouping (only whole batches, or the trailing one, go).
    # Rank 0 alone decides, before any fit: no rank's list may depend on
    # files that another rank is writing
    todo = None
    if rank == 0:
        todo = []
        for b in range(0, len(files), batch_size):
            paths = files[b:b + batch_size]
            if not redo and is_done(outpath, paths, save_name, tid):
                print(f"{paths[0]} already done, skipped")
            else:
                todo.append(paths)
    todo = broadcast_object(todo, mesh)
    # this rank's slots of every batch, the trailing batch padded to the
    # full size by repeating its last frame (one batch shape for the whole
    # run); a padding copy is fitted but writes no crop info and no output
    mine = local_batch_slice(batch_size, n, rank)
    slots = []
    for paths in todo:
        slots += ([(p, True) for p in paths]
                  + [(paths[-1], False)] * (batch_size - len(paths)))[mine]
    # the next batch is prepared by the loader's workers while this one fits
    for batch in DataLoader(_PrepDataset(slots, prep), batch_size // n,
                            num_workers=4):
        paths = [p for p, real in zip(batch["path"], batch["real"]) if real]
        t0 = time.time()
        result = fitter.fit_batch(
            batch["images"], batch["crop_center"], batch["mocap_pose"],
            batch["mocap_betas"], batch["kpts"],
            use_silhouette=use_silhouette, monitor=monitor, local_batch=True,
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
                        help="one process per card fits its slice of each "
                             "batch (run under torchrun)")
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
              tid=args.tid, data_parallel=args.data_parallel,
              exp_root=args.exp_root,
              offscreen_guard=args.offscreen_guard, device=args.device,
              debug_viz=args.debug_viz)


if __name__ == "__main__":
    main()
