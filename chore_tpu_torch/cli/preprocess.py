"""Preprocessing entry point (counterpart of ``chore_tpu/cli/preprocess.py``).

Usage:
  python -m chore_tpu_torch.cli.preprocess -s SEQ -o OUT [-k 0 1 2 3] \\
      [-flip] [--device cpu] ...

The UDF and the part labels are computed on the card (the dense
``point_mesh_udf``, its nearest vertex through the 1-NN kernel K1), or with
``--device cpu`` on the host by the native triangle BVH
(``BoundarySampler(backend="auto")``).
"""
from __future__ import annotations

from argparse import ArgumentParser
from glob import glob

from chore_tpu_torch.data.paths import load_paths
from chore_tpu_torch.preprocess import process_scale_seq


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-s", "--seq_folder", default=None)
    parser.add_argument("-o", "--outdir", default=None)
    parser.add_argument("-dn", "--data_name", default="scale")
    parser.add_argument("-fs", "--start", type=int, default=0)
    parser.add_argument("-fe", "--end", type=int, default=None)
    parser.add_argument("--sigmas", nargs="+", type=float,
                        default=[0.08, 0.02, 0.003])
    parser.add_argument("--ratios", nargs="+", type=float,
                        default=[0.01, 0.49, 0.5])
    parser.add_argument("-gr", "--grid_ratio", type=float, default=0.01)
    parser.add_argument("--sample_num", type=int, default=100000)
    parser.add_argument("-sn", "--smpl_name", default="fit02")
    parser.add_argument("-on", "--obj_name", default="fit01")
    parser.add_argument("-k", "--kids", nargs="+", type=int, default=None,
                        help="kinect ids; default: the sequence's own")
    parser.add_argument("-redo", action="store_true")
    parser.add_argument("-i", "--interval", type=int, default=1)
    parser.add_argument("-flip", action="store_true")
    parser.add_argument("-sd", "--smpl_depth", type=float, default=2.2)
    parser.add_argument("-a", "--all", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "the native backend on the host)")
    args = parser.parse_args(argv)

    paths = load_paths()
    outdir = args.outdir or paths.get("PROCESSED_PATH")
    if args.all:
        behave = paths.get("BEHAVE_PATH")
        if not behave:
            raise SystemExit("--all requires BEHAVE_PATH in PATHS.yml")
        seqs = sorted(glob(behave + "/*/"))
    else:
        if not args.seq_folder:
            raise SystemExit("provide -s SEQ_FOLDER or --all")
        seqs = [args.seq_folder]
    if not outdir:
        raise SystemExit("provide -o OUTDIR or PROCESSED_PATH in PATHS.yml")
    written = {}
    for seq in seqs:
        files = process_scale_seq(
            seq, outdir,
            kids=tuple(args.kids) if args.kids else None, start=args.start,
            end=args.end, interval=args.interval,
            device=args.device,
            data_name=args.data_name, smpl_name=args.smpl_name,
            obj_name=args.obj_name, sigmas=tuple(args.sigmas),
            ratios=tuple(args.ratios), sample_num=args.sample_num,
            grid_ratio=args.grid_ratio, smpl_depth=args.smpl_depth,
            flip=args.flip, redo=args.redo,
        )
        print(f"{seq}: {len(files)} npz written")
        written[seq] = files
    return written


if __name__ == "__main__":
    main()
