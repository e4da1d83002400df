"""Evaluation entry point (counterpart of ``chore_tpu/cli/evaluate.py``).

Usage:
  python -m chore_tpu_torch.cli.evaluate -sn SAVE_NAME -r RECON_DIR \\
      -b BEHAVE_DIR [--seqs SEQ ...] [-t TID] [--device cpu]

Procrustes and the Chamfer run on the card unless ``--device cpu``.
"""
from __future__ import annotations

from argparse import ArgumentParser
from glob import glob

from chore_tpu_torch.data.paths import load_paths
from chore_tpu_torch.recon.evaluate import ReconEvaluator


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-sn", "--save_name", required=True)
    parser.add_argument("-r", "--recon_path", default=None)
    parser.add_argument("-b", "--behave_path", default=None)
    parser.add_argument("--seqs", nargs="+", default=None,
                        help="sequence dirs; default: all under behave_path")
    parser.add_argument("-t", "--tid", type=int, default=1)
    parser.add_argument("-i", "--id", default=None,
                        help="'smpl' evaluates the SMPL mesh only")
    parser.add_argument("--outdir", default="results")
    parser.add_argument("--seq-workers", type=int, default=4,
                        help="sequences evaluated concurrently (IO overlap; "
                             "1 = serial)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to "
                             "run on the CPU)")
    args = parser.parse_args(argv)

    paths = load_paths()
    recon = args.recon_path or paths.get("RECON_PATH")
    behave = args.behave_path or paths.get("BEHAVE_PATH")
    seqs = args.seqs or sorted(glob(f"{behave}/*/"))
    ev = ReconEvaluator(recon, behave, smpl_only=args.id == "smpl",
                        outdir=args.outdir, device=args.device)
    return ev.eval_seqs(seqs, args.save_name, args.tid,
                        seq_workers=args.seq_workers)


if __name__ == "__main__":
    main()
