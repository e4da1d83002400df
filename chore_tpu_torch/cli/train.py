"""Training entry point (counterpart of ``chore_tpu/cli/train.py``).

One process per card; with several (``torchrun --nproc_per_node N -m
chore_tpu_torch.cli.train ...``, which sets RANK/WORLD_SIZE/MASTER_ADDR),
each loads its shard of the global batch (``batch_size`` per process) and
``DistributedDataParallel`` averages the gradients. At the end each
process prints its trainer's phase timing (``Trainer.timer``).

Usage:
  python -m chore_tpu_torch.cli.train <exp_name> [--epochs N]
      [--exp-root DIR] [--resume latest|best] [--from-torch TAR]
      [--device cpu]
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

from chore_tpu_torch.cli.common import build_model
from chore_tpu_torch.config import ChoreConfig, load_config
from chore_tpu_torch.data import BehaveTrainData, DataLoader, DataPaths
from chore_tpu_torch.parallel import (
    init_distributed,
    process_count,
    process_index,
)
from chore_tpu_torch.train import Trainer


def launch_train(cfg: ChoreConfig, exp_root="experiments", epochs=None,
                 ck_period_min=60.0, profile_dir=None, resume="latest",
                 from_torch=None, device=None):
    device = init_distributed(device=device)
    world = process_count()
    print(f"training on {world} process(es), {device} each")
    model = build_model(cfg, device, trainable=True)
    exp_dir = os.path.join(exp_root, cfg.exp_name)
    trainer = Trainer(model, exp_dir, base_lr=cfg.learning_rate,
                      milestones=tuple(cfg.milestones),
                      ck_period_min=ck_period_min, profile_dir=profile_dir)
    if from_torch is not None:
        # weights, Adam moments and epoch from the reference's .tar; a
        # checkpoint of this run in exp_dir still wins below (a re-resume)
        unused = trainer.import_torch(from_torch)
        print(f"imported reference checkpoint {from_torch} "
              f"(epoch {trainer.epoch}, {len(unused)} unused torch keys)")

    train_paths, val_paths = DataPaths.load_splits(cfg.split_file)
    # the global batch is batch_size per process (the reference's 15 per
    # GPU)
    per_host_batch = cfg.batch_size

    def make_ds(paths, phase):
        return BehaveTrainData(
            paths, phase=phase, total_samplenum=cfg.num_samples_train,
            image_size=tuple(cfg.net_img_size), ratios=tuple(cfg.ratios),
            sigmas=tuple(cfg.sigmas), random_flip=cfg.random_flip,
            aug_blur=cfg.aug_blur, crop_size=cfg.loadSize, z0=cfg.z_0)

    train_ds = make_ds(train_paths, "train")
    val_ds = make_ds(val_paths[:per_host_batch * 4], "val")
    train_loader = DataLoader(train_ds, per_host_batch, shuffle=True,
                              num_workers=cfg.num_workers, drop_last=True,
                              shard_index=process_index(), shard_count=world,
                              worker_type=cfg.worker_type)

    def train_batches(epoch):
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            batch.pop("path", None)
            yield batch

    def val_batches():
        # drop_last=False: a val set smaller than a batch would otherwise
        # give nothing, and the best-checkpoint pointer would never move
        for batch in DataLoader(val_ds, per_host_batch,
                                num_workers=cfg.num_workers):
            batch.pop("path", None)
            yield batch

    try:
        trainer.train_model(train_batches, epochs or cfg.num_epochs,
                            val_batches, resume=resume)
    finally:
        train_loader.close()
    # this process's step phases and set-up (ddp_init; first_s holds the
    # first step's cuDNN search), as cli.recon prints the fit's
    print(f"train phase timing (process {process_index()}):",
          trainer.timer.summary())
    return trainer


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("exp_name", nargs="?", default="chore-release")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--exp-root", default="experiments")
    parser.add_argument("--ck-period-min", type=float, default=60.0)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of early "
                             "training steps here")
    parser.add_argument("--resume", choices=["latest", "best"],
                        default="latest",
                        help="checkpoint to resume from: latest (no lost "
                             "progress) or best (reference semantics: roll "
                             "back to the val-min checkpoint)")
    parser.add_argument("--from-torch", default=None, metavar="TAR",
                        help="continue training from a reference torch "
                             "checkpoint_*.tar (imports weights, Adam "
                             "moments and epoch)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "on the CPU)")
    args = parser.parse_args(argv)
    try:
        cfg = load_config(args.exp_name)
    except FileNotFoundError:
        cfg = ChoreConfig(exp_name=args.exp_name)
    launch_train(cfg, args.exp_root, args.epochs, args.ck_period_min,
                 profile_dir=args.profile_dir, resume=args.resume,
                 from_torch=args.from_torch, device=args.device)


if __name__ == "__main__":
    main()
