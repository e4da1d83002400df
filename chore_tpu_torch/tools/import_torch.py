"""Convert a reference (torch) CHORE checkpoint into an experiment directory.
Counterpart of ``tools/import_torch.py``.

Takes the reference's released ``checkpoint_*h:*m:*s_*.tar`` (a dict with
``model_state_dict``), loads its weights into the port's field (which has
the reference's parameter names), and writes a checkpoint in
``chore_tpu``'s format into ``experiments/<exp>/checkpoints/``, where the
recon/demo CLIs find it through ``cli.common.load_trained``.

Usage:
  python -m chore_tpu_torch.tools.import_torch /path/to/checkpoint_...tar
      [--exp chore-release] [--exp-root experiments] [--device cpu]
"""
from __future__ import annotations

import argparse
import os


def sorted_tree(tree):
    """A nested dict with every level's keys in sorted order: the order of
    a flax tree rebuilt from ``jax.tree_util``'s flattening, which the
    checkpoint's bytes follow."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def import_checkpoint(tar_path, exp_name="chore-release",
                      exp_root="experiments", cfg=None, device=None):
    """cfg: explicit ChoreConfig; defaults to configs/{exp_name}.json or
    the release architecture (the .tar's tensor shapes must match it).
    Returns the written checkpoint's path."""
    from chore_tpu_torch.cli.common import build_model
    from chore_tpu_torch.config import ChoreConfig, load_config
    from chore_tpu_torch.models.convert import params_to_jax, trained_names
    from chore_tpu_torch.train.checkpoints import save_checkpoint
    from chore_tpu_torch.train.torch_import import load_torch_checkpoint

    if cfg is None:
        try:
            cfg = load_config(exp_name)
        except FileNotFoundError:
            cfg = ChoreConfig(exp_name=exp_name)
    model = build_model(cfg, device)
    sd = load_torch_checkpoint(tar_path)["model_state_dict"]
    own = model.state_dict()
    used = trained_names(own)
    missing = [k for k in used if k not in sd]
    if missing:
        raise KeyError(f"torch checkpoint missing {missing[0]}")
    model.load_state_dict({k: sd.get(k, v) for k, v in own.items()})
    params = sorted_tree(params_to_jax(model.state_dict()))
    unused = [k for k in sd if k not in set(used)]
    if unused:
        print(f"ignored {len(unused)} non-parameter torch keys "
              f"(e.g. {unused[:3]})")
    # keep the reference's wall-time file naming when parseable so the
    # provenance stays visible; epoch is unknown -> 0
    base = os.path.basename(tar_path)
    try:
        training_time = float(os.path.splitext(base)[0].split("_")[-1])
    except ValueError:
        training_time = 0.0
    ckpt_dir = os.path.join(exp_root, exp_name, "checkpoints")
    name = save_checkpoint(ckpt_dir, {"params": params}, training_time,
                           epoch=0)
    out = os.path.join(ckpt_dir, name)
    print(f"imported {tar_path} -> {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tar_path")
    ap.add_argument("--exp", default="chore-release")
    ap.add_argument("--exp-root", default="experiments")
    ap.add_argument("--device", default=None,
                    help="where the field is built (default: the card)")
    args = ap.parse_args(argv)
    import_checkpoint(args.tar_path, args.exp, args.exp_root,
                      device=args.device)


if __name__ == "__main__":
    main()
