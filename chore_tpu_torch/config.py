"""Experiment configuration.

Counterpart of ``chore_tpu/config.py``: the same ``ChoreConfig`` fields and
defaults (release values; ``precision="mixed"`` runs the encoder's convs
in bfloat16 with float32 norm statistics and heads), the same reference
key aliases and pinned inert keys, and the same json round trip, so an
experiment config written by either package loads in the other. The
``*_config`` methods return the port's own FieldConfig, FitConfig and
SamplerConfig.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import torch

from chore_tpu_torch.models.chore import FieldConfig
from chore_tpu_torch.recon.fitter import FitConfig
from chore_tpu_torch.recon.generator import SamplerConfig


@dataclasses.dataclass
class ChoreConfig:
    """Union of the reference's experiment options that drive behavior
    (release values from config/chore-release.json)."""

    exp_name: str = "chore-release"
    # data
    test_kid: int = 1
    image_size: Sequence[int] = (2048, 1536)
    net_img_size: Sequence[int] = (512, 512)
    batch_size: int = 15
    num_workers: int = 8
    worker_type: str = "thread"  # or "process" (GIL-heavy __getitem__)
    split_file: str = "splits/behave-split.pkl"
    num_samples_train: int = 20000
    sigmas: Sequence[float] = (0.08, 0.02, 0.003)
    ratios: Sequence[float] = (0.01, 0.49, 0.5)
    loadSize: int = 1200
    z_0: float = 2.2
    input_type: str = "RGBM3"
    random_flip: bool = False
    aug_blur: float = 0.0
    # model
    precision: str = "mixed"  # "mixed": bf16 encoder/f32 heads; "float32"
    num_stack: int = 5
    num_hourglass: int = 2
    hourglass_dim: int = 256
    norm: str = "group"
    skip_hourglass: bool = True
    remat: bool = False  # hourglass rematerialization (bigger train batches)
    hg_down: str = "ave_pool"
    z_feat: str = "xyz"
    projection_mode: str = "perspective"
    # training
    learning_rate: float = 1e-3
    num_epochs: int = 80
    milestones: Sequence[int] = (15, 25)
    clamp_thres: float = 0.1
    # recon
    filter_val: float = 0.004
    sparse_thres: float = 0.03
    seq_folder: Optional[str] = None

    def encoder_dtype(self):
        return torch.bfloat16 if self.precision == "mixed" else torch.float32

    def field_config(self) -> FieldConfig:
        return FieldConfig(
            num_stack=self.num_stack,
            num_hourglass=self.num_hourglass,
            hourglass_dim=self.hourglass_dim,
            crop_size=self.loadSize,
            net_img_size=self.net_img_size[0],
            z0=self.z_0,
            clamp_thres=self.clamp_thres,
            remat=self.remat,
        )

    def sampler_config(self, num_points=5000) -> SamplerConfig:
        return SamplerConfig(
            filter_val=self.filter_val, num_points=num_points
        )

    def fit_config(self) -> FitConfig:
        return FitConfig(
            net_in_size=self.net_img_size[0],
            z0=self.z_0,
            crop_size=self.loadSize,
        )


# Reference keys that load under a different name here
CONFIG_ALIASES = {
    "name": "exp_name",        # options.py --name duplicates --exp_name
    "schedule": "milestones",  # options.py --schedule; json uses milestones
    "num_threads": "num_workers",  # torch DataLoader worker count
}

# Reference flags (its options.py:9-202 and config jsons) that are
# INTENTIONALLY inert in this framework (the same set as chore_tpu's);
# loading a json containing any OTHER unknown key warns loudly. Categories:
#   the reference's device/loader machinery, set per entry point here
#   PIFu-legacy flags never read on the CHORE release path (no reader
#     in the reference's model/chore.py, data/train_data.py,
#     trainer/trainer.py)
#   entry-point paths/frequencies that are CLI arguments here, not config
REFERENCE_INERT_KEYS = frozenset({
    # -- device/host machinery of the reference trainer
    "gpu_id", "gpu_ids", "multi_gpus", "local_rank", "pin_memory",
    "serial_batches", "depth2color",
    # -- PIFu legacy, unread by the CHORE release path
    "model_type", "encode_type", "surface_classifier", "use_tanh",
    "no_residual", "mlp_dim", "mlp_dim_color", "norm_color",
    "num_sample_color", "num_sample_inout", "num_views",
    "random_multiview", "learning_rateC", "color_loss_type", "sigma",
    "z_size", "mix_samp", "person_obj_ratio", "clean_only", "data_name",
    "joint_df", "reso_grid", "pn_hid_dim", "num_anchor_points",
    "bin_classifier", "num_parts", "orth_size", "orth_scale",
    "random_scale", "random_trans", "realdepth", "scan_data",
    "aug_alstd", "aug_bri", "aug_con", "aug_sat", "aug_hue",
    # -- reference trainer hardcodes 0.3 (trainer.py:41); ours is a
    #    Trainer() argument with the same default
    "gamma",
    # -- entry-point arguments in our CLIs, not experiment config
    "dataset_path", "checkpoint", "checkpoints_path", "results_path",
    "load_netG_checkpoint_path", "load_netC_checkpoint_path",
    "load_checkpoint_path", "resume_epoch", "continue_train", "debug",
    "freq_plot", "freq_save", "freq_save_ply", "no_gen_mesh",
    "no_num_eval", "val_test_error", "val_train_error", "gen_test_mesh",
    "gen_train_mesh", "all_mesh", "num_gen_mesh_test", "resolution",
    "test_folder_path", "eval_num", "densepc_num", "save_densepc",
    "save_npz", "pcsave_name", "single", "mask_path", "img_path",
    "nocrop", "overwrite", "focal_length", "subfolder_name",
})


def config_from_dict(data, exp_name=None):
    """Build a ChoreConfig from a (reference) json dict with every key
    accounted for: dataclass fields load, CONFIG_ALIASES remap,
    REFERENCE_INERT_KEYS pass silently (pinned inert by test), anything
    else triggers a warning naming the dropped key."""
    import warnings

    fields = {f.name for f in dataclasses.fields(ChoreConfig)}
    kept = {k: v for k, v in data.items() if k in fields}
    for k, v in data.items():
        if k in fields:
            continue
        alias = CONFIG_ALIASES.get(k)
        if alias is not None:
            # alias is a fallback only: chore-release.json carries both
            # name="chore" AND exp_name="chore-release" — the direct
            # field always wins
            kept.setdefault(alias, v)
        elif k not in REFERENCE_INERT_KEYS:
            warnings.warn(
                f"config key {k!r} is not supported and not in the pinned "
                f"inert list; its value {v!r} is IGNORED", stacklevel=2)
    if exp_name is not None:
        kept["exp_name"] = exp_name
    return ChoreConfig(**kept)


def save_config(cfg: ChoreConfig, config_dir="configs"):
    """Snapshot to configs/{exp_name}.json
    (reference: config_loader.py:11-21)."""
    os.makedirs(config_dir, exist_ok=True)
    path = os.path.join(config_dir, f"{cfg.exp_name}.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return path


def load_config(exp_name, config_dir="configs") -> ChoreConfig:
    """Load configs/{exp_name}.json with every key accounted for
    (reference: config_loader.py:24-32); see config_from_dict."""
    path = os.path.join(config_dir, f"{exp_name}.json")
    with open(path) as f:
        data = json.load(f)
    return config_from_dict(data, exp_name=exp_name)
