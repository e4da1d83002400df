"""Shared entry-point plumbing: model, checkpoint, template and SMPL-H
loading (counterpart of ``chore_tpu/cli/common.py``)."""
from __future__ import annotations

import os

from chore_tpu_torch.config import ChoreConfig
from chore_tpu_torch.data.paths import load_paths
from chore_tpu_torch.models.chore import build_field
from chore_tpu_torch.models.convert import params_from_jax
from chore_tpu_torch.recon.templates import MESH_TEMPLATES, load_template
from chore_tpu_torch.smpl import SMPLH, load_model_arrays, synthetic_smplh
from chore_tpu_torch.train.checkpoints import find_checkpoint, load_checkpoint
from chore_tpu_torch.utils.meshio import octasphere


def build_model(cfg: ChoreConfig, device=None, state_dict=None, seed=0,
                trainable=False):
    """The CHORE field at the config's widths and encoder precision, on
    ``device`` (the card unless "cpu"); seeded random weights unless
    ``state_dict``; frozen unless ``trainable``."""
    return build_field(cfg.field_config(), device=device, seed=seed,
                       state_dict=state_dict,
                       encoder_dtype=cfg.encoder_dtype(), trainable=trainable)


def load_trained(cfg: ChoreConfig, exp_root="experiments", device=None):
    """The field with the best/latest ``chore_tpu`` checkpoint of
    EXP_ROOT/<exp_name> (warns and keeps a random init without one)."""
    exp_dir = os.path.join(exp_root, cfg.exp_name)
    path = find_checkpoint(exp_dir) if os.path.isdir(exp_dir) else None
    if path is None:
        print(f"WARNING: no checkpoint under {exp_dir}; using random init "
              "(the port's seeded N(0, 0.02), not chore_tpu's PRNGKey(0) "
              "init)")
        return build_model(cfg, device)
    state, epoch, _, _ = load_checkpoint(path)
    model = build_model(cfg, device, state_dict=params_from_jax(
        state["params"]))
    print(f"loaded checkpoint {path} (epoch {epoch})")
    return model


def load_smplh(gender="male", device=None):
    """The real SMPL-H model when PATHS.yml's SMPL_MODEL_ROOT holds one,
    else the synthetic stand-in (shape-compatible; warns)."""
    root = load_paths().get("SMPL_MODEL_ROOT")
    if root and os.path.isfile(os.path.join(root, f"SMPLH_{gender}.pkl")):
        return SMPLH(load_model_arrays(root, gender=gender, hands=True),
                     device=device)
    print("WARNING: SMPL-H model files not found; using the synthetic "
          "body model (set SMPL_MODEL_ROOT in PATHS.yml for real results)")
    return SMPLH(synthetic_smplh(), device=device)


def load_object_template(obj_name):
    """BEHAVE object template, or a sphere stand-in when the objects
    directory is unavailable."""
    behave = load_paths().get("BEHAVE_PATH")
    objects = os.path.join(behave, "..", "objects") if behave else None
    if objects and obj_name in MESH_TEMPLATES:
        path = os.path.join(objects, MESH_TEMPLATES[obj_name])
        if os.path.isfile(path):
            return load_template(objects, obj_name)
    print(f"WARNING: template for '{obj_name}' not found; using a sphere "
          "stand-in")
    return octasphere(radius=0.15, subdiv=3)
