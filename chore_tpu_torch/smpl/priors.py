"""Mahalanobis pose priors (body + GRAB hands), counterpart of
``chore_tpu/smpl/priors.py``:
  body:  || (pose[3:66] - mean) @ precision ||^2 per example
  hands: || (pose[66:111] - lh_mean) @ lh_prec ||^2
         + || (pose[111:156] - rh_mean) @ rh_prec ||^2
"""
from __future__ import annotations

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.smpl.assets import load_priors
from chore_tpu_torch.smpl.const import SMPLH_HANDPOSE_START


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def make_body_prior(assets_dir=None, device=None):
    """The body prior, its tables on ``device``: the card unless
    ``device="cpu"`` (raises when there is no card and none is named)."""
    device = resolve_device(device)
    p = load_priors(assets_dir)
    mean, prec = _t(p["body_mean"], device), _t(p["body_precision"], device)

    def body_prior(pose, prefix=3, end=66):
        """(B, >=66) pose -> (B,) prior energy."""
        t2 = (pose[:, prefix:end] - mean[None]) @ prec
        return (t2 * t2).sum(1)

    return body_prior


def make_hand_prior(assets_dir=None, device=None):
    """The hand prior, its tables on ``device`` (as ``make_body_prior``)."""
    device = resolve_device(device)
    p = load_priors(assets_dir)
    mean = _t(np.concatenate([p["lh_mean"], p["rh_mean"]]), device)
    lh_prec = _t(p["lh_precision"], device)
    rh_prec = _t(p["rh_precision"], device)

    def hand_prior(full_pose, prefix=SMPLH_HANDPOSE_START):
        """(B, 156) SMPL-H pose -> (B,) prior energy."""
        t = full_pose[:, prefix:] - mean[None]
        t2 = torch.cat([t[:, :45] @ lh_prec, t[:, 45:] @ rh_prec], dim=1)
        return (t2 * t2).sum(1)

    return hand_prior


def mean_hand_pose(assets_dir=None):
    """(90,) GRAB mean hand pose (numpy) used to initialize SMPL-H hands."""
    p = load_priors(assets_dir)
    return np.concatenate([p["lh_mean"], p["rh_mean"]]).astype(np.float32)


def mean_body_pose(assets_dir=None):
    """(63,) mean body pose of the body prior (numpy)."""
    return np.asarray(load_priors(assets_dir)["body_mean"], np.float32)
