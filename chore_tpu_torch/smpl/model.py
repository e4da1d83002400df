"""SMPL-H split parameters and forward wrappers.

Counterpart of ``chore_tpu/smpl/model.py``. Parameters are a dict of
tensors (global/body/hand pose, top/other betas, trans); each fitting phase
freezes a subset of the keys.
"""
from __future__ import annotations

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.smpl import const
from chore_tpu_torch.smpl.assets import load_landmark_regressors
from chore_tpu_torch.smpl.lbs import lbs, model_from_arrays
from chore_tpu_torch.smpl.priors import mean_hand_pose


def split_params(pose, betas, trans):
    """(B,156)/(B,nb)/(B,3) -> split-param dict."""
    g = const.GLOBAL_POSE_NUM
    b = const.BODY_POSE_NUM
    return {
        "global_pose": pose[:, :g],
        "body_pose": pose[:, g: g + b],
        "hand_pose": pose[:, g + b:],
        "top_betas": betas[:, : const.TOP_BETA_NUM],
        "other_betas": betas[:, const.TOP_BETA_NUM:],
        "trans": trans,
    }


def pack_pose(params):
    return torch.cat([params["global_pose"], params["body_pose"],
                      params["hand_pose"]], dim=1)


def pack_betas(params):
    return torch.cat([params["top_betas"], params["other_betas"]], dim=1)


class SMPLH:
    """SMPL-H forward + landmarks bound to loaded model arrays, on
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, model_arrays, assets_dir=None, device=None):
        self.device = resolve_device(device)
        self.model = model_from_arrays(model_arrays, self.device)
        regs = load_landmark_regressors(assets_dir)
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.body25_reg = t(np.asarray(regs["body25"], np.float32))
        self.face_reg = t(np.asarray(regs["face"], np.float32))
        self.hand_reg = t(np.asarray(regs["hand"], np.float32))
        self.faces = self.model.faces  # numpy (F, 3)

    def forward(self, params):
        """-> (verts, joints, v_posed, naked), each (B, ., 3)."""
        return lbs(self.model, pack_pose(params), pack_betas(params),
                   params["trans"])

    def verts(self, params):
        return self.forward(params)[0]

    def get_landmarks(self, params, verts=None):
        """body25 (B,25,3), face (B,70,3), hand (B,42,3) landmarks by dense
        regressor matmuls; ``verts`` skips the forward when already known."""
        v = self.verts(params) if verts is None else verts
        return (torch.matmul(self.body25_reg, v),
                torch.matmul(self.face_reg, v),
                torch.matmul(self.hand_reg, v))

    def pelvis(self, params):
        """The "SMPL center": body25 joint 8."""
        return self.get_landmarks(params)[0][:, const.BODY25_PELVIS]


def init_params(poses, betas, trans, assets_dir=None, device=None):
    """Split params from (possibly SMPL-72) mocap estimates: 72-dim poses
    are padded to 156 with the GRAB mean hand pose. The params live on
    ``device``: the card unless device="cpu"."""
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
        dtype=torch.float32, device=device)
    poses, betas, trans = f32(poses), f32(betas), f32(trans)
    B = poses.shape[0]
    if poses.shape[1] != const.SMPLH_POSE_PARAMS_NUM:
        assert poses.shape[1] == const.SMPL_POSE_PARAMS_NUM, (
            f"unknown pose source with {poses.shape[1]} params")
        hand = f32(mean_hand_pose(assets_dir))[None].expand(B, -1)
        poses = torch.cat([poses[:, : const.SMPLH_HANDPOSE_START], hand],
                          dim=1)
    return split_params(poses, betas, trans)
