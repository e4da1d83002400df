"""SMPL / SMPL-H linear blend skinning.

Counterpart of ``chore_tpu/smpl/lbs.py``. Rodrigues runs over all joints at
once; the kinematic chain composes 4x4 transforms one tree LEVEL at a time
(every joint of a level in one batched matmul: 11 launches for SMPL-H's
52 joints instead of 51), each product the same as the JAX package's
per-joint compose. Needs full f32 matmuls (``use_full_f32``): TF32 would
put millimetre noise on the vertices, against UDF thresholds of 0.004.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chore_tpu_torch.ops.rotation import axis_angle_to_matrix


@dataclasses.dataclass
class SMPLModel:
    """SMPL(-H) model tensors on one device, plus the kinematic tree."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, num_betas)
    posedirs: torch.Tensor  # (V, 3, 9*(J-1))
    j_regressor: torch.Tensor  # (J, V)
    weights: torch.Tensor  # (V, J)
    faces: np.ndarray  # (F, 3) int32
    parents: tuple
    # per tree level >= 1: (joint indices, their parents) as index tensors
    levels: list


def _tree_levels(parents, device):
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = []
    for d in range(1, max(depth) + 1):
        idx = [j for j in range(len(parents)) if depth[j] == d]
        levels.append((torch.tensor(idx, device=device),
                       torch.tensor([parents[j] for j in idx], device=device)))
    return levels


def model_from_arrays(data, device) -> SMPLModel:
    """SMPLModel on ``device`` from a loader dict of numpy arrays."""
    t = lambda k: torch.as_tensor(  # noqa: E731
        np.asarray(data[k], np.float32), device=device)
    parents = tuple(int(p) for p in data["parents"])
    return SMPLModel(
        v_template=t("v_template"), shapedirs=t("shapedirs"),
        posedirs=t("posedirs"), j_regressor=t("j_regressor"),
        weights=t("weights"), faces=np.asarray(data["faces"], np.int32),
        parents=parents, levels=_tree_levels(parents, device))


def lbs(model: SMPLModel, pose, betas, trans):
    """SMPL(-H) forward: pose (B, J*3) axis-angle, betas (B, K), trans
    (B, 3) ->
    (verts (B, V, 3), joints (B, J, 3), v_posed (B, V, 3), naked (B, V, 3))."""
    B = pose.shape[0]
    J = len(model.parents)
    rotmats = axis_angle_to_matrix(pose.reshape(B, J, 3))  # (B, J, 3, 3)

    v_shaped = model.v_template[None] + torch.einsum(
        "vdk,bk->bvd", model.shapedirs, betas)
    joints = torch.matmul(model.j_regressor, v_shaped)  # (B, J, 3)

    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    pose_map = (rotmats[:, 1:] - eye).reshape(B, (J - 1) * 9)
    v_posed = naked = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs,
                                              pose_map)

    # relative 4x4 transforms of every joint, then the chain level by level
    par = torch.tensor(model.parents[1:], device=pose.device)
    loc = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]], dim=1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(B, J, 1, 4)
    rel = torch.cat([torch.cat([rotmats, loc[..., None]], dim=-1), bottom],
                    dim=-2)  # (B, J, 4, 4)
    global_tf = rel
    for idx, pidx in model.levels:
        composed = global_tf[:, pidx] @ rel[:, idx]
        global_tf = global_tf.index_copy(1, idx, composed)

    # remove the rest-pose joint location: A_j = G_j - pack(G_j @ [j, 0])
    shifted = (global_tf[..., :3] * joints[:, :, None, :]).sum(-1)  # (B,J,4)
    rel_tf = torch.cat([global_tf[..., :3],
                        (global_tf[..., 3] - shifted)[..., None]], dim=-1)

    # skinning: per-vertex blended transform, one (V, J) x (B, J, 16) matmul
    vert_tf = torch.matmul(model.weights, rel_tf.reshape(B, J, 16))
    vert_tf = vert_tf.reshape(B, -1, 4, 4)
    verts = ((vert_tf[..., :3, :3] * v_posed[:, :, None, :]).sum(-1)
             + vert_tf[..., :3, 3])
    jtr = global_tf[..., :3, 3]
    return (verts + trans[:, None, :], jtr + trans[:, None, :], v_posed,
            naked)
