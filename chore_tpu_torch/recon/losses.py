"""Fitting losses for joint SMPL + object optimization.

Counterpart of ``chore_tpu/recon/losses.py``. The contact and collision
terms reach the grouped 1-NN kernel K1 through ``ops.chamfer.nn_sqdist`` /
``nn_sqdist_multi`` (kernel on the card, plain version on the CPU), batched
over examples by the kernel's batch dimension. Called alone, each term
makes its own kernel launch; the fitter's joint step runs the three 1-NN
calls of both terms (``contact_nn_calls`` + ``collision_nn_call``) as one
launch and hands the results in through ``nn=``:
  * contact: per-part chamfer between in-contact SMPL vertices and object
    points (group id = part label), mean over valid part pairs;
  * collision: object points behind the tangent plane of their nearest
    SMPL vertex are penalized quadratically (k = 1).
Loss weights follow w^2 * value / (1 + decay).

Under a data-parallel mesh the fitter divides each term by the rank count,
which makes a rank's mean over its equal slice its share of the global
batch's; only the contact term needs more, its pair count summed over the
ranks (``contact_loss(mesh=)``).
"""
from __future__ import annotations

import torch

from chore_tpu_torch.models.layers import one_hot_ce
from chore_tpu_torch.ops.camera import PerspectiveCamera, Z0
from chore_tpu_torch.ops.chamfer import nn_sqdist, nn_sqdist_multi
from chore_tpu_torch.ops.nn import BIG
from chore_tpu_torch.parallel.mesh import all_sum
from chore_tpu_torch.smpl.const import SMPL_PARTS_NUM

# w^2 constants
BEHAVE_WEIGHTS = {
    "beta": 1.0,
    "pose": 1e-5,
    "hand": 1e-5,
    "j2d": 0.3**2,
    "object": 30.0**2,
    "part": 0.05**2,
    "contact": 30.0**2,
    "scale": 10.0**2,
    "df_h": 30.0**2,
    "smplz": 30.0**2,
    "mask": 0.003**2,
    "ocent": 15.0**2,
    "collide": 3.0**2,
    "pinit": 5.0**2,
    "rot": 10.0**2,
    "trans": 10.0**2,
    "offscreen": 10.0**2,
}

# in-the-wild variant (``Reconstructor(coco=True)``, ``cli.recon --coco``,
# the demo): stronger pose/contact/keypoint regularization
COCO_WEIGHTS = dict(
    BEHAVE_WEIGHTS,
    j2d=0.8**2,
    object=90.0**2,
    contact=150.0**2,
    scale=2.0**2,
    pinit=10.0**2,
    ocent=30.0**2,
    mask=0.3**2,
    collide=15.0**2,
)


def weighted_sum(loss_dict, weights, decay):
    """sum_k w_k * loss_k / (1 + decay)."""
    total = 0.0
    for k, v in loss_dict.items():
        total = total + weights[k] * v / (1.0 + decay)
    return total


def df_h_loss(df_pred_h, clamp=0.1):
    """Mean clamped human UDF at SMPL verts."""
    return df_pred_h.clamp(max=clamp).mean()


def df_o_loss(df_pred_o, clamp=0.8):
    """Mean clamped object UDF at object points."""
    return df_pred_o.clamp(max=clamp).mean()


def scale_loss(obj_s, obj_scale=1.0):
    return ((obj_s - obj_scale) ** 2).mean()


def smplz_loss(joints, z0=Z0):
    """Pelvis (body25 joint 8) fixed-depth loss."""
    return ((joints[:, 8, 2] - z0) ** 2).mean()


def pinit_loss(pose, pose_init):
    """Stay near the mocap body pose: pose[3:72]."""
    return ((pose[:, 3:72] - pose_init) ** 2).sum(-1).mean()


def part_ce_loss(parts_pred, part_labels):
    """Part-correspondence CE at SMPL verts, summed over verts.
    parts_pred (B, V, 14), labels (B, V)."""
    return one_hot_ce(parts_pred, part_labels).sum(-1).mean()


def j2d_loss(joints3d, kpts2d, crop_center, camera: PerspectiveCamera,
             net_in_size=512):
    """2D keypoint reprojection: project to the crop patch, rescale to
    network-input pixels, confidence-weighted MSE."""
    px, py = camera.project_screen(joints3d, crop_center)
    proj = torch.cat([px, py], dim=-1) * (net_in_size / camera.crop_size)
    err = (proj - kpts2d[..., :2]) ** 2
    return (err.sum(-1) * kpts2d[..., 2]).mean()


def ocent_loss(obj_points, obj_center_pred):
    """Object-centre consistency."""
    actual = obj_points.mean(dim=1)
    return ((actual - obj_center_pred) ** 2).sum(-1).mean()


def _contact_masks(df_hum_o, df_obj_h, thresh):
    """In-contact points (df < thresh) per side, a side with no contacts
    at all making all its points eligible; and whether each example has a
    contact on either side."""
    mask_h = df_hum_o < thresh
    mask_o = df_obj_h < thresh
    any_h = mask_h.any(dim=1, keepdim=True)
    any_o = mask_o.any(dim=1, keepdim=True)
    eff_h = mask_h | ~any_h  # fall back to all points
    eff_o = mask_o | ~any_o
    return eff_h, eff_o, (any_h | any_o)[:, 0]


def contact_nn_calls(smpl_verts, obj_points, df_hum_o, df_obj_h,
                     part_labels_h, part_labels_o, thresh=0.08):
    """The contact loss's two grouped 1-NN calls (h->o, then o->h), as
    ``nn_sqdist`` keyword sets; arguments as for ``contact_loss``."""
    eff_h, eff_o, _ = _contact_masks(df_hum_o, df_obj_h, thresh)
    gh = part_labels_h[None].expand(df_hum_o.shape)
    return [dict(x=smpl_verts, y=obj_points, y_mask=eff_o, x_group=gh,
                 y_group=part_labels_o),
            dict(x=obj_points, y=smpl_verts, y_mask=eff_h,
                 x_group=part_labels_o, y_group=gh)]


def contact_loss(smpl_verts, obj_points, df_hum_o, df_obj_h,
                 part_labels_h, part_labels_o, thresh=0.08, nn=None,
                 mesh=None):
    """Per-part contact chamfer.

    Args:
      smpl_verts: (B, Nh, 3); obj_points: (B, No, 3).
      df_hum_o: (B, Nh) predicted OBJECT df at smpl verts.
      df_obj_h: (B, No) predicted HUMAN df at object points.
      part_labels_h: (Nh,) SMPL part labels.
      part_labels_o: (B, No) predicted part labels of object points.
      nn: optional [(d_h, idx_h), (d_o, idx_o)], ``nn_sqdist_multi`` over
        ``contact_nn_calls`` of the same arguments; computed here (one
        kernel launch for both directions) when None.
      mesh: optional data-parallel mesh; the pair count is then the global
        batch's (summed over the ranks before the division), and the value
        this rank's share of the global batch's.

    Points with df < thresh are in contact; a side with no contacts at all
    makes all its points eligible. Each part with points on both sides is a
    cloud pair; the loss is the mean over pairs of the bidirectional mean
    squared chamfer. The two directions cover all B x 14 part pairs.
    """
    P = SMPL_PARTS_NUM
    eff_h, eff_o, example_on = _contact_masks(df_hum_o, df_obj_h, thresh)
    if nn is None:
        nn = nn_sqdist_multi(contact_nn_calls(
            smpl_verts, obj_points, df_hum_o, df_obj_h, part_labels_h,
            part_labels_o, thresh))
    (d_h, _), (d_o, _) = nn

    part_ids = torch.arange(P, device=smpl_verts.device)
    hm = eff_h[..., None] & (part_labels_h[None, :, None] == part_ids)
    om = eff_o[..., None] & (part_labels_o[..., None] == part_ids)
    nx = hm.sum(1)  # (B, P)
    ny = om.sum(1)
    valid = (nx > 0) & (ny > 0) & example_on[:, None]
    # zero the sentinel of unmatched queries (their pair is invalid anyway)
    dh_ok = torch.where(d_h < 0.5 * BIG, d_h, torch.zeros_like(d_h))
    do_ok = torch.where(d_o < 0.5 * BIG, d_o, torch.zeros_like(d_o))
    lx = torch.einsum("bn,bnp->bp", dh_ok, hm.to(d_h.dtype))
    ly = torch.einsum("bn,bnp->bp", do_ok, om.to(d_o.dtype))
    pair = lx / nx.clamp(min=1) + ly / ny.clamp(min=1)
    pair = torch.where(valid, pair, torch.zeros_like(pair))
    n_pairs = all_sum(valid.sum(), mesh)
    return torch.where(n_pairs > 0, pair.sum() / n_pairs.clamp(min=1),
                       torch.zeros_like(pair.sum()))


def vertex_normals(verts, faces):
    """(B, V, 3) area-weighted outward vertex normals from shared faces;
    ``faces`` (F, 3) integer tensor on the verts' device."""
    v0, v1, v2 = (verts[:, faces[:, i]] for i in range(3))
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)  # (B, F, 3), area-weighted
    n = torch.zeros_like(verts)
    for i in range(3):
        n.index_add_(1, faces[:, i], fn)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)


def collision_nn_call(smpl_verts, obj_points):
    """The collision loss's ungrouped 1-NN call (o->h), as ``nn_sqdist``
    keywords."""
    return dict(x=obj_points, y=smpl_verts)


def collision_signed(smpl_verts, smpl_normals, obj_points, nn=None):
    """(B, No) signed distance of each object point to the tangent plane of
    its nearest SMPL vertex (negative = inside). The nearest index is not
    differentiated; gradients flow through the object points and the SMPL
    surface. ``nn``: optional precomputed ``nn_sqdist`` result of
    ``collision_nn_call``."""
    _, idx = (nn if nn is not None
              else nn_sqdist(**collision_nn_call(smpl_verts, obj_points)))
    gidx = idx[..., None].expand(-1, -1, 3)
    v_nn = torch.gather(smpl_verts, 1, gidx)
    n_nn = torch.gather(smpl_normals, 1, gidx)
    return ((obj_points - v_nn) * n_nn).sum(-1)


def collision_loss(smpl_verts, smpl_normals, obj_points, nn=None):
    """Penetration penalty: mean s^2 over points inside the body."""
    signed = collision_signed(smpl_verts, smpl_normals, obj_points, nn)
    return (signed.clamp(max=0.0) ** 2).mean()
