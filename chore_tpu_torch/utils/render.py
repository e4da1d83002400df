"""Visualization: render reconstructed meshes over the input photo.

Counterpart of ``chore_tpu/utils/render.py``: a front render under the
Kinect camera, an optional side view, and ``align_to_input``, which
un-crops and un-scales the full-view render back onto the original photo
with the saved crop info. The z-buffer (``ops.rasterizer.hard_rasterize``)
runs on ``device``; flat Lambertian shading and texture lookup run on the
host in numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from chore_tpu_torch import resolve_device
from chore_tpu_torch.data.image_ops import resize_linear
from chore_tpu_torch.data.test_data import MEAN_CROP_CENTER
from chore_tpu_torch.ops.camera import KINECT_CX, KINECT_CY, KINECT_FX, \
    KINECT_FY
from chore_tpu_torch.ops.rasterizer import hard_rasterize, project_unit_k


def kinect_unit_k():
    """Kinect colour intrinsics in unit coords of the 2048-wide image (v is
    normalized by the 1536 height: 4:3)."""
    return np.array(
        [[KINECT_FX, 0, KINECT_CX],
         [0, KINECT_FY * 2048 / 1536, KINECT_CY * 2048 / 1536],
         [0, 0, 1]], np.float32,
    )


def look_at_side(verts, angle_deg=90.0, center=None):
    """Rotate the scene about the y axis through its centre, for a side
    view."""
    c = verts.mean(0) if center is None else center
    a = np.deg2rad(angle_deg)
    r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    return (verts - c) @ r.T + c


def rasterize_unit_k(verts, faces, K, image_size, device=None):
    """``hard_rasterize`` of one mesh under unit-coord intrinsics ``K`` on
    ``device`` (the card unless "cpu") -> (face index (S, S), bary
    (S, S, 3)) as numpy."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(verts, np.float32), device=dev)[None]
    k = torch.as_tensor(np.asarray(K, np.float32), device=dev)[None]
    f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    fi, _, bary = hard_rasterize(project_unit_k(v, k), f,
                                 image_size=image_size)
    return fi[0].cpu().numpy(), bary[0].cpu().numpy()


def render_meshes(mesh_list, colors, image_size=512, K=None,
                  light_dir=(0.3, -0.5, -0.8), background=None,
                  textures=None, ambient=0.4, directional=0.6, device=None):
    """Lambertian render of several meshes under the Kinect camera: one
    z-buffer pass across all meshes, flat colour or texture per mesh.

    Args:
      mesh_list: list of (verts (V, 3), faces (F, 3)).
      colors: list of RGB tuples per mesh (used where untextured).
      image_size: output resolution (square; the 4:3 Kinect view fills it
        through the unit-K normalization).
      K: (3, 3) unit-coord intrinsics; default full-view Kinect.
      textures: optional list parallel to mesh_list; entries are None or
        (uv_faces (F, 3, 2) image coords, texture (H, W, 3) [0, 1]).
      device: where the z-buffer runs (the card unless "cpu").

    Returns (image (S, S, 3) float [0, 1], mask (S, S) bool).
    """
    from chore_tpu_torch.utils.textures import face_normals, lighting, \
        sample_uv_colors

    K = kinect_unit_k() if K is None else K
    textures = textures or [None] * len(mesh_list)
    all_v, all_f, face_colors, all_uv, tex_id = [], [], [], [], []
    tex_images = []
    off = 0
    for (v, f), c, tx in zip(mesh_list, colors, textures):
        f = np.asarray(f, np.int64)
        all_v.append(np.asarray(v, np.float32))
        all_f.append(f + off)
        face_colors.append(np.tile(np.asarray(c, np.float32), (len(f), 1)))
        if tx is not None:
            uvf, img_tx = tx
            all_uv.append(np.asarray(uvf, np.float32))
            tex_id.append(np.full(len(f), len(tex_images), np.int32))
            tex_images.append(np.asarray(img_tx, np.float32))
        else:
            all_uv.append(np.zeros((len(f), 3, 2), np.float32))
            tex_id.append(np.full(len(f), -1, np.int32))
        off += len(v)
    verts = np.concatenate(all_v, 0)
    faces = np.concatenate(all_f, 0).astype(np.int32)
    fcolors = np.concatenate(face_colors, 0)
    uv_faces = np.concatenate(all_uv, 0)
    tex_id = np.concatenate(tex_id, 0)

    fi, bary = rasterize_unit_k(verts, faces, K, image_size, device)
    mask = fi >= 0
    shade = lighting(face_normals(verts, faces), light_dir,
                     ambient=ambient, directional=directional)
    img = (np.zeros((image_size, image_size, 3), np.float32)
           if background is None else background.copy())
    safe_fi = np.clip(fi, 0, len(faces) - 1)
    base = fcolors[safe_fi]
    if tex_images:
        uv_pix = np.einsum("hwk,hwkc->hwc", bary, uv_faces[safe_fi])
        for t, tex in enumerate(tex_images):
            sel = tex_id[safe_fi] == t
            if sel.any():
                base[sel] = sample_uv_colors(tex, uv_pix[sel])
    shaded = base * shade[safe_fi][..., None]
    img[mask] = shaded[mask]
    return img, mask


def _translate(img, dx, dy):
    """``cv2.warpAffine(img, [[1, 0, dx], [0, 1, dy]], (w, h))`` for an
    integer shift: out[y, x] = img[y - dy, x - dx], zero outside."""
    out = np.zeros_like(img)
    h, w = img.shape[:2]
    if abs(dx) < w and abs(dy) < h:
        out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
            img[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def align_to_input(render_sq, mask_sq, orig_image, crop_info,
                   use_mean_center=False, alpha=1.0):
    """Paste a full-Kinect-view render back onto the original photo.

    Args:
      render_sq: (S, S, 3) float32 square render of the full 2048 x 1536
        view (the 4:3 view fills the square: unit-K normalization).
      mask_sq: (S, S) bool foreground.
      orig_image: (H, W, 3) uint8 original photo.
      crop_info: dict from TestImagePrep (resize_scale, crop_center).
      use_mean_center: undo the prep's restaging of crop_center onto the
        mean centre, a whole-pixel shift (``crop_center`` is rounded);
        a fractional shift raises.

    The resizes are ``cv2.resize``'s float32 INTER_LINEAR
    (``data.image_ops.resize_linear``), the shift an exact translation with
    zero fill (what ``cv2.warpAffine`` does for a whole-pixel shift).
    """
    H, W = orig_image.shape[:2]
    s = crop_info["resize_scale"]
    render = resize_linear(np.asarray(render_sq, np.float32), (2048, 1536))
    mask = resize_linear(mask_sq.astype(np.float32), (2048, 1536)) > 0.5
    if use_mean_center:
        shift = np.asarray(crop_info["crop_center"]) - MEAN_CROP_CENTER
        dx, dy = (int(round(float(v))) for v in shift)
        if not np.allclose(shift, [dx, dy], rtol=0, atol=0):
            raise ValueError(f"crop-centre shift {shift} is not a whole "
                             "number of pixels")
        render = _translate(render, dx, dy)
        mask = _translate(mask.astype(np.float32), dx, dy) > 0.5
    rw, rh = int(round(W * s)), int(round(H * s))
    render = resize_linear(np.ascontiguousarray(render[:rh, :rw]), (W, H))
    mask = resize_linear(np.ascontiguousarray(
        mask[:rh, :rw].astype(np.float32)), (W, H)) > 0.5
    out = orig_image.astype(np.float32) / 255.0
    out[mask] = (1 - alpha) * out[mask] + alpha * render[mask]
    return (out * 255).astype(np.uint8)
