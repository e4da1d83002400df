"""Occlusion-aware differentiable silhouette loss on an ROI.

Counterpart of ``chore_tpu/recon/silhouette.py``. Host-side preparation
(numpy/scipy: object mask -> square bbox with 30% expansion, crop and
bilinear resize of the object/person masks to the render size, per-example
ROI intrinsics, optional edge distance transform) runs once per batch; the
loss renders the transformed template with ``ops.rasterizer.soft_silhouette``
(kernels K2/K3 on the card) and takes a masked L2 against the reference.

The JAX package resizes with ``cv2.resize(INTER_LINEAR)`` and dilates with
``cv2.dilate``; the port has no cv2 and computes the same maps with numpy
and ``scipy.ndimage``.
"""
from __future__ import annotations

import numpy as np
import torch

from chore_tpu_torch.ops.camera import (
    DEFAULT_IMAGE_SIZE,
    KINECT_CX,
    KINECT_CY,
    KINECT_FX,
    KINECT_FY,
)
from chore_tpu_torch.ops.rasterizer import project_unit_k, soft_silhouette

KINECT_W = float(DEFAULT_IMAGE_SIZE)
FX, FY = KINECT_FX, KINECT_FY
CX, CY = KINECT_CX, KINECT_CY


def mask_to_square_bbox(mask, expansion=0.3):
    """Object mask (H, W) in net-input space -> square bbox (x, y, size)
    with ``expansion`` added around the tight box."""
    ys, xs = np.where(mask > 0.5)
    if len(xs) == 0:
        raise ValueError("empty object mask")
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    w, h = x1 - x0, y1 - y0
    size = max(w, h) * (1.0 + expansion)
    cx, cy = x0 + w / 2.0, y0 + h / 2.0
    return np.array([cx - size / 2.0, cy - size / 2.0, size, size])


def _linear_taps(src, dst):
    """Source indices and f32 weights of a bilinear resize from ``src`` to
    ``dst`` samples, as OpenCV's INTER_LINEAR computes them: source
    coordinate (d + 0.5) * src/dst - 0.5 in double, border samples clamped
    to the edge with weight 1."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    low, high = i0 < 0, i0 >= src - 1
    frac[low | high] = 0.0
    i0 = np.where(low, 0, np.where(high, src - 1, i0))
    w1 = frac.astype(np.float32)
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1.0) - w1, w1


def resize_linear(img, out_size):
    """(H, W) float32 -> (out_size, out_size) bilinear resize, the
    horizontal pass first, in float32 (``cv2.resize(..., INTER_LINEAR)``'s
    result to an ulp)."""
    img = np.asarray(img, np.float32)
    x0, x1, ax0, ax1 = _linear_taps(img.shape[1], out_size)
    y0, y1, ay0, ay1 = _linear_taps(img.shape[0], out_size)
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    return rows[y0] * ay0[:, None] + rows[y1] * ay1[:, None]


def crop_resize(mask, bbox, out_size):
    """Crop bbox (x, y, w, h) from mask on a zero-padded canvas and resize
    the square crop to out_size^2."""
    x, y, w, h = bbox
    H, W = mask.shape
    pad = int(np.ceil(max(w, h))) + 2
    canvas = np.zeros((H + 2 * pad, W + 2 * pad), np.float32)
    canvas[pad : pad + H, pad : pad + W] = mask
    x0, y0 = int(round(x)) + pad, int(round(y)) + pad
    s = int(round(w))
    crop = canvas[y0 : y0 + s, x0 : x0 + s]
    return resize_linear(crop, out_size)


def compute_k_roi(bbox_orig, kinect_width=KINECT_W):
    """ROI intrinsics in unit coordinates for a bbox in original pixels."""
    x, y, b, _ = bbox_orig
    fx_ = FX * kinect_width / b
    fy_ = FY * kinect_width / b
    cx_ = (CX * kinect_width - x) / b
    cy_ = (CY * kinect_width - y) / b
    return np.array([[fx_, 0, cx_], [0, fy_, cy_], [0, 0, 1]], np.float32)


def edge_distance_transform(mask, kernel_size=7, power=0.25):
    """edt^(2*power) of the silhouette edges; edges = dilation - mask, the
    dilation a kernel_size^2 max filter with zero borders."""
    from scipy.ndimage import distance_transform_edt, maximum_filter

    fore = (mask > 0.5).astype(np.uint8)
    dil = maximum_filter(fore, size=kernel_size, mode="constant", cval=0)
    edges = dil.astype(np.float32) - fore.astype(np.float32)
    edt = distance_transform_edt(1 - (edges > 0)) ** (power * 2)
    return edt.astype(np.float32)


class SilhouetteLossROI:
    """Built once per batch from net-input person/object masks.

    Args:
      person_masks, obj_masks: (B, S, S) float arrays (net-input channels
        3/4).
      template_verts: (Vt, 3) centred object template vertices.
      template_faces: (Ft, 3) int faces.
      crop_centers: (B, 2) crop centres in original-image pixels.
      crop_size: training crop size (1200); net_input: 512.

    ``data`` holds numpy arrays: image_ref, keep_mask, edt_ref (B, R, R)
    and k_rois (B, 3, 3). A frame whose object mask is empty gets keep 0
    everywhere, so its silhouette term is zero.
    """

    def __init__(self, person_masks, obj_masks, template_verts,
                 template_faces, crop_centers, rend_size=256, crop_size=1200,
                 net_input=512, bbox_expansion=0.3, compute_edt=False):
        B = person_masks.shape[0]
        scale = crop_size / float(net_input)
        k_rois, keep_masks, image_refs, edts = [], [], [], []
        zeros = np.zeros((rend_size, rend_size), np.float32)
        for i in range(B):
            try:
                bbox = mask_to_square_bbox(np.asarray(obj_masks[i]),
                                           bbox_expansion)
            except ValueError:
                # no object mask: neutralize the frame, keep the batch
                image_refs.append(zeros)
                keep_masks.append(zeros)
                k_rois.append(compute_k_roi(
                    np.array([0.0, 0.0, KINECT_W, KINECT_W])))
                edts.append(zeros)
                continue
            obj_crop = crop_resize(np.asarray(obj_masks[i]), bbox, rend_size)
            ps_crop = crop_resize(np.asarray(person_masks[i]), bbox,
                                  rend_size)
            # keep everything except person-occluded non-object pixels
            fore = obj_crop > 0.5
            person = ps_crop > 0.5
            keep = (~person) | fore
            image_refs.append(fore.astype(np.float32))
            keep_masks.append(keep.astype(np.float32))
            bbox_orig = bbox * scale
            bbox_orig[:2] += np.asarray(crop_centers[i]) - crop_size / 2.0
            k_rois.append(compute_k_roi(bbox_orig))
            edts.append(edge_distance_transform(fore.astype(np.float32))
                        if compute_edt else zeros)
        self.data = {
            "image_ref": np.stack(image_refs),
            "keep_mask": np.stack(keep_masks),
            "edt_ref": np.stack(edts),
            "k_rois": np.stack(k_rois),
        }
        self.verts = np.asarray(template_verts, np.float32)
        self.faces = np.asarray(template_faces, np.int32)
        self.rend_size = rend_size

    def tensors(self, device):
        """``data`` as f32 tensors on ``device``."""
        return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                for k, v in self.data.items()}

    def __call__(self, R, t, s):
        dev = R.device
        return silhouette_loss(
            self.tensors(dev), torch.as_tensor(self.verts, device=dev),
            torch.as_tensor(self.faces, dtype=torch.int64, device=dev),
            R, t, s, self.rend_size)


def _posed_ndc(sil_data, template_verts, R, t, s):
    """The template posed by (R, t, s), projected with the ROI intrinsics."""
    verts = torch.einsum("vd,bde->bve", template_verts, R)
    verts = (verts + t[:, None, :]) * s[:, None, None]
    return project_unit_k(verts, sil_data["k_rois"])


def silhouette_loss(sil_data, template_verts, faces, R, t, s, rend_size=256,
                    sigma=None):
    """Render the transformed template in the ROI and compare it with the
    reference mask.

    Args:
      sil_data: dict of tensors image_ref / keep_mask (B, R, R), k_rois
        (B, 3, 3) on the parameters' device (``SilhouetteLossROI.tensors``).
      template_verts: (Vt, 3) tensor; faces: (Ft, 3) integer tensor.
      R: (B, 3, 3); t: (B, 3); s: (B,).
      sigma: coverage softness override (None = half a pixel).

    Returns (loss scalar, rendered (B, R, R)).
    """
    ndc = _posed_ndc(sil_data, template_verts, R, t, s)
    image = soft_silhouette(ndc, faces, image_size=rend_size, sigma=sigma)
    image = sil_data["keep_mask"] * image
    loss = ((image - sil_data["image_ref"]) ** 2).sum(dim=(1, 2)).mean()
    return loss, image


def offscreen_loss(sil_data, template_verts, R, t, s, far=100.0):
    """Hinge on how far the projected template verts leave the ROI frustum:
    sum over verts of relu(xy - 1) + relu(-1 - xy) + relu(-z) +
    relu(z - far), batch-meaned; zero while the object projects inside.
    ``torch.maximum`` splits the gradient at a tie, as ``jnp.maximum``
    does."""
    ndc = _posed_ndc(sil_data, template_verts, R, t, s)
    xy, z = ndc[..., :2], ndc[..., 2]
    zero = ndc.new_zeros(())
    per_ex = (torch.maximum(xy - 1.0, zero).sum(dim=(1, 2))
              + torch.maximum(-1.0 - xy, zero).sum(dim=(1, 2))
              + torch.maximum(-z, zero).sum(dim=1)
              + torch.maximum(z - far, zero).sum(dim=1))
    return per_ex.mean()
