"""Test-time image preparation: raw image -> network-ready crop with depth
normalization.

Counterpart of ``chore_tpu/data/test_data.py``, in numpy without cv2/PIL
(``data/imageio.py``, ``data/image_ops.py``): the crop is scaled so the
person appears as if standing at z_0 = 2.2 m under the Kinect camera (the
scale compares the bbox of the openpose keypoints with the projected
keypoints of the FrankMocap mesh moved to z_0); in-the-wild images are
restaged on the mean training crop centre (``use_mean_center``); keypoints
are rescaled into network-input pixels for the fitter.
"""
from __future__ import annotations

import os
import pickle
import threading

import numpy as np

from chore_tpu_torch.data import image_ops as iops
from chore_tpu_torch.data.paths import load_kpts_json, load_mocap
from chore_tpu_torch.ops.camera import PerspectiveCamera
from chore_tpu_torch.smpl.assets import load_landmark_regressors
from chore_tpu_torch.utils.meshio import load_ply

MEAN_CROP_CENTER = np.array([1008.0, 995.0])  # BEHAVE train mean
KINECT_SIZE = (2048, 1536)


class TestImagePrep:
    def __init__(self, image_size=(512, 512), crop_size=1200,
                 use_mean_center=False, z0=2.2, assets_dir=None,
                 crop_info_dir=None):
        self.img_size = tuple(image_size)
        self.crop_size = np.array([crop_size, crop_size], np.float64)
        self.use_mean_center = use_mean_center
        self.z0 = z0
        self.camera = PerspectiveCamera(crop_size=crop_size)
        self.body25_reg = load_landmark_regressors(assets_dir)["body25"]
        self.crop_info_dir = crop_info_dir

    # ------------------------------------------------------------------ #
    def persp_proj(self, points):
        """Project (N, 3) with the Kinect camera in original pixels."""
        z = points[:, 2:3]
        px = self.camera.fx_px * points[:, 0:1] / z + self.camera.cx_px
        py = self.camera.fy_px * points[:, 1:2] / z + self.camera.cy_px
        return np.concatenate([px, py, np.ones_like(px)], 1)

    @staticmethod
    def _bbox_width(j2d, exp=1.1):
        bmin = j2d.min(0)
        bmax = j2d.max(0)
        return (bmax - bmin) * exp

    def fullbody_crop_scale(self, kpts_2048, mocap_verts):
        """Scale factor making the person appear at z_0."""
        verts = mocap_verts - mocap_verts.mean(0) + np.array([0, 0, self.z0])
        j3d = self.body25_reg @ verts  # (25, 3)
        j3d_proj = self.persp_proj(j3d)
        valid = kpts_2048[:, 2] > 0.3
        if valid.sum() < 2:
            # too few confident keypoints to estimate a bbox scale: assume
            # the person already stands at z_0
            return 1.0
        j2d = kpts_2048[valid]
        j2d_mocap = j3d_proj[valid]
        width = self._bbox_width(j2d[:, :2])
        width_mocap = self._bbox_width(j2d_mocap[:, :2])
        w, h = width
        wm, hm = width_mocap
        if w >= h and wm >= hm:
            scale = w / max(wm, 1e-6)
        else:
            scale = h / max(hm, 1e-6)
        return float(scale) if np.isfinite(scale) and scale > 0 else 1.0

    # ------------------------------------------------------------------ #
    def pad_to_mean_center(self, img, crop_center):
        """Translate the image so crop_center lands on the mean training
        crop centre."""
        if not self.use_mean_center:
            return img
        h, w = img.shape[:2]
        top_left = (MEAN_CROP_CENTER - crop_center).astype(int)
        bottom_right = np.array([w, h]) + top_left
        kw, kh = KINECT_SIZE
        new_size = np.maximum([kw, kh], bottom_right).astype(int)
        # float64 like the reference's np.zeros: a uint8 canvas would make
        # the following resize round, flipping mask pixels at the 0.5
        # threshold and so which RGB boundary pixels the composition zeroes
        if img.ndim == 3:
            new_img = np.zeros((new_size[1], new_size[0], img.shape[2]))
        else:
            new_img = np.zeros((new_size[1], new_size[0]))
        x1y1 = np.maximum(0, top_left)
        x2y2 = np.minimum([kw, kh], bottom_right)
        sx1 = max(0, -top_left[0])
        sy1 = max(0, -top_left[1])
        sx2 = min(w, w - (bottom_right[0] - kw))
        sy2 = min(h, h - (bottom_right[1] - kh))
        new_img[x1y1[1]:x2y2[1], x1y1[0]:x2y2[0]] = img[sy1:sy2, sx1:sx2]
        return new_img

    # ------------------------------------------------------------------ #
    def prepare(self, rgb_file, save_crop_info=True):
        """-> dict with images (S, S, 5), crop_center, resize_scale,
        crop_scale, old_crop_center, kpts (net-input pixels), mocap pose and
        betas. ``save_crop_info=False`` writes no crop-info file (a padding
        copy of a frame another process prepares)."""
        person_mask, obj_mask = iops.load_masks(rgb_file)
        bmin, bmax = iops.masks2bbox([person_mask, obj_mask])
        crop_center = (bmin + bmax) // 2
        rgb = iops.load_rgb(rgb_file)
        rh, rw = rgb.shape[:2]
        if rw > rh:
            resize_scale = 2048 / rw
            newsize = (2048, int(rh * resize_scale))
        else:
            resize_scale = 1536 / rh
            newsize = (int(rw * resize_scale), 1536)
        bbox_width = (bmax - bmin) * resize_scale  # 2048-equivalent space
        crop_center = np.round(resize_scale * crop_center).astype(np.float64)
        rgb = iops.resize_linear(rgb, newsize)
        person_mask = iops.resize_linear(person_mask, newsize)
        obj_mask = iops.resize_linear(obj_mask, newsize)

        kpts = load_kpts_json(
            rgb_file.replace(".color.jpg", ".color.json"), tol=0.0
        )
        if kpts[:, 2].sum() == 0:
            raise ValueError(f"no valid keypoints in {rgb_file}")
        scaled_kpts = kpts.copy()
        scaled_kpts[:, :2] *= resize_scale

        mocap_verts, _ = load_ply(
            rgb_file.replace(".color.jpg", ".mocap.ply")
        )
        scale = self.fullbody_crop_scale(scaled_kpts, mocap_verts)
        crop_size = scale * self.crop_size
        # the subject must fit the final (depth-normalized) crop
        if not (bbox_width <= crop_size * 1.5).all():
            raise ValueError(
                f"bbox {bbox_width} exceeds crop {crop_size} for {rgb_file}")

        rgb = self.pad_to_mean_center(rgb, crop_center)
        person_mask = self.pad_to_mean_center(person_mask, crop_center)
        obj_mask = self.pad_to_mean_center(obj_mask, crop_center)
        old_center = crop_center.copy()
        if self.use_mean_center:
            crop_center = MEAN_CROP_CENTER.copy()

        rgb = iops.resize(iops.crop(rgb, crop_center, crop_size),
                          self.img_size) / 255.0
        pm = iops.resize(iops.crop(person_mask, crop_center, crop_size),
                         self.img_size) / 255.0
        om = iops.resize(iops.crop(obj_mask, crop_center, crop_size),
                         self.img_size) / 255.0
        images = iops.compose_rgbm3(om, pm, rgb)

        crop_info = {
            "rgb_newsize": np.array(newsize),
            "resize_scale": resize_scale,
            "crop_center": old_center,
            "crop_scale": scale,
            "crop_size": crop_size,
        }
        if save_crop_info:
            self._save_crop_info(rgb_file, crop_info)

        pose, betas = load_mocap(
            rgb_file.replace(".color.jpg", ".mocap.json")
        )
        kpts_net = self.scale_body_kpts(
            kpts, resize_scale, scale, old_center
        )
        return {
            "images": images,
            "path": rgb_file,
            "crop_center": crop_center.astype(np.float32),
            "old_crop_center": old_center.astype(np.float32),
            "resize_scale": np.float32(resize_scale),
            "crop_scale": np.float32(scale),
            "kpts": kpts_net.astype(np.float32),
            "mocap_pose": pose,
            "mocap_betas": betas,
            "crop_info": crop_info,
        }

    def _save_crop_info(self, rgb_file, crop_info):
        """Persist crop info for overlay rendering next to the image, or
        under ``crop_info_dir`` when set (read-only datasets)."""
        if self.crop_info_dir is not None:
            out = os.path.join(
                self.crop_info_dir,
                os.path.basename(rgb_file).replace(".color.jpg",
                                                   ".crop_info.pkl"),
            )
        else:
            out = rgb_file.replace(".color.jpg", ".crop_info.pkl")
        if os.path.isfile(out):
            return
        # published whole (a rename), so processes that prepare frames at
        # once never leave a torn file
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(crop_info, f)
            os.replace(tmp, out)
        except OSError:
            pass  # read-only dataset directory: the crop info is optional

    # ------------------------------------------------------------------ #
    def scale_body_kpts(self, kpts, resize_scale, crop_scale, old_center):
        """Original-image keypoints -> network-input pixels (BEHAVE variant;
        with use_mean_center also re-centred like the COCO variant)."""
        pxy = kpts[:, :2] * resize_scale
        if self.use_mean_center:
            pxy = pxy - old_center + MEAN_CROP_CENTER
            center = MEAN_CROP_CENTER
        else:
            center = old_center
        crop_size_org = crop_scale * self.camera.crop_size
        pxy = pxy - center + crop_size_org / 2.0
        pxy = pxy * self.img_size[0] / crop_size_org
        return np.concatenate([pxy, kpts[:, 2:3]], 1)
