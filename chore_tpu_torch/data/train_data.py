"""Training dataset over preprocessed boundary-sample npz files.

Counterpart of ``chore_tpu/data/train_data.py``: per item, subsample
``total_samplenum`` points from the per-sigma boundary samples at the
release ratios, attach UDFs, part labels, the PCA axes and the centres,
and build the 5-channel uint8 crop around the mask-union bbox centre.
Every random draw comes from a RandomState of (seed, epoch, index), so an
item is the same in any worker and equal to ``chore_tpu``'s.
"""
from __future__ import annotations

import numpy as np

from chore_tpu_torch.data import image_ops as iops


class BehaveTrainData:
    def __init__(self, data_paths, phase="train",
                 total_samplenum=20000,
                 image_size=(512, 512),
                 ratios=(0.01, 0.49, 0.5),
                 sigmas=(0.08, 0.02, 0.003),
                 random_flip=False,
                 aug_blur=0.0,
                 crop_size=1200,
                 z0=2.2,
                 seed=0):
        if phase not in ("train", "val", "test"):
            raise ValueError(f"phase must be train, val or test: {phase!r}")
        self.data_paths = list(data_paths)
        self.phase = phase
        self.img_size = tuple(image_size)
        self.crop_size = np.array([crop_size, crop_size])
        self.total_sample_num = total_samplenum
        self.sample_nums = [int(total_samplenum * r) for r in ratios]
        self.sigmas = list(sigmas)
        self.random_flip = random_flip
        self.aug_blur = aug_blur
        self.z0 = z0
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        """Vary the per-item draws across epochs (called by the loader)."""
        self.epoch = int(epoch)

    def _item_rng(self, idx, attempt=0):
        return np.random.RandomState(
            (self.seed * 1_000_003 + self.epoch * 7919 + idx
             + 104_729 * attempt) % (2**31 - 1))

    def __len__(self):
        return len(self.data_paths)

    def get_item(self, idx):
        rng = self._item_rng(idx)
        path = self.data_paths[idx]
        flip = bool(self.phase == "train" and self.random_flip
                    and rng.rand() > 0.5)
        if flip:  # mirrored GT with the left/right part labels swapped
            path = path.replace(".npz", "_flip.npz")
        data = np.load(path, allow_pickle=True)
        res = self.get_samples(data, rng)
        images, center = self.prepare_image_crop(data, flip, rng)
        res["images"] = images
        res["crop_center"] = center.astype(np.float32)
        res["path"] = path
        return res

    def __getitem__(self, idx):
        """``get_item``, retried on a failure with another item drawn from
        an attempt-salted RandomState (the same (seed, epoch, idx) would
        redraw the same failing item forever); 100 failures in a row
        raise."""
        cur = idx
        for attempt in range(100):
            try:
                return self.get_item(cur)
            except Exception as e:  # noqa: BLE001 - any unreadable item
                ridx = int(self._item_rng(idx, attempt + 1).randint(
                    0, len(self.data_paths)))
                print(f"failed on {self.data_paths[cur]} ({e}), "
                      f"retrying {self.data_paths[ridx]}")
                cur = ridx
        raise RuntimeError(
            f"100 consecutive sample failures starting at index {idx}; "
            "the dataset looks unreadable")

    def get_samples(self, data, rng):
        """Per-sigma subsampling without replacement."""
        points, dfs_h, dfs_o, parts = [], [], [], []
        for sigma, n in zip(self.sigmas, self.sample_nums):
            key = f"sigma{sigma}"
            pts = data["points"].item()[key]
            choice = rng.choice(pts.shape[0], n, replace=False)
            points.append(pts[choice])
            dfs_h.append(data["dist_h"].item()[key][choice])
            dfs_o.append(data["dist_o"].item()[key][choice])
            parts.append(data["parts"].item()[key][choice])
        body_center = data["smpl_center"].astype(np.float32)
        if not abs(body_center[2] - self.z0) < 1e-5:
            raise ValueError(f"invalid smpl center {body_center}")
        # the PCA axes are per image: shipped as (3, 3), chore_losses
        # broadcasts them over the points
        return {
            "points": np.concatenate(points, 0).astype(np.float32),
            "df_h": np.concatenate(dfs_h, 0).astype(np.float32),
            "df_o": np.concatenate(dfs_o, 0).astype(np.float32),
            "parts": np.concatenate(parts, 0).astype(np.int32),
            "pca": np.asarray(data["pca_axis"], np.float32),
            "body_center": body_center,
            "obj_center": (data["obj_center"].astype(np.float32)
                           - body_center),
        }

    def prepare_image_crop(self, data, flip, rng):
        """Crop crop_size^2 around the mask-union bbox centre, resize to the
        network size, compose RGBM3 as uint8 (the field scales integer
        images by 1/255 on the device, the same values as the float
        pipeline, a quarter of the bytes to copy)."""
        rgb_file = str(data["image_file"])
        person_mask, obj_mask = iops.load_masks(rgb_file, flip)
        bmin, bmax = iops.masks2bbox([person_mask, obj_mask])
        center = (bmin + bmax) // 2
        ih, iw = person_mask.shape[:2]
        if not (0 < center[0] < iw and 0 < center[1] < ih):
            raise ValueError(f"invalid crop center {center} for {rgb_file}")
        rgb = iops.load_rgb(rgb_file, flip, self.aug_blur, rng)
        rgb = iops.resize(iops.crop(rgb, center, self.crop_size),
                          self.img_size)
        pm = iops.resize(iops.crop(person_mask, center, self.crop_size),
                         self.img_size)
        om = iops.resize(iops.crop(obj_mask, center, self.crop_size),
                         self.img_size)
        return iops.compose_rgbm3_u8(om, pm, rgb), center
