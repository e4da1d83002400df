"""BEHAVE dataset on-disk readers (host IO, numpy): the counterpart of
``chore_tpu/behave/readers.py``, with the library calls it makes replaced
by the port's own (``data/imageio``): masks through ``read_gray``
(``cv2.IMREAD_GRAYSCALE``), colour through ``read_rgb`` (PIL's
``.convert("RGB")``), depth through ``read_depth``
(``cv2.IMREAD_ANYDEPTH``), and ``cv2.projectPoints`` in numpy float64
(``KinectCalib.project_points``). ``KinectCalib.undistort``
(``cv2.undistort``) is used by no path of the system and is not ported yet
(ROADMAP.md). The ``reference:`` notes name the files of the BEHAVE
toolkit that the JAX package's readers follow.

  SEQ/info.json                         sequence metadata (category, gender,
                                        calib paths, kinect ids)
  SEQ/<frame>/k{i}.color.jpg|.depth.png per-kinect images
  SEQ/<frame>/k{i}.person_mask.jpg, k{i}.obj_rend_mask.jpg etc.
  SEQ/<frame>/k{i}.mocap.json|.ply      FrankMocap estimates
  SEQ/<frame>/person/<save>/person_fit.ply|pkl   GT SMPL fits
  SEQ/<frame>/<obj>/<save>/<obj>_fit.ply|pkl     GT object fits
"""
from __future__ import annotations

import json
import os
import pickle
from os.path import basename, isdir, isfile, join

import numpy as np

from chore_tpu_torch.data.imageio import read_depth, read_gray, read_rgb
from chore_tpu_torch.utils.meshio import load_ply


def _read_rgb3(path):
    """``np.array(Image.open(path).convert("RGB"))``: (H, W, 3) uint8 for
    the colour and 8-bit gray files the readers meet (gray replicated,
    alpha dropped)."""
    img = read_rgb(path)
    if img.dtype == np.uint8 and img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        return np.ascontiguousarray(img[..., :3])
    raise ValueError(f"{path}: {img.dtype} image of shape {img.shape} is "
                     "not converted to RGB here")


class SeqInfo:
    """Sequence metadata from info.json (reference: seq_utils.py:11-58)."""

    def __init__(self, seq_path):
        with open(join(seq_path, "info.json")) as f:
            self.info = json.load(f)
        for name in ("config", "empty", "intrinsic"):
            if self.info.get(name) is not None:
                self.info[name] = join(seq_path, self.info[name])

    def get_obj_name(self, convert=False):
        cat = self.info["cat"]
        if convert:
            if "chair" in cat:
                return "chair"
            if "ball" in cat:
                return "sports ball"
        return cat

    def get_gender(self):
        return self.info["gender"]

    def get_config(self):
        return self.info["config"]

    def get_intrinsic(self):
        return self.info["intrinsic"]

    def beta_init(self):
        return self.info["beta"]

    def kinect_count(self):
        return len(self.info["kinects"]) if "kinects" in self.info else 3

    @property
    def kids(self):
        return list(range(self.kinect_count()))


class KinectFrameReader:
    """Frame discovery + color/depth loading
    (reference: sync_frame.py:15-107)."""

    def __init__(self, seq, kinect_count=4, ext="jpg", check_image=True,
                 empty=None):
        self.seq_path = seq.rstrip("/")
        self.ext = ext
        self.kinect_count = kinect_count
        self.seq_name = basename(self.seq_path)
        self.frames = self._discover(check_image)
        self.kids = list(range(kinect_count))
        self.empty = empty  # path to an empty-room sequence for bkg removal

    def prepare_bkgs(self):
        """Per-kinect mean background depth from the empty-room sequence
        (reference: sync_frame.py:107-112); None without one."""
        if self.empty is None:
            return None
        return [get_seq_bkg(self.empty, k)
                for k in range(self.kinect_count)]

    def _discover(self, check_image):
        valid = []
        for frame in sorted(os.listdir(self.seq_path)):
            folder = join(self.seq_path, frame)
            if not isdir(folder):
                continue
            if not check_image:
                valid.append(frame)
                continue
            ok = all(
                isfile(join(folder, f"k{k}.color.{self.ext}"))
                and isfile(join(folder, f"k{k}.depth.png"))
                for k in range(self.kinect_count)
            )
            if ok:
                valid.append(frame)
        return valid

    def __len__(self):
        return len(self.frames)

    def get_frame_folder(self, idx):
        if isinstance(idx, str):
            return join(self.seq_path, idx)
        return join(self.seq_path, self.frames[idx])

    def get_frame_idx(self, frame_time):
        return self.frames.index(frame_time)

    def get_color_files(self, idx, kids):
        folder = self.get_frame_folder(idx)
        return [join(folder, f"k{k}.color.{self.ext}") for k in kids]

    def get_color_images(self, idx, kids):
        return [_read_rgb3(f) for f in self.get_color_files(idx, kids)]

    def get_depth_images(self, idx, kids):
        folder = self.get_frame_folder(idx)
        return [_read_depth_or_none(join(folder, f"k{k}.depth.png"))
                for k in kids]


class FrameDataReader(KinectFrameReader):
    """Per-frame GT/mocap/mask access (reference: frame_data.py:18-203)."""

    def __init__(self, seq, empty=None, ext="jpg", check_image=True):
        info = SeqInfo(seq)
        super().__init__(seq, info.kinect_count(), ext, check_image,
                         empty=empty)
        self.seq_info = info
        self.kids = info.kids

    def _load_mesh(self, path):
        if not isfile(path):
            return None
        return load_ply(path)

    def get_mocap_mesh(self, idx, kid=1):
        return self._load_mesh(
            join(self.get_frame_folder(idx), f"k{kid}.mocap.ply")
        )

    def get_mocap_params(self, idx, kid=1):
        f = join(self.get_frame_folder(idx), f"k{kid}.mocap.json")
        if not isfile(f):
            return None, None
        with open(f) as fh:
            p = json.load(fh)
        return np.asarray(p["pose"]), np.asarray(p["betas"])

    def smplfit_meshfile(self, idx, save_name, ext="ply"):
        return join(self.get_frame_folder(idx), "person", save_name,
                    f"person_fit.{ext}")

    def get_smplfit(self, idx, save_name):
        if save_name is None:
            return None
        return self._load_mesh(self.smplfit_meshfile(idx, save_name))

    def objfit_meshfile(self, idx, save_name, ext="ply", convert=True):
        name = self.seq_info.get_obj_name(convert=convert)
        path = join(self.get_frame_folder(idx), name, save_name,
                    f"{name}_fit.{ext}")
        if not isfile(path):
            name = self.seq_info.get_obj_name()
            path = join(self.get_frame_folder(idx), name, save_name,
                        f"{name}_fit.{ext}")
        return path

    def get_objfit(self, idx, save_name):
        if save_name is None:
            return None
        return self._load_mesh(self.objfit_meshfile(idx, save_name))

    def get_objfit_params(self, idx, save_name):
        name = self.seq_info.get_obj_name(convert=True)
        path = join(self.get_frame_folder(idx), name, save_name,
                    f"{name}_fit.pkl")
        if not isfile(path):  # same raw-name fallback as objfit_meshfile
            name = self.seq_info.get_obj_name()
            path = join(self.get_frame_folder(idx), name, save_name,
                        f"{name}_fit.pkl")
        if not isfile(path):
            return None, None
        with open(path, "rb") as f:
            fit = pickle.load(f)
        return fit["angle"], fit["trans"]

    def get_body_kpts(self, idx, kid, tol=0.5):
        f = join(self.get_frame_folder(idx), f"k{kid}.color.json")
        if not isfile(f):
            return None
        with open(f) as fh:
            data = json.load(fh)
        j2d = np.asarray(data["body_joints"], np.float64).reshape(-1, 3)
        j2d[:, 2] = np.where(j2d[:, 2] < tol, 0, j2d[:, 2])
        return j2d

    def get_mask(self, idx, kid, cat="person", ret_bool=True):
        folder = self.get_frame_folder(idx)
        if cat == "person":
            f = join(folder, f"k{kid}.person_mask.{self.ext}")
        elif cat == "obj":
            f = join(folder, f"k{kid}.obj_rend_mask.jpg")
            if not isfile(f):
                f = join(folder, f"k{kid}.obj_mask.{self.ext}")
        else:
            raise ValueError(cat)
        if not isfile(f):
            return None
        mask = read_gray(f)
        return mask > 127 if ret_bool else mask

    def get_mask_full(self, idx, kid):
        f = join(self.get_frame_folder(idx), f"k{kid}.obj_rend_full.jpg")
        if not isfile(f):
            return None
        return read_gray(f) > 127

    def cvt_end(self, end):
        n = len(self)
        return n if end is None or end > n else end


def _read_depth_or_none(path):
    """``cv2.imread(path, cv2.IMREAD_ANYDEPTH)``: None for a missing file."""
    return read_depth(path) if isfile(path) else None


def _tilt_matrix(tau_x, tau_y):
    """OpenCV's ``computeTiltProjectionMatrix`` (the 14-coefficient model's
    tilted sensor)."""
    cx, sx, cy, sy = np.cos(tau_x), np.sin(tau_x), np.cos(tau_y), np.sin(tau_y)
    rot_x = np.array([[1.0, 0, 0], [0, cx, sx], [0, -sx, cx]])
    rot_y = np.array([[cy, 0, -sy], [0, 1.0, 0], [sy, 0, cy]])
    rxy = rot_y @ rot_x
    proj_z = np.array([[rxy[2, 2], 0, -rxy[0, 2]], [0, rxy[2, 2], -rxy[1, 2]],
                       [0, 0, 1.0]])
    return proj_z @ rxy


def project_points(points, camera_matrix, dist_coeffs):
    """``cv2.projectPoints(points, 0, 0, camera_matrix, dist_coeffs)`` in
    float64: OpenCV's pinhole model with its radial (k1-k6), tangential
    (p1, p2), thin-prism (s1-s4) and tilt (tau_x, tau_y) terms, for 0, 4, 5,
    8, 12 or 14 coefficients. (N, 3) -> (N, 2)."""
    p = np.asarray(points, np.float64).reshape(-1, 3)
    d = np.asarray(dist_coeffs, np.float64).reshape(-1)
    if d.size not in (0, 4, 5, 8, 12, 14):
        raise ValueError(f"{d.size} distortion coefficients: OpenCV takes "
                         "4, 5, 8, 12 or 14")
    k = np.zeros(14)
    k[:d.size] = d
    z = p[:, 2]
    inv_z = np.where(z != 0, 1.0 / np.where(z != 0, z, 1.0), 1.0)
    x, y = p[:, 0] * inv_z, p[:, 1] * inv_z
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    a1 = 2 * x * y
    a2 = r2 + 2 * x * x
    a3 = r2 + 2 * y * y
    cdist = 1 + k[0] * r2 + k[1] * r4 + k[4] * r6
    icdist2 = 1.0 / (1 + k[5] * r2 + k[6] * r4 + k[7] * r6)
    xd = x * cdist * icdist2 + k[2] * a1 + k[3] * a2 + k[8] * r2 + k[9] * r4
    yd = y * cdist * icdist2 + k[2] * a3 + k[3] * a1 + k[10] * r2 + k[11] * r4
    if k[12] or k[13]:
        tilt = np.stack([xd, yd, np.ones_like(xd)], -1) @ _tilt_matrix(
            k[12], k[13]).T
        w = np.where(tilt[:, 2] != 0, 1.0 / np.where(tilt[:, 2] != 0,
                                                     tilt[:, 2], 1.0), 1.0)
        xd, yd = w * tilt[:, 0], w * tilt[:, 1]
    cam = np.asarray(camera_matrix, np.float64)
    return np.stack([xd * cam[0, 0] + cam[0, 2], yd * cam[1, 1] + cam[1, 2]],
                    -1)


def _distortion(dist_coeffs):
    d = np.asarray(dist_coeffs, np.float64).reshape(-1)
    if d.size not in (0, 4, 5, 8, 12, 14):
        raise ValueError(f"{d.size} distortion coefficients: OpenCV takes "
                         "4, 5, 8, 12 or 14")
    k = np.zeros(14)
    k[:d.size] = d
    return k


_REMAP_BITS = 5  # OpenCV's INTER_BITS: map coordinates in 1/32 pixel


def undistort_maps(camera_matrix, dist_coeffs, size):
    """OpenCV's ``initUndistortRectifyMap(K, dist, I, K, size, CV_16SC2)``:
    for each pixel of the undistorted (width, height) ``size`` image, the
    source position in the distorted image in 1/32 pixel, computed in
    float64 and rounded to nearest even. Returns (ix, iy) int64 (H, W)."""
    w, h = size
    K = np.asarray(camera_matrix, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tau_x, tau_y = \
        _distortion(dist_coeffs)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = np.broadcast_to((np.arange(w) - u0) / fx, (h, w))
    y = np.broadcast_to(((np.arange(h) - v0) / fy)[:, None], (h, w))
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2 + s3 * r2 + s4 * r2 * r2
    t = _tilt_matrix(tau_x, tau_y)
    tx = t[0, 0] * xd + t[0, 1] * yd + t[0, 2]
    ty = t[1, 0] * xd + t[1, 1] * yd + t[1, 2]
    tz = t[2, 0] * xd + t[2, 1] * yd + t[2, 2]
    inv = np.where(tz != 0, 1.0 / np.where(tz != 0, tz, 1.0), 1.0)
    u = fx * inv * tx + u0
    v = fy * inv * ty + v0
    scale = 1 << _REMAP_BITS
    return (np.rint(u * scale).astype(np.int64),
            np.rint(v * scale).astype(np.int64))


def remap_linear(img, ix, iy):
    """OpenCV's ``remap(img, map1, map2, INTER_LINEAR, BORDER_CONSTANT)``
    with 1/32-pixel maps (``undistort_maps``): the four neighbours of each
    source position, zero outside the image, weighted by the fractions
    (1/32 steps). uint8 images sum the weights in OpenCV's 15-bit fixed
    point and round; float images in float32."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    mask = (1 << _REMAP_BITS) - 1
    sx, sy = ix >> _REMAP_BITS, iy >> _REMAP_BITS
    ax, ay = ix & mask, iy & mask
    scale = 1 << _REMAP_BITS
    pad = np.zeros((h + 2, w + 2) + img.shape[2:], img.dtype)
    pad[1:-1, 1:-1] = img
    # out-of-image taps read the zero border (clipped into the pad ring)
    cx0 = np.clip(sx, -1, w) + 1
    cx1 = np.clip(sx + 1, -1, w) + 1
    cy0 = np.clip(sy, -1, h) + 1
    cy1 = np.clip(sy + 1, -1, h) + 1
    taps = (pad[cy0, cx0], pad[cy0, cx1], pad[cy1, cx0], pad[cy1, cx1])
    wts = ((scale - ay) * (scale - ax), (scale - ay) * ax,
           ay * (scale - ax), ay * ax)  # in 1/1024
    extra = (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        # the weights in 1/32768 (exact: 32768 / 1024 = 32), summed in
        # integers and rounded back by >> 15, as OpenCV's 8-bit remap
        acc = sum(t.astype(np.int64) * (32 * wt)[(...,) + extra]
                  for t, wt in zip(taps, wts))
        return np.clip((acc + (1 << 14)) >> 15, 0, 255).astype(np.uint8)
    acc = None
    for t, wt in zip(taps, wts):
        term = t.astype(np.float32) * (wt.astype(np.float32)
                                       / np.float32(1024))[(...,) + extra]
        acc = term if acc is None else acc + term
    return acc.astype(img.dtype)


def undistort_image(img, camera_matrix, dist_coeffs):
    """``cv2.undistort(img, camera_matrix, dist_coeffs)``: the undistorted
    image of the same size, pixels whose source falls outside the image
    black. Within OpenCV's own 1/32-pixel fixed point: a source position
    that rounds the other way (float64 noise at a 1/64 boundary) moves a
    pixel by one 1/32 step."""
    h, w = np.asarray(img).shape[:2]
    ix, iy = undistort_maps(camera_matrix, dist_coeffs, (w, h))
    return remap_linear(img, ix, iy)


class KinectCalib:
    """Color-camera intrinsics + depth->pointcloud table + depth<->color
    mappings (reference: kinect_calib.py:13-181)."""

    def __init__(self, calibration, pc_table):
        self.pc_table_ext = np.dstack(
            [pc_table, np.ones(pc_table.shape[:2] + (1,), pc_table.dtype)]
        )
        color = calibration["color"]
        self.image_size = (color["width"], color["height"])
        self.calibration_matrix = np.eye(3)
        self.calibration_matrix[0, 0] = color["fx"]
        self.calibration_matrix[1, 1] = color["fy"]
        self.calibration_matrix[:2, 2] = (color["cx"], color["cy"])
        self.dist_coeffs = np.asarray(color["opencv"][4:])
        # depth<->color extrinsics (kinect_calib.py:19-27); identity for
        # synthetic calibrations that omit them
        d2c = calibration.get("depth_to_color")
        c2d = calibration.get("color_to_depth")
        self.depth2color_R = (np.asarray(d2c["rotation"]).reshape(3, 3)
                              if d2c else np.eye(3))
        self.depth2color_t = (np.asarray(d2c["translation"])
                              if d2c else np.zeros(3))
        self.color2depth_R = (np.asarray(c2d["rotation"]).reshape(3, 3)
                              if c2d else np.eye(3))
        self.color2depth_t = (np.asarray(c2d["translation"])
                              if c2d else np.zeros(3))

    def undistort(self, img):
        """``cv2.undistort(img, calibration_matrix, dist_coeffs)`` of a
        color image (``undistort_image``)."""
        return undistort_image(img, self.calibration_matrix,
                               self.dist_coeffs)

    def project_points(self, points):
        """Distortion-aware projection into the color image (N, 2):
        ``cv2.projectPoints`` with zero rotation and translation."""
        return project_points(points, self.calibration_matrix,
                              self.dist_coeffs)

    def dmap2pc(self, depth, return_mask=False):
        """Depth map (mm) -> (N, 3) point cloud via the precomputed table
        (kinect_calib.py:77-90)."""
        d = depth.astype(np.float64) / 1000.0
        d[depth == 0] = np.nan
        pc = self.pc_table_ext * d[..., None]
        valid = np.isfinite(pc[:, :, 0])
        if return_mask:
            return pc[valid], valid
        return pc[valid]

    @staticmethod
    def interpolate_depth(depth_im):
        """Fill depth holes (zeros) by 1-D linear interpolation over the
        flattened map (kinect_calib.py:91-100, the PROX recipe)."""
        flat = depth_im.ravel().astype(np.float64)
        zero = flat == 0.0
        if zero.any() and (~zero).any():
            flat[zero] = np.interp(np.flatnonzero(zero),
                                   np.flatnonzero(~zero), flat[~zero])
        return flat.reshape(depth_im.shape)

    def pc2color(self, pointcloud):
        """Depth-camera points -> color-image pixel coordinates (N, 2)
        (kinect_calib.py:102-110)."""
        pc_color = pointcloud @ self.depth2color_R.T + self.depth2color_t
        return self.project_points(pc_color)

    def valid_pixmask(self, color_pixels):
        """(N,) bool: pixel inside the color image
        (kinect_calib.py:123-128)."""
        w, h = self.image_size
        return ((color_pixels[:, 0] >= 0) & (color_pixels[:, 0] < w)
                & (color_pixels[:, 1] >= 0) & (color_pixels[:, 1] < h))

    def pc2color_valid(self, pointcloud):
        """(pixels, points) with out-of-image projections removed
        (kinect_calib.py:112-121)."""
        pix = self.pc2color(pointcloud)
        mask = self.valid_pixmask(pix)
        return pix[mask], pointcloud[mask]

    def color_to_pc(self, colorpts, pc_depth, projected_color_pc=None,
                    k=4, std=1.0):
        """Color-pixel coordinates -> interpolated 3D points: Gaussian
        kNN blend over the projected point cloud
        (kinect_calib.py:130-146)."""
        from scipy.spatial import cKDTree

        if projected_color_pc is None:
            projected_color_pc = self.pc2color(pc_depth)
        dists, inds = cKDTree(projected_color_pc).query(colorpts, k=k)
        dists = dists.reshape(-1, k)  # scipy squeezes the k=1 axis
        inds = inds.reshape(-1, k)
        w = np.exp(-dists / (2.0 * std**2))
        w = w / w.sum(axis=1, keepdims=True)
        return (pc_depth[inds.reshape(-1)].reshape(-1, k, 3)
                * w[:, :, None]).sum(axis=1)

    def get_pc_colors(self, pointcloud, color_frame,
                      projected_color_pc=None):
        """Per-point RGB in [0, 1] sampled from the color image with
        bivariate-spline interpolation (kinect_calib.py:148-163)."""
        from scipy.interpolate import RectBivariateSpline

        if projected_color_pc is None:
            projected_color_pc = self.pc2color(pointcloud)
        colors = np.ones_like(pointcloud, dtype=np.float64)
        for i in range(3):
            spline = RectBivariateSpline(
                np.arange(color_frame.shape[0]),
                np.arange(color_frame.shape[1]),
                color_frame[:, :, i])
            colors[:, i] = spline(projected_color_pc[:, 1],
                                  projected_color_pc[:, 0], grid=False)
        return np.clip(colors / 255.0, 0.0, 1.0)

    def pc2dmap(self, points):
        """Reproject a point cloud to a dense color-frame depth map via
        nearest-grid interpolation (kinect_calib.py:165-176)."""
        from scipy import interpolate

        p2d = self.project_points(points)
        cw, ch = self.image_size
        px, py = np.meshgrid(np.linspace(0, cw - 1, cw),
                             np.linspace(0, ch - 1, ch))
        depth = interpolate.griddata(p2d, points[:, 2], (px, py),
                                     method="nearest")
        dmap = np.zeros((ch, cw))
        dmap[py.astype(int), px.astype(int)] = depth
        return dmap

    def dmap2colorpc(self, color, depth):
        """Depth map in the color camera -> (points, per-point colors)
        (kinect_calib.py:178-181)."""
        pc, mask = self.dmap2pc(depth, return_mask=True)
        return pc, color[mask]


def get_seq_bkg(seq, kid, start=0):
    """Mean depth over all frames of one kinect in an (empty-room) sequence
    (reference: sync_frame.py:135-146)."""
    depths = []
    for frame in sorted(os.listdir(seq))[start:]:
        depth = _read_depth_or_none(join(seq, frame, f"k{kid}.depth.png"))
        if depth is not None:
            depths.append(depth)
    return np.stack(depths, axis=-1).mean(axis=-1)


def remove_background(depth, bkg, tol=100):
    """Zero out pixels within tol (mm) of the background depth
    (reference: sync_frame.py:117-121, 149-153). Operates in place like
    the reference and also returns the array."""
    diff = np.abs(depth - bkg)
    depth[~(diff >= tol)] = 0
    return depth


def load_intrinsics(intrinsic_folder, kids):
    out = []
    for k in kids:
        with open(join(intrinsic_folder, f"{k}/calibration.json")) as f:
            calib = json.load(f)
        table = np.load(join(intrinsic_folder, f"{k}/pointcloud_table.npy"))
        out.append(KinectCalib(calib, table))
    return out


def load_kinect_poses(config_folder, kids):
    rots, trans = [], []
    for k in kids:
        with open(join(config_folder, f"{k}/config.json")) as f:
            cfg = json.load(f)
        rots.append(np.asarray(cfg["rotation"]).reshape(3, 3))
        trans.append(np.asarray(cfg["translation"]))
    return rots, trans


def load_kinect_poses_back(config_folder, kids):
    """Inverse (world -> camera-k) transforms
    (reference: behave/utils.py:46-67)."""
    rots, trans = load_kinect_poses(config_folder, kids)
    rb, tb = [], []
    for r, t in zip(rots, trans):
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = t
        inv = np.linalg.inv(m)
        rb.append(inv[:3, :3])
        tb.append(inv[:3, 3])
    return rb, tb


class KinectTransform:
    """Sequence-specific world<->camera-k transforms
    (reference: kinect_transform.py:14-87)."""

    def __init__(self, seq):
        self.seq_info = SeqInfo(seq)
        kids = self.seq_info.kids
        self.intrinsics = load_intrinsics(self.seq_info.get_intrinsic(), kids)
        self.local2world_R, self.local2world_t = load_kinect_poses(
            self.seq_info.get_config(), kids
        )
        self.world2local_R, self.world2local_t = load_kinect_poses_back(
            self.seq_info.get_config(), kids
        )

    def world2local(self, points, kid):
        return points @ self.world2local_R[kid].T + self.world2local_t[kid]

    def local2world(self, points, kid):
        return points @ self.local2world_R[kid].T + self.local2world_t[kid]

    def world2color_verts(self, verts, kid):
        return self.world2local(verts, kid)

    def project2color(self, p3d, kid):
        return self.intrinsics[kid].project_points(self.world2local(p3d, kid))

    @staticmethod
    def flip_verts(verts):
        out = verts.copy()
        out[:, 0] = -out[:, 0]
        return out
