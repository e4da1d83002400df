"""Host-side image operations of the test-time data path (numpy only).

Counterpart of ``chore_tpu/data/image_ops.py``: mask loading with the
reference's file-name fallbacks, the bbox of the mask union, centre crop
with zero padding, the aspect-checked resize and the 5-channel RGBM3
composition. Files are read through ``data/imageio.py``; ``resize``
reproduces ``cv2.resize(..., INTER_LINEAR)`` bit for bit on uint8 and
float32 input (OpenCV's 11-bit fixed point; its float kernels), and to
float rounding on float64.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from chore_tpu_torch import native
from chore_tpu_torch.data.imageio import read_gray, read_rgb


def mask_paths_for(rgb_file):
    """Person/object mask paths with the reference's fallback chain."""
    person = rgb_file.replace(".color.jpg", ".person_mask.jpg")
    if not osp.isfile(person):
        person = rgb_file.replace(".color.jpg", ".person_mask.png")
    obj = rgb_file.replace(".color.jpg", ".obj_rend_mask.jpg")
    if not osp.isfile(obj):
        obj = rgb_file.replace(".color.jpg", ".obj_mask.jpg")
        if not osp.isfile(obj):
            obj = rgb_file.replace(".color.jpg", ".obj_mask.png")
    return person, obj


def load_masks(rgb_file, flip=False):
    person_file, obj_file = mask_paths_for(rgb_file)
    if not (osp.isfile(person_file) and osp.isfile(obj_file)):
        raise FileNotFoundError(f"masks missing for {rgb_file}")
    person, obj = read_gray(person_file), read_gray(obj_file)
    if flip:
        person = person[:, ::-1]
        obj = obj[:, ::-1]
    return person, obj


def load_rgb(rgb_file, flip=False, blur_sigma=0.0, rng=None):
    """The RGB photo, mirrored if ``flip``; with ``blur_sigma`` > 0 blurred
    by a Gaussian of sigma ``rng.uniform(0, blur_sigma) * 255`` (the
    training augmentation)."""
    rgb = read_rgb(rgb_file)
    if flip:
        rgb = rgb[:, ::-1]
    if blur_sigma > 1e-6:
        rng = rng or np.random
        s = float(rng.uniform(0, blur_sigma)) * 255.0
        if s > 0:
            rgb = gaussian_blur_u8(rgb, int(2 * round(3 * s) + 1), s)
    return rgb


def gaussian_kernel_u8(ksize, sigma):
    """OpenCV's 8-bit Gaussian kernel: the sampled, normalised Gaussian
    in units of 1/256, rounded from the outer taps inward with the
    rounding error carried to the next tap, the centre tap making the sum
    exactly 256."""
    half = (ksize - 1) // 2
    d = np.arange(half, dtype=np.float64) - half
    side = np.exp(-(d * d) / (2.0 * sigma * sigma))
    side /= 2.0 * side.sum() + 1.0
    taps, err = [], 0.0
    for x in side:
        adj = x * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        taps.append(v)
    return np.array(taps + [256 - 2 * sum(taps)] + taps[::-1], np.int64)


def gaussian_blur_u8(img, ksize, sigma):
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of a uint8 image, as
    OpenCV's fixed-point path computes it: the 8-bit kernel along rows,
    then columns (exact integer sums), rounded once from 16 fractional
    bits; BORDER_REFLECT_101 edges."""
    from scipy.ndimage import correlate1d

    w = gaussian_kernel_u8(ksize, sigma)
    acc = correlate1d(img.astype(np.int64), w, axis=1, mode="mirror")
    acc = correlate1d(acc, w, axis=0, mode="mirror")
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)


def masks2bbox(masks, thres=127):
    """(bmin, bmax) xyxy of the union of masks: the bbox of the pixels of
    clip(sum, 0, 255) above ``thres`` (what the reference's union of
    contour rects covers); an empty union gives [50000, 50000] /
    [-100, -100]."""
    comb = np.zeros_like(masks[0], dtype=np.int32)
    for m in masks:
        comb += m
    fg = np.clip(comb, 0, 255, out=comb) > thres
    # the rows, then the columns of those rows, that hold a pixel: two
    # reductions instead of every pixel's coordinates (a 2,048 x 1,536
    # mask is decoded for every training item)
    rows = np.flatnonzero(fg.any(axis=1))
    if rows.size == 0:
        return np.array([50000, 50000]), np.array([-100, -100])
    cols = np.flatnonzero(fg[rows[0]:rows[-1] + 1].any(axis=0))
    return (np.array([cols[0], rows[0]]),
            np.array([cols[-1] + 1, rows[-1] + 1]))


def crop(img, center, crop_size):
    """Crop a (crop_size x crop_size) patch around center, zero-padded at
    borders (including the reference's (w-1, h-1) clamping)."""
    h, w = img.shape[:2]
    size = np.broadcast_to(np.asarray(crop_size), (2,))
    topleft = np.round(np.asarray(center) - size / 2).astype(int)
    bottomright = np.round(np.asarray(center) + size / 2).astype(int)
    x1, y1 = max(0, topleft[0]), max(0, topleft[1])
    x2, y2 = min(w - 1, bottomright[0]), min(h - 1, bottomright[1])
    cropped = img[y1:y2, x1:x2]
    p1 = max(0, -topleft[0])
    p2 = max(0, -topleft[1])
    p3 = max(0, bottomright[0] - w + 1)
    p4 = max(0, bottomright[1] - h + 1)
    pad = [[p2, p4], [p1, p3]] + ([[0, 0]] if img.ndim == 3 else [])
    return np.pad(cropped, pad)


def resize(img, img_size):
    """Aspect-ratio-checked resize to (width, height)."""
    h, w = img.shape[:2]
    if abs(w / h - img_size[0] / img_size[1]) >= 1e-6:
        raise ValueError(f"aspect mismatch: image {img.shape} vs target "
                         f"{img_size}")
    return resize_linear(img, img_size)


def _linear_taps(n_in, n_out, dtype):
    """OpenCV's INTER_LINEAR source index and fraction per output index:
    fx = (d + 0.5) * scale - 0.5 rounded to ``dtype`` (float32 for uint8
    images, float64 for float64 ones), sx = floor(fx), fx -= sx."""
    scale = 1.0 / (n_out / n_in)  # OpenCV's 1 / inv_scale, in double
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(dtype)).astype(dtype)


def resize_linear(img, size):
    """``cv2.resize(img, size)`` (INTER_LINEAR), size = (width, height), for
    uint8 and float images of 1 or more channels:

    * the same size: a copy;
    * uint8 and float64, an exact 2x downscale: OpenCV's INTER_AREA fast
      path (2x2 mean, rounded for uint8), which it switches to there;
    * else half-pixel bilinear. Horizontally the source index is clamped
      to [0, w - 1] with the weight moved onto the kept sample; vertically
      the two rows are clamped and keep their weights. uint8 runs OpenCV's
      fixed point: 11-bit weights round(w * 2048) (float32 w), integer
      horizontal sums, then ((b0 * (S0 >> 4)) >> 16) +
      ((b1 * (S1 >> 4)) >> 16) + 2) >> 2; float64 runs the same taps with
      float64 weights in float64; float32 takes float64 taps, rounds the
      fraction f to float32 and interpolates as OpenCV's float kernels
      do, a + (b - a) * f with one rounding after the multiply-add, along
      rows, then columns."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    if img.dtype == np.float32:
        return _resize_linear_f32(img, out_w, out_h)
    u8 = img.dtype == np.uint8
    if (w == 2 * out_w and h == 2 * out_h):
        x = img.astype(np.int32 if u8 else np.float64)
        s = (x[0::2, 0::2] + x[0::2, 1::2]) + (x[1::2, 0::2] + x[1::2, 1::2])
        return ((s + 2) >> 2).astype(np.uint8) if u8 else (
            (s * 0.25).astype(img.dtype))

    wt = np.float32 if u8 else np.float64
    sx, fx = _linear_taps(w, out_w, wt)
    lo = sx < 0
    fx[lo], sx[lo] = 0.0, 0
    hi = sx >= w - 1
    fx[hi], sx[hi] = 0.0, w - 1
    sx1 = np.minimum(sx + 1, w - 1)
    sy, fy = _linear_taps(h, out_h, wt)
    sy0 = np.clip(sy, 0, h - 1)
    sy1 = np.clip(sy + 1, 0, h - 1)
    wx0, wy0 = wt(1.0) - fx, wt(1.0) - fy
    extra = (1,) * (img.ndim - 2)
    if u8:
        # one-tap columns at the right edge (fx = 0) weigh S[sx] by 2048
        taps = [np.ascontiguousarray(t, np.int64) for t in (
            sx, sx1, np.rint(wx0 * 2048), np.rint(fx * 2048),
            sy0, sy1, np.rint(wy0 * 2048), np.rint(fy * 2048))]
        src = np.ascontiguousarray(img)
        out = np.empty((out_h, out_w) + img.shape[2:], np.uint8)
        native.image_lib().resize_u8(
            src.ctypes.data, h, w, int(np.prod(img.shape[2:])),
            *[t.ctypes.data for t in taps[:4]], out_w,
            *[t.ctypes.data for t in taps[4:]], out_h, out.ctypes.data)
        return out
    x = img.astype(np.float64)
    rows = (x[:, sx] * wx0.reshape(1, -1, *extra)
            + x[:, sx1] * fx.reshape(1, -1, *extra))
    rows[:, hi] = x[:, sx[hi]]
    by0, by1 = wy0.reshape(-1, 1, *extra), fy.reshape(-1, 1, *extra)
    return (rows[sy0] * by0 + rows[sy1] * by1).astype(img.dtype)


def _clamped_taps(n_in, n_out):
    """float64 taps with OpenCV's edge clamping -> (index, index + 1
    clamped, float32 fraction)."""
    s, f = _linear_taps(n_in, n_out, np.float64)
    f[s < 0], s[s < 0] = 0.0, 0
    hi = s >= n_in - 1
    f[hi], s[hi] = 0.0, n_in - 1
    return s, np.minimum(s + 1, n_in - 1), f.astype(np.float32)


def _lerp(a, b, f):
    """a + (b - a) * f for float32 a, b, f as a fused multiply-add: the
    product is exact in float64, the sum is rounded to float32 from
    float64."""
    return ((b - a).astype(np.float64) * f + a).astype(np.float32)


def _resize_linear_f32(img, out_w, out_h):
    h, w = img.shape[:2]
    extra = (1,) * (img.ndim - 2)
    sx0, sx1, fx = _clamped_taps(w, out_w)
    sy0, sy1, fy = _clamped_taps(h, out_h)
    rows = _lerp(img[:, sx0], img[:, sx1], fx.reshape(1, -1, *extra))
    return _lerp(rows[sy0], rows[sy1], fy.reshape(-1, 1, *extra))


def compose_rgbm3(obj_mask, person_mask, rgb):
    """5-channel net input: background-removed RGB + person + object masks.
    All inputs in [0, 1]; returns (H, W, 5) channels-last."""
    comb = (person_mask > 0.5) | (obj_mask > 0.5)
    rgb = rgb * comb[..., None]
    return np.dstack([rgb, person_mask, obj_mask]).astype(np.float32)


def compose_rgbm3_u8(obj_mask, person_mask, rgb):
    """uint8 variant of ``compose_rgbm3``: the same k/255 values shipped as
    ``k`` (``CHOREField.encode`` scales integer images by 1/255); threshold
    127 is the float path's ``> 0.5``."""
    comb = (person_mask > 127) | (obj_mask > 127)
    rgb = rgb * comb[..., None].astype(np.uint8)
    return np.dstack([rgb, person_mask, obj_mask]).astype(np.uint8)
