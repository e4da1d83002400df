"""The port's image preparation (numpy, no cv2) against ``chore_tpu``'s
(cv2): ``resize`` against ``cv2.resize`` (INTER_LINEAR), bitwise on uint8
and within 1e-9 relative on float64, at down, up and exact-2x scales;
``crop`` and ``masks2bbox`` against ``chore_tpu.data.image_ops``; and
``TestImagePrep.prepare`` on the committed example frame, bitwise in
BEHAVE mode and within 1e-6 with ``use_mean_center`` (its float64 path)."""
import os

import numpy as np
import pytest

from chore_tpu_torch.data import image_ops as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "chore_tpu_torch", "assets", "example_synth",
                       "frame0000", "k1.color.jpg")

# (source h, w) -> (target h, w): the prep's crops (1,200 / 1,000 / 1,536 /
# 777 px -> 512), an exact 2x downscale (OpenCV's area path), upscales,
# tiny and odd sizes, a one-column change and the identity
RESIZES = [((1200, 1200), (512, 512)), ((1000, 1000), (512, 512)),
           ((1536, 1536), (512, 512)), ((777, 777), (512, 512)),
           ((1024, 1024), (512, 512)), ((64, 48), (32, 24)),
           ((100, 80), (237, 190)), ((37, 53), (106, 74)),
           ((5, 5), (512, 512)), ((7, 9), (3, 4)), ((513, 513), (512, 512)),
           ((300, 200), (300, 199)), ((30, 20), (30, 20))]


@pytest.fixture(scope="module")
def example_rgb():
    from chore_tpu_torch.data.imageio import read_rgb

    return read_rgb(EXAMPLE)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_like_cv2(example_rgb, src, dst):
    import cv2

    h, w = src
    rng = np.random.RandomState(h * w)
    for img in (example_rgb[500:500 + h, 700:700 + w],
                rng.randint(0, 256, (h, w)).astype(np.uint8)):
        img = np.ascontiguousarray(img)
        size = (dst[1], dst[0])
        np.testing.assert_array_equal(tops.resize_linear(img, size),
                                      cv2.resize(img, size))
        f = img.astype(np.float64) * 1.37
        got, want = tops.resize_linear(f, size), cv2.resize(f, size)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


def test_resize_checks_aspect():
    with pytest.raises(ValueError, match="aspect"):
        tops.resize(np.zeros((10, 20), np.uint8), (10, 10))


@pytest.mark.parametrize("center,size", [((40.0, 30.0), 50), ((2.0, 3.0), 41),
                                         ((70.0, 55.0), 64), ((30.5, 20.5), 7)])
def test_crop_like_jax(center, size):
    from chore_tpu.data import image_ops as jops

    img = np.random.RandomState(0).randint(0, 256, (60, 80, 3)).astype(
        np.uint8)
    for a in (img, img[..., 0], img.astype(np.float64) / 3):
        got, want = tops.crop(a, center, size), jops.crop(a, center, size)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["two_blobs", "touching_edges", "one_pixel",
                                  "empty", "below_threshold", "example"])
def test_masks2bbox_like_jax(kind):
    from chore_tpu.data import image_ops as jops

    a = np.zeros((90, 120), np.uint8)
    b = np.zeros_like(a)
    if kind == "two_blobs":
        a[10:30, 20:45] = 255
        b[50:70, 60:100] = 200
        b[52, 61] = 100
    elif kind == "touching_edges":
        a[0:5, 0:7] = 255
        b[80:, 110:] = 255
    elif kind == "one_pixel":
        a[40, 40] = 128
    elif kind == "below_threshold":
        a[10:20, 10:20] = 60
        b[10:20, 10:20] = 60
    elif kind == "example":
        a, b = tops.load_masks(EXAMPLE)
    for got, want in zip(tops.masks2bbox([a, b]), jops.masks2bbox([a, b])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mean_center", [False, True])
def test_prepare_like_jax(tmp_path, mean_center):
    from chore_tpu.data.test_data import TestImagePrep as JPrep
    from chore_tpu_torch.data.test_data import TestImagePrep as TPrep

    dj, dt = tmp_path / "j", tmp_path / "t"
    dj.mkdir()
    dt.mkdir()
    want = JPrep(use_mean_center=mean_center, crop_info_dir=str(dj)).prepare(
        EXAMPLE)
    got = TPrep(use_mean_center=mean_center, crop_info_dir=str(dt)).prepare(
        EXAMPLE)
    assert set(got) == set(want)
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj)) == [
        "k1.crop_info.pkl"]
    for k in ("images", "kpts", "crop_center", "old_crop_center",
              "resize_scale", "crop_scale", "mocap_pose", "mocap_betas"):
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        if mean_center:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in want["crop_info"].items():
        if mean_center:
            np.testing.assert_allclose(got["crop_info"][k], v, atol=1e-6)
        else:
            np.testing.assert_array_equal(got["crop_info"][k], v)
    assert got["images"].shape == (512, 512, 5)


def test_compose_like_jax():
    """Both RGBM3 compositions, float and uint8, on the example's crops."""
    from chore_tpu.data import image_ops as jops

    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    pm = (rng.rand(32, 32) > 0.6).astype(np.uint8) * 255
    om = (rng.rand(32, 32) > 0.7).astype(np.uint8) * 200
    got = tops.compose_rgbm3(om / 255.0, pm / 255.0, rgb / 255.0)
    np.testing.assert_array_equal(
        got, jops.compose_rgbm3(om / 255.0, pm / 255.0, rgb / 255.0))
    got = tops.compose_rgbm3_u8(om, pm, rgb)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jops.compose_rgbm3_u8(om, pm, rgb))
