"""The port's image writers (``data/imageio.py``: ``encode_jpeg``,
``encode_png``, ``imwrite``) against what ``chore_tpu`` writes with,
``cv2.imwrite``/``cv2.imencode`` at their defaults.

JPEG: random and smooth images, odd sizes, colour and gray. The port's
file and OpenCV's are byte for byte equal (so PIL decodes both to the same
pixels, which is asserted too). PNG: decoded by cv2 and by the port to the
written pixels (gray, BGR)."""
import itertools
import os

import numpy as np
import pytest

from chore_tpu_torch.data.imageio import (
    encode_jpeg,
    encode_png,
    imwrite,
    read_bgr,
    read_rgb,
)

SIZES = [(1, 1), (8, 8), (9, 17), (16, 16), (37, 53), (64, 80)]
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chore_tpu_torch", "assets", "example_synth", "frame0000")


def _image(size, channels, smooth, seed):
    rng = np.random.RandomState(seed)
    if smooth:
        yy, xx = np.mgrid[:size[0], :size[1]]
        a = np.stack([(xx * 7 + yy * (3 + k) + 40 * np.sin(yy / 5.0 + k))
                      % 256 for k in range(channels)], -1)
    else:
        a = rng.randint(0, 256, size + (channels,))
    a = a.astype(np.uint8)
    return a[..., 0] if channels == 1 else a


@pytest.mark.parametrize("size,channels,smooth", list(itertools.product(
    SIZES, [1, 3], [False, True])))
def test_jpeg_equals_cv2(tmp_path, size, channels, smooth):
    import cv2
    from PIL import Image

    img = _image(size, channels, smooth, seed=size[0] + channels)
    ok, ref = cv2.imencode(".jpg", img)
    assert ok
    mine = encode_jpeg(img)
    assert mine == ref.tobytes()
    a, b = tmp_path / "port.jpg", tmp_path / "cv2.jpg"
    a.write_bytes(mine)
    b.write_bytes(ref.tobytes())
    np.testing.assert_array_equal(np.array(Image.open(a)),
                                  np.array(Image.open(b)))


def test_jpeg_overlay_size(tmp_path):
    """The demo's overlay: a 2,048 x 1,536 photo-like image (the committed
    example frame) through ``imwrite``."""
    import cv2

    photo = read_bgr(os.path.join(EXAMPLE, "k1.color.jpg"))
    imwrite(str(tmp_path / "o.jpg"), photo)
    ok, ref = cv2.imencode(".jpg", photo)
    assert (tmp_path / "o.jpg").read_bytes() == ref.tobytes()


@pytest.mark.parametrize("size,channels", list(itertools.product(
    SIZES, [1, 3])))
def test_png_round_trip(tmp_path, size, channels):
    import cv2

    img = _image(size, channels, False, seed=channels)
    path = str(tmp_path / "x.png")
    imwrite(path, img)
    with open(path, "rb") as f:
        assert f.read() == encode_png(img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img)
    if channels == 1:
        np.testing.assert_array_equal(read_rgb(path), img)
    else:
        np.testing.assert_array_equal(read_bgr(path), img)


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8),
    np.zeros((0, 4, 3), np.uint8), np.zeros((4,), np.uint8)])
def test_refuses_what_it_cannot_write(tmp_path, bad):
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / "x.jpg"), bad)
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / "x.png"), bad)


def test_refuses_other_extensions(tmp_path):
    with pytest.raises(ValueError, match="only .jpg"):
        imwrite(str(tmp_path / "x.bmp"), np.zeros((4, 4, 3), np.uint8))
    for enc in (encode_jpeg, encode_png):
        with pytest.raises(ValueError):
            enc(np.zeros((4, 4, 4), np.uint8))
