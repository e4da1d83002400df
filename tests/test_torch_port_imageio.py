"""The port's image decoder (``data/imageio.py``, numpy + zlib) against
what ``chore_tpu`` reads with: ``read_rgb`` against
``np.array(PIL.Image.open(f))`` and ``read_gray`` against
``cv2.imread(f, cv2.IMREAD_GRAYSCALE)``, bitwise, on the committed example
frame and on JPEGs and PNGs written here (baseline JPEG at quality 75 and
95 in 4:4:4, 4:2:2, 4:2:0, 4:4:0 and grayscale, with restart intervals, at
odd sizes; PNG gray, gray+alpha, RGB and RGBA). No case needed a 1-LSB
allowance."""
import itertools
import os

import numpy as np
import pytest

from chore_tpu_torch.data.imageio import read_gray, read_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "chore_tpu_torch", "assets", "example_synth",
                       "frame0000")
SIZES = [(1, 1), (16, 17), (53, 37)]


def _pixels(h, w, c, smooth, seed):
    rng = np.random.RandomState(seed)
    if smooth:
        yy, xx = np.mgrid[:h, :w]
        a = np.stack([(xx * 255.0 / max(w - 1, 1) + 30 * np.sin(yy / 3.0 + k))
                      % 256 for k in range(c)], -1)
    else:
        a = rng.randint(0, 256, (h, w, c))
    a = a.astype(np.uint8)
    return a[..., 0] if c == 1 else a


def _assert_like_pil_and_cv2(path):
    import cv2
    from PIL import Image

    rgb, ref = read_rgb(path), np.array(Image.open(path))
    assert rgb.dtype == ref.dtype and rgb.shape == ref.shape
    np.testing.assert_array_equal(rgb, ref)
    gray = read_gray(path)
    np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("name", ["k1.color.jpg", "k1.person_mask.jpg",
                                  "k1.obj_rend_mask.jpg"])
def test_committed_example(name):
    _assert_like_pil_and_cv2(os.path.join(EXAMPLE, name))


JPEG_CASES = {  # name -> (writer, channels, writer options)
    "444": ("pil", 3, dict(subsampling=0)),
    "422": ("pil", 3, dict(subsampling=1)),
    "420": ("pil", 3, dict(subsampling=2)),
    "gray": ("pil", 1, {}),
    "420_restart": ("pil", 3, dict(subsampling=2, restart_marker_blocks=3)),
    "440": ("cv2", 3, dict(sampling=0x121111)),
    "gray_restart": ("cv2", 1, dict(rst=1)),
}


@pytest.mark.parametrize("case,quality,size", list(itertools.product(
    sorted(JPEG_CASES), [75, 95], SIZES)))
def test_generated_jpeg(tmp_path, case, quality, size):
    import cv2
    from PIL import Image

    writer, c, opts = JPEG_CASES[case]
    for smooth in (False, True):
        a = _pixels(*size, c, smooth, seed=quality)
        path = str(tmp_path / f"{case}_{smooth}.jpg")
        if writer == "pil":
            Image.fromarray(a).save(path, quality=quality, **opts)
        else:
            params = [cv2.IMWRITE_JPEG_QUALITY, quality]
            if "rst" in opts:
                params += [cv2.IMWRITE_JPEG_RST_INTERVAL, opts["rst"]]
            if "sampling" in opts:
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, opts["sampling"]]
            cv2.imwrite(path, a if c == 1 else a[..., ::-1], params)
        _assert_like_pil_and_cv2(path)


@pytest.mark.parametrize("mode,size", list(itertools.product(
    ["L", "LA", "RGB", "RGBA"], SIZES + [(40, 64)])))
def test_generated_png(tmp_path, mode, size):
    """PIL's and OpenCV's writers (OpenCV cannot write gray+alpha)."""
    import cv2
    from PIL import Image

    c = len(mode)
    for smooth in (False, True):
        a = _pixels(*size, c, smooth, seed=c)
        path = str(tmp_path / f"pil_{smooth}.png")
        Image.fromarray(a).save(path)
        _assert_like_pil_and_cv2(path)
        if c != 2:
            path = str(tmp_path / f"cv2_{smooth}.png")
            cv2.imwrite(path, a if c == 1 else a[..., [2, 1, 0, 3][:c]])
            _assert_like_pil_and_cv2(path)


def test_unsupported_files_raise(tmp_path):
    """What stays refused: 12-bit, lossless, hierarchical and
    arithmetic-coded JPEGs (a baseline file with its frame header
    rewritten: nothing here writes them), and files that are neither JPEG
    nor PNG. Progressive JPEGs, interlaced and palette PNGs now decode
    (``test_torch_port_imageio_formats.py``)."""
    from PIL import Image

    a = _pixels(20, 20, 3, False, seed=0)
    base = tmp_path / "base.jpg"
    Image.fromarray(a).save(str(base))
    data = base.read_bytes()
    sof = data.index(b"\xff\xc0")
    for k, (patch, why) in enumerate([
            ({sof + 4: 12}, "12-bit"), ({sof + 1: 0xC3}, "lossless"),
            ({sof + 1: 0xC7}, "hierarchical"),
            ({sof + 1: 0xC9}, "arithmetic-coded")]):
        bad = bytearray(data)
        for at, value in patch.items():
            bad[at] = value
        path = tmp_path / f"bad{k}.jpg"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=why):
            read_rgb(str(path))
        with pytest.raises(ValueError, match=why):
            read_gray(str(path))
    other = tmp_path / "x.jpg"
    other.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        read_rgb(str(other))


def test_kinect_size_jpeg_decoded_by_threads_at_once(tmp_path):
    """A 2048 x 1536 4:2:0 colour JPEG (a Kinect frame's size), decoded by
    four threads at once (the training loader's workers; the native
    Huffman decode releases the GIL), equals cv2's and PIL's, bitwise."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    path = str(tmp_path / "k.jpg")
    a = _pixels(1536, 2048, 3, True, 0)
    noise = np.random.RandomState(1).randint(0, 8, a.shape)
    assert cv2.imwrite(path, (a + noise).astype(np.uint8))
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: read_rgb(path), range(4)))
    for rgb in outs:
        np.testing.assert_array_equal(rgb, outs[0])
    _assert_like_pil_and_cv2(path)
    np.testing.assert_array_equal(outs[0], read_rgb(path))


def test_entropy_data_cut_before_eoi_raises(tmp_path):
    """Entropy-coded data cut short and closed by an EOI marker: the scan
    runs out of bits before its last block, which raises ``ValueError``."""
    import cv2

    path = str(tmp_path / "k.jpg")
    assert cv2.imwrite(path, _pixels(64, 64, 3, False, 3))
    data = open(path, "rb").read()
    cut = data[:data.index(b"\xff\xda") + 300] + b"\xff\xd9"
    with open(path, "wb") as f:
        f.write(cut)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        read_rgb(path)

