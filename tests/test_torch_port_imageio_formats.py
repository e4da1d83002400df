"""The port's image readers on the formats beyond baseline JPEG and 8-bit
PNG, each bitwise against the library call it stands for:
``read_rgb`` against ``np.array(PIL.Image.open(f))`` (dtype and shape
too), ``read_gray`` against ``cv2.imread(f, cv2.IMREAD_GRAYSCALE)``,
``read_bgr`` against ``cv2.imread(f)``. Files are written here: EXIF
orientations 1-8 in JPEG APP1 and PNG eXIf (PIL), progressive JPEGs (PIL:
qualities 50/75/95, 4:4:4/4:2:2/4:2:0, gray, with and without restart
markers), 4:1:1 and other sampling factors (cv2), and PNGs of every colour
type and bit depth, Adam7-interlaced or not, with and without tRNS, every
row filter (a small writer here: PIL and cv2 write few of them). The JPEG
kinds that stay refused raise ``ValueError``."""
import itertools
import struct
import zlib

import numpy as np
import pytest


def _exif(orientation):
    from PIL import Image

    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def _pixels(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _like_cv2_and_pil(path, readers=("rgb", "gray", "bgr")):
    import cv2
    from PIL import Image

    from chore_tpu_torch.data.imageio import read_bgr, read_gray, read_rgb

    if "rgb" in readers:
        got, want = read_rgb(path), np.array(Image.open(path))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if "gray" in readers:
        np.testing.assert_array_equal(
            read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    if "bgr" in readers:
        got = read_bgr(path)
        assert got.dtype == np.uint8 and got.shape[2] == 3
        np.testing.assert_array_equal(got, cv2.imread(path))


@pytest.mark.parametrize("orientation,ext", list(itertools.product(
    range(1, 9), ["jpg", "png"])))
def test_exif_orientation_gray(tmp_path, orientation, ext):
    """``read_gray`` rotates as cv2 does (orientations 5-8 swap the axes of
    a 20 x 30 image); ``read_rgb`` stays unrotated, as PIL does."""
    import cv2
    from PIL import Image

    from chore_tpu_torch.data.imageio import read_gray, read_rgb

    a = _pixels((20, 30, 3), orientation)
    path = str(tmp_path / f"o.{ext}")
    Image.fromarray(a).save(path, exif=_exif(orientation))
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert want.shape == ((30, 20) if orientation >= 5 else (20, 30))
    np.testing.assert_array_equal(read_gray(path), want)
    np.testing.assert_array_equal(read_rgb(path), np.array(Image.open(path)))


@pytest.mark.parametrize("orientation,ext", list(itertools.product(
    range(1, 9), ["jpg", "png"])))
def test_exif_orientation_colour(tmp_path, orientation, ext):
    from PIL import Image

    a = _pixels((20, 30, 3), orientation + 10)
    path = str(tmp_path / f"o.{ext}")
    Image.fromarray(a).save(path, exif=_exif(orientation))
    _like_cv2_and_pil(path)


@pytest.mark.parametrize("quality,subsampling,size,restart", list(
    itertools.product([50, 75, 95], [0, 1, 2], [(1, 1), (16, 17), (53, 37)],
                      [0, 2])))
def test_progressive_jpeg(tmp_path, quality, subsampling, size, restart):
    """PIL's progressive script: DC first and refinement scans over all
    components, AC spectral bands per component with successive
    approximation, EOB runs."""
    from PIL import Image

    path = str(tmp_path / "p.jpg")
    kw = dict(quality=quality, subsampling=subsampling, progressive=True)
    if restart:
        kw["restart_marker_blocks"] = restart
    for smooth in (False, True):
        a = _pixels(size + (3,), quality + subsampling)
        if smooth:
            a = np.sort(a, axis=1)
        Image.fromarray(a).save(path, **kw)
        _like_cv2_and_pil(path)


@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_gray_jpeg(tmp_path, quality):
    from PIL import Image

    path = str(tmp_path / "pg.jpg")
    Image.fromarray(_pixels((37, 53), quality)).save(
        path, quality=quality, progressive=True)
    _like_cv2_and_pil(path)


@pytest.mark.parametrize("sampling,size", list(itertools.product(
    [0x411111, 0x221111, 0x121111, 0x111111], [(1, 1), (16, 17), (53, 77),
                                                (3, 70)])))
def test_jpeg_sampling_factors(tmp_path, sampling, size):
    """4:1:1 (Y 4x1: libjpeg's replicating int_upsample) beside 4:2:0,
    4:4:0 and 4:4:4, from cv2's writer."""
    import cv2

    path = str(tmp_path / "s.jpg")
    cv2.imwrite(path, _pixels(size + (3,), sampling % 97),
                [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    with open(path, "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == (sampling >> 16)  # Y's h/v byte as asked
    _like_cv2_and_pil(path)


@pytest.mark.parametrize("sof,kind", [(0xC3, "lossless"),
                                      (0xC5, "hierarchical"),
                                      (0xC9, "arithmetic-coded")])
def test_refused_jpeg_kinds_raise(tmp_path, sof, kind):
    """Lossless, hierarchical and arithmetic-coded files (no writer here
    makes one: the frame marker of a baseline file is rewritten)."""
    from PIL import Image

    from chore_tpu_torch.data.imageio import read_bgr, read_gray, read_rgb

    path = tmp_path / "k.jpg"
    Image.fromarray(_pixels((16, 16, 3), 0)).save(str(path))
    data = bytearray(path.read_bytes())
    data[data.index(b"\xff\xc0") + 1] = sof
    path.write_bytes(bytes(data))
    for reader in (read_rgb, read_gray, read_bgr):
        with pytest.raises(ValueError, match=kind):
            reader(str(path))


@pytest.mark.parametrize("case", ["missing", "empty", "text", "directory"])
def test_read_bgr_or_none_is_none_where_cv2_is(tmp_path, case):
    """None where ``cv2.imread`` gives None: no file, or no image."""
    import cv2

    from chore_tpu_torch.data.imageio import read_bgr_or_none

    path = tmp_path / "x.jpg"
    if case == "empty":
        path.write_bytes(b"")
    elif case == "text":
        path.write_text("no image\n")
    elif case == "directory":
        path.mkdir()
    assert cv2.imread(str(path)) is None
    assert read_bgr_or_none(str(path)) is None


@pytest.mark.parametrize("ext,kind", [("bmp", "BMP"), ("tiff", "TIFF"),
                                      ("webp", "WebP"), ("ppm", "PNM"),
                                      ("ras", "Sun raster")])
def test_read_bgr_or_none_raises_on_formats_cv2_reads(tmp_path, ext, kind):
    """A format that cv2 reads and the port does not raises, where a None
    would silently drop the overlay or the texture."""
    import cv2

    from chore_tpu_torch.data.imageio import read_bgr_or_none

    path = str(tmp_path / f"x.{ext}")
    assert cv2.imwrite(path, _pixels((12, 10, 3), 1))
    assert cv2.imread(path) is not None
    with pytest.raises(ValueError, match=kind):
        read_bgr_or_none(path)


@pytest.mark.parametrize("fault,match", [
    ("arithmetic", "arithmetic-coded"), ("12-bit", "12"),
    ("entropy cut", "past the end of the file"),
    ("header cut", "corrupt or truncated")])
def test_read_bgr_or_none_raises_on_refused_or_corrupt_jpeg(tmp_path, fault,
                                                            match):
    """A JPEG kind the port refuses, and a file cut short (in its
    entropy-coded data, where cv2 still gives an image, or in its
    headers), raise ``ValueError`` rather than give None."""
    from PIL import Image

    from chore_tpu_torch.data.imageio import read_bgr_or_none

    path = tmp_path / "k.jpg"
    Image.fromarray(_pixels((64, 64, 3), 2)).save(str(path))
    data = bytearray(path.read_bytes())
    sof = data.index(b"\xff\xc0")
    if fault == "arithmetic":
        data[sof + 1] = 0xC9
    elif fault == "12-bit":
        data[sof + 4] = 12
    elif fault == "entropy cut":
        data = data[:data.index(b"\xff\xda") + 200]
    else:
        data = data[:data.index(b"\xff\xc4") + 12]
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match):
        read_bgr_or_none(str(path))


# --------------------------------------------------------------------- #
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _row_bytes(vals, depth):
    """(h, w, c) sample values -> per-row packed bytes, big-endian."""
    h = vals.shape[0]
    flat = vals.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in flat]
    per = 8 // depth
    rows = []
    for r in flat:
        r = np.concatenate([r, np.zeros(-len(r) % per, np.int64)])
        r = r.reshape(-1, per) << (8 - depth * (1 + np.arange(per)))
        rows.append(r.sum(1).astype(np.uint8).tobytes())
    return rows


def _filtered(rows, bpp, rng):
    """Each row with a random filter type 0-4."""
    out, prev = [], None
    for row in rows:
        cur = np.frombuffer(row, np.uint8).astype(np.int64)
        up = np.zeros_like(cur) if prev is None else prev
        f = rng.randint(0, 5)
        res = np.empty_like(cur)
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            c = up[i - bpp] if i >= bpp else 0
            b = up[i]
            if f == 4:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[f]
            res[i] = (cur[i] - pred) & 255
        out.append(bytes([f]) + res.astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _write_png(path, vals, depth, ctype, plte=None, trns=None,
               interlace=0, seed=0):
    rng = np.random.RandomState(seed)
    h, w, c = vals.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        raw = b"".join(_filtered(_row_bytes(vals[y0::dy, x0::dx], depth),
                                 bpp, rng)
                       for x0, y0, dx, dy in _ADAM7
                       if vals[y0::dy, x0::dx].size)
    else:
        raw = _filtered(_row_bytes(vals, depth), bpp, rng)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += chunk(b"PLTE", plte)
    if trns is not None:
        data += chunk(b"tRNS", trns)
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


PNG_KINDS = [(d, t) for t, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                  (3, (1, 2, 4, 8)), (4, (8, 16)),
                                  (6, (8, 16))) for d in ds]
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("depth,ctype,interlace", [
    (d, t, i) for (d, t) in PNG_KINDS for i in (0, 1)])
def test_png_kinds(tmp_path, depth, ctype, interlace):
    """Palette (PIL: the indices; cv2: the colours), gray at 1/2/4/16 bits
    (PIL: bool, scaled "L", "I;16"), 16-bit colour (PIL and cv2: the high
    byte; cv2's gray through libpng's 16-bit rgb_to_gray), gray+alpha at 16
    bits (PIL: RGBA); odd sizes, with and without tRNS."""
    rng = np.random.RandomState(depth * 10 + ctype)
    path = str(tmp_path / "x.png")
    for size, with_trns in itertools.product([(1, 1), (5, 3), (13, 11),
                                              (17, 30)], (False, True)):
        n_pal = min(1 << depth, 7)
        high = n_pal if ctype == 3 else 1 << depth
        vals = rng.randint(0, high, size + (_CHANNELS[ctype],))
        plte = trns = None
        if ctype == 3:
            plte = rng.randint(0, 256, 3 * n_pal).astype(np.uint8).tobytes()
        if with_trns:
            if ctype == 3:
                trns = rng.randint(0, 256, n_pal).astype(np.uint8).tobytes()
            elif ctype in (0, 2):
                trns = struct.pack(">" + "H" * vals.shape[2],
                                   *(int(x) for x in vals[0, 0]))
        _write_png(path, vals, depth, ctype, plte, trns, interlace,
                   seed=size[0])
        _like_cv2_and_pil(path)
