"""Image file decoding and encoding in numpy: the port's counterpart of the
``PIL.Image.open`` / ``cv2.imread`` / ``cv2.imwrite`` calls of
``chore_tpu`` (neither library is installed where the port runs).

Readers, each standing for one library call (the format comes from the
file's magic bytes, not its extension):

* ``read_rgb``: ``np.array(PIL.Image.open(path))``. PIL does not apply the
  EXIF Orientation tag, so neither does this reader.
* ``read_depth``: ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` (16-bit PNG
  depth maps as uint16).
* ``read_gray``: ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, and
  ``read_bgr``: ``cv2.imread(path)`` (IMREAD_COLOR). OpenCV rotates and
  flips the pixels by the EXIF Orientation tag (1-8) of a JPEG's APP1
  segment or a PNG's ``eXIf`` chunk, and so do these.

Formats:

* JPEG: baseline, extended sequential and progressive Huffman (SOF0, SOF1,
  SOF2: spectral selection and successive approximation, restart
  intervals, EOB runs), 8-bit, 1 or 3 components with sampling factors up
  to 4. Decoded as libjpeg(-turbo) decodes it by default, so the result is
  bitwise equal: coefficients gathered over all scans, then the integer
  ISLOW IDCT of ``jidctint.c``, the "fancy" triangle-filter upsampling of
  ``jdsample.c`` for 2:1 ratios and its replicating ``int_upsample`` for
  the others, and the fixed-point YCbCr->RGB tables of ``jdcolor.c``.
  Lossless, hierarchical, arithmetic-coded and 12-bit files raise
  ``ValueError``.
* PNG: every colour type (gray, RGB, palette, gray+alpha, RGBA) at every
  bit depth the format allows (1, 2, 4, 8, 16), Adam7 interlaced or not,
  every filter type. ``read_rgb`` gives PIL's modes: palette indices for
  "P", a bool array for 1-bit gray, gray scaled to 8 bits for 2/4-bit,
  uint16 for 16-bit gray, the high byte of 16-bit RGB/RGBA, and 16-bit
  gray+alpha as RGBA. The cv2 readers give libpng's 8-bit output as
  OpenCV configures it: palette expanded to colours, sub-8-bit gray scaled,
  16-bit samples stripped to their high byte, alpha dropped, colour to gray
  by libpng's rgb_to_gray (0.299, 0.587 as 9797 and 19234 of 2^15, blue the
  rest: truncated at 8 bits, rounded at 16). ``tRNS`` changes no pixel of
  any reader.

Writers (``imwrite``, standing for ``cv2.imwrite`` on a BGR or gray uint8
image): baseline JPEG as libjpeg-turbo writes it at OpenCV's defaults
(quality 95, 4:2:0, standard Huffman tables, JFIF), and PNG (also of a
uint16 image, 16-bit samples).

A sequential scan's Huffman decode, the IDCT, the upsampling and the
colour conversion run in ``csrc/image.cpp`` (``native.image_lib``, built
with g++ on first use; a call releases the GIL, so loader threads decode
at once); a progressive scan's Huffman decode is a Python loop over
the coded symbols. The rest, the JPEG encoder's entropy stage included, is
vectorised numpy.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from chore_tpu_torch import native

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def read_rgb(path):
    """What ``np.array(PIL.Image.open(path))`` gives, unrotated: (H, W, 3)
    uint8 for a colour JPEG or RGB PNG, (H, W) for gray (bool at 1 bit,
    uint16 for a 16-bit PNG, palette indices for a palette PNG), (H, W, 2)
    gray+alpha, (H, W, 4) RGBA."""
    data = _read(path)
    if data.startswith(JPEG_MAGIC):
        return _Jpeg(data, path).decode(gray=False)
    return _Png(data, path).pil()


def read_gray(path):
    """What ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives, (H, W) uint8,
    EXIF orientation applied: for a JPEG libjpeg's Y plane (cv2 asks
    libjpeg for grayscale output, so no chroma is upsampled or converted);
    for a PNG libpng's 8-bit gray (see the module docstring)."""
    data = _read(path)
    if data.startswith(JPEG_MAGIC):
        jpg = _Jpeg(data, path)
        return _orient(jpg.decode(gray=True), jpg.orientation)
    png = _Png(data, path)
    return _orient(png.cv2(color=False), png.orientation)


def read_depth(path):
    """What ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` gives, (H, W), EXIF
    orientation applied: a 16-bit PNG keeps its 16-bit samples as uint16
    (colour through libpng's rgb_to_gray at 16 bits, rounded); any other
    file reads as ``read_gray`` does (uint8)."""
    data = _read(path)
    if data.startswith(JPEG_MAGIC):
        return read_gray(path)
    png = _Png(data, path)
    if png.depth != 16:
        return _orient(png.cv2(color=False), png.orientation)
    s = png.samples.astype(np.int64)
    if png.ctype in (0, 4):
        g = s[..., 0]
    else:
        r, gg, b = s[..., 0], s[..., 1], s[..., 2]
        mixed = (9797 * r + 19234 * gg + 3737 * b + 16384) >> 15
        g = np.where((r != gg) | (r != b), mixed, r)
    return _orient(g.astype(np.uint16), png.orientation)


def read_bgr(path):
    """What ``cv2.imread(path)`` (IMREAD_COLOR) gives, (H, W, 3) uint8 in
    BGR order, EXIF orientation applied: gray files replicated to three
    channels, alpha dropped."""
    data = _read(path)
    if data.startswith(JPEG_MAGIC):
        jpg = _Jpeg(data, path)
        img = jpg.decode(gray=False)
        img = (np.repeat(img[..., None], 3, -1) if img.ndim == 2
               else img[..., ::-1])
        return _orient(np.ascontiguousarray(img), jpg.orientation)
    png = _Png(data, path)
    return _orient(png.cv2(color=True), png.orientation)


def read_bgr_or_none(path):
    """``read_bgr``, or None where ``cv2.imread`` returns None: the file is
    missing or unreadable, or it is in no format that OpenCV reads. A file
    that OpenCV reads and this module does not (another format, a JPEG
    kind it refuses) and a fault in the data raise ``ValueError``."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        return None
    if not head.startswith((JPEG_MAGIC, PNG_MAGIC)) and not _other_format(
            head):
        return None
    return read_bgr(path)


# leading bytes of the other formats that OpenCV's imread decodes
_OTHER_FORMATS = (
    (b"BM", "BMP"), (b"\x59\xa6\x6a\x95", "Sun raster"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "BigTIFF"),
    (b"MM\x00+", "BigTIFF"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"v/1\x01", "OpenEXR"),
    (b"#?RGBE", "Radiance HDR"), (b"#?RADIANCE", "Radiance HDR"),
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"))


def _other_format(head):
    """The name of the format other than JPEG and PNG that OpenCV would
    read from a file starting with ``head``, or None."""
    for magic, name in _OTHER_FORMATS:
        if head.startswith(magic):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:1] == b"P" and head[1:2] in b"1234567fF" and head[2:3].isspace():
        return "PNM/PFM"
    return None


def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(JPEG_MAGIC) or data.startswith(PNG_MAGIC)):
        other = _other_format(data[:16])
        raise ValueError(f"{path}: neither a JPEG nor a PNG file"
                         + (f" but {other}, which is not read" if other
                            else ""))
    return data


# --------------------------------------------------------------------- #
# EXIF orientation (OpenCV's ExifTransform)
def _exif_orientation(tiff):
    """The Orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF
    block, or 1 when there is none or it is out of range."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
    for k in range(n):
        at = ifd + 2 + 12 * k
        if at + 12 > len(tiff):
            break
        tag, kind = struct.unpack(e + "HH", tiff[at:at + 4])
        if tag == 0x0112 and kind == 3:
            value = struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def _orient(img, orientation):
    """Apply an EXIF orientation as OpenCV does: 2 flip left-right, 3 rotate
    180, 4 flip up-down, 5 transpose, 6 transpose then flip left-right
    (90 degrees clockwise), 7 transpose then flip both, 8 transpose then
    flip up-down."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


# --------------------------------------------------------------------- #
# JPEG decoding
# zig-zag position -> natural (row-major) index, with 16 extra entries so a
# corrupt run past the end lands on 63 (as jpeg_natural_order does)
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16
_NATURAL_I32 = np.asarray(_NATURAL, np.int32)

_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless",
}


# jpeg_decode_scan's error codes
_SCAN_ERRORS = {1: "missing restart marker",
                2: "corrupt or truncated entropy-coded data",
                3: "corrupt entropy-coded data (a coefficient out of range)"}


def _huffman_lut(counts, symbols):
    """16-bit lookahead tables (symbol, code length), int32, of a canonical
    Huffman table; a code that is not in the table decodes as symbol 0,
    length 16 (libjpeg's "bad Huffman code" recovery)."""
    sym = np.zeros(1 << 16, np.int32)
    length = np.full(1 << 16, 16, np.int32)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            lo = code << (16 - ln)
            hi = (code + 1) << (16 - ln)
            sym[lo:hi] = symbols[k]
            length[lo:hi] = ln
            code += 1
            k += 1
        code <<= 1
    return sym, length


def _bit_windows(stream):
    """56-bit big-endian windows at every byte offset of ``stream`` (zero
    bits past the end, as libjpeg inserts)."""
    b = np.frombuffer(stream + bytes(8), np.uint8).astype(np.int64)
    n = len(stream) + 1
    win = b[:n] << 48
    for k in range(1, 7):
        win |= b[k:n + k] << (48 - 8 * k)
    return win.tolist()


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


class _Jpeg:
    """One Huffman-coded JPEG file: markers and scans parsed on
    construction, pixels by ``decode``."""

    def __init__(self, data, path):
        self.data, self.path = data, path
        self.quant = {}
        self.dc_tables, self.ac_tables = {}, {}
        self.restart = 0
        self.adobe_transform = None
        self.orientation = 1
        self.progressive = False
        self.comps = None
        self.coef = None  # per component: (blocks_h, blocks_w, 64) int32
        try:
            self._parse()
        except (IndexError, struct.error):
            self._fail("corrupt or truncated JPEG")

    def _fail(self, what):
        raise ValueError(f"{self.path}: {what}")

    # -- markers -------------------------------------------------------- #
    def _parse(self):
        d, pos = self.data, 2
        exif_seen = False
        while True:
            while pos < len(d) and d[pos] == 0xFF and d[pos + 1] == 0xFF:
                pos += 1  # fill bytes
            if pos + 2 > len(d) or d[pos] != 0xFF:
                self._fail("truncated or corrupt JPEG marker stream")
            marker = d[pos + 1]
            if marker == 0xD9:  # EOI
                break
            if pos + 4 > len(d):
                self._fail("truncated JPEG marker segment")
            seg_len = struct.unpack(">H", d[pos + 2:pos + 4])[0]
            seg = d[pos + 4:pos + 2 + seg_len]
            pos += 2 + seg_len
            if marker in (0xC0, 0xC1, 0xC2):
                self.progressive = marker == 0xC2
                self._sof(seg)
            elif marker in _UNSUPPORTED_SOF:
                self._fail(f"{_UNSUPPORTED_SOF[marker]} JPEG (SOF{marker - 0xC0}) "
                           "is not supported; only sequential and progressive "
                           "Huffman files are")
            elif marker == 0xC4:
                self._dht(seg)
            elif marker == 0xDB:
                self._dqt(seg)
            elif marker == 0xDD:
                self.restart = struct.unpack(">H", seg[:2])[0]
            elif marker == 0xDA:
                pos = self._sos(seg, pos)
            elif marker == 0xDC:
                self._fail("DNL marker (height defined after the scan) is not "
                           "supported")
            elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00" \
                    and not exif_seen:
                exif_seen = True  # the first Exif APP1 counts
                self.orientation = _exif_orientation(seg[6:])
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                self.adobe_transform = seg[11]
        if self.comps is None or self.coef is None:
            self._fail("no frame or no scan")

    def _sof(self, seg):
        prec, h, w, n = struct.unpack(">BHHB", seg[:6])
        if prec != 8:
            self._fail(f"{prec}-bit JPEG is not supported (8-bit only)")
        if h == 0:
            self._fail("zero image height (DNL) is not supported")
        if n not in (1, 3):
            self._fail(f"{n}-component JPEG is not supported (1 or 3)")
        comps = []
        for k in range(n):
            cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4):
                self._fail(f"sampling factors {hs}x{vs} are not supported "
                           "(1 to 4)")
            comps.append(_Component(cid, hs, vs, tq))
        if n == 1:  # a single component is never subsampled
            comps[0].h = comps[0].v = 1
        self.height, self.width, self.comps = h, w, comps
        self.hmax = max(c.h for c in comps)
        self.vmax = max(c.v for c in comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        for c in comps:
            # real (non-padded) size of the component's plane
            c.width = -(-w * c.h // self.hmax)
            c.height = -(-h * c.v // self.vmax)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
        if self.progressive:  # coefficients gathered over the scans
            self.coef = [[0] * (c.bh * c.bw * 64) for c in comps]
        else:
            self.coef = [np.zeros((c.bh, c.bw, 64), np.int32) for c in comps]

    def _dht(self, seg):
        pos = 0
        while pos < len(seg):
            tc, th = seg[pos] >> 4, seg[pos] & 15
            counts = list(seg[pos + 1:pos + 17])
            total = sum(counts)
            symbols = list(seg[pos + 17:pos + 17 + total])
            pos += 17 + total
            (self.ac_tables if tc else self.dc_tables)[th] = _huffman_lut(
                counts, symbols)

    def _dqt(self, seg):
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            n = 128 if pq else 64
            vals = np.frombuffer(seg[pos + 1:pos + 1 + n],
                                 ">u2" if pq else np.uint8).astype(np.int64)
            table = np.zeros(64, np.int64)
            table[_NATURAL[:64]] = vals
            self.quant[tq] = table
            pos += 1 + n

    # -- entropy-coded data ---------------------------------------------- #
    def _sos(self, seg, pos):
        if self.comps is None:
            self._fail("scan before frame header")
        ns = seg[0]
        by_id = {c.id: k for k, c in enumerate(self.comps)}
        scan = []
        for k in range(ns):
            cid, t = seg[1 + 2 * k:3 + 2 * k]
            if cid not in by_id:
                self._fail(f"scan names unknown component {cid}")
            scan.append((by_id[cid], t >> 4, t & 15))
        ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
        ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
        if not self.progressive and (ss != 0 or se != 63):
            self._fail("spectral selection in a sequential scan")
        # the entropy-coded data runs to the next marker that is neither a
        # stuffed 0xFF00 nor a restart marker; restart markers split it into
        # intervals, each starting on a byte boundary
        d = self.data
        start = i = pos
        pieces, starts, total = [], [], 0
        while True:
            nxt = d.find(b"\xff", i)
            if nxt < 0:
                self._fail("entropy-coded data runs past the end of the file")
            j = nxt + 1
            while j < len(d) and d[j] == 0xFF:  # fill bytes before a marker
                j += 1
            if j >= len(d):
                self._fail("entropy-coded data runs past the end of the file")
            if d[j] == 0 and j == nxt + 1:  # stuffed 0xFF data byte
                i = j + 1
                continue
            piece = d[start:nxt].replace(b"\xff\x00", b"\xff")
            starts.append(total)
            pieces.append(piece)
            total += len(piece)
            if 0xD0 <= d[j] <= 0xD7:  # RSTn: the next interval
                start = i = j + 1
                continue
            break
        stream = b"".join(pieces)
        try:
            if self.progressive:
                self._decode_progressive(scan, ss, se, ah, al, stream, starts)
            else:
                self._decode_scan(scan, stream, starts)
        except IndexError:
            self._fail("corrupt or truncated entropy-coded data")
        return j - 1

    def _layout(self, scan):
        """Per MCU, its blocks as (slot in the scan, flat coefficient
        offset), a (MCUs, blocks per MCU, 2) int64 array: one block per MCU
        over a lone component's own (unpadded) block grid, else the
        interleaved MCUs of the frame."""
        comps = self.comps
        if len(scan) == 1:
            c = comps[scan[0][0]]
            nbw, nbh = -(-c.width // 8), -(-c.height // 8)
            base = (np.arange(nbh)[:, None] * c.bw
                    + np.arange(nbw)[None, :]).reshape(-1, 1) * 64
            return np.ascontiguousarray(
                np.stack([np.zeros_like(base), base], -1), np.int64)
        my = np.arange(self.mcuy)[:, None]
        mx = np.arange(self.mcux)[None, :]
        cols = []
        for slot, (ci, _, _) in enumerate(scan):
            c = comps[ci]
            for y in range(c.v):
                for x in range(c.h):
                    b = ((my * c.v + y) * c.bw + mx * c.h + x).reshape(-1)
                    cols.append(np.stack([np.full_like(b, slot), b * 64], -1))
        return np.ascontiguousarray(np.stack(cols, 1), np.int64)

    def _tables(self, scan, dc=True, ac=True):
        """Per scan slot: (DC symbols, DC lengths, AC symbols, AC lengths),
        each a 65536-entry int32 lookahead table (empty where not used)."""
        empty = np.zeros(0, np.int32)
        tables = []
        for _, td, ta in scan:
            if (dc and td not in self.dc_tables) or (
                    ac and ta not in self.ac_tables):
                self._fail("scan uses an undefined Huffman table")
            tables.append((self.dc_tables[td] if dc else (empty, empty))
                          + (self.ac_tables[ta] if ac else (empty, empty)))
        return tables

    def _decode_scan(self, scan, stream, starts):
        """Huffman-decode one sequential scan's blocks into ``self.coef``
        (``csrc/image.cpp``)."""
        if len(scan) > 4:
            self._fail(f"{len(scan)} components in one scan (at most 4)")
        layout = self._layout(scan)
        luts = np.ascontiguousarray(np.stack(
            [np.stack(t) for t in self._tables(scan)]), np.int32)
        data = np.frombuffer(stream + bytes(8), np.uint8)
        starts = np.asarray(starts, np.int64)
        coef = (ctypes.c_void_p * len(scan))(
            *[self.coef[ci].ctypes.data for ci, _, _ in scan])
        rc = native.image_lib().jpeg_decode_scan(
            data.ctypes.data, len(stream), starts.ctypes.data, len(starts),
            self.restart or len(layout), layout.shape[0], layout.shape[1],
            layout.ctypes.data, luts.ctypes.data, coef,
            _NATURAL_I32.ctypes.data)
        if rc:
            self._fail(_SCAN_ERRORS[rc])

    def _decode_progressive(self, scan, ss, se, ah, al, stream, starts):
        """One progressive scan (``jdphuff.c``): a DC first or refinement
        scan over one or more components, or an AC first or refinement
        scan of band [ss, se] of one component, with EOB runs; the
        coefficients accumulate in ``self.coef`` (point transform ``al``
        applied, dequantized only after the last scan)."""
        if se > 63 or ss > se or (ss == 0 and se != 0) or (
                ss > 0 and len(scan) != 1):
            self._fail(f"bad progressive scan parameters Ss={ss} Se={se}")
        layout = self._layout(scan).tolist()
        dc = ss == 0
        tables = [tuple(t.tolist() for t in ts) for ts in self._tables(
            scan, dc=dc and ah == 0, ac=not dc)]
        coefs = [self.coef[ci] for ci, _, _ in scan]
        w = _bit_windows(stream)
        nat = _NATURAL
        p1, m1 = 1 << al, -1 << al

        def bits(p, n):
            return (w[p >> 3] >> (56 - (p & 7) - n)) & ((1 << n) - 1)

        def extend(x, s):
            return x - (1 << s) + 1 if x < (1 << (s - 1)) else x

        interval = self.restart or len(layout)
        seg, p, eobrun = 0, 0, 0
        preds = [0] * len(scan)
        for m, mcu in enumerate(layout):
            if m % interval == 0:
                if seg >= len(starts):
                    self._fail("missing restart marker")
                p = 8 * starts[seg]
                seg += 1
                preds = [0] * len(scan)
                eobrun = 0
            for slot, base in mcu:
                cf = coefs[slot]
                if dc and ah == 0:  # DC first scan
                    dsym, dlen = tables[slot][0], tables[slot][1]
                    v = (w[p >> 3] >> (40 - (p & 7))) & 0xFFFF
                    s = dsym[v]
                    p += dlen[v]
                    if s:
                        x = extend(bits(p, s), s)
                        p += s
                        preds[slot] += x
                    cf[base] = preds[slot] << al
                elif dc:  # DC refinement: one bit
                    if bits(p, 1):
                        cf[base] |= p1
                    p += 1
                elif ah == 0:  # AC first scan
                    if eobrun:
                        eobrun -= 1
                        continue
                    asym, alen = tables[slot][2], tables[slot][3]
                    k = ss
                    while k <= se:
                        v = (w[p >> 3] >> (40 - (p & 7))) & 0xFFFF
                        rs = asym[v]
                        p += alen[v]
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            cf[base + nat[k]] = extend(bits(p, s), s) << al
                            p += s
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += bits(p, r)
                                p += r
                            eobrun -= 1
                            break
                        k += 1
                else:  # AC refinement
                    asym, alen = tables[slot][2], tables[slot][3]
                    k = ss
                    if not eobrun:
                        while k <= se:
                            v = (w[p >> 3] >> (40 - (p & 7))) & 0xFFFF
                            rs = asym[v]
                            p += alen[v]
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if bits(p, 1) else m1
                                p += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += bits(p, r)
                                    p += r
                                break
                            # correction bits of the nonzero coefficients
                            # passed over; stop at the r-th zero one
                            while k <= se:
                                at = base + nat[k]
                                if cf[at]:
                                    if bits(p, 1) and not cf[at] & p1:
                                        cf[at] += p1 if cf[at] >= 0 else m1
                                    p += 1
                                else:
                                    if r == 0:
                                        break
                                    r -= 1
                                k += 1
                            if s:
                                cf[base + nat[k]] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            at = base + nat[k]
                            if cf[at]:
                                if bits(p, 1) and not cf[at] & p1:
                                    cf[at] += p1 if cf[at] >= 0 else m1
                                p += 1
                            k += 1
                        eobrun -= 1

    # -- pixels ------------------------------------------------------------ #
    def decode(self, gray):
        if len(self.comps) == 3 and (self.adobe_transform == 0 or [
                c.id for c in self.comps] == [82, 71, 66]):
            self._fail("RGB-coded (not YCbCr) JPEG is not supported")
        if self.progressive:
            self.coef = [np.asarray(cf, np.int32).reshape(c.bh, c.bw, 64)
                         for cf, c in zip(self.coef, self.comps)]
            self.progressive = False
        comps = self.comps[:1 if gray else len(self.comps)]
        for c in comps:
            if self.hmax % c.h or self.vmax % c.v:
                self._fail(f"fractional sampling ({c.h}x{c.v} of "
                           f"{self.hmax}x{self.vmax}) is not supported")
        planes = [_upsample(self._plane(k), c, self)
                  for k, c in enumerate(comps)]
        if len(planes) == 1:
            return planes[0]
        return _ycc_to_rgb(*planes)

    def _plane(self, ci):
        """Component ``ci``'s samples, cropped to its real size."""
        c = self.comps[ci]
        q = self.quant.get(c.tq)
        if q is None:
            self._fail(f"undefined quantization table {c.tq}")
        blocks = np.ascontiguousarray(self.coef[ci], np.int32)
        q = np.ascontiguousarray(q, np.int64)
        out = np.empty((c.bh * 8, c.bw * 8), np.uint8)
        # dequantize, jidctint.c's ISLOW IDCT and the range limit
        native.image_lib().jpeg_idct_islow(
            blocks.ctypes.data, q.ctypes.data, c.bh, c.bw, out.ctypes.data)
        return out[:c.height, :c.width]


# jfdctint.c constants (CONST_BITS 13)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _upsample(plane, c, jpg):
    """A component plane to full resolution as libjpeg's default
    upsampler does: the fancy triangle filters for 2:1 ratios, else
    replication (``int_upsample``, also for planes too narrow for the
    fancy filters); edge samples replicate the last real one."""
    plane = np.ascontiguousarray(plane, np.uint8)
    out = np.empty((jpg.height, jpg.width), np.uint8)
    native.image_lib().jpeg_upsample(
        plane.ctypes.data, *plane.shape, jpg.hmax // c.h, jpg.vmax // c.v,
        out.ctypes.data, *out.shape)
    return out


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's YCbCr -> RGB of three full-size planes: (H, W, 3)."""
    out = np.empty(y.shape + (3,), np.uint8)
    native.image_lib().jpeg_ycc_to_rgb(
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data, y.size, out.ctypes.data)
    return out


# --------------------------------------------------------------------- #
# PNG decoding
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class _Png:
    """One PNG file: chunks parsed and samples unfiltered on construction
    (``samples``: (H, W, channels), raw values: palette indices, 1-16 bit
    levels); ``pil()`` and ``cv2(color)`` give each library's pixels."""

    def __init__(self, data, path):
        self.path = path
        pos, idat, hdr = 8, [], None
        self.palette, self.orientation = None, 1
        while pos + 8 <= len(data):
            n, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + n]
            pos += 12 + n
            if kind == b"IHDR":
                hdr = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                self.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"eXIf":
                self.orientation = _exif_orientation(body)
            elif kind == b"IEND":
                break
        if hdr is None:
            raise ValueError(f"{path}: PNG without IHDR")
        w, h, depth, ctype, _, _, interlace = hdr
        if depth not in _PNG_DEPTHS.get(ctype, ()):
            raise ValueError(f"{path}: PNG colour type {ctype} at {depth} "
                             "bits is not a valid PNG")
        if ctype == 3 and self.palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        if interlace > 1:
            raise ValueError(f"{path}: unknown PNG interlace method "
                             f"{interlace}")
        self.width, self.height, self.depth, self.ctype = w, h, depth, ctype
        self.channels = _PNG_CHANNELS[ctype]
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        if not interlace:
            self.samples = self._pass(raw, w, h)[0]
            return
        self.samples = np.zeros((h, w, self.channels),
                                np.uint16 if depth == 16 else np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes, not even filters
            sub, used = self._pass(raw, pw, ph)
            self.samples[y0::dy, x0::dx] = sub
            raw = raw[used:]

    def _pass(self, raw, w, h):
        """Unfilter and unpack one (sub)image of w x h from the front of
        ``raw`` -> ((h, w, channels) samples, bytes used)."""
        bits = self.depth * self.channels
        stride = -(-w * bits // 8)
        bpp = max(1, bits // 8)
        used = h * (stride + 1)
        if raw.size < used:
            raise ValueError(f"{self.path}: PNG image data is truncated")
        rows = raw[:used].reshape(h, stride + 1)
        out = np.zeros((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for yy in range(h):
            f, line = rows[yy, 0], rows[yy, 1:]
            if f == 0:
                cur = line.copy()
            elif f == 1:  # Sub: a running sum per byte of the pixel, mod 256
                cur = np.cumsum(line.reshape(-1, bpp), 0,
                                dtype=np.uint8).reshape(-1)
            elif f == 2:  # Up
                cur = line + prev
            elif f in (3, 4):
                cur = _unfilter_sequential(f, line.tolist(), prev.tolist(),
                                           bpp)
            else:
                raise ValueError(f"{self.path}: unknown PNG filter type {f}")
            out[yy] = cur
            prev = out[yy]
        if self.depth == 16:
            vals = out.view(">u2").astype(np.uint16)
        elif self.depth == 8:
            vals = out
        else:  # 1/2/4-bit samples, most significant first in each byte
            per = 8 // self.depth
            shifts = (8 - self.depth * (1 + np.arange(per))).astype(np.uint8)
            vals = ((out[..., None] >> shifts) & ((1 << self.depth) - 1))
            vals = vals.reshape(h, -1)[:, :w * self.channels]
        return vals.reshape(h, w, self.channels), used

    def _scaled8(self):
        """Gray levels of a sub-8-bit gray image scaled to 0-255 (libpng's
        expand and PIL's "L;2"/"L;4" unpackers agree)."""
        return (self.samples * (255 // ((1 << self.depth) - 1))).astype(
            np.uint8)

    def pil(self):
        s = self.samples
        if self.ctype == 3:  # mode "P": the indices
            return s[..., 0].astype(np.uint8)
        if self.ctype == 0:
            if self.depth == 1:
                return s[..., 0] != 0  # mode "1"
            if self.depth == 16:
                return s[..., 0].astype(np.uint16)  # mode "I;16"
            return self._scaled8()[..., 0]
        if self.depth == 16:
            s = (s >> 8).astype(np.uint8)
            if self.ctype == 4:  # 16-bit gray+alpha reads as RGBA
                s = s[..., [0, 0, 0, 1]]
        return np.ascontiguousarray(s)

    def cv2(self, color):
        """libpng's 8-bit output as OpenCV asks for it: (H, W, 3) BGR when
        ``color``, else (H, W) gray."""
        s = self.samples
        if self.ctype == 3:
            s = self.palette[np.minimum(s[..., 0], len(self.palette) - 1)]
        elif self.ctype in (0, 4) and self.depth < 8:
            s = self._scaled8()
        s = s[..., :3] if s.shape[-1] >= 3 else s[..., :1]  # alpha dropped
        if s.shape[-1] == 1:
            g = s[..., 0]
            if self.depth == 16:
                g = g >> 8
            g = g.astype(np.uint8)
            return np.repeat(g[..., None], 3, -1) if color else g
        if color:
            if self.depth == 16:
                s = s >> 8
            return np.ascontiguousarray(s[..., ::-1].astype(np.uint8))
        r, g, b = (s[..., k].astype(np.int64) for k in range(3))
        grey = r.copy()
        diff = (r != g) | (r != b)
        if self.depth == 16:
            mixed = (9797 * r + 19234 * g + 3737 * b + 16384) >> 15
            return (np.where(diff, mixed, grey) >> 8).astype(np.uint8)
        mixed = (9797 * r + 19234 * g + 3737 * b) >> 15
        return np.where(diff, mixed, grey).astype(np.uint8)


def _unfilter_sequential(f, line, prev, bpp):
    """Average (3) and Paeth (4) filters, byte by byte."""
    cur = [0] * len(line)
    for i, v in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if f == 3:
            cur[i] = (v + ((a + b) >> 1)) & 255
            continue
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (v + pred) & 255
    return np.asarray(cur, np.uint8)


# --------------------------------------------------------------------- #
# Writers
def imwrite(path, img):
    """What ``cv2.imwrite(path, img)`` writes for a uint8 image that is
    gray (H, W) or BGR (H, W, 3), by the extension: ``.jpg``/``.jpeg`` with
    ``encode_jpeg``'s defaults, ``.png`` with ``encode_png`` (which also
    takes uint16)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img)
    elif ext == ".png":
        data = encode_png(img)
    else:
        raise ValueError(f"{path}: only .jpg, .jpeg and .png are written")
    with open(path, "wb") as f:
        f.write(data)


def _check_u8(img, channels, dtypes=(np.uint8,)):
    img = np.asarray(img)
    if img.dtype not in dtypes:
        names = " or ".join(np.dtype(d).name for d in dtypes)
        raise ValueError(f"only {names} images are written, not {img.dtype}")
    c = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if c not in channels or min(img.shape[:2]) == 0:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    return img


# Annex K tables of the JPEG standard (natural order) and the standard
# Huffman tables (bits, values) that libjpeg's jpeg_set_defaults installs
_STD_LUMA_Q = [
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
_STD_CHROMA_Q = [
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _quant_table(base, quality):
    """jcparam.c's jpeg_set_quality with force_baseline: the scale factor
    of jpeg_quality_scaling, entries (q * scale + 50) / 100 in [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = (np.asarray(base, np.int64) * scale + 50) // 100
    return np.clip(q, 1, 255)


def _huffman_codes(bits, values):
    """(code, length) per symbol 0-255 of a canonical Huffman table."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            code[values[k]], length[values[k]] = c, ln
            c += 1
            k += 1
        c <<= 1
    return code, length


def _rgb_to_ycc(bgr):
    """jccolor.c's rgb_ycc_convert (SCALEBITS 16, Cb/Cr rounded with
    ONE_HALF - 1) of a BGR image -> Y, Cb, Cr int32 planes (every sum is
    below 2^26)."""
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    b, g, r = (bgr[..., k].astype(np.int32) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
          + half - 1) >> 16
    return y, cb, cr


def _pad_edge(x, rows, cols):
    """Replicate the last row and column out to (rows, cols)."""
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])),
                  mode="edge")


def _fdct_1d(x, last):
    """One pass of jfdctint.c's ISLOW FDCT along the last axis of
    ``x`` (..., 8): the row pass (``last=False``: scaled up by
    2^PASS1_BITS) or the column pass (descaled by PASS1_BITS)."""
    F = _F
    sh = 13 + 2 if last else 13 - 2
    tmp0, tmp7 = x[..., 0] + x[..., 7], x[..., 0] - x[..., 7]
    tmp1, tmp6 = x[..., 1] + x[..., 6], x[..., 1] - x[..., 6]
    tmp2, tmp5 = x[..., 2] + x[..., 5], x[..., 2] - x[..., 5]
    tmp3, tmp4 = x[..., 3] + x[..., 4], x[..., 3] - x[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    out = [None] * 8
    if last:
        out[0] = descale(tmp10 + tmp11, 2)
        out[4] = descale(tmp10 - tmp11, 2)
    else:
        out[0] = (tmp10 + tmp11) << 2
        out[4] = (tmp10 - tmp11) << 2
    z1 = (tmp12 + tmp13) * F["f0541"]
    out[2] = descale(z1 + tmp13 * F["f0765"], sh)
    out[6] = descale(z1 + tmp12 * -F["f1847"], sh)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F["f1175"]
    tmp4 = tmp4 * F["f0298"]
    tmp5 = tmp5 * F["f2053"]
    tmp6 = tmp6 * F["f3072"]
    tmp7 = tmp7 * F["f1501"]
    z1 = z1 * -F["f0899"]
    z2 = z2 * -F["f2562"]
    z3 = z3 * -F["f1961"] + z5
    z4 = z4 * -F["f0390"] + z5
    out[7] = descale(tmp4 + z1 + z3, sh)
    out[5] = descale(tmp5 + z2 + z4, sh)
    out[3] = descale(tmp6 + z2 + z3, sh)
    out[1] = descale(tmp7 + z1 + z4, sh)
    return np.stack(out, -1)


def _forward_blocks(plane, q):
    """(8*bh, 8*bw) samples -> (bh, bw, 64) quantized coefficients in
    natural order: level shift by 128, ISLOW FDCT (rows, then columns),
    then jcdctmgr.c's quantization, round half away from zero of
    x / (8 q)."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    x = plane.astype(np.int64).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    x = _fdct_1d(x - 128, last=False)
    x = _fdct_1d(x.swapaxes(-1, -2), last=True).swapaxes(-1, -2)
    d = (np.asarray(q, np.int64) << 3).reshape(8, 8)
    mag = (np.abs(x) + (d >> 1)) // d
    return np.where(x < 0, -mag, mag).reshape(bh, bw, 64)


def _with_dummy_blocks(coef, mcu_h, mcu_w, rows, cols):
    """The (rows, cols, 64) block grid of a component's whole MCUs from its
    real blocks, as jccoefct.c fills it: a dummy block at the right edge
    takes the DC of the block to its left, a dummy block row at the bottom
    the DC of the block before it in the MCU (the MCU's last block of the
    row above), AC zero."""
    bh, bw = coef.shape[:2]
    out = np.zeros((rows, cols, 64), np.int64)
    out[:bh, :bw] = coef
    for bx in range(bw, cols):
        out[:bh, bx, 0] = out[:bh, bx - 1, 0]
    for by in range(bh, rows):
        last = out[by - 1, mcu_w - 1::mcu_w, 0]
        out[by, :, 0] = np.repeat(last, mcu_w)
    return out


def encode_jpeg(img, quality=95):
    """The baseline JPEG that ``cv2.imwrite`` (libjpeg-turbo) writes for a
    uint8 BGR or gray image at OpenCV's defaults: quality 95, 4:2:0
    (h2v2 downsampling with the alternating 1, 2 bias, edges replicated to
    whole blocks), the ISLOW FDCT, standard Huffman tables, one
    interleaved scan, a JFIF APP0. Its decoded pixels equal those of
    OpenCV's file (the same quantized coefficients)."""
    img = _check_u8(img, (1, 3))
    H, W = img.shape[:2]
    luma_q = _quant_table(_STD_LUMA_Q, quality)
    if img.ndim == 2:
        qs = [luma_q]
        y = _pad_edge(img, -(-H // 8) * 8, -(-W // 8) * 8)
        grids = [_forward_blocks(y, luma_q)]
        sampling, mcuy, mcux = [(1, 1)], -(-H // 8), -(-W // 8)
    else:
        chroma_q = _quant_table(_STD_CHROMA_Q, quality)
        qs = [luma_q, chroma_q]
        mcuy, mcux = -(-H // 16), -(-W // 16)
        bgr = _pad_edge_3(img, H + H % 2, mcux * 16)
        y, cb, cr = _rgb_to_ycc(bgr)
        yb = _forward_blocks(
            _pad_edge(y[:H, :W], -(-H // 8) * 8, -(-W // 8) * 8), luma_q)
        grids = [_with_dummy_blocks(yb, 2, 2, 2 * mcuy, 2 * mcux)]
        bias = np.tile([1, 2], mcux * 4)
        for c in (cb, cr):
            s = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                 + c[1::2, 1::2] + bias) >> 2
            grids.append(_forward_blocks(_pad_edge(s, mcuy * 8, mcux * 8),
                                         chroma_q))
        sampling = [(2, 2), (1, 1), (1, 1)]
    # blocks in scan order: raster for one component; else per MCU the
    # Y blocks row by row, then Cb, then Cr
    if len(grids) == 1:
        blocks, comp = grids[0].reshape(-1, 64), np.zeros(mcuy * mcux, int)
    else:
        yb = grids[0].reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4)
        per_mcu = np.concatenate([yb.reshape(mcuy, mcux, 4, 64),
                                  grids[1][:, :, None], grids[2][:, :, None]],
                                 2)
        blocks = per_mcu.reshape(-1, 64)
        comp = np.tile([0, 0, 0, 0, 1, 2], mcuy * mcux)
    tables = [(_huffman_codes(*_DC_LUMA), _huffman_codes(*_AC_LUMA)),
              (_huffman_codes(*_DC_CHROMA), _huffman_codes(*_AC_CHROMA))]
    data = _entropy_code(blocks, comp, tables)
    return _jpeg_file(H, W, qs, sampling, data)


def _pad_edge_3(img, rows, cols):
    return np.pad(img, ((0, rows - img.shape[0]), (0, cols - img.shape[1]),
                        (0, 0)), mode="edge")


def _magnitude(v):
    """(size category, extra bits) of JPEG-coded integers."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    extra = np.where(v < 0, v + (np.int64(1) << size) - 1, v)
    return size, extra


def _entropy_code(blocks, comp, tables):
    """Huffman-code (N, 64) natural-order blocks of one interleaved scan
    (``comp``: each block's component, 0 luma, else chroma; DC predicted
    per component) into entropy-coded bytes, 0xFF stuffed, padded with
    1 bits. Vectorised: every code word with its extra bits is one
    (value, length) event, placed by prefix sums, then packed into 32-bit
    words."""
    zz = blocks[:, _NATURAL[:64]].astype(np.int64)
    nb = zz.shape[0]
    tbl = (comp > 0).astype(np.int64)
    # DC differences per component, in scan order
    diff = np.empty(nb, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        dc = zz[sel, 0]
        diff[sel] = dc - np.concatenate([[0], dc[:-1]])
    dsize, dextra = _magnitude(diff)
    dc_code = np.stack([tables[0][0][0], tables[1][0][0]])
    dc_len = np.stack([tables[0][0][1], tables[1][0][1]])
    ac_code = np.stack([tables[0][1][0], tables[1][1][0]])
    ac_len = np.stack([tables[0][1][1], tables[1][1][1]])
    dc_val = (dc_code[tbl, dsize] << dsize) | dextra
    dc_bits = dc_len[tbl, dsize] + dsize
    # AC: each nonzero coefficient, its zero run split into ZRLs (16 zeros)
    bi, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prevk = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prevk - 1
    nzrl, r16 = run >> 4, run & 15
    asize, aextra = _magnitude(v)
    sym = (r16 << 4) | asize
    ac_val = (ac_code[tbl[bi], sym] << asize) | aextra
    ac_bits = ac_len[tbl[bi], sym] + asize
    per = nzrl + 1  # events per nonzero coefficient
    lastk = np.zeros(nb, np.int64)
    np.maximum.at(lastk, bi, k)
    eob = lastk < 63
    n_ev = 1 + np.bincount(bi, weights=per, minlength=nb).astype(
        np.int64) + eob
    start = np.concatenate([[0], np.cumsum(n_ev)[:-1]])
    excl = np.cumsum(per) - per  # events before each entry, globally
    first_at = np.searchsorted(bi, bi, side="left")
    pos = start[bi] + 1 + (excl - excl[first_at]) + nzrl
    total = int(n_ev.sum())
    vals = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)
    vals[start], lens[start] = dc_val, dc_bits
    vals[pos], lens[pos] = ac_val, ac_bits
    zr = np.repeat(np.arange(len(bi)), nzrl)
    if len(zr):
        j = np.arange(len(zr)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        zpos = pos[zr] - nzrl[zr] + j
        vals[zpos] = ac_code[tbl[bi[zr]], 0xF0]
        lens[zpos] = ac_len[tbl[bi[zr]], 0xF0]
    epos = (start + n_ev - 1)[eob]
    vals[epos] = ac_code[tbl[eob], 0]
    lens[epos] = ac_len[tbl[eob], 0]
    # pack: each event lies in one 64-bit big-endian window at its word
    off = np.cumsum(lens) - lens
    nbits = int(lens.sum())
    word, sh = off >> 5, off & 31
    win = vals.astype(np.uint64) << (64 - sh - lens).astype(np.uint64)
    nw = (nbits >> 5) + 2
    hi = np.bincount(word, weights=(win >> np.uint64(32)).astype(np.float64),
                     minlength=nw)
    lo = np.bincount(word + 1, weights=(win & np.uint64(0xFFFFFFFF)).astype(
        np.float64), minlength=nw)
    words = (hi + lo).astype(np.uint64).astype(">u4")
    out = np.frombuffer(words.tobytes(), np.uint8)[:-(-nbits // 8)].copy()
    if nbits % 8:
        out[-1] |= (1 << (8 - nbits % 8)) - 1
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _jpeg_file(H, W, qs, sampling, data):
    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [b"\xff\xd8",
           seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    zig = np.asarray(_NATURAL[:64])
    for t, q in enumerate(qs):
        out.append(seg(0xDB, bytes([t]) + bytes(q[zig].astype(np.uint8))))
    nc = len(sampling)
    sof = struct.pack(">BHHB", 8, H, W, nc)
    for c, (h, v) in enumerate(sampling):
        sof += bytes([c + 1, (h << 4) | v, min(c, 1)])
    out.append(seg(0xC0, sof))
    huff = [(0x00, _DC_LUMA), (0x10, _AC_LUMA)]
    if nc > 1:
        huff += [(0x01, _DC_CHROMA), (0x11, _AC_CHROMA)]
    for cls, (bits, vals) in huff:
        out.append(seg(0xC4, bytes([cls] + bits + vals)))
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0x11 * min(c, 1)])
                                 for c in range(nc)) + b"\x00\x3f\x00"
    out.append(seg(0xDA, sos))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def encode_png(img):
    """A PNG of a gray (H, W) or BGR (H, W, 3) image, uint8 or uint16 (8- or
    16-bit samples, as ``cv2.imwrite`` writes a depth map; written as gray or
    RGB, the channel order swapped back as cv2.imwrite does), every row
    filter type 0, zlib level 6."""
    img = _check_u8(img, (1, 3), (np.uint8, np.uint16))
    H, W = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    if img.ndim == 2:
        ctype, rows = 0, img
    else:
        ctype, rows = 2, img[..., ::-1].reshape(H, -1)
    rows = np.ascontiguousarray(rows).astype(">u2" if depth == 16 else
                                             np.uint8).view(np.uint8)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows.reshape(H, -1)],
                         1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
