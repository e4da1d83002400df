"""Image file decoding in numpy: the port's counterpart of the
``PIL.Image.open`` / ``cv2.imread(..., IMREAD_GRAYSCALE)`` calls of
``chore_tpu``'s data path (neither library is installed where the port
runs).

The format comes from the file's magic bytes, not its extension:

* JPEG: baseline and extended sequential Huffman (SOF0/SOF1), 8-bit, 1 or 3
  components with sampling factors up to 2, restart intervals. Decoded as
  libjpeg(-turbo) decodes it by default, so the result is bitwise equal:
  the integer ISLOW IDCT of ``jidctint.c``, the "fancy" triangle-filter
  upsampling of ``jdsample.c`` and the fixed-point YCbCr->RGB tables of
  ``jdcolor.c``. Progressive, lossless, arithmetic-coded and 12-bit files
  raise ``ValueError``.
* PNG: 8-bit gray, gray+alpha, RGB and RGBA, every filter type; interlaced
  and palette files raise.

The Huffman stage is a Python loop over the coded symbols; the rest is
vectorised numpy.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def read_rgb(path):
    """What ``np.array(PIL.Image.open(path))`` gives: (H, W, 3) uint8 for a
    colour JPEG or RGB PNG, (H, W) for gray, (H, W, 2) gray+alpha, (H, W, 4)
    RGBA."""
    data = _read(path)
    if data.startswith(JPEG_MAGIC):
        return _Jpeg(data, path).decode(gray=False)
    return _decode_png(data, path)


def read_gray(path):
    """What ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives, (H, W) uint8:
    for a JPEG libjpeg's Y plane (cv2 asks libjpeg for grayscale output, so
    no chroma is upsampled or converted); for a colour PNG libpng's
    rgb_to_gray with the weights OpenCV asks for (0.299, 0.587: 9797 and
    19234 of 2^15, blue the rest), truncated, alpha dropped."""
    data = _read(path)
    if data.startswith(JPEG_MAGIC):
        return _Jpeg(data, path).decode(gray=True)
    img = _decode_png(data, path)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:  # gray + alpha
        return np.ascontiguousarray(img[..., 0])
    r, g, b = (img[..., k].astype(np.int32) for k in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(JPEG_MAGIC) or data.startswith(PNG_MAGIC)):
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    return data


# --------------------------------------------------------------------- #
# JPEG
# zig-zag position -> natural (row-major) index, with 16 extra entries so a
# corrupt run past the end lands on 63 (as jpeg_natural_order does)
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless",
}


def _huffman_lut(counts, symbols):
    """16-bit lookahead tables (symbol, code length) of a canonical Huffman
    table; a code that is not in the table decodes as symbol 0, length 16
    (libjpeg's "bad Huffman code" recovery)."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.full(1 << 16, 16, np.int64)
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
    return sym.tolist(), length.tolist()


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


class _Jpeg:
    """One sequential-Huffman JPEG file: markers parsed on construction,
    pixels by ``decode``."""

    def __init__(self, data, path):
        self.data, self.path = data, path
        self.quant = {}
        self.dc_tables, self.ac_tables = {}, {}
        self.restart = 0
        self.adobe_transform = None
        self.comps = None
        self.coef = None  # per component: (blocks_h, blocks_w, 64) int32
        self._parse()

    def _fail(self, what):
        raise ValueError(f"{self.path}: {what}")

    # -- markers -------------------------------------------------------- #
    def _parse(self):
        d, pos = self.data, 2
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
            if marker in (0xC0, 0xC1):
                self._sof(seg)
            elif marker in _UNSUPPORTED_SOF:
                self._fail(f"{_UNSUPPORTED_SOF[marker]} JPEG (SOF{marker - 0xC0}) "
                           "is not supported; only baseline and extended "
                           "sequential Huffman files are")
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
            if not (1 <= hs <= 2 and 1 <= vs <= 2):
                self._fail(f"sampling factors {hs}x{vs} are not supported "
                           "(at most 2)")
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
        if ss != 0 or se != 63:
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
        try:
            self._decode_scan(scan, b"".join(pieces), starts)
        except IndexError:
            self._fail("corrupt or truncated entropy-coded data")
        return j - 1

    def _decode_scan(self, scan, stream, starts):
        """Huffman-decode one scan's blocks into ``self.coef``."""
        comps = self.comps
        if len(scan) == 1:  # non-interleaved: one block per MCU over the
            ci = scan[0][0]  # component's own (unpadded) block grid
            c = comps[ci]
            nbw, nbh = -(-c.width // 8), -(-c.height // 8)
            layout = [[(0, (by * c.bw + bx) * 64)]
                      for by in range(nbh) for bx in range(nbw)]
        else:
            layout = []
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    mcu = []
                    for slot, (ci, _, _) in enumerate(scan):
                        c = comps[ci]
                        for y in range(c.v):
                            for x in range(c.h):
                                b = (my * c.v + y) * c.bw + mx * c.h + x
                                mcu.append((slot, b * 64))
                    layout.append(mcu)
        tables = []
        for ci, td, ta in scan:
            if td not in self.dc_tables or ta not in self.ac_tables:
                self._fail("scan uses an undefined Huffman table")
            tables.append(self.dc_tables[td] + self.ac_tables[ta])
        # 56-bit big-endian windows at every byte offset (zero bits past the
        # end, as libjpeg inserts)
        b = np.frombuffer(stream + bytes(8), np.uint8).astype(np.int64)
        n = len(stream) + 1
        win = b[:n] << 48
        for k in range(1, 7):
            win |= b[k:n + k] << (48 - 8 * k)
        w = win.tolist()
        nat = _NATURAL
        idx = [[] for _ in scan]
        val = [[] for _ in scan]
        preds = [0] * len(scan)
        interval = self.restart or len(layout)
        seg = 0
        p = 0
        for m, mcu in enumerate(layout):
            if m % interval == 0:
                if seg >= len(starts):
                    self._fail("missing restart marker")
                p = 8 * starts[seg]
                seg += 1
                preds = [0] * len(scan)
            for slot, base in mcu:
                dsym, dlen, asym, alen = tables[slot]
                ix, vx = idx[slot], val[slot]
                v = (w[p >> 3] >> (40 - (p & 7))) & 0xFFFF
                s = dsym[v]
                p += dlen[v]
                if s:
                    x = (w[p >> 3] >> (56 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if x < (1 << (s - 1)):
                        x -= (1 << s) - 1
                    preds[slot] += x
                ix.append(base)
                vx.append(preds[slot])
                k = 1
                while k < 64:
                    v = (w[p >> 3] >> (40 - (p & 7))) & 0xFFFF
                    rs = asym[v]
                    p += alen[v]
                    r = rs & 15
                    if r:
                        k += rs >> 4
                        x = (w[p >> 3] >> (56 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                        if x < (1 << (r - 1)):
                            x -= (1 << r) - 1
                        ix.append(base + nat[k])
                        vx.append(x)
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break
        for slot, (ci, _, _) in enumerate(scan):
            flat = self.coef[ci].reshape(-1)
            flat[np.asarray(idx[slot], np.int64)] = np.asarray(val[slot],
                                                               np.int32)

    # -- pixels ------------------------------------------------------------ #
    def decode(self, gray):
        if len(self.comps) == 3 and (self.adobe_transform == 0 or [
                c.id for c in self.comps] == [82, 71, 66]):
            self._fail("RGB-coded (not YCbCr) JPEG is not supported")
        planes = [self._plane(k) for k in range(1 if gray else
                                               len(self.comps))]
        planes = [_upsample(p, c, self) for p, c in zip(planes, self.comps)]
        if len(planes) == 1:
            return planes[0]
        return _ycc_to_rgb(*planes)

    def _plane(self, ci):
        """Component ``ci``'s samples, cropped to its real size."""
        c = self.comps[ci]
        q = self.quant.get(c.tq)
        if q is None:
            self._fail(f"undefined quantization table {c.tq}")
        blocks = self.coef[ci].reshape(-1, 64)
        out = np.empty((blocks.shape[0], 64), np.uint8)
        for s in range(0, blocks.shape[0], 4096):
            out[s:s + 4096] = _idct_islow(blocks[s:s + 4096], q)
        img = out.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        return img.reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]


# jidctint.c constants (CONST_BITS 13)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x, shift):
    """One pass of jidctint.c's ISLOW IDCT along the second-to-last axis of
    ``x`` (..., 8, 8), descaled by ``shift`` bits with rounding."""
    F = _F
    z2, z3 = x[..., 2, :], x[..., 6, :]
    z1 = (z2 + z3) * F["f0541"]
    tmp2 = z1 + z3 * -F["f1847"]
    tmp3 = z1 + z2 * F["f0765"]
    tmp0 = (x[..., 0, :] + x[..., 4, :]) << 13
    tmp1 = (x[..., 0, :] - x[..., 4, :]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7, :], x[..., 5, :], x[..., 3, :], x[..., 1, :]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F["f1175"]
    t0 = t0 * F["f0298"]
    t1 = t1 * F["f2053"]
    t2 = t2 * F["f3072"]
    t3 = t3 * F["f1501"]
    z1 = z1 * -F["f0899"]
    z2 = z2 * -F["f2562"]
    z3 = z3 * -F["f1961"] + z5
    z4 = z4 * -F["f0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    rows = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return np.stack([(r + half) >> shift for r in rows], axis=-2)


def _idct_range_limit():
    """libjpeg's post-IDCT range-limit table (jdmaster.c), indexed by
    ``value & 1023``: [0, 128) -> value + 128, [128, 512) -> 255,
    [512, 896) -> 0, [896, 1024) -> value - 896."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE = _idct_range_limit()


def _idct_islow(blocks, q):
    """(N, 64) quantized coefficients (natural order) -> (N, 64) uint8
    samples: dequantize, columns (PASS1_BITS 2), then rows."""
    x = (blocks.astype(np.int64) * q).reshape(-1, 8, 8)
    ws = _idct_1d(x, 13 - 2)  # pass 1 over columns
    out = _idct_1d(ws.swapaxes(-1, -2), 13 + 2 + 3).swapaxes(-1, -2)
    return _RANGE[out & 1023].reshape(-1, 64)


def _upsample(plane, c, jpg):
    """A component plane to full resolution as libjpeg's default
    (fancy) upsampler does; edge samples replicate the last real one."""
    fh, fv = jpg.hmax // c.h, jpg.vmax // c.v
    x = plane.astype(np.int32)
    dw = x.shape[1]
    if fh == 2 and fv == 2 and dw > 2:  # h2v2_fancy_upsample
        up = np.concatenate([x[:1], x[:-1]], 0)
        down = np.concatenate([x[1:], x[-1:]], 0)
        rows = np.empty((2 * x.shape[0], dw), np.int32)
        rows[0::2] = 3 * x + up
        rows[1::2] = 3 * x + down
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.empty((rows.shape[0], 2 * dw), np.int32)
        out[:, 0::2] = (3 * rows + left + 8) >> 4
        out[:, 1::2] = (3 * rows + right + 7) >> 4
    elif fh == 2 and fv == 1 and dw > 2:  # h2v1_fancy_upsample
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((x.shape[0], 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
    elif fh == 1 and fv == 2:  # h1v2_fancy_upsample
        up = np.concatenate([x[:1], x[:-1]], 0)
        down = np.concatenate([x[1:], x[-1:]], 0)
        out = np.empty((2 * x.shape[0], dw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
    else:  # 1:1, or a plane too narrow for the fancy filters: replicate
        out = np.repeat(np.repeat(x, fv, 0), fh, 1)
    return out[:jpg.height, :jpg.width].astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    one_half = 1 << 15
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def _ycc_to_rgb(y, cb, cr):
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------- #
# PNG
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _decode_png(data, path):
    if not data.startswith(PNG_MAGIC):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth != 8:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is "
                         "not supported (8-bit gray, gray+alpha, RGB, RGBA)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for yy in range(h):
        f, line = rows[yy, 0], rows[yy, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), 0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prev
        elif f in (3, 4):
            cur = _unfilter_sequential(f, line.tolist(), prev.tolist(), bpp)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {f}")
        out[yy] = cur
        prev = out[yy]
    shape = (h, w) if bpp == 1 else (h, w, bpp)
    return out.reshape(shape)


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
