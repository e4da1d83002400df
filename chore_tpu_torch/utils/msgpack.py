"""A msgpack decoder and encoder for flax checkpoints (no msgpack package
is installed where the port runs).

Decodes the subset ``flax.serialization.to_bytes`` writes for a
checkpoint: maps, arrays, str, bin, nil/bool, ints and floats of every
width, and flax's extension types 1 (an ndarray packed as msgpack: shape,
dtype name, C-order bytes) and 3 (a numpy scalar packed as a 0-d ndarray);
any other extension raises. Array leaves are numpy; a ``bfloat16`` leaf
(numpy has no such dtype) becomes a ``torch.bfloat16`` tensor through a
uint16 view. ``packb`` writes the same subset the way
``flax.serialization.msgpack_serialize`` does (byte for byte on a tree of
dicts with str keys and numpy leaves), so ``msgpack_restore`` reads it.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data, raw):
        self.data, self.pos, self.raw = data, 0, raw

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data is truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fmts:
            return self.unpack(fmts[t])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                0xDC: ">H", 0xDD: ">I",  # array
                0xDE: ">H", 0xDF: ">I",  # map
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if t in lens:
            n = self.unpack(lens[t])
            if t <= 0xC6:
                return bytes(self.take(n))
            if t <= 0xC9:
                code = self.unpack(">b")
                return _ext(code, bytes(self.take(n)))
            if t <= 0xDB:
                return self.str_(n)
            if t <= 0xDD:
                return [self.obj() for _ in range(n)]
            return self.map_(n)
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(1 << (t - 0xD4))))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map_(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray(data):
    shape, dtype_name, buf = _Reader(memoryview(data), raw=True).obj()
    if dtype_name == b"bfloat16":
        u16 = np.frombuffer(buf, np.uint16).reshape(shape, order="C")
        return torch.from_numpy(u16.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def _ext(code, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr if torch.is_tensor(arr) else arr[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def unpackb(data):
    """Decode one msgpack object (as ``flax.serialization.msgpack_restore``
    does)."""
    r = _Reader(memoryview(data), raw=False)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack "
                         "object")
    return out


# ------------------------------------------------------------------ #
# encoding
_MAX_CHUNK = 2**30  # flax writes larger arrays in chunks; the port's are
# all smaller (the largest parameter is 1.2 MB)


def _uint(out, n, small, codes):
    """Append a length or a count with the smallest header that holds it."""
    if small is not None and n < small[0]:
        out.append(small[1] | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _int(out, v):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        _uint(out, v, None, ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                             (0xCF, ">Q")))
    else:
        for code, fmt, lo in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                              (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= lo:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} out of msgpack's range")


def _ndarray_bytes(a):
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    if a.nbytes > _MAX_CHUNK:
        raise ValueError(f"array of {a.nbytes} bytes needs flax's chunking")
    return packb((list(a.shape), a.dtype.name, a.tobytes("C")))


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _uint(out, n, None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack(">b", code) + data


def _pack(out, v):
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int) and not isinstance(v, np.integer):
        _int(out, v)
    elif isinstance(v, float) and not isinstance(v, np.floating):
        out += b"\xcb" + struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _uint(out, len(b), (32, 0xA0), ((0xD9, ">B"), (0xDA, ">H"),
                                        (0xDB, ">I")))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _uint(out, len(b), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += b
    elif isinstance(v, dict):
        _uint(out, len(v), (16, 0x80), ((0xDE, ">H"), (0xDF, ">I")))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        _uint(out, len(v), (16, 0x90), ((0xDC, ">H"), (0xDD, ">I")))
        for x in v:
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    else:
        raise TypeError(f"cannot msgpack a {type(v).__name__}")


def packb(obj):
    """Encode ``obj`` (dicts, lists, str, bytes, None, bool, int, float,
    numpy arrays and scalars) as ``flax.serialization.msgpack_serialize``
    does."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
