"""A msgpack decoder for flax checkpoints (no msgpack package is installed
where the port runs).

Decodes the subset ``flax.serialization.to_bytes`` writes for a
checkpoint: maps, arrays, str, bin, nil/bool, ints and floats of every
width, and flax's extension types 1 (an ndarray packed as msgpack: shape,
dtype name, C-order bytes) and 3 (a numpy scalar packed as a 0-d ndarray);
any other extension raises. Array leaves are numpy; a ``bfloat16`` leaf
(numpy has no such dtype) becomes a ``torch.bfloat16`` tensor through a
uint16 view.
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
