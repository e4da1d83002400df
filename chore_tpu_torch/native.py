"""ctypes bindings to the chorenat native geometry runtime
(``native/chorenat.cpp``), the counterpart of ``chore_tpu/native.py``:
triangle-BVH closest-point queries, point KD-tree 1-NN, area-weighted
surface sampling and the bidirectional Chamfer, all OpenMP-parallel.

The port compiles the same source with the same flags as
``native/Makefile`` (``-O3 -march=native -fPIC -fopenmp``), so the machine
code, and with it every sample and distance, is that of the JAX package's
library. The library goes into ``chore_tpu_torch/_build/``, named by a hash
of the source, the flags, the compiler and the host CPU (``-march=native``
code built on one machine must not be loaded on another). It is written to
a temporary file unique to the process and thread and published with
``os.replace``, so processes and threads that build at once (test workers,
thread pools) never load a half-written library. A failed build raises with g++'s output; no
entry point falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "chorenat.cpp")
# the port's own host loops (JPEG decode stages, uint8 resize)
IMAGE_SOURCE = os.path.join(_PKG, "csrc", "image.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall",
             "-Wextra", "-shared")

_lib = None
_lib_lock = threading.Lock()
_image_lib = None


def _cpu_signature():
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine() + platform.processor()
    keep = [ln for ln in lines if ln.split(":")[0].strip() in (
        "vendor_id", "model name", "flags", "Features", "CPU part")]
    return platform.machine() + "\n".join(dict.fromkeys(keep))


def _cxx():
    """``g++`` on the PATH. ``$CXX`` is not read: on some hosts it names a
    toolchain kept for nvcc's host code that has no OpenMP."""
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("chorenat: no g++ on the PATH")
    return cxx


def library_path(source=None, stem="chorenat"):
    """(compiler, path of the library for ``source`` (default ``SOURCE``),
    its flags and the host)."""
    source = SOURCE if source is None else source
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read())
    for part in (" ".join(CXX_FLAGS), version, _cpu_signature()):
        digest.update(part.encode())
    return cxx, os.path.join(BUILD_DIR,
                             f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source=None, stem="chorenat"):
    """Compile ``source`` (default ``SOURCE``) into a shared library if it
    is missing; returns its path. Raises with the compiler's output if the
    compile fails."""
    source = SOURCE if source is None else source
    cxx, lib = library_path(source, stem)
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{stem} build failed ({cxx} exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int32_p = ctypes.POINTER(ctypes.c_int32)
        lib.chorenat_bvh_build.restype = ctypes.c_void_p
        lib.chorenat_bvh_build.argtypes = [
            c_float_p, ctypes.c_int64, c_int32_p, ctypes.c_int64]
        lib.chorenat_bvh_free.argtypes = [ctypes.c_void_p]
        lib.chorenat_bvh_query.argtypes = [
            ctypes.c_void_p, c_float_p, ctypes.c_int64,
            c_float_p, c_int32_p, c_float_p]
        lib.chorenat_kdtree_build.restype = ctypes.c_void_p
        lib.chorenat_kdtree_build.argtypes = [c_float_p, ctypes.c_int64]
        lib.chorenat_kdtree_free.argtypes = [ctypes.c_void_p]
        lib.chorenat_kdtree_query.argtypes = [
            ctypes.c_void_p, c_float_p, ctypes.c_int64, c_float_p, c_int32_p]
        lib.chorenat_sample_surface.argtypes = [
            c_float_p, c_int32_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, c_float_p]
        lib.chorenat_chamfer.restype = ctypes.c_float
        lib.chorenat_chamfer.argtypes = [
            c_float_p, ctypes.c_int64, c_float_p, ctypes.c_int64]
        _lib = lib
    return _lib


def image_lib():
    """The library of ``csrc/image.cpp`` (built on first use): the JPEG
    reader's Huffman, IDCT, upsampling and colour stages
    (``data/imageio.py``) and the uint8 resize (``data/image_ops.py``).
    ctypes releases the GIL for each call."""
    global _image_lib
    with _lib_lock:
        if _image_lib is None:
            lib = ctypes.CDLL(build(IMAGE_SOURCE, "choreimage"))
            i64, ptr, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
            lib.jpeg_decode_scan.restype = i32
            lib.jpeg_decode_scan.argtypes = [ptr, i64, ptr, i64, i64, i64,
                                             i64, ptr, ptr, ptr, ptr]
            lib.jpeg_idct_islow.restype = None
            lib.jpeg_idct_islow.argtypes = [ptr, ptr, i64, i64, ptr]
            lib.jpeg_upsample.restype = None
            lib.jpeg_upsample.argtypes = [ptr, i64, i64, i32, i32, ptr, i64,
                                          i64]
            lib.jpeg_ycc_to_rgb.restype = None
            lib.jpeg_ycc_to_rgb.argtypes = [ptr, ptr, ptr, i64, ptr]
            lib.resize_u8.restype = None
            lib.resize_u8.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr,
                                      i64, ptr, ptr, ptr, ptr, i64, ptr]
            _image_lib = lib
    return _image_lib


def available() -> bool:
    """Whether the library is loaded or can be built here (the meaning of
    ``chore_tpu.native.available``, which ``BoundarySampler(backend=
    "auto")`` reads)."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class TriangleBVH:
    """AABB BVH over a triangle mesh with exact closest-point queries."""

    def __init__(self, verts, faces):
        self._lib = _load()
        self._verts = _f32(verts)
        self._faces = _i32(faces)
        self._h = self._lib.chorenat_bvh_build(
            _ptr(self._verts, ctypes.c_float), len(self._verts),
            _ptr(self._faces, ctypes.c_int32), len(self._faces))

    def query(self, points, want_faces=False, want_closest=False):
        """Unsigned distances (and optionally face indices / closest points)
        from each query point to the mesh."""
        pts = _f32(points)
        n = len(pts)
        dist = np.empty(n, np.float32)
        fidx = np.empty(n, np.int32) if want_faces else None
        closest = np.empty((n, 3), np.float32) if want_closest else None
        self._lib.chorenat_bvh_query(
            self._h, _ptr(pts, ctypes.c_float), n,
            _ptr(dist, ctypes.c_float),
            _ptr(fidx, ctypes.c_int32) if want_faces else None,
            _ptr(closest, ctypes.c_float) if want_closest else None)
        out = [dist]
        if want_faces:
            out.append(fidx)
        if want_closest:
            out.append(closest)
        return out[0] if len(out) == 1 else tuple(out)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chorenat_bvh_free(self._h)
            self._h = None


class PointKDTree:
    """KD-tree over a point set with batched 1-NN queries."""

    def __init__(self, points):
        self._lib = _load()
        self._pts = _f32(points)
        self._h = self._lib.chorenat_kdtree_build(
            _ptr(self._pts, ctypes.c_float), len(self._pts))

    def query(self, points):
        """(distances (N,), indices (N,)) of the nearest tree point."""
        pts = _f32(points)
        n = len(pts)
        dist = np.empty(n, np.float32)
        idx = np.empty(n, np.int32)
        self._lib.chorenat_kdtree_query(
            self._h, _ptr(pts, ctypes.c_float), n,
            _ptr(dist, ctypes.c_float), _ptr(idx, ctypes.c_int32))
        return dist, idx

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chorenat_kdtree_free(self._h)
            self._h = None


def point_mesh_udf(points, verts, faces):
    """(udf (N,), nearest_vertex_index (N,)): the host counterpart of
    ``ops.point_mesh.point_mesh_udf``."""
    udf = TriangleBVH(verts, faces).query(points)
    _, vidx = PointKDTree(verts).query(points)
    return udf, vidx


def sample_surface(verts, faces, n, seed=0):
    """Area-weighted surface sampling, deterministic in ``seed`` (a
    different stream from ``utils.meshio.sample_surface``)."""
    lib = _load()
    v, f = _f32(verts), _i32(faces)
    out = np.empty((n, 3), np.float32)
    lib.chorenat_sample_surface(
        _ptr(v, ctypes.c_float), _ptr(f, ctypes.c_int32), len(f), n,
        ctypes.c_uint64(seed), _ptr(out, ctypes.c_float))
    return out


def chamfer(a, b):
    """Bidirectional sqrt Chamfer, the sum of the two directional means."""
    lib = _load()
    aa, bb = _f32(a), _f32(b)
    return float(lib.chorenat_chamfer(
        _ptr(aa, ctypes.c_float), len(aa), _ptr(bb, ctypes.c_float),
        len(bb)))
