"""Build and load the port's hand-written CUDA kernels.

Each source under ``chore_tpu_torch/csrc/`` exposes a plain C entry point.
It is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``chore_tpu_torch/_build/`` at first use and loaded with ``ctypes``;
nothing includes PyTorch's headers, so a build takes seconds. The library
name carries a hash of the source and flags, so an edited source is rebuilt
and a stale library is never loaded. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them. Building and loading are
thread-safe (the evaluator calls kernels from a thread pool): one lock per
process, and each build writes a temporary file unique to its process and
thread before ``os.replace`` publishes it, so no caller loads a
half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source file under csrc/
SOURCES = {"nn_grouped": "nn_grouped.cu", "silhouette": "silhouette.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_lock = threading.RLock()
# nvcc's resource report (registers, shared memory, spills) per kernel
build_log: dict = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name):
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all(names=None):
    """Compile every kernel whose library is missing, all ``nvcc`` runs in
    parallel. Returns {name: seconds} (0.0 when already built); raises with
    nvcc's output if any compile fails."""
    with _lock:
        return _build_all(list(SOURCES) if names is None else list(names))


def _build_all(names):
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, secs = {}, {}
    nvcc = None
    for name in names:
        src, lib = _library_path(name)
        if os.path.isfile(lib):
            secs[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    errors = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return secs


def load(name):
    """The kernel's ctypes library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(_library_path(name)[1])
                _loaded[name] = lib
    return lib
