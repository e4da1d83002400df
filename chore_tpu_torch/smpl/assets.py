"""Loaders for the port's vendored data assets (``chore_tpu_torch/assets``,
byte-identical copies of ``chore_tpu/assets``)."""
from __future__ import annotations

import functools
import os

import numpy as np

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


@functools.lru_cache()
def load_landmark_regressors(assets_dir=None):
    """Dense (K, 6890) landmark regressors: body25 (25), face (70), hand (42),
    densified once from the stored sparse triplets."""
    d = np.load(os.path.join(assets_dir or ASSETS_DIR, "landmark_regressors.npz"))
    out = {}
    for name in ["body25", "face", "hand"]:
        shape = tuple(d[f"{name}_shape"])
        m = np.zeros(shape, np.float32)
        m[d[f"{name}_rows"], d[f"{name}_cols"]] = d[f"{name}_vals"]
        out[name] = m
    return out


@functools.lru_cache()
def load_part_labels(assets_dir=None):
    """(6890,) int32 part label (14-way) per SMPL vertex."""
    d = np.load(os.path.join(assets_dir or ASSETS_DIR, "smpl_parts_dense.npz"))
    return d["labels"].astype(np.int32)


@functools.lru_cache()
def load_priors(assets_dir=None):
    """Body (63-dim) and GRAB hand (2x45-dim) Gaussian pose priors."""
    d = np.load(os.path.join(assets_dir or ASSETS_DIR, "priors.npz"))
    return {k: d[k] for k in d.files}
