"""SMPL / SMPL-H model loading without chumpy (copy of
``chore_tpu/smpl/loader.py``; pure numpy).

The official model pickles store chumpy arrays; the reference drags in the
whole chumpy package just to unpickle them (reference:
lib_smpl/smplpytorch/smplpytorch/native/webuser/serialization.py:22-83). We
instead install a minimal stub unpickler that recovers the raw ndarrays, and
cache the result as npz so subsequent loads are instant.

Also provides a deterministic synthetic SMPL-H-shaped model so the full
pipeline is testable on machines without the (license-gated) model files.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from chore_tpu_torch.smpl.const import NUM_JOINTS_SMPLH, NUM_VERTS

# SMPL-H kinematic tree (parent of each of the 52 joints; 15 finger joints
# per hand chained off wrists 20/21). Model metadata shared by every SMPL-H
# release; real model files override this with their own kintree_table.
SMPLH_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    # left hand: 5 fingers x 3 joints, chained off wrist 20
    20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    # right hand: chained off wrist 21
    21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50,
)
SMPL_PARENTS = SMPLH_PARENTS[:22] + (20, 21)


class _Stub:
    """Catch-all stand-in for chumpy/scipy objects inside model pickles."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


class _ModelUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy") or module.startswith("scipy.sparse"):
            if module.startswith("scipy.sparse"):
                # real scipy is available; let it load sparse matrices
                try:
                    return super().find_class(module, name)
                except Exception:
                    return _Stub
            return _Stub
        return super().find_class(module, name)


def _to_array(x):
    """Extract a plain ndarray from chumpy stubs / scipy sparse / ndarray."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if isinstance(x, _Stub):
        for key in ("x", "a", "v"):
            if key in getattr(x, "__dict__", {}):
                return _to_array(x.__dict__[key])
        raise ValueError(f"cannot extract array from stub {x.__dict__.keys()}")
    return np.asarray(x)


def load_smpl_pickle(path):
    """Load a SMPL/SMPL-H model pickle into a dict of plain numpy arrays."""
    with open(path, "rb") as f:
        data = _ModelUnpickler(f, encoding="latin1").load()
    out = {
        "v_template": _to_array(data["v_template"]).astype(np.float32),
        "shapedirs": _to_array(data["shapedirs"]).astype(np.float32),
        "posedirs": _to_array(data["posedirs"]).astype(np.float32),
        "j_regressor": _to_array(data["J_regressor"]).astype(np.float32),
        "weights": _to_array(data["weights"]).astype(np.float32),
        "faces": np.asarray(data["f"]).astype(np.int32),
        "parents": np.asarray(data["kintree_table"])[0].astype(np.int32),
    }
    out["parents"][0] = -1
    return out


def load_model_arrays(model_root, gender="male", hands=True, num_betas=10):
    """Load (and npz-cache) the SMPL-H model arrays for a gender.

    Mirrors the file convention of the reference
    (lib_smpl/smplpytorch/.../smpl_layer.py:39-44): SMPLH_{gender}.pkl for
    hands=True, SMPL_{gender}.pkl otherwise.
    """
    name = f"SMPLH_{gender}" if hands else f"SMPL_{gender}"
    cache = os.path.join(model_root, f"{name}.converted.npz")
    pkl_path = os.path.join(model_root, f"{name}.pkl")
    cache_fresh = os.path.isfile(cache) and (
        not os.path.isfile(pkl_path)
        or os.path.getmtime(cache) >= os.path.getmtime(pkl_path)
    )
    if cache_fresh:
        data = dict(np.load(cache))
    else:
        data = load_smpl_pickle(pkl_path)
        try:
            np.savez(cache, **data)
        except OSError:
            pass  # read-only model dir: skip the cache
    data["shapedirs"] = data["shapedirs"][:, :, :num_betas]
    return data


def synthetic_smplh(num_betas=10, seed=0, num_verts=NUM_VERTS,
                    num_joints=NUM_JOINTS_SMPLH):
    """Deterministic synthetic SMPL-H-shaped model for tests/CI.

    Builds a vertically-extended point cloud with smooth skinning weights
    concentrated around joint heights, so LBS produces plausible deformations
    and all downstream shape contracts (6890 verts, 52 joints, 10 betas)
    hold without the license-gated model files.
    """
    rng = np.random.RandomState(seed)
    # body: vertical cylinder-ish cloud from y=-1.1 (feet) to y=0.6 (head)
    t = np.linspace(-1.1, 0.6, num_verts).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, num_verts).astype(np.float32)
    r = 0.15 + 0.05 * rng.rand(num_verts).astype(np.float32)
    v_template = np.stack(
        [r * np.cos(theta), t, r * np.sin(theta)], axis=1
    ).astype(np.float32)

    # 24-joint SMPL re-parents the two hand joints to the wrists; a plain
    # 52-joint prefix would chain joint 23 off joint 22
    chain = SMPL_PARENTS if num_joints == 24 else SMPLH_PARENTS[:num_joints]
    parents = np.array(chain, dtype=np.int32)
    # joint rest locations: spread over the body with children near parents
    joints = np.zeros((num_joints, 3), dtype=np.float32)
    joints[:, 1] = np.linspace(-0.9, 0.5, num_joints)
    joints[:, 0] = 0.05 * rng.randn(num_joints)

    # j_regressor: soft assignment of verts near each joint's height
    d = np.abs(v_template[None, :, 1] - joints[:, None, 1])  # (J, V)
    w = np.exp(-(d ** 2) / 0.01)
    j_regressor = (w / w.sum(1, keepdims=True)).astype(np.float32)

    # skinning weights: nearest-2-joint soft weights
    d2 = d.T  # (V, J)
    wts = np.exp(-(d2 ** 2) / 0.02)
    weights = (wts / wts.sum(1, keepdims=True)).astype(np.float32)

    shapedirs = (0.03 * rng.randn(num_verts, 3, num_betas)).astype(np.float32)
    posedirs = (0.001 * rng.randn(num_verts, 3, 9 * (num_joints - 1))).astype(
        np.float32
    )
    # simple triangulation over consecutive index triples (valid indices only)
    idx = np.arange(num_verts - 2, dtype=np.int32)
    faces = np.stack([idx, idx + 1, idx + 2], axis=1)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "j_regressor": j_regressor,
        "weights": weights,
        "faces": faces,
        "parents": parents,
    }
