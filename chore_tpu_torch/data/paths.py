"""Path configuration and test-image discovery.

Counterpart of ``chore_tpu/data/paths.py``: machine paths come from a
``PATHS.yml`` (the argument, ``$CHORE_TPU_PATHS``, the working directory,
then the repository root), test frames are discovered per sequence with
optional occlusion filtering, and the FrankMocap / openpose sidecar files
are read. ``PATHS.yml`` is read by a parser of the flat ``KEY: value  #
comment`` form that ``PATHS.yml.example`` uses (no YAML library is
installed where the port runs); anything else in the file raises.
Training splits are read from a pickle or npz file.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import re
from glob import glob

import numpy as np

from chore_tpu_torch.data.imageio import read_gray

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.-]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _scalar(text, where):
    """A plain or quoted YAML scalar (comments already removed from a plain
    one); the typed forms yaml.safe_load reads (null, booleans, ints,
    floats) come back typed."""
    if not text:
        return None
    if text[0] in "&*!|>[{%@`" or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: unsupported YAML value {text!r} (only "
                         "flat 'KEY: value' lines are read)")
    low = text.lower()
    if low in ("null", "~"):
        return None
    if low in ("true", "false"):
        return low == "true"
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _value(text, where):
    """The value part of a line: a quoted string (no escapes), or a plain
    scalar up to a `` #`` comment."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        q = text[0]
        end = text.find(q, 1)
        rest = text[end + 1:].strip() if end > 0 else ""
        if end < 0 or (rest and not rest.startswith("#")) or (
                q == '"' and "\\" in text[1:end]):
            raise ValueError(f"{where}: unsupported quoted scalar {text!r}")
        return text[1:end]
    if text.startswith("#"):
        return None
    return _scalar(re.sub(r"\s#.*$", "", text).strip(), where)


def parse_flat_yaml(text, name="PATHS.yml"):
    """``KEY: value  # comment`` lines -> dict. Raises ValueError on
    anything else YAML allows (nesting, lists, anchors, flow or block
    scalars, documents), so a file in another form is never misread."""
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0].isspace():
            raise ValueError(f"{where}: nested YAML is not supported (only "
                             "flat 'KEY: value' lines are read)")
        m = _KEY.match(line.rstrip())
        if m is None:
            raise ValueError(f"{where}: not a flat 'KEY: value' line: "
                             f"{line!r}")
        key, value = m.group(1), m.group(2)
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        out[key] = None if value is None else _value(value, where)
    return out


@functools.lru_cache()
def load_paths(path=None):
    """Load PATHS.yml: keys BEHAVE_PATH, PROCESSED_PATH, RECON_PATH,
    SMPL_MODEL_ROOT, SMPL_ASSETS_ROOT (optional)."""
    candidates = [
        path,
        os.environ.get("CHORE_TPU_PATHS"),
        os.path.join(os.getcwd(), "PATHS.yml"),
        os.path.join(os.path.dirname(__file__), "..", "..", "PATHS.yml"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            with open(c) as f:
                return parse_flat_yaml(f.read(), c)
    return {}


class DataPaths:
    """Split loading and test-image discovery."""

    @staticmethod
    def load_splits(split_file, processed_path=None):
        """-> (train_paths, val_paths) of preprocessed npz files, from the
        "train" and "test" lists of a ``.pkl`` (the user's own split
        file) or ``.npz``; relative paths are under ``processed_path``,
        else PATHS.yml's PROCESSED_PATH."""
        if split_file.endswith(".pkl"):
            with open(split_file, "rb") as f:
                data = pickle.load(f)
        else:
            data = dict(np.load(split_file, allow_pickle=True))
        train, val = list(data["train"]), list(data["test"])
        root = processed_path or load_paths().get("PROCESSED_PATH")
        if root:
            train = [os.path.join(root, str(p)) for p in train]
            val = [os.path.join(root, str(p)) for p in val]
        return train, val

    @staticmethod
    def get_image_paths_seq(seq_folder, tid=1, check_occlusion=False,
                            occ_thres=0.3):
        """All k{tid}.color.jpg frames of a sequence, sorted; optionally
        drop frames whose object is mostly occluded (visible/full mask
        ratio <= occ_thres)."""
        files = sorted(glob(os.path.join(seq_folder, "*",
                                         f"k{tid}.color.jpg")))
        if not check_occlusion:
            return files
        keep = []
        for f in files:
            vis = f.replace(".color.jpg", ".obj_rend_mask.jpg")
            full = f.replace(".color.jpg", ".obj_rend_full.jpg")
            if not (os.path.isfile(vis) and os.path.isfile(full)):
                keep.append(f)
                continue
            mv, mf = read_gray(vis), read_gray(full)
            full_area = float((mf > 127).sum())
            if full_area == 0:
                continue
            if (mv > 127).sum() / full_area > occ_thres:
                keep.append(f)
        return keep


def load_mocap(json_file):
    """FrankMocap pose (72,) + betas (10,)."""
    with open(json_file) as f:
        params = json.load(f)
    return (np.asarray(params["pose"], np.float32),
            np.asarray(params["betas"], np.float32))


def load_kpts_json(json_file, tol=0.3):
    """Openpose body25 keypoints (25, 3); confidence < tol zeroed."""
    with open(json_file) as f:
        data = json.load(f)
    j2d = np.asarray(data["body_joints"], np.float32).reshape(-1, 3)
    j2d[:, 2] = np.where(j2d[:, 2] < tol, 0.0, j2d[:, 2])
    return j2d
