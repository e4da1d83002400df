"""BEHAVE sequence metadata (counterpart of ``SeqInfo`` in
``chore_tpu/behave/readers.py``, the part the entry points read; the
calibration paths and the Kinect frame and depth readers come with the
evaluation and preprocessing slices)."""
from __future__ import annotations

import json
from os.path import join


class SeqInfo:
    """Sequence metadata from SEQ/info.json: object category and gender."""

    def __init__(self, seq_path):
        with open(join(seq_path, "info.json")) as f:
            self.info = json.load(f)

    def get_obj_name(self, convert=False):
        cat = self.info["cat"]
        if convert:
            if "chair" in cat:
                return "chair"
            if "ball" in cat:
                return "sports ball"
        return cat

    def get_gender(self):
        return self.info["gender"]
