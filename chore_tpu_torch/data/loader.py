"""Batch collation of prepared frames (counterpart of ``collate`` in
``chore_tpu/data/loader.py``; the threaded loader comes with training)."""
from __future__ import annotations

import numpy as np


def collate(items):
    """List of dicts -> dict of stacked arrays (non-array values listed)."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or (
            np.isscalar(vals[0]) and not isinstance(vals[0], str)
        ):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out
