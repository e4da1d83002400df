"""Reading ``chore_tpu`` training checkpoints.

Counterpart of the reading half of ``chore_tpu/train/checkpoints.py``:
files ``checkpoint_{h}h:{m}m:{s}s_{secs}.ckpt`` under EXP/checkpoints/,
flax msgpack of {state: {params, opt_state}, epoch, training_time,
global_step}; a ``val_min={epoch}.npz`` pointer [epoch, val_loss, file]
names the best-validation checkpoint, which loading prefers, else the
newest by training time. Writing checkpoints comes with training.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from chore_tpu_torch.utils.msgpack import unpackb


def _latest_checkpoint(ckpt_dir):
    files = glob.glob(os.path.join(ckpt_dir, "checkpoint_*.ckpt"))
    if not files:
        return None
    times = [float(os.path.splitext(os.path.basename(p))[0].split("_")[-1])
             for p in files]
    return files[int(np.argmax(times))]


def find_checkpoint(exp_dir, prefer="val_min"):
    """prefer='val_min': the best-validation pointer first, else the
    latest; prefer='latest': the newest checkpoint."""
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if prefer == "val_min":
        pointer = glob.glob(os.path.join(exp_dir, "val_min=*"))
        if pointer:
            # the pointer is an object array written by the package's own
            # trainer (chore_tpu.train.checkpoints.update_val_min)
            log = np.load(pointer[0], allow_pickle=True)
            arr = log["data"] if hasattr(log, "files") else log
            path = os.path.join(ckpt_dir, str(arr[2]))
            if os.path.isfile(path):
                return path
    return _latest_checkpoint(ckpt_dir)


def load_checkpoint(path):
    """-> (state, epoch, training_time, global_step); ``state`` is the
    nested dict of the checkpoint (``state["params"]`` the flax parameter
    tree, numpy leaves). A payload without global_step gives 0."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    if not (isinstance(payload, dict) and "state" in payload
            and "epoch" in payload and "training_time" in payload):
        raise ValueError(f"{path}: not a chore_tpu checkpoint payload")
    return (payload["state"], int(payload["epoch"]),
            float(payload["training_time"]),
            int(payload.get("global_step", 0)))
