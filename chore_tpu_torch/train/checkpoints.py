"""Training checkpoints in ``chore_tpu``'s format.

Counterpart of ``chore_tpu/train/checkpoints.py``: files
``checkpoint_{h}h:{m}m:{s}s_{secs}.ckpt`` under EXP/checkpoints/, flax
msgpack of {state: {params, opt_state}, epoch, training_time, global_step}
(``params`` the flax parameter tree, ``opt_state`` optax's
``inject_hyperparams`` state dict); a ``val_min={epoch}.npz`` pointer
[epoch, val_loss, file] names the best-validation checkpoint, which
loading prefers, else the newest by training time. Either package reads
what the other writes. Writes are the caller's to gate to the main
process.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from chore_tpu_torch.utils.msgpack import packb, unpackb


def _convert_secs(sec):
    return int(sec // 3600), int((sec // 60) % 60), int(sec % 60)


def checkpoint_name(training_time):
    h, m, s = _convert_secs(training_time)
    return f"checkpoint_{h}h:{m}m:{s}s_{training_time}.ckpt"


def save_checkpoint(ckpt_dir, state, training_time, epoch, global_step=0):
    """state: {params, opt_state} of numpy trees; returns the file name. A
    file of that name already there is kept (same training time, same
    checkpoint)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = checkpoint_name(training_time)
    path = os.path.join(ckpt_dir, name)
    if os.path.isfile(path):
        return name
    payload = {
        "state": state,
        "epoch": np.asarray(epoch),
        "training_time": np.asarray(training_time),
        "global_step": np.asarray(global_step),
    }
    with open(path, "wb") as f:
        f.write(packb(payload))
    return name


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


def update_val_min(exp_dir, epoch, val_loss, ck_file):
    """Keep the best-validation pointer: a newer checkpoint is accepted
    while val_loss <= best + 1.0 (the reference's preference for recent
    ones), and the pointer keeps the running minimum, so it cannot ratchet
    upward in steps of 1.0. Returns whether the pointer moved."""
    best = val_loss
    pointer = glob.glob(os.path.join(exp_dir, "val_min=*"))
    if pointer:
        log = np.load(pointer[0], allow_pickle=True)
        arr = log["data"] if hasattr(log, "files") else log
        stored = float(arr[1])
        if stored + 1.0 < val_loss:
            return False
        best = min(val_loss, stored)
        for p in pointer:
            os.remove(p)
    path = os.path.join(exp_dir, f"val_min={epoch}.npz")
    np.savez(path, data=np.array([epoch, best, ck_file], dtype=object))
    return True
