"""Per-step records of a training run, and the port's parameter groups.

``record_steps(Trainer, sink)`` wraps a trainer class's ``train_step``
(the JAX package's or the port's: both return ``(loss, parts)`` and keep
``global_step``, ``epoch`` and ``lr_fn``) so that each step calls
``sink(trainer, batch, loss, parts)``. ``trace_to(Trainer, path)``
records the training study's traces with it, one JSON line a step:

  {"step", "epoch", "lr", "loss", <the six terms>, "points_sum",
   "images_sum"}

``points_sum`` / ``images_sum`` are the batch's float64 / integer sums,
so two traces show whether their runs saw the same batches.

``group_of`` / ``by_group`` sort the port's parameter names into the
groups that the step comparisons report: the stem, each stack, each
head. Nothing here imports JAX."""
import contextlib
import json

import numpy as np


@contextlib.contextmanager
def record_steps(trainer_cls, sink):
    """Call ``sink(trainer, batch, loss, parts)`` after every
    ``trainer_cls.train_step`` made inside the block."""
    orig = trainer_cls.train_step

    def train_step(self, batch):
        loss, parts = orig(self, batch)
        sink(self, batch, loss, parts)
        return loss, parts

    trainer_cls.train_step = train_step
    try:
        yield
    finally:
        trainer_cls.train_step = orig


@contextlib.contextmanager
def trace_to(trainer_cls, path):
    """Inside the block, write one JSON line to ``path`` (anew) for every
    ``trainer_cls.train_step``."""
    with open(path, "w") as f:
        def sink(trainer, batch, loss, parts):
            f.write(json.dumps({
                "step": trainer.global_step, "epoch": trainer.epoch,
                "lr": float(trainer.lr_fn(trainer.epoch)),
                "loss": float(loss),
                **{k: float(v) for k, v in parts.items()},
                "points_sum": float(np.asarray(batch["points"],
                                               np.float64).sum()),
                "images_sum": int(np.asarray(batch["images"]).sum(
                    dtype=np.int64))}) + "\n")
            f.flush()

        with record_steps(trainer_cls, sink):
            yield


def read_trace(path):
    """A trace file's lines as a list of dicts, in step order."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def group_of(name):
    """A port parameter's group: ``stem``, ``stack<i>`` or a head."""
    mod, _, rest = name.partition(".")
    if mod != "image_filter":
        return mod
    sub = rest.split(".")[0]
    if sub.startswith(("conv1", "conv2", "conv3", "conv4", "bn1")):
        return "stem"
    return "stack" + sub.rstrip("_")[-1]


def by_group(arrays, fn):
    """{group: sum over its arrays of fn(name, array)}."""
    out = {}
    for name, a in arrays.items():
        g = group_of(name)
        out[g] = out.get(g, 0) + fn(name, a)
    return out
