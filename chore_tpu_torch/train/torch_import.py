"""Continuing training from a reference PyTorch checkpoint: the
counterpart of ``chore_tpu/train/torch_import.py``.

The port's field has the reference's parameter names, so the weights load
as they are (``models/convert.py``). What needs mapping is the Adam
state: torch.optim keys it by the parameter's position in
``model.parameters()``, and this module turns those positions into names.
"""
from __future__ import annotations

import torch

from chore_tpu_torch.models.convert import strip_ddp


def load_torch_checkpoint(path):
    """The dict of a reference ``checkpoint_*.tar`` (a bare state-dict
    file becomes ``{"model_state_dict": ...}``), its model state dict
    without DistributedDataParallel's ``module.`` prefix."""
    data = torch.load(path, map_location="cpu")
    if not (isinstance(data, dict) and "model_state_dict" in data):
        data = {"model_state_dict": data}
    return {**data, "model_state_dict": strip_ddp(data["model_state_dict"])}


def parameter_names(state_dict):
    """The state dict's keys in ``model.parameters()`` order: the
    registration order without duplicate tensors. The only shared tensor
    of the reference field is ConvBlock's ``bn4``, registered again as
    ``downsample.0``, and the field has no buffers, so dropping that alias
    gives the order."""
    return [k for k in state_dict if ".downsample.0." not in k]


def adam_state_by_name(data):
    """The torch Adam state of ``data`` (``load_torch_checkpoint``'s) by
    parameter name: ({name: (exp_avg, exp_avg_sq) or None}, the step
    count, the names without state). A parameter that never had a
    gradient (DistributedDataParallel with unused parameters) has no
    state; optax keeps one count where torch keeps one per parameter, so
    the count is the largest."""
    names = parameter_names(data["model_state_dict"])
    opt = data["optimizer_state_dict"]
    order = [i for g in opt["param_groups"] for i in g["params"]]
    if len(order) != len(names):
        raise ValueError(
            f"optimizer tracks {len(order)} params but the model state "
            f"dict has {len(names)} parameter entries")
    by_name, count = {}, 0
    for name, i in zip(names, order):
        st = opt["state"].get(i)
        by_name[name] = None if st is None else (st["exp_avg"],
                                                  st["exp_avg_sq"])
        if st is not None:
            count = max(count, int(st["step"]))
    missing = [n for n, st in by_name.items() if st is None]
    return by_name, count, missing
