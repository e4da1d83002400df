"""Weights between ``chore_tpu``'s flax parameter tree and this port.

``params_from_jax`` inverts ``chore_tpu/train/torch_import.py``'s mapping
(``_torch_key``/``_convert_leaf``, copied here, not imported): flax conv
kernels (kH, kW, I, O) become OIHW (a grouped conv's (kH, kW, I/G, O)
becomes torch's (O, I/G, kH, kW) by the same transpose), decoder Dense kernels (I, O) become
Conv1d (O, I, 1), GroupNorm ``scale`` becomes ``weight``. The result uses the
reference torch names, so the same state dict also describes a reference
``.tar`` checkpoint, which ``load_reference_checkpoint`` reads.
``params_to_jax`` is the way back; optimizer moments, which are shaped
like their parameters, map the same way.
"""
from __future__ import annotations

import numpy as np
import torch

# flax decoder module name -> torch attribute name
_DECODER_NAMES = {
    "df": "df",
    "pca": "pca_predictor",
    "parts": "part_predictor",
    "centers": "center_predictor",
}
# flax Dense layer name -> index in the torch nn.Sequential
_FC_INDEX = {"fc0": "0", "fc1": "2", "fc2": "4", "fc_out": "6"}


def _torch_key(path):
    """flax param path (tuple of names, leaf last) -> torch state-dict key."""
    *mods, leaf = path
    mods = list(mods)
    if mods and mods[0] in _DECODER_NAMES:
        mods[0] = _DECODER_NAMES[mods[0]]
        mods[1] = _FC_INDEX[mods[1]]
    if mods and mods[-1] == "downsample":
        mods[-1] = "downsample.2"
    suffix = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join(mods + [suffix])


def _torch_leaf(path, arr):
    if torch.is_tensor(arr):  # e.g. a bfloat16 checkpoint leaf
        arr = arr.float().numpy()
    a = np.asarray(arr, np.float32)
    if path[-1] == "kernel":
        if a.ndim == 4:  # (kH, kW, I, O) -> (O, I, kH, kW)
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:  # Dense (I, O) -> Conv1d (O, I, 1)
            a = a.T[..., None]
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def params_from_jax(flax_params):
    """flax params (nested dicts of arrays, optionally under "params") ->
    a state dict that ``CHOREField.load_state_dict`` accepts strictly.

    Also fills what the reference constructor has and flax does not: the
    ``downsample.0`` alias of each width-changing block's ``bn4``, and the
    unused ``bn4`` (weight 1, bias 0) of every equal-width ConvBlock."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    sd = {_torch_key(p): _torch_leaf(p, v) for p, v in _leaves(flax_params)}
    for key in list(sd):
        block = key[:-len("bn3.weight")]
        # a ConvBlock is what has bn3 beside conv3 (the stem has neither)
        if (key.endswith("bn3.weight") and block in ("", block.rstrip(".") + ".")
                and block + "conv3.weight" in sd):
            if block + "bn4.weight" not in sd:
                bn1 = sd[block + "bn1.weight"]
                sd[block + "bn4.weight"] = torch.ones_like(bn1)
                sd[block + "bn4.bias"] = torch.zeros_like(bn1)
            if block + "downsample.2.weight" in sd:
                sd[block + "downsample.0.weight"] = sd[block + "bn4.weight"]
                sd[block + "downsample.0.bias"] = sd[block + "bn4.bias"]
    return sd


_FLAX_DECODER = {v: k for k, v in _DECODER_NAMES.items()}
_FLAX_FC = {v: k for k, v in _FC_INDEX.items()}


def trained_names(state_dict):
    """The keys of ``state_dict`` that are parameters of ``chore_tpu``'s
    field, in order: without the ``downsample.0`` alias of ``bn4`` and
    without the ``bn4`` of ConvBlocks that keep their width (the reference
    constructs it; nothing uses it)."""
    out = []
    for k in state_dict:
        if ".downsample.0." in k:
            continue
        head, bn4, _ = k.rpartition(".bn4.")
        if bn4 and head + ".downsample.2.weight" not in state_dict:
            continue
        out.append(k)
    return out


def _flax_path(key):
    """torch state-dict key -> flax param path (inverse of _torch_key)."""
    *mods, leaf = key.split(".")
    if mods[0] in _FLAX_DECODER:
        mods[0] = _FLAX_DECODER[mods[0]]
        mods[1] = _FLAX_FC[mods[1]]
    if len(mods) > 1 and mods[-2] == "downsample" and mods[-1] == "2":
        mods = mods[:-1]
    return tuple(mods), leaf


def params_to_jax(state_dict, names=None):
    """A state dict of the port (tensors) -> ``chore_tpu``'s flax params
    ``{"params": {...}}`` with numpy float32 leaves: conv weights OIHW ->
    (kH, kW, I, O), decoder Conv1d (O, I, 1) -> Dense (I, O), GroupNorm
    ``weight`` -> ``scale``. ``names``: the keys to map (default
    ``trained_names``). Any tensor shaped like the named parameter (its
    gradient, an optimizer moment) maps the same way."""
    names = trained_names(state_dict) if names is None else names
    tree = {}
    for key in names:
        a = state_dict[key]
        a = (a.detach().float().cpu().numpy() if torch.is_tensor(a)
             else np.asarray(a, np.float32))
        mods, leaf = _flax_path(key)
        if leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif a.ndim == 3:
                leaf, a = "kernel", a[..., 0].T
            else:
                leaf = "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a, np.float32)
    return {"params": tree}


def strip_ddp(state_dict):
    """Drop the ``module.`` prefix DistributedDataParallel adds."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def load_reference_checkpoint(path):
    """State dict of a reference ``checkpoint_*.tar`` (or a bare state
    dict file), ready for ``CHOREField.load_state_dict``."""
    data = torch.load(path, map_location="cpu")
    sd = data.get("model_state_dict", data) if isinstance(data, dict) else data
    return strip_ddp(sd)
