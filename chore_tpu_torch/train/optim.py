"""The trainer's optimizers, computing optax's updates, and their state in
optax's ``inject_hyperparams`` layout.

``chore_tpu`` trains with ``optax.inject_hyperparams(opt)(learning_rate)``
for opt in adam, adadelta, rmsprop at their defaults. torch's Adam (b1
0.9, b2 0.999, eps 1e-8 outside the root) and Adadelta (rho 0.9, eps 1e-6,
the step scaled by the LR) compute the same updates; optax's rmsprop
(decay 0.9, eps 1e-8 INSIDE the root, no momentum) is not torch's RMSprop
(alpha 0.99, eps outside), so it is written here. ``optax_state`` and
``load_optax_state`` move the moments to and from the state dict optax's
state serializes to, so a checkpoint resumes in either package.
"""
from __future__ import annotations

import numpy as np
import torch

from chore_tpu_torch.models.convert import params_from_jax, params_to_jax

OPTIMIZERS = ("adam", "adadelta", "rmsprop")
# optax's hyperparameters of each optimizer at its defaults (the LR apart)
_HYPER = {"adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
          "adadelta": dict(eps=1e-6, rho=0.9, weight_decay=0.0),
          "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0)}
# torch state key -> (index in optax's chain state, optax field)
_SLOTS = {"adam": (("exp_avg", "0", "mu"), ("exp_avg_sq", "0", "nu")),
          "adadelta": (("square_avg", "1", "e_g"),
                       ("acc_delta", "1", "e_x")),
          "rmsprop": (("nu", "0", "nu"),)}
_CHAIN = {"adam": 2, "adadelta": 3, "rmsprop": 3}


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop at its defaults: nu = decay nu + (1 - decay) g^2,
    p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                nu = st["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]),
                       alpha=-group["lr"])


def _f32(x):
    return float(np.float32(x))


def make_optimizer(name, params, lr):
    """The optimizer ``chore_tpu``'s Trainer builds for ``name``. Its
    hyperparameters are float32, as ``inject_hyperparams`` holds them
    (1 - float32(0.999) is 1.3e-5 away from 0.001)."""
    h = {k: _f32(v) for k, v in _HYPER.get(name, {}).items()}
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(h["b1"], h["b2"]),
                                eps=h["eps"])
    if name == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=h["rho"],
                                    eps=h["eps"])
    if name == "rmsprop":
        return RMSprop(params, lr=lr, decay=h["decay"], eps=h["eps"])
    raise ValueError(f"optimizer must be one of {OPTIMIZERS}: {name!r}")


def set_lr(opt, lr):
    for group in opt.param_groups:
        group["lr"] = _f32(lr)


def step_count(opt):
    """Optimizer steps taken (optax's one count; torch keeps one per
    parameter, all equal here)."""
    steps = [int(st["step"]) for st in opt.state.values() if "step" in st]
    return max(steps, default=0)


def optax_state(opt, name, named_params):
    """The optimizer's state as the state dict of optax's
    ``inject_hyperparams(name)`` state (numpy leaves): count,
    hyperparams, and the moments as flax trees. ``named_params``: [(torch
    name, parameter)] of the trained parameters."""
    count = np.asarray(step_count(opt), np.int32)
    hyper = {k: np.asarray(v, np.float32) for k, v in _HYPER[name].items()}
    hyper["learning_rate"] = np.asarray(opt.param_groups[0]["lr"], np.float32)
    inner = {str(i): {} for i in range(_CHAIN[name])}
    names = [n for n, _ in named_params]
    for key, slot, field in _SLOTS[name]:
        moments = {n: opt.state[p][key] if key in opt.state[p]
                   else torch.zeros_like(p) for n, p in named_params}
        inner[slot][field] = params_to_jax(moments, names)
    if name == "adam":
        inner["0"] = {"count": count, **inner["0"]}
    return {"count": count, "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": inner}


def load_optax_state(opt, name, named_params, tree):
    """Set the optimizer's moments and step count from an optax state dict
    (``optax_state``'s layout, e.g. read from a ``chore_tpu``
    checkpoint). The LR stays the caller's (the schedule's)."""
    inner = tree["inner_state"]
    hyper = set(tree["hyperparams"])
    if hyper != set(_HYPER[name]) | {"learning_rate"}:
        raise ValueError(f"checkpoint optimizer state ({sorted(hyper)}) is "
                         f"not {name}'s")
    count = int(np.asarray(inner["0"]["count"] if name == "adam"
                           else tree["count"]))
    moments = {key: params_from_jax(inner[slot][field])
               for key, slot, field in _SLOTS[name]}
    for n, p in named_params:
        st = {"step": torch.tensor(float(count))}
        for key in moments:
            st[key] = moments[key][n].to(p.device, p.dtype)
        opt.state[p] = st
