"""Adam phase runner for the fitting loops.

Counterpart of ``chore_tpu/recon/optimize.py``; the JAX ``while_loop``/``scan``
become Python loops, with these semantics kept exactly:
  * Adam as ``optax.adam`` defines it (b1 0.9, b2 0.999, eps 1e-8, bias
    correction from one step count per phase);
  * frozen parameters get no update and no moment update (``optax``'s
    ``multi_transform`` + ``set_to_zero``);
  * a step whose update input is not finite is skipped entirely, optimizer
    state included (``apply_if_finite``); the input checked is the running
    gradient sum, over every parameter, frozen ones too;
  * inner step j applies Adam to the SUM of the gradients of steps 0..j of
    its outer iteration (the reference zeroes gradients once per outer
    iteration);
  * the plateau test runs after every step, gated by the phase-local
    iteration, with ``prev_loss`` carried in from the previous phase; the
    test is computed in float32 like the JAX package's.
One ``run_phase`` is one reference optimizer lifetime.

Under a data-parallel ``mesh`` each rank optimizes its own frames' parameters
and ``loss_fn`` returns its share of the global batch's loss; each step sums
the shares and the non-finite flags over the ranks (``all_sum`` of the one
small tensor the step reads back to the host; the identity with one
process), so the finite skip and the plateau stop act on the global values
and every rank runs the same steps and collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from chore_tpu_torch.parallel.mesh import all_sum

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One optimization phase.

    Attributes:
      lr: Adam learning rate.
      n_iters: max outer iterations.
      steps_per_iter: grad steps per iteration.
      trainable: {param name: bool} (True = optimized); None = all.
      early_stop_min_iter: phase-local iteration after which the plateau
        stop may fire (it > gate); None disables it. May be negative
        (always open). The reference gates on a global iteration counter,
        which callers translate to this local one.
      early_stop_rel: plateau threshold factor
        (|prev - loss| / prev < prev * early_stop_rel).
    """

    lr: float
    n_iters: int
    steps_per_iter: int = 10
    trainable: object = None
    early_stop_min_iter: Optional[float] = None
    early_stop_rel: float = 1e-3


def run_phase(loss_fn, params, spec: PhaseSpec, generator=None,
              prev_loss=300.0, record=False, mesh=None):
    """Run one phase.

    Args:
      loss_fn: (params, it, generator) -> (total_loss, aux_dict); ``it`` is
        the phase-local outer iteration (int).
      params: {name: tensor}; not modified (the phase works on copies).
      spec: PhaseSpec.
      generator: torch.Generator handed to ``loss_fn`` (SVD jitter).
      prev_loss: plateau-reference loss entering the phase.
      record: also return the per-step loss trace.
      mesh: optional ``parallel.Mesh``; ``loss_fn`` then returns this
        rank's share of the global loss, and the loss and the finite check
        are the global batch's.

    Returns:
      (params, final_loss, n_iters_run), plus, when ``record``, a trace
      {"loss": (n_iters, steps) f32, "live": (n_iters, steps) bool}: the
      loss evaluated (pre-update) at each step, and whether the step ran
      before the early stop (stopped steps repeat the last loss).
    """
    names = list(params)
    mask = spec.trainable or {k: True for k in names}
    train = [k for k in names if mask[k]]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(p[k]) for k in train}
    nu = {k: torch.zeros_like(p[k]) for k in train}
    count = 0

    stop_gate = spec.early_stop_min_iter
    rel_f = np.float32(spec.early_stop_rel)

    prev = np.float32(prev_loss)
    done = False
    n_run = 0
    loss_tr = np.zeros((spec.n_iters, spec.steps_per_iter), np.float32)
    live_tr = np.zeros((spec.n_iters, spec.steps_per_iter), bool)
    for it in range(spec.n_iters):
        if done and not record:
            break
        n_run += int(not done)
        gsum = {k: torch.zeros_like(p[k]) for k in names}  # zero_grad()
        for j in range(spec.steps_per_iter):
            was_live = not done
            if not done:
                with torch.enable_grad():
                    loss, _ = loss_fn(p, it, generator)
                    grads = torch.autograd.grad(
                        loss, [p[k] for k in names], allow_unused=True)
                with torch.no_grad():
                    for k, g in zip(names, grads):
                        if g is not None:
                            gsum[k] = gsum[k] + g
                    finite = torch.stack(
                        [torch.isfinite(gsum[k]).all() for k in names]).all()
                    loss_v, bad = all_sum(torch.stack(
                        [loss.detach().float(), (~finite).float()]),
                        mesh).tolist()
                    if bad == 0:
                        count += 1
                        bc1 = np.float32(1) - np.float32(_B1) ** np.float32(count)
                        bc2 = np.float32(1) - np.float32(_B2) ** np.float32(count)
                        for k in train:
                            g = gsum[k]
                            mu[k] = (1 - _B1) * g + _B1 * mu[k]
                            nu[k] = (1 - _B2) * (g * g) + _B2 * nu[k]
                            upd = (mu[k] / float(bc1)) / (
                                torch.sqrt(nu[k] / float(bc2)) + _EPS)
                            p[k].add_(upd * -spec.lr)
                loss_f = np.float32(loss_v)
                if stop_gate is not None:
                    rel = np.abs(prev - loss_f) / np.maximum(prev,
                                                            np.float32(1e-9))
                    done = bool(rel < prev * rel_f) and it > stop_gate
                prev = loss_f
            loss_tr[it, j] = prev
            live_tr[it, j] = was_live
    out = {k: v.detach() for k, v in p.items()}
    if record:
        return out, float(prev), n_run, {"loss": loss_tr, "live": live_tr}
    return out, float(prev), n_run


def freeze_all_except(params, *names):
    """Trainable mask: only the keys in ``names``."""
    return {k: k in names for k in params}
