"""Nearest-neighbour squared distances with exact gradients.

Counterpart of ``chore_tpu/ops/chamfer.py::nn_sqdist`` on its TPU route
(``nn_sqdist_exact_grad``, ``chore_tpu/ops/pallas/nn.py:151-169``): the
grouped 1-NN (kernel on the card, plain version on the CPU) runs on detached
inputs and gives the index; the distance is then re-expressed as
``|x - y[idx]|^2`` so autograd yields the exact min-distance gradient with
respect to both clouds. Queries the kernel found no match for keep the 1e10
sentinel (zero gradient). ``vmap`` over examples becomes the kernel's batch
dimension. ``nn_sqdist_multi`` runs several such calls through one kernel
launch.
"""
from __future__ import annotations

import torch

from chore_tpu_torch.ops.nn import BIG, group_rows, nn_grouped_multi


def nn_sqdist_multi(calls):
    """Several ``nn_sqdist`` calls, each a dict of its keyword arguments
    (x, y, y_mask, x_group, y_group), through one kernel launch on the card
    (the plain version per call on the CPU). Calls over the same x and y
    tensors share their detached copies, so the kernel can scan such a
    grouped and ungrouped pair once. Returns [(sqdist, index)]."""
    detached = {}

    def prep(t):
        if id(t) not in detached:
            detached[id(t)] = t.detach().contiguous()
        return detached[id(t)]

    problems = []
    for c in calls:
        xd, yd = prep(c["x"]), prep(c["y"])
        problems.append((xd, yd, *group_rows(
            xd, yd, c.get("y_mask"), c.get("x_group"), c.get("y_group"))))
    out = []
    for c, (d_kern, idx) in zip(calls, nn_grouped_multi(problems)):
        x, y = c["x"], c["y"]
        y_nn = torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))
        d = ((x - y_nn) ** 2).sum(-1)
        d = torch.where(d_kern >= 0.5 * BIG, torch.full_like(d, BIG), d)
        out.append((d, idx))
    return out


def nn_sqdist(x, y, y_mask=None, x_group=None, y_group=None):
    """Per-point (optionally grouped) nearest-neighbour sq distance + index.

    Args:
      x: (B, N, 3) query points.
      y: (B, M, 3) reference points.
      y_mask: optional (B, M) bool; masked-out references are ignored.
      x_group / y_group: optional (B, N) / (B, M) integer group ids; a query
        only matches references of its own group.

    Returns:
      (sqdist (B, N), index (B, N) int64); sqdist is the 1e10 sentinel (and
      the index 0) where no valid same-group reference exists.
    """
    return nn_sqdist_multi([dict(x=x, y=y, y_mask=y_mask, x_group=x_group,
                                 y_group=y_group)])[0]


def chamfer_eval_multi(pairs):
    """``chamfer_eval`` of several (x, y) pairs through one ``nn_sqdist_multi``
    call (one kernel launch on the card for all 2 x len(pairs) directions).
    Each x (..., N, 3), y (..., M, 3); returns [chamfer (...,)] in order.

    Each pair is first moved by the same offset, minus x's centroid: the
    distance is translation-invariant, and the kernel's f32 expansion
    |x|^2 - 2x.y + |y|^2 cancels far less about the origin. At z ~ 2 m
    (|x|^2 ~ 4) its ~1e-6 error in a squared distance is ~4% of the squared
    distance of samples 5 mm apart, enough to pick a farther neighbour and
    bias a 7.7 mm object Chamfer up by ~1.3e-4 relative; centred, the
    evaluator's errors lie within 7e-7 relative of a float64 oracle
    (measured on the CPU at 10,000 samples)."""
    calls, shapes = [], []
    for x, y in pairs:
        lead = x.shape[:-2]
        x3, y3 = x.reshape(-1, *x.shape[-2:]), y.reshape(-1, *y.shape[-2:])
        c = x3.mean(dim=1, keepdim=True)
        x3, y3 = x3 - c, y3 - c
        calls += [dict(x=x3, y=y3), dict(x=y3, y=x3)]
        shapes.append(lead)
    out = nn_sqdist_multi(calls)
    res = []
    for k, lead in enumerate(shapes):
        dx, dy = out[2 * k][0], out[2 * k + 1][0]
        res.append((torch.sqrt(dx).mean(-1)
                    + torch.sqrt(dy).mean(-1)).reshape(lead))
    return res


def chamfer_eval(x, y):
    """Evaluation-protocol Chamfer: mean_x min_y |x - y| + mean_y min_x
    |x - y| (square-root distances, the two directional means summed; the
    counterpart of ``chore_tpu/ops/chamfer.py::chamfer_eval``). The 1-NN
    index comes from the kernel (one launch for both directions on the
    card) and each distance is re-expressed as |x - y[idx]|, as on the JAX
    package's TPU route."""
    return chamfer_eval_multi([(x, y)])[0]


def masked_chamfer_sq(x, y, x_mask, y_mask):
    """pytorch3d-style masked squared Chamfer of one cloud pair (N, 3) x
    (M, 3): the mean over valid x of the squared distance to the nearest
    valid y, plus the same from y; invalid points neither query nor serve
    as references, and the result is 0 when either side is empty. Both
    directions are one 1-NN launch on the card."""
    (dx, _), (dy, _) = nn_sqdist_multi([
        dict(x=x[None], y=y[None], y_mask=y_mask[None]),
        dict(x=y[None], y=x[None], y_mask=x_mask[None])])
    nx, ny = x_mask.sum(), y_mask.sum()
    zero = dx.new_zeros(())
    lx = torch.where(x_mask, dx[0], zero).sum() / nx.clamp(min=1)
    ly = torch.where(y_mask, dy[0], zero).sum() / ny.clamp(min=1)
    return torch.where((nx > 0) & (ny > 0), lx + ly, zero)
