"""Nearest-neighbour squared distances with exact gradients.

Counterpart of ``chore_tpu/ops/chamfer.py::nn_sqdist`` on its TPU route
(``nn_sqdist_exact_grad``, ``chore_tpu/ops/pallas/nn.py:151-169``): the
grouped 1-NN (kernel on the card, plain version on the CPU) runs on detached
inputs and gives the index; the distance is then re-expressed as
``|x - y[idx]|^2`` so autograd yields the exact min-distance gradient with
respect to both clouds. Queries the kernel found no match for keep the 1e10
sentinel (zero gradient). ``vmap`` over examples becomes the kernel's batch
dimension.
"""
from __future__ import annotations

import torch

from chore_tpu_torch.ops.nn import BIG, group_rows, nn_grouped


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
    xd, yd = x.detach().contiguous(), y.detach().contiguous()
    qg, rg = group_rows(xd, yd, y_mask, x_group, y_group)
    d_kern, idx = nn_grouped(xd, yd, qg, rg)
    y_nn = torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))
    d = ((x - y_nn) ** 2).sum(-1)
    d = torch.where(d_kern >= 0.5 * BIG, torch.full_like(d, BIG), d)
    return d, idx
