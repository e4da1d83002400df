"""Grouped 1-nearest-neighbour: the CUDA kernel K1, its plain version, and
the wrapper that dispatches between them.

Counterpart of ``chore_tpu/ops/pallas/nn.py``. For each query x_i with group
g_i: the min over references y_j of the same group of
``max(|x_i|^2 - 2 x_i.y_j + |y_j|^2, 0)``, and its argmin. Masked references
carry group -1, which no query carries. A query with no match gets the
1e10 sentinel and index 0; ties go to the lowest index.

``nn_grouped`` launches ``csrc/nn_grouped.cu`` for CUDA tensors (or raises)
and runs ``nn_sqdist_plain`` for CPU tensors only. Neither is
differentiable: ``ops.chamfer.nn_sqdist`` re-expresses the distance against
the returned index for autograd.
"""
from __future__ import annotations

import ctypes

import torch

BIG = 1e10

# kernel launches, counted where the kernel is launched and nowhere else
launches = {"nn_grouped": 0}


def group_rows(x, y, y_mask=None, x_group=None, y_group=None):
    """Query and reference group rows as f32 (B, N) / (B, M), with the mask
    folded into the reference row as group -1 (``nn_pallas``'s layout)."""
    B, N, M = x.shape[0], x.shape[1], y.shape[1]
    qg = (torch.zeros((B, N), dtype=torch.float32, device=x.device)
          if x_group is None else x_group.to(torch.float32).expand(B, N))
    rg = (torch.zeros((B, M), dtype=torch.float32, device=x.device)
          if y_group is None else y_group.to(torch.float32).expand(B, M))
    if y_mask is not None:
        rg = torch.where(y_mask.to(torch.bool), rg, torch.full_like(rg, -1.0))
    return qg.contiguous(), rg.contiguous()


def nn_sqdist_plain(x, y, qg, rg):
    """Plain PyTorch version of the kernel: the dense (B, N, M) expansion,
    group match, then argmin (first index on ties).

    x (B, N, 3), y (B, M, 3), qg (B, N), rg (B, M) f32 ->
    (d (B, N) f32, idx (B, N) int64)."""
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1)[:, None, :]
    d = (xx - 2.0 * torch.bmm(x, y.transpose(1, 2)) + yy).clamp_min(0.0)
    d = torch.where(qg[:, :, None] == rg[:, None, :], d,
                    torch.full_like(d, BIG))
    idx = torch.argmin(d, dim=-1)
    return torch.gather(d, -1, idx[..., None])[..., 0], idx


def _entry_point():
    """The kernel's C entry point (built at first use), typed once."""
    from chore_tpu_torch.ops.cuda_build import load

    fn = load("nn_grouped").nn_grouped_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def nn_sqdist_cuda(x, y, qg, rg):
    """Launch the kernel on the current stream. Same contract as
    ``nn_sqdist_plain`` (indices come back as int64)."""
    for name, t in (("x", x), ("y", y), ("qg", qg), ("rg", rg)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"nn_grouped: {name} must be a contiguous f32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    B, N, M = x.shape[0], x.shape[1], y.shape[1]
    if (x.shape != (B, N, 3) or y.shape != (B, M, 3)
            or qg.shape != (B, N) or rg.shape != (B, M)):
        raise ValueError(
            f"nn_grouped: bad shapes x{tuple(x.shape)} y{tuple(y.shape)} "
            f"qg{tuple(qg.shape)} rg{tuple(rg.shape)}")
    if len({t.device for t in (x, y, qg, rg)}) != 1:
        raise ValueError("nn_grouped: inputs on different devices")
    fn = _entry_point()
    d = torch.empty((B, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), qg.data_ptr(), rg.data_ptr(),
                 d.data_ptr(), idx.data_ptr(), B, N, M, stream)
    if err != 0:
        raise RuntimeError(f"nn_grouped kernel launch failed: CUDA error {err}")
    launches["nn_grouped"] += 1
    return d, idx.long()


def nn_grouped(x, y, qg, rg):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if x.is_cuda:
        return nn_sqdist_cuda(x, y, qg, rg)
    return nn_sqdist_plain(x, y, qg, rg)
