"""Grouped 1-nearest-neighbour: the CUDA kernel K1, its plain version, and
the wrappers that dispatch between them.

Counterpart of ``chore_tpu/ops/pallas/nn.py``. For each query x_i with group
g_i: the min over references y_j of the same group of
``max(|x_i|^2 - 2 x_i.y_j + |y_j|^2, 0)``, and its argmin. Masked references
carry group -1, which no query carries; without group rows every pair
matches. A query with no match gets the 1e10 sentinel and index 0; ties go
to the lowest index.

``nn_grouped_multi`` takes several problems and launches
``csrc/nn_grouped.cu`` once for all of them on CUDA tensors (or raises); on
CPU tensors it runs ``nn_sqdist_plain`` once per problem. ``nn_grouped`` is
the one-problem case. Neither is differentiable: ``ops.chamfer.nn_sqdist``
re-expresses the distance against the returned index for autograd.
"""
from __future__ import annotations

import ctypes
import threading

import torch

BIG = 1e10

# kernel launches, counted where the kernel is launched and nowhere else
# (under a lock: the evaluator launches from several threads)
launches = {"nn_grouped": 0}
_count_lock = threading.Lock()

# problem kinds of the kernel's table (``Kind`` in the source)
GROUPED, UNGROUPED, SHARED = 0, 1, 2
MAX_PROBLEMS = 8


class Problem(ctypes.Structure):
    """One entry of the kernel's problem table (``NNProblem`` in the
    source): clouds, group rows (null when ungrouped), outputs; for a
    SHARED problem ``d2``/``i2`` take the unconditional answer."""

    _fields_ = ([(k, ctypes.c_void_p)
                 for k in ("x", "y", "qg", "rg", "d", "i", "d2", "i2")]
                + [(k, ctypes.c_int) for k in ("B", "N", "M", "kind")])


def group_rows(x, y, y_mask=None, x_group=None, y_group=None):
    """Query and reference group rows as f32 (B, N) / (B, M), with the mask
    folded into the reference row as group -1 (``nn_pallas``'s layout);
    (None, None) when there is neither a mask nor a group."""
    if y_mask is None and x_group is None and y_group is None:
        return None, None
    B, N, M = x.shape[0], x.shape[1], y.shape[1]
    qg = (torch.zeros((B, N), dtype=torch.float32, device=x.device)
          if x_group is None else x_group.to(torch.float32).expand(B, N))
    rg = (torch.zeros((B, M), dtype=torch.float32, device=x.device)
          if y_group is None else y_group.to(torch.float32).expand(B, M))
    if y_mask is not None:
        rg = torch.where(y_mask.to(torch.bool), rg, torch.full_like(rg, -1.0))
    return qg.contiguous(), rg.contiguous()


def nn_sqdist_plain(x, y, qg=None, rg=None):
    """Plain PyTorch version of the kernel: the dense (B, N, M) expansion,
    group match (none without group rows), then argmin (first index on
    ties).

    x (B, N, 3), y (B, M, 3), qg (B, N), rg (B, M) f32 ->
    (d (B, N) f32, idx (B, N) int64)."""
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1)[:, None, :]
    d = (xx - 2.0 * torch.bmm(x, y.transpose(1, 2)) + yy).clamp_min(0.0)
    if qg is not None:
        d = torch.where(qg[:, :, None] == rg[:, None, :], d,
                        torch.full_like(d, BIG))
    idx = torch.argmin(d, dim=-1)
    return torch.gather(d, -1, idx[..., None])[..., 0], idx


def _entry_point():
    """The kernel's C entry point (built at first use), typed once."""
    from chore_tpu_torch.ops.cuda_build import load

    fn = load("nn_grouped").nn_multi_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = [ctypes.POINTER(Problem), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _checked(x, y, qg, rg):
    """The problem's tensors, validated; y and rg cloned when not 16-byte
    aligned (the kernel bulk-copies them)."""
    named = [("x", x), ("y", y)]
    if (qg is None) != (rg is None):
        raise ValueError("nn_grouped: qg and rg must both be given or both "
                         "be None")
    if qg is not None:
        named += [("qg", qg), ("rg", rg)]
    for name, t in named:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"nn_grouped: {name} must be a contiguous f32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    B, N, M = x.shape[0], x.shape[1], y.shape[1]
    if (x.shape != (B, N, 3) or y.shape != (B, M, 3)
            or (qg is not None and (qg.shape != (B, N) or rg.shape != (B, M)))):
        raise ValueError(
            f"nn_grouped: bad shapes x{tuple(x.shape)} y{tuple(y.shape)} "
            f"qg{None if qg is None else tuple(qg.shape)} "
            f"rg{None if rg is None else tuple(rg.shape)}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("nn_grouped: inputs on different devices")
    align = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()  # noqa: E731
    return x, align(y), qg, None if rg is None else align(rg)


def _same(a, b):
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape


def plan(problems):
    """The kernel's table for ``problems`` [(x, y, qg, rg)]: a list of
    (kind, problem, partner). An ungrouped problem over the same query and
    reference tensors as a grouped one rides on that one's scan (kind
    SHARED, the ungrouped one its partner); every other problem is its own
    entry (partner None)."""
    partner = {}
    for u, (xu, yu, qu, _) in enumerate(problems):
        if qu is not None:
            continue
        for g, (xg, yg, qgg, _) in enumerate(problems):
            if (qgg is not None and g not in partner
                    and _same(xu, xg) and _same(yu, yg)):
                partner[g] = u
                break
    riders = set(partner.values())
    table = []
    for k, p in enumerate(problems):
        if k in riders:
            continue
        kind = (SHARED if k in partner else
                UNGROUPED if p[2] is None else GROUPED)
        table.append((kind, k, partner.get(k)))
    return table


def nn_multi_cuda(problems):
    """Launch the kernel once, on the current stream, for every problem
    (x, y, qg, rg) of the list (qg = rg = None: ungrouped). Same contract
    as ``nn_sqdist_plain`` per problem; returns [(d, idx int64)]."""
    problems = [_checked(*p) for p in problems]
    if len({p[0].device for p in problems}) != 1:
        raise ValueError("nn_grouped: problems on different devices")
    outs = [(torch.empty(x.shape[:2], dtype=torch.float32, device=x.device),
             torch.empty(x.shape[:2], dtype=torch.int64, device=x.device))
            for x, _, _, _ in problems]
    table = plan(problems)
    if len(table) > MAX_PROBLEMS:
        raise ValueError(f"nn_grouped: {len(table)} problems in one launch, "
                         f"at most {MAX_PROBLEMS}")
    if all(x.shape[0] * x.shape[1] == 0 for x, _, _, _ in problems):
        return outs  # no query: nothing to launch
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    entries = []
    for kind, k, rider in table:
        x, y, qg, rg = problems[k]
        d2, i2 = outs[rider] if rider is not None else (None, None)
        entries.append(Problem(
            ptr(x), ptr(y), ptr(qg), ptr(rg), ptr(outs[k][0]),
            ptr(outs[k][1]), ptr(d2), ptr(i2), x.shape[0], x.shape[1],
            y.shape[1], kind))
    fn = _entry_point()
    dev = problems[0][0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn((Problem * len(entries))(*entries), len(entries), stream)
    if err != 0:
        raise RuntimeError(f"nn_grouped kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches["nn_grouped"] += 1
    return outs


def nn_sqdist_cuda(x, y, qg=None, rg=None):
    """One problem through the kernel (``nn_multi_cuda``)."""
    return nn_multi_cuda([(x, y, qg, rg)])[0]


def nn_grouped_multi(problems):
    """Kernel (one launch) for CUDA tensors, the plain version per problem
    for CPU tensors. ``problems``: [(x, y, qg, rg)], qg/rg None when
    ungrouped. Returns [(d, idx)]."""
    if all(p[0].is_cuda for p in problems):
        return nn_multi_cuda(problems)
    if any(p[0].is_cuda for p in problems):
        raise ValueError("nn_grouped: problems on different devices")
    return [nn_sqdist_plain(*p) for p in problems]


def nn_grouped(x, y, qg=None, rg=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    return nn_grouped_multi([(x, y, qg, rg)])[0]
