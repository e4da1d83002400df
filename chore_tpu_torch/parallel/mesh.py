"""Data parallelism over ``torch.distributed`` (counterpart of
``chore_tpu/parallel/mesh.py``).

One process per device, each holding a full replica and its own shard of
the global batch: ``DistributedDataParallel`` all-reduces the gradients
(NCCL on the card, gloo on the CPU), checkpoints and logs are written by
rank 0 only, and a decision a process takes alone (a wall-clock
checkpoint) is broadcast from rank 0 so every rank runs the same
collectives. A single process needs no process group: every function here
then works without one.

Data-parallel reconstruction (``ReconFitter(mesh=)``) runs over a ``Mesh``:
the processes of one group, each fitting its slice of the global batch on
its own device. The fit's batch means become sums over the ranks
(``all_sum``, one small tensor per optimizer step), so every rank takes the
same plateau and finite decisions as one process fitting the whole batch.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from chore_tpu_torch import resolve_device


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device=None):
    """Join the process group. With ``num_processes`` > 1, directly at
    ``coordinator`` (``tcp://host:port``) as ``process_id``; otherwise from
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them) when ``WORLD_SIZE`` > 1;
    a single process stays a no-op. The backend is NCCL for a CUDA
    ``device`` (each process on ``cuda:LOCAL_RANK`` unless given), else
    gloo. Returns this process's device."""
    if num_processes is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        coordinator = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if device is None and torch.cuda.is_available():
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if (num_processes or 1) > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=coordinator, world_size=num_processes,
            rank=process_id, device_id=device if device.type == "cuda"
            else None)
    return device


def process_count():
    """Number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process():
    """Rank 0 writes checkpoints and logs."""
    return process_index() == 0


def _collective_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def sync_decision(flag: bool) -> bool:
    """Rank 0's value of a local boolean decision, on every rank. Whatever
    decides if a collective runs (the periodic validation) must pass
    through here, or the ranks diverge and the job hangs."""
    if process_count() > 1:
        t = torch.tensor([int(bool(flag))], device=_collective_device())
        dist.broadcast(t, 0)
        return bool(t.item())
    return bool(flag)


def all_mean(t):
    """Mean of a tensor over the ranks (itself with one process)."""
    if process_count() > 1:
        t = t.clone()
        dist.all_reduce(t)
        t /= process_count()
    return t


def shard_batch(batch, device):
    """This process's shard of the global batch (what its loader gives it)
    as tensors on ``device``; tensors already there pass through."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The processes that fit one global batch together, one per device
    (the counterpart of ``chore_tpu``'s 1-D device mesh).

    Attributes:
      group: the ``torch.distributed`` process group (None: one process).
      size: number of ranks; rank: this process's rank.
      device: this process's device.
    """

    group: object
    size: int
    rank: int
    device: torch.device


def make_mesh(device=None):
    """This process's ``Mesh``: joins the process group as
    ``init_distributed`` does (``torchrun``'s environment; NCCL on the card,
    gloo on the CPU; a group already joined is kept), or a one-process mesh
    without one."""
    device = init_distributed(device=device)
    if dist.is_initialized():
        return Mesh(dist.group.WORLD, dist.get_world_size(),
                    dist.get_rank(), device)
    return Mesh(None, 1, 0, device)


def _distributed(mesh):
    return mesh is not None and mesh.size > 1


def replicate(module, mesh):
    """Broadcast ``module``'s parameters and buffers from rank 0 (as
    ``DistributedDataParallel`` does when it is built); returns it."""
    if _distributed(mesh):
        dev = _collective_device()
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                x = t.detach().to(dev, copy=True)
                dist.broadcast(x, 0, group=mesh.group)
                t.copy_(x)
    return module


def all_sum(t, mesh):
    """The sum of a small tensor over the ranks, added in rank order, so
    every rank holds the same bits; carries no gradient. The identity with
    one process."""
    if not _distributed(mesh):
        return t
    x = t.detach().to(_collective_device()).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.to(t.device)


def all_gather_batch(tree, mesh):
    """Every rank's equal-sized batch of a tensor, or of each tensor of a
    (nested) dict, concatenated in rank order along the first dimension:
    the global batch on every rank. The identity with one process."""
    if not _distributed(mesh):
        return tree
    if isinstance(tree, dict):
        return {k: all_gather_batch(v, mesh) for k, v in tree.items()}
    x = tree.detach().to(_collective_device()).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts).to(tree.device)


def all_gather_object(obj, mesh):
    """Every rank's picklable ``obj``, as a list in rank order."""
    if not _distributed(mesh):
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_object(obj, mesh):
    """Rank 0's value of a picklable object, on every rank (a decision
    that must not depend on what another rank is writing)."""
    if not _distributed(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, group=mesh.group)
    return box[0]


def local_batch_slice(global_batch_size, count=None, index=None):
    """This process's slice of the global batch. count/index default to
    the live process group; pass them to compute another rank's slice."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    per = global_batch_size // count
    start = index * per
    return slice(start, start + per)
