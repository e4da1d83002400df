"""Data parallelism over ``torch.distributed`` (counterpart of
``chore_tpu/parallel/mesh.py``).

One process per device, each holding a full replica and its own shard of
the global batch: ``DistributedDataParallel`` all-reduces the gradients
(NCCL on the card, gloo on the CPU), checkpoints and logs are written by
rank 0 only, and a decision a process takes alone (a wall-clock
checkpoint) is broadcast from rank 0 so every rank runs the same
collectives. A single process needs no process group: every function here
then works without one.
"""
from __future__ import annotations

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


def local_batch_slice(global_batch_size, count=None, index=None):
    """This process's slice of the global batch. count/index default to
    the live process group; pass them to compute another rank's slice."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    per = global_batch_size // count
    start = index * per
    return slice(start, start + per)
