"""Hooks a test hands to every rank of a data-parallel cell (the traffic
parameter ``rank_hook``), run before the rank builds anything."""
from __future__ import annotations


def one_thread(rank, world):
    """Four ranks on a few CPU cores: one thread each for the
    arithmetic."""
    import torch

    torch.set_num_threads(1)


def no_exchange(rank, world):
    """The exchange between the ranks left out: the trainer sees one
    process and steps each rank on its own gradient (the loss is still
    averaged over the ranks)."""
    import chore_tpu_torch.train.trainer as trainer_mod

    one_thread(rank, world)
    trainer_mod.process_count = lambda: 1


def jax_in_last_rank(rank, world):
    """The last rank holds a module named ``jax`` (loaded where the
    harness cannot see it: in a process that does not print the
    result)."""
    import sys
    import types

    one_thread(rank, world)
    if rank == world - 1:
        sys.modules["jax"] = types.ModuleType("jax")
