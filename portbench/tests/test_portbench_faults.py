"""Whole runs of the training cells at a tiny size on the CPU (the look
for a card skipped), sound and with the timed path broken underneath:
the sound run comes out correct under the cells' limits, and each fault
that a cell can have comes out not correct."""
from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests.conftest import TINY

CELLS = {"train-staged-f32": {"trace_steps": 2},
         "train-staged": {"trace_steps": 2}}


def state_unchanged(mp):
    """Every step returns the state unchanged: the optimizer never
    moves a parameter."""
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(mp):
    """Half of the batch left out, the mean taken over the rest."""
    from chore_tpu_torch.train.trainer import Trainer

    step = Trainer.train_step

    def half(self, batch):
        n = len(batch["images"]) // 2
        return step(self, {k: v[:n] for k, v in batch.items()})
    mp.setattr(Trainer, "train_step", half)


def answer_altered(mp):
    """The loss altered where it is produced (by 5%), and with it every
    gradient."""
    import chore_tpu_torch.train.trainer as trainer_mod

    losses = trainer_mod.chore_losses

    def altered(*a, **k):
        total, parts = losses(*a, **k)
        return total * 1.05, parts
    mp.setattr(trainer_mod, "chore_losses", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


def execute(cell, seed=2 ** 31 + 5):
    return run.execute(cell, seed, 0.2, 0, device="cpu", overrides=TINY,
                       traffic=CELLS[cell])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = execute(cell)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = execute(cell)
    assert out["correct"] is False, out["checks"]


DDP = {**TINY, "num_stack": 1, "num_workers": 1}


def execute_ddp(hook, **traffic):
    import chore_tpu_torch.train.trainer as trainer_mod

    saved, threads = trainer_mod.process_count, torch.get_num_threads()
    try:
        return run.execute(
            "train-ddp4", 2 ** 31 + 7, 0.2, 0, device="cpu", overrides=DDP,
            traffic={"rank_hook": f"portbench.tests.faults:{hook}",
                     **traffic})
    finally:
        trainer_mod.process_count = saved
        torch.set_num_threads(threads)


@pytest.mark.parametrize("hook,correct", [("one_thread", True),
                                          ("no_exchange", False)])
def test_data_parallel_exchange(hook, correct):
    """Four processes over gloo: sound, and with the gradient exchange left
    out (each rank steps on its own gradient)."""
    out = execute_ddp(hook)
    assert out["correct"] is correct, out["checks"]
    assert out["device"]["count"] == 4


def test_a_rank_holding_jax_is_refused():
    """A module named jax in a rank other than the one that prints the
    result: the run ends with no result."""
    with pytest.raises(SystemExit, match="forbidden modules.*jax"):
        execute_ddp("jax_in_last_rank")
