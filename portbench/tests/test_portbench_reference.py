"""The plain reference against the port at a tiny width on the CPU: the
field's forward, losses and gradients, and its Adam."""
from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import training
from portbench.reference import field as ref
from portbench.tests.conftest import TINY

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name="chore-release-f32", **kw):
    cfg = json.load(open(os.path.join(HERE, "configs", f"{name}.json")))
    return {**cfg, **TINY, **kw}


def test_field_loss_and_gradients_agree_with_the_port(tmp_path):
    from chore_tpu_torch.models.chore import chore_losses

    cfg = config()
    dev = torch.device("cpu")
    p = ref.make_params(cfg, 3, dev)
    trainer = training.build_trainer(cfg, p, dev, str(tmp_path))
    batch = training.synthetic_batch(cfg, 3, 0, dev)
    model = trainer.model
    preds = model(batch["images"], batch["points"], batch["crop_center"])
    loss, _ = chore_losses(preds, batch, model.cfg)
    names = [n for n, _ in trainer.named_params]
    grads = torch.autograd.grad(loss, [q for _, q in trainer.named_params])
    want, want_grads = ref.loss_and_grads(cfg, p, batch)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-6)
    assert set(names) == set(want_grads)
    for n, g in zip(names, grads):
        torch.testing.assert_close(g, want_grads[n], rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12)


def test_blocks_of_rows_add_up():
    cfg = config()
    dev = torch.device("cpu")
    p = ref.make_params(cfg, 4, dev)
    batch = training.synthetic_batch(cfg, 4, 1, dev)
    whole, gw = ref.loss_and_grads(cfg, p, batch)
    parts, gp = ref.loss_and_grads(cfg, p, batch, rows=1)
    assert parts == pytest.approx(whole, rel=1e-6)
    for k in gw:
        torch.testing.assert_close(gp[k], gw[k], rtol=1e-4, atol=1e-7)


def test_the_adam_of_the_reference_is_the_trainers(tmp_path):
    """Three steps of the port's trainer against the reference's, in
    float32 on the CPU: losses, first gradients and changes."""
    cfg = config()
    dev = torch.device("cpu")
    trainer = training.build_trainer(cfg, ref.make_params(cfg, 5, dev), dev,
                                     str(tmp_path))
    batches = [training.synthetic_batch(cfg, 5, i, dev) for i in range(3)]
    first = training.FirstSteps(trainer, cfg, 5, dev)
    for b in batches:
        first.after(trainer.train_step(b)[0])
    got = training.gaps(first.readings(),
                        training.reference_steps(cfg, 5, batches, dev))
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-2
    assert got["grad_diff"] < 1e-4
