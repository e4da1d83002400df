"""The port's training entry point on the CPU, over a small split the test
writes (preprocessed npz frames, JPEG photos and masks): one epoch of
``python -m chore_tpu_torch.cli.train`` (``main`` with ``--device cpu``,
the config from configs/<exp>.json) writes a checkpoint, metrics.jsonl
and the val_min pointer; a second call with more epochs resumes from
that checkpoint (and writes the profiler trace of the steps from the
second on, and prints its steps' phase timing), and ``chore_tpu``'s
``load_checkpoint`` reads the result."""
import json
import os
import pickle

import numpy as np
import pytest

from test_torch_port_util import (
    few_torch_threads,  # noqa: F401 - a fixture
    write_train_frames,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def test_launch_train_writes_and_resumes(tmp_path, monkeypatch, capsys):
    from chore_tpu_torch.cli import train as cli
    from chore_tpu_torch.config import ChoreConfig, save_config

    paths = write_train_frames(tmp_path / "frames", n=6)
    split = str(tmp_path / "split.pkl")
    with open(split, "wb") as f:
        pickle.dump({"train": paths[:4], "test": paths[4:]}, f)
    cfg = ChoreConfig(exp_name="small", num_stack=1, net_img_size=(64, 64),
                      precision="float32", batch_size=2, num_workers=2,
                      num_samples_train=300, loadSize=200, split_file=split,
                      random_flip=True, num_epochs=1)
    monkeypatch.chdir(tmp_path)
    save_config(cfg)
    exp = tmp_path / "exps" / "small"
    cli.main(["small", "--exp-root", "exps", "--device", "cpu"])
    ckpts = os.listdir(exp / "checkpoints")
    assert len(ckpts) == 1
    pointer = [p for p in os.listdir(exp) if p.startswith("val_min=")]
    assert pointer == ["val_min=1.npz"]
    data = np.load(exp / pointer[0], allow_pickle=True)["data"]
    assert data[2] == ckpts[0] and np.isfinite(float(data[1]))
    logs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["epoch"] for r in logs if "epoch" in r] == [1.0]
    assert any("val_loss" in r for r in logs)

    trainer = cli.launch_train(cfg, "exps", epochs=2, device="cpu",
                               profile_dir=str(tmp_path / "trace"))
    assert trainer.epoch == 2 and trainer.global_step == 4
    # the resumed run's two steps, phase by phase, printed at its end
    timing = trainer.timer.summary()
    assert {k: v["count"] for k, v in timing.items()} == {
        "forward": 2, "loss": 2, "backward": 2, "optimizer": 2}
    assert ("train phase timing (process 0): " + str(timing)
            in capsys.readouterr().out)
    # steps 2.. were traced (the window closes when training ends)
    assert {"trace.json", "ops.txt"} <= set(os.listdir(tmp_path / "trace"))
    assert len(os.listdir(exp / "checkpoints")) == 2
    logs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["epoch"] for r in logs if "epoch" in r] == [1.0, 2.0]

    import jax

    from chore_tpu.models import CHOREField, FieldConfig
    from chore_tpu.train.checkpoints import find_checkpoint, load_checkpoint
    from chore_tpu_torch.models.convert import params_to_jax

    model = CHOREField(cfg=FieldConfig(num_stack=1))
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jax.numpy.zeros((1, 64, 64, 5)),
                              jax.numpy.zeros((1, 8, 3)),
                              jax.numpy.zeros((1, 2)))
    state, epoch, _, step = load_checkpoint(
        find_checkpoint(str(exp), prefer="latest"), {"params": template})
    assert (epoch, step) == (2, 4)
    want = params_to_jax(trainer.model.state_dict())
    got = jax.tree_util.tree_leaves(state["params"])
    assert all(np.array_equal(a, b) for a, b in zip(
        got, jax.tree_util.tree_leaves(want)))
