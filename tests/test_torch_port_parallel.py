"""Data parallelism of the port over ``torch.distributed`` (gloo, two
spawned processes on the CPU) against one process on the joined batch:

* one ``Trainer.train_step`` under ``DistributedDataParallel``, each rank
  on its half (``local_batch_slice``): the loss (averaged over the ranks)
  within 1e-6 relative, every gradient within 4e-6 of its tensor's
  largest (the batch is summed in another order: 1.0e-6 seen), and the
  parameters after the step within 1e-6 (Adadelta: its
  update is smooth in the gradient; Adam's first step is lr * sign(g) on
  elements whose gradient is rounding noise);
* ``compute_val_loss`` of a batch of 3 (wrap-padded to 4 across the two
  ranks) equal to one process on the padded batch;
* ``sync_decision`` gives rank 0's value on both ranks; the loader's
  shards have equal sizes; only rank 0 writes the checkpoint.

Rank 0 joins with explicit arguments, rank 1 from the environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as ``torchrun`` sets it."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_util import (
    few_torch_threads,  # noqa: F401 - a fixture
    train_batch,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIELD = dict(num_stack=1, num_hourglass=2, net_img_size=32)

WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, {repo!r})
rank, out = int(sys.argv[1]), sys.argv[2]
from chore_tpu_torch.data.loader import DataLoader
from chore_tpu_torch.models.chore import FieldConfig, build_field
from chore_tpu_torch.parallel import (init_distributed, is_main_process,
                                      local_batch_slice, process_count,
                                      process_index, sync_decision)
from chore_tpu_torch.train import Trainer
if rank == 0:
    init_distributed("tcp://localhost:{port}", 2, 0, device="cpu")
else:
    init_distributed(device="cpu")
assert process_count() == 2 and process_index() == rank
batch = dict(np.load(os.path.join(out, "batch.npz")))
val = dict(np.load(os.path.join(out, "val.npz")))
model = build_field(FieldConfig(**{field!r}), device="cpu", seed=0,
                    trainable=True)
tr = Trainer(model, os.path.join(out, "exp"), optimizer="adadelta")
part = local_batch_slice(4)
loss, parts = tr.train_step({{k: v[part] for k, v in batch.items()}})
res = {{"loss": float(loss), "parts": {{k: float(v) for k, v in parts.items()}},
       "decision": sync_decision(rank == 0),
       "val": tr.compute_val_loss([val]),
       "shard": len(DataLoader(list(range(23)), 1, shard_index=rank,
                               shard_count=2)._indices()),
       "saved": tr.save()}}
np.savez(os.path.join(out, f"rank{{rank}}.npz"),
         **{{"p/" + n: p.detach().numpy() for n, p in tr.named_params}},
         **{{"g/" + n: p.grad.numpy() for n, p in tr.named_params}})
with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_step_equals_joined_batch(tmp_path):
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.train import Trainer

    batch = train_batch(np.random.RandomState(0), B=4)
    val = train_batch(np.random.RandomState(9), B=3)
    np.savez(tmp_path / "batch.npz", **batch)
    np.savez(tmp_path / "val.npz", **val)
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, port=port, field=FIELD))
    env = dict(os.environ, RANK="1", WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]

    model = build_field(FieldConfig(**FIELD), device="cpu", seed=0,
                        trainable=True)
    ref = Trainer(model, str(tmp_path / "ref"), optimizer="adadelta")
    loss, parts = ref.train_step(batch)
    padded = {k: np.concatenate([v, v[:1]]) for k, v in val.items()}
    ref_val = ref.compute_val_loss([padded])
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in (0, 1)]
    arrays = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for r, a in zip(res, arrays):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        for k, v in parts.items():
            np.testing.assert_allclose(r["parts"][k], float(v), rtol=1e-6)
        np.testing.assert_allclose(r["val"], ref_val, rtol=1e-6)
        assert r["decision"] is True and r["shard"] == 12
        for n, p in ref.named_params:
            g = p.grad.numpy()
            np.testing.assert_allclose(a["g/" + n], g, rtol=0,
                                       atol=4e-6 * np.abs(g).max(),
                                       err_msg=n)
            np.testing.assert_allclose(a["p/" + n], p.detach().numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)
    assert res[0]["saved"] and res[1]["saved"] is None
    assert os.listdir(tmp_path / "exp" / "checkpoints") == [res[0]["saved"]]


def test_single_process_helpers():
    """Without a process group every helper is the one-process identity."""
    from chore_tpu_torch.parallel import (
        all_mean,
        init_distributed,
        is_main_process,
        local_batch_slice,
        process_count,
        sync_decision,
    )

    assert init_distributed(device="cpu") == torch.device("cpu")
    assert process_count() == 1 and is_main_process()
    assert sync_decision(True) is True and sync_decision(0) is False
    t = torch.tensor([1.5, 2.0])
    assert torch.equal(all_mean(t), t)
    assert local_batch_slice(15) == slice(0, 15)
    assert [local_batch_slice(12, 3, i) for i in range(3)] == [
        slice(0, 4), slice(4, 8), slice(8, 12)]
