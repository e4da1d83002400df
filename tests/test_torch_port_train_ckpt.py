"""Checkpoint writing and the reference import of the port's trainer:

* ``Trainer.import_torch`` of a reference-layout ``.tar`` built here (DDP
  ``module.`` prefixes, the ``downsample.0`` aliases, a torch Adam state
  after one step in which one parameter had no gradient, so no state)
  against ``chore_tpu.train.Trainer.import_torch``: equal weights, Adam
  moments, count, epoch, training time, global step and unused keys;
* ``train.torch_import``: the parameter order and the Adam state by name
  equal to ``chore_tpu.train.torch_import``'s, and a bare state-dict file;
* ``update_val_min``'s running-minimum pointer and ``checkpoint_name``
  equal to ``chore_tpu``'s, step by step;
* ``utils.msgpack.packb`` byte-identical to flax's ``to_bytes`` on a
  checkpoint payload of each optimizer, and ``unpackb`` reading it back."""
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_util import (
    assert_trees_close,
    few_torch_threads,  # noqa: F401 - a fixture
    flat,
    jax_train_params,
    jax_trainer,
    port_trainer,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def tar(tmp_path_factory):
    """A reference ``checkpoint_*.tar`` with every key the reference
    registers, prefixed ``module.``, and a torch Adam state in which
    ``image_filter.conv1.bias`` never had a gradient."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field

    model = build_field(FieldConfig(num_stack=1, num_hourglass=2,
                                    net_img_size=32), device="cpu", seed=4,
                        trainable=True).requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(1)
    for n, p in model.named_parameters():
        if n != "image_filter.conv1.bias" and ".bn4." not in n:
            p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    sd = {"module." + k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path_factory.mktemp("ref") / "checkpoint_0h:2m:3s_123.0.tar")
    torch.save({"model_state_dict": sd,
                "optimizer_state_dict": opt.state_dict(),
                "epoch": 7, "training_time": 123.0}, path)
    return path


def test_import_torch_matches_reference(tar, tmp_path):
    from chore_tpu.models import CHOREField
    from chore_tpu_torch.models.convert import params_to_jax
    from chore_tpu_torch.train import optim

    cfg, params = jax_train_params()
    jt = jax_trainer(CHOREField(cfg=cfg), params, tmp_path / "j")
    tt = port_trainer(cfg, params, tmp_path / "t")
    unused_j = jt.import_torch(tar)
    unused_t = tt.import_torch(tar)
    assert sorted(unused_t) == sorted(unused_j) and unused_t
    assert (tt.epoch, tt.training_time, tt.global_step) == (
        jt.epoch, jt.training_time, jt.global_step) == (7, 123.0, 1)
    assert_trees_close(params_to_jax(tt.model.state_dict()),
                       jax.device_get(jt.params), 0)
    mine = optim.optax_state(tt.opt, "adam", tt.named_params)["inner_state"]
    ref = jax.device_get(jt.opt_state).inner_state[0]
    assert int(mine["0"]["count"]) == int(ref.count) == 1
    assert_trees_close(mine["0"]["mu"], ref.mu, 0)
    assert_trees_close(mine["0"]["nu"], ref.nu, 0)
    zero = flat(mine["0"]["mu"])["params/image_filter/conv1/bias"]
    assert not zero.any()
    # a trainer of another optimizer refuses the Adam state, as JAX's does
    with pytest.raises(ValueError, match="only defined for Adam"):
        port_trainer(cfg, params, tmp_path / "r", "rmsprop").import_torch(tar)


def test_torch_import_order_and_state_match_reference(tar, tmp_path):
    from chore_tpu.train import torch_import as ref
    from chore_tpu_torch.train import torch_import

    data = torch_import.load_torch_checkpoint(tar)
    sd = data["model_state_dict"]
    assert not any(k.startswith("module.") for k in sd)
    raw = torch.load(tar, map_location="cpu")
    assert torch_import.parameter_names(sd) == ref._parameter_names(
        ref._strip_ddp(raw["model_state_dict"]))
    by_name, count, missing = torch_import.adam_state_by_name(data)
    assert count == 1 and "image_filter.conv1.bias" in missing
    assert all(".bn4." in n for n in missing
               if n != "image_filter.conv1.bias")
    opt = raw["optimizer_state_dict"]
    order = [i for g in opt["param_groups"] for i in g["params"]]
    for name, i in zip(torch_import.parameter_names(sd), order):
        st = opt["state"].get(i)
        if st is None:
            assert by_name[name] is None
        else:
            assert torch.equal(by_name[name][0], st["exp_avg"])
            assert torch.equal(by_name[name][1], st["exp_avg_sq"])
    bare = str(tmp_path / "bare.pt")
    torch.save(raw["model_state_dict"], bare)
    assert list(torch_import.load_torch_checkpoint(bare)) == [
        "model_state_dict"]
    assert list(torch_import.load_torch_checkpoint(bare)[
        "model_state_dict"]) == list(sd)


def test_val_min_pointer_and_names_match_reference(tmp_path):
    from chore_tpu.train.checkpoints import checkpoint_name as jname
    from chore_tpu.train.checkpoints import update_val_min as jupdate
    from chore_tpu_torch.train.checkpoints import checkpoint_name, update_val_min

    for secs in (0.0, 59.9, 3725.5, 90061.25):
        assert checkpoint_name(secs) == jname(secs)
    # accepted while <= best + 1.0, and the pointer keeps the minimum
    steps = [(1, 5.0), (2, 5.8), (3, 7.0), (4, 4.0), (5, 4.9), (6, 5.1)]
    for epoch, loss in steps:
        outs = []
        for d, fn in ((tmp_path / "t", update_val_min),
                      (tmp_path / "j", jupdate)):
            os.makedirs(d, exist_ok=True)
            outs.append(fn(str(d), epoch, loss, f"ck{epoch}.ckpt"))
        assert outs[0] == outs[1]
        ptrs = [sorted(os.listdir(tmp_path / s)) for s in "tj"]
        assert ptrs[0] == ptrs[1] and len(ptrs[0]) == 1
        a, b = (np.load(tmp_path / s / ptrs[0][0], allow_pickle=True)["data"]
                for s in "tj")
        assert a.tolist() == b.tolist()
    assert a.tolist() == [5, 4.0, "ck5.ckpt"]


@pytest.mark.parametrize("name", ["adam", "adadelta", "rmsprop"])
def test_packb_equals_flax_bytes(name):
    import optax
    from flax import serialization

    from chore_tpu_torch.utils.msgpack import packb, unpackb

    _, params = jax_train_params()
    tx = optax.inject_hyperparams(getattr(optax, name))(learning_rate=1e-3)
    payload = {"state": {"params": params, "opt_state": tx.init(params)},
               "epoch": np.asarray(3), "training_time": np.asarray(12.5),
               "global_step": np.asarray(40)}
    ref = serialization.to_bytes(payload)

    def numpy_tree(t):  # keeps the dict order, as to_bytes does
        return ({k: numpy_tree(v) for k, v in t.items()}
                if isinstance(t, dict) else np.asarray(t))

    mine = packb(numpy_tree(serialization.to_state_dict(payload)))
    assert mine == ref
    back = unpackb(mine)
    assert_trees_close(back, serialization.msgpack_restore(ref), 0)
    # scalars, strings and bytes of every length class flax writes
    extra = {"a": [1, -1, -33, 200, 70000, -70000, 2**40, 1.5, None, True,
                   "x" * 40, b"y" * 300, np.float32(2.0), np.int64(5)]}
    assert packb(extra) == serialization.msgpack_serialize(extra)
