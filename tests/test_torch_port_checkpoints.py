"""Reading ``chore_tpu`` checkpoints in the port: a checkpoint written by
``chore_tpu.train.checkpoints.save_checkpoint`` ({params, opt_state} of a
small CHOREField) reads back with bitwise-equal arrays and the same
epoch, training time and step; the val_min pointer wins over the newest
file; a payload without global_step loads with step 0; and the msgpack
decoder matches ``flax.serialization.msgpack_restore`` leaf for leaf."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import jax_field


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    import optax
    from flax import serialization

    from chore_tpu.train.checkpoints import save_checkpoint

    _, params = jax_field()
    opt_state = optax.adam(1e-3).init(params)
    state = {"params": params, "opt_state": opt_state}
    exp = tmp_path_factory.mktemp("exp")
    ckpt = os.path.join(str(exp), "checkpoints")
    names = [save_checkpoint(ckpt, state, 3725.5, 7, global_step=1234),
             save_checkpoint(ckpt, state, 9000.25, 9, global_step=2000)]
    want = serialization.to_state_dict(state)
    return str(exp), ckpt, names, want


def test_latest_and_arrays_bitwise(saved):
    from chore_tpu.train.checkpoints import find_checkpoint as jfind
    from chore_tpu_torch.train.checkpoints import find_checkpoint, load_checkpoint

    exp, ckpt, names, want = saved
    path = find_checkpoint(exp)
    assert path == jfind(exp) == os.path.join(ckpt, names[1])
    state, epoch, secs, step = load_checkpoint(path)
    assert (epoch, secs, step) == (9, 9000.25, 2000)
    got = dict(_leaves(state))
    ref = dict(_leaves(want))
    assert set(got) == set(ref) and len(got) > 50
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


def test_loads_into_the_port_field(saved):
    """The checkpoint's params load strictly into the port's field."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.models.convert import params_from_jax
    from chore_tpu_torch.train.checkpoints import find_checkpoint, load_checkpoint

    exp, _, _, want = saved
    state = load_checkpoint(find_checkpoint(exp))[0]
    model = build_field(FieldConfig(num_stack=2), device="cpu",
                        state_dict=params_from_jax(state["params"]))
    w = np.asarray(want["params"]["params"]["image_filter"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        model.image_filter.conv1.weight.numpy(), w.transpose(3, 2, 0, 1))


def test_val_min_pointer_preferred(saved):
    from chore_tpu.train.checkpoints import find_checkpoint as jfind
    from chore_tpu.train.checkpoints import update_val_min
    from chore_tpu_torch.train.checkpoints import find_checkpoint

    exp, ckpt, names, _ = saved
    assert update_val_min(exp, 7, 0.5, names[0])
    try:
        assert find_checkpoint(exp) == jfind(exp) == os.path.join(
            ckpt, names[0])
        assert find_checkpoint(exp, prefer="latest") == os.path.join(
            ckpt, names[1])
    finally:
        for f in os.listdir(exp):
            if f.startswith("val_min="):
                os.remove(os.path.join(exp, f))


def test_payload_without_global_step(tmp_path):
    from flax import serialization

    from chore_tpu_torch.train.checkpoints import load_checkpoint

    path = tmp_path / "checkpoint_0h:0m:5s_5.0.ckpt"
    path.write_bytes(serialization.to_bytes({
        "state": {"params": {"w": np.ones(3, np.float32)}},
        "epoch": np.asarray(2), "training_time": np.asarray(5.0)}))
    state, epoch, secs, step = load_checkpoint(str(path))
    assert (epoch, secs, step) == (2, 5.0, 0)
    np.testing.assert_array_equal(state["params"]["w"], np.ones(3))


def test_msgpack_like_flax():
    from flax import serialization

    from chore_tpu_torch.utils.msgpack import unpackb

    rng = np.random.RandomState(0)
    tree = {
        "ints": {"small": 5, "neg": -3, "neg16": -300, "neg32": -70000,
                 "u16": 60000, "u32": 3_000_000_000, "big": 2 ** 40,
                 "neg64": -2 ** 40},
        "floats": {"f": 1.25, "tiny": 1e-300},
        "strings": {"s": "hello", "long": "x" * 300, "empty": ""},
        "misc": {"none": None, "yes": True, "no": False},
        "scalars": {"f32": np.float32(3.5), "i16": np.int16(-3),
                    "u8": np.uint8(200), "bf16": jnp.bfloat16(1.5)},
        "arrays": {"i32": np.arange(12, dtype=np.int32).reshape(3, 4),
                   "f64": rng.rand(4, 5), "u8": np.arange(256, dtype=np.uint8),
                   "bool": rng.rand(7) > 0.5, "empty": np.zeros((0, 3)),
                   "bf16": np.asarray(jnp.asarray(rng.randn(2, 3),
                                                  jnp.bfloat16)),
                   "big": rng.rand(200, 100).astype(np.float32)},
        "list_like": {"0": 1, "1": 2},
    }
    data = serialization.to_bytes(tree)
    want, got = serialization.msgpack_restore(data), unpackb(data)
    ref, out = dict(_leaves(want)), dict(_leaves(got))
    assert set(out) == set(ref)
    for k, v in ref.items():
        g = out[k]
        if str(getattr(v, "dtype", "")) == "bfloat16":
            assert torch.is_tensor(g) and g.dtype == torch.bfloat16
            assert tuple(g.shape) == np.shape(v)
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                np.asarray(v).view(np.uint16))
            continue
        assert type(g) is type(v), k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(v))
        assert np.asarray(g).dtype == np.asarray(v).dtype, k
    with pytest.raises(ValueError, match="truncated"):
        unpackb(data[:-5])
    with pytest.raises(ValueError, match="extension type 2"):
        unpackb(serialization.to_bytes({"c": 1 + 2j}))
