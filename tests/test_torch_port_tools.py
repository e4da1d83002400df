"""The port's example and import tools against the reference's:

* ``chore_tpu_torch.tools.make_example`` writes the committed example
  (``chore_tpu_torch/assets/example_synth/frame0000``, written by
  ``tools/make_example.py``) byte for byte once it is given the JAX
  package's posed body; with its own body (the port's SMPL-H, whose float32
  vertices differ from XLA's in the last bits) the masks and the mocap
  parameters stay byte-equal and the rest within the stated tolerances;
* ``chore_tpu_torch.tools.import_torch`` on a reference-layout ``.tar``
  writes the same checkpoint bytes as ``tools/import_torch.py``, with the
  weights ``Trainer.import_torch`` loads, and ``load_trained`` reads it.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_util import (  # noqa: F401 - a fixture
    few_torch_threads,
    jax_posed_body,
    reference_tool,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "chore_tpu_torch", "assets", "example_synth",
                       "frame0000")
EXAMPLE_FILES = ("k1.color.jpg", "k1.person_mask.jpg", "k1.obj_rend_mask.jpg",
                 "k1.color.json", "k1.mocap.ply", "k1.mocap.json")


def test_make_example_with_the_reference_body_is_the_asset(tmp_path,
                                                           monkeypatch):
    from chore_tpu_torch.tools import make_example

    monkeypatch.setattr(make_example, "posed_body", jax_posed_body)
    (frame,) = make_example.make_example(str(tmp_path), device="cpu")
    assert sorted(os.listdir(frame)) == sorted(EXAMPLE_FILES)
    for name in EXAMPLE_FILES:
        with open(os.path.join(frame, name), "rb") as f:
            got = f.read()
        with open(os.path.join(EXAMPLE, name), "rb") as f:
            assert got == f.read(), name


def test_make_example_with_its_own_body(tmp_path):
    """The port's SMPL-H puts its vertices within ~4e-7 m of XLA's (float32
    rounding, ~1 ulp at 2 m): masks and mocap parameters byte-equal, the
    vertices within 1e-6 m, keypoints within 1e-4 px, the colour image
    within one level on at most 100 pixels of its 3.1 million."""
    from chore_tpu_torch.data.imageio import read_rgb
    from chore_tpu_torch.tools import make_example
    from chore_tpu_torch.utils.meshio import load_ply

    (frame,) = make_example.make_example(str(tmp_path), device="cpu")
    for name in ("k1.person_mask.jpg", "k1.obj_rend_mask.jpg",
                 "k1.mocap.json"):
        with open(os.path.join(frame, name), "rb") as f:
            got = f.read()
        with open(os.path.join(EXAMPLE, name), "rb") as f:
            assert got == f.read(), name
    (va, fa), (vb, fb) = (load_ply(os.path.join(d, "k1.mocap.ply"))[:2]
                          for d in (frame, EXAMPLE))
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_allclose(va, vb, rtol=0, atol=1e-6)
    ka, kb = (np.array(json.load(open(os.path.join(d, "k1.color.json")))[
        "body_joints"]) for d in (frame, EXAMPLE))
    np.testing.assert_allclose(ka, kb, rtol=0, atol=1e-4)
    ia, ib = (read_rgb(os.path.join(d, "k1.color.jpg")).astype(np.int32)
              for d in (frame, EXAMPLE))
    diff = np.abs(ia - ib)
    assert diff.max() <= 1 and int(diff.any(-1).sum()) <= 100


def test_make_example_command_line(tmp_path):
    from chore_tpu_torch.tools import make_example

    make_example.main(["--out", str(tmp_path / "ex"), "--seed", "1",
                       "--device", "cpu"])
    assert os.listdir(tmp_path / "ex") == ["frame0000"]
    assert sorted(os.listdir(tmp_path / "ex" / "frame0000")) == \
        sorted(EXAMPLE_FILES)


# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tar(tmp_path_factory):
    """A reference ``checkpoint_*.tar`` at the tiny config of
    ``test_torch_port_train_ckpt.py``: every key the reference registers,
    prefixed ``module.``, and a torch Adam state after one step."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field

    model = build_field(FieldConfig(num_stack=1, num_hourglass=2,
                                    net_img_size=32), device="cpu", seed=4,
                        trainable=True).requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(1)
    for n, p in model.named_parameters():
        if ".bn4." not in n:
            p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    sd = {"module." + k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path_factory.mktemp("ref") / "checkpoint_0h:2m:3s_123.0.tar")
    torch.save({"model_state_dict": sd,
                "optimizer_state_dict": opt.state_dict(),
                "epoch": 7, "training_time": 123.0}, path)
    return path


TINY = dict(exp_name="imported", num_stack=1, num_hourglass=2,
            net_img_size=(32, 32), precision="float32")


def test_import_torch_matches_reference(tar, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    import chore_tpu.cli.common as jcommon
    import chore_tpu.config as jconfig

    from chore_tpu_torch.cli.common import load_trained
    from chore_tpu_torch.config import ChoreConfig
    from chore_tpu_torch.models.chore import build_field
    from chore_tpu_torch.models.convert import params_to_jax
    from chore_tpu_torch.tools import import_torch
    from chore_tpu_torch.train import Trainer, load_checkpoint
    from test_torch_port_util import assert_trees_close

    def build_model(cfg):
        """``chore_tpu``'s ``build_model`` with the template's shapes from
        ``jax.eval_shape`` (flax's eager init takes ~40 s on the CPU; the
        import reads only the template's structure and shapes)."""
        from chore_tpu.models import CHOREField

        model = CHOREField(cfg=cfg.field_config(),
                           encoder_dtype=cfg.encoder_dtype())
        return model, jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 64, 64, 5)),
                               jnp.zeros((1, 8, 3)), jnp.zeros((1, 2)),
                               train=False))

    monkeypatch.setattr(jcommon, "build_model", build_model)
    want = reference_tool("import_torch").import_checkpoint(
        tar, "imported", str(tmp_path / "j"), cfg=jconfig.ChoreConfig(**TINY))
    cfg = ChoreConfig(**TINY)
    got = import_torch.import_checkpoint(tar, "imported", str(tmp_path / "t"),
                                         cfg=cfg, device="cpu")
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()

    # the weights Trainer.import_torch loads from the same file
    trainer = Trainer(build_field(cfg.field_config(), device="cpu",
                                  trainable=True), str(tmp_path / "tr"),
                      ck_period_min=1e9)
    trainer.import_torch(tar)
    state, epoch, training_time, _ = load_checkpoint(got)
    assert (int(epoch), float(training_time)) == (0, 123.0)
    assert_trees_close(state["params"],
                       params_to_jax(trainer.model.state_dict()), 0)
    # and the CLIs' loader reads it
    model = load_trained(cfg, str(tmp_path / "t"), device="cpu")
    assert_trees_close(params_to_jax(model.state_dict()), state["params"], 0)


def test_import_torch_command_line(tar, tmp_path, monkeypatch):
    from chore_tpu_torch.config import ChoreConfig, save_config
    from chore_tpu_torch.tools import import_torch

    monkeypatch.chdir(tmp_path)
    save_config(ChoreConfig(**TINY), "configs")
    import_torch.main([tar, "--exp", "imported", "--exp-root", "exps",
                       "--device", "cpu"])
    assert os.listdir(tmp_path / "exps" / "imported" / "checkpoints") == [
        "checkpoint_0h:2m:3s_123.0.ckpt"]
