"""The port's training step against ``chore_tpu``'s, at float32 on the CPU,
at the tiny field of ``tests/test_train.py`` (1 stack, 32^2 input, a few
hundred points), with seeded numpy inputs and weights:

* ``chore_losses`` on random predictions (df above clamp_thres: the leak;
  compact and tiled PCA targets): each part and the total within 1e-6
  relative, gradients with respect to the predictions within 1e-5 of each
  tensor's largest;
* a checkpoint the port writes restores in ``chore_tpu`` with equal arrays;
* ``multistep_lr`` and ``compute_val_loss`` (partial batches, weighted by
  their real size) equal to JAX.

The step and the optimizers: ``test_torch_port_train_optim.py``."""
import os

import jax
import jax.numpy as jnp
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
    train_batch,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _preds(rng, B, N, stacks=2):
    """Random head outputs; df spans [-0.1, 0.3] so some lie above
    clamp_thres (0.1)."""
    return [{"df": rng.uniform(-0.1, 0.3, (B, N, 2)).astype(np.float32),
             "pca": rng.randn(B, N, 3, 3).astype(np.float32),
             "parts": rng.randn(B, N, 14).astype(np.float32),
             "centers": rng.randn(B, N, 6).astype(np.float32)}
            for _ in range(stacks)]


@pytest.mark.parametrize("tiled_pca", [False, True])
def test_chore_losses_match_jax(tiled_pca):
    from chore_tpu.models import FieldConfig as JCfg
    from chore_tpu.models import chore_losses as jlosses
    from chore_tpu_torch.models.chore import FieldConfig, chore_losses

    rng = np.random.RandomState(0)
    B, N = 3, 50
    batch = train_batch(rng, B=B, N=N)
    if tiled_pca:
        batch["pca"] = np.ascontiguousarray(
            np.broadcast_to(batch["pca"][:, None], (B, N, 3, 3)))
    preds = _preds(rng, B, N)
    assert (np.stack([p["df"] for p in preds]) > 0.1).any()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(p):
        return jlosses(p, jb, JCfg())

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, preds))
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in preds]
    tl, tparts = chore_losses(tp, {k: torch.as_tensor(v)
                                   for k, v in batch.items()}, FieldConfig())
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert set(tparts) == set(jparts)
    for k, v in jparts.items():
        np.testing.assert_allclose(float(tparts[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    for s, (pt, pj) in enumerate(zip(tp, jgrads)):
        for k, g in pj.items():
            g = np.asarray(g)
            np.testing.assert_allclose(pt[k].grad.numpy(), g, rtol=0,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=f"stack {s} {k}")


def test_multistep_lr_matches_jax():
    from chore_tpu.train import multistep_lr as jlr
    from chore_tpu_torch.train import multistep_lr

    for ms, gamma in (((15, 25), 0.3), ((1,), 0.5), ((), 0.3)):
        a, b = multistep_lr(1e-3, ms, gamma), jlr(1e-3, ms, gamma)
        assert [a(e) for e in range(40)] == [b(e) for e in range(40)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX trainer, its params, cfg): its optax state is the checkpoint
    template, its ``compute_val_loss`` the reference."""
    from chore_tpu.models import CHOREField

    cfg, params = jax_train_params()
    jt = jax_trainer(CHOREField(cfg=cfg), params,
                     tmp_path_factory.mktemp("jexp"))
    return jt, params, cfg


def test_port_checkpoint_restores_in_jax(pair, tmp_path):
    """The port trains two steps and saves; ``chore_tpu``'s
    ``load_checkpoint`` restores params, the optax state (count, moments,
    hyperparameters), epoch, time and step equal to what the port
    holds, and the raw payload has the keys, shapes and dtypes of one
    ``chore_tpu`` writes."""
    import optax

    from chore_tpu.train.checkpoints import find_checkpoint, load_checkpoint
    from chore_tpu_torch.train.checkpoints import checkpoint_name

    jt, params, cfg = pair
    tt = port_trainer(cfg, params, tmp_path)
    rng = np.random.RandomState(5)
    tt.set_epoch_lr(1)
    for _ in range(2):
        tt.train_step(train_batch(rng))
    tt.epoch, tt.training_time = 3, 4000.5
    name = tt.save()
    assert name == checkpoint_name(4000.5) == "checkpoint_1h:6m:40s_4000.5.ckpt"
    template = {"params": params,
                "opt_state": jax.device_get(jt.opt_state)}
    state, epoch, secs, step = load_checkpoint(
        find_checkpoint(str(tmp_path)), template)
    assert (epoch, secs, step) == (3, 4000.5, 2)
    mine = tt.state()
    assert_trees_close(state["params"], mine["params"], 0)
    inner = state["opt_state"].inner_state[0]
    assert isinstance(inner, optax.ScaleByAdamState)
    assert int(inner.count) == int(state["opt_state"].count) == 2
    assert_trees_close(inner.mu, mine["opt_state"]["inner_state"]["0"]["mu"], 0)
    assert_trees_close(inner.nu, mine["opt_state"]["inner_state"]["0"]["nu"], 0)
    lr = float(state["opt_state"].hyperparams["learning_rate"])
    np.testing.assert_allclose(lr, 3e-4, rtol=1e-6)
    # the layout is the one chore_tpu writes: every key, shape and dtype
    # of the raw payload equal to a JAX-written checkpoint's
    from flax import serialization

    jt.exp_dir = str(tmp_path / "jax")
    raw = [serialization.msgpack_restore(open(p, "rb").read())
           for p in (find_checkpoint(str(tmp_path)),
                     os.path.join(jt.exp_dir, "checkpoints", jt.save()))]
    mine, ref = flat(raw[0]), flat(raw[1])
    assert set(mine) == set(ref)
    assert all(mine[k].shape == v.shape and mine[k].dtype == v.dtype
               for k, v in ref.items())
    # the name exists: a second save keeps the first file
    assert tt.save() == name and len(os.listdir(tmp_path / "checkpoints")) == 1


def test_compute_val_loss_matches_jax(pair, tmp_path):
    """Batches of 3 and 2 (a trailing partial batch): each batch's loss
    and the size-weighted mean, within 1e-5 relative."""
    jt, params, cfg = pair
    tt = port_trainer(cfg, params, tmp_path)
    rng = np.random.RandomState(2)
    b3, b2 = train_batch(rng, B=3), train_batch(rng, B=2)
    for batches in ([b3], [b2], [b3, b2]):
        np.testing.assert_allclose(tt.compute_val_loss(batches),
                                   jt.compute_val_loss(batches), rtol=1e-5)
    assert tt.compute_val_loss([]) == float("inf")
