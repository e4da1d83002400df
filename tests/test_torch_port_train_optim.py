"""The port's training step and optimizers against ``chore_tpu``'s, at
float32 on the CPU (the tiny field, seeded numpy inputs and weights).
``chore_tpu``'s step is its Trainer's (the same loss under
``value_and_grad``, then the trainer's optax transformation), with the
gradient jitted once for the whole file (``jax_grad_fn``): a Trainer
compiles its own step per optimizer, most of a file's time.

* one step: loss and parts within 1e-5 relative, parameter gradients
  within 1e-4 of each tensor's largest;
* each optimizer's update alone against ``optax.inject_hyperparams`` on
  the same gradients (``optax_updates_match``);
* end to end, per optimizer: both trainers start from one JAX (params,
  opt_state), a ``chore_tpu`` checkpoint after two steps that the port
  resumes from, then take three steps across an epoch whose LR drops
  0.3x. Losses within 1e-5 relative; parameters within 1e-5. For Adam,
  an element whose JAX gradient at one of the three steps is nonzero but
  below 1e-6 of its tensor's largest (the frameworks' f32 rounding
  difference, the one-step test) is held only within the steps' summed
  LR: Adam divides each gradient by its running RMS, so such an element
  carries the rounding into its update at full size (the worst, in a
  conv kernel, 4.2e-5 apart; 3,972 such elements of 4,167,839). From
  zero moments the first update is lr g / (|g| + 1e-8), which does the
  same to every element whose gradient is rounding noise; the resumed
  moments avoid that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import (
    few_torch_threads,  # noqa: F401 - a fixture
    flat,
    jax_grad_fn,
    jax_train_params,
    optax_updates_match,
    port_trainer,
    resumed_steps_match,
    train_batch,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def grad_fn():
    from chore_tpu.models import CHOREField

    cfg, _ = jax_train_params()
    return jax_grad_fn(CHOREField(cfg=cfg))


def test_one_step_loss_parts_and_grads(grad_fn, tmp_path):
    from chore_tpu_torch.models.chore import chore_losses
    from chore_tpu_torch.models.convert import params_to_jax

    cfg, params = jax_train_params()
    batch = train_batch(np.random.RandomState(1))
    (jl, jparts), jg = grad_fn(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tt = port_trainer(cfg, params, tmp_path)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tparts = chore_losses(
        tt.model(tb["images"], tb["points"], tb["crop_center"]), tb,
        tt.cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k, v in jparts.items():
        np.testing.assert_allclose(float(tparts[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    grads = params_to_jax({n: p.grad for n, p in tt.named_params},
                          [n for n, _ in tt.named_params])
    got, want = flat(grads), flat(jg)
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("name", ["adam", "adadelta", "rmsprop"])
def test_updates_match_optax(name, tmp_path):
    optax_updates_match(name, tmp_path)


@pytest.mark.parametrize("name,noise_rel", [("adam", 1e-6),
                                            ("adadelta", None),
                                            ("rmsprop", None)])
def test_resumed_steps_across_lr_drop(grad_fn, tmp_path, name, noise_rel):
    resumed_steps_match(tmp_path, name, grad_fn, loss_rtol=1e-5, atol=1e-5,
                        noise_rel=noise_rel)
