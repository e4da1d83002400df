"""The port's training at the release "mixed" precision (bfloat16 convs,
float32 norms and heads) against ``chore_tpu``'s, on the CPU at the tiny
field. bf16 rounds each conv's inputs and weights to 8 bits, and the two
frameworks round and sum at different places, so the bounds are looser
than float32's (``test_torch_port_train.py``: 1e-5 and 1e-4);
``test_torch_port_mixed.py`` holds the bf16 forward at 3e-2.

* one step: loss and parts within 1e-4 relative; the gradient of all
  parameters (one vector) within 1e-2 relative in norm, and each
  tensor's within 0.5 (a wrong or missing gradient is 1 or more). A
  bias or norm gradient is a sum over the whole map, so its bf16
  rounding difference is large against the sum: 0.23 at most here;
* both trainers from one JAX (params, opt_state) (a ``chore_tpu``
  checkpoint after two Adam steps), then three steps across an LR drop:
  losses within 1e-4 relative, the update of all parameters within 0.1
  relative in norm (Adam carries each element's gradient difference
  into its update at full size).

``chore_tpu``'s step is its Trainer's, with the gradient jitted once for
the file (``jax_grad_fn``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import (
    few_torch_threads,  # noqa: F401 - a fixture
    flat,
    jax_grad_fn,
    jax_train_params,
    port_trainer,
    resumed_steps_match,
    train_batch,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def grad_fn():
    from chore_tpu.models import CHOREField

    cfg, _ = jax_train_params()
    return jax_grad_fn(CHOREField(cfg=cfg, encoder_dtype=jnp.bfloat16))


def test_mixed_one_step_loss_and_grads(grad_fn, tmp_path):
    from chore_tpu_torch.models.chore import chore_losses
    from chore_tpu_torch.models.convert import params_to_jax

    cfg, params = jax_train_params()
    batch = train_batch(np.random.RandomState(1))
    (jl, jparts), jg = grad_fn(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tt = port_trainer(cfg, params, tmp_path, encoder_dtype=torch.bfloat16)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tparts = chore_losses(
        tt.model(tb["images"], tb["points"], tb["crop_center"]), tb, tt.cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k, v in jparts.items():
        np.testing.assert_allclose(float(tparts[k].detach()), float(v),
                                   rtol=1e-4, err_msg=k)
    got = flat(params_to_jax({n: p.grad for n, p in tt.named_params},
                             [n for n, _ in tt.named_params]))
    want = flat(jg)
    assert set(got) == set(want)
    for k, g in want.items():
        rel = np.linalg.norm(got[k] - g) / np.linalg.norm(g)
        assert rel < 0.5, (k, rel)
    keys = sorted(want)
    gt = np.concatenate([got[k].ravel() for k in keys])
    gj = np.concatenate([want[k].ravel() for k in keys])
    assert np.linalg.norm(gt - gj) / np.linalg.norm(gj) < 1e-2


def test_mixed_adam_resumed_steps_across_lr_drop(grad_fn, tmp_path):
    resumed_steps_match(tmp_path, "adam", grad_fn, loss_rtol=1e-4,
                        update_rtol=0.1, mixed=True)
