"""Point generation against ``chore_tpu``: the port's Generator, fed the
random numbers the JAX sampler draws from the same key (replayed through
the same ``jax.random`` splits), on the same field weights.

The df head's output bias is set so that the human field has a frame with
no survivors (the fresh-sample fallback and the all-by-df-rank compaction)
and one with a few, and the object field a few in both: the survivor
resampling, the stable compaction and the valid-weighted means all run.
Tolerance 1e-4 on survivors, centres and axes: f32 noise through the
projection steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_util import (
    assert_clouds_match,
    jax_field,
    jax_sampler_draws,
    t,
    torch_field,
)

SAMP = dict(num_steps=3, sample_num=512, num_rounds=3, num_points=200,
            filter_val=0.004)


@pytest.fixture(scope="module")
def generated():
    from chore_tpu.recon.generator import Generator as JG
    from chore_tpu.recon.generator import SamplerConfig as JS
    from chore_tpu_torch.recon.generator import Generator as TG
    from chore_tpu_torch.recon.generator import SamplerConfig as TS

    model, params = jax_field(seed=2)
    p = jax.tree_util.tree_map(np.asarray, params)
    p["params"]["df"]["fc_out"]["bias"] = np.array([0.002, 0.006], np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, p)

    rng = np.random.RandomState(0)
    images = rng.rand(2, 64, 64, 5).astype(np.float32)
    cc = np.array([[1018.0, 779.0], [1000.0, 760.0]], np.float32)
    key = jax.random.PRNGKey(7)
    gj = JG(model, params, JS(**SAMP))
    fj, tj = gj.encode(images)
    gt = TG(torch_field(params), TS(**SAMP), device="cpu")
    ft, tt = gt.encode(images)
    out = {}
    for df_idx in (0, 1):
        out[df_idx] = (
            gj.sample_from_feats(fj, tj, jnp.asarray(cc), key, df_idx),
            gt.sample_from_feats(ft, tt, cc, df_idx,
                                 draws=jax_sampler_draws(key, 2, JS(**SAMP))))
    return out


@pytest.mark.parametrize("df_idx", [0, 1])
def test_generator_matches(generated, df_idx):
    assert_clouds_match(*generated[df_idx])


def test_survivors_exercised(generated):
    """Both the no-survivor fallback and partial survival occur."""
    nv = np.concatenate([np.asarray(generated[i][0]["n_valid"])
                         for i in (0, 1)])
    assert (nv == 0).any()
    assert ((nv > 0) & (nv < SAMP["num_points"])).any()


def test_generator_rng_is_seeded():
    """Without injected draws the port draws from its torch.Generator:
    the same seed gives the same cloud."""
    import torch

    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.recon.generator import Generator, SamplerConfig

    gen = Generator(build_field(FieldConfig(num_stack=1), device="cpu"),
                    SamplerConfig(num_steps=1, sample_num=64, num_rounds=2,
                                  num_points=32), device="cpu")
    img = t(np.random.RandomState(0).rand(1, 64, 64, 5))
    cc = t([[1018.0, 779.0]])
    a = gen.generate_pclouds(img, cc, torch.Generator().manual_seed(3))
    b = gen.generate_pclouds(img, cc, torch.Generator().manual_seed(3))
    assert torch.equal(a["object"]["points"], b["object"]["points"])
