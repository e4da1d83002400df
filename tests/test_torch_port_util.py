"""Shared helpers of the ``test_torch_port_*`` files: the same seeded
inputs and the same weights into ``chore_tpu`` and ``chore_tpu_torch``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_field(num_stack=2, seed=0, perturb=0.01):
    """(flax model, params) of a small CHOREField with seeded numpy
    weights: kernels N(0, 0.02), norm scales 1 and biases 0 each plus a
    ``perturb``-sized N(0, 1) offset, so no norm or bias sits at its init.
    Shapes come from ``jax.eval_shape`` (running flax's init eagerly on the
    CPU takes ~15 s)."""
    from chore_tpu.models import CHOREField, FieldConfig

    model = CHOREField(cfg=FieldConfig(num_stack=num_stack))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 64, 64, 5)), jnp.zeros((1, 8, 3)),
                            jnp.zeros((1, 2)))
    rng = np.random.RandomState(seed + 1)

    def leaf(path, sds):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.randn(*sds.shape).astype(np.float32)
        base = {"kernel": 0.02 * z, "scale": 1.0 + perturb * z}
        return jnp.asarray(base.get(name, perturb * z))

    return model, jax.tree_util.tree_map_with_path(leaf, shapes)


def torch_field(params, num_stack=2):
    """The port's CHOREField on the CPU with the same weights."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.models.convert import params_from_jax

    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return build_field(FieldConfig(num_stack=num_stack), device="cpu",
                       state_dict=sd)


def jax_sampler_draws(key, batch_size, cfg):
    """The random numbers ``chore_tpu``'s sampler draws from ``key``, in the
    port's injected-draws layout (same key splits as
    ``make_surface_sampler.sample``)."""
    k_init, k_loop = jax.random.split(key)
    u_init = jax.random.uniform(k_init, (batch_size, cfg.sample_num, 3))
    us, noise, fresh = [], [], []
    for k in jax.random.split(k_loop, cfg.num_rounds):
        k1, k2, k3 = jax.random.split(k, 3)
        us.append(jax.random.uniform(k1, (batch_size, cfg.sample_num)))
        noise.append(jax.random.normal(k2, (batch_size, cfg.sample_num, 3)))
        fresh.append(jax.random.normal(k3, (batch_size, cfg.sample_num, 3)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {"init_u": t(u_init), "u": t(jnp.stack(us)),
            "noise": t(jnp.stack(noise)), "fresh": t(jnp.stack(fresh))}


def jax_fit_draws(key, batch_size, cfg):
    """Injected point-generation draws matching ``ReconFitter.fit_batch``'s
    key splits (k_gen -> human, object)."""
    k_gen = jax.random.split(key, 3)[0]
    kh, ko = jax.random.split(k_gen)
    return {"human": jax_sampler_draws(kh, batch_size, cfg),
            "object": jax_sampler_draws(ko, batch_size, cfg)}


def assert_clouds_match(oj, ot, atol=1e-4):
    """A generated cloud of ``chore_tpu`` (oj) and of the port (ot) agree:
    the same valid mask; centres, axes and the survivors (which come first,
    in round-then-index order) within ``atol``; the rest, ranked by df where
    f32 noise may swap near-equal values, the same points as a set within
    10 * atol."""
    np.testing.assert_array_equal(n(ot["valid"]), np.asarray(oj["valid"]))
    nv = np.asarray(oj["n_valid"])
    np.testing.assert_array_equal(n(ot["n_valid"]), nv)
    for k in ("centers", "pca_axis"):
        np.testing.assert_allclose(n(ot[k]), np.asarray(oj[k]), atol=atol,
                                   err_msg=k)
    pj, pt = np.asarray(oj["points"]), n(ot["points"])
    parts_j, parts_t = np.asarray(oj["parts"]), n(ot["parts"])
    for b, v in enumerate(nv):
        np.testing.assert_allclose(pt[b, :v], pj[b, :v], atol=atol)
        np.testing.assert_array_equal(parts_t[b, :v], parts_j[b, :v])
        d = np.sqrt(((pt[b, v:, None] - pj[b, None, v:]) ** 2).sum(-1))
        if d.size:
            assert d.min(0).max() < 10 * atol and d.min(1).max() < 10 * atol


def t(a, dtype=torch.float32):
    """numpy/jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def test_draws_replay_the_jax_sampler():
    """The replayed draws are the JAX sampler's: its scene-box init from
    the same key equals the port's box built from ``init_u``."""
    from chore_tpu.recon.generator import SamplerConfig, init_box_samples
    from chore_tpu_torch.recon.generator import BOX_HI, BOX_LO

    cfg = SamplerConfig(sample_num=64, num_rounds=3)
    key = jax.random.PRNGKey(4)
    d = jax_sampler_draws(key, 2, cfg)
    assert tuple(d["u"].shape) == (3, 2, 64)
    assert tuple(d["noise"].shape) == tuple(d["fresh"].shape) == (3, 2, 64, 3)
    want = init_box_samples(jax.random.split(key)[0], 2, 64)
    lo, hi = torch.tensor(BOX_LO), torch.tensor(BOX_HI)
    np.testing.assert_allclose(n(lo + d["init_u"] * (hi - lo)),
                               np.asarray(want), atol=1e-6)
