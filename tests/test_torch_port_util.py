"""Shared helpers of the ``test_torch_port_*`` files: the same seeded
inputs and the same weights into ``chore_tpu`` and ``chore_tpu_torch``."""
import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def run_both_fits(fit_kw, samp_kw, frame, use_silhouette, edit_params=None):
    """``fit_batch`` of ``chore_tpu`` and of the port (CPU, traces
    recorded) on the same frame, weights, SMPL-H arrays and point-generation
    draws. Both add the same fixed 1e-3 matrix before every SO(3)
    projection: with ``svd_jitter=False`` an exact rotation makes the SVD
    backward 0/0 and every object step is skipped as non-finite; the fixed
    matrix is the deterministic stand-in for the production jitter.
    ``edit_params``: optional function of the field's flax params that
    returns the params both fits use."""
    import chore_tpu.recon.fitter as jfit
    import chore_tpu_torch.recon.fitter as tfit
    from chore_tpu.recon.generator import SamplerConfig as JSamp
    from chore_tpu.smpl import SMPLH as JSMPLH
    from chore_tpu.smpl import synthetic_smplh
    from chore_tpu.utils.meshio import octasphere
    from chore_tpu_torch.recon.generator import SamplerConfig as TSamp
    from chore_tpu_torch.smpl import SMPLH as TSMPLH

    model, params = jax_field()
    if edit_params is not None:
        params = edit_params(params)
    arrays = synthetic_smplh()
    tv, tf = octasphere(radius=0.18, subdiv=1)
    key = jax.random.PRNGKey(0)
    with fixed_so3_jitter():
        fj = jfit.ReconFitter(model, params, JSMPLH(arrays), tv, tf,
                              cfg=jfit.FitConfig(**fit_kw),
                              sampler_cfg=JSamp(**samp_kw),
                              record_traces=True)
        out_j = fj.fit_batch(*frame, key=key, use_silhouette=use_silhouette)
        ft = tfit.ReconFitter(torch_field(params), TSMPLH(arrays, device="cpu"),
                              tv, tf, cfg=tfit.FitConfig(**fit_kw),
                              sampler_cfg=TSamp(**samp_kw), record_traces=True,
                              device="cpu")
        out_t = ft.fit_batch(*frame, use_silhouette=use_silhouette,
                             draws=jax_fit_draws(key, len(frame[0]),
                                                 JSamp(**samp_kw)))
    return out_j, out_t


@contextlib.contextmanager
def fixed_so3_jitter():
    """Both packages add the same fixed 1e-3 matrix before every SO(3)
    projection (the deterministic stand-in for the production jitter; see
    ``run_both_fits``)."""
    import chore_tpu.ops.rotation as jrot
    import chore_tpu.recon.fitter as jfit
    import chore_tpu_torch.ops.rotation as trot
    import chore_tpu_torch.recon.fitter as tfit

    jitter = (1e-3 * np.random.RandomState(5).rand(3, 3)).astype(np.float32)
    j_proj, t_proj = jrot.project_so3, trot.project_so3
    jrot.project_so3 = jfit.project_so3 = lambda m: j_proj(m + jitter)
    jit_t = torch.from_numpy(jitter)
    trot.project_so3 = tfit.project_so3 = lambda m: t_proj(m + jit_t)
    try:
        yield
    finally:
        jrot.project_so3 = jfit.project_so3 = j_proj
        trot.project_so3 = tfit.project_so3 = t_proj


def stacked_trace(traces, names):
    """(loss, live) of the named phases' per-step traces, concatenated."""
    loss = np.concatenate([np.asarray(traces[k]["loss"]).ravel()
                           for k in names])
    live = np.concatenate([np.asarray(traces[k]["live"]).ravel()
                           for k in names])
    return loss, live


def assert_traces_match(traces_j, traces_t, names, moved=False):
    """Per-step weighted loss of the named phases: equal live masks
    (the same early-stop decisions) and relative 1e-3 -- f32 noise
    compounding over a few dozen Adam steps, where a structural mismatch
    (a wrong decay, anchor, sigma level, a reset optimizer, a missing term)
    moves the trace by percent within a step or two. ``moved``: the loss
    must also change along the live steps."""
    lj, vj = stacked_trace(traces_j, names)
    lt, vt = stacked_trace(traces_t, names)
    np.testing.assert_array_equal(vj, vt)
    rel = np.abs(lj - lt) / np.maximum(np.abs(lj), 1e-6)
    assert rel.max() < 1e-3, f"max rel {rel.max():.3e} at {rel.argmax()}"
    if moved:
        assert np.ptp(lj[vj]) > 0


SIL_FIT = dict(iter_betas=1, iter_pose=1, iter_kpts=1, iter_kpts_max=2,
               iter_obj=2, iter_sil=2, iter_joint=1, iter_joint_max=4,
               steps_per_iter=3, obj_samples=128, net_in_size=64,
               sil_rend_size=64, svd_jitter=False)
SIL_SAMP = dict(num_steps=2, sample_num=256, num_rounds=2, num_points=128)


def sil_frame(seed=0, person=(30, 36, 12, 20), disk=(36.4, 31.2, 11.3),
              crop_center=(1018.0, 779.0), S=64):
    """A 64^2 frame (batch of one) whose channel 3 is a person box (centre
    x, y, half-width, half-height) and channel 4 an object disk (centre x,
    y, radius), so the silhouette ROI is a real crop; the rest seeded
    noise."""
    rng = np.random.RandomState(seed)
    images = rng.rand(1, S, S, 5).astype(np.float32)
    yy, xx = np.mgrid[:S, :S]
    px, py, hw, hh = person
    images[0, ..., 3] = (np.abs(xx - px) < hw) & (np.abs(yy - py) < hh)
    dx, dy, r = disk
    images[0, ..., 4] = (xx - dx) ** 2 + (yy - dy) ** 2 < r ** 2
    cc = np.array([crop_center], np.float32)
    pose = (rng.randn(1, 72) * 0.05).astype(np.float32)
    betas = (0.1 * rng.randn(1, 10)).astype(np.float32)
    kpts = np.concatenate(
        [(S * rng.rand(1, 25, 2)).astype(np.float32),
         (0.3 + 0.7 * rng.rand(1, 25, 1)).astype(np.float32)], -1)
    return images, cc, pose, betas, kpts


def sil_fit_case(options=None):
    """Both packages' ``fit_batch(use_silhouette=True)`` at a cut budget
    (2 'sil' iterations of 3 steps, 64^2 render) on ``sil_frame()``;
    ``options`` are extra FitConfig fields."""
    return run_both_fits(dict(SIL_FIT, **(options or {})), SIL_SAMP,
                         sil_frame(), use_silhouette=True)


def assert_final_params_match(out_j, out_t):
    """Final SMPL and object parameters, 1e-3 absolute (the trace noise
    carried into the parameters)."""
    for k, v in out_j["smpl_params"].items():
        np.testing.assert_allclose(n(out_t["smpl_params"][k]), np.asarray(v),
                                   atol=1e-3, err_msg=k)
    for k, v in out_j["obj_params"].items():
        np.testing.assert_allclose(n(out_t["obj_params"][k]), np.asarray(v),
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(n(out_t["obj_R"]), np.asarray(out_j["obj_R"]),
                               atol=1e-3)
    np.testing.assert_allclose(n(out_t["scale"]), np.asarray(out_j["scale"]),
                               atol=1e-4)
    assert all(np.isfinite(n(v)).all() for v in out_t["obj_params"].values())


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


def test_init_box_samples():
    """The public scene-box sampler: ``chore_tpu``'s box mapping of the same
    unit draws (1e-6), and the port's draws from a seeded generator lie in
    the box, (batch, n, 3)."""
    from chore_tpu.recon.generator import init_box_samples as jinit
    from chore_tpu_torch.recon.generator import (
        BOX_HI,
        BOX_LO,
        box_samples,
        init_box_samples,
    )

    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (2, 50, 3))
    np.testing.assert_allclose(n(box_samples(t(u))),
                               np.asarray(jinit(key, 2, 50)), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    got = init_box_samples(g, 3, 40)
    want = box_samples(torch.rand((3, 40, 3),
                                  generator=torch.Generator().manual_seed(0)))
    assert got.shape == (3, 40, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got >= torch.tensor(BOX_LO)).all()
    assert (got <= torch.tensor(BOX_HI)).all()


# --------------------------------------------------------------------- #
# the entry points: a small config on the committed example frame
EXAMPLE_SEQ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "chore_tpu_torch", "assets", "example_synth")
EXAMPLE = os.path.join(EXAMPLE_SEQ, "frame0000", "k1.color.jpg")
SMALL_CFG = dict(exp_name="small", num_stack=2, net_img_size=(64, 64),
                 precision="float32")
API_FIT = dict(iter_betas=1, iter_pose=1, iter_kpts=1, iter_kpts_max=2,
               iter_obj=2, iter_sil=2, iter_joint=1, iter_joint_max=4,
               steps_per_iter=3, obj_samples=128, net_in_size=64,
               sil_rend_size=64, svd_jitter=False)
API_SAMP = dict(num_steps=2, sample_num=256, num_rounds=2, num_points=128)


def write_jax_checkpoint(exp_root, exp_name="small"):
    """``chore_tpu``'s checkpoint of ``jax_field()``'s weights under
    EXP_ROOT/<exp_name>/checkpoints."""
    from chore_tpu.train.checkpoints import save_checkpoint

    _, params = jax_field()
    save_checkpoint(os.path.join(str(exp_root), exp_name, "checkpoints"),
                    {"params": params}, 60.0, 1)
    return params


def api_pair(tmp_path, use_silhouette):
    """``Reconstructor.reconstruct`` of ``chore_tpu`` (key 0) and of the
    port (CPU, the same draws replayed) on the example frame, both loading
    one JAX checkpoint, at the small config, under the fixed SO(3) jitter.
    Returns (out_j, out_t, port Reconstructor)."""
    from chore_tpu.api import Reconstructor as JRec
    from chore_tpu.config import ChoreConfig as JCfg
    from chore_tpu.recon.fitter import FitConfig as JFit
    from chore_tpu.recon.generator import SamplerConfig as JSamp
    from chore_tpu_torch.api import Reconstructor as TRec
    from chore_tpu_torch.config import ChoreConfig as TCfg
    from chore_tpu_torch.recon.fitter import FitConfig as TFit
    from chore_tpu_torch.recon.generator import SamplerConfig as TSamp

    exp_root = tmp_path / "experiments"
    write_jax_checkpoint(exp_root)
    key = jax.random.PRNGKey(0)
    with fixed_so3_jitter():
        rj = JRec(JCfg(**SMALL_CFG), obj_name="basketball",
                  exp_root=str(exp_root), fit_cfg=JFit(**API_FIT),
                  sampler_cfg=JSamp(**API_SAMP),
                  crop_info_dir=str(tmp_path))
        out_j = rj.reconstruct(EXAMPLE, use_silhouette=use_silhouette,
                               key=key)
        rt = TRec(TCfg(**SMALL_CFG), obj_name="basketball",
                  exp_root=str(exp_root), fit_cfg=TFit(**API_FIT),
                  sampler_cfg=TSamp(**API_SAMP), crop_info_dir=str(tmp_path),
                  device="cpu")
        out_t = rt.reconstruct(EXAMPLE, use_silhouette=use_silhouette,
                               draws=jax_fit_draws(key, 1,
                                                   JSamp(**API_SAMP)))
    return out_j, out_t, rt


def assert_api_outputs_match(out_j, out_t):
    """The same keys; vertices and parameters within
    ``assert_final_params_match``'s 1e-3 (numpy on both sides)."""
    assert set(out_t) == set(out_j)
    for k in ("smpl_verts", "obj_verts", "obj_R"):
        assert out_t[k].shape == np.shape(out_j[k]), k
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), atol=1e-3,
                                   err_msg=k)
    for group in ("smpl_params", "obj_params"):
        assert set(out_t[group]) == set(out_j[group])
        for k, v in out_j[group].items():
            np.testing.assert_allclose(out_t[group][k], np.asarray(v),
                                       atol=1e-3, err_msg=f"{group}/{k}")
    np.testing.assert_array_equal(out_t["smpl_faces"], out_j["smpl_faces"])
    np.testing.assert_array_equal(out_t["obj_faces"], out_j["obj_faces"])
    assert out_t["paths"] == out_j["paths"]
    for k, v in out_j["crop_info"][0].items():
        np.testing.assert_array_equal(out_t["crop_info"][0][k], v)


# --------------------------------------------------------------------- #
# training: the tiny field of tests/test_train.py, batches, both trainers
@pytest.fixture(scope="module", autouse=False)
def few_torch_threads():
    """Two intra-op threads for the tiny field's steps: the tier-1 run has
    six workers on the host's cores, and PyTorch's default (one thread per
    core) each spinning in every small op oversubscribes them many times
    over. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
TRAIN_FIELD = dict(num_stack=1, num_hourglass=2, net_img_size=32)


def jax_train_params(seed=0, **field):
    """(flax CHOREField, params) at TRAIN_FIELD (or ``field``) with
    ``jax_field``'s seeded numpy weights."""
    from chore_tpu.models import CHOREField, FieldConfig

    cfg = FieldConfig(**{**TRAIN_FIELD, **field})
    model = CHOREField(cfg=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 32, 32, 5)), jnp.zeros((1, 8, 3)),
                            jnp.zeros((1, 2)))
    rng = np.random.RandomState(seed + 1)

    def leaf(path, sds):
        name = getattr(path[-1], "key", str(path[-1]))
        z = rng.randn(*sds.shape).astype(np.float32)
        return jnp.asarray({"kernel": 0.02 * z,
                            "scale": 1.0 + 0.01 * z}.get(name, 0.01 * z))

    return cfg, jax.tree_util.tree_map_with_path(leaf, shapes)


def train_batch(rng, B=2, N=200, img=32):
    """A seeded training batch as ``BehaveTrainData`` gives it: uint8 images,
    points in front of the camera, UDFs on both sides of clamp_thres and
    of the 0.05 mask, compact (B, 3, 3) PCA targets."""
    return {
        "images": rng.randint(0, 256, (B, img, img, 5)).astype(np.uint8),
        "points": (rng.rand(B, N, 3) * [1, 1, 0.5]
                   + [-0.5, -0.5, 1.95]).astype(np.float32),
        "crop_center": np.tile([[1018.0, 779.0]], (B, 1)).astype(np.float32),
        "df_h": (np.abs(rng.randn(B, N)) * 0.1).astype(np.float32),
        "df_o": (np.abs(rng.randn(B, N)) * 0.1).astype(np.float32),
        "parts": rng.randint(0, 14, (B, N)).astype(np.int32),
        "pca": rng.randn(B, 3, 3).astype(np.float32),
        "body_center": np.tile([[0.0, 0, 2.2]], (B, 1)).astype(np.float32),
        "obj_center": (0.3 * rng.randn(B, 3)).astype(np.float32),
    }


def jax_trainer(model, params, exp_dir, optimizer="adam", milestones=(1,)):
    """``chore_tpu``'s Trainer on a one-device mesh."""
    from chore_tpu.parallel import make_mesh
    from chore_tpu.train import Trainer

    return Trainer(model, params, str(exp_dir),
                   mesh=make_mesh(devices=jax.devices()[:1]),
                   milestones=milestones, optimizer=optimizer,
                   ck_period_min=1e9)


def port_trainer(cfg, params, exp_dir, optimizer="adam", milestones=(1,),
                 encoder_dtype=torch.float32):
    """The port's Trainer on the CPU with the same weights."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.models.convert import params_from_jax
    from chore_tpu_torch.train import Trainer

    tcfg = FieldConfig(**{f: getattr(cfg, f) for f in (
        "num_stack", "num_hourglass", "net_img_size")})
    model = build_field(tcfg, device="cpu", trainable=True,
                        encoder_dtype=encoder_dtype,
                        state_dict=params_from_jax(
                            jax.tree_util.tree_map(np.asarray, params)))
    return Trainer(model, str(exp_dir), milestones=milestones,
                   optimizer=optimizer, ck_period_min=1e9)


def flat(tree):
    """{path string: numpy leaf} of a nested dict / pytree."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, want, atol, err=""):
    """Equal keys, every leaf within ``atol``."""
    got, want = flat(got), flat(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                   err_msg=f"{err}{k}")


def jax_grad_fn(model):
    """``chore_tpu``'s training loss and its gradient, jitted once: the
    Trainer's ``loss_fn`` (``model.apply`` + ``chore_losses``) under
    ``jax.value_and_grad``. One compile serves every step and optimizer
    of a test file (a Trainer compiles its own step, per optimizer)."""
    from chore_tpu.models import chore_losses

    def loss_fn(params, batch):
        preds = model.apply(params, batch["images"], batch["points"],
                            batch["crop_center"])
        return chore_losses(preds, batch, model.cfg)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@functools.lru_cache(maxsize=None)
def optax_update_fn(name):
    """(tx, update): ``chore_tpu``'s Trainer transformation for optimizer
    ``name`` (``optax.inject_hyperparams(name)(learning_rate=1e-3)``; the
    LR lives in the state) and it with ``optax.apply_updates``, jitted
    once per process (eager optax compiles each op for each leaf shape)."""
    import optax

    tx = optax.inject_hyperparams(getattr(optax, name))(learning_rate=1e-3)

    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return tx, jax.jit(update)


def jax_step(jt, grad_fn, update_fn, batch):
    """``chore_tpu``'s ``Trainer.train_step`` on ``jt``: the gradient from
    ``grad_fn``, then ``update_fn`` (``optax_update_fn``'s, the same
    transformation as ``jt.tx``). Returns (loss, gradients)."""
    (loss, _), grads = grad_fn(jt.params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    jt.params, jt.opt_state = update_fn(grads, jt.opt_state, jt.params)
    jt.global_step += 1
    return loss, grads


def resumed_steps_match(tmp_path, optimizer, grad_fn, loss_rtol, atol=None,
                        update_rtol=None, warm=2, steps=(1, 2), mixed=False,
                        noise_rel=None):
    """Start both trainers from one JAX (params, opt_state):
    ``chore_tpu``'s trainer takes ``warm`` steps (``jax_step``) on one
    batch and saves; the port resumes from that checkpoint. Then both take
    steps[0] steps at epoch 0 and steps[1] at epoch 1 (milestone 1: the LR
    drops 0.3x) on other batches: per-step losses within ``loss_rtol``;
    the parameters within ``atol``, or the update of all parameters (one
    vector, from the resumed point) within ``update_rtol`` relative in
    norm.

    ``noise_rel``: an element whose JAX gradient, at one of these steps,
    is nonzero but below ``noise_rel`` of its tensor's largest, is
    rounding noise; those elements (at most 0.2% of all) are held within
    the steps' summed LR, the most an Adam update can move them, and every
    other element within ``atol``."""
    from chore_tpu.models import CHOREField
    from chore_tpu_torch.models.convert import params_to_jax

    cfg, params = jax_train_params()
    jt = jax_trainer(CHOREField(cfg=cfg, encoder_dtype=(
        jnp.bfloat16 if mixed else jnp.float32)), params, tmp_path / "exp",
        optimizer)
    update_fn = optax_update_fn(optimizer)[1]
    rng = np.random.RandomState(3)
    jt.set_epoch_lr(0)
    for _ in range(warm):
        jax_step(jt, grad_fn, update_fn, train_batch(rng))
    jt.save()
    tt = port_trainer(cfg, params, tmp_path / "exp", optimizer,
                      encoder_dtype=torch.bfloat16 if mixed else torch.float32)
    assert tt.load() and tt.global_step == warm
    start = flat(jax.device_get(jt.params))
    noise = {k: np.zeros(v.shape, bool) for k, v in start.items()}
    lr_sum = 0.0
    for epoch, n in enumerate(steps):
        lr = jt.set_epoch_lr(epoch)
        assert lr == tt.set_epoch_lr(epoch)
        for _ in range(n):
            b = train_batch(rng)
            lj, gj = jax_step(jt, grad_fn, update_fn, b)
            lt, _ = tt.train_step(b)
            np.testing.assert_allclose(float(lt), float(lj), rtol=loss_rtol)
            lr_sum += lr
            if noise_rel is not None:
                for k, g in flat(jax.device_get(gj)).items():
                    g = np.abs(np.asarray(g))
                    noise[k] |= (g > 0) & (g < noise_rel * g.max())
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    got = params_to_jax(tt.model.state_dict())
    if noise_rel is not None:
        got, want = flat(got), flat(want)
        assert set(got) == set(want), set(got) ^ set(want)
        n_noise = sum(int(m.sum()) for m in noise.values())
        assert n_noise <= 2e-3 * sum(m.size for m in noise.values()), n_noise
        for k, v in want.items():
            err = np.abs(got[k] - v)
            np.testing.assert_array_less(err[~noise[k]], atol,
                                         err_msg=f"{optimizer} {k}")
            np.testing.assert_array_less(err[noise[k]], lr_sum,
                                         err_msg=f"{optimizer} {k} (noise)")
    elif atol is not None:
        assert_trees_close(got, want, atol, f"{optimizer} ")
    if update_rtol is not None:
        got, want = flat(got), flat(want)
        keys = sorted(want)
        dj = np.concatenate([(want[k] - start[k]).ravel() for k in keys])
        dt = np.concatenate([(got[k] - start[k]).ravel() for k in keys])
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel < update_rtol, rel


def write_train_frames(root, n=4, size=(320, 240), points=400, seed=0):
    """``n`` preprocessed training frames as ``cli.preprocess`` writes them
    (``<frame>_k1_scale.npz`` with per-sigma boundary samples, UDFs, part
    labels, centres, PCA axes and the image path), each with a mirrored
    ``_flip.npz``, over a written colour JPEG and person/object mask
    JPEGs of ``size`` (w, h). Returns the npz paths."""
    import cv2

    rng = np.random.RandomState(seed)
    w, h = size
    yy, xx = np.mgrid[:h, :w]
    paths = []
    for i in range(n):
        frame = os.path.join(str(root), f"t{i:04d}.000")
        os.makedirs(frame)
        rgb = os.path.join(frame, "k1.color.jpg")
        cv2.imwrite(rgb, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        cx, cy = w // 2 + rng.randint(-20, 20), h // 2 + rng.randint(-20, 20)
        person = 255 * ((np.abs(xx - cx) < 30) & (np.abs(yy - cy) < 50))
        obj = 255 * ((xx - cx - 35) ** 2 + (yy - cy) ** 2 < 20 ** 2)
        cv2.imwrite(os.path.join(frame, "k1.person_mask.jpg"),
                    person.astype(np.uint8))
        cv2.imwrite(os.path.join(frame, "k1.obj_rend_mask.jpg"),
                    obj.astype(np.uint8))
        for suffix, mirror in (("", 1.0), ("_flip", -1.0)):
            sig = {}
            for name in ("points", "dist_h", "dist_o", "parts"):
                sig[name] = {}
            for sigma in (0.08, 0.02, 0.003):
                k = f"sigma{sigma}"
                p = rng.randn(points, 3).astype(np.float32) * sigma
                sig["points"][k] = (p + [0.0, 0.0, 2.2]) * [mirror, 1, 1]
                sig["dist_h"][k] = np.abs(rng.randn(points)).astype(
                    np.float32) * sigma
                sig["dist_o"][k] = np.abs(rng.randn(points)).astype(
                    np.float32) * sigma
                sig["parts"][k] = rng.randint(0, 14, points).astype(
                    np.int64)
            path = os.path.join(frame, f"t{i:04d}.000_k1_scale{suffix}.npz")
            np.savez(path, points=sig["points"], dist_h=sig["dist_h"],
                     dist_o=sig["dist_o"], parts=sig["parts"],
                     smpl_center=np.array([0.01 * i, 0.1, 2.2]),
                     obj_center=np.array([0.3, 0.0, 2.1 + 0.01 * i]),
                     pca_axis=rng.randn(3, 3), image_file=rgb)
            if not suffix:
                paths.append(path)
    return paths


def optax_updates_match(name, tmp_path):
    """The port's optimizer against ``optax.inject_hyperparams(name)`` on
    the same gradients: the state of two optax updates loaded into the
    port (``load_optax_state``), then three updates, the LR dropping
    0.3x before the last two. Gradients span six decades (elements near
    eps included); parameters within 1e-5 of each tensor's largest update
    plus 4 ulp of its largest value (the f32 rounding of p + update), and
    the port's exported state equal to optax's: counts and
    hyperparameters exactly, each moment (all parameters' as one vector)
    within 1e-6 relative in norm (torch's moment update is a lerp;
    elementwise, a moment that cancels to near zero keeps the rounding of
    its larger terms)."""
    import optax
    from flax import serialization

    from chore_tpu_torch.models.convert import params_from_jax
    from chore_tpu_torch.train import optim

    cfg, params = jax_train_params()
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(
                -6, 0, p.shape)).astype(np.float32), params)

    tx, update = optax_update_fn(name)
    state = tx.init(params)
    for _ in range(2):
        params, state = update(grads(), state, params)
    tt = port_trainer(cfg, params, tmp_path, optimizer=name)
    optim.load_optax_state(tt.opt, name, tt.named_params,
                           serialization.to_state_dict(state))
    p0 = params
    for lr in (1e-3, 3e-4, 3e-4):
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        optim.set_lr(tt.opt, lr)
        g = grads()
        params, state = update(g, state, params)
        tg = params_from_jax(g)
        for n, p in tt.named_params:
            p.grad = tg[n].clone()
        tt.opt.step()
    from chore_tpu_torch.models.convert import params_to_jax

    got, want, start = (flat(params_to_jax(tt.model.state_dict())),
                        flat(params), flat(p0))
    for k, v in want.items():
        moved = np.abs(v - start[k]).max()
        np.testing.assert_allclose(
            got[k], v, rtol=0, atol=1e-5 * moved + 4 * np.spacing(
                np.abs(v).max()), err_msg=k)
    mine = flat(optim.optax_state(tt.opt, name, tt.named_params))
    ref = flat(serialization.to_state_dict(state))
    assert set(mine) == set(ref)
    moments = {}
    for k, v in ref.items():
        assert mine[k].dtype == v.dtype and mine[k].shape == v.shape, k
        if v.ndim == 0:
            np.testing.assert_allclose(mine[k], v, rtol=1e-7, err_msg=k)
        else:
            field = k.split("/params/")[0]
            moments.setdefault(field, []).append((mine[k] - v, v))
    assert moments
    for field, pairs in moments.items():
        diff = np.sqrt(sum(np.sum(d.astype(np.float64) ** 2)
                           for d, _ in pairs))
        norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                           for _, v in pairs))
        assert diff <= 1e-6 * norm, (field, diff / norm)


# --------------------------------------------------------------------- #
# the whole-system tools: the reference's tools/ and its posed body
def reference_tool(name):
    """The reference's ``tools/<name>.py`` as a module (imported by path:
    ``tools/`` is no package)."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"reference_tools_{name}", os.path.join(repo, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_posed_body(smplh, pose, depth, device=None):
    """``chore_tpu_torch.tools.make_example.posed_body`` computed by the JAX
    package, as the reference tools compute the body (float64 verts): the
    port's SMPL-H puts its float32 vertices a few ulps from XLA's, so
    byte-equal tool outputs need this body patched in."""
    from chore_tpu.smpl import SMPLH, synthetic_smplh
    from chore_tpu.smpl.model import init_params

    js = SMPLH(synthetic_smplh())
    sp = init_params(pose, np.zeros((1, 10)), np.zeros((1, 3)))
    sv = np.asarray(js.verts(sp))[0]
    pelvis = np.asarray(js.pelvis(sp))[0]
    return sv + (np.array([0, 0, depth]) - pelvis)
