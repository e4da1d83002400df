"""The whole slice against the JAX package: ``ReconFitter.fit_batch`` with
``use_silhouette=False`` in ``chore_tpu`` and ``chore_tpu_torch``, on the
same synthetic frame, the same weights, the same SMPL-H arrays and the same
point-generation draws (the JAX draws replayed into the port).

Both sides add the same fixed 1e-3 matrix before every SO(3) projection
(``svd_jitter=False`` otherwise leaves an exact rotation, where the SVD
backward is 0/0 and every object step is skipped as non-finite) -- the
deterministic stand-in for the production jitter.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_port_util import (
    assert_clouds_match,
    jax_field,
    jax_fit_draws,
    n,
    torch_field,
)

S = 64
FIT = dict(iter_betas=1, iter_pose=1, iter_kpts=1, iter_kpts_max=2,
           iter_obj=2, iter_joint=1, iter_joint_max=4, steps_per_iter=3,
           obj_samples=128, net_in_size=S, svd_jitter=False)
SAMP = dict(num_steps=2, sample_num=256, num_rounds=2, num_points=128)


def _frame():
    rng = np.random.RandomState(0)
    images = rng.rand(1, S, S, 5).astype(np.float32)
    cc = np.array([[1018.0, 779.0]], np.float32)
    pose = (rng.randn(1, 72) * 0.05).astype(np.float32)
    betas = (0.1 * rng.randn(1, 10)).astype(np.float32)
    kpts = np.concatenate(
        [(S * rng.rand(1, 25, 2)).astype(np.float32),
         (0.3 + 0.7 * rng.rand(1, 25, 1)).astype(np.float32)], -1)
    return images, cc, pose, betas, kpts


@pytest.fixture(scope="module")
def both_fits():
    import chore_tpu.ops.rotation as jrot
    import chore_tpu.recon.fitter as jfit
    import chore_tpu_torch.ops.rotation as trot
    import chore_tpu_torch.recon.fitter as tfit
    from chore_tpu.recon.generator import SamplerConfig as JSamp
    from chore_tpu.smpl import SMPLH as JSMPLH
    from chore_tpu.smpl import synthetic_smplh
    from chore_tpu.utils.meshio import octasphere
    from chore_tpu_torch.recon.generator import SamplerConfig as TSamp
    from chore_tpu_torch.smpl import SMPLH as TSMPLH

    model, params = jax_field()
    arrays = synthetic_smplh()
    tv, tf = octasphere(radius=0.18, subdiv=1)
    images, cc, pose, betas, kpts = _frame()
    key = jax.random.PRNGKey(0)
    jitter = (1e-3 * np.random.RandomState(5).rand(3, 3)).astype(np.float32)

    j_proj = jrot.project_so3
    t_proj = trot.project_so3
    jrot.project_so3 = jfit.project_so3 = lambda m: j_proj(m + jitter)
    jit_t = torch.from_numpy(jitter)
    trot.project_so3 = tfit.project_so3 = lambda m: t_proj(m + jit_t)
    try:
        fj = jfit.ReconFitter(model, params, JSMPLH(arrays), tv, tf,
                              cfg=jfit.FitConfig(**FIT),
                              sampler_cfg=JSamp(**SAMP), record_traces=True)
        out_j = fj.fit_batch(images, cc, pose, betas, kpts, key=key,
                             use_silhouette=False)
        ft = tfit.ReconFitter(torch_field(params), TSMPLH(arrays, device="cpu"),
                              tv, tf, cfg=tfit.FitConfig(**FIT),
                              sampler_cfg=TSamp(**SAMP), record_traces=True,
                              device="cpu")
        out_t = ft.fit_batch(images, cc, pose, betas, kpts,
                             use_silhouette=False,
                             draws=jax_fit_draws(key, 1, JSamp(**SAMP)))
    finally:
        jrot.project_so3 = jfit.project_so3 = j_proj
        trot.project_so3 = tfit.project_so3 = t_proj
    return out_j, out_t


def test_point_clouds(both_fits):
    """Generated clouds from the same draws. Tolerance 1e-4: f32
    accumulation-order noise of two frameworks through 2 projection steps."""
    out_j, out_t = both_fits
    for name in ("human", "object"):
        assert_clouds_match(out_j["pclouds"][name], out_t["pclouds"][name])


def _trace(traces, names):
    loss = np.concatenate([np.asarray(traces[k]["loss"]).ravel()
                           for k in names])
    live = np.concatenate([np.asarray(traces[k]["live"]).ravel()
                           for k in names])
    return loss, live


@pytest.mark.parametrize("chain,names", [
    ("smpl_trace", ["global", "pose_kpts"]),
    ("obj_trace", ["obj", "joint"]),
])
def test_loss_traces(both_fits, chain, names):
    """Per-step weighted loss of every phase. Same early-stop decisions
    (live masks equal); relative tolerance 1e-3: f32 noise compounding over
    <= 24 Adam steps (a structural mismatch -- wrong decay, a reset
    optimizer, a missing term -- moves the trace by percent within a step
    or two)."""
    out_j, out_t = both_fits
    lj, vj = _trace(out_j[chain], names)
    lt, vt = _trace(out_t[chain], names)
    np.testing.assert_array_equal(vj, vt)
    rel = np.abs(lj - lt) / np.maximum(np.abs(lj), 1e-6)
    assert rel.max() < 1e-3, f"{chain}: max rel {rel.max():.3e} at {rel.argmax()}"
    if chain == "obj_trace":
        # the object moved: the fixed jitter keeps its steps finite
        assert np.ptp(lj[vj]) > 0


def test_final_parameters(both_fits):
    """Final SMPL and object parameters, 1e-3 absolute (the trace noise
    above carried into the parameters)."""
    out_j, out_t = both_fits
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
