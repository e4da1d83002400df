"""The whole slice against the JAX package: ``ReconFitter.fit_batch`` with
``use_silhouette=False`` in ``chore_tpu`` and ``chore_tpu_torch``, on the
same synthetic frame, the same weights, the same SMPL-H arrays and the same
point-generation draws (the JAX draws replayed into the port).

Both sides add the same fixed 1e-3 matrix before every SO(3) projection
(``svd_jitter=False`` otherwise leaves an exact rotation, where the SVD
backward is 0/0 and every object step is skipped as non-finite) -- the
deterministic stand-in for the production jitter.
"""
import numpy as np
import pytest

from test_torch_port_util import (
    assert_clouds_match,
    assert_final_params_match,
    assert_traces_match,
    run_both_fits,
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
    return run_both_fits(FIT, SAMP, _frame(), use_silhouette=False)


def test_point_clouds(both_fits):
    """Generated clouds from the same draws. Tolerance 1e-4: f32
    accumulation-order noise of two frameworks through 2 projection steps."""
    out_j, out_t = both_fits
    for name in ("human", "object"):
        assert_clouds_match(out_j["pclouds"][name], out_t["pclouds"][name])


@pytest.mark.parametrize("chain,names", [
    ("smpl_trace", ["global", "pose_kpts"]),
    ("obj_trace", ["obj", "joint"]),
])
def test_loss_traces(both_fits, chain, names):
    """Per-step weighted loss of every phase (see ``assert_traces_match``);
    the object moves (the fixed jitter keeps its steps finite)."""
    out_j, out_t = both_fits
    assert_traces_match(out_j[chain], out_t[chain], names,
                        moved=chain == "obj_trace")


def test_final_parameters(both_fits):
    """Final SMPL and object parameters, 1e-3 absolute (the trace noise
    above carried into the parameters)."""
    assert_final_params_match(*both_fits)
