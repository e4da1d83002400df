"""SMPL-H against ``chore_tpu`` on ``synthetic_smplh``: LBS vertices and
joints, landmarks, priors and parameter packing, values and gradients.
Tolerances 1e-5 on vertices/joints (metres; f32 through a 52-joint chain
composed in another grouping order) and 1e-4 relative on gradients."""
import jax
import numpy as np
import pytest
import torch

from test_torch_port_util import n, t


@pytest.fixture(scope="module")
def models():
    from chore_tpu.smpl import SMPLH as JS
    from chore_tpu.smpl import synthetic_smplh
    from chore_tpu_torch.smpl import SMPLH as TS

    arrays = synthetic_smplh()
    return JS(arrays), TS(arrays, device="cpu")


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(0)
    pose = (0.3 * rng.randn(2, 72)).astype(np.float32)
    betas = rng.randn(2, 10).astype(np.float32)
    trans = (rng.randn(2, 3) * 0.1 + [0, 0, 2.2]).astype(np.float32)
    return pose, betas, trans


def _split(lib_init, params, tensor):
    pose, betas, trans = params
    if tensor:
        return lib_init(t(pose), t(betas), t(trans), device="cpu")
    return lib_init(pose, betas, trans)


def test_init_params_pads_hands(params):
    from chore_tpu.smpl import init_params as ji
    from chore_tpu_torch.smpl import init_params as ti

    pj, pt = _split(ji, params, False), _split(ti, params, True)
    assert set(pj) == set(pt)
    for k in pj:
        np.testing.assert_array_equal(n(pt[k]), np.asarray(pj[k]), err_msg=k)


def test_verts_joints_landmarks(models, params):
    from chore_tpu.smpl import init_params as ji
    from chore_tpu_torch.smpl import init_params as ti

    jm, tm = models
    pj, pt = _split(ji, params, False), _split(ti, params, True)
    vj, jj, _, _ = jm.forward(pj)
    vt, jt, _, _ = tm.forward(pt)
    np.testing.assert_allclose(n(vt), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(n(jt), np.asarray(jj), atol=1e-5)
    for a, b in zip(jm.get_landmarks(pj), tm.get_landmarks(pt)):
        np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(n(tm.pelvis(pt)), np.asarray(jm.pelvis(pj)),
                               atol=1e-5)


def test_gradients(models, params):
    """d(weighted sum of verts + body25 joints)/d(every split param)."""
    from chore_tpu.smpl import init_params as ji
    from chore_tpu_torch.smpl import init_params as ti

    jm, tm = models
    w = np.random.RandomState(1).randn(2, 6890, 3).astype(np.float32)
    wj = np.random.RandomState(2).randn(2, 25, 3).astype(np.float32)

    def jloss(p):
        return (jm.verts(p) * w).sum() + (jm.get_landmarks(p)[0] * wj).sum()

    gj = jax.grad(jloss)(_split(ji, params, False))
    pt = {k: v.clone().requires_grad_(True)
          for k, v in _split(ti, params, True).items()}
    lt = (tm.verts(pt) * t(w)).sum() + (tm.get_landmarks(pt)[0] * t(wj)).sum()
    lt.backward()
    for k in gj:
        g = np.asarray(gj[k])
        np.testing.assert_allclose(n(pt[k].grad), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_priors(params):
    from chore_tpu.smpl import make_body_prior as jb
    from chore_tpu.smpl import make_hand_prior as jh
    from chore_tpu_torch.smpl import make_body_prior as tb
    from chore_tpu_torch.smpl import make_hand_prior as th

    pose = np.random.RandomState(3).randn(2, 156).astype(np.float32) * 0.2
    np.testing.assert_allclose(n(tb(device="cpu")(t(pose))),
                               np.asarray(jb()(pose)), rtol=1e-5)
    np.testing.assert_allclose(n(th(device="cpu")(t(pose))),
                               np.asarray(jh()(pose)), rtol=1e-5)


def test_mean_body_pose_and_model_sizes(models):
    from chore_tpu.smpl.priors import mean_body_pose as jm
    from chore_tpu_torch.smpl.priors import mean_body_pose as tm

    got, want = tm(), np.asarray(jm())
    assert got.shape == (63,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    js, ts = models
    assert (ts.model.num_joints, ts.model.num_verts) == (
        js.model.num_joints, js.model.num_verts)


def test_smplh_device_default(monkeypatch):
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        SMPLH(synthetic_smplh(num_verts=64))


@pytest.mark.parametrize("helper", ["make_body_prior", "make_hand_prior",
                                    "init_params"])
def test_helpers_device_default(monkeypatch, helper):
    """With no device named the helpers put their tensors on the card, and
    raise where there is none (no silent CPU fall back)."""
    import chore_tpu_torch.smpl as tsmpl

    args = {"init_params": (np.zeros((1, 72), np.float32),
                            np.zeros((1, 10), np.float32),
                            np.zeros((1, 3), np.float32))}.get(helper, ())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tsmpl, helper)(*args)
