"""Fitting losses and the Adam phase runner against ``chore_tpu``.

Every loss term of the SMPL and object chains, value and gradient, on
seeded numpy inputs (the contact and collision terms reach the grouped 1-NN
through its plain version here, the JAX side through its XLA path); then
``run_phase``'s per-step traces: Adam, frozen keys, gradient accumulation,
a non-finite iteration, the plateau stop and the carried ``prev_loss``.
Tolerances: 1e-5 relative on values, 1e-4 on gradients (f32 reductions in
other orders), stated per test where they differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import n, t


def _vg_j(fn, *xs):
    return jax.value_and_grad(fn, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])


def _vg_t(fn, *xs):
    xs = [t(x).requires_grad_(True) for x in xs]
    v = fn(*xs)
    return v, torch.autograd.grad(v, xs)


def _close(jv, tv, rtol=1e-5, gtol=1e-4):
    (vj, gj), (vt, gt) = jv, tv
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=rtol,
                               atol=1e-7)
    for a, b in zip(gj, gt):
        a = np.asarray(a)
        np.testing.assert_allclose(n(b), a, rtol=gtol,
                                   atol=gtol * max(np.abs(a).max(), 1e-6))


RNG = np.random.RandomState(0)
DF = np.abs(RNG.randn(2, 300)).astype(np.float32) * 0.3
LOGITS = RNG.randn(2, 300, 14).astype(np.float32)
LABELS = RNG.randint(0, 14, (2, 300)).astype(np.int32)
JOINTS = (RNG.randn(2, 25, 3) * 0.3 + [0, 0, 2.2]).astype(np.float32)
KPTS = np.concatenate([RNG.rand(2, 25, 2) * 512, RNG.rand(2, 25, 1)],
                      -1).astype(np.float32)
CC = np.array([[1018.0, 779.0], [990.0, 760.0]], np.float32)


@pytest.mark.parametrize("term", ["df_h", "df_o", "scale", "smplz", "pinit",
                                  "part", "j2d", "ocent"])
def test_simple_terms(term):
    from chore_tpu.ops.camera import PerspectiveCamera as JC
    from chore_tpu.recon import losses as J
    from chore_tpu_torch.ops.camera import PerspectiveCamera as TC
    from chore_tpu_torch.recon import losses as T

    pose = RNG.randn(2, 156).astype(np.float32)
    pinit = RNG.randn(2, 69).astype(np.float32)
    pts = RNG.randn(2, 50, 3).astype(np.float32)
    cpred = RNG.randn(2, 3).astype(np.float32)
    cases = {
        "df_h": (lambda L, x: L.df_h_loss(x), [DF]),
        "df_o": (lambda L, x: L.df_o_loss(x), [DF * 4]),
        "scale": (lambda L, s: L.scale_loss(s, 1.0), [DF[:, 0] + 0.5]),
        "smplz": (lambda L, j: L.smplz_loss(j, 2.2), [JOINTS]),
        "pinit": (lambda L, p, q: L.pinit_loss(p, q), [pose, pinit]),
        "ocent": (lambda L, p, c: L.ocent_loss(p, c), [pts, cpred]),
    }
    if term == "part":
        vj = _vg_j(lambda z: J.part_ce_loss(z, jnp.asarray(LABELS)), LOGITS)
        vt = _vg_t(lambda z: T.part_ce_loss(z, t(LABELS, torch.int64)),
                   LOGITS)
    elif term == "j2d":
        vj = _vg_j(lambda j, c: J.j2d_loss(j, jnp.asarray(KPTS), c, JC(), 512),
                   JOINTS, CC)
        vt = _vg_t(lambda j, c: T.j2d_loss(j, t(KPTS), c, TC(), 512),
                   JOINTS, CC)
    else:
        fn, args = cases[term]
        vj = _vg_j(lambda *a: fn(J, *a), *args)
        vt = _vg_t(lambda *a: fn(T, *a), *args)
    _close(vj, vt)


def test_weighted_sum_and_weights():
    from chore_tpu.recon import losses as J
    from chore_tpu_torch.recon import losses as T

    for k, v in J.BEHAVE_WEIGHTS.items():
        assert T.BEHAVE_WEIGHTS[k] == v
    ld = {"df_h": 0.3, "pose": 12.0, "j2d": 4.5}
    assert float(T.weighted_sum({k: torch.tensor(v) for k, v in ld.items()},
                                T.BEHAVE_WEIGHTS, 2.5)) == pytest.approx(
        float(J.weighted_sum({k: jnp.float32(v) for k, v in ld.items()},
                             J.BEHAVE_WEIGHTS, 2.5)), rel=1e-6)


def _contact_inputs(seed, no_contact_side=None):
    rng = np.random.RandomState(seed)
    B, Nh, No = 2, 400, 150
    h = (rng.randn(B, Nh, 3) * 0.3 + [0, 0, 2.2]).astype(np.float32)
    o = (rng.randn(B, No, 3) * 0.2 + [0.1, 0, 2.2]).astype(np.float32)
    df_h = np.abs(rng.randn(B, Nh)).astype(np.float32) * 0.1
    df_o = np.abs(rng.randn(B, No)).astype(np.float32) * 0.1
    if no_contact_side == "h":
        df_h[0] += 1.0  # example 0: no human contacts -> all eligible
    lh = rng.randint(0, 14, Nh).astype(np.int32)
    lo = rng.randint(0, 14, (B, No)).astype(np.int32)
    lo[1] = np.where(lo[1] == 3, 4, lo[1])  # a part without object points
    return h, o, df_h, df_o, lh, lo


@pytest.mark.parametrize("variant", [None, "h"])
def test_contact_loss(variant):
    """Per-part contact chamfer through the grouped 1-NN, both clouds'
    gradients."""
    from chore_tpu.recon import losses as J
    from chore_tpu_torch.recon import losses as T

    h, o, dh, do, lh, lo = _contact_inputs(1, variant)
    vj = _vg_j(lambda a, b: J.contact_loss(a, b, jnp.asarray(dh),
                                           jnp.asarray(do), jnp.asarray(lh),
                                           jnp.asarray(lo)), h, o)
    vt = _vg_t(lambda a, b: T.contact_loss(a, b, t(dh), t(do),
                                           t(lh, torch.int64),
                                           t(lo, torch.int64)), h, o)
    _close(vj, vt)
    assert float(vt[0].detach()) > 0


def test_vertex_normals_and_collision():
    from chore_tpu.recon import losses as J
    from chore_tpu.smpl import synthetic_smplh
    from chore_tpu_torch.recon import losses as T

    arr = synthetic_smplh(num_verts=500, num_joints=24)
    rng = np.random.RandomState(2)
    verts = np.stack([arr["v_template"] + [0, 0, 2.2]] * 2).astype(np.float32)
    verts += 0.01 * rng.randn(*verts.shape).astype(np.float32)
    faces = arr["faces"]
    nj = J.vertex_normals(jnp.asarray(verts), faces)
    nt = T.vertex_normals(t(verts), t(faces, torch.int64))
    np.testing.assert_allclose(n(nt), np.asarray(nj), atol=1e-5)
    obj = (rng.randn(2, 200, 3) * 0.15 + [0, -0.2, 2.2]).astype(np.float32)
    vj = _vg_j(lambda v, o: J.collision_loss(v, J.vertex_normals(v, faces), o),
               verts, obj)
    vt = _vg_t(lambda v, o: T.collision_loss(
        v, T.vertex_normals(v, t(faces, torch.int64)), o), verts, obj)
    _close(vj, vt)
    assert float(vt[0].detach()) > 0
    sj = J.collision_signed(jnp.asarray(verts), nj, jnp.asarray(obj))
    st = T.collision_signed(t(verts), nt, t(obj))
    np.testing.assert_allclose(n(st), np.asarray(sj), atol=1e-5)


# ---------------------------------------------------------------------- #
TARGET = np.array([3.0, -1.0, 0.5], np.float32)


def _phase_pair(spec_kw, nan_iter=None, prev=300.0):
    """The same loss in both frameworks: a weighted quadratic in three
    params (one frozen in some specs) whose gradient is NaN throughout
    outer iteration ``nan_iter``."""
    from chore_tpu.recon import optimize as JO
    from chore_tpu_torch.recon import optimize as TO

    p0 = {"a": np.array([[0.0, 1.0]], np.float32),
          "b": np.array([[2.0]], np.float32),
          "c": np.array([[-1.0, 0.5, 4.0]], np.float32)}

    def jloss(p, it, k):
        tot = (40.0 * ((p["a"] - TARGET[0]) ** 2).sum()
               + 25.0 * ((p["b"] - TARGET[1]) ** 2).sum()
               + 10.0 * ((p["c"] - TARGET[2]) ** 4).sum())
        if nan_iter is not None:
            # cond, not where: where's untaken sqrt branch would put a NaN
            # into every step's gradient
            tot = tot + jax.lax.cond(
                it == nan_iter, lambda: jnp.sqrt(-p["b"].sum() - 10.0),
                lambda: jnp.float32(0.0))
        return tot, {}

    def tloss(p, it, g):
        tot = (40.0 * ((p["a"] - TARGET[0]) ** 2).sum()
               + 25.0 * ((p["b"] - TARGET[1]) ** 2).sum()
               + 10.0 * ((p["c"] - TARGET[2]) ** 4).sum())
        if nan_iter is not None and it == nan_iter:
            tot = tot + torch.sqrt(-p["b"].sum() - 10.0)
        return tot, {}

    trainable = spec_kw.pop("trainable", None)
    js = JO.PhaseSpec(trainable=None if trainable is None else
                      JO.freeze_all_except(p0, *trainable), **spec_kw)
    ts = TO.PhaseSpec(trainable=None if trainable is None else
                      TO.freeze_all_except(p0, *trainable), **spec_kw)
    pj, lj, nj, trj = JO.run_phase(jloss, {k: jnp.asarray(v) for k, v in
                                           p0.items()}, js, prev_loss=prev,
                                   record=True)
    pt, lt, nt, trt = TO.run_phase(tloss, {k: t(v) for k, v in p0.items()},
                                   ts, prev_loss=prev, record=True)
    return (pj, float(lj), int(nj), trj), (pt, lt, nt, trt), p0


@pytest.mark.parametrize("case", [
    dict(spec=dict(lr=0.05, n_iters=6, steps_per_iter=4)),
    dict(spec=dict(lr=0.05, n_iters=6, steps_per_iter=4,
                   trainable=("a", "c"))),
    dict(spec=dict(lr=0.1, n_iters=5, steps_per_iter=3), nan_iter=1),
    dict(spec=dict(lr=0.02, n_iters=40, steps_per_iter=5,
                   early_stop_min_iter=2.0, early_stop_rel=1e-3), prev=120.0),
], ids=["all", "frozen", "nonfinite", "early_stop"])
def test_run_phase_traces(case):
    """Per-step loss traces, live masks, iterations run, final loss and
    params; 1e-5 relative (f32 Adam arithmetic in the same order)."""
    (pj, lj, nj, trj), (pt, lt, nt, trt), p0 = _phase_pair(
        dict(case["spec"]), case.get("nan_iter"), case.get("prev", 300.0))
    np.testing.assert_array_equal(trt["live"], np.asarray(trj["live"]))
    np.testing.assert_allclose(trt["loss"], np.asarray(trj["loss"]),
                               rtol=1e-5)
    assert nt == nj and lt == pytest.approx(lj, rel=1e-5)
    for k in pj:
        np.testing.assert_allclose(n(pt[k]), np.asarray(pj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    trainable = case["spec"].get("trainable")
    if trainable:
        for k in set(p0) - set(trainable):
            np.testing.assert_array_equal(n(pt[k]), p0[k])
    if case.get("nan_iter") is not None:
        # the NaN iteration changes nothing: its losses repeat
        row = trt["loss"][case["nan_iter"]]
        assert np.isnan(row).all() or np.ptp(row[np.isfinite(row)]) == 0
    if "early_stop_min_iter" in case["spec"]:
        assert not trt["live"].all() and nt < case["spec"]["n_iters"]


def test_run_phase_without_record_stops_early():
    from chore_tpu_torch.recon import optimize as TO

    spec = TO.PhaseSpec(lr=0.02, n_iters=40, steps_per_iter=5,
                        early_stop_min_iter=2.0)
    calls = []

    def loss(p, it, g):
        calls.append(it)
        return 40.0 * ((p["a"] - 3.0) ** 2).sum(), {}

    _, _, n_run = TO.run_phase(loss, {"a": torch.zeros(1, 2)}, spec,
                               prev_loss=120.0)
    assert n_run < 40 and max(calls) == n_run - 1
