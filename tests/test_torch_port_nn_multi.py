"""Kernel K1's multi-problem entry point (``ops.nn.nn_grouped_multi``) on
the CPU, where it runs the plain version once per problem: each problem's
answer equals a separate ``nn_grouped`` call exactly and the TPU kernel
``chore_tpu.ops.pallas.nn.nn_pallas`` in interpret mode; the kernel's
table plan (which problems share one scan); and the contact and collision
losses fed by one multi call, as the fitter's joint step makes it, against
``chore_tpu``'s losses. The CUDA kernel itself is held to the plain version
in ``test_torch_port_cuda.py`` (no JAX there).

Tolerances: distances 1e-5 absolute (f32 expansions of unit-scale points
summed in other orders), indices equal (random inputs, or exact
duplicates); losses 1e-5 relative on values and 1e-4 on gradients, as in
``test_torch_port_losses.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chore_tpu.ops.pallas.nn as jnn
from test_torch_port_cuda import CASES, make_case, multi_case
from test_torch_port_util import n, t


@pytest.fixture()
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(jnn, "nn_pallas", jnn.nn_pallas.__wrapped__)


def _torch_problem(x, y, ym, xg, yg):
    from chore_tpu_torch.ops.nn import group_rows

    tx, ty = t(x)[None], t(y)[None]
    opt = lambda a, dt: None if a is None else t(a, dt)[None]  # noqa: E731
    return (tx, ty, *group_rows(tx, ty, opt(ym, torch.bool),
                                opt(xg, torch.int64), opt(yg, torch.int64)))


def _check_against_singles_and_pallas(problems, raw):
    """``problems`` [(x, y, qg, rg)] (torch, batched); ``raw`` the same as
    numpy (x, y, y_mask, x_group, y_group) per example (lists over b)."""
    from chore_tpu_torch.ops import nn as tnn

    before = tnn.launches["nn_grouped"]
    multi = tnn.nn_grouped_multi(problems)
    assert tnn.launches["nn_grouped"] == before  # CPU: no kernel launch
    assert len(multi) == len(problems)
    for p, (d, i), per_b in zip(problems, multi, raw):
        ds, is_ = tnn.nn_grouped(*p)
        assert torch.equal(d, ds) and torch.equal(i, is_)
        assert i.dtype == torch.int64 and d.dtype == torch.float32
        for b, (x, y, ym, xg, yg) in enumerate(per_b):
            dj, ij = jnn.nn_pallas(x, y, y_mask=ym, x_group=xg, y_group=yg)
            np.testing.assert_array_equal(n(i[b]), np.asarray(ij))
            np.testing.assert_allclose(n(d[b]), np.asarray(dj), atol=1e-5)
            unmatched = np.asarray(dj) >= 1e9
            assert (n(d[b])[unmatched] == 1e10).all()
            assert (n(i[b])[unmatched] == 0).all()
    return multi


def test_multi_of_every_case(interpret):
    """The single-problem cases of the card tests, all in one call."""
    raw = [make_case(3, **CASES[name]) for name in CASES]
    problems = [_torch_problem(*r) for r in raw]
    _check_against_singles_and_pallas(problems, [[r] for r in raw])


@pytest.mark.parametrize("name", ["joint_small", "all_masked",
                                  "empty_groups", "duplicates", "batch2"])
def test_multi_cases(interpret, name):
    """The joint step's three problems cut small (700 x 300, 14 groups,
    masks; the o->h pair sharing its clouds), an all-masked problem, groups
    with no references, exact duplicates (lowest index) and B = 2."""
    problems, raw = multi_case(name)
    multi = _check_against_singles_and_pallas(problems, raw)
    if name == "duplicates":  # refs 100..149 repeat refs 0..49
        for _, i in multi:
            assert not bool(((i >= 100) & (i < 150)).any())
    if name == "all_masked":
        assert (n(multi[0][0]) == 1e10).all() and (n(multi[0][1]) == 0).all()


def test_plan_shares_one_scan():
    """An ungrouped problem over the same clouds as a grouped one rides on
    its scan (kind SHARED); nothing else is paired."""
    from chore_tpu_torch.ops import nn as tnn

    problems, _ = multi_case("joint_small")
    h2o, o2h, coll = problems
    assert tnn.plan(problems) == [(tnn.GROUPED, 0, None),
                                  (tnn.SHARED, 1, 2)]
    # another reference cloud of the same shape: no sharing
    other = (coll[0], coll[1].clone(), None, None)
    assert tnn.plan([o2h, other]) == [(tnn.GROUPED, 0, None),
                                      (tnn.UNGROUPED, 1, None)]
    # one grouped problem takes one rider; the second ungrouped one scans
    # on its own
    assert tnn.plan([o2h, coll, coll]) == [(tnn.SHARED, 0, 1),
                                           (tnn.UNGROUPED, 2, None)]
    assert tnn.plan([h2o]) == [(tnn.GROUPED, 0, None)]


def test_nn_sqdist_multi_matches_separate_calls():
    """``nn_sqdist_multi`` gives each call's ``nn_sqdist`` result, values
    and gradients (the exact-gradient re-expression per call)."""
    from chore_tpu_torch.ops.chamfer import nn_sqdist, nn_sqdist_multi

    rng = np.random.RandomState(5)
    xs = rng.randn(2, 90, 3).astype(np.float32)
    ys = rng.randn(2, 60, 3).astype(np.float32)
    xg = t(rng.randint(0, 4, (2, 90)), torch.int64)
    yg = t(rng.randint(0, 4, (2, 60)), torch.int64)
    ym = t(rng.rand(2, 60) > 0.3, torch.bool)
    grads = []
    for multi in (True, False):
        x, y = t(xs).requires_grad_(True), t(ys).requires_grad_(True)
        calls = [dict(x=x, y=y, y_mask=ym, x_group=xg, y_group=yg),
                 dict(x=y, y=x), dict(x=x, y=y)]
        out = (nn_sqdist_multi(calls) if multi
               else [nn_sqdist(**c) for c in calls])
        sum(torch.where(d < 1e9, d, torch.zeros_like(d)).sum() * (k + 1)
            for k, (d, _) in enumerate(out)).backward()
        grads.append((out, x.grad, y.grad))
    (om, gxm, gym), (os_, gxs, gys) = grads
    for (dm, im), (ds, is_) in zip(om, os_):
        assert torch.equal(im, is_) and torch.equal(dm, ds)
    # the same terms, accumulated into the leaves' gradients in another
    # order: f32 rounding only
    torch.testing.assert_close(gxm, gxs, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gym, gys, rtol=1e-6, atol=1e-6)


def _joint_inputs(seed):
    """SMPL-like verts with normals and part labels, an object cloud, the
    two df predictions: a joint step's inputs at a small size (B = 2)."""
    from chore_tpu.smpl import synthetic_smplh

    arr = synthetic_smplh(num_verts=500, num_joints=24)
    rng = np.random.RandomState(seed)
    verts = np.stack([arr["v_template"] + [0, 0, 2.2]] * 2).astype(np.float32)
    verts += 0.01 * rng.randn(*verts.shape).astype(np.float32)
    obj = (rng.randn(2, 200, 3) * 0.15 + [0, -0.2, 2.2]).astype(np.float32)
    df_h = np.abs(rng.randn(2, 500)).astype(np.float32) * 0.1
    df_o = np.abs(rng.randn(2, 200)).astype(np.float32) * 0.1
    lh = rng.randint(0, 14, 500).astype(np.int32)
    lo = rng.randint(0, 14, (2, 200)).astype(np.int32)
    return verts, obj, df_h, df_o, lh, lo, arr["faces"]


def test_losses_fed_by_one_multi_call():
    """contact + collision as the fitter's joint step computes them (one
    multi call for the three 1-NN problems, results handed in through
    ``nn=``) against ``chore_tpu``'s losses, values and gradients with
    respect to both clouds; and equal to the losses called alone."""
    from chore_tpu.recon import losses as J
    from chore_tpu_torch.ops.chamfer import nn_sqdist_multi
    from chore_tpu_torch.recon import losses as T

    verts, obj, dh, do, lh, lo, faces = _joint_inputs(7)
    tfaces = t(faces, torch.int64)

    def jloss(v, o):
        c = J.contact_loss(v, o, jnp.asarray(dh), jnp.asarray(do),
                           jnp.asarray(lh), jnp.asarray(lo))
        k = J.collision_loss(v, J.vertex_normals(v, faces), o)
        return c + 0.5 * k

    def tloss(v, o, fed):
        kw = dict(df_hum_o=t(dh), df_obj_h=t(do),
                  part_labels_h=t(lh, torch.int64),
                  part_labels_o=t(lo, torch.int64))
        normals = T.vertex_normals(v, tfaces)
        if not fed:
            return (T.contact_loss(v, o, **kw)
                    + 0.5 * T.collision_loss(v, normals, o))
        nn = nn_sqdist_multi(T.contact_nn_calls(v, o, **kw)
                             + [T.collision_nn_call(v, o)])
        return (T.contact_loss(v, o, **kw, nn=nn[:2])
                + 0.5 * T.collision_loss(v, normals, o, nn=nn[2]))

    vj, (gvj, goj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(verts), jnp.asarray(obj))
    res = []
    for fed in (True, False):
        v, o = t(verts).requires_grad_(True), t(obj).requires_grad_(True)
        val = tloss(v, o, fed)
        res.append((val.detach(), *torch.autograd.grad(val, (v, o))))
    (vt, gvt, got), (va, gva, goa) = res
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5, atol=1e-7)
    for g, gj in ((gvt, gvj), (got, goj)):
        gj = np.asarray(gj)
        np.testing.assert_allclose(n(g), gj, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(gj).max(), 1e-6))
    assert float(vt) > 0
    # fed or alone: the same indices, the same terms (gradients accumulated
    # in another order)
    assert torch.equal(vt, va)
    torch.testing.assert_close(gvt, gva, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, goa, rtol=1e-6, atol=1e-6)
