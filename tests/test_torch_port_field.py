"""The field network against ``chore_tpu``: a 2-stack CHOREField at 64^2
with the same weights (``params_from_jax``), forward on every head of every
stack, the point gradient of the frozen query, and the last-stack query.
Tolerances: 1e-4 absolute on heads of magnitude ~0.05-5 (two hourglass
stacks of f32 convs summed in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import jax_field, n, t, torch_field


@pytest.fixture(scope="module")
def fields():
    model, params = jax_field()
    return model, params, torch_field(params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    images = rng.rand(1, 64, 64, 5).astype(np.float32)
    # spread beyond the frustum so the OUT_DIST path is exercised
    pts = (rng.rand(1, 300, 3) * [5.0, 5.0, 0.6] + [-2.5, -2.5, 1.9]).astype(
        np.float32)
    cc = np.array([[1018.0, 779.0]], np.float32)
    return images, pts, cc


def test_forward_all_stacks(fields, inputs):
    model, params, tm = fields
    images, pts, cc = inputs
    pj = model.apply(params, jnp.asarray(images), jnp.asarray(pts),
                     jnp.asarray(cc))
    pt = tm(t(images), t(pts), t(cc))
    assert len(pt) == len(pj) == 2
    for s in range(2):
        for k in ("df", "parts", "pca", "centers"):
            np.testing.assert_allclose(n(pt[s][k]), np.asarray(pj[s][k]),
                                       atol=1e-4, err_msg=f"stack {s} {k}")
    out = np.asarray(pj[-1]["df"])
    assert (out == 5.0).any() and (out != 5.0).any()


def test_eval_encode_and_point_gradient(fields, inputs):
    """The fitting query: eval encode (last stack only), frozen features,
    gradient of the summed df with respect to the points; 1e-4 relative."""
    model, params, tm = fields
    images, pts, cc = inputs
    fj, tj = model.apply(params, jnp.asarray(images), train=False,
                         method="encode")

    def jdf(p):
        preds = model.apply(params, fj, tj, p, jnp.asarray(cc),
                            frozen_features=True, method="query")
        return preds[-1]["df"].sum()

    gj = jax.grad(jdf)(jnp.asarray(pts))
    ft, tt = tm.encode(t(images), train=False)
    assert len(ft) == 1
    tp = t(pts).requires_grad_(True)
    tm.query_last(ft, tt, tp, t(cc))["df"].sum().backward()
    np.testing.assert_allclose(n(tp.grad), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)


def test_query_last_equals_query(fields, inputs):
    """query_last is query(...)[-1], bit for bit (train-mode features: the
    other stacks are present and skipped)."""
    _, _, tm = fields
    images, pts, cc = inputs
    feats, tmpx = tm.encode(t(images), train=True)
    assert len(feats) == 2
    for frozen in (False, True):
        full = tm.query(feats, tmpx, t(pts), t(cc), frozen_features=frozen)[-1]
        last = tm.query_last(feats, tmpx, t(pts), t(cc),
                             frozen_features=frozen)
        for k in full:
            assert torch.equal(full[k], last[k]), k


def test_integer_images_scaled(fields):
    _, _, tm = fields
    u8 = np.random.RandomState(1).randint(0, 256, (1, 64, 64, 5)).astype(
        np.uint8)
    a, _ = tm.encode(torch.from_numpy(u8), train=False)
    b, _ = tm.encode(t(u8.astype(np.float32) / 255.0), train=False)
    assert torch.equal(a[0], b[0])


def test_build_field_needs_a_device_or_cpu(monkeypatch):
    """No card and no explicit device: build_field raises instead of
    silently running on the CPU."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_field(FieldConfig(num_stack=1))
    m = build_field(FieldConfig(num_stack=1), device="cpu", seed=3)
    assert not any(p.requires_grad for p in m.parameters())
    w = m.df[0].weight
    assert abs(float(w.std()) - 0.02) < 0.003 and float(m.df[0].bias.abs().max()) == 0


@pytest.mark.slow
def test_release_entry_workload():
    """``__graft_entry__.entry()``'s workload at release width (5 stacks,
    1x512^2x5 encode, 50k-point query) against ``CHOREField.apply``; the
    small-config twins above run in the fast lane. 1e-4 on every head."""
    from chore_tpu.models import CHOREField, FieldConfig

    model = CHOREField(cfg=FieldConfig())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 5)), jnp.zeros((1, 8, 3)),
                            jnp.zeros((1, 2)))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.02 * rng.randn(*s.shape).astype(np.float32)),
        shapes)
    images = rng.rand(1, 512, 512, 5).astype(np.float32)
    points = (rng.rand(1, 50000, 3) * [2, 2, 0.5] + [-1, -1, 1.95]).astype(
        np.float32)
    cc = np.array([[1018.0, 779.0]], np.float32)
    want = model.apply(params, jnp.asarray(images), jnp.asarray(points),
                       jnp.asarray(cc), train=False)[-1]
    tm = torch_field(params, num_stack=5)
    with torch.no_grad():
        got = tm(t(images), t(points), t(cc), train=False)[-1]
    for k in ("df", "parts", "pca", "centers"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), atol=1e-4,
                                   err_msg=k)
