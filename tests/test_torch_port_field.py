"""The field network against ``chore_tpu``: a 2-stack CHOREField at 64^2
with the same weights (``params_from_jax``), forward on every head of every
stack, the point gradient of the frozen query, and the last-stack query;
``HGFilter(grouped_heads=True)`` (the HGFilterGConv variant) on the same
weights; a ``StepTimer`` phase as a named range of the profiler's trace,
and its report.
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


@pytest.mark.parametrize("num_stack", [1, 2])
def test_grouped_heads_hgfilter(num_stack):
    """``HGFilter(grouped_heads=True)``: per-stack heads and re-injection
    convs grouped one channel each, weights through ``params_from_jax``
    (strict load: grouped kernels (1, 1, I/G, O) become (O, I/G, 1, 1));
    every stack's output and normx within 1e-5 of the largest (f32 convs
    summed in other orders)."""
    from chore_tpu.models.hourglass import HGFilter as JH
    from chore_tpu_torch.models.convert import params_from_jax
    from chore_tpu_torch.models.hourglass import HGFilter as TH

    kw = dict(num_stack=num_stack, depth=1, features=16, out_dim=32,
              grouped_heads=True)
    jm = JH(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 5)))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda sd: jnp.asarray(0.1 * rng.randn(*sd.shape), jnp.float32),
        shapes)
    assert params["params"]["l0"]["kernel"].shape == (1, 1, 1, 32)
    x = np.random.RandomState(0).rand(1, 32, 32, 5).astype(np.float32)
    outs_j, _, normx_j = jm.apply(params, jnp.asarray(x), train=True)
    tm = TH(**kw)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    assert tm.l0.groups == 16
    with torch.no_grad():
        outs_t, _, normx_t = tm(t(x).permute(0, 3, 1, 2), train=True)
    assert len(outs_t) == len(outs_j) == num_stack
    for a, b in zip(outs_j + [normx_j], outs_t + [normx_t]):
        a = np.asarray(a)
        np.testing.assert_allclose(n(b.permute(0, 2, 3, 1)), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max())
    with pytest.raises(ValueError, match="out_dim"):
        TH(features=16, out_dim=24, grouped_heads=True)


def test_annotate_and_step_timer_report(tmp_path):
    """A timer's phase is a named range on the profiler's timeline
    (``chore.<scope>.<phase>``, holding the ops it ran); the timer's
    report is its summary, written as JSON when a path is given."""
    import json

    from torch.profiler import profile

    from chore_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer("port")
    with profile() as prof:
        with timer.phase("region"):
            torch.ones(4).sum()
    ev = {e.name: e for e in prof.events()}
    span, op = ev["chore.port.region"], ev["aten::sum"]
    assert span.time_range.start <= op.time_range.start
    assert op.time_range.end <= span.time_range.end
    path = tmp_path / "timer.json"
    rep = timer.report(str(path))
    assert rep == timer.summary() == json.loads(path.read_text())
    assert rep["region"]["count"] == 1 and timer.report() == rep


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
