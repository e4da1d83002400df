"""The release "mixed" precision (bf16 encoder convs, float32 GroupNorm
statistics and heads) against ``chore_tpu``'s ``encoder_dtype=bfloat16``
field, with the same weights (``params_from_jax``) on the same seeded
image and points: every stage's dtype is equal, and the values agree
within MIXED_TOL of their largest magnitude.

The bound: both sides round every conv output (and each bicubic matmul) to
bf16 (8 bits of mantissa, 2^-9 ~ 2e-3 relative), but in different places
where the frameworks fuse differently (a bias add after or inside the
conv, a 2x2 pooling sum in bf16 or float32), so single roundings differ by
one bf16 ulp here and there and compound through ~60 convs of two stacks.
The float32 path stays at ``test_torch_port_field.py``'s tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import jax_field, n, t

# of the largest magnitude; measured at most 1.75e-2 (the first hourglass
# block), so 3e-2 leaves room for another CPU's bf16 kernels
MIXED_TOL = 3e-2
S = 64


def _inputs():
    rng = np.random.RandomState(3)
    images = rng.rand(1, S, S, 5).astype(np.float32)
    pts = (rng.rand(1, 300, 3) * [1.2, 1.6, 0.5] + [-0.6, -0.8, 1.95]
           ).astype(np.float32)
    cc = np.array([[1018.0, 779.0]], np.float32)
    return images, pts, cc


@pytest.fixture(scope="module")
def fields():
    from chore_tpu.models import CHOREField, FieldConfig
    from chore_tpu_torch.models.chore import FieldConfig as TFieldConfig
    from chore_tpu_torch.models.chore import build_field
    from chore_tpu_torch.models.convert import params_from_jax

    _, params = jax_field()
    jm = CHOREField(cfg=FieldConfig(num_stack=2),
                    encoder_dtype=jnp.bfloat16)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tm = build_field(TFieldConfig(num_stack=2), device="cpu", state_dict=sd,
                     encoder_dtype=torch.bfloat16)
    return jm, params, tm


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= MIXED_TOL * scale, f"{what}: {err:.3g} of {scale:.3g}"


def test_stage_dtypes_and_values(fields):
    """The hourglass filter's outputs (both stacks), tmpx and normx, and the
    output of every ConvBlock and HourGlass inside it."""
    jm, params, tm = fields
    images, _, _ = _inputs()
    (outs_j, tmpx_j, normx_j), inter = jm.apply(
        params, jnp.asarray(images),
        method=lambda m, x: m.image_filter(x, train=True),
        capture_intermediates=True, mutable=["intermediates"])
    captured = {}

    def hook(name):
        def fn(_, __, out):
            captured[name] = out
        return fn

    from chore_tpu_torch.models.hourglass import HourGlass
    from chore_tpu_torch.models.layers import ConvBlock

    handles = [m.register_forward_hook(hook(name))
               for name, m in tm.image_filter.named_modules()
               if isinstance(m, (ConvBlock, HourGlass))]
    try:
        with torch.no_grad():
            x = t(images).permute(0, 3, 1, 2)
            outs_t, tmpx_t, normx_t = tm.image_filter(x, train=True)
    finally:
        for h in handles:
            h.remove()
    nhwc = lambda a: n(a.float().permute(0, 2, 3, 1))  # noqa: E731
    pairs = [(f"out{i}", a, b) for i, (a, b) in enumerate(zip(outs_j, outs_t))]
    pairs += [("tmpx", tmpx_j, tmpx_t), ("normx", normx_j, normx_t)]
    flat = jax.tree_util.tree_flatten_with_path(
        inter["intermediates"]["image_filter"])[0]
    for path, val in flat:
        keys = [getattr(k, "key", None) for k in path]
        name = ".".join(k for k in keys if isinstance(k, str)
                        and k != "__call__")
        if name in captured:
            pairs.append((name, val, captured[name]))
    assert len(pairs) > 2 + 2 + 20  # every block of both stacks
    for name, a, b in pairs:
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        _close(nhwc(b), a, name)
    assert str(outs_j[0].dtype) == "bfloat16"
    assert str(tmpx_j.dtype) == "float32"


def test_encode_and_query_last(fields):
    """``encode(train=False)`` and ``query_last``'s heads (float32)."""
    jm, params, tm = fields
    images, pts, cc = _inputs()
    feats_j, tmpx_j = jm.apply(params, jnp.asarray(images), train=False,
                               method="encode")
    preds_j = jm.apply(params, feats_j, tmpx_j, jnp.asarray(pts),
                       jnp.asarray(cc), method="query")[-1]
    with torch.no_grad():
        feats_t, tmpx_t = tm.encode(t(images), train=False)
        preds_t = tm.query_last(feats_t, tmpx_t, t(pts), t(cc))
    assert feats_t[-1].dtype == torch.bfloat16 and tmpx_t.dtype == torch.float32
    _close(n(feats_t[-1].float()), feats_j[-1], "features")
    _close(n(tmpx_t), tmpx_j, "tmpx")
    for k in ("df", "parts", "pca", "centers"):
        assert preds_t[k].dtype == torch.float32
        assert str(preds_j[k].dtype) == "float32"
        _close(n(preds_t[k]), preds_j[k], k)
