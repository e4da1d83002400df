"""Port ops against ``chore_tpu``: camera, rotation, grid sampling, the
encoder's layers and the weight converter, forward values and gradients.
Inputs come from numpy seeds; both sides run float32 on the CPU, so the
tolerances are f32 accumulation-order noise, stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import n, t


def _grad_t(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    gs = torch.autograd.grad(out.sum(), xs)
    return [n(g) for g in gs]


class TestCamera:
    def test_project_points_and_grad(self):
        """Crop-normalized projection incl. the z = 0 guard; 1e-5 relative
        (f32 division)."""
        from chore_tpu.ops.camera import PerspectiveCamera as JC
        from chore_tpu_torch.ops.camera import PerspectiveCamera as TC

        rng = np.random.RandomState(0)
        pts = (rng.randn(2, 50, 3) * [0.5, 0.5, 0.3] + [0, 0, 2.2]).astype(
            np.float32)
        pts[0, :3, 2] = [0.0, 3e-7, -4e-7]  # inside the guard
        cc = np.array([[1018.0, 779.0], [900.0, 700.0]], np.float32)
        jc, tc = JC(), TC()
        want = np.asarray(jc.project_points(jnp.asarray(pts), jnp.asarray(cc)))
        got = n(tc.project_points(t(pts), t(cc)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        gj = jax.grad(lambda p: jc.project_points(p, jnp.asarray(cc)).sum())(
            jnp.asarray(pts))
        (gt,) = _grad_t(lambda p: tc.project_points(p, t(cc)), t(pts))
        np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-4, atol=1e-2)
        assert np.isfinite(gt).all()

    def test_project_screen_uncropped(self):
        from chore_tpu.ops.camera import PerspectiveCamera as JC
        from chore_tpu_torch.ops.camera import PerspectiveCamera as TC

        pts = np.random.RandomState(1).randn(1, 9, 3).astype(np.float32) + 2
        for a, b in zip(JC().project_screen(jnp.asarray(pts)),
                        TC().project_screen(t(pts))):
            np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-5)


class TestRotation:
    def _mats(self, seed=0, b=4):
        rng = np.random.RandomState(seed)
        q = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(b)])
        return (q + 0.1 * rng.randn(b, 3, 3)).astype(np.float32)

    def test_project_so3(self):
        """SVD projection with the det fix; the JAX side adds Newton-Schulz
        polish, which moves values by rounding only: 1e-5."""
        from chore_tpu.ops.rotation import project_so3 as jp
        from chore_tpu_torch.ops.rotation import project_so3 as tp

        m = self._mats()
        m[0] = -m[0]  # det < 0 input: the fix must flip it
        got, want = n(tp(t(m))), np.asarray(jp(jnp.asarray(m)))
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)

    def test_project_so3_grad(self):
        """Gradient through the SVD (split spectrum); 1e-4."""
        from chore_tpu.ops.rotation import project_so3 as jp
        from chore_tpu_torch.ops.rotation import project_so3 as tp

        m = self._mats(1)
        w = np.random.RandomState(2).randn(*m.shape).astype(np.float32)
        gj = jax.grad(lambda x: (jp(x) * w).sum())(jnp.asarray(m))
        (gt,) = _grad_t(lambda x: tp(x) * t(w), t(m))
        np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-4)

    def test_jittered_uses_given_noise_or_generator(self):
        from chore_tpu_torch.ops.rotation import project_so3, project_so3_jittered

        m = t(self._mats(3))
        noise = 1e-4 * torch.rand(m.shape, generator=torch.Generator()
                                  .manual_seed(0))
        torch.testing.assert_close(project_so3_jittered(m, noise=noise),
                                   project_so3(m + noise))
        a = project_so3_jittered(m, torch.Generator().manual_seed(1))
        b = project_so3_jittered(m, torch.Generator().manual_seed(1))
        torch.testing.assert_close(a, b)

    def test_pseudo_inverse_and_orientation(self):
        from chore_tpu.ops import rotation as jr
        from chore_tpu_torch.ops import rotation as tr

        a, b = self._mats(4), self._mats(5)
        np.testing.assert_allclose(n(tr.pseudo_inverse(t(a))),
                                   np.asarray(jr.pseudo_inverse(a)), atol=1e-4)
        np.testing.assert_allclose(
            n(tr.init_object_orientation(t(a), t(b))),
            np.asarray(jr.init_object_orientation(a, b)), atol=1e-4)

    def test_axis_angle(self):
        from chore_tpu.ops.rotation import axis_angle_to_matrix as ja
        from chore_tpu_torch.ops.rotation import axis_angle_to_matrix as ta

        aa = np.random.RandomState(6).randn(5, 7, 3).astype(np.float32)
        aa[0, 0] = 0.0
        np.testing.assert_allclose(n(ta(t(aa))), np.asarray(ja(aa)), atol=1e-6)
        gj = jax.grad(lambda x: ja(x).sum())(jnp.asarray(aa))
        (gt,) = _grad_t(ta, t(aa))
        np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-5)


class TestGridSample:
    @pytest.fixture()
    def data(self):
        rng = np.random.RandomState(0)
        feat = rng.randn(2, 9, 11, 6).astype(np.float32)
        uv = rng.uniform(-1.3, 1.3, (2, 40, 2)).astype(np.float32)
        uv[0, 0] = [1.0, -1.0]  # exact corners
        return feat, uv

    @pytest.mark.parametrize("frozen", [False, True])
    def test_forward_and_uv_grad(self, data, frozen):
        """align_corners=True, zero padding; 1e-5 forward, 1e-4 on the uv
        gradient (the JAX frozen sampler's hand-written VJP against
        grid_sample's backward)."""
        from chore_tpu.ops import grid_sample as jg
        from chore_tpu_torch.ops import grid_sample as tg

        feat, uv = data
        jf = jg.bilinear_sample_frozen if frozen else jg.bilinear_sample
        tf = tg.bilinear_sample_frozen if frozen else tg.bilinear_sample
        np.testing.assert_allclose(n(tf(t(feat), t(uv))),
                                   np.asarray(jf(feat, uv)), atol=1e-5)
        w = np.random.RandomState(1).randn(2, 40, 6).astype(np.float32)
        gj = jax.grad(lambda u: (jf(jnp.asarray(feat), u) * w).sum())(
            jnp.asarray(uv))
        (gt,) = _grad_t(lambda u: tf(t(feat), u) * t(w), t(uv))
        np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-4)

    def test_feature_grad(self, data):
        from chore_tpu.ops import grid_sample as jg
        from chore_tpu_torch.ops import grid_sample as tg

        feat, uv = data
        gj = jax.grad(lambda f: jg.bilinear_sample(f, uv).sum())(
            jnp.asarray(feat))
        (gt,) = _grad_t(lambda f: tg.bilinear_sample(f, t(uv)), t(feat))
        np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-5)


class TestLayers:
    @pytest.mark.parametrize("cin,cout", [(64, 128), (64, 64)])
    def test_conv_block(self, cin, cout):
        """ConvBlock with and without the downsample projection, weights
        through params_from_jax; 1e-4 (3x3 convs summed in another order)."""
        from chore_tpu.models.layers import ConvBlock as JB
        from chore_tpu_torch.models.convert import params_from_jax
        from chore_tpu_torch.models.layers import ConvBlock as TB

        rng = np.random.RandomState(0)
        x = rng.randn(1, 8, 8, cin).astype(np.float32)
        jb = JB(cin, cout)
        params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
        params = jax.tree_util.tree_map(
            lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype),
            params)
        tb = TB(cin, cout)
        tb.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        want = np.asarray(jb.apply(params, jnp.asarray(x)))
        got = n(tb(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_bicubic_and_pool(self):
        """F.interpolate(bicubic, align_corners=True) equals the JAX
        package's explicit interpolation matrices to 1e-5."""
        from chore_tpu.models import layers as jl
        from chore_tpu_torch.models import layers as tl

        x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
        nchw = t(x).permute(0, 3, 1, 2)
        np.testing.assert_allclose(
            n(tl.bicubic_upsample_2x(nchw).permute(0, 2, 3, 1)),
            np.asarray(jl.bicubic_upsample_2x(jnp.asarray(x))), atol=1e-5)
        x = x[:, :4, :6]
        np.testing.assert_allclose(
            n(tl.avg_pool_2x(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)),
            np.asarray(jl.avg_pool_2x(jnp.asarray(x))), atol=1e-6)

    def test_one_hot_ce_out_of_range_labels(self):
        """Labels outside [0, C) give a zero row (zero loss), as
        jax.nn.one_hot does; values and logit gradients to 1e-6."""
        from chore_tpu.models.layers import one_hot_ce as jce
        from chore_tpu_torch.models.layers import one_hot_ce as tce

        rng = np.random.RandomState(2)
        logits = rng.randn(3, 20, 14).astype(np.float32)
        labels = rng.randint(0, 14, (3, 20)).astype(np.int32)
        labels[0, :3] = [-1, 14, 99]
        want = np.asarray(jce(jnp.asarray(logits), jnp.asarray(labels)))
        got = n(tce(t(logits), t(labels, torch.int64)))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert (got[0, :3] == 0).all()
        gj = jax.grad(lambda z: jce(z, jnp.asarray(labels)).sum())(
            jnp.asarray(logits))
        (gt,) = _grad_t(lambda z: tce(z, t(labels, torch.int64)), t(logits))
        np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-6)


class TestConvert:
    def test_roundtrip_through_reference_importer(self):
        """params_from_jax inverts chore_tpu's torch importer exactly:
        port state dict -> convert_state_dict -> the original flax tree."""
        from chore_tpu.train.torch_import import convert_state_dict
        from test_torch_port_util import jax_field, torch_field

        _, params = jax_field()
        sd = torch_field(params).state_dict()
        back, unused = convert_state_dict(sd, params)
        assert all(".downsample.0." in k or ".bn4." in k for k in unused)
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(params)[0],
                jax.tree_util.tree_flatten_with_path(back)[0]):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_reference_checkpoint_loads_strictly(self, tmp_path):
        """A reference-style ``.tar`` (DDP ``module.`` prefixes, bn4 and its
        ``downsample.0`` alias in every block) loads into CHOREField with a
        strict load_state_dict and gives the same outputs."""
        from chore_tpu_torch.models.chore import FieldConfig, build_field
        from chore_tpu_torch.models.convert import load_reference_checkpoint

        src = build_field(FieldConfig(num_stack=1), device="cpu", seed=4)
        sd = {"module." + k: v for k, v in src.state_dict().items()}
        assert any(".downsample.0." in k for k in sd)
        path = tmp_path / "checkpoint_epoch_1.tar"
        torch.save({"model_state_dict": sd, "epoch": 1}, path)
        dst = build_field(FieldConfig(num_stack=1), device="cpu",
                          state_dict=load_reference_checkpoint(path))
        img = torch.rand(1, 64, 64, 5, generator=torch.Generator().manual_seed(0))
        pts = torch.tensor([[[0.1, -0.2, 2.2], [0.3, 0.1, 2.0]]])
        cc = torch.tensor([[1018.0, 779.0]])
        a, b = src(img, pts, cc)[-1], dst(img, pts, cc)[-1]
        for k in a:
            assert torch.equal(a[k], b[k]), k
