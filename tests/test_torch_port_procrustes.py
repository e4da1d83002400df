"""``ops/procrustes.py`` and ``ops.rotation._newton_schulz_orthogonalize`` of
the port against ``chore_tpu``'s on the same seeded inputs (CPU, f32): R, t,
scale and the aligned points within 1e-5, for a single set, a batch, and a
reflected target (the sign(det) fix must still return a rotation)."""
import numpy as np
import pytest
import torch

TOL = 1e-5


def _case(kind):
    rng = np.random.RandomState({"single": 0, "batch": 1,
                                 "reflected": 2}[kind])
    shape = (4, 300, 3) if kind == "batch" else (300, 3)
    src = rng.randn(*shape).astype(np.float32)
    a = rng.randn(3, 3)
    rot = np.linalg.qr(a)[0] * np.sign(np.linalg.det(np.linalg.qr(a)[0]))
    ref = 1.3 * src @ rot.T + np.array([0.5, -0.3, 1.0])
    ref = ref + 0.01 * rng.randn(*shape)
    if kind == "reflected":
        ref = ref * np.array([-1.0, 1.0, 1.0])
    return src, ref.astype(np.float32)


@pytest.mark.parametrize("kind", ["single", "batch", "reflected"])
def test_similarity_transform_matches_jax(kind):
    import jax.numpy as jnp

    from chore_tpu.ops import procrustes as jp
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops import procrustes as tp

    use_full_f32()
    src, ref = _case(kind)
    want = jp.similarity_transform(jnp.asarray(src), jnp.asarray(ref))
    got = tp.similarity_transform(torch.from_numpy(src),
                                  torch.from_numpy(ref))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    r = got[0].double().numpy()
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        tp.align_points(torch.from_numpy(src), torch.from_numpy(ref)).numpy(),
        np.asarray(jp.align_points(jnp.asarray(src), jnp.asarray(ref))),
        atol=TOL, rtol=TOL)


def test_recovers_a_known_transform():
    """No noise: the recovered transform maps src onto ref to f32 noise."""
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops.procrustes import align_points

    use_full_f32()
    rng = np.random.RandomState(5)
    src = rng.randn(500, 3).astype(np.float32)
    q = np.linalg.qr(rng.randn(3, 3))[0]
    q = q * np.sign(np.linalg.det(q))
    ref = (0.7 * src @ q.T + np.array([1.0, 2.0, -0.5])).astype(np.float32)
    out = align_points(torch.from_numpy(src), torch.from_numpy(ref))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_newton_schulz_matches_jax():
    import jax.numpy as jnp

    from chore_tpu.ops.rotation import _newton_schulz_orthogonalize as jns
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops.rotation import _newton_schulz_orthogonalize

    use_full_f32()
    rng = np.random.RandomState(3)
    q = np.linalg.qr(rng.randn(5, 3, 3))[0]
    x = (q + 1e-3 * rng.randn(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _newton_schulz_orthogonalize(torch.from_numpy(x)).numpy(),
        np.asarray(jns(jnp.asarray(x))), atol=1e-6)
