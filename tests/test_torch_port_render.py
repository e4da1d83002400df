"""The port's overlay renderer against ``chore_tpu``'s, on the CPU:
``ops.rasterizer.hard_rasterize`` (the JAX package's XLA scan z-buffer)
on random meshes, depth ordering, a zero-area face, faces behind the
camera and face counts that are not a multiple of the tile; then
``utils.render``'s ``render_meshes`` (flat and textured), ``look_at_side``
and ``align_to_input`` (cv2 inside the JAX package's; float32 resizes and
an integer translation in the port's).

Bounds: face maps equal (pixels exactly on a shared edge excepted, see
``test_hard_rasterize_pixels_on_a_shared_edge``); depth and barycentrics
within 1e-5 where the maps are equal. Renders within 1e-5 where the face
maps are equal. ``align_to_input``'s uint8 overlay within 1 LSB."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

HR_TOL = 1e-5
IMG_TOL = 1e-5


def _both_raster(verts, faces, S, **kw):
    from chore_tpu.ops.rasterizer import hard_rasterize as jhr
    from chore_tpu_torch.ops.rasterizer import hard_rasterize as thr

    j = [np.asarray(x) for x in jhr(jnp.asarray(verts), jnp.asarray(faces),
                                    image_size=S)]
    t = [x.numpy() for x in thr(torch.from_numpy(verts),
                                torch.from_numpy(faces.astype(np.int64)),
                                image_size=S, **kw)]
    return j, t


def _assert_raster_equal(j, t):
    (ji, jz, jw), (ti, tz, tw) = j, t
    assert ti.dtype == np.int32 and ti.shape == ji.shape
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tz, jz, atol=HR_TOL, rtol=0)
    np.testing.assert_allclose(tw, jw, atol=HR_TOL, rtol=0)


def _random_mesh(seed, F, B=1, spread=1.2):
    rng = np.random.RandomState(seed)
    V = 3 * F
    v = np.concatenate([rng.uniform(-spread, spread, (B, V, 2)),
                        rng.uniform(0.5, 3.0, (B, V, 1))], -1)
    # small triangles around random centres, so depth ordering matters
    v[..., :2] = (v[..., :2].reshape(B, F, 3, 2).mean(2, keepdims=True)
                  + 0.15 * rng.randn(B, F, 3, 2)).reshape(B, V, 2)
    f = rng.permutation(V).reshape(F, 3).astype(np.int32)
    return v.astype(np.float32), f


@pytest.mark.parametrize("F,S,B", [(1, 16, 1), (130, 48, 1), (700, 64, 2),
                                   (1100, 40, 1)])
def test_hard_rasterize_random_meshes(F, S, B, monkeypatch):
    """Face counts below, at and past one 512-face tile (130, 700, 1,100
    are no multiple of it), a batch of two; bands of few rows so several
    bands and tiles meet."""
    from chore_tpu_torch.ops import rasterizer

    monkeypatch.setitem(rasterizer._MAX_PAIRS, "cpu", 1 << 14)
    v, f = _random_mesh(F, F, B)
    j, t = _both_raster(v, f, S)
    _assert_raster_equal(j, t)
    assert (t[0] >= 0).mean() > 0.2 or F == 1


def _quads(corners, depths):
    """Copies of one quad (two triangles sharing its diagonal) at the
    given depths -> (verts (1, 4n, 3), faces (2n, 3))."""
    verts = [np.concatenate([corners, np.full((4, 1), z, np.float32)], 1)
             for z in depths]
    tri = np.array([[0, 1, 2], [0, 2, 3]])
    f = np.concatenate([tri + 4 * k for k in range(len(depths))])
    return np.concatenate(verts)[None].astype(np.float32), f.astype(np.int32)


def test_hard_rasterize_depth_order_and_ties():
    """Two copies of one quad at depths 2 and 3, the far one first: the
    near one wins; an exact duplicate of the near quad (a tie in depth)
    loses to the lower index. No pixel centre lies on the diagonal."""
    quad = np.array([[-0.61, -0.6], [0.6, -0.6], [0.6, 0.61], [-0.61, 0.61]],
                    np.float32)
    v, f = _quads(quad, (3.0, 2.0, 2.0))
    j, t = _both_raster(v, f, 32)
    _assert_raster_equal(j, t)
    inside = t[0][0] >= 0
    assert set(np.unique(t[0][0][inside])) == {2, 3}
    np.testing.assert_allclose(t[1][0][inside], 2.0, atol=1e-6)


def test_hard_rasterize_pixels_on_a_shared_edge():
    """A quad whose diagonal runs through pixel centres: there the exact
    edge value is 0 and the pixel is inside both triangles. The port
    computes d0 * r1 - d1 * r0 with two roundings (eager torch ops, as on
    the card) and gets 0, so the lower face index wins and the quad has
    no crack. The JAX package's XLA CPU build may fuse it into one
    multiply-add, leave a residual of ~2e-10 and draw the other face or
    nothing there, so the diagonal is not compared with it. Everywhere off
    the diagonal the maps are equal, and the diagonal's pixels are all the
    port's lower index."""
    quad = np.array([[-0.6, -0.6], [0.6, -0.6], [0.6, 0.6], [-0.6, 0.6]],
                    np.float32)
    v, f = _quads(quad, (2.0,))
    (ji, jz, _), (ti, tz, _) = _both_raster(v, f, 32)
    c = (2.0 * np.arange(32) + 1.0) / 32 - 1.0
    inside_quad = ((np.abs(c)[:, None] < 0.6) & (np.abs(c)[None] < 0.6))
    diagonal = np.eye(32, dtype=bool) & inside_quad
    np.testing.assert_array_equal(ti[0][~diagonal], ji[0][~diagonal])
    assert (ti[0][inside_quad] >= 0).all()  # no crack
    assert (ti[0][diagonal] == 0).all()


def test_hard_rasterize_degenerate_and_behind_camera():
    """A zero-area face (collinear), a face with one vertex behind the
    camera and one wholly behind it are never drawn; a normal face behind
    them still is."""
    v = np.array([[
        [-0.5, -0.5, 2.0], [0.0, 0.0, 2.0], [0.5, 0.5, 2.0],   # collinear
        [-0.8, -0.8, 1.0], [0.8, -0.8, 1.0], [0.0, 0.8, -1.0],  # one z < 0
        [-0.8, -0.8, -1.0], [0.8, -0.8, -1.0], [0.0, 0.8, -1.0],  # behind
        [-0.9, -0.9, 4.0], [0.9, -0.9, 4.0], [0.0, 0.9, 4.0],  # visible
    ]], np.float32)
    f = np.arange(12, dtype=np.int32).reshape(4, 3)
    j, t = _both_raster(v, f, 24)
    _assert_raster_equal(j, t)
    assert set(np.unique(t[0])) == {-1, 3}


def test_hard_rasterize_empty_and_all_background():
    v = np.array([[[0, 0, 2.0], [0.1, 0, 2.0], [0, 0.1, 2.0]]], np.float32)
    j, t = _both_raster(v, np.zeros((0, 3), np.int32), 8)
    _assert_raster_equal(j, t)
    assert (t[0] == -1).all() and (t[1] == 100.0).all()


def _scene():
    from chore_tpu.utils.meshio import octasphere

    rng = np.random.RandomState(3)
    a = octasphere(radius=0.3, center=(0.1, 0.0, 2.2), subdiv=2)
    b = octasphere(radius=0.2, center=(-0.2, 0.1, 2.6), subdiv=2)
    a = (a[0] + 0.01 * rng.randn(*a[0].shape).astype(np.float32), a[1])
    return [a, b], [(0.2, 0.7, 0.3), (0.8, 0.3, 0.2)]


@pytest.mark.parametrize("side", [False, True])
def test_render_meshes_flat(side):
    from chore_tpu.utils.render import look_at_side as jside
    from chore_tpu.utils.render import render_meshes as jrender
    from chore_tpu_torch.utils.render import look_at_side as tside
    from chore_tpu_torch.utils.render import render_meshes as trender

    meshes, colors = _scene()
    if side:
        c = np.concatenate([v for v, _ in meshes]).mean(0)
        jm = [(jside(v, 90.0, c), f) for v, f in meshes]
        tm = [(tside(v, 90.0, c), f) for v, f in meshes]
        for (a, _), (b, _) in zip(jm, tm):
            np.testing.assert_array_equal(b, a)
        meshes = tm
    ji, jm_ = jrender(meshes, colors, image_size=96)
    ti, tm_ = trender(meshes, colors, image_size=96, device="cpu")
    np.testing.assert_array_equal(tm_, jm_)
    assert tm_.mean() > 0.01
    np.testing.assert_allclose(ti, ji, atol=IMG_TOL, rtol=0)


def test_render_meshes_textured():
    """One flat and one textured mesh in one z-buffer pass (the demo's
    ``--textured-obj`` path): the texture lookup is bilinear and
    border-clamped on both sides."""
    from chore_tpu.utils.render import render_meshes as jrender
    from chore_tpu_torch.utils.render import render_meshes as trender

    meshes, colors = _scene()
    rng = np.random.RandomState(4)
    F = len(meshes[1][1])
    uv = rng.rand(F, 3, 2).astype(np.float32)
    tex = rng.rand(12, 16, 3).astype(np.float32)
    textures = [None, (uv, tex)]
    ji, jm = jrender(meshes, colors, image_size=80, textures=textures)
    ti, tm = trender(meshes, colors, image_size=80, textures=textures,
                     device="cpu")
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ti, ji, atol=IMG_TOL, rtol=0)


def _overlay_inputs(seed, S, H, W):
    rng = np.random.RandomState(seed)
    render = rng.rand(S, S, 3).astype(np.float32)
    yy, xx = np.mgrid[:S, :S] / S
    mask = ((xx - 0.45) ** 2 + (yy - 0.55) ** 2) < 0.08
    photo = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    return render, mask, photo


@pytest.mark.parametrize("case", [
    dict(scale=1.0, center=(1008.0, 995.0), mean=False, H=1536, W=2048),
    dict(scale=1.0, center=(1008.0, 995.0), mean=True, H=1536, W=2048),
    dict(scale=1.0, center=(1208.0, 955.0), mean=True, H=1536, W=2048),
    dict(scale=1.0, center=(900.0, 1031.0), mean=True, H=1536, W=2048),
    dict(scale=2.0, center=(600.0, 400.0), mean=True, H=768, W=1024),
    dict(scale=1.6, center=(1000.0, 900.0), mean=False, H=960, W=1280),
])
def test_align_to_input_matches_cv2(case):
    """Identity, and mean-centre shifts of both signs in x and y, at the
    example's 2,048 x 1,536 and at photos scaled by 2 and 1.6: uint8
    within 1 LSB of the JAX package's cv2 resize + warpAffine."""
    from chore_tpu.utils.render import align_to_input as jalign
    from chore_tpu_torch.utils.render import align_to_input as talign

    render, mask, photo = _overlay_inputs(5, 64, case["H"], case["W"])
    info = {"resize_scale": case["scale"],
            "crop_center": np.array(case["center"])}
    a = jalign(render, mask, photo, info, use_mean_center=case["mean"],
               alpha=0.85)
    b = talign(render, mask, photo, info, use_mean_center=case["mean"],
               alpha=0.85)
    assert b.shape == a.shape == photo.shape and b.dtype == np.uint8
    assert np.abs(b.astype(int) - a.astype(int)).max() <= 1
    assert (b != photo).mean() > 0.01


def test_align_to_input_refuses_fractional_shift():
    from chore_tpu_torch.utils.render import align_to_input

    render, mask, photo = _overlay_inputs(6, 32, 1536, 2048)
    info = {"resize_scale": 1.0, "crop_center": np.array([1008.5, 995.0])}
    with pytest.raises(ValueError, match="whole number"):
        align_to_input(render, mask, photo, info, use_mean_center=True)
