"""The silhouette path against ``chore_tpu``: the plain versions of the
coverage kernels K2/K3 against the Pallas kernels (interpret mode, as
``tests/test_pallas_sil.py`` runs them), ``edge_coeffs``, the whole
``soft_silhouette`` against the JAX XLA path, the projection, the losses,
and the cv2-free ROI prep against the cv2 one.

Tolerances: coverage 1e-5 absolute; gradients rtol 1e-4 / atol 1e-7 (f32
sums over pixels in another order) -- the bounds ``test_pallas_sil.py``
holds the JAX package's two paths to."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import chore_tpu.ops.pallas.silhouette as jsil
import chore_tpu.ops.rasterizer as JR
from chore_tpu.utils.meshio import octasphere
from test_torch_port_util import n, t

K_UNIT = np.array([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]], np.float32)


@pytest.fixture()
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(jsil, "_coverage_fwd_call",
                        jsil._coverage_fwd_call.__wrapped__)
    monkeypatch.setattr(jsil, "_coverage_bwd_call",
                        jsil._coverage_bwd_call.__wrapped__)


def _scene(subdiv=2, shift=(0.0, 0.0, 0.0)):
    """(1, V, 3) projected octasphere and its faces, numpy."""
    tv, tf = octasphere(radius=0.18, center=(0.1, 0.05, 2.0), subdiv=subdiv)
    ndc = np.asarray(JR.project_unit_k(jnp.asarray(tv)[None],
                                       jnp.asarray(K_UNIT)))
    return (ndc + np.asarray(shift, np.float32)).astype(np.float32), tf


def _bad_scene():
    """One vertex behind the camera and one degenerate face."""
    ndc, tf = _scene()
    ndc = ndc.copy()
    ndc[0, 0, 2] = -1.0
    ndc[0, 1] = ndc[0, 2]
    return ndc, tf


CASES = {
    "octasphere": lambda: (*_scene(), 64, 1.0),
    "degenerate_behind_camera": lambda: (*_bad_scene(), 64, 1.0),
    "no_faces": lambda: (_scene()[0], np.zeros((0, 3), np.int32), 32, 1.0),
    "size_100": lambda: (*_scene(), 100, 1.0),
    "sigma_x4": lambda: (*_scene(), 64, 4.0),
}


def _upstream(S, seed=0):
    """Random g with every other 8-row band zero: whole pixel tiles (and
    the TPU kernel's whole tiles) see no gradient."""
    g = np.random.RandomState(seed).randn(S, S).astype(np.float32)
    for r0 in range(0, S, 16):
        g[r0 : r0 + 8] = 0.0
    return g.reshape(-1)


@pytest.mark.parametrize("case", list(CASES))
def test_coverage_plain_matches_pallas(interpret, case):
    """``coverage_sums_plain`` and ``coverage_sums_bwd_plain`` against the
    Pallas kernels' forward and VJP on the same coefficients."""
    from chore_tpu_torch.ops.silhouette import (
        coverage_sums_bwd_plain,
        coverage_sums_plain,
    )

    ndc, tf, S, widen = CASES[case]()
    sigma = widen * 0.5 * (2.0 / S)
    e = jsil.edge_coeffs(jnp.asarray(ndc[0]), jnp.asarray(tf), sigma)
    g = _upstream(S)
    cov_j, vjp = jax.vjp(lambda x: jsil.coverage_sums(x, S, 1.0 / sigma), e)
    (de_j,) = vjp(jnp.asarray(g))
    e_t = t(e)[None]
    cov_t = coverage_sums_plain(e_t, S, 1.0 / sigma)
    de_t = coverage_sums_bwd_plain(e_t, t(g)[None], S, 1.0 / sigma)
    assert cov_t.shape == (1, S * S) and de_t.shape == (1, 3, 8, len(tf))
    np.testing.assert_allclose(n(cov_t)[0], np.asarray(cov_j), atol=1e-5)
    np.testing.assert_allclose(n(de_t)[0], np.asarray(de_j), rtol=1e-4,
                               atol=1e-7)
    if case == "no_faces":
        assert (n(cov_t) == 0).all()
    else:
        assert np.asarray(cov_j).sum() > 10 and np.abs(de_j).max() > 0


def test_plain_autograd_routes_like_the_explicit_vjp():
    """Autograd through ``coverage_sums_plain`` (first-minimizer
    ``torch.where`` chains) gives ``coverage_sums_bwd_plain``, batch of 2."""
    from chore_tpu_torch.ops.silhouette import (
        coverage_sums_bwd_plain,
        coverage_sums_plain,
        edge_coeffs,
    )

    a, tf = _scene()
    b, _ = _scene(shift=(0.2, -0.1, 0.0))
    S, sigma = 48, 0.5 * (2.0 / 48)
    e = edge_coeffs(t(np.concatenate([a, b])), torch.as_tensor(tf), sigma)
    e = e.detach().requires_grad_(True)
    g = t(np.stack([_upstream(S, 1), _upstream(S, 2)]))
    (de_auto,) = torch.autograd.grad(
        coverage_sums_plain(e, S, 1.0 / sigma), e, g)
    de = coverage_sums_bwd_plain(e.detach(), g, S, 1.0 / sigma)
    torch.testing.assert_close(de, de_auto, rtol=1e-5, atol=1e-7)
    assert float(de[1].abs().max()) > 0


def _tie_mesh():
    """Axis-aligned triangles (a box tie between two vertices per axis), a
    sliver, and a face seen from behind (clockwise)."""
    v = np.array([[[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.5, 0.5, 2.0],
                   [-0.5, 0.5, 2.0], [0.1, 0.1, 2.5], [0.9, 0.12, 2.5],
                   [0.5, 0.11, 2.5]]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [0, 3, 2]], np.int32)
    return v, f


@pytest.mark.parametrize("mesh", ["octasphere", "bad", "ties"])
def test_edge_coeffs_values_and_vjp(mesh):
    from chore_tpu_torch.ops.silhouette import edge_coeffs

    ndc, tf = {"octasphere": _scene, "bad": _bad_scene,
               "ties": _tie_mesh}[mesh]()
    sigma = 0.5 * (2.0 / 64)
    ct = np.random.RandomState(1).randn(3, 8, len(tf)).astype(np.float32)
    e_j, vjp = jax.vjp(lambda v: jsil.edge_coeffs(v, jnp.asarray(tf), sigma),
                       jnp.asarray(ndc[0]))
    (gv_j,) = vjp(jnp.asarray(ct))
    v_t = t(ndc).requires_grad_(True)
    e_t = edge_coeffs(v_t, torch.as_tensor(tf), sigma)
    (gv_t,) = torch.autograd.grad(e_t, v_t, t(ct)[None])
    e_j = np.asarray(e_j)
    np.testing.assert_allclose(n(e_t)[0], e_j, rtol=1e-5,
                               atol=1e-6 * np.abs(e_j).max())
    np.testing.assert_allclose(n(gv_t)[0], np.asarray(gv_j), rtol=1e-4,
                               atol=1e-7 * np.abs(gv_j).max())


def _render_loss_j(ndc, tf, S, ref, fn):
    def loss(shift):
        sil = fn(jnp.asarray(ndc) + shift[None, None], jnp.asarray(tf),
                 image_size=S)
        return jnp.mean((sil - jnp.asarray(ref)) ** 2), sil

    (v, sil), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray([0.03, -0.02, 0.0]))
    return np.asarray(sil), float(v), np.asarray(g)


@pytest.mark.parametrize("case", ["octasphere", "degenerate_behind_camera",
                                  "offscreen"])
def test_soft_silhouette_matches_xla_path(case):
    """The port's render (edge-coefficient form) against the XLA path the
    JAX CPU fit runs: values and the gradient of a mask loss w.r.t. a
    translation."""
    from chore_tpu_torch.ops.rasterizer import soft_silhouette

    ndc, tf = {"octasphere": _scene, "degenerate_behind_camera": _bad_scene,
               "offscreen": lambda: _scene(shift=(5.0, 0.0, 0.0))}[case]()
    S = 64
    ref = (np.asarray(JR.soft_silhouette(jnp.asarray(_scene()[0]),
                                         jnp.asarray(tf), image_size=S))
           > 0.5).astype(np.float32)
    sil_j, v_j, g_j = _render_loss_j(ndc, tf, S, ref, JR.soft_silhouette)
    shift = t([0.03, -0.02, 0.0]).requires_grad_(True)
    sil_t = soft_silhouette(t(ndc) + shift[None, None], torch.as_tensor(tf),
                            image_size=S)
    v_t = ((sil_t - t(ref)) ** 2).mean()
    (g_t,) = torch.autograd.grad(v_t, shift)
    np.testing.assert_allclose(n(sil_t), sil_j, atol=1e-5)
    np.testing.assert_allclose(float(v_t.detach()), v_j, rtol=1e-5)
    np.testing.assert_allclose(n(g_t), g_j, rtol=1e-4, atol=1e-7)
    if case == "offscreen":
        assert (n(sil_t) == 0).all() and (n(g_t) == 0).all()
    else:
        assert np.abs(g_j).max() > 0


def test_clip_gradient_matches_jnp_clip():
    """0.5 at exactly 0 and 1, as ``jnp.clip``'s max/min ties give."""
    from chore_tpu_torch.ops.rasterizer import _Clip01

    x = np.array([-1.0, 0.0, 0.25, 1.0, 3.0], np.float32)
    gj = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.asarray(x)))
    xt = t(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(_Clip01.apply(xt).sum(), xt)
    np.testing.assert_array_equal(n(gt), gj)
    np.testing.assert_array_equal(gj, [0.0, 0.5, 1.0, 0.5, 0.0])


def test_project_unit_k():
    from chore_tpu_torch.ops.rasterizer import project_unit_k

    rng = np.random.RandomState(2)
    v = (rng.randn(2, 40, 3) * 0.2 + [0, 0, 2]).astype(np.float32)
    K = np.stack([K_UNIT[0], K_UNIT[0] * [[1.3], [0.8], [1.0]]])
    np.testing.assert_allclose(
        n(project_unit_k(t(v), t(K))),
        np.asarray(JR.project_unit_k(jnp.asarray(v), jnp.asarray(K))),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# the losses and the ROI prep (recon/silhouette.py)
S_NET = 128


def _masks(empty_object=False):
    """Net-input person (box) and object (disk) masks, (2, S, S); frame 1
    shifted; ``empty_object`` blanks frame 1's object."""
    yy, xx = np.mgrid[:S_NET, :S_NET]
    person = np.zeros((2, S_NET, S_NET), np.float32)
    obj = np.zeros_like(person)
    for i, (cx, cy, r) in enumerate(((64.3, 70.1, 21.7), (40.6, 52.2, 13.4))):
        obj[i] = ((xx - cx) ** 2 + (yy - cy) ** 2 < r * r)
        person[i, int(cy) - 30 : int(cy) + 5, int(cx) - 28 : int(cx) + 9] = 1
    if empty_object:
        obj[1] = 0
    return person, obj


def _sil_rois(empty_object=False, rend=64):
    from chore_tpu.recon.silhouette import SilhouetteLossROI as JS
    from chore_tpu_torch.recon.silhouette import SilhouetteLossROI as TS

    tv, tf = octasphere(radius=0.18, subdiv=2)
    person, obj = _masks(empty_object)
    cc = np.array([[1018.0, 779.0], [900.0, 700.0]], np.float32)
    kw = dict(rend_size=rend, net_input=S_NET, compute_edt=True)
    return (JS(person, obj, tv, tf, cc, **kw), TS(person, obj, tv, tf, cc, **kw),
            person, obj, tv, tf)


@pytest.mark.parametrize("empty_object", [False, True])
def test_roi_prep_matches_cv2(empty_object):
    """``SilhouetteLossROI.data``: k_rois to 1e-6; image_ref / keep_mask
    equal except where cv2's interpolated mask lies within 1e-5 of the 0.5
    threshold; the edge distance transform equal where the masks are."""
    from chore_tpu.recon.silhouette import crop_resize as jcrop
    from chore_tpu.recon.silhouette import mask_to_square_bbox

    js, ts, person, obj, _, _ = _sil_rois(empty_object)
    np.testing.assert_allclose(ts.data["k_rois"], js.data["k_rois"],
                               rtol=1e-6, atol=1e-6)
    for i in range(2):
        if empty_object and i == 1:
            for k in ("image_ref", "keep_mask", "edt_ref"):
                assert (ts.data[k][i] == 0).all() and (js.data[k][i] == 0).all()
            continue
        bbox = mask_to_square_bbox(obj[i])
        near = ((np.abs(jcrop(obj[i], bbox, 64) - 0.5) < 1e-5)
                | (np.abs(jcrop(person[i], bbox, 64) - 0.5) < 1e-5))
        for k in ("image_ref", "keep_mask"):
            same = ts.data[k][i] == js.data[k][i]
            assert (same | near).all(), k
        if not near.any():  # the distance transform of equal masks
            np.testing.assert_array_equal(ts.data["edt_ref"][i],
                                          js.data["edt_ref"][i])
        assert ts.data["image_ref"][i].sum() > 100


@pytest.mark.parametrize("size,out", [(77, 256), (300, 256), (100, 33),
                                      (67, 33), (64, 64)])
def test_crop_resize_matches_cv2(size, out):
    """The numpy bilinear resize against ``cv2.resize(INTER_LINEAR)`` on
    binary and random float masks, up- and downscaling: an f32 ulp."""
    import cv2

    from chore_tpu_torch.recon.silhouette import crop_resize, resize_linear

    rng = np.random.RandomState(size)
    for img in ((rng.rand(size, size) > 0.5).astype(np.float32),
                rng.rand(size, size).astype(np.float32)):
        want = cv2.resize(img, (out, out), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(resize_linear(img, out), want, atol=3e-7)
    from chore_tpu.recon.silhouette import crop_resize as jcrop

    mask = (rng.rand(90, 90) > 0.4).astype(np.float32)
    bbox = np.array([-10.4, 20.6, size * 0.9, size * 0.9])
    np.testing.assert_allclose(crop_resize(mask, bbox, out),
                               jcrop(mask, bbox, out), atol=3e-7)


def _pose(B=2, seed=3):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    R = Rotation.from_rotvec(rng.randn(B, 3) * 0.3).as_matrix()
    R = R.astype(np.float32)
    tr = np.array([[0.02, -0.01, 2.2], [-0.05, 0.03, 2.4]], np.float32)[:B]
    s = np.array([1.05, 0.9], np.float32)[:B]
    return R, tr, s


@pytest.mark.parametrize("sigma_widen", [1.0, 3.0])
def test_silhouette_loss_value_and_grads(sigma_widen):
    """Value and gradients w.r.t. R, t, s of the masked L2 on the ROI
    render (B = 2, one frame's object behind a person box)."""
    from chore_tpu.recon.silhouette import silhouette_loss as jloss
    from chore_tpu_torch.recon.silhouette import silhouette_loss as tloss

    js, ts, _, _, tv, tf = _sil_rois()
    R, tr, s = _pose()
    sigma = None if sigma_widen == 1.0 else sigma_widen * (1.0 / 64)

    def fj(R, tr, s):
        return jloss(js.data, tv, tf, R, tr, s, 64, sigma=sigma)[0]

    vj, gj = jax.value_and_grad(fj, argnums=(0, 1, 2))(
        jnp.asarray(R), jnp.asarray(tr), jnp.asarray(s))
    xs = [t(a).requires_grad_(True) for a in (R, tr, s)]
    vt = tloss(ts.tensors("cpu"), t(ts.verts), torch.as_tensor(tf), *xs, 64,
               sigma=sigma)[0]
    gt = torch.autograd.grad(vt, xs)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    assert float(vj) > 1.0
    # the projection is invariant to s (x s / z s), so its gradient is f32
    # cancellation noise: every gradient is held to the largest one's scale
    scale = max(np.abs(np.asarray(a)).max() for a in gj)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-4,
                                   atol=1e-5 * scale)
    assert np.abs(np.asarray(gj[0])).max() > 0
    assert np.abs(np.asarray(gj[1])).max() > 0
    if sigma is None:  # the ROI object's own call renders the same
        np.testing.assert_allclose(
            float(ts(*[t(a) for a in (R, tr, s)])[0]),
            float(js(jnp.asarray(R), jnp.asarray(tr), jnp.asarray(s))[0]),
            rtol=1e-5)


def test_offscreen_loss_value_and_grads():
    from chore_tpu.recon.silhouette import offscreen_loss as jloss
    from chore_tpu_torch.recon.silhouette import offscreen_loss as tloss

    js, ts, _, _, tv, _ = _sil_rois()
    R, tr, s = _pose()
    # frame 0 leaves the ROI sideways, frame 1 lies wholly behind the camera
    tr = tr + np.array([[0.6, 0.0, 0.0], [0.0, -0.7, -3.4]], np.float32)
    vj, gj = jax.value_and_grad(
        lambda *a: jloss(js.data, tv, *a), argnums=(0, 1, 2))(
        jnp.asarray(R), jnp.asarray(tr), jnp.asarray(s))
    xs = [t(a).requires_grad_(True) for a in (R, tr, s)]
    vt = tloss(ts.tensors("cpu"), t(ts.verts), *xs)
    gt = torch.autograd.grad(vt, xs)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    assert float(vj) > 1.0
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------------------- #
# the wrappers on the CPU
def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors run the plain versions through autograd and count no
    kernel launch."""
    from chore_tpu_torch.ops import silhouette as tsil

    before = dict(tsil.launches)
    ndc, tf = _scene()
    v = t(ndc).requires_grad_(True)
    e = tsil.edge_coeffs(v, torch.as_tensor(tf), 1.0 / 32)
    tsil.coverage_sums(e, 32, 32.0).sum().backward()
    assert tsil.launches == before
    assert float(v.grad.abs().max()) > 0


def test_cuda_wrappers_reject_cpu_tensors():
    from chore_tpu_torch.ops.silhouette import (
        coverage_sums_bwd_cuda,
        coverage_sums_cuda,
    )

    e = torch.zeros(1, 3, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        coverage_sums_cuda(e, 8, 8.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        coverage_sums_bwd_cuda(e, torch.zeros(1, 64), 8, 8.0)


def test_entry_points_are_typed(monkeypatch):
    """The kernels' C entry points get their argument types before the
    first call (a libc function stands in for the built library)."""
    import ctypes

    from chore_tpu_torch.ops import cuda_build
    from chore_tpu_torch.ops import silhouette as tsil

    libc = ctypes.CDLL(None)

    class Lib:
        coverage_fwd_launch = libc.labs
        coverage_bwd_launch = libc.llabs

    monkeypatch.setattr(cuda_build, "load", lambda name: Lib)
    lib = tsil._lib()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    assert list(lib.coverage_fwd_launch.argtypes) == [
        ptr, ptr, i32, i32, i32, ctypes.c_double, ptr]
    # K3 takes e, g and de only: one launch, no scratch buffer, and the
    # stand-in library has no other entry point for _lib to type
    assert list(lib.coverage_bwd_launch.argtypes) == [
        ptr, ptr, ptr, i32, i32, i32, ctypes.c_double, ptr]
    assert lib.coverage_bwd_launch.restype is i32
