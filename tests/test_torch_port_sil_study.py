"""``chore_tpu_torch.tools.sil_convergence`` against
``tools/sil_convergence.py``, at a reduced size (``chair_mesh(1)``, 288
faces):

* ``make_masks`` bitwise equal to the reference tool's at a 256^2 net
  input;
* the GT-pose anchor loss within 1e-5 relative of JAX's
  ``silhouette_loss``;
* the port's counterparts of ``tests/test_sil_convergence.py``: the render
  at GT matches the target, the background is empty, GT is near the
  minimum;
* a tiny study (2 rows, a few sil iterations): the small perturbation's
  masked L2 falls from its init.
"""
import numpy as np
import pytest
import torch

from test_torch_port_util import (  # noqa: F401 - a fixture
    few_torch_threads,
    reference_tool,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

NET = 256


@pytest.fixture(scope="module")
def chair():
    from chore_tpu_torch.tools.sil_convergence import (
        CROP_CENTER,
        R_GT_AXIS,
        R_GT_DEG,
        T_GT,
        rot_axis,
    )
    from chore_tpu_torch.utils.meshio import chair_mesh

    v, f = chair_mesh(1)
    return v, f, rot_axis(R_GT_AXIS, R_GT_DEG), T_GT, CROP_CENTER


def test_make_masks_equal_the_reference(chair):
    from chore_tpu_torch.tools import sil_convergence

    v, f, R, t, cc = chair
    ref = reference_tool("sil_convergence")
    want = ref.make_masks(v, f, R, t, 1.0, cc, net_input=NET)
    got = sil_convergence.make_masks(v, f, R, t, 1.0, cc, net_input=NET,
                                     device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.sum() > 100
        np.testing.assert_array_equal(g, w)


def _sil(chair, obj_mask, per_mask, rend):
    from chore_tpu_torch.recon.silhouette import SilhouetteLossROI

    v, f, _, _, cc = chair
    return SilhouetteLossROI(per_mask[None], obj_mask[None], v, f, cc,
                             rend_size=rend, net_input=obj_mask.shape[0])


def _loss(chair, sil, R, t, rend):
    from chore_tpu_torch.recon.silhouette import silhouette_loss

    v, f = chair[:2]
    loss, img = silhouette_loss(
        sil.tensors("cpu"), torch.as_tensor(v),
        torch.as_tensor(f, dtype=torch.int64),
        torch.as_tensor(np.asarray(R, np.float32)[None]),
        torch.as_tensor(np.asarray(t, np.float32)[None]),
        torch.ones(1), rend)
    return float(loss), img[0].numpy()


def test_anchor_loss_matches_jax(chair):
    """At the GT pose, on the same masks, the port's loss and render
    against JAX's ``silhouette_loss`` and ``SilhouetteLossROI``."""
    import jax.numpy as jnp

    from chore_tpu.recon.silhouette import SilhouetteLossROI as JSil
    from chore_tpu.recon.silhouette import silhouette_loss as jloss
    from chore_tpu_torch.tools import sil_convergence

    v, f, R, t, cc = chair
    obj, per = sil_convergence.make_masks(v, f, R, t, 1.0, cc,
                                          net_input=NET, device="cpu")
    rend = 128
    sil = _sil(chair, obj, per, rend)
    jsil = JSil(per[None], obj[None], v, f, cc, rend_size=rend,
                net_input=NET)
    for k, a in sil.data.items():
        np.testing.assert_array_equal(a, np.asarray(jsil.data[k]), err_msg=k)
    got, img = _loss(chair, sil, R, t, rend)
    want, jimg = jloss(jsil.data, v, f, jnp.asarray(R[None]),
                       jnp.asarray(t[None]), jnp.asarray([1.0], jnp.float32),
                       rend)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(img, np.asarray(jimg)[0], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def scene_512(chair):
    """GT chair mask at a 512^2 net input, no person, and its 128^2 ROI
    data (``tests/test_sil_convergence.py``'s scene)."""
    from chore_tpu_torch.ops.camera import PerspectiveCamera
    from chore_tpu_torch.ops.rasterizer import hard_rasterize

    v, f, R, t, cc = chair

    ndc = PerspectiveCamera().project_points(
        torch.as_tensor((v @ R + t)[None]), torch.as_tensor(cc))
    fid, _, _ = hard_rasterize(ndc, torch.as_tensor(f, dtype=torch.int64),
                               image_size=512)
    obj = (fid[0].numpy() >= 0).astype(np.float32)
    return _sil(chair, obj, np.zeros_like(obj), 128)


def test_render_at_gt_matches_target(chair, scene_512):
    """IoU of the soft render at the exact GT pose with image_ref: 0.66
    with the round-4 sliver-slab bug, ~0.9 healthy."""
    _, img = _loss(chair, scene_512, chair[2], chair[3], 128)
    img = img > 0.5
    ref = scene_512.data["image_ref"][0] > 0.5
    assert (img | ref).sum() > 500  # the scene is on screen
    assert (img & ref).sum() / (img | ref).sum() > 0.82


def test_background_is_empty(chair, scene_512):
    """No coverage beyond ~the coverage support of the target."""
    from scipy.ndimage import binary_dilation

    _, img = _loss(chair, scene_512, chair[2], chair[3], 128)
    ref = scene_512.data["image_ref"][0] > 0.5
    near = binary_dilation(ref, np.ones((21, 21), bool))
    assert img[~near].max() < 0.05


def test_gt_is_near_minimum(chair, scene_512):
    """Visibly wrong poses cost more than GT (a misaligned target would
    let them win)."""
    from chore_tpu_torch.tools.sil_convergence import rot_axis

    R, t = chair[2], chair[3]
    l_gt, _ = _loss(chair, scene_512, R, t, 128)
    for deg, dt in ((20, 0.1), (40, 0.15)):
        l, _ = _loss(chair, scene_512, R @ rot_axis([1, 0.3, 0.2], deg),
                     t + np.float32(dt), 128)
        assert l > l_gt * 1.5


def test_tiny_study_small_perturbation_improves(chair):
    """Two rows, 2 sil iterations at 128^2: the 5-degree row's masked L2
    ends below its value at the perturbed init, and every number is
    finite."""
    from chore_tpu_torch.tools import sil_convergence as sc

    rend = 128
    res = sc.study(subdiv=1, iters=2, rend=rend, device="cpu",
                   grid=sc.GRID[:2], verbose=False)
    assert res["faces"] == 288 and res["iters"]["sil"] == 2
    assert res["anchor"]["iou"] > 0.82
    rows = res["rows"]
    assert [r["grid"] for r in rows] == sc.GRID[:2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in (
            "rot0", "rot1", "te0", "te1", "se", "iou", "l2_fin", "l2_gt"))
        assert r["l2_fin"] >= r["l2_gt"]
    # the 5-degree row's L2 at its perturbed init
    v, f, R, t, cc = chair
    R_init, t_init, s_init = sc.perturbations(np.random.RandomState(0), R,
                                              sc.GRID[:2])
    obj, per = sc.make_masks(v, f, R, t, 1.0, cc, device="cpu")
    sil = _sil(chair, obj, per, rend)
    from chore_tpu_torch.recon.silhouette import silhouette_loss

    _, img0 = silhouette_loss(
        sil.tensors("cpu"), torch.as_tensor(v),
        torch.as_tensor(f, dtype=torch.int64), torch.as_tensor(R_init[:1]),
        torch.as_tensor(np.asarray(t_init[:1], np.float32)),
        torch.as_tensor(s_init[:1]), rend)
    l2_init = float(((img0[0].numpy() - sil.data["image_ref"][0]) ** 2).sum())
    assert rows[0]["l2_fin"] < l2_init
