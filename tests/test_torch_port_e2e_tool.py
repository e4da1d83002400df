"""``chore_tpu_torch.tools.e2e_synthetic`` end to end on the CPU:

* the tool at a cut schedule (2 frames, 1 epoch, 1 stack at 64^2, a few
  fit iterations): finite numbers under the reference tool's JSON keys,
  and its six plys;
* the evaluation glue on the tool's reconstructed meshes against the
  reference tool's (JAX's ``similarity_transform``, ``apply_transform``,
  ``chamfer_eval``): within 1e-5 relative;
* ``diag_object.diagnose`` on the tool's trained field at a cut schedule,
  and its GT-centre wrapper of ``ReconFitter.fit_object``.
"""
import json
import os

import numpy as np
import pytest

from test_torch_port_util import few_torch_threads  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("few_torch_threads")

JSON_KEYS = ["final_train_loss", "chamfer_smpl_m", "chamfer_obj_m",
             "n_valid_human", "n_valid_object", "epochs"]
IMG = 64


def cut_sampler():
    """Point generation cut to a CPU test's size (the tool's own draws 4,000
    points from the release sample counts)."""
    from chore_tpu_torch.recon.generator import SamplerConfig

    return SamplerConfig(num_steps=2, sample_num=1024, num_rounds=2,
                         num_points=256)


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    """The port's tool on 2 frames, 1 epoch, 1 stack at 64^2, with a cut
    fit schedule and point generation."""
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.tools import e2e_synthetic

    out = str(tmp_path_factory.mktemp("tool"))
    args = e2e_synthetic.parser().parse_args(
        ["--frames", "2", "--epochs", "1", "--num-stack", "1",
         "--img-size", str(IMG), "--out", out, "--device", "cpu"])
    fits_started = []
    rep, details = e2e_synthetic.run(
        args, fit_cfg=FitConfig(net_in_size=IMG, sil_rend_size=128,
                                iter_kpts_max=1, iter_obj=1, iter_joint=1,
                                iter_joint_max=1, steps_per_iter=2),
        sampler_cfg=cut_sampler(),
        before_fit=lambda: fits_started.append(len(fits_started)))
    details["fits_started"] = fits_started
    return out, rep, details


def test_tool_end_to_end(tool_run):
    out, rep, details = tool_run
    assert list(rep) == JSON_KEYS
    assert all(np.isfinite(v) for v in rep.values())
    assert rep["epochs"] == 1 and len(details["losses"]) == 1
    assert 0 < rep["n_valid_human"] <= 256 and rep["n_valid_object"] <= 256
    assert details["result"]["iters"]["joint"] >= 1
    assert sorted(os.listdir(os.path.join(out, "recon"))) == sorted(
        ["rec_smpl.ply", "rec_obj.ply", "gt_smpl.ply", "gt_obj.ply",
         "pc_human.ply", "pc_object.ply"])
    assert json.loads(json.dumps(rep)) == rep
    # the details a caller times and re-checks the run by: the hook ran
    # once, each stage has its seconds, and the returned clouds give the
    # report's Chamfer numbers
    from chore_tpu_torch.tools import e2e_synthetic

    assert details["fits_started"] == [0]
    assert sorted(details["seconds"]) == ["eval", "fit", "scenes", "train"]
    assert all(v > 0 for v in details["seconds"].values())
    assert [x.shape for pair in details["clouds"] for x in pair] == [
        (5000, 3)] * 4
    errs = e2e_synthetic.chamfer_errors(details["clouds"])
    assert errs == details["chamfer_m"]
    assert [round(e, 4) for e in errs] == [rep["chamfer_smpl_m"],
                                           rep["chamfer_obj_m"]]
    assert details["fitter"].timer.summary()["encode"]["count"] >= 1


def test_refit_without_a_shift_is_the_tool_fit(tool_run):
    """``refit`` (the crop-moved control fits) at no shift repeats the
    tool's fit bit for bit on the CPU; a shift moves it."""
    import torch

    from chore_tpu_torch.tools import e2e_synthetic

    _, _, d = tool_run
    item = e2e_synthetic.val_item(d["paths"][0], IMG)
    again = e2e_synthetic.refit(d["fitter"], d["gt0"], item, IMG)
    moved = e2e_synthetic.refit(d["fitter"], d["gt0"], item, IMG, 0.5)
    for c in ("smpl_params", "obj_params"):
        for n, v in d["result"][c].items():
            assert torch.equal(again[c][n], v), (c, n)
    assert not all(torch.equal(moved["obj_params"][n], v)
                   for n, v in d["result"]["obj_params"].items())


def test_evaluation_glue_matches_the_reference(tool_run):
    """The port's Procrustes + Chamfer on the tool's reconstruction against
    the reference tool's glue on the same meshes: JAX's
    ``similarity_transform`` and ``apply_transform`` give the same aligned
    samples (1e-5 m); the Chamfer within 1e-5 relative of a float64 oracle
    and of JAX's ``chamfer_eval`` on the same clouds moved to the GT
    cloud's centroid (the distance does not change; uncentred at z ~ 2 m,
    XLA's float32 expansion |x|^2 - 2x.y + |y|^2 picks farther neighbours
    and is itself ~1e-5 off the oracle, ``ops/chamfer.py``)."""
    import jax.numpy as jnp

    from chore_tpu.ops.chamfer import chamfer_eval
    from chore_tpu.ops.procrustes import apply_transform, similarity_transform
    from chore_tpu.utils.meshio import load_ply, sample_surface

    from chore_tpu_torch.tools import e2e_synthetic

    out, _, _ = tool_run
    meshes = {k: load_ply(os.path.join(out, "recon", f"{k}.ply"))[:2]
              for k in ("rec_smpl", "rec_obj", "gt_smpl", "gt_obj")}
    rec_smpl, rec_obj = meshes["rec_smpl"][0], meshes["rec_obj"][0]
    gt0 = {"smpl": meshes["gt_smpl"], "obj": meshes["gt_obj"]}
    obj_f = meshes["gt_obj"][1]
    clouds = e2e_synthetic.eval_clouds(rec_smpl, rec_obj, gt0, obj_f, "cpu")
    got = e2e_synthetic.evaluate(rec_smpl, rec_obj, gt0, obj_f, "cpu")
    r, t, s = similarity_transform(
        jnp.asarray(np.concatenate([rec_smpl, rec_obj])),
        jnp.asarray(np.concatenate([gt0["smpl"][0], gt0["obj"][0]])))
    for (x, y), rec, (gt, gt_f), faces, err in zip(
            clouds, (rec_smpl, rec_obj), (gt0["smpl"], gt0["obj"]),
            (gt0["smpl"][1], obj_f), got):
        rec_a = np.asarray(apply_transform(jnp.asarray(rec), r, t, s))
        jx = sample_surface(gt, gt_f, 5000)
        jy = sample_surface(rec_a, faces, 5000)
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-5)
        c = jx.mean(0)
        want = float(chamfer_eval(jnp.asarray(jx - c), jnp.asarray(jy - c)))
        a, b = jx.astype(np.float64), jy.astype(np.float64)
        d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
        oracle = d.min(1).mean() + d.min(0).mean()
        np.testing.assert_allclose(err, [want, oracle], rtol=1e-5)


DIAG_KEYS = ["field_df_o_on_gt_surface", "ray_depth_offset_m", "ray_df_min",
             "pred_center_err_m", "pcloud_n_valid", "pcloud_centroid_err_m",
             "pcloud_chamfer_m", "fit_objonly_chamfer_m",
             "fit_objonly_center_err_m", "fit_full_chamfer_m",
             "fit_full_center_err_m", "fit_gtinit_chamfer_m",
             "fit_gtinit_center_err_m"]


def test_diag_object_on_the_tool_run(tool_run):
    """``diag_object.diagnose`` on the tool's trained field at a cut
    schedule: the reference tool's keys, every number finite, and the
    GT-centred fit starting at the GT centre."""
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.tools import diag_object

    _, _, d = tool_run
    rep = diag_object.diagnose(
        d["model"], d["smplh"], d["gt0"], d["paths"][0], IMG,
        fit_cfg=FitConfig(net_in_size=IMG, sil_rend_size=128,
                          iter_kpts_max=1, iter_obj=1, iter_joint=1,
                          iter_joint_max=1, steps_per_iter=2),
        sampler_cfg=cut_sampler())
    assert list(rep) == DIAG_KEYS
    assert all(np.isfinite(v) for v in rep.values())
    assert rep["pcloud_n_valid"] <= 256


def test_with_center_replaces_the_predicted_centre(tool_run):
    """The wrapped ``fit_object`` gets ``centre - human_t`` as the object's
    centre relative to the human, every other argument as it came."""
    import torch

    from chore_tpu_torch.tools import diag_object

    seen = {}

    class Fitter:
        def fit_object(self, *args, **kw):
            seen["args"], seen["kw"] = args, kw
            return "out"

    f = Fitter()
    centre = np.array([0.45, 0.1, 2.25], np.float32)
    human_t = torch.tensor([[0.1, -0.2, 2.2]])
    rest = ("pca", human_t, "scale")
    assert diag_object.with_center(f, centre).fit_object(
        "feats", "tmpx", "cc", "smpl", torch.zeros(1, 3), *rest,
        generator="g", sil_data=None) == "out"
    args = seen["args"]
    assert args[:4] == ("feats", "tmpx", "cc", "smpl") and args[5:] == rest
    np.testing.assert_allclose(args[4].numpy(),
                               centre[None] - human_t.numpy(), atol=1e-7)
    assert seen["kw"] == {"generator": "g", "sil_data": None}


def test_fit_of_uint8_images_is_the_fit_of_their_floats(tool_run):
    """``fit_batch`` on ``BehaveTrainData``'s uint8 images (what the tools
    fit) equals the fit of the same images as float32 / 255, as in
    ``chore_tpu``, whose field scales integer images on the device. Casting
    them to float32 first fed the field 0..255: with GroupNorm after the
    first convolution that still fits, but worse (the learning check's
    object read 5.17 cm on an H100)."""
    import torch

    from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
    from chore_tpu_torch.tools import e2e_synthetic

    _, _, d = tool_run
    tv, tf = d["gt0"]["obj"]
    fitter = ReconFitter(
        d["model"], d["smplh"], tv, tf,
        cfg=FitConfig(net_in_size=IMG, iter_kpts_max=1, iter_obj=1,
                      iter_joint=1, iter_joint_max=1, steps_per_iter=2),
        sampler_cfg=cut_sampler(), device="cpu")
    item = e2e_synthetic.val_item(d["paths"][0], IMG)
    assert item["images"].dtype == np.uint8
    outs = [fitter.fit_batch(images, item["crop_center"][None],
                             d["gt0"]["pose"], np.zeros((1, 10), np.float32),
                             e2e_synthetic.zero_conf_kpts(IMG),
                             use_silhouette=False)
            for images in (item["images"][None],
                           item["images"][None].astype(np.float32) / 255)]
    for c in ("smpl_params", "obj_params"):
        for k, v in outs[1][c].items():
            assert torch.equal(outs[0][c][k], v), (c, k)
