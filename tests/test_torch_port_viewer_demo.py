"""The port's fit monitor and demo, on the CPU at small sizes:
``utils.viewer.FitMonitor.snapshot`` against ``chore_tpu``'s (the same
file names and losses.jsonl lines; frames within one level where the
renders agree to 1e-5, the written JPEGs decoded within 4 levels);
``fit_batch(monitor=)`` snapshots its three stages with the fit's own
meshes; ``cli.recon --debug-viz``; ``cli.demo`` (``run_demo`` and
``main --device cpu``) on the committed example frame writes every
artifact ``tests/test_demo_example.py`` lists, the overlay at the photo's
size. ``Reconstructor.save``'s overlay is held to ``chore_tpu``'s in
``test_torch_port_api.py`` (that file's JAX fit)."""
import json
import os

import numpy as np
import pytest

from test_torch_port_util import EXAMPLE, EXAMPLE_SEQ

DEMO_FILES = ["smpl.ply", "object.ply", "human_pc.ply", "object_pc.ply",
              "overlay.jpg", "side.jpg"]
STAGES = ["00_pclouds.jpg", "01_smpl.jpg", "02_object.jpg"]


def _tiny():
    from chore_tpu_torch.config import ChoreConfig
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.recon.generator import SamplerConfig

    cfg = ChoreConfig(exp_name="tiny-demo", num_stack=1, num_hourglass=1,
                      net_img_size=(64, 64))
    fit = FitConfig(iter_betas=1, iter_pose=1, iter_kpts_max=2, iter_obj=1,
                    iter_sil=1, iter_joint_max=2, steps_per_iter=2,
                    obj_samples=128, net_in_size=64, sil_rend_size=32)
    samp = SamplerConfig(num_steps=2, sample_num=256, num_rounds=2,
                         num_points=128)
    return cfg, fit, samp


def test_snapshot_matches_jax(tmp_path):
    from PIL import Image

    from chore_tpu.utils.viewer import FitMonitor as JMon
    from chore_tpu_torch.utils.meshio import octasphere
    from chore_tpu_torch.utils.viewer import FitMonitor as TMon

    sv, sf = octasphere(radius=0.3, center=(0, 0, 2.2), subdiv=2)
    rng = np.random.RandomState(0)
    pts = (rng.rand(1000, 3) * 0.4 + [0.3, 0, 2.0]).astype(np.float32)
    calls = [("pclouds", dict(pclouds={"object": pts, "human": pts - 0.3})),
             ("smpl", dict(meshes=[(sv, sf, JMon.SMPL_COLOR)],
                           losses={"df_h": 0.5, "j2d": np.float32(2.0)})),
             ("object:joint", dict(meshes=[(sv, sf, JMon.OBJ_COLOR)],
                                   pclouds={"x": pts}, losses={"a": 1}))]
    mons = {"j": JMon(str(tmp_path / "j"), image_size=64),
            "t": TMon(str(tmp_path / "t"), image_size=64)}
    for stage, kw in calls:
        fj = mons["j"].snapshot(stage, **kw)
        ft = mons["t"].snapshot(stage, device="cpu", **kw)
        assert ft.shape == fj.shape == (64, 128, 3)
        assert np.abs(ft.astype(int) - fj.astype(int)).max() <= 1
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == [
        "00_pclouds.jpg", "01_smpl.jpg", "02_object_joint.jpg",
        "losses.jsonl"]
    assert ((tmp_path / "t" / "losses.jsonl").read_text()
            == (tmp_path / "j" / "losses.jsonl").read_text())
    rec = [json.loads(x) for x in
           (tmp_path / "t" / "losses.jsonl").read_text().splitlines()]
    assert rec[0] == {"seq": 1, "stage": "smpl", "df_h": 0.5, "j2d": 2.0}
    for f in files[:-1]:
        a = np.array(Image.open(tmp_path / "t" / f)).astype(int)
        b = np.array(Image.open(tmp_path / "j" / f)).astype(int)
        assert np.abs(a - b).max() <= 4, f


def test_empty_snapshot_and_no_window(tmp_path):
    from chore_tpu_torch.utils.viewer import FitMonitor

    mon = FitMonitor(str(tmp_path), interactive=True)
    assert mon.interactive is False
    assert mon.snapshot("nothing", device="cpu") is None
    assert os.listdir(tmp_path) == [] and mon.seq == 0


def test_fit_batch_monitor_writes_three_stages(tmp_path):
    """A tiny fit on the CPU: snapshots after point generation, the SMPL
    chain and the object chain, with the fit's own clouds and meshes; no
    losses.jsonl (the fit's snapshots carry no losses, as in
    ``chore_tpu``)."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.recon.fitter import ReconFitter
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere
    from chore_tpu_torch.utils.viewer import FitMonitor

    class Recorder(FitMonitor):
        def __init__(self, outdir):
            super().__init__(outdir, image_size=48)
            self.calls = []

        def snapshot(self, stage, **kw):
            self.calls.append((stage, kw))
            return super().snapshot(stage, **kw)

    _, fit, samp = _tiny()
    tv, tf = octasphere(radius=0.15, subdiv=2)
    fitter = ReconFitter(build_field(FieldConfig(num_stack=1), device="cpu"),
                         SMPLH(synthetic_smplh(), device="cpu"), tv, tf,
                         cfg=fit, sampler_cfg=samp, device="cpu")
    rng = np.random.RandomState(0)
    images = rng.rand(1, 64, 64, 5).astype(np.float32)
    mon = Recorder(str(tmp_path))
    out = fitter.fit_batch(images, np.array([[1018.0, 779.0]]),
                           np.zeros((1, 72)), np.zeros((1, 10)),
                           np.zeros((1, 25, 3)), use_silhouette=False,
                           monitor=mon)
    assert [c[0] for c in mon.calls] == ["pclouds", "smpl", "object"]
    assert all(c[1]["device"].type == "cpu" for c in mon.calls)
    assert sorted(os.listdir(tmp_path)) == STAGES
    np.testing.assert_array_equal(
        mon.calls[0][1]["pclouds"]["object"],
        out["pclouds"]["object"]["points"][0].numpy())
    smpl = fitter.smplh.verts(out["smpl_params"])[0].numpy()
    obj = fitter.transform_obj(out["obj_params"],
                               points=fitter.template_verts)[0].numpy()
    (v1, f1, c1), = mon.calls[1][1]["meshes"]
    np.testing.assert_array_equal(v1, smpl)
    assert c1 == FitMonitor.SMPL_COLOR
    (v2, _, _), (v3, f3, c3) = mon.calls[2][1]["meshes"]
    np.testing.assert_array_equal(v2, smpl)
    np.testing.assert_array_equal(v3, obj)
    np.testing.assert_array_equal(f3, fitter.template_faces)
    assert c3 == FitMonitor.OBJ_COLOR


def test_cli_recon_debug_viz(tmp_path, monkeypatch):
    """``--debug-viz DIR`` reaches ``recon_fit``; ``recon_fit(debug_viz=)``
    at the tiny config writes the three snapshots."""
    import chore_tpu_torch.cli.recon as cli

    seen = {}
    monkeypatch.setattr(cli, "recon_fit",
                        lambda *a, **kw: seen.update(kw))
    cli.main(["-s", EXAMPLE_SEQ, "-sn", "x", "--debug-viz", "viz",
              "--device", "cpu"])
    assert seen["debug_viz"] == "viz" and seen["device"] == "cpu"
    monkeypatch.undo()

    cfg, fit, samp = _tiny()
    viz = str(tmp_path / "viz")
    cli.recon_fit(cfg, EXAMPLE_SEQ, "fit", str(tmp_path / "out"),
                  obj_name="basketball", exp_root=str(tmp_path / "none"),
                  fit_cfg=fit, sampler_cfg=samp, device="cpu",
                  debug_viz=viz)
    assert sorted(os.listdir(viz)) == STAGES
    assert os.path.isfile(os.path.join(tmp_path, "out", "example_synth",
                                       "frame0000", "fit", "k1.smpl.ply"))


def _assert_demo_frame(frame):
    from chore_tpu_torch.data.imageio import read_bgr

    for f in DEMO_FILES:
        path = os.path.join(frame, f)
        assert os.path.isfile(path) and os.path.getsize(path) > 0, f
    overlay = read_bgr(os.path.join(frame, "overlay.jpg"))
    photo = read_bgr(EXAMPLE)
    assert overlay.shape == photo.shape
    assert float(np.abs(overlay.astype(int) - photo.astype(int)).mean()) < 120
    assert read_bgr(os.path.join(frame, "side.jpg")).shape == (64, 64, 3)


def test_run_demo_on_the_example(tmp_path):
    """``run_demo`` at the tiny config, render 64, with a textured OBJ as
    the object template and field meshes at 12^3."""
    from chore_tpu_torch.cli.demo import run_demo
    from chore_tpu_torch.utils.meshio import octasphere
    from chore_tpu_torch.utils.textures import save_obj_textured

    v, f = octasphere(radius=0.15, subdiv=2)
    rng = np.random.RandomState(1)
    obj = str(tmp_path / "tex" / "ball.obj")
    os.makedirs(os.path.dirname(obj))
    save_obj_textured(obj, v, f, rng.rand(len(f), 3, 2).astype(np.float32),
                      rng.rand(8, 8, 3).astype(np.float32))
    cfg, fit, samp = _tiny()
    out = str(tmp_path / "demo_out")
    fitter = run_demo(cfg, EXAMPLE_SEQ, "basketball", outpath=out,
                      max_frames=1, fit_cfg=fit, sampler_cfg=samp,
                      render_size=64, textured_obj=obj, field_mesh_res=12,
                      exp_root=str(tmp_path / "none"), device="cpu")
    frame = os.path.join(out, "frame0000", "demo")
    _assert_demo_frame(frame)
    assert {"human_field.ply", "object_field.ply"} <= set(os.listdir(frame))
    assert len(fitter.template_faces) == len(f)
    for name in ("demo_prep", "demo_fit", "render_front", "render_side",
                 "align_to_input", "jpeg_overlay", "ply_writes"):
        assert fitter.timer.summary()[name]["count"] >= 1, name


def test_demo_main_on_cpu(tmp_path, monkeypatch):
    """``python -m chore_tpu_torch.cli.demo tiny -s <example> -o OUT
    --device cpu`` with configs/tiny.json (1 stack, 64^2) and the fit
    schedule cut."""
    import chore_tpu_torch.config as config
    from chore_tpu_torch.cli.demo import main

    cfg, fit, samp = _tiny()
    monkeypatch.setattr(config.ChoreConfig, "fit_config", lambda self: fit)
    monkeypatch.setattr(config.ChoreConfig, "sampler_config",
                        lambda self, num_points=5000: samp)
    monkeypatch.chdir(tmp_path)
    os.makedirs("configs")
    with open(os.path.join("configs", "tiny.json"), "w") as fh:
        json.dump({"num_stack": 1, "num_hourglass": 1,
                   "net_img_size": [64, 64]}, fh)
    monkeypatch.setattr("chore_tpu_torch.cli.demo.render_meshes",
                        _small_render())
    main(["tiny", "-s", EXAMPLE_SEQ, "-o", "OUT", "--device", "cpu",
          "--exp-root", "none"])
    _assert_demo_frame(os.path.join("OUT", "frame0000", "demo"))


def _small_render():
    """render_meshes at 64^2 whatever size main asks for (the CPU z-buffer
    at the default 512^2 costs seconds per view)."""
    from chore_tpu_torch.utils.render import render_meshes

    def render(*a, **kw):
        return render_meshes(*a, **{**kw, "image_size": 64})

    return render
