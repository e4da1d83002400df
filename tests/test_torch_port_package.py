"""Package-level contracts of ``chore_tpu_torch``: it imports neither JAX,
the JAX package, cv2, PIL, PyYAML nor msgpack, its sub-packages export
``chore_tpu``'s names, its assets are byte copies of ``chore_tpu``'s, its
entry points refuse to drop silently to the CPU, and ``fit_batch`` at its
defaults runs the silhouette phase, neutralized on a frame with no object
mask."""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "chore_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return mods


def test_imports_no_jax_or_reference():
    """Importing every module of the port, in a fresh interpreter, leaves
    jax, flax, optax, chore_tpu, cv2, PIL, yaml and msgpack (absent on the
    card's machine) out of sys.modules."""
    mods = _port_modules()
    assert "chore_tpu_torch.recon.silhouette" in mods and len(mods) > 15
    assert {"chore_tpu_torch.api", "chore_tpu_torch.cli.recon",
            "chore_tpu_torch.data.imageio", "chore_tpu_torch.cli.train",
            "chore_tpu_torch.train.trainer", "chore_tpu_torch.train.optim",
            "chore_tpu_torch.train.torch_import",
            "chore_tpu_torch.parallel.mesh",
            "chore_tpu_torch.data.train_data", "chore_tpu_torch.ops",
            "chore_tpu_torch.recon", "chore_tpu_torch.models",
            "chore_tpu_torch.parallel", "chore_tpu_torch.utils.profiling",
            "chore_tpu_torch.behave.readers"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'chore_tpu', 'cv2', 'PIL', "
            "'yaml', 'msgpack'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("sub", ["ops", "recon", "models"])
def test_exports_match_the_reference(sub):
    """Each sub-package exports every name of ``chore_tpu``'s ``__all__``
    (and may export more), each one defined."""
    import importlib

    want = importlib.import_module(f"chore_tpu.{sub}").__all__
    port = importlib.import_module(f"chore_tpu_torch.{sub}")
    assert set(want) <= set(port.__all__), set(want) - set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


@pytest.mark.parametrize("name", ["landmark_regressors.npz", "priors.npz",
                                  "smpl_parts_dense.npz"])
def test_assets_are_byte_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "chore_tpu", "assets", name),
                       os.path.join(PKG, "assets", name), shallow=False)


def test_no_device_without_a_card(monkeypatch):
    from chore_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    from chore_tpu_torch.parallel import init_distributed

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()


def test_full_f32_settings():
    from chore_tpu_torch import resolve_device

    resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_silhouette_phase_not_ported(monkeypatch):
    """The silhouette phase is ported: ``fit_batch`` at its defaults runs
    'sil' for its full budget; on a frame with no object mask the ROI prep
    neutralizes it, so every sil-phase mask loss is exactly 0 (the other
    phases' budgets and the render size are cut to keep this fast)."""
    import chore_tpu_torch.recon.fitter as tfit
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.recon.generator import SamplerConfig
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere

    masks = []

    def recording(*args, **kw):
        out = tfit_loss(*args, **kw)
        masks.append(float(out[0].detach()))
        return out

    tfit_loss = tfit.silhouette_loss
    monkeypatch.setattr(tfit, "silhouette_loss", recording)
    tv, tf = octasphere(radius=0.18, subdiv=1)
    cfg = tfit.FitConfig(obj_samples=64, iter_kpts_max=1, iter_obj=1,
                         iter_joint_max=1, steps_per_iter=2, net_in_size=64,
                         sil_rend_size=64)
    fitter = tfit.ReconFitter(
        build_field(FieldConfig(num_stack=1), device="cpu"),
        SMPLH(synthetic_smplh(), device="cpu"), tv, tf, cfg=cfg,
        sampler_cfg=SamplerConfig(num_steps=1, sample_num=256, num_rounds=2,
                                  num_points=64), device="cpu")
    z = np.zeros((1, 64, 64, 5), np.float32)
    out = fitter.fit_batch(z, np.zeros((1, 2)), np.zeros((1, 72)),
                           np.zeros((1, 10)), np.zeros((1, 25, 3)))
    assert out["iters"]["sil"] == cfg.iter_sil == 50
    assert len(masks) == cfg.iter_sil * cfg.steps_per_iter
    assert masks == [0.0] * len(masks)
    assert "silhouette_prep" in fitter.timer.summary()


def test_kernel_sources_and_build_dir():
    """Every kernel source exists (K1, and K2/K3 in one file); the build
    goes under _build/, which git ignores."""
    from chore_tpu_torch.ops import cuda_build

    assert cuda_build.SOURCES == {"nn_grouped": "nn_grouped.cu",
                                  "silhouette": "silhouette.cu"}
    for src in cuda_build.SOURCES.values():
        assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, src))
    assert cuda_build.BUILD_DIR == os.path.join(PKG, "_build")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "chore_tpu_torch/_build/" in f.read().split()
