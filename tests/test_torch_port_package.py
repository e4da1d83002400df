"""Package-level contracts of ``chore_tpu_torch``: it imports neither JAX
nor the JAX package, its assets are byte copies of ``chore_tpu``'s, its
entry points refuse to drop silently to the CPU, and the unported
silhouette phase raises."""
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
    jax, flax, optax and chore_tpu out of sys.modules."""
    mods = _port_modules()
    assert "chore_tpu_torch.ops.nn" in mods and len(mods) > 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'chore_tpu'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


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


def test_full_f32_settings():
    from chore_tpu_torch import resolve_device

    resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_silhouette_phase_not_ported():
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere

    tv, tf = octasphere(radius=0.18, subdiv=1)
    fitter = ReconFitter(build_field(FieldConfig(num_stack=1), device="cpu"),
                         SMPLH(synthetic_smplh(), device="cpu"), tv, tf,
                         cfg=FitConfig(obj_samples=64), device="cpu")
    z = np.zeros((1, 64, 64, 5), np.float32)
    with pytest.raises(NotImplementedError, match="slice 2"):
        fitter.fit_batch(z, np.zeros((1, 2)), np.zeros((1, 72)),
                         np.zeros((1, 10)), np.zeros((1, 25, 3)))


def test_kernel_sources_and_build_dir():
    """Every kernel source exists; the build goes under _build/, which git
    ignores."""
    from chore_tpu_torch.ops import cuda_build

    for src in cuda_build.SOURCES.values():
        assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, src))
    assert cuda_build.BUILD_DIR == os.path.join(PKG, "_build")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "chore_tpu_torch/_build/" in f.read().split()
