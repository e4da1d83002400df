"""``chore_tpu_torch.tools.e2e_synthetic`` against ``tools/e2e_synthetic.py``:

* ``build_scenes`` on 2 frames from the same ``RandomState(0)``: given the
  JAX package's posed body, the npz arrays bitwise equal (both run the
  native sampler on the CPU, from one source), the JPEGs and the manifest
  byte-equal; with the port's own body (float32 vertices within a few ulps
  of XLA's) every array within 1e-5;
* ``train_field`` for 2 epochs at 1 stack and 64^2 from the JAX helper's
  init (``params_from_jax``): per-step losses within 1e-4 relative (both
  loaders give the same batches: ``test_torch_port_train_data.py`` holds
  items and order equal);

The tool end to end, its evaluation glue and ``diag_object``:
``test_torch_port_e2e_tool.py``.
"""
import os

import numpy as np
import pytest

from test_torch_port_util import (  # noqa: F401 - a fixture
    few_torch_threads,
    jax_posed_body,
    reference_tool,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

IMG, STACKS, EPOCHS = 64, 1, 2


def swap_native(mod):
    """Point a ``chore_tpu`` module's ``native`` at the port's library
    (bitwise equal, ``test_torch_port_native.py``): ``chore_tpu.native``
    runs ``make`` in ``native/``, which races across xdist workers."""
    import chore_tpu_torch.native as tnative

    mod.native = tnative


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX scenes, port scenes with the JAX body, port scenes with its
    own body): each (root, paths, gt0)."""
    import chore_tpu.preprocess.boundary_sampler as jbs

    from chore_tpu_torch.tools import e2e_synthetic

    swap_native(jbs)
    ref = reference_tool("e2e_synthetic")
    out = []
    root = str(tmp_path_factory.mktemp("jax"))
    paths, gt0, _ = ref.build_scenes(root, 2, np.random.RandomState(0))
    out.append((root, paths, gt0))
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(e2e_synthetic, "posed_body", jax_posed_body)
        root = str(tmp_path_factory.mktemp("port_jax_body"))
        paths, gt0, _ = e2e_synthetic.build_scenes(
            root, 2, np.random.RandomState(0), device="cpu")
        out.append((root, paths, gt0))
    root = str(tmp_path_factory.mktemp("port"))
    paths, gt0, _ = e2e_synthetic.build_scenes(
        root, 2, np.random.RandomState(0), device="cpu")
    out.append((root, paths, gt0))
    return out


def npz_arrays(path):
    """{key: array} of a scene npz, nested dicts flattened, the image path
    made relative to the scene root."""
    with np.load(path, allow_pickle=True) as z:
        out = {}
        for k in z.files:
            v = z[k]
            if v.dtype == object:
                for kk, a in v.item().items():
                    out[f"{k}/{kk}"] = a
            elif k == "image_file":
                out[k] = os.path.relpath(str(v), os.path.dirname(
                    os.path.dirname(path)))
            else:
                out[k] = v
    return out


def scene_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_scenes_with_the_reference_body_are_bitwise_equal(scenes):
    (jroot, jpaths, jgt0), (troot, tpaths, tgt0), _ = scenes
    assert scene_files(troot) == scene_files(jroot)
    for pj, pt in zip(jpaths, tpaths):
        a, b = npz_arrays(pj), npz_arrays(pt)
        assert sorted(a) == sorted(b)
        assert a.pop("image_file") == b.pop("image_file")
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for rel in scene_files(jroot):
        if rel.endswith((".jpg", ".json")):
            with open(os.path.join(jroot, rel), "rb") as f, \
                    open(os.path.join(troot, rel), "rb") as g:
                assert f.read() == g.read(), rel
    np.testing.assert_array_equal(tgt0["smpl"][0], jgt0["smpl"][0])
    np.testing.assert_array_equal(tgt0["obj"][0], jgt0["obj"][0])
    np.testing.assert_array_equal(tgt0["pose"], jgt0["pose"])


def test_scenes_with_its_own_body(scenes):
    """The port's body: the geometry within 1e-6, and every sampled array
    within 1e-5 but for at most 0.1% of its elements -- where a surface
    sample's face or a nearest part flips with an area or distance a few
    ulps away (``rng.choice`` over the face areas)."""
    (_, jpaths, jgt0), _, (_, tpaths, tgt0) = scenes
    np.testing.assert_allclose(tgt0["smpl"][0], jgt0["smpl"][0], rtol=0,
                               atol=1e-6)
    for pj, pt in zip(jpaths, tpaths):
        a, b = npz_arrays(pj), npz_arrays(pt)
        assert a.pop("image_file") == b.pop("image_file")
        for k in a:
            off = np.abs(b[k].astype(np.float64) - a[k]) > 1e-5
            assert off.mean() <= 1e-3, (k, int(off.sum()))


def test_build_scenes_resume_guard(scenes, tmp_path, capsys):
    """Reused npz files with the same manifest; regenerated on a change."""
    import shutil

    from chore_tpu_torch.tools import e2e_synthetic

    root = str(tmp_path / "copy")
    shutil.copytree(scenes[2][0], root)
    proc = os.path.join(root, "processed")
    stamp = {f: os.path.getmtime(os.path.join(proc, f))
             for f in os.listdir(proc) if f.endswith(".npz")}
    e2e_synthetic.build_scenes(root, 2, np.random.RandomState(0),
                               device="cpu")
    assert {f: os.path.getmtime(os.path.join(proc, f))
            for f in stamp} == stamp
    e2e_synthetic.build_scenes(root, 1, np.random.RandomState(0),
                               obj_radius=0.2, device="cpu")
    assert "regenerating 2 npz" in capsys.readouterr().out
    assert sorted(os.listdir(proc)) == ["manifest.json",
                                        "t0000_k1_scale.npz"]


def test_train_field_losses_match_the_reference(scenes, tmp_path,
                                                monkeypatch):
    import jax

    import chore_tpu.train.trainer as jtrainer
    from chore_tpu.parallel import make_mesh

    from chore_tpu_torch.models.convert import params_from_jax
    from chore_tpu_torch.tools import e2e_synthetic

    (_, paths, _), _, _ = scenes
    init = {}

    class OneDevice(jtrainer.Trainer):
        """The reference helper's Trainer on one device, its init kept."""

        def __init__(self, model, params, exp_dir, **kw):
            init["params"] = jax.device_get(params)
            super().__init__(model, params, exp_dir,
                             mesh=make_mesh(devices=jax.devices()[:1]), **kw)

    monkeypatch.setattr(jtrainer, "Trainer", OneDevice)
    ref = reference_tool("e2e_synthetic")
    _, _, _, losses_j = ref.train_field(paths, str(tmp_path / "j"), EPOCHS,
                                        num_stack=STACKS, img_size=IMG,
                                        verbose=False)
    model, cfg, losses_t = e2e_synthetic.train_field(
        paths, str(tmp_path / "t"), EPOCHS, num_stack=STACKS, img_size=IMG,
        verbose=False, device="cpu",
        state_dict=params_from_jax(jax.tree_util.tree_map(
            np.asarray, init["params"])))
    assert len(losses_t) == len(losses_j) == EPOCHS
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert (cfg.num_stack, cfg.net_img_size) == (STACKS, IMG)
    assert not model.training and not any(
        p.requires_grad for p in model.parameters())
