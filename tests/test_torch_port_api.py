"""The whole slice through its entry point, against the JAX package:
``Reconstructor.reconstruct(use_silhouette=False)`` of ``chore_tpu`` and
of ``chore_tpu_torch`` (CPU) on the committed example frame, both loading
the same ``chore_tpu`` checkpoint, with the same draws and the fixed SO(3)
jitter (``test_torch_port_util.api_pair``); then ``save``. The sil run has
its own file (``test_torch_port_api_sil.py``): a JAX fit is the file's
budget."""
import os

import numpy as np
import pytest
import torch

from test_torch_port_util import api_pair, assert_api_outputs_match


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api")
    return (*api_pair(tmp, use_silhouette=False), tmp)


def test_reconstruct_matches_jax(pair):
    out_j, out_t, _, _ = pair
    assert_api_outputs_match(out_j, out_t)
    assert out_t["smpl_verts"].shape == (1, 6890, 3)
    assert np.isfinite(out_t["obj_verts"]).all()


def test_save_writes_plys_that_load_back(pair, tmp_path):
    from chore_tpu_torch.utils.meshio import load_ply

    _, out_t, rec, _ = pair
    dirs = rec.save(out_t, str(tmp_path / "res"))
    assert dirs == [str(tmp_path / "res" / "frame0000")]
    assert sorted(os.listdir(dirs[0])) == ["object.ply", "smpl.ply"]
    for name, vk, fk in (("smpl.ply", "smpl_verts", "smpl_faces"),
                         ("object.ply", "obj_verts", "obj_faces")):
        v, f = load_ply(os.path.join(dirs[0], name))
        np.testing.assert_array_equal(v, out_t[vk][0])
        np.testing.assert_array_equal(f, out_t[fk])


def test_overlay_raises_before_writing(pair, tmp_path):
    _, out_t, rec, _ = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rec.save(out_t, str(tmp_path / "ov"), overlay=True)
    assert not os.path.exists(tmp_path / "ov")


def test_no_card_raises(monkeypatch, tmp_path):
    """With no card and no device="cpu" the entry point raises, before it
    loads anything."""
    from chore_tpu_torch.api import Reconstructor
    from chore_tpu_torch.config import ChoreConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Reconstructor(ChoreConfig(num_stack=1), exp_root=str(tmp_path))


def test_fit_cfg_must_match_net_size(tmp_path):
    from chore_tpu_torch.api import Reconstructor
    from chore_tpu_torch.config import ChoreConfig
    from chore_tpu_torch.recon.fitter import FitConfig

    with pytest.raises(ValueError, match="net_in_size"):
        Reconstructor(ChoreConfig(net_img_size=(64, 64)),
                      fit_cfg=FitConfig(net_in_size=512), device="cpu",
                      exp_root=str(tmp_path))
