"""The whole slice through its entry point, against the JAX package:
``Reconstructor.reconstruct(use_silhouette=False)`` of ``chore_tpu`` and
of ``chore_tpu_torch`` (CPU) on the committed example frame, both loading
the same ``chore_tpu`` checkpoint, with the same draws and the fixed SO(3)
jitter (``test_torch_port_util.api_pair``); then ``save``, whose default
overlay is held to ``chore_tpu``'s overlay of the same result. The sil run has
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
    dirs = rec.save(out_t, str(tmp_path / "res"), overlay=False)
    assert dirs == [str(tmp_path / "res" / "frame0000")]
    assert sorted(os.listdir(dirs[0])) == ["object.ply", "smpl.ply"]
    for name, vk, fk in (("smpl.ply", "smpl_verts", "smpl_faces"),
                         ("object.ply", "obj_verts", "obj_faces")):
        v, f = load_ply(os.path.join(dirs[0], name))
        np.testing.assert_array_equal(v, out_t[vk][0])
        np.testing.assert_array_equal(f, out_t[fk])


def test_save_writes_overlay_by_default(pair, tmp_path):
    """``save`` at its defaults (overlay on, render 512) writes overlay.jpg
    at the photo's size. Against ``chore_tpu``'s own overlay of the same
    result dict (its ``render_meshes`` + ``align_to_input`` with cv2 inside
    + ``cv2.imwrite``, as its ``save`` does): both files decoded by PIL are
    equal (the z-buffers' barycentrics differ by ~1e-6, which here moves
    no pixel's colour by a level); a missing photo skips the overlay, as
    ``cv2.imread``'s None does."""
    import cv2
    from PIL import Image

    from chore_tpu.utils.render import align_to_input, render_meshes

    _, out_t, rec, _ = pair
    stem = rec.save(out_t, str(tmp_path / "ov"))[0]
    assert sorted(os.listdir(stem)) == ["object.ply", "overlay.jpg",
                                        "smpl.ply"]
    got = np.array(Image.open(os.path.join(stem, "overlay.jpg")))
    photo = cv2.imread(out_t["paths"][0])
    assert got.shape == photo.shape
    meshes = [(out_t["smpl_verts"][0], out_t["smpl_faces"]),
              (out_t["obj_verts"][0], out_t["obj_faces"])]
    front, mask = render_meshes(meshes, [(0.2, 0.7, 0.3), (0.8, 0.3, 0.2)],
                                image_size=512)
    ov = align_to_input(front[..., ::-1], mask, photo, out_t["crop_info"][0],
                        use_mean_center=False, alpha=0.85)
    cv2.imwrite(str(tmp_path / "ref.jpg"), ov)
    want = np.array(Image.open(tmp_path / "ref.jpg"))
    np.testing.assert_array_equal(got, want)
    assert (got != cv2.imread(out_t["paths"][0])[..., ::-1]).any()
    missing = dict(out_t, paths=[str(tmp_path / "gone.jpg")])
    stem = rec.save(missing, str(tmp_path / "no_photo"))[0]
    assert sorted(os.listdir(stem)) == ["object.ply", "smpl.ply"]


def test_save_raises_on_a_photo_it_cannot_read(pair, tmp_path):
    """A photo that cv2 reads and the port refuses (here an arithmetic-coded
    JPEG) raises from ``save`` rather than skip the overlay, as a missing
    one does."""
    _, out_t, rec, _ = pair
    data = bytearray(open(out_t["paths"][0], "rb").read())
    data[data.index(b"\xff\xc0") + 1] = 0xC9  # SOF9: arithmetic-coded
    photo = tmp_path / "arith.jpg"
    photo.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="arithmetic-coded"):
        rec.save(dict(out_t, paths=[str(photo)]), str(tmp_path / "res"))


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
