"""The port's ``utils/textures.py`` against ``chore_tpu``'s, case by case
as ``tests/test_textures.py`` drives the JAX package: OBJ + MTL + PNG
loading (the atlas read as cv2 reads it) and the save/load round trip
(PNG written by the port's encoder), per-face texture patches (a 1-pixel
texture too), the atlas packing round trip, lighting, and the textured
render. Bounds: parsed arrays and lighting equal; sampled colours within
1e-5 (bilinear lookups: ``F.grid_sample`` against the JAX package's
corner gathers); renders within 1e-5 where the face maps are equal."""
import os

import numpy as np
import pytest

from chore_tpu.utils import textures as J
from chore_tpu_torch.utils import textures as T

TOL = 1e-5


@pytest.fixture
def quad_obj(tmp_path):
    """Unit quad in the z=2 plane, textured left-half red / right-half
    green, written as OBJ + MTL + png (cv2's PNG writer)."""
    import cv2

    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4] = [1, 0, 0]
    tex[:, 4:] = [0, 1, 0]
    tex[2:5, 1:3] = [0.2, 0.4, 0.9]
    cv2.imwrite(str(tmp_path / "quad.png"),
                (tex[..., ::-1] * 255).astype(np.uint8))
    (tmp_path / "quad.mtl").write_text(
        "newmtl material_1\nmap_Kd quad.png\n")
    (tmp_path / "quad.obj").write_text("\n".join([
        "mtllib quad.mtl",
        "v -0.5 -0.5 2", "v 0.5 -0.5 2", "v 0.5 0.5 2", "v -0.5 0.5 2",
        "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
        "usemtl material_1",
        "f 1/1 2/2 3/3 4/4",  # quad -> fan-triangulated
    ]) + "\n")
    return str(tmp_path / "quad.obj")


def _assert_mesh_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_load_matches(quad_obj):
    m = T.load_obj_textured(quad_obj)
    _assert_mesh_equal(J.load_obj_textured(quad_obj), m)
    assert m["faces"].shape == (2, 3) and m["texture"].shape == (8, 8, 3)
    np.testing.assert_allclose(m["uv_faces"][0, 0], [0, 1], atol=1e-6)


@pytest.mark.parametrize("atlas", ["arithmetic.jpg", "atlas.bmp"])
def test_load_refused_atlas_raises(quad_obj, atlas):
    """An atlas that cv2 reads and the port does not (an arithmetic-coded
    JPEG, a BMP) raises rather than leave the mesh untextured (a missing
    atlas does that, as ``cv2.imread``'s None does: the next test)."""
    import cv2

    folder = os.path.dirname(quad_obj)
    path = os.path.join(folder, atlas)
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    if atlas.endswith(".jpg"):
        with open(path, "r+b") as f:
            f.seek(f.read().index(b"\xff\xc0") + 1)
            f.write(b"\xc9")  # SOF9: arithmetic-coded
    with open(os.path.join(folder, "quad.mtl"), "w") as f:
        f.write(f"newmtl material_1\nmap_Kd {atlas}\n")
    with pytest.raises(ValueError, match="arithmetic|BMP"):
        T.load_obj_textured(quad_obj)


def test_load_without_texture_file(quad_obj):
    os.remove(os.path.join(os.path.dirname(quad_obj), "quad.png"))
    m = T.load_obj_textured(quad_obj)
    _assert_mesh_equal(J.load_obj_textured(quad_obj), m)
    assert m["texture"] is None and m["uv_faces"] is not None


def test_save_load_roundtrip(quad_obj, tmp_path):
    """The port writes OBJ + MTL + PNG; the JAX package loads it to the
    same arrays the port does, and both match the source within 1/255."""
    m = T.load_obj_textured(quad_obj)
    out = str(tmp_path / "rt" / "mesh.obj")
    os.makedirs(os.path.dirname(out))
    T.save_obj_textured(out, m["verts"], m["faces"], m["uv_faces"],
                        m["texture"])
    m2 = T.load_obj_textured(out)
    _assert_mesh_equal(J.load_obj_textured(out), m2)
    np.testing.assert_allclose(m2["verts"], m["verts"], atol=1e-6)
    np.testing.assert_array_equal(m2["faces"], m["faces"])
    np.testing.assert_allclose(m2["uv_faces"], m["uv_faces"], atol=1e-6)
    np.testing.assert_allclose(m2["texture"], m["texture"], atol=1.0 / 255)
    out_j = str(tmp_path / "rt" / "mesh_j.obj")
    J.save_obj_textured(out_j, m["verts"], m["faces"], m["uv_faces"],
                        m["texture"])
    with open(out) as a, open(out_j) as b:
        assert a.read().replace("mesh.mtl", "mesh_j.mtl") == b.read()


def test_save_untextured_matches(tmp_path):
    v = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    f = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    T.save_obj_textured(str(tmp_path / "t.obj"), v, f)
    J.save_obj_textured(str(tmp_path / "j.obj"), v, f)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


@pytest.mark.parametrize("ts", [1, 4, 8])
def test_sample_face_textures_matches(quad_obj, ts):
    m = T.load_obj_textured(quad_obj)
    want = np.asarray(J.sample_face_textures(m["texture"], m["uv_faces"],
                                             texture_size=ts))
    got = T.sample_face_textures(m["texture"], m["uv_faces"],
                                 texture_size=ts, device="cpu").numpy()
    assert got.shape == want.shape == (2, ts, ts, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_degenerate_1px_texture():
    """1-pixel-wide/tall textures must not NaN (division by W-1=0)."""
    uv_faces = np.array([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]], np.float32)
    for shape in ((1, 1, 3), (1, 5, 3), (5, 1, 3)):
        tex = np.random.RandomState(1).rand(*shape).astype(np.float32)
        got = T.sample_face_textures(tex, uv_faces, texture_size=3,
                                     device="cpu").numpy()
        want = np.asarray(J.sample_face_textures(tex, uv_faces,
                                                 texture_size=3))
        assert np.isfinite(got).all(), shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_atlas_roundtrip():
    rng = np.random.RandomState(0)
    ts, F = 6, 5
    face_tex = rng.rand(F, ts, ts, 3).astype(np.float32)
    atlas, uv = T.atlas_from_face_textures(face_tex)
    atlas_j, uv_j = J.atlas_from_face_textures(face_tex)
    np.testing.assert_array_equal(atlas, atlas_j)
    np.testing.assert_array_equal(uv, uv_j)
    back = T.sample_face_textures(atlas, uv, ts, device="cpu").numpy()
    i, j = np.meshgrid(np.arange(ts), np.arange(ts), indexing="ij")
    tri = (i + j) <= (ts - 1)
    np.testing.assert_allclose(back[:, tri], face_tex[:, tri], atol=1e-5)
    for k in (1, 3, 8):
        np.testing.assert_array_equal(T._lattice(k)[0], J._lattice(k)[0])
        np.testing.assert_array_equal(T._lattice(k)[1], J._lattice(k)[1])


def test_sample_uv_colors_matches():
    rng = np.random.RandomState(2)
    tex = rng.rand(9, 13, 3).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (4, 7, 2)).astype(np.float32)
    got = T.sample_uv_colors(tex, uv)
    assert got.shape == (4, 7, 3)
    np.testing.assert_allclose(got, J.sample_uv_colors(tex, uv), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("two_sided", [False, True])
def test_lighting_and_normals(two_sided):
    rng = np.random.RandomState(3)
    v = rng.randn(30, 3).astype(np.float32)
    f = rng.randint(0, 30, (40, 3))
    n = T.face_normals(v, f)
    np.testing.assert_array_equal(n, J.face_normals(v, f))
    np.testing.assert_array_equal(
        T.lighting(n, (0.3, -0.5, -0.8), 0.3, 0.7, two_sided),
        J.lighting(n, (0.3, -0.5, -0.8), 0.3, 0.7, two_sided))


def test_render_textured_matches(quad_obj):
    m = T.load_obj_textured(quad_obj)
    K = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)
    want, wmask = J.render_textured(m["verts"], m["faces"], m["uv_faces"],
                                    m["texture"], K, image_size=64)
    got, gmask = T.render_textured(m["verts"], m["faces"], m["uv_faces"],
                                   m["texture"], K, image_size=64,
                                   device="cpu")
    np.testing.assert_array_equal(gmask, wmask)
    assert 0.15 < gmask.mean() < 0.35
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
