"""The port's BEHAVE readers (``chore_tpu_torch/behave/readers.py``, no cv2
or PIL) against ``chore_tpu``'s on the synthetic sequence of
``tests/test_readers.py``: frame discovery, masks, colour and depth images,
GT fits, mocap, keypoints, calibration and ``KinectTransform`` equal;
``project_points`` against ``cv2.projectPoints`` within 1e-9 and
``undistort_image`` bitwise against ``cv2.undistort`` with every distortion
model; the 16-bit depth reader bitwise against
``cv2.IMREAD_ANYDEPTH``; ``get_seq_bkg`` and ``remove_background``."""
import numpy as np
import pytest

from test_readers import seq  # noqa: F401  (the synthetic sequence)


def _readers(seq, **kw):
    from chore_tpu.behave import readers as jr
    from chore_tpu_torch.behave import readers as tr

    return jr.FrameDataReader(seq, **kw), tr.FrameDataReader(seq, **kw)


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("check_image", [True, False])
def test_discovery_and_seq_info(seq, check_image):  # noqa: F811
    j, t = _readers(seq, check_image=check_image)
    assert t.frames == j.frames and t.kids == j.kids
    assert t.seq_name == j.seq_name and len(t) == len(j)
    assert t.seq_info.info == j.seq_info.info
    assert t.get_color_files(0, [0, 1]) == j.get_color_files(0, [0, 1])
    assert t.cvt_end(None) == j.cvt_end(None) and t.cvt_end(99) == len(j)


def test_masks_images_fits_mocap_kpts(seq):  # noqa: F811
    j, t = _readers(seq)
    for kid in (0, 1):
        for cat in ("person", "obj"):
            _equal(j.get_mask(0, kid, cat), t.get_mask(0, kid, cat))
            _equal(j.get_mask(1, kid, cat, ret_bool=False),
                   t.get_mask(1, kid, cat, ret_bool=False))
        _equal(j.get_mask_full(0, kid), t.get_mask_full(0, kid))
        _equal(j.get_body_kpts(0, kid), t.get_body_kpts(0, kid))
        _equal(j.get_body_kpts(0, kid, tol=0.95),
               t.get_body_kpts(0, kid, tol=0.95))
        _equal(j.get_mocap_params(0, kid), t.get_mocap_params(0, kid))
        _equal(j.get_mocap_mesh(0, kid), t.get_mocap_mesh(0, kid))
    _equal(j.get_color_images(0, [0, 1]), t.get_color_images(0, [0, 1]))
    depths = t.get_depth_images(0, [0, 1])
    assert depths[0].dtype == np.uint16
    _equal(j.get_depth_images(0, [0, 1]), depths)
    _equal(j.get_smplfit(0, "fit02"), t.get_smplfit(0, "fit02"))
    _equal(j.get_objfit(1, "fit01"), t.get_objfit(1, "fit01"))
    assert t.get_smplfit(0, None) is None and t.get_objfit(0, None) is None
    assert t.objfit_meshfile(0, "fit01") == j.objfit_meshfile(0, "fit01")
    _equal(j.get_objfit_params(0, "fit01"), t.get_objfit_params(0, "fit01"))
    _equal(j.get_objfit_params(0, "nofit"), t.get_objfit_params(0, "nofit"))


def test_kinect_transform_and_calib(seq):  # noqa: F811
    from chore_tpu.behave import readers as jr
    from chore_tpu_torch.behave import readers as tr

    j, t = jr.KinectTransform(seq), tr.KinectTransform(seq)
    rng = np.random.RandomState(0)
    pts = rng.randn(200, 3) * 0.3 + [0, 0, 2.0]
    for k in (0, 1):
        _equal(j.world2local(pts, k), t.world2local(pts, k))
        _equal(j.local2world(pts, k), t.local2world(pts, k))
        _equal(j.world2color_verts(pts, k), t.world2color_verts(pts, k))
        np.testing.assert_allclose(t.project2color(pts, k),
                                   j.project2color(pts, k), atol=1e-9)
    _equal(jr.KinectTransform.flip_verts(pts), tr.KinectTransform.flip_verts(
        pts))
    cj, ct = j.intrinsics[0], t.intrinsics[0]
    for name in ("calibration_matrix", "dist_coeffs", "pc_table_ext",
                 "depth2color_R", "depth2color_t"):
        _equal(getattr(cj, name), getattr(ct, name))
    for c in (cj, ct):  # a non-trivial depth -> colour offset
        c.depth2color_t = np.array([0.05, 0.0, 0.0])
    depth = np.zeros((48, 64), np.uint16)
    depth[10:40:3, 10:60:3] = 2000
    pc, mask = ct.dmap2pc(depth, return_mask=True)
    _equal(cj.dmap2pc(depth, return_mask=True), (pc, mask))
    np.testing.assert_allclose(ct.pc2color(pc), cj.pc2color(pc), atol=1e-9)
    pix = ct.pc2color(pc)
    np.testing.assert_allclose(ct.color_to_pc(pix, pc, k=3),
                               cj.color_to_pc(pix, pc, k=3), atol=1e-9)
    _equal(cj.pc2color_valid(pc), ct.pc2color_valid(pc))
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    np.testing.assert_allclose(ct.get_pc_colors(pc, img),
                               cj.get_pc_colors(pc, img), atol=1e-9)
    np.testing.assert_allclose(ct.pc2dmap(pc), cj.pc2dmap(pc), atol=1e-9)
    _equal(cj.dmap2colorpc(img, depth), ct.dmap2colorpc(img, depth))
    holes = np.full((8, 8), 2.0)
    holes[3, 3] = holes[5, 6] = 0.0
    _equal(cj.interpolate_depth(holes), ct.interpolate_depth(holes))
    _equal(cj.undistort(img), ct.undistort(img))


@pytest.mark.parametrize("n", [0, 4, 5, 8, 12, 14])
def test_project_points_against_opencv(n):
    import cv2

    from chore_tpu_torch.behave.readers import project_points

    rng = np.random.RandomState(n)
    cam = np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
    pts = rng.randn(500, 3) * [0.5, 0.4, 0.3] + [0, 0, 2.0]
    dist = rng.randn(n) * 0.05
    want = cv2.projectPoints(pts[..., None], np.zeros(3), np.zeros(3), cam,
                             dist if n else None)[0].reshape(-1, 2)
    np.testing.assert_allclose(project_points(pts, cam, dist), want,
                               atol=1e-9, rtol=0)


@pytest.mark.parametrize("n", [4, 5, 8, 12, 14])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_undistort_against_opencv(n, dtype):
    """``cv2.undistort`` of a smooth 2,048 x 1,536 colour image with a
    Kinect-like camera and each distortion model: bitwise equal (the maps
    in OpenCV's 1/32 pixel, the 8-bit sums in its 15-bit fixed point). A
    source position within float64 noise of a 1/64-pixel boundary could
    round the other way and move its pixel by one 1/32 step; none did."""
    import cv2

    from chore_tpu_torch.behave.readers import undistort_image

    K = np.array([[979.78, 0, 1018.95], [0, 979.84, 779.49], [0, 0, 1.0]])
    dist = np.array([0.5, -2.6, 7e-4, -3e-4, 1.5, 0.38, -2.4, 1.4, 1e-3,
                     -5e-4, 8e-4, -2e-4, 0.01, -0.02])[:n]
    rng = np.random.RandomState(n)
    img = cv2.GaussianBlur((rng.rand(1536, 2048, 3) * 255).astype(np.uint8),
                           (0, 0), 3)
    if dtype == "float32":
        img = img.astype(np.float32) / 255
    got = undistort_image(img, K, dist)
    want = cv2.undistort(img, K, dist)
    assert got.dtype == want.dtype and (want == 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray16", "rgb16", "gray8", "rgb8",
                                  "jpeg"])
def test_depth_reader_bitwise_against_opencv(tmp_path, kind):
    import cv2

    from chore_tpu_torch.data.imageio import imwrite, read_depth

    rng = np.random.RandomState(1)
    dt = np.uint16 if kind.endswith("16") else np.uint8
    shape = (37, 53) if kind.startswith("gray") else (37, 53, 3)
    img = rng.randint(0, np.iinfo(dt).max + 1, shape).astype(dt)
    path = str(tmp_path / ("d.jpg" if kind == "jpeg" else "d.png"))
    cv2.imwrite(path, img)
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    got = read_depth(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if kind != "jpeg":  # the port's writer: what cv2 reads back
        mine = str(tmp_path / "m.png")
        imwrite(mine, img)
        np.testing.assert_array_equal(cv2.imread(mine, cv2.IMREAD_UNCHANGED),
                                      img)
        np.testing.assert_array_equal(read_depth(mine), want)


def test_background_and_empty_room(seq, tmp_path):  # noqa: F811
    import cv2

    from chore_tpu.behave import readers as jr
    from chore_tpu_torch.behave import readers as tr

    empty = tmp_path / "empty"
    rng = np.random.RandomState(2)
    for t in ("t0001.000", "t0002.000", "t0003.000"):
        (empty / t).mkdir(parents=True)
        for k in range(2 if t != "t0003.000" else 1):  # k1 misses a frame
            cv2.imwrite(str(empty / t / f"k{k}.depth.png"),
                        rng.randint(2900, 3100, (48, 64)).astype(np.uint16))
    for kid in (0, 1):
        _equal(jr.get_seq_bkg(str(empty), kid), tr.get_seq_bkg(str(empty),
                                                               kid))
    bkg = tr.get_seq_bkg(str(empty), 0)
    depth = np.full((48, 64), 3000, np.uint16)
    depth[10:20, 10:20] = 2200
    _equal(jr.remove_background(depth.copy(), bkg),
           tr.remove_background(depth.copy(), bkg))
    _equal(jr.KinectFrameReader(seq, kinect_count=2,
                                empty=str(empty)).prepare_bkgs(),
           tr.KinectFrameReader(seq, kinect_count=2,
                                empty=str(empty)).prepare_bkgs())
    assert tr.KinectFrameReader(seq, kinect_count=2).prepare_bkgs() is None
