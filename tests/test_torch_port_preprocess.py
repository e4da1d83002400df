"""The port's GT preprocessing (``ops/point_mesh.py``,
``preprocess/boundary_sampler.py``, ``preprocess/preprocess_scale.py``,
``cli/preprocess.py``) against ``chore_tpu``'s on the CPU.

Bounds: ``point_mesh_udf`` within 1e-6 of JAX's UDF; nearest-vertex labels
equal except where the best two vertex distances lie within NN_DIST_TOL
(5e-5, the 1-NN kernel's rule: the two packages expand the distance in
different orders). ``BoundarySampler`` at one seed: points bitwise equal
(the same ``np.random.RandomState`` stream), UDFs within 1e-5 m, labels
equal except near-ties, for the native and the device backend.
``process_scale_seq`` writes the same npz files, keys and layout as
``chore_tpu``'s. The JAX side's native backend runs the port's native
library, which ``test_torch_port_native.py`` holds bitwise equal to
``chore_tpu.native`` (whose ``make`` on ``native/`` races across test
processes).
"""
import os

import numpy as np
import pytest
import torch

from test_readers import seq  # noqa: F401  (the synthetic sequence)

UDF_TOL = 1e-6
SAMPLER_UDF_TOL = 1e-5
NN_DIST_TOL = 5e-5


def _near_tie(points, verts):
    """(N,) bool: the best two squared vertex distances within NN_DIST_TOL
    (float64)."""
    d = ((points[:, None, :].astype(np.float64)
          - verts[None].astype(np.float64)) ** 2).sum(-1)
    two = np.partition(d, 1, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= NN_DIST_TOL


def _assert_labels(got, want, points, verts):
    differ = np.asarray(got) != np.asarray(want)
    if differ.any():
        assert _near_tie(points[differ], verts).all()


@pytest.fixture(scope="module")
def scene():
    """A sphere 'body' padded to SMPL's 6,890 vertices with far-away dummy
    vertices (never nearest), and a sphere object beside it."""
    from chore_tpu_torch.utils.meshio import octasphere

    sv, sf = octasphere(radius=0.5, center=(0, 0, 2.2), subdiv=3)
    ov, of = octasphere(radius=0.2, center=(0.8, 0, 2.2), subdiv=3)
    dummy = np.full((6890 - len(sv), 3), 50.0, np.float32)
    return np.concatenate([sv, dummy], 0), sf, ov, of


def test_point_mesh_udf_matches_jax(scene):
    import jax.numpy as jnp

    from chore_tpu.ops.point_mesh import point_mesh_udf as judf
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops.point_mesh import point_mesh_udf

    use_full_f32()
    sv, sf, _, _ = scene
    rng = np.random.RandomState(4)
    pts = (rng.randn(1500, 3) * 0.5 + [0, 0, 2.2]).astype(np.float32)
    dj, ij = judf(jnp.asarray(pts), jnp.asarray(sv), jnp.asarray(sf))
    for tile in (None, 700):  # the tile changes no result
        dt, it = point_mesh_udf(torch.from_numpy(pts), torch.from_numpy(sv),
                                torch.from_numpy(sf), tile=tile)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=UDF_TOL,
                                   rtol=0)
        assert it.dtype == torch.int64
        _assert_labels(it.numpy(), np.asarray(ij), pts, sv)


@pytest.fixture()
def jax_native(monkeypatch):
    import chore_tpu.preprocess.boundary_sampler as jbs
    from chore_tpu_torch import native

    monkeypatch.setattr(jbs, "native", native)


@pytest.mark.parametrize("backend", ["native", "device"])
def test_boundary_sampler_matches_jax(scene, jax_native, backend):
    from chore_tpu.preprocess import BoundarySampler as JSampler
    from chore_tpu_torch.preprocess import BoundarySampler, flip_part_labels

    sv, sf, ov, of = scene
    # equal counts per sigma: one shape, so JAX compiles once per mesh
    kw = dict(sigmas=[0.08, 0.02], ratios=[0.5, 0.5], sample_num=2000,
              min_samples=500, grid_ratio=0.05)
    want = JSampler(seed=3, backend=backend).boundary_sample_all(
        sv, sf, ov, of, flip=True, **kw)
    sampler = BoundarySampler(seed=3, backend=backend, device="cpu")
    assert sampler.backend == backend
    got = sampler.boundary_sample_all(sv, sf, ov, of, flip=True, **kw)
    assert sorted(got) == sorted(want)
    for key in ("sigma0.08", "sigma0.02"):
        pts = got["points"][key]
        np.testing.assert_array_equal(pts, want["points"][key])
        for name in ("dist_h", "dist_o"):
            assert got[name][key].dtype == np.float32
            np.testing.assert_allclose(got[name][key], want[name][key],
                                       atol=SAMPLER_UDF_TOL, rtol=0)
        assert got["parts"][key].dtype == np.uint8
        differ = got["parts"][key] != want["parts"][key]
        if differ.any():  # near-ties only: a label follows its vertex
            assert _near_tie(pts[differ], sv).all()
        assert set(np.unique(flip_part_labels(got["parts"][key]))) <= set(
            range(14))
    for name in ("pca_axis", "smpl_center", "body_kpts", "obj_center"):
        np.testing.assert_array_equal(got[name], want[name])


def test_backends_and_errors():
    """"auto" follows the device: the dense device backend on the card,
    the native BVH on the CPU (choosing touches no card)."""
    from chore_tpu_torch.preprocess import BoundarySampler

    auto = BoundarySampler(backend="auto", device="cpu")
    assert (auto.backend, auto.device) == ("native", None)
    auto = BoundarySampler(backend="auto", device="cuda")
    assert (auto.backend, auto.device.type) == ("device", "cuda")
    assert BoundarySampler(backend="device", device="cpu").device.type == \
        "cpu"
    if not torch.cuda.is_available():  # no card: the default device raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BoundarySampler(backend="auto")
    with pytest.raises(ValueError, match="backend"):
        BoundarySampler(backend="gpu")


def _body_sequence(seq_dir):
    """Replace the fixture's sphere person fits with the synthetic SMPL-H
    body, pelvis at z = 2.0 (so the depth scaling is 1.1)."""
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.smpl.model import init_params
    from chore_tpu_torch.utils.meshio import save_ply

    smplh = SMPLH(synthetic_smplh(), device="cpu")
    sp = init_params(torch.zeros(1, 72), torch.zeros(1, 10),
                     torch.zeros(1, 3), device="cpu")
    sv = smplh.verts(sp)[0].numpy()
    pelvis = smplh.pelvis(sp)[0].numpy()
    sv = sv + (np.array([0, 0, 2.0]) - pelvis)
    for t in ("t0001.000", "t0002.000", "t0003.000"):
        f = os.path.join(seq_dir, t, "person", "fit02", "person_fit.ply")
        save_ply(f, sv, smplh.faces)


def test_process_scale_seq_matches_jax(seq, tmp_path,  # noqa: F811
                                       monkeypatch):
    import chore_tpu.preprocess.boundary_sampler as jbs
    from chore_tpu.preprocess import process_scale_seq as jprocess
    from chore_tpu_torch import native
    from chore_tpu_torch.cli.preprocess import main
    from chore_tpu_torch.preprocess import process_scale_seq

    _body_sequence(seq)
    monkeypatch.setattr(jbs, "native", native)
    kw = dict(sample_num=2000, kids=[1])
    out_j = jprocess(seq, str(tmp_path / "j"), **kw)
    out_t = process_scale_seq(seq, str(tmp_path / "t"), backend="native",
                              **kw)
    rel = lambda fs, root: [  # noqa: E731
        os.path.relpath(f, root) for f in fs]
    assert rel(out_t, tmp_path / "t") == rel(out_j, tmp_path / "j")
    assert len(out_t) == 2  # the two complete frames (discovery drops t0003)
    for fj, ft in zip(out_j, out_t):
        dj, dt = np.load(fj, allow_pickle=True), np.load(ft, allow_pickle=True)
        assert sorted(dt.files) == sorted(dj.files)
        for k in dj.files:
            a, b = dj[k], dt[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == object:  # the per-sigma dicts
                a, b = a.item(), b.item()
                assert sorted(a) == sorted(b)
                for s in a:
                    assert a[s].dtype == b[s].dtype
                    np.testing.assert_array_equal(b[s], a[s])
            else:
                np.testing.assert_array_equal(b, a)
        assert abs(float(dt["smpl_center"][2]) - 2.2) < 1e-4
    # the is-done skip, then the CLI on one frame and kinect
    assert process_scale_seq(seq, str(tmp_path / "t"), device="cpu",
                             **kw) == out_t
    written = main(["-s", seq, "-o", str(tmp_path / "cli"), "--sample_num",
                    "300", "-fe", "1", "-k", "1", "--device", "cpu"])
    files = written[seq]
    assert len(files) == 1 and files[0].endswith("t0001.000_k1_scale.npz")
    assert rel(files, tmp_path / "cli") == [rel(out_t, tmp_path / "t")[0]]
