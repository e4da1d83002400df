"""The port's ``utils/marching.py`` against ``chore_tpu``'s (the same numpy
code): grids, chunked evaluation, marching tetrahedra and the coarse-to-
fine reconstruction give bitwise equal arrays. Then ``cli.demo``'s
``extract_field_meshes`` of a small field loaded from one ``chore_tpu``
checkpoint into both packages: the same face count, each triangle's
vertices within 1e-4."""
import numpy as np
import pytest

from chore_tpu.utils import marching as J
from chore_tpu_torch.utils import marching as T


def sphere_sdf(points, c=(0.1, -0.05, 0.0), r=0.6):
    return np.linalg.norm(points - np.asarray(c), axis=-1) - r


def _equal(a, b):
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("res", [2, 16, 33])
def test_create_grid_and_batch_eval(res):
    bmin, bmax = [-1, -0.5, 1.7], [1, 1.2, 2.7]
    pj, aj = J.create_grid(res, bmin, bmax)
    pt, at = T.create_grid(res, bmin, bmax)
    _equal((pj, *aj), (pt, *at))
    _equal([J.batch_eval(pj, sphere_sdf, chunk=100)],
           [T.batch_eval(pt, sphere_sdf, chunk=100)])


@pytest.mark.parametrize("level", [0.0, 0.17])
def test_marching_tetrahedra_bitwise(level):
    rng = np.random.RandomState(0)
    pts, _ = J.create_grid(32, [-1, -1, -1], [1, 1, 1])
    vals = (sphere_sdf(pts) + 0.02 * rng.randn(len(pts))).reshape(32, 32, 32)
    vj, fj = J.marching_tetrahedra(vals, [-1, -1, -1], [1, 1, 1], level)
    vt, ft = T.marching_tetrahedra(vals, [-1, -1, -1], [1, 1, 1], level)
    assert len(fj) > 500
    _equal((vj, fj), (vt, ft))


def test_tet_triangles_every_case():
    """Each of the 16 inside/outside codes of a tetrahedron."""
    rng = np.random.RandomState(1)
    codes = np.arange(16)
    v = np.where((codes[:, None] >> np.arange(4)) & 1, -1.0, 1.0)
    v = v + 0.1 * rng.rand(16, 4)
    p = rng.rand(16, 4, 3)
    _equal([J._tet_triangles(p, v, 0.0)], [T._tet_triangles(p, v, 0.0)])


def test_empty_grid():
    vals = np.ones((8, 8, 8))
    _equal(J.marching_tetrahedra(vals, [-1] * 3, [1] * 3, 0.0),
           T.marching_tetrahedra(vals, [-1] * 3, [1] * 3, 0.0))


@pytest.mark.parametrize("stride,band", [(1, None), (4, 0.3), (4, None)])
def test_reconstruction_bitwise(stride, band):
    kw = dict(level=0.0, coarse_stride=stride, band=band, chunk=5000)
    lo, hi = np.full(3, -1.0, np.float32), np.ones(3, np.float32)
    vj, fj = J.reconstruction(sphere_sdf, 40, lo, hi, **kw)
    vt, ft = T.reconstruction(sphere_sdf, 40, lo, hi, **kw)
    _equal((vj, fj), (vt, ft))
    assert abs(np.linalg.norm(vt - [0.1, -0.05, 0.0], axis=1).mean()
               - 0.6) < 0.01


def test_extract_field_meshes_matches(tmp_path):
    """Both demos' field meshes of one small field (2 stacks, 64^2 input,
    the weights of a ``chore_tpu`` checkpoint), res 20 at level 0.3."""
    import jax.numpy as jnp

    from chore_tpu.cli.demo import extract_field_meshes as jextract
    from chore_tpu.recon.fitter import FitConfig as JFit
    from chore_tpu.recon.fitter import ReconFitter as JFitter
    from chore_tpu.smpl import SMPLH as JSMPLH
    from chore_tpu.smpl import synthetic_smplh as jsynth
    from chore_tpu_torch.cli.common import load_trained
    from chore_tpu_torch.cli.demo import extract_field_meshes as textract
    from chore_tpu_torch.config import ChoreConfig
    from chore_tpu_torch.recon.fitter import FitConfig as TFit
    from chore_tpu_torch.recon.fitter import ReconFitter as TFitter
    from chore_tpu_torch.smpl import SMPLH as TSMPLH
    from chore_tpu_torch.smpl import synthetic_smplh as tsynth
    from chore_tpu_torch.utils.meshio import octasphere
    from test_torch_port_util import jax_field, write_jax_checkpoint

    write_jax_checkpoint(tmp_path, "small")
    model_j, params_j = jax_field()
    model_t = load_trained(ChoreConfig(exp_name="small", num_stack=2),
                           exp_root=str(tmp_path), device="cpu")
    tv, tf = octasphere(radius=0.15, subdiv=1)
    fj = JFitter(model_j, params_j, JSMPLH(jsynth()), tv, tf,
                 cfg=JFit(net_in_size=64, obj_samples=64))
    ft = TFitter(model_t, TSMPLH(tsynth(), device="cpu"), tv, tf,
                 cfg=TFit(net_in_size=64, obj_samples=64), device="cpu")
    rng = np.random.RandomState(0)
    images = rng.rand(1, 64, 64, 5).astype(np.float32)
    cc = np.array([[1018.0, 779.0]], np.float32)
    kw = dict(res=20, level=0.3)
    out_j = jextract(fj, jnp.asarray(images), cc, **kw)
    out_t = textract(ft, images, cc, **kw)
    assert set(out_t) == set(out_j) == {"human", "object"}
    for name in ("human", "object"):
        (vj, fj_), (vt, ft_) = out_j[name], out_t[name]
        assert len(ft_) == len(fj_) > 0, name
        # triangle by triangle: the vertex lists may differ in length, as
        # the deduplication rounds positions that differ by f32 noise to
        # one lattice key or to two
        np.testing.assert_allclose(vt[ft_], vj[fj_], atol=1e-4, rtol=0,
                                   err_msg=name)
