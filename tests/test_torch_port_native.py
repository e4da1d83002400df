"""The port's native geometry runtime (``chore_tpu_torch/native.py``, its own
build of ``native/chorenat.cpp``) against ``chore_tpu.native``: the BVH
distances, faces and closest points, the KD-tree, ``sample_surface`` and
the Chamfer bitwise equal on the same seeded inputs (the reference's
library built by its own Makefile, in a private copy of ``native/``); the
library lands in ``chore_tpu_torch/_build/``; two processes building into
one empty directory at once both load a whole library."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference_native(tmp_path_factory):
    """``chore_tpu.native``, its library built by its own Makefile in a
    private copy of ``native/``. Its loader runs ``make`` in the directory
    it is given; in ``native/`` itself other test processes may build at the
    same moment (one can load the library while another rewrites it)."""
    import shutil

    from chore_tpu import native

    private = tmp_path_factory.mktemp("native")
    for name in ("Makefile", "chorenat.cpp"):
        shutil.copy(os.path.join(REPO, "native", name), private)
    names = ("_NATIVE_DIR", "_SO_PATH", "_lib", "_build_failed")
    saved = [getattr(native, n) for n in names]
    for n, v in zip(names, (str(private), str(private / "libchorenat.so"),
                            None, False)):
        setattr(native, n, v)
    try:
        assert native.available(), "chore_tpu.native did not build"
        yield native
    finally:
        for n, v in zip(names, saved):
            setattr(native, n, v)


@pytest.fixture(scope="module")
def case():
    from chore_tpu_torch.utils.meshio import octasphere

    v, f = octasphere(radius=0.4, center=(0.1, -0.2, 2.2), subdiv=3)
    rng = np.random.RandomState(7)
    pts = (rng.randn(3000, 3) * 0.6 + [0, 0, 2.2]).astype(np.float32)
    return v, f, pts


def test_bvh_and_kdtree_bitwise(case, reference_native):
    from chore_tpu_torch import native as tn

    jn = reference_native
    v, f, p = case
    for a, b in zip(tn.TriangleBVH(v, f).query(p, True, True),
                    jn.TriangleBVH(v, f).query(p, True, True)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tn.PointKDTree(v).query(p), jn.PointKDTree(v).query(p)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tn.point_mesh_udf(p, v, f), jn.point_mesh_udf(p, v, f)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_surface_and_chamfer_bitwise(case, seed, reference_native):
    from chore_tpu_torch import native as tn

    jn = reference_native
    v, f, p = case
    a = tn.sample_surface(v, f, 5000, seed=seed)
    np.testing.assert_array_equal(a, jn.sample_surface(v, f, 5000,
                                                       seed=seed))
    assert tn.chamfer(a, p) == jn.chamfer(a, p)


def test_library_in_build_dir():
    from chore_tpu_torch import native

    path = native.build()
    assert os.path.dirname(path) == os.path.join(REPO, "chore_tpu_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("libchorenat_")
    assert native.available()


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Two fresh processes build into the same empty directory at once:
    both load the library and sample the same points, and only the
    published library is left (no temporary file)."""
    code = (
        "import sys, numpy as np\n"
        "from chore_tpu_torch import native\n"
        "from chore_tpu_torch.utils.meshio import octasphere\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "v, f = octasphere(0.3, subdiv=2)\n"
        "s = native.sample_surface(v, f, 1000, seed=5)\n"
        "print(native.library_path()[1], float(np.abs(s).sum()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0] == lines[1]
    assert os.listdir(tmp_path) == [os.path.basename(lines[0][0])]


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    from chore_tpu_torch import native

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="chorenat build failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not os.listdir(tmp_path / "build")
