"""The port's evaluator (``recon/evaluate.py``, ``ops.chamfer.chamfer_eval``,
``cli/evaluate.py``) against ``chore_tpu``'s on the CPU.

The sequence is ``tests/test_preprocess_eval.py``'s fake reconstruction
tree (GT = two spheres, the reconstruction a scaled and moved copy) grown
by three frames: one gated out by occlusion, one whose object has another
vertex count (the SMPL-only alignment), one with no reconstruction. Both
evaluators must keep the same frames and write the same JSON keys. Each
per-frame error of the port must lie within 1e-4 relative of JAX's and
within 1e-5 relative of a float64 oracle (cKDTree Chamfer after a float64
Procrustes of the same samples). The port moves each Chamfer pair to the
first cloud's centroid before the 1-NN (``ops.chamfer.chamfer_eval_multi``):
at z ~ 2.2 the f32 expansion |x|^2 - 2x.y + |y|^2 picks farther neighbours,
which puts JAX's jitted CPU evaluator 1.3e-3 relative off the oracle on
t0003's object. So JAX's evaluator is run with the same centring put in
front of its ``chamfer_eval``; the rest of its arithmetic (f32 Procrustes,
the expansion's distances) is its own: measured 7.8e-6 relative from the
port at most. The JAX evaluator samples through
the port's native library, which ``test_torch_port_native.py`` holds
bitwise equal to ``chore_tpu.native``.

``chamfer_eval`` alone (10k points 5 mm about a 0.5 m sphere at z = 2.2
against 8k of them moved 1 cm): measured 5.5e-8 relative off the float64
brute force for the port (centred, re-expressed distance), 1.2e-5 for
JAX's CPU expansion, 1.2e-5 between the two; the bounds are 1e-5 against
the oracle and 1e-4 against JAX.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from test_preprocess_eval import _make_fake_recon_tree

JAX_REL = 1e-4
ORACLE_REL = 1e-5
SAMPLES = 2000
SEQ = "Date01_Sub01_basketball"


def _mask(path, frac):
    import cv2

    m = np.zeros((100, 100), np.uint8)
    m[10:10 + int(80 * frac), 10:90] = 255
    cv2.imwrite(path, m)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(seq dir, recon dir) with four frames, t0003-t0006."""
    from chore_tpu_torch.utils.meshio import octasphere, save_ply

    tmp = tmp_path_factory.mktemp("eval")
    seq, recon = _make_fake_recon_tree(
        tmp, offset=np.array([0.5, -0.3, 1.0]), scale=1.3)
    sv, sf = octasphere(radius=0.5, center=(0, 0.2, 2.2), subdiv=3)
    ov, of = octasphere(radius=0.2, center=(0.7, 0, 2.2), subdiv=3)
    ov2, of2 = octasphere(radius=0.2, center=(0.7, 0, 2.2), subdiv=2)
    rng = np.random.RandomState(0)
    for frame, vis, rec_obj in (("t0004.000", 0.2, (ov, of)),
                                ("t0005.000", 1.0, (ov2, of2)),
                                ("t0006.000", 1.0, None)):
        f = os.path.join(seq, frame)
        for sub, name, (v, fc) in (("person/fit02", "person_fit.ply",
                                    (sv, sf)),
                                   ("basketball/fit01", "basketball_fit.ply",
                                    (ov, of))):
            os.makedirs(os.path.join(f, sub))
            save_ply(os.path.join(f, sub, name), v, fc)
        _mask(os.path.join(f, "k1.obj_rend_mask.jpg"), vis)
        _mask(os.path.join(f, "k1.obj_rend_full.jpg"), 1.0)
        if rec_obj is None:
            continue
        out = os.path.join(recon, SEQ, frame, "test-sn")
        os.makedirs(out)
        noise = lambda v: v + 0.002 * rng.randn(*v.shape)  # noqa: E731
        save_ply(os.path.join(out, "k1.smpl.ply"),
                 noise(sv) * 0.9 + [0.1, 0.0, -0.2], sf)
        save_ply(os.path.join(out, "k1.object.ply"),
                 noise(rec_obj[0]) * 0.9 + [0.1, 0.0, -0.2], rec_obj[1])
    return seq, recon


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items() if k != "time"}


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    import chore_tpu.recon.evaluate as jev
    from chore_tpu_torch import native
    from chore_tpu_torch.recon.evaluate import ReconEvaluator

    seq, recon = tree
    out = tmp_path_factory.mktemp("results")
    def centred(x, y):  # the port's centring, then JAX's own Chamfer
        c = x.mean(axis=0)
        return jev.chamfer_eval(x - c, y - c)

    # a new function object, so jit traces it afresh (a trace of the
    # module's own ``_aligned_chamfer`` at these shapes may be cached)
    aligned = types.FunctionType(
        jev._aligned_chamfer.__code__,
        dict(jev._aligned_chamfer.__globals__, chamfer_eval=centred))
    saved = jev.native, jev._aligned_chamfer
    jev.native, jev._aligned_chamfer = native, aligned
    try:
        j = jev.ReconEvaluator(recon, os.path.dirname(seq),
                               sample_num=SAMPLES, outdir=str(out / "j"))
        res_j = j.eval_seqs([seq], "test-sn", tid=1)
    finally:
        jev.native, jev._aligned_chamfer = saved
    t = ReconEvaluator(recon, os.path.dirname(seq), sample_num=SAMPLES,
                       outdir=str(out / "t"), device="cpu")
    res_t = t.eval_seqs([seq], "test-sn", tid=1)
    return j, res_j, t, res_t, out


@pytest.fixture(scope="module")
def oracle(tree):
    """Float64 per-frame errors of the two evaluated frames: the same
    native samples, a float64 Procrustes, a cKDTree Chamfer."""
    from scipy.spatial import cKDTree

    from chore_tpu_torch import native
    from chore_tpu_torch.recon.evaluate import ReconDataReader

    seq, recon = tree
    reader = ReconDataReader(recon, seq, check_image=False)
    want = []
    for i, smpl_only in ((0, False), (2, True)):  # t0003, t0005
        gs_v, gs_f = reader.get_smplfit(i, "fit02")
        go_v, go_f = reader.get_objfit(i, "fit01")
        (rs_v, rs_f), (ro_v, ro_f) = reader.get_recon(i, "test-sn", 1)
        samp = [native.sample_surface(v, f, SAMPLES, seed=k).astype(
            np.float64) for k, (v, f) in enumerate(
                ((gs_v, gs_f), (go_v, go_f), (rs_v, rs_f), (ro_v, ro_f)))]
        if smpl_only:
            move = _f64_procrustes(rs_v.astype(np.float64),
                                   gs_v.astype(np.float64))
        else:
            move = _f64_procrustes(
                np.concatenate([rs_v, ro_v]).astype(np.float64),
                np.concatenate([gs_v, go_v]).astype(np.float64))

        def chamfer(a, b):
            return (cKDTree(b).query(a)[0].mean()
                    + cKDTree(a).query(b)[0].mean())

        want.append([chamfer(samp[0], move(samp[2])),
                     chamfer(samp[1], move(samp[3]))])
    return np.asarray(want)


def _f64_procrustes(src, ref):
    mu1, mu2 = src.mean(0), ref.mean(0)
    x1, x2 = src - mu1, ref - mu2
    u, _, vh = np.linalg.svd(x1.T @ x2)
    z = np.eye(3)
    z[2, 2] = np.sign(np.linalg.det(u @ vh))
    r = vh.T @ z @ u.T
    s = np.trace(r @ x1.T @ x2) / (x1 * x1).sum()
    return lambda p: s * p @ r.T + (mu2 - s * mu1 @ r.T)


def test_same_frames_and_errors_as_jax(runs, oracle):
    j, res_j, t, res_t, _ = runs
    ej, et = j.errors_dict[SEQ], t.errors_dict[SEQ]
    # t0003 (combined alignment) and t0005 (SMPL-only); t0004 gated out,
    # t0006 without a reconstruction
    assert et.shape == ej.shape == oracle.shape == (2, 2)
    assert res_t["total"] == res_j["total"] == 2
    assert _keys(res_t) == _keys(res_j)
    np.testing.assert_allclose(et, ej, rtol=JAX_REL, atol=0)
    assert sorted(t.timer.summary()) == ["chamfer", "io_sampling",
                                         "procrustes"]


def test_errors_against_a_float64_oracle(runs, oracle):
    _, _, t, _, _ = runs
    np.testing.assert_allclose(t.errors_dict[SEQ], oracle, rtol=ORACLE_REL,
                               atol=0)


def test_chamfer_eval_bounds():
    """``chamfer_eval`` at the evaluator's 10k: within 1e-5 relative of a
    float64 brute force, and within 1e-4 of JAX's."""
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from chore_tpu.ops.chamfer import chamfer_eval as jchamfer
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops.chamfer import chamfer_eval, chamfer_eval_multi

    use_full_f32()
    rng = np.random.RandomState(0)
    d = rng.randn(10000, 3)
    x = 0.5 * d / np.linalg.norm(d, axis=1, keepdims=True) + [0, 0, 2.2]
    x = (x + 0.005 * rng.randn(10000, 3)).astype(np.float32)
    y = (x[rng.permutation(10000)[:8000]]
         + 0.01 * rng.randn(8000, 3)).astype(np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    oracle = (cKDTree(y64).query(x64)[0].mean()
              + cKDTree(x64).query(y64)[0].mean())
    got = float(chamfer_eval(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - oracle) <= ORACLE_REL * oracle
    want = float(jchamfer(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - want) <= JAX_REL * want
    # the multi form: the same value, and batched pairs
    xb = torch.from_numpy(np.stack([x[:3000], x[3000:6000]]))
    yb = torch.from_numpy(np.stack([y[:2000], y[2000:4000]]))
    pair, batched = chamfer_eval_multi([(torch.from_numpy(x),
                                         torch.from_numpy(y)), (xb, yb)])
    assert float(pair) == got and batched.shape == (2,)
    for b in range(2):
        assert float(batched[b]) == float(chamfer_eval(xb[b], yb[b]))


def test_cli_evaluate_writes_json(tree, runs, tmp_path, monkeypatch):
    import functools

    import chore_tpu_torch.cli.evaluate as cli

    seq, recon = tree
    _, _, _, res_t, _ = runs
    out = tmp_path / "cli"
    # the tests' sample count (the CLI's is the evaluator's 10,000)
    monkeypatch.setattr(cli, "ReconEvaluator", functools.partial(
        cli.ReconEvaluator, sample_num=SAMPLES))
    res = cli.main(["-sn", "test-sn", "-r", recon, "-b",
                    os.path.dirname(seq), "--seqs", seq, "--outdir",
                    str(out), "--device", "cpu"])
    files = os.listdir(out)
    assert len(files) == 1 and files[0].startswith("test-sn_k1_")
    with open(out / files[0]) as f:
        written = json.load(f)
    assert _keys(written) == _keys(res_t)
    assert written["smpl"] == res["smpl"] == res_t["smpl"]
    assert written["total"] == 2
