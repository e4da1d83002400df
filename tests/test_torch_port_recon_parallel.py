"""Data-parallel reconstruction of the port (``ReconFitter(mesh=)``,
``Reconstructor(mesh=)``, ``cli.recon --data-parallel``) over two gloo
processes on the CPU, one frame per rank, against one process fitting the
joined batch. JAX-free: the one-process fit is the reference here, and
``test_torch_port_fit_batch.py`` holds that fit to ``chore_tpu``.

The fit couples the frames of a batch (batch-mean losses, the contact
loss's pair count, one plateau and finite decision for the batch), so the
ranks must reproduce it through their per-step sums: the same iteration
count in every phase, and parameters within 1e-3, the tolerance of
``chore_tpu``'s own sharded fit test (the ranks take float32 sums in
another order; Adam moves a raw rotation entry whose gradient is rounding
noise by up to its learning rate, 0.006: 2.1e-4 seen). A control shows
that two independent one-frame fits miss the joined fit by more than
that. The production SO(3) jitter is on: each rank draws it,
like every random number of the fit, at the global batch's shape and keeps
its slice.

Rank 0 joins with explicit arguments, rank 1 from the environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as ``torchrun`` sets it; each
worker process has a timeout, so a collective that hangs fails the test.
"""
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLE_FRAME = os.path.join(REPO, "chore_tpu_torch", "assets",
                             "example_synth", "frame0000")
S = 64
FIT = dict(iter_betas=1, iter_pose=1, iter_kpts=1, iter_kpts_max=2,
           iter_obj=2, iter_sil=2, iter_joint=1, iter_joint_max=4,
           steps_per_iter=3, obj_samples=128, net_in_size=S,
           sil_rend_size=64)
SAMP = dict(num_steps=2, sample_num=256, num_rounds=2, num_points=128)
SMALL_CFG = dict(exp_name="small", num_stack=1, net_img_size=(S, S),
                 precision="float32")
ATOL = 1e-3
WORKER_TIMEOUT = 300

WORKER = r"""
import os, pickle, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
sys.path.insert(0, {here!r})
rank, out = int(sys.argv[1]), sys.argv[2]
from chore_tpu_torch.parallel import init_distributed, make_mesh
if rank == 0:
    init_distributed("tcp://localhost:{port}", 2, 0, device="cpu")
mesh = make_mesh(device="cpu")  # rank 1 joins from the environment
assert (mesh.size, mesh.rank) == (2, rank)
import test_torch_port_recon_parallel as case
files = case.seq_files(out)
res = {{"fit": case.fit_frames(mesh),
       "recon": case.reconstruct(files[:2], mesh),
       "recon_padded": case.reconstruct(files[:3], mesh),
       "cli": case.cli_run(out, "out_dp", data_parallel=True)}}
with open(os.path.join(out, f"rank{{rank}}.pkl"), "wb") as f:
    pickle.dump(res, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def frames():
    """Two 64^2 frames (B=2) that differ in every input: seeded noise, a
    person box in channel 3 and an object disk in channel 4 (so the
    silhouette ROI is a real crop), crop centres, mocap inits, keypoints."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:S, :S]
    images = rng.rand(2, S, S, 5).astype(np.float32)
    for b, (px, py, dx, dy, r) in enumerate([(30, 36, 36.4, 31.2, 11.3),
                                             (26, 33, 40.2, 35.6, 9.4)]):
        images[b, ..., 3] = (np.abs(xx - px) < 12) & (np.abs(yy - py) < 20)
        images[b, ..., 4] = (xx - dx) ** 2 + (yy - dy) ** 2 < r ** 2
    cc = np.array([[1018.0, 779.0], [990.0, 801.0]], np.float32)
    pose = (rng.randn(2, 72) * 0.05).astype(np.float32)
    betas = (0.1 * rng.randn(2, 10)).astype(np.float32)
    kpts = np.concatenate(
        [(S * rng.rand(2, 25, 2)).astype(np.float32),
         (0.3 + 0.7 * rng.rand(2, 25, 1)).astype(np.float32)], -1)
    return images, cc, pose, betas, kpts


def _numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree


def fit_frames(mesh=None, which=slice(None)):
    """``ReconFitter.fit_batch`` of ``frames()[which]`` (the global batch:
    each rank keeps its slice) at the small config, seeded field and
    generator; returns this process's params, iterations and traces."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
    from chore_tpu_torch.recon.generator import SamplerConfig
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere

    tv, tf = octasphere(radius=0.18, subdiv=1)
    fitter = ReconFitter(
        build_field(FieldConfig(num_stack=1), device="cpu", seed=0),
        SMPLH(synthetic_smplh(), device="cpu"), tv, tf,
        cfg=FitConfig(**FIT), sampler_cfg=SamplerConfig(**SAMP), mesh=mesh,
        record_traces=True, device="cpu")
    out = fitter.fit_batch(*(a[which] for a in frames()))
    return {k: _numpy(out[k]) for k in ("smpl_params", "obj_params",
                                        "obj_R", "iters", "smpl_trace",
                                        "obj_trace")}


def seq_files(root):
    """A four-frame sequence under ROOT/seq: the committed example frame,
    then copies whose keypoints, mocap pose and photo differ; returns the
    color images in order (written once, by whoever comes first)."""
    from chore_tpu_torch.data.imageio import imwrite, read_bgr

    seq = os.path.join(root, "seq")
    files = [os.path.join(seq, f"frame{k:04d}", "k1.color.jpg")
             for k in range(4)]
    if os.path.isdir(seq):
        return files
    tmp = seq + f".{os.getpid()}"
    rng = np.random.RandomState(3)
    for k in range(4):
        frame = os.path.join(tmp, f"frame{k:04d}")
        shutil.copytree(EXAMPLE_FRAME, frame)
        if k == 0:
            continue
        path = os.path.join(frame, "k1.color.json")
        with open(path) as f:
            kp = json.load(f)
        j = np.asarray(kp["body_joints"]).reshape(-1, 3)
        j[:, :2] += (4.0 * k, -3.0 * k)
        kp["body_joints"] = j.ravel().tolist()
        with open(path, "w") as f:
            json.dump(kp, f)
        path = os.path.join(frame, "k1.mocap.json")
        with open(path) as f:
            mc = json.load(f)
        mc["pose"] = (np.asarray(mc["pose"])
                      + 0.03 * rng.randn(len(mc["pose"]))).tolist()
        with open(path, "w") as f:
            json.dump(mc, f)
        path = os.path.join(frame, "k1.color.jpg")
        imwrite(path, (read_bgr(path) * (1.0 - 0.08 * k)).astype(np.uint8))
    try:
        os.rename(tmp, seq)
    except OSError:  # another process published it first
        shutil.rmtree(tmp)
    return files


def _cfgs():
    from chore_tpu_torch.config import ChoreConfig
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.recon.generator import SamplerConfig

    return (ChoreConfig(**SMALL_CFG), FitConfig(**FIT),
            SamplerConfig(**SAMP))


def reconstruct(files, mesh=None):
    """``Reconstructor.reconstruct(files)`` at the small config (seeded
    random field, no checkpoint); crop info written next to each image."""
    from chore_tpu_torch.api import Reconstructor

    cfg, fit, samp = _cfgs()
    rec = Reconstructor(cfg, obj_name="basketball",
                        exp_root="no_such_experiments", fit_cfg=fit,
                        sampler_cfg=samp, device="cpu", mesh=mesh)
    return rec.reconstruct(files)


def cli_run(root, out, batch_size=1, data_parallel=False):
    """``cli.recon.recon_fit`` over ROOT/seq into ROOT/OUT (with
    ``data_parallel``, the batch rounds up to the ranks); returns how many
    batches this process fitted."""
    from chore_tpu_torch.cli.recon import recon_fit

    cfg, fit, samp = _cfgs()
    seq_files(root)
    fitter = recon_fit(cfg, os.path.join(root, "seq"), "fit",
                       os.path.join(root, out), obj_name="basketball",
                       batch_size=batch_size, data_parallel=data_parallel,
                       exp_root="no_such_experiments", fit_cfg=fit,
                       sampler_cfg=samp, device="cpu")
    return fitter.timer.summary().get("encode", {}).get("count", 0)


def _outputs(root):
    """{relative path: file bytes or pickle} of the frames' outputs under
    ROOT/seq (the crop-info file beside them is written only into an
    output directory that exists when a frame is prepared)."""
    out = {}
    for d, _, fs in os.walk(os.path.join(root, "seq")):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = (
                    pickle.load(fh) if f.endswith(".pkl") else fh.read())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank runs (subprocesses) and the one-process references,
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("recon_dp")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        files = seq_files(str(tmp))
        ref_files = seq_files(str(tmp / "ref"))
        # the one-process -bs 2 run; the data-parallel run resumes after
        # its first batch, which is already on disk
        cli_run(str(tmp), "out_ref", batch_size=2)
        for k in range(2):
            rel = os.path.join("seq", f"frame{k:04d}")
            shutil.copytree(os.path.join(tmp, "out_ref", rel),
                            os.path.join(tmp, "out_dp", rel))
        port = _free_port()
        script = tmp / "worker.py"
        script.write_text(WORKER.format(repo=REPO, here=HERE, port=port))
        env = dict(os.environ, RANK="1", WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, str(script), str(r),
                                   str(tmp)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        try:
            ref = {"fit": fit_frames(),
                   "control": [fit_frames(which=slice(b, b + 1))
                               for b in range(2)],
                   "recon": reconstruct(ref_files[:2]),
                   "recon_padded": reconstruct(ref_files[:3]
                                               + ref_files[2:3])}
            for p in procs:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT)
                assert p.returncode == 0, out[-3000:]
        finally:
            for p in procs:
                p.kill()
    finally:
        torch.set_num_threads(threads)
    ranks = []
    for r in (0, 1):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return tmp, ref, ranks


def _joined(ranks, key, group):
    return {k: np.concatenate([r[key][group][k] for r in ranks])
            for k in ranks[0][key][group]}


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def test_fitter_ranks_equal_the_joined_batch(runs):
    """``ReconFitter(mesh=)``: each rank returns its own frame; together
    they are the one-process B=2 fit (parameters within 1e-3), with the
    same iteration counts and the same per-step batch loss on both ranks
    (relative 1e-4; 2.7e-5 seen)."""
    _, ref, ranks = runs
    want = ref["fit"]
    for group in ("smpl_params", "obj_params"):
        got = _joined(ranks, "fit", group)
        assert got["obj_s" if group == "obj_params" else "trans"].shape[0] \
            == 2
        assert _max_diff(got, want[group]) < ATOL, group
    np.testing.assert_allclose(
        np.concatenate([r["fit"]["obj_R"] for r in ranks]), want["obj_R"],
        atol=ATOL)
    for r in ranks:
        assert r["fit"]["iters"] == want["iters"]
        for chain in ("smpl_trace", "obj_trace"):
            for name, tr in want[chain].items():
                got = r["fit"][chain][name]
                np.testing.assert_array_equal(got["live"], tr["live"])
                np.testing.assert_allclose(got["loss"], tr["loss"],
                                           rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(ranks[0]["fit"]["smpl_trace"]["global"]
                                  ["loss"],
                                  ranks[1]["fit"]["smpl_trace"]["global"]
                                  ["loss"])


def test_control_independent_frames_differ(runs):
    """Two one-frame fits are not the B=2 fit: they miss it by far more
    than the tolerance above, so the comparison sees the coupling."""
    _, ref, _ = runs
    joined = {k: np.concatenate([c["obj_params"][k] for c in ref["control"]])
              for k in ref["fit"]["obj_params"]}
    joined.update({k: np.concatenate([c["smpl_params"][k]
                                      for c in ref["control"]])
                   for k in ref["fit"]["smpl_params"]})
    want = dict(ref["fit"]["obj_params"], **ref["fit"]["smpl_params"])
    diff = _max_diff(joined, want)
    print(f"independent frames vs the joined batch: {diff:.3e}")
    assert diff > ATOL


@pytest.mark.parametrize("case", ["recon", "recon_padded"])
def test_reconstructor_every_rank_returns_the_batch(runs, case):
    """``Reconstructor(mesh=)`` with one frame per rank ("recon"), and with
    three frames padded to four ("recon_padded", against one process on
    the padded list): every rank returns the whole trimmed result, equal
    to the one-process result within 1e-3, with the same crop info."""
    tmp, ref, ranks = runs
    want = ref[case]
    n = 2 if case == "recon" else 3
    for r in ranks:
        got = r[case]
        assert got["smpl_verts"].shape[0] == n == len(got["paths"])
        assert ([os.path.relpath(p, tmp) for p in got["paths"]]
                == [os.path.relpath(p, tmp / "ref")
                    for p in want["paths"][:n]])
        for k in ("smpl_verts", "obj_verts", "obj_R"):
            np.testing.assert_allclose(got[k], want[k][:n], atol=ATOL,
                                       err_msg=k)
        for group in ("smpl_params", "obj_params"):
            assert _max_diff(got[group], {k: v[:n] for k, v in
                                          want[group].items()}) < ATOL
        for a, b in zip(got["crop_info"], want["crop_info"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_crop_info_written_next_to_each_frame(runs):
    """The ranks wrote each reconstructed frame's crop info next to its
    image, equal to what one process writes (a padding copy writes none;
    a file is published whole, so ranks never leave a torn one)."""
    tmp, _, _ = runs
    for k in range(4):
        rel = os.path.join("seq", f"frame{k:04d}", "k1.crop_info.pkl")
        assert os.path.isfile(tmp / rel) == (k < 3), rel
        if k < 3:
            with open(tmp / rel, "rb") as f:
                got = pickle.load(f)
            with open(tmp / "ref" / rel, "rb") as f:
                want = pickle.load(f)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name])


def test_cli_data_parallel_resume_writes_the_same_files(runs):
    """``cli.recon --data-parallel`` on two ranks, resuming after the first
    batch, writes the same files as the one-process ``-bs 2`` run: the
    same names, the same mesh faces, vertices and parameters within 1e-3;
    each rank fitted one batch (the second), the written one was skipped."""
    tmp, _, ranks = runs
    want, got = _outputs(tmp / "out_ref"), _outputs(tmp / "out_dp")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".ply")]) == 8
    from chore_tpu_torch.utils.meshio import load_ply

    for k, v in want.items():
        if k.endswith(".pkl"):
            for name in v:
                np.testing.assert_allclose(np.asarray(got[k][name]),
                                           np.asarray(v[name]), atol=ATOL,
                                           err_msg=f"{k}/{name}")
        elif k.endswith(".ply"):
            vg, fg = load_ply(str(tmp / "out_dp" / k))
            vw, fw = load_ply(str(tmp / "out_ref" / k))
            np.testing.assert_array_equal(fg, fw)
            np.testing.assert_allclose(vg, vw, atol=ATOL, err_msg=k)
    assert [r["cli"] for r in ranks] == [1, 1]


def test_one_process_mesh_writes_the_same_files(runs, tmp_path):
    """``--data-parallel`` without ``torchrun`` is a one-process mesh: the
    batch stays 2 and the files are byte for byte the plain run's."""
    tmp, _, _ = runs
    shutil.copytree(tmp / "seq", tmp_path / "seq")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cli_run(str(tmp_path), "out", batch_size=2, data_parallel=True)
    finally:
        torch.set_num_threads(threads)
    want, got = _outputs(tmp / "out_ref"), _outputs(tmp_path / "out")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith(".pkl"):
            for name in v:
                np.testing.assert_array_equal(got[k][name], v[name])
        else:
            assert got[k] == v, k
