"""Kernel tests that need the card: each hand-written CUDA kernel against
its plain PyTorch version on CUDA tensors. Marked ``cuda``; they skip where
there is no card. This file imports no JAX (the card's machine has none;
``tests/conftest.py`` does), so on the card run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The 1-NN cases are shared with ``test_torch_port_nn.py``, and
``test_torch_port_silhouette.py`` holds the coverage kernels' plain versions
to the TPU kernels on the CPU.
"""
import os

import numpy as np
import pytest
import torch


def make_case(seed, n_x=700, n_y=450, groups=None, mask=None, dups=False,
              coincident=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_x, 3).astype(np.float32)
    y = rng.randn(n_y, 3).astype(np.float32)
    if dups:
        y[100:150] = y[:50]  # exact duplicates: lowest index must win
    if coincident:
        # queries on references, each twice: raw distances at or just
        # below 0 all clamp to 0, and the lower index wins
        y[300:350] = y[200:250]
        x[:50] = y[200:250]
    xg = yg = ym = None
    if groups:
        xg = rng.randint(0, groups, n_x).astype(np.int32)
        yg = rng.randint(0, groups, n_y).astype(np.int32)
    if mask is not None:
        ym = rng.rand(n_y) > mask
    return x, y, ym, xg, yg


CASES = {
    "plain": dict(),
    "groups": dict(groups=5),
    "mask": dict(mask=0.4),
    "groups_mask": dict(groups=4, mask=0.4),
    "duplicates": dict(dups=True),
    "ragged": dict(n_x=13, n_y=7),
    "empty_groups": dict(groups=40, n_y=30),  # many queries unmatched
    "coincident": dict(coincident=True),
}


def multi_case(name, dev="cpu", scale=1):
    """([(x, y, qg, rg)] batched torch problems for ``nn_grouped_multi``,
    and per problem the numpy inputs per example (x, y, y_mask, x_group,
    y_group)). ``joint_small``: the fit's joint step (contact h->o, o->h in
    14 part groups with masks, collision o->h ungrouped over the same
    clouds) at 700 x 300 points, or at the fit's 6,890 x 3,000 with
    ``scale="full"``; the others: all masked, groups without references,
    exact duplicates, B = 2."""
    from chore_tpu_torch.ops.nn import group_rows

    rng = np.random.RandomState(17)
    B = 2 if name == "batch2" else 1
    nh, no = (6890, 3000) if scale == "full" else (700, 300)

    def cloud(k, spread=0.3):
        return (rng.randn(B, k, 3) * spread + [0, -0.2, 2.2]).astype(
            np.float32)

    specs = []  # (x, y, y_mask, x_group, y_group), numpy, batched
    if name == "joint_small":
        h, o = cloud(nh), cloud(no, 0.2)
        gh, go = rng.randint(0, 14, (B, nh)), rng.randint(0, 14, (B, no))
        mh, mo = rng.rand(B, nh) < 0.3, rng.rand(B, no) < 0.4
        specs = [(h, o, mo, gh, go), (o, h, mh, go, gh),
                 (o, h, None, None, None)]
    elif name == "all_masked":
        x, y = cloud(120), cloud(80)
        specs = [(x, y, np.zeros((B, 80), bool), None, None),
                 (y, x, None, None, None)]
    elif name == "empty_groups":
        x, y = cloud(150), cloud(90)
        specs = [(x, y, None, rng.randint(0, 5, (B, 150)),
                  rng.randint(0, 3, (B, 90))), (x, y, None, None, None)]
    elif name == "duplicates":
        x, y = cloud(130), cloud(200)
        yg = rng.randint(0, 3, (B, 200))
        y[:, 100:150], yg[:, 100:150] = y[:, :50], yg[:, :50]
        specs = [(x, y, None, rng.randint(0, 3, (B, 130)), yg),
                 (x, y, None, None, None)]
    elif name == "batch2":
        specs = [(cloud(300), cloud(210), rng.rand(B, 210) > 0.2,
                  rng.randint(0, 5, (B, 300)), rng.randint(0, 5, (B, 210))),
                 (cloud(90), cloud(400), None, None, None)]
    tensors = {}  # one torch tensor per numpy cloud: shared clouds stay so

    def tt(a, dt=torch.float32):
        if a is None:
            return None
        if id(a) not in tensors:
            tensors[id(a)] = torch.as_tensor(a).to(dt).to(dev).contiguous()
        return tensors[id(a)]

    problems, raw = [], []
    for x, y, ym, xg, yg in specs:
        tx, ty = tt(x), tt(y)
        problems.append((tx, ty, *group_rows(
            tx, ty, tt(ym, torch.bool), tt(xg, torch.int64),
            tt(yg, torch.int64))))
        opt = lambda a, b: None if a is None else a[b]  # noqa: E731
        raw.append([(x[b], y[b], opt(ym, b), opt(xg, b), opt(yg, b))
                    for b in range(B)])
    return problems, raw


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on a card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_port_cuda.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    """The CUDA kernel against the plain version on the card: 1e-5 on
    distances (unit-scale points), identical indices; two calls bitwise
    equal, one launch counted per call."""
    from chore_tpu_torch.ops import nn as tnn
    from chore_tpu_torch.ops.nn import group_rows

    x, y, ym, xg, yg = make_case(3, **CASES[name])
    dev = cuda_device
    opt = lambda a, dt: (  # noqa: E731
        None if a is None else torch.as_tensor(a, dtype=dt)[None].to(dev))
    tx, ty = (torch.as_tensor(a)[None].to(dev) for a in (x, y))
    qg, rg = group_rows(tx, ty, opt(ym, torch.bool), opt(xg, torch.int64),
                        opt(yg, torch.int64))
    before = tnn.launches["nn_grouped"]
    dk, ik = tnn.nn_grouped(tx, ty, qg, rg)
    dk2, ik2 = tnn.nn_grouped(tx, ty, qg, rg)
    dp, ip = tnn.nn_sqdist_plain(tx, ty, qg, rg)
    torch.cuda.synchronize()
    assert tnn.launches["nn_grouped"] == before + 2
    assert torch.equal(dk, dk2) and torch.equal(ik, ik2)
    assert torch.equal(ik, ip)
    torch.testing.assert_close(dk, dp, atol=1e-5, rtol=0)


def assert_nn_close(d, i, problem, tol):
    """(d, i) of the kernel against the plain version of ``problem``:
    distances within ``tol``; an index may differ only where the best two
    distances lie within ``tol`` of each other; the unmatched get the
    sentinel and index 0."""
    from chore_tpu_torch.ops.nn import BIG, nn_sqdist_plain

    x, y, qg, rg = problem
    dp, ip = nn_sqdist_plain(*problem)
    torch.testing.assert_close(d, dp, atol=tol, rtol=0)
    dm = ((x * x).sum(-1, keepdim=True) - 2.0 * torch.bmm(
        x, y.transpose(1, 2)) + (y * y).sum(-1)[:, None, :]).clamp_min(0)
    if qg is not None:
        dm = torch.where(qg[:, :, None] == rg[:, None, :], dm,
                         torch.full_like(dm, BIG))
    if dm.shape[-1] >= 2:
        top = torch.topk(dm, 2, dim=-1, largest=False).values
        sure = (top[..., 1] - top[..., 0]) > tol
    else:
        sure = torch.ones_like(d, dtype=torch.bool)
    assert not bool(((i != ip) & sure).any())
    unmatched = dp >= 0.5 * BIG
    assert bool(((d[unmatched] == BIG) & (i[unmatched] == 0)).all())


MULTI_CASES = ["joint_small", "joint_full", "all_masked", "empty_groups",
               "duplicates", "batch2"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", MULTI_CASES)
def test_multi_matches_plain_on_card(cuda_device, name):
    """One launch for every problem of the case, each answer against its
    plain version (5e-5 on distances: points near z = 2.2, |x|^2 ~ 5; the
    near-tie index rule); two calls bitwise equal; the shared scan's two
    answers each equal to a separate call of the kernel."""
    from chore_tpu_torch.ops import nn as tnn

    problems, _ = multi_case(name.replace("_full", "_small"), cuda_device,
                             scale="full" if name == "joint_full" else 1)
    before = tnn.launches["nn_grouped"]
    out = tnn.nn_grouped_multi(problems)
    out2 = tnn.nn_grouped_multi(problems)
    torch.cuda.synchronize()
    assert tnn.launches["nn_grouped"] == before + 2
    shared = [k for kind, k, _ in tnn.plan(problems) if kind == tnn.SHARED]
    # the joint step's o->h pair, and the pairs built over one x and y
    assert len(shared) == (0 if name in ("all_masked", "batch2") else 1)
    for p, (d, i), (d2, i2) in zip(problems, out, out2):
        assert torch.equal(d, d2) and torch.equal(i, i2)
        assert_nn_close(d, i, p, 5e-5)
        ds, is_ = tnn.nn_grouped(*p)  # alone: the same scan, bitwise
        assert torch.equal(d, ds) and torch.equal(i, is_)
    if name == "duplicates":
        for _, i in out:
            assert not bool(((i >= 100) & (i < 150)).any())


@pytest.mark.cuda
def test_multi_is_one_kernel_per_call(cuda_device):
    """100 multi calls of the joint step's three problems under
    torch.profiler run exactly 100 kernels on the card: one launch per
    call, no second pass, no index conversion."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chore_tpu_torch.ops import nn as tnn

    problems, _ = multi_case("joint_small", cuda_device, scale="full")
    tnn.nn_grouped_multi(problems)  # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            tnn.nn_grouped_multi(problems)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    assert sum(ev.count for ev in kernels) == 100, [
        (ev.key, ev.count) for ev in kernels]


# --------------------------------------------------------------------- #
# K2/K3: the soft-silhouette coverage kernels
def coverage_case(name, dev):
    """(e (B, 3, 8, F), g (B, P), S, inv_sigma) on ``dev``: an octasphere
    template in front of a unit camera; the named variation on it."""
    from chore_tpu_torch.ops.rasterizer import project_unit_k
    from chore_tpu_torch.ops.silhouette import edge_coeffs
    from chore_tpu_torch.utils.meshio import octasphere

    S, widen, B, subdiv, shift = 64, 1.0, 1, 2, (0.0, 0.0, 0.0)
    if name == "size_100":
        S = 100
    elif name == "sigma_x4":
        widen = 4.0
    elif name == "batch2":
        B = 2
    elif name == "faces_2048":
        subdiv = 4
    elif name == "faces_2048_batch2":
        subdiv, B = 4, 2
    elif name == "faces_2047":
        subdiv = 4
    elif name == "faces_2501":
        subdiv = 5
    elif name == "size_100_faces_1000":
        S, subdiv = 100, 4
    elif name == "offscreen":
        shift = (5.0, 0.0, 0.0)
    tv, tf = octasphere(radius=0.3, center=(0.05, -0.02, 1.2), subdiv=subdiv)
    K = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]])
    verts = torch.as_tensor(tv)[None].repeat(B, 1, 1)
    if B == 2:
        verts[1] += torch.tensor([0.1, 0.05, 0.3])
    ndc = project_unit_k(verts, K.expand(B, 3, 3)) + torch.tensor(shift)
    if name == "degenerate_behind_camera":
        ndc[0, 0, 2] = -1.0
        ndc[0, 1] = ndc[0, 2]
    faces = torch.as_tensor(tf, dtype=torch.int64)
    if name == "no_faces":
        faces = faces[:0]
    elif name == "faces_odd":  # F = 125: rows not 16-byte aligned
        faces = faces[:125]
    elif name in ("faces_2047", "faces_2501", "size_100_faces_1000"):
        # K2 in clusters of two tiles: F % 4 = 3 in one stage, F % 4 = 1 in
        # three chunks, and an odd count of tile columns (7 at S = 100)
        faces = faces[:int(name.split("_")[-1])]
    elif name == "huge_face":  # its grown box covers the whole image
        big = torch.tensor([[-1.5, -1.2, 1.2], [1.4, -0.9, 1.2],
                            [0.1, 1.3, 1.2]])
        n = ndc.shape[1]
        ndc = torch.cat([ndc, big.expand(B, 3, 3)], 1)
        faces = torch.cat([faces, torch.tensor([[n, n + 1, n + 2]])])
    sigma = widen * 0.5 * (2.0 / S)
    e = edge_coeffs(ndc, faces, sigma)
    g = torch.from_numpy(
        np.random.RandomState(1).randn(B, S * S).astype(np.float32))
    if name == "sparse_g":
        g[:, : S * S // 2] = 0.0
    elif name == "zero_g":
        g.zero_()
    return e.contiguous().to(dev), g.to(dev), S, 1.0 / sigma


COVERAGE_CASES = ["octasphere", "faces_2048", "degenerate_behind_camera",
                  "no_faces", "size_100", "sigma_x4", "batch2", "offscreen",
                  "sparse_g", "zero_g", "huge_face", "faces_odd",
                  "faces_2048_batch2", "faces_2047", "faces_2501",
                  "size_100_faces_1000"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", COVERAGE_CASES)
def test_coverage_kernels_match_plain_on_card(cuda_device, name):
    """K2 against ``coverage_sums_plain`` to 1e-5 of max(1, the sum) (f32
    sums over up to thousands of faces in another order); K3 against
    ``coverage_sums_bwd_plain`` to 1e-5 of the largest gradient (the d_e
    evaluation is rounded op by op in both, so the routing is the same);
    two calls of each bitwise equal; one launch counted per call."""
    from chore_tpu_torch.ops import silhouette as tsil

    e, g, S, inv = coverage_case(name, cuda_device)
    before = dict(tsil.launches)
    cov = tsil.coverage_sums_cuda(e, S, inv)
    cov2 = tsil.coverage_sums_cuda(e, S, inv)
    de = tsil.coverage_sums_bwd_cuda(e, g, S, inv)
    de2 = tsil.coverage_sums_bwd_cuda(e, g, S, inv)
    cov_p = tsil.coverage_sums_plain(e, S, inv)
    de_p = tsil.coverage_sums_bwd_plain(e, g, S, inv)
    torch.cuda.synchronize()
    assert tsil.launches["coverage_fwd"] == before["coverage_fwd"] + 2
    n_bwd = 0 if e.shape[-1] == 0 else 2
    assert tsil.launches["coverage_bwd"] == before["coverage_bwd"] + n_bwd
    assert torch.equal(de, de2)
    assert torch.equal(cov, cov2)
    torch.testing.assert_close(cov, cov_p, atol=1e-5, rtol=1e-5)
    if name == "no_faces":
        assert de.shape[-1] == 0 and float(cov.abs().max()) == 0.0
        return
    scale = max(float(de_p.abs().max()), 1e-30)
    torch.testing.assert_close(de, de_p, atol=1e-5 * scale, rtol=0)
    if name == "offscreen":
        assert float(cov.abs().max()) == 0.0
    if name in ("offscreen", "zero_g"):
        assert float(de.abs().max()) == 0.0
    else:
        assert float(cov.max()) > 0.5 and float(de.abs().max()) > 0


@pytest.mark.cuda
def test_soft_silhouette_autograd_on_card(cuda_device):
    """The autograd Function launches K2 forward and K3 backward; the
    vertex gradient agrees with the CPU's plain route."""
    from chore_tpu_torch.ops import silhouette as tsil
    from chore_tpu_torch.ops.rasterizer import project_unit_k, soft_silhouette
    from chore_tpu_torch.utils.meshio import octasphere

    tv, tf = octasphere(radius=0.3, center=(0.05, -0.02, 1.2), subdiv=2)
    K = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]])
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        v = torch.as_tensor(tv)[None].to(dev).requires_grad_(True)
        sil = soft_silhouette(project_unit_k(v, K.to(dev)),
                              torch.as_tensor(tf, device=dev), image_size=64)
        before = dict(tsil.launches)
        ((sil - 0.5) ** 2).sum().backward()
        grads.append(v.grad.cpu())
        if dev.type == "cuda":
            assert tsil.launches["coverage_bwd"] == before["coverage_bwd"] + 1
    scale = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4 * scale, rtol=0)


def graph_node_kinds(fn, count):
    """The node types (0 = kernel) of a CUDA graph holding ``count`` calls
    of ``fn``, from ``cuGraphGetNodes``: what each call put on the stream,
    as CUDA recorded it (a profiler's activity records can drop one)."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds


@pytest.mark.cuda
def test_coverage_bwd_is_one_kernel_per_call(cuda_device):
    """100 K3 calls put exactly 100 kernels on the stream: one launch per
    call, no second pass, no memset. Counted as the kernel nodes of a CUDA
    graph of the 100 calls (torch.profiler's CUPTI records missed one of
    the 100 in 2 of ~6 card runs while the wrapper's own count and the
    graph's nodes were exact)."""
    from chore_tpu_torch.ops import silhouette as tsil

    e, g, S, inv = coverage_case("octasphere", cuda_device)
    before = tsil.launches["coverage_bwd"]
    kinds = graph_node_kinds(lambda: tsil.coverage_sums_bwd_cuda(e, g, S,
                                                                 inv), 100)
    assert kinds == [0] * 100, kinds
    assert tsil.launches["coverage_bwd"] - before == 101  # with the warm-up


@pytest.mark.cuda
def test_hard_rasterize_on_card_matches_cpu(cuda_device):
    """The overlay z-buffer (stock torch ops) on the card against the same
    function on the CPU, on an SMPL-sized scene at 256^2: face indices
    equal on >= 99.9% of pixels (a pixel on an edge may flip with the
    rounding of a fused multiply-add), depth and barycentrics within 1e-4
    where they are equal."""
    from chore_tpu_torch.ops.rasterizer import hard_rasterize, project_unit_k
    from chore_tpu_torch.smpl import synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere
    from chore_tpu_torch.utils.render import kinect_unit_k

    sm = synthetic_smplh()
    sv = sm["v_template"].astype(np.float32) + np.float32([0, 0.2, 2.2])
    ov, of = octasphere(radius=0.15, center=(0.3, 0.1, 2.0), subdiv=3)
    verts = np.concatenate([sv, ov]).astype(np.float32)
    faces = np.concatenate([sm["faces"], of + len(sv)]).astype(np.int64)
    ndc = project_unit_k(torch.from_numpy(verts)[None],
                         torch.from_numpy(kinect_unit_k())[None])
    f = torch.from_numpy(faces)
    ci, cz, cw = hard_rasterize(ndc, f, image_size=256)
    gi, gz, gw = (x.cpu() for x in hard_rasterize(
        ndc.to(cuda_device), f.to(cuda_device), image_size=256))
    eq = gi == ci
    assert (ci >= 0).float().mean() > 0.02
    assert eq.float().mean() >= 0.999
    assert float((gz - cz).abs()[eq].max()) <= 1e-4
    assert float((gw - cw).abs()[eq].max()) <= 1e-4


# --------------------------------------------------------------------- #
# evaluation and preprocessing: K1 at its other users' calls
@pytest.mark.cuda
def test_chamfer_eval_and_point_mesh_udf_on_card(cuda_device):
    """``chamfer_eval_multi`` (the evaluator's four problems, one launch)
    and ``point_mesh_udf`` on the card against the same functions on the
    CPU: Chamfer within 1e-5 relative, UDF within 1e-6, nearest vertices
    equal except where the best two distances lie within 5e-5."""
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops import nn as tnn
    from chore_tpu_torch.ops.chamfer import chamfer_eval_multi
    from chore_tpu_torch.ops.point_mesh import point_mesh_udf
    from chore_tpu_torch.smpl import synthetic_smplh

    use_full_f32()
    rng = np.random.RandomState(3)
    clouds = [torch.from_numpy((rng.randn(n, 3) * 0.3 + [0, 0, 2.2]).astype(
        np.float32)) for n in (10000, 10000, 10000, 10000)]
    pairs = [(clouds[0], clouds[2]), (clouds[1], clouds[3])]
    cpu = chamfer_eval_multi(pairs)
    before = tnn.launches["nn_grouped"]
    card = chamfer_eval_multi([(a.to(cuda_device), b.to(cuda_device))
                               for a, b in pairs])
    torch.cuda.synchronize()
    assert tnn.launches["nn_grouped"] - before == 1
    for c, g in zip(cpu, card):
        assert abs(float(g) - float(c)) <= 1e-5 * float(c)

    sm = synthetic_smplh()
    verts = torch.from_numpy(sm["v_template"].astype(np.float32)
                             + np.float32([0, 0.2, 2.2]))
    faces = torch.from_numpy(sm["faces"].astype(np.int64))
    pts = torch.from_numpy((rng.randn(5000, 3) * 0.4 + [0, 0.2, 2.2]).astype(
        np.float32))
    d_c, i_c = point_mesh_udf(pts, verts, faces)
    before = tnn.launches["nn_grouped"]
    d_g, i_g = (x.cpu() for x in point_mesh_udf(
        pts.to(cuda_device), verts.to(cuda_device), faces.to(cuda_device)))
    assert tnn.launches["nn_grouped"] - before == 1
    assert float((d_g - d_c).abs().max()) <= 1e-6
    differ = i_g != i_c
    if bool(differ.any()):
        d = ((pts[differ][:, None].double() - verts[None].double()) ** 2).sum(
            -1)
        two = torch.topk(d, 2, dim=-1, largest=False).values
        assert bool(((two[:, 1] - two[:, 0]) <= 5e-5).all())


def _write_eval_tree(root, frames):
    """A BEHAVE sequence and reconstructions written with the port's own
    writers (no cv2 on the card's machine): GT two spheres per frame, the
    reconstruction a moved and scaled copy, masks passing the gate."""
    import json

    from chore_tpu_torch.data.imageio import imwrite
    from chore_tpu_torch.utils.meshio import octasphere, save_ply

    seq = os.path.join(root, "Date01_Sub01_basketball")
    recon = os.path.join(root, "recon")
    os.makedirs(seq)
    with open(os.path.join(seq, "info.json"), "w") as f:
        json.dump({"cat": "basketball", "gender": "male", "kinects": [0, 1]},
                  f)
    sv, sf = octasphere(radius=0.5, center=(0, 0.2, 2.2), subdiv=3)
    ov, of = octasphere(radius=0.2, center=(0.7, 0, 2.2), subdiv=3)
    mask = np.zeros((100, 100), np.uint8)
    mask[10:90, 10:90] = 255
    for k in range(frames):
        frame = os.path.join(seq, f"t{k:04d}.000")
        for sub, name, (v, fc) in (("person/fit02", "person_fit.ply",
                                    (sv, sf)),
                                   ("basketball/fit01", "basketball_fit.ply",
                                    (ov, of))):
            os.makedirs(os.path.join(frame, sub))
            save_ply(os.path.join(frame, sub, name), v, fc)
        imwrite(os.path.join(frame, "k1.obj_rend_mask.jpg"), mask)
        imwrite(os.path.join(frame, "k1.obj_rend_full.jpg"), mask)
        out = os.path.join(recon, os.path.basename(seq), f"t{k:04d}.000",
                           "sn")
        os.makedirs(out)
        save_ply(os.path.join(out, "k1.smpl.ply"), sv * 1.2 + 0.1 * k, sf)
        save_ply(os.path.join(out, "k1.object.ply"), ov * 1.2 + 0.1 * k, of)
    return seq, recon


@pytest.mark.cuda
def test_evaluator_one_launch_per_frame_on_card(cuda_device, tmp_path):
    """``ReconEvaluator`` on the card: one K1 launch per evaluated frame
    (its thread pool launching concurrently), errors within 1e-5 relative
    of the same evaluation on the CPU."""
    from chore_tpu_torch.ops import nn as tnn
    from chore_tpu_torch.recon.evaluate import ReconEvaluator

    seq, recon = _write_eval_tree(str(tmp_path), frames=5)
    kw = dict(sample_num=3000, outdir=str(tmp_path / "results"))
    before = tnn.launches["nn_grouped"]
    card = ReconEvaluator(recon, str(tmp_path), device=cuda_device, **kw)
    res = card.eval_seqs([seq], "sn")
    assert tnn.launches["nn_grouped"] - before == 5 == res["total"]
    cpu = ReconEvaluator(recon, str(tmp_path), device="cpu", **kw)
    cpu.eval_seqs([seq], "sn")
    np.testing.assert_allclose(card.errors_dict["Date01_Sub01_basketball"],
                               cpu.errors_dict["Date01_Sub01_basketball"],
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_first_k1_calls_from_four_threads_build_once(cuda_device, tmp_path,
                                                     monkeypatch):
    """Four threads making the process's first K1 call at once (a fresh,
    empty build directory): nvcc runs once, every thread gets the right
    answer, and the four launches are all counted."""
    import subprocess
    import threading

    from chore_tpu_torch.ops import cuda_build
    from chore_tpu_torch.ops import nn as tnn

    started = []
    popen = subprocess.Popen

    def counting(cmd, *a, **k):
        started.append(cmd)
        return popen(cmd, *a, **k)

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build.subprocess, "Popen", counting)
    x, y, ym, xg, yg = (torch.from_numpy(a)[None] for a in make_case(
        5, groups=5, mask=0.3))
    p = [(x, y, *tnn.group_rows(x, y, ym, xg, yg))]
    pc = [tuple(t.to(cuda_device) for t in p[0])]
    barrier = threading.Barrier(4)
    outs, errors = [None] * 4, []

    def call(k):
        try:
            barrier.wait()
            outs[k] = tnn.nn_grouped_multi(pc)[0]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    before = tnn.launches["nn_grouped"]
    threads = [threading.Thread(target=call, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(started) == 1 and os.listdir(tmp_path) == [
        os.path.basename(cuda_build._library_path("nn_grouped")[1])]
    assert tnn.launches["nn_grouped"] - before == 4
    for d, i in outs:
        assert_nn_close(d, i, pc[0], 5e-5)



# --------------------------------------------------------------------- #
# training
@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device, tmp_path):
    """One float32 training step of the tiny field (seeded weights, the
    same batch) on the card and on the CPU: the loss and its parts within
    1e-5 relative, every gradient within 1e-4 of its tensor's largest
    (cuDNN's and the CPU's conv sums and grid_sample's atomic backward
    add in other orders; TF32 is off)."""
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.train import Trainer

    rng = np.random.RandomState(0)
    B, N = 2, 300
    batch = {
        "images": rng.randint(0, 256, (B, 32, 32, 5)).astype(np.uint8),
        "points": (rng.rand(B, N, 3) * [1, 1, 0.5]
                   + [-0.5, -0.5, 1.95]).astype(np.float32),
        "crop_center": np.tile([[1018.0, 779.0]], (B, 1)).astype(np.float32),
        "df_h": (np.abs(rng.randn(B, N)) * 0.1).astype(np.float32),
        "df_o": (np.abs(rng.randn(B, N)) * 0.1).astype(np.float32),
        "parts": rng.randint(0, 14, (B, N)).astype(np.int32),
        "pca": rng.randn(B, 3, 3).astype(np.float32),
        "body_center": np.tile([[0.0, 0, 2.2]], (B, 1)).astype(np.float32),
        "obj_center": (0.3 * rng.randn(B, 3)).astype(np.float32)}
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        model = build_field(FieldConfig(num_stack=1, net_img_size=32),
                            device=dev, seed=3, trainable=True)
        tr = Trainer(model, str(tmp_path / dev.type), ck_period_min=1e9)
        loss, parts = tr.train_step(batch)
        out.append((float(loss), {k: float(v) for k, v in parts.items()},
                    {n: p.grad.cpu() for n, p in tr.named_params}))
    (lc, pc, gc), (l0, p0, g0) = out
    np.testing.assert_allclose(lc, l0, rtol=1e-5)
    for k in p0:
        np.testing.assert_allclose(pc[k], p0[k], rtol=1e-5, err_msg=k)
    for n, g in g0.items():
        torch.testing.assert_close(gc[n], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()))


@pytest.mark.cuda
def test_prefetch_to_device_on_card(cuda_device):
    """Batches come out on the card with their dtypes (uint8 images stay
    uint8) and values, pinned copies ordered before use: a big reduction
    queued on the consumer's stream right after each batch reads the
    copied values; a source exception reaches the consumer."""
    from chore_tpu_torch.data.loader import prefetch_to_device

    rng = np.random.RandomState(0)
    host = [{"images": rng.randint(0, 256, (4, 512, 512, 5)).astype(
        np.uint8), "points": rng.randn(4, 20000, 3).astype(np.float32),
        "path": [f"f{i}"]} for i in range(5)]

    def source():
        yield from host
        raise OSError("disk gone")

    got = []
    it = prefetch_to_device(source(), cuda_device)
    for want in host:
        b = next(it)
        assert b["images"].dtype == torch.uint8 and b["images"].is_cuda
        assert b["path"] == want["path"]
        got.append((int(b["images"].sum(dtype=torch.int64)),
                    float(b["points"].double().sum())))
        np.testing.assert_array_equal(b["images"].cpu().numpy(),
                                      want["images"])
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    for (si, sp), want in zip(got, host):
        assert si == int(want["images"].sum(dtype=np.int64))
        np.testing.assert_allclose(sp, want["points"].astype(np.float64).sum(),
                                   rtol=1e-12)
