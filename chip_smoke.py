#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``chore_tpu_torch``) on one card.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases profile --out DIR  # profiler breakdown

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. card name and power limit, torch/CUDA versions; build every kernel.
  2. kernels: each hand-written kernel against its plain PyTorch version
     on the card, at the main path's shapes and on edge cases.
  3. field: the release-width CHORE field (f32, seeded random weights):
     encode 1x512^2x5, then query 50k points.
  4. fit: ``ReconFitter.fit_batch(use_silhouette=False)`` with the release
     FitConfig/SamplerConfig on a synthetic frame; one warm-up, one timed
     run with per-stage times; every kernel of the path must have launched.
  5. the kernel table as one JSON line, then the result line.

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# distance tolerance of the 1-NN kernel against its plain version: both
# compute |x|^2 - 2x.y + |y|^2 in f32 with different summation orders; at
# |x|^2 ~ 5 (points near z = 2.2) an ulp is ~5e-7, so 5e-5 is ~100 ulps
NN_DIST_TOL = 5e-5

PHASES = ("kernels", "field", "fit")


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps):
    """Mean device ms of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
def nn_cases(torch, dev):
    """(name, x, y, qg, rg) cases: the main path's shapes first."""
    from chore_tpu_torch.ops.nn import group_rows

    g = torch.Generator(device="cpu").manual_seed(0)

    def cloud(b, n, spread=0.3):
        base = torch.tensor([0.0, -0.2, 2.2])
        return (base + spread * torch.randn(b, n, 3, generator=g)).to(dev)

    def labels(b, n, k=14):
        return torch.randint(0, k, (b, n), generator=g).to(dev)

    h, o = cloud(1, 6890), cloud(1, 3000, 0.2)
    gh, go = labels(1, 6890), labels(1, 3000)
    mh = (torch.rand(1, 6890, generator=g) < 0.3).to(dev)
    mo = (torch.rand(1, 3000, generator=g) < 0.4).to(dev)
    cases = []

    def add(name, x, y, y_mask=None, xg=None, yg=None):
        qg, rg = group_rows(x, y, y_mask, xg, yg)
        cases.append((name, x.contiguous(), y.contiguous(), qg, rg))

    # main path: contact h->o and o->h (14 part groups, partial masks),
    # collision o->h ungrouped (recon/losses.py contact_loss/collision)
    add("contact_h2o", h, o, mo, gh, go)
    add("contact_o2h", o, h, mh, go, gh)
    add("collision_o2h", o, h)
    # edge cases
    x, y = cloud(1, 300), cloud(1, 200)
    yg = labels(1, 200, 3)
    xg = labels(1, 300, 4)  # group 3 has no references: sentinel
    add("empty_group", x, y, None, xg, yg)
    add("all_masked", x, y, torch.zeros(1, 200, dtype=torch.bool,
                                        device=dev))
    ydup = torch.cat([y[:, :50], y[:, :50], y[:, 50:]], 1)  # exact dups
    add("duplicates", x, ydup)
    add("ragged_sizes", cloud(1, 1037), cloud(1, 1029))
    add("batch2", cloud(2, 700), cloud(2, 2100), None, labels(2, 700, 5),
        labels(2, 2100, 5))
    return cases


def check_nn(torch, dev):
    from chore_tpu_torch.ops.nn import BIG, nn_sqdist_cuda, nn_sqdist_plain

    worst = 0.0
    for name, x, y, qg, rg in nn_cases(torch, dev):
        d_k, i_k = nn_sqdist_cuda(x, y, qg, rg)
        d_p, i_p = nn_sqdist_plain(x, y, qg, rg)
        torch.cuda.synchronize()
        err = (d_k - d_p).abs().max().item()
        # second-best distance: an index may differ only where the best
        # two are within the tolerance of each other
        xx = (x * x).sum(-1, keepdim=True)
        yy = (y * y).sum(-1)[:, None, :]
        dm = (xx - 2.0 * torch.bmm(x, y.transpose(1, 2)) + yy).clamp_min(0)
        dm = torch.where(qg[:, :, None] == rg[:, None, :], dm,
                         torch.full_like(dm, BIG))
        k = min(2, dm.shape[-1])
        top = torch.topk(dm, k, dim=-1, largest=False).values
        gap = (top[..., 1] - top[..., 0]) if k == 2 else \
            torch.full_like(top[..., 0], BIG)
        sure = gap > NN_DIST_TOL
        bad_idx = int(((i_k != i_p) & sure).sum().item())
        unmatched = d_p >= 0.5 * BIG
        sent_ok = bool(((d_k[unmatched] == BIG) & (i_k[unmatched] == 0))
                       .all().item())
        log(f"  nn_grouped {name}: B={x.shape[0]} N={x.shape[1]} "
            f"M={y.shape[1]} max|d-plain|={err:.3g} idx_mismatch={bad_idx} "
            f"unmatched={int(unmatched.sum())} sentinel_ok={sent_ok}")
        if not (err <= NN_DIST_TOL and bad_idx == 0 and sent_ok):
            raise SystemExit(f"nn_grouped disagrees with plain on {name}")
        if name == "duplicates":
            # exact duplicate references: the lowest index must win
            if bool(((i_k >= 50) & (i_k < 100)).any()):
                raise SystemExit("nn_grouped: duplicate tie not resolved "
                                 "to the lowest index")
        worst = max(worst, err)
    return worst


def time_nn(torch, dev):
    """Kernel, plain and bound for the three launches of one joint step."""
    from chore_tpu_torch.ops.nn import nn_sqdist_cuda, nn_sqdist_plain

    main = [c for c in nn_cases(torch, dev)
            if c[0] in ("contact_h2o", "contact_o2h", "collision_o2h")]

    def run(fn):
        return lambda: [fn(x, y, qg, rg) for _, x, y, qg, rg in main]

    ms = cuda_ms(run(nn_sqdist_cuda), 50)
    plain_ms = cuda_ms(run(nn_sqdist_plain), 20)
    flops = nbytes = 0.0
    for _, x, y, qg, rg in main:
        B, N, M = x.shape[0], x.shape[1], y.shape[1]
        pairs = float((qg[:, :, None] == rg[:, None, :]).sum().item())
        flops += 8.0 * pairs  # 3 FMA dot (6) + 2 add/sub, per pair
        nbytes += 4.0 * B * (3 * N + 3 * M + N + M + N + N)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# --------------------------------------------------------------------- #
# phase 3: the release-width field
FIELD_TOL = 1e-3  # card vs CPU, f32 with TF32 off: conv summation order


def run_field(torch, dev, card):
    from chore_tpu_torch.models.chore import FieldConfig, build_field

    cfg = FieldConfig()  # release: 5 stacks, depth 2, 256 features
    model = build_field(cfg, device=dev, seed=0)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 512, 512, 5).astype(np.float32))
    points = torch.from_numpy((rng.rand(1, 50000, 3) * [2, 2, 0.5]
                               + [-1, -1, 1.95]).astype(np.float32))
    cc = torch.tensor([[1018.0, 779.0]])
    images, points, cc = images.to(dev), points.to(dev), cc.to(dev)

    with torch.no_grad():
        feats, tmpx = model.encode(images, train=False)
        preds = model.query_last(feats, tmpx, points, cc)
        torch.cuda.synchronize()
        enc_ms = cuda_ms(lambda: model.encode(images, train=False), 5)
        q_ms = cuda_ms(lambda: model.query_last(feats, tmpx, points, cc), 10)
    for k, want in (("df", (1, 50000, 2)), ("parts", (1, 50000, 14)),
                    ("pca", (1, 50000, 3, 3)), ("centers", (1, 50000, 6))):
        if tuple(preds[k].shape) != want or not bool(
                torch.isfinite(preds[k]).all()):
            raise SystemExit(f"field: bad {k} {tuple(preds[k].shape)}")
    log(f"  field encode 1x512^2x5: {enc_ms:.3f} ms; query 50k points "
        f"(last stack): {q_ms:.3f} ms = {50000 / q_ms * 1e3 / 1e6:.2f} M "
        f"points/s [{card}]")

    # the same weights on the CPU, small input: the card's numbers agree
    cpu_model = build_field(cfg, device="cpu", seed=0)
    small_i, small_p = images[:, :128, :128].cpu(), points[:, :2000].cpu()
    with torch.no_grad():
        ref = cpu_model(small_i, small_p, cc.cpu(), train=False)[-1]
        got = model(small_i.to(dev), small_p.to(dev), cc, train=False)[-1]
    err = max((got[k].cpu() - ref[k]).abs().max().item() for k in ref)
    log(f"  field card vs CPU (128^2, 2k points): max abs err {err:.3g} "
        f"(tol {FIELD_TOL})")
    if not err <= FIELD_TOL:
        raise SystemExit("field: card disagrees with the CPU")
    return {"encode_ms": enc_ms, "query_ms": q_ms}


# --------------------------------------------------------------------- #
# phase 4: the slice, fit_batch without the silhouette phase
TRACE_TOL = 1e-3  # card vs CPU per-step loss, relative (f32 noise)


class _FixedJitter:
    """Adds one fixed matrix before every SO(3) projection (deterministic
    stand-in for the random SVD jitter, so the card and the CPU take the
    same object steps in the small comparison)."""

    def __init__(self, torch):
        import chore_tpu_torch.ops.rotation as rot
        import chore_tpu_torch.recon.fitter as fit

        self.mods, self.orig = (rot, fit), rot.project_so3
        jit = torch.from_numpy(
            (1e-3 * np.random.RandomState(5).rand(3, 3)).astype(np.float32))
        self.fn = lambda m: self.orig(m + jit.to(m.device))

    def __enter__(self):
        for m in self.mods:
            m.project_so3 = self.fn

    def __exit__(self, *exc):
        for m in self.mods:
            m.project_so3 = self.orig


def synthetic_frame(size):
    rng = np.random.RandomState(0)
    images = rng.rand(1, size, size, 5).astype(np.float32)
    cc = np.array([[1018.0, 779.0]], np.float32)
    pose = (rng.randn(1, 72) * 0.05).astype(np.float32)
    betas = np.zeros((1, 10), np.float32)
    kpts = np.concatenate([np.full((1, 25, 2), size / 2, np.float32),
                           np.ones((1, 25, 1), np.float32)], -1)
    return images, cc, pose, betas, kpts


def make_fitter(dev, field_cfg, fit_cfg, samp_cfg, record=False):
    from chore_tpu_torch.models.chore import build_field
    from chore_tpu_torch.recon.fitter import ReconFitter
    from chore_tpu_torch.smpl import SMPLH, synthetic_smplh
    from chore_tpu_torch.utils.meshio import octasphere

    tv, tf = octasphere(radius=0.18, subdiv=2)
    return ReconFitter(build_field(field_cfg, device=dev, seed=0),
                       SMPLH(synthetic_smplh(), device=dev), tv, tf,
                       cfg=fit_cfg, sampler_cfg=samp_cfg,
                       record_traces=record, device=dev)


def check_small_fit(torch, dev):
    """A small fit on the card (kernel route) and on the CPU (plain route)
    from the same weights and draws: the per-step loss traces agree."""
    from chore_tpu_torch.models.chore import FieldConfig
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.recon.generator import SamplerConfig, make_draws

    fc = FieldConfig(num_stack=2)
    fit = FitConfig(iter_kpts_max=2, iter_obj=2, iter_joint_max=4,
                    steps_per_iter=3, obj_samples=500, net_in_size=64,
                    svd_jitter=False)
    samp = SamplerConfig(num_steps=2, sample_num=512, num_rounds=2,
                         num_points=256)
    frame = synthetic_frame(64)
    g = torch.Generator().manual_seed(1)
    draws = {k: make_draws(samp, 1, g, "cpu") for k in ("human", "object")}
    traces = []
    with _FixedJitter(torch):
        for d in (dev, torch.device("cpu")):
            f = make_fitter(d, fc, fit, samp, record=True)
            dr = {k: {n: v.to(d) for n, v in x.items()}
                  for k, x in draws.items()}
            out = f.fit_batch(*frame, use_silhouette=False, draws=dr)
            traces.append(np.concatenate([
                out[c][p]["loss"].ravel() for c, ps in
                (("smpl_trace", ("global", "pose_kpts")),
                 ("obj_trace", ("obj", "joint"))) for p in ps]))
    a, b = traces
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    log(f"  small fit card vs CPU: {len(a)} steps, max rel trace diff "
        f"{rel.max():.3g} (tol {TRACE_TOL})")
    if not rel.max() <= TRACE_TOL:
        raise SystemExit("fit: card trace disagrees with the CPU trace")


def run_fit(torch, dev, card, nn_mod):
    from chore_tpu_torch.models.chore import FieldConfig
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.recon.generator import SamplerConfig

    check_small_fit(torch, dev)
    fitter = make_fitter(dev, FieldConfig(), FitConfig(),
                         SamplerConfig())
    frame = synthetic_frame(512)

    def run(seed, block):
        g = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        out = fitter.fit_batch(*frame, generator=g, use_silhouette=False,
                               block_per_stage=block)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, warm_s = run(0, False)
    log(f"  fit warm-up: {warm_s:.3f} s")
    fitter.timer.reset()
    nn_mod.launches["nn_grouped"] = 0  # count the main path's run only
    out, sec = run(1, True)
    launches = nn_mod.launches["nn_grouped"]
    stages = {k: v["mean_ms"] for k, v in fitter.timer.summary().items()}
    log(f"  fit (release FitConfig/SamplerConfig, no silhouette): "
        f"{sec:.4f} s/image [{card}]")
    log(f"  stages ms: {json.dumps(stages)} [{card}]")
    log(f"  iterations per phase: {json.dumps(out['iters'])}")
    log(f"  nn_grouped launches in the timed fit: {launches}")
    tensors = [*out["smpl_params"].values(), *out["obj_params"].values(),
               out["obj_R"], out["scale"],
               *[v for pc in out["pclouds"].values() for v in pc.values()
                 if torch.is_floating_point(v)]]
    if not all(bool(torch.isfinite(v).all()) for v in tensors):
        raise SystemExit("fit: non-finite output")
    if launches <= 0:
        raise SystemExit("fit: the main path never launched nn_grouped")
    return {"sec": sec, "stages_ms": stages, "iters": out["iters"],
            "launches": launches}


# --------------------------------------------------------------------- #
# optional phase: where the fit's time goes (torch.profiler)
def run_profile(torch, dev, card, out_dir):
    """A release-width fit with cut iteration budgets under torch.profiler:
    device busy share, and the kernels and host ops that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chore_tpu_torch.models.chore import FieldConfig
    from chore_tpu_torch.recon.fitter import FitConfig
    from chore_tpu_torch.recon.generator import SamplerConfig

    fitter = make_fitter(dev, FieldConfig(),
                         FitConfig(iter_kpts_max=8, iter_obj=4,
                                   iter_joint_max=8), SamplerConfig())
    frame = synthetic_frame(512)
    run = lambda: fitter.fit_batch(  # noqa: E731
        *frame, generator=torch.Generator(device=dev).manual_seed(1),
        use_silhouette=False, block_per_stage=True)
    run()
    torch.cuda.synchronize()
    fitter.timer.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device kernels only: the aten ops that launched them carry the same
    # time again as their own "self device" time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    stages = {k: v["mean_ms"] for k, v in fitter.timer.summary().items()}
    steps = {k: 10 * v for k, v in out["iters"].items()}
    log(f"  profile: cut budgets {json.dumps(out['iters'])} (x10 steps), "
        f"wall {wall:.3f} s under the profiler, device busy "
        f"{busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / wall:.1f}% "
        f"[{card}]")
    log(f"  profile stages ms: {json.dumps(stages)}")
    log(f"  profile ms per step: smpl "
        f"{stages['optimize_smpl'] / (steps['global'] + steps['pose_kpts']):.3f}"
        f", object {stages['optimize_object'] / (steps['obj'] + steps['joint']):.3f}")
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:12]
    log(f"  top kernels ({len(kernels)} distinct, "
        f"{sum(e.count for e in kernels)} launches; ms / launches):")
    for e in top_dev:
        log(f"    {dev_us(e) / 1e3:10.3f} ms {e.count:7d}  {e.key[:90]}")
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
    log("  top host time (self, ms / calls):")
    for e in top_cpu:
        log(f"    {e.self_cpu_time_total / 1e3:10.3f} ms {e.count:7d}  "
            f"{e.key[:90]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_fit.txt"), "w") as f:
            f.write(events.table(sort_by="self_cpu_time_total",
                                 row_limit=60))


# --------------------------------------------------------------------- #
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + ("profile",))
                    + " (profile is off by default)")
    ap.add_argument("--out", default=None,
                    help="directory to write the full profile table to")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + ("profile",))
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "chore_tpu_torch")):
        print("chip_smoke: chore_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.ops import cuda_build
    from chore_tpu_torch.ops import nn as nn_mod

    dev = torch.device("cuda:0")
    use_full_f32()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 1: build every kernel (one nvcc per source, all at once)
    t0 = time.perf_counter()
    secs = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s total, per kernel "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name, out in cuda_build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc[{name}] {line.strip()}")

    kernels = {"nn_grouped": {
        "name": "nn_grouped", "route": "cuda",
        "source": "chore_tpu_torch/csrc/nn_grouped.cu",
        "replaces": "chore_tpu/ops/pallas/nn.py:45",
        "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": None, "library_ms": None}}

    if "kernels" in phases:
        log("phase kernels:")
        kernels["nn_grouped"]["max_abs_err"] = check_nn(torch, dev)
        kernels["nn_grouped"].update(time_nn(torch, dev))
        k = kernels["nn_grouped"]
        log(f"  nn_grouped one joint step (3 launches): kernel "
            f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']}) [{card}]")

    if "field" in phases:
        log("phase field:")
        run_field(torch, dev, card)

    if "fit" in phases:
        log("phase fit:")
        fit = run_fit(torch, dev, card, nn_mod)
        kernels["nn_grouped"]["launches"] = fit["launches"]

    if "profile" in phases:
        log("phase profile:")
        run_profile(torch, dev, card, args.out)

    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
