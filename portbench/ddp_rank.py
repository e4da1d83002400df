"""One rank of a data-parallel training cell (``traffic/train_ddp.py``):
a process per card in one ``torch.distributed`` group (NCCL on the cards,
gloo on the CPU) joined at ``tcp://localhost:<port>``, beside a gloo group
that carries the harness's own decisions and readings without a device
synchronize. Each rank runs under the port's ``Trainer``, which wraps the
field in ``DistributedDataParallel``, fed ``batches`` batches of its own
made on its card from (seed, rank) and cycled, as ``train_staged`` does.
Rank 0 (the process that prints the result) decides when the window
closes; every rank steps until then.

After the window each rank frees its program state and sends rank 0 its
readings and the forbidden modules (``harness.FORBIDDEN``) it holds; rank
0 refuses the run if any rank holds one. A traffic parameter ``rank_hook``
(``module:function``, called with the rank's parameters before anything is
built) lets a test plant a fault in every rank.
"""
from __future__ import annotations

import importlib
import os

from portbench import harness, training


def child(rank, world, port, spec):
    """Entry of ranks 1..world-1 (spawned processes)."""
    import sys

    sys.modules.setdefault("torch.utils.tensorboard", None)
    run_rank(rank, world, port, spec)


def run_rank(rank, world, port, spec, r=None):
    """One rank's whole run; rank 0 passes its harness ``Run`` and gets
    back (readings over the ranks, first-step readings, the window's
    steps)."""
    import torch
    import torch.distributed as dist

    from chore_tpu_torch.parallel import init_distributed

    t = spec["cell"]["traffic"]
    if t.get("rank_hook"):
        mod, fn = t["rank_hook"].split(":")
        getattr(importlib.import_module(mod), fn)(rank, world)
    dev = init_distributed(
        f"tcp://localhost:{port}", world, rank,
        device=(f"cuda:{rank}" if spec["device"] == "cuda" else "cpu"))
    if r is None:
        r = harness.Run(spec["name"], spec["cell"], spec["cfg"],
                        spec["seed"], spec["seconds"], spec["trace"], dev,
                        tmp=os.path.join(spec["tmp"], f"rank{rank}"))
    else:
        r.device = dev
        r.tmp = os.path.join(spec["tmp"], "rank0")
    os.makedirs(r.tmp, exist_ok=True)
    ctrl = dist.new_group(backend="gloo")
    cfg = r.cfg
    n = t["batches"]
    batches = [training.synthetic_batch(cfg, r.seed, rank * n + i, dev)
               for i in range(n)]
    params = training.ref.make_params(cfg, r.seed, dev)
    trainer = training.build_trainer(cfg, params, dev,
                                     os.path.join(r.tmp, "exp"))
    del params
    step = r.spans.wrap("train_step", trainer.train_step)
    first = training.FirstSteps(trainer, cfg, r.seed, dev)
    for i in range(3):
        first.after(step(batches[i])[0])
    prof = r.profiler(t["trace_steps"])
    B = cfg["batch_size"]

    def still_open(win):
        flag = torch.tensor([int(win.open()) if rank == 0 else 0])
        dist.broadcast(flag, 0, group=ctrl)
        return bool(flag.item())

    dist.barrier(group=ctrl)
    k = 3
    with r.window() as win:
        while still_open(win):
            with r.spans.span("step"):
                loss, _ = step(batches[k % n])
            k += 1
            if trainer.global_step % 50 == 0:
                float(loss)
            win.add(B * world)
            if prof is not None:
                prof.step()
    if prof is not None:
        prof.__exit__(None, None, None)
    first_steps = first.readings()
    del trainer, step, first, batches
    training.free_cuda()
    mine = {"peak": max(r.peak_before, r.peak_window),
            "peak_window": r.peak_window, "spans": r.spans.spans,
            "trace": (harness.load_trace(r.trace_path) if r.trace_path
                      else None),
            "forbidden": harness.forbidden_modules()}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine, group=ctrl)
    dist.barrier(group=ctrl)
    dist.destroy_process_group()
    if rank:
        return None
    found = {k: q["forbidden"] for k, q in enumerate(ranks) if q["forbidden"]}
    if found:
        raise SystemExit(f"ranks hold forbidden modules after the window "
                         f"(rank: modules): {found}")
    readings = {"train_images_per_s": win.work / win.seconds,
                "train_peak_gib": max(q["peak_window"] for q in ranks)
                / 2 ** 30,
                "steps": win.count, "images_per_step": B * world}
    r.peak_before = max(q["peak"] for q in ranks)
    r.spans.spans = {k: [d for q in ranks for d in q["spans"].get(k, [])]
                     for k in mine["spans"]}
    if r.trace:
        traces = [q["trace"] for q in ranks]
        r.trace_summary = {
            **traces[0],
            "busy_s": sum(q["busy_s"] for q in traces) / world,
            "window_s": sum(q["window_s"] for q in traces) / world}
    return readings, first_steps, win.count
