"""Data-parallel training on every card of the cell, one process each
(``ddp_rank.py``): the gradient all-reduce of ``DistributedDataParallel``,
each rank fed its own staged batches. The global batch is the ranks'
batches together; the check follows the first three steps on the joined
global batch."""
from __future__ import annotations

import multiprocessing as mp
import socket

from portbench import ddp_rank, training


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(r):
    world = r.cell["chips"]
    port = free_port()
    spec = {"name": r.name, "cell": r.cell, "cfg": r.cfg, "seed": r.seed,
            "seconds": r.seconds, "trace": r.trace, "tmp": r.tmp,
            "device": r.device.type}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ddp_rank.child, args=(k, world, port, spec))
             for k in range(1, world)]
    for p in procs:
        p.start()
    try:
        readings, first_steps, steps = ddp_rank.run_rank(
            0, world, port, spec, r)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"a rank failed: {[p.exitcode for p in procs]}")
    cfg, dev = r.cfg, r.device
    n = r.cell["traffic"]["batches"]

    def check():
        import torch

        joined = []
        for i in range(3):
            shards = [training.synthetic_batch(cfg, r.seed, q * n + i, dev)
                      for q in range(world)]
            joined.append({k: torch.cat([s[k] for s in shards])
                           for k in shards[0]})
        return training.gaps(first_steps, training.reference_steps(
            cfg, r.seed, joined, dev))

    return readings, steps, 0, check
