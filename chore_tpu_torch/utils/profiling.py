"""Tracing, named regions, matmul/conv FLOP counts and per-phase
wall-clock timing (counterpart of ``chore_tpu/utils/profiling.py``)."""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """A ``torch.profiler`` trace of the block (host, and the card's kernels
    when there is one) written to LOGDIR/trace.json (Chrome trace format:
    chrome://tracing or Perfetto), with the per-op table in
    LOGDIR/ops.txt. No-op when disabled or ``logdir`` is None."""
    if not enabled or logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60))


def annotate(name):
    """A named region on the ``torch.profiler`` timeline (and an NVTX range
    on the card's trace): ``with annotate("encode"): ...``."""
    import torch

    return torch.profiler.record_function(name)


def flops_estimate(fn, *args, **kwargs):
    """FLOPs of the matmuls and convolutions that ``fn(*args, **kwargs)``
    runs, 2 per multiply-accumulate (``torch.utils.flop_counter``), the
    convention MFU figures use; elementwise and reduction work is left
    out. Unlike ``chore_tpu``'s, which traces the function, this runs it
    once (give it small inputs, or tensors on the meta device)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


class StepTimer:
    """Wall-clock accumulator keyed by phase name.

    with timer.phase("encode"): ...
    timer.summary() -> {phase: {count, total_s, mean_ms, max_ms}}

    Phases may be timed from several threads at once (the evaluator's
    pool): each records its own wall time.
    """

    def __init__(self):
        self._acc = defaultdict(list)
        self._lock = threading.Lock()

    def reset(self):
        self._acc.clear()

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._acc[name].append(dt)

    def summary(self):
        out = {}
        with self._lock:
            items = [(k, list(v)) for k, v in self._acc.items()]
        for name, ts in items:
            out[name] = {
                "count": len(ts),
                "total_s": round(sum(ts), 4),
                "mean_ms": round(1e3 * sum(ts) / len(ts), 3),
                "max_ms": round(1e3 * max(ts), 3),
            }
        return out

    def report(self, path=None):
        """``summary()``, also written to ``path`` as JSON when given."""
        s = self.summary()
        if path:
            with open(path, "w") as f:
                json.dump(s, f, indent=2)
        return s
