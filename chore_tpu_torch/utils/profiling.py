"""Tracing and per-phase wall-clock timing, each phase also a named
range of the trace (counterpart of ``chore_tpu/utils/profiling.py``)."""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """A ``torch.profiler`` trace of the block (host, and the card's kernels
    when there is one) written to LOGDIR/trace.json (Chrome trace format:
    chrome://tracing or Perfetto), with the per-op table in
    LOGDIR/ops.txt. No-op when disabled or ``logdir`` is None."""
    if not enabled or logdir is None:
        yield
        return
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


class StepTimer:
    """Wall-clock accumulator keyed by phase name, the port's one span
    facility; ``scope`` names its owner ("train", "fit", "eval").

    with timer.phase("encode"): ...
    timer.summary() -> {phase: {count, total_s, mean_ms, max_ms, first_s}}

    While a ``torch.profiler`` records, each phase is also the range
    ``chore.<scope>.<name>`` of its trace, on the clock of the kernels it
    launched. When none records, no range is entered: a
    ``record_function`` costs ~15 us to enter and leave, the check well
    under 1 us. Each phase keeps running sums, so memory stays constant
    over a long run; ``first_s`` is its first duration (a first call
    holds cuDNN's algorithm search and the allocator's growth). Phases
    may be timed from several threads at once (the evaluator's pool):
    each records its own wall time.
    """

    def __init__(self, scope):
        self.scope = scope
        self._acc = {}  # name -> [count, total, max, first] in seconds
        self._lock = threading.Lock()

    def reset(self):
        """Forget every phase, e.g. at the start of a measured window."""
        with self._lock:
            self._acc.clear()

    @contextlib.contextmanager
    def phase(self, name):
        span = (torch.profiler.record_function(f"chore.{self.scope}.{name}")
                if torch.autograd._profiler_enabled()
                else contextlib.nullcontext())
        with span:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0)

    def _add(self, name, dt):
        with self._lock:
            acc = self._acc.setdefault(name, [0, 0.0, 0.0, dt])
            acc[0] += 1
            acc[1] += dt
            acc[2] = max(acc[2], dt)

    def summary(self):
        with self._lock:
            items = [(k, tuple(v)) for k, v in self._acc.items()]
        return {name: {"count": n,
                       "total_s": round(total, 4),
                       "mean_ms": round(1e3 * total / n, 3),
                       "max_ms": round(1e3 * peak, 3),
                       "first_s": round(first, 6)}
                for name, (n, total, peak, first) in items}

    def report(self, path=None):
        """``summary()``, also written to ``path`` as JSON when given."""
        s = self.summary()
        if path:
            with open(path, "w") as f:
                json.dump(s, f, indent=2)
        return s
