"""Per-phase wall-clock timing (``StepTimer`` of
``chore_tpu/utils/profiling.py``)."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StepTimer:
    """Wall-clock accumulator keyed by phase name.

    with timer.phase("encode"): ...
    timer.summary() -> {phase: {count, total_s, mean_ms, max_ms}}
    """

    def __init__(self):
        self._acc = defaultdict(list)

    def reset(self):
        self._acc.clear()

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self):
        out = {}
        for name, ts in self._acc.items():
            out[name] = {
                "count": len(ts),
                "total_s": round(sum(ts), 4),
                "mean_ms": round(1e3 * sum(ts) / len(ts), 3),
                "max_ms": round(1e3 * max(ts), 3),
            }
        return out
