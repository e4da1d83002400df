"""The benchmark's own machinery, shared by every cell: finding a cell, its
configuration, traffic kind and per-layer metrics by name; spans; the
measured window; reading the profiler's trace; the result line.

A cell is ``workloads/<name>.json``: its configuration, chips, traffic
kind, the traffic's parameters, the limits of its correctness check and
``why``. A configuration is ``configs/<name>.json``. A traffic kind is
``traffic/<kind>.py`` with ``run(r)``; a per-layer metric is
``metrics/<name>.py`` with ``read(ctx)``, which returns a number or None
(nothing to read). ``BENCHMARK.json`` says which metrics a cell reports.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level modules that no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "chore_tpu")
TRACE_PREFIX = "portbench."


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name, root=HERE):
    """(cell, configuration) of the workload ``name``."""
    path = os.path.join(root, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise SystemExit(f"no workload {name!r} ({path})")
    cell = load_json(path)
    cfg = load_json(root, "configs", f"{cell['config']}.json")
    return cell, cfg


def load_module(kind, name, root=HERE):
    """``<root>/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded by path)."""
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell_name):
    """(end-to-end metrics, per-layer metrics) that ``BENCHMARK.json``
    has the cell report: a metric with ``workloads`` where it lists the
    cell; a per-layer one without it wherever its ``moves`` is
    reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``chore_tpu_torch`` is not ``chore_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host-clock spans around the calls into each layer, kept in memory;
    under a profiler each is also a ``portbench.<name>`` range of its
    trace."""

    def __init__(self, traced=False):
        self.traced = traced
        self.open_from = None  # only spans starting after this are kept
        self.spans: dict = {}

    @contextlib.contextmanager
    def span(self, name):
        rf = None
        if self.traced:
            import torch

            rf = torch.profiler.record_function(TRACE_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            if self.open_from is not None and t0 >= self.open_from:
                self.spans.setdefault(name, []).append(t1 - t0)

    def wrap(self, name, fn):
        def call(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return call


class Window:
    """The measured window: ``open()`` is true until ``seconds`` have
    passed since it started; the work counted inside it and its length up
    to the synchronize that ends it."""

    def __init__(self, run):
        self.run = run
        self.count = 0
        self.work = 0.0
        self.start = self.end = None

    def __enter__(self):
        import torch

        r = self.run
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
            r.peak_before = torch.cuda.max_memory_allocated(r.device)
            torch.cuda.reset_peak_memory_stats(r.device)
        self.start = time.perf_counter()
        r.setup_s = self.start - r.t0
        r.spans.open_from = self.start
        return self

    def open(self):
        return time.perf_counter() - self.start < self.run.seconds

    def add(self, work):
        """One step of ``work`` (images) done in the window."""
        self.count += 1
        self.work += work

    def __exit__(self, *exc):
        import torch

        r = self.run
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
            r.peak_window = torch.cuda.max_memory_allocated(r.device)
        self.end = time.perf_counter()
        r.window_s = self.end - self.start
        r.spans.open_from = math.inf

    @property
    def seconds(self):
        return self.end - self.start


class Run:
    """What a traffic kind's ``run`` is handed: the cell, its
    configuration, the seed, the window's length, whether to trace, the
    device; spans, a scratch directory in ``TMPDIR``, and the readings it
    returns."""

    def __init__(self, name, cell, cfg, seed, seconds, trace, device,
                 t0=None, tmp=None):
        self.name, self.cell, self.cfg = name, cell, cfg
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace)
        self.device = device
        self.t0 = time.perf_counter() if t0 is None else t0
        self.spans = Spans(traced=self.trace)
        self.tmp = tmp
        self.setup_s = self.window_s = None
        self.peak_before = self.peak_window = 0
        self.trace_path = None
        self.trace_summary = None  # set where the ranks' traces are merged

    def window(self):
        return Window(self)

    def profiler(self, steps):
        """Under ``--trace 1``, a started ``torch.profiler`` that records
        ``steps`` steps after one to skip and one to warm up (call
        ``.step()`` after each step of the window); else None."""
        if not self.trace:
            return None
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        self.trace_path = os.path.join(self.tmp, "trace.json")

        def ready(p):
            p.export_chrome_trace(self.trace_path)

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, on_trace_ready=ready,
                       schedule=schedule(wait=1, warmup=1, active=steps,
                                         repeat=1))
        prof.__enter__()
        del torch
        return prof


# --------------------------------------------------------------- the trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals):
    """Merge (start, end) intervals; returns them sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(events):
    """From chrome-trace events: the traced window (the first to the last
    ``portbench.step`` range), the device's busy seconds in it (the union
    of kernel, copy and set intervals), the device operations that took
    most time and the longest idle gaps, each gap named by the innermost
    ``portbench.`` span that was open on the host at its middle. None
    when the trace holds no step."""
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == TRACE_PREFIX + "step"]
    if not steps:
        return None
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    dev = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e["name"])
           for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and e["ts"] < w1
           and e["ts"] + e["dur"] > w0]
    busy = union([(s, e) for s, e, _ in dev if e > s])
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"][len(TRACE_PREFIX):])
            for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith(TRACE_PREFIX)]
    gaps, at = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)

    def doing(t):
        inner = [h for h in host if h[0] <= t <= h[1]]
        return (min(inner, key=lambda h: (h[2] == "step", h[1] - h[0]))[2]
                if inner else "outside any span")

    named: dict = {}
    for s, e in gaps:
        named.setdefault(doing(0.5 * (s + e)), []).append((e - s) * 1e-6)
    longest = sorted(((n, g) for n, gs in named.items() for g in gs),
                     key=lambda x: -x[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "steps": len(steps),
        "device_ops": sorted(([n, t * 1e-6] for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[n, g] for n, g in longest],
    }


def load_trace(path):
    with open(path) as f:
        data = json.load(f)
    return read_trace(data["traceEvents"] if isinstance(data, dict)
                      else data)


# ---------------------------------------------------------------- metrics
class Context:
    """What a per-layer metric reads: the window's spans (seconds per
    call, by name), the trace summary (or None), the traffic's readings,
    the cell and its configuration."""

    def __init__(self, run, readings, trace):
        self.spans = run.spans.spans
        self.trace = trace
        self.readings = readings
        self.cell, self.cfg = run.cell, run.cfg

    def mean_ms(self, name):
        calls = self.spans.get(name)
        return 1e3 * statistics.fmean(calls) if calls else None


def per_layer(run, metrics, readings, trace, root=HERE):
    ctx = Context(run, readings, trace)
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"], root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_lines(checks):
    """``name value limit`` lines of the numbers compared."""
    return [f"{c['name']} {c['value']!r} limit {c['limit']!r}"
            for c in checks]
