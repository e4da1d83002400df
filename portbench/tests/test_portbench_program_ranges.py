"""The program's own profiler ranges in the benchmark's trace: the port's
trainer marks each step's phases as ``chore.train.<phase>`` ranges while a
profiler records. They lie inside the harness's ``portbench.train_step``
spans, and what the harness reads from the trace (the window, the
device's busy time, the steps, the device operations and the idle gaps,
which ``train_mfu``, ``idle_share.train`` and the breakdown take) is the
same with and without them."""
from __future__ import annotations

import json

import pytest

from portbench import harness, run
from portbench.tests.conftest import TINY

PHASES = ("forward", "loss", "backward", "optimizer")


def without_program_ranges(events):
    return [e for e in events if not e.get("name", "").startswith("chore.")]


def test_program_ranges_leave_the_readings_alone():
    """Two steps of 100 us with kernels and gaps in and between the
    phases. Each phase is a host range (``user_annotation``) and, as on
    the card, a device range (``gpu_user_annotation``) spanning the
    kernels it launched: every reading is equal with the ranges and
    without, and the window, busy time, steps and device operations are
    the kernels' and copies' alone."""
    X = "X"
    ev = [{"ph": X, "name": "portbench.step", "ts": 0, "dur": 100},
          {"ph": X, "name": "portbench.step", "ts": 100, "dur": 100},
          {"ph": X, "name": "portbench.train_step", "ts": 2, "dur": 98},
          {"ph": X, "name": "portbench.train_step", "ts": 100, "dur": 100},
          {"ph": X, "cat": "kernel", "name": "a", "ts": 10, "dur": 40},
          {"ph": X, "cat": "kernel", "name": "b", "ts": 40, "dur": 20},
          {"ph": X, "cat": "gpu_memcpy", "name": "c", "ts": 150, "dur": 40},
          {"ph": X, "cat": "kernel", "name": "outside", "ts": 250,
           "dur": 10}]
    ranges = []
    for t0 in (2, 100):
        for name, s, e in zip(PHASES, (0, 30, 40, 85), (30, 40, 85, 98)):
            ranges.append({"ph": X, "cat": "user_annotation",
                           "name": f"chore.train.{name}",
                           "ts": t0 + s, "dur": e - s})
    # the device's copies of the ranges: from the first kernel a phase
    # launched to the end of its last, the first step's forward over both
    # kernels, the second step's backward over the copy, and one that
    # runs past the window's end
    for name, ts, dur in (("forward", 10, 50), ("backward", 150, 40),
                          ("optimizer", 195, 70)):
        ranges.append({"ph": X, "cat": "gpu_user_annotation",
                       "name": f"chore.train.{name}", "ts": ts, "dur": dur})
    plain = harness.read_trace(ev)
    assert harness.read_trace(ev + ranges) == plain
    assert plain["steps"] == 2
    assert plain["window_s"] == pytest.approx(200e-6, rel=1e-12)
    # [10, 60] and [150, 190]
    assert plain["busy_s"] == pytest.approx(90e-6, rel=1e-12)
    assert [n for n, _ in plain["device_ops"]] == ["a", "c", "b"]
    assert [t for _, t in plain["device_ops"]] == pytest.approx(
        [40e-6, 40e-6, 20e-6], rel=1e-12)


def test_a_traced_run_holds_the_step_phases(monkeypatch):
    """A traced run (tiny, on the CPU): each traced step's four phases, in
    order, inside its ``portbench.train_step`` span and covering nearly
    all of it; the readings equal with the phases left out."""
    seen = {}
    load = harness.load_trace

    def keep(path):
        with open(path) as f:
            data = json.load(f)
        seen["events"] = (data["traceEvents"] if isinstance(data, dict)
                          else data)
        return load(path)

    monkeypatch.setattr(harness, "load_trace", keep)
    out = run.execute("train-staged-f32", 2 ** 31 + 13, 1.0, 1,
                      device="cpu", overrides=TINY,
                      traffic={"trace_steps": 2})
    assert out["correct"] is True
    assert "train_step_host_ms" in out["metrics"]
    ev = [e for e in seen["events"] if e.get("ph") == "X"]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e["name"] == "portbench.train_step")
    phases = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e["name"].startswith("chore."))
    assert steps and len(phases) == len(PHASES) * len(steps)
    for s0, s1 in steps:
        inner = [p for p in phases if s0 <= p[0] and p[1] <= s1]
        assert [p[2] for p in inner] == [f"chore.train.{n}" for n in PHASES]
        assert sum(p[1] - p[0] for p in inner) >= 0.9 * (s1 - s0)
    assert (harness.read_trace(seen["events"])
            == harness.read_trace(without_program_ranges(seen["events"])))
