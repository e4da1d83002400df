"""The harness: cells, configurations, traffic kinds and metrics found by
name from files alone; the result line; the trace reading; the check for
JAX in the process."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, run
from portbench.tests.conftest import TINY

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_new_files_alone_add_a_cell(tmp_path):
    """A configuration, a cell, a traffic kind and a per-layer metric that
    are new files, with entries in BENCHMARK.json, run without an edit to
    any file that was there."""
    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(pb / "configs" / "chore-release-f32.json"))
    json.dump({**cfg, "name": "cfg-new"}, open(pb / "configs" /
                                               "cfg-new.json", "w"))
    json.dump({"name": "cell-new", "config": "cfg-new", "chips": 1,
               "traffic": {"kind": "echo", "value": 3.0},
               "limits": {"echo_gap": 0.5}, "why": "a test"},
              open(pb / "workloads" / "cell-new.json", "w"))
    (pb / "traffic" / "echo.py").write_text(
        "def run(r):\n"
        "    with r.window() as win:\n"
        "        win.add(r.cell['traffic']['value'])\n"
        "    return ({'echo_per_s': win.work, 'echo_ms': 2.0}, 1, 0,\n"
        "            lambda: {'echo_gap': 0.25})\n")
    (pb / "metrics" / "echo.layer.py").write_text(
        "def read(ctx):\n    return ctx.readings['echo_ms']\n")
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["cell-new"]})
    bench["per_layer"].append({"name": "echo.layer", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "echo", "moves": "echo_per_s"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    out = run.execute("cell-new", 7, 0.01, 0, device="cpu", root=str(pb))
    assert out["correct"] is True
    assert set(out["metrics"]) == {"echo_per_s", "setup_s"}
    assert out["metrics"]["echo_per_s"]["value"] == 3.0
    assert out["checks"] == {"echo_gap": {"value": 0.25, "limit": 0.5}}
    e2e, layer = harness.cell_metrics(bench, "cell-new")
    assert [m["name"] for m in layer] == ["echo.layer"]
    r = harness.Run("cell-new", {}, {}, 7, 0.01, 0, None)
    got = harness.per_layer(r, layer, {"echo_ms": 2.0}, None, str(pb))
    assert got == {"echo.layer": {"value": 2.0, "unit": "ms"}}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    """The last line's keys, in order, with ``checks`` last; the cell's
    end-to-end metrics untraced, its per-layer metrics traced."""
    out = run.execute("train-staged-f32", 2 ** 31 + 11, 0.5, trace,
                      device="cpu", overrides=TINY,
                      traffic={"trace_steps": 2})
    keys = list(out)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    e2e, layer = harness.cell_metrics(bench, "train-staged-f32")
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in layer}
        assert "train_step_host_ms" in out["metrics"]
        assert dev["window_s"] > 0
        assert len(out["breakdown"]["idle_gaps"]) <= 10
        assert len(out["breakdown"]["device_ops"]) <= 10
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        {"chore_tpu_torch.models": 0, "jaxtyping": 0, "flaxen": 0}) == []
    assert harness.forbidden_modules(
        {"chore_tpu.recon": 0, "jax.numpy": 0, "jaxlib": 0, "flax": 0,
         "chore_tpu_torch": 0}) == ["chore_tpu", "flax", "jax", "jaxlib"]


PROBE = """
import sys
sys.path.insert(0, {root!r})
sys.modules.setdefault("torch.utils.tensorboard", None)
from portbench import harness
{body}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, body=body)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """A whole run (tiny, on the CPU) holds no module whose top-level name
    is jax, jaxlib, flax or chore_tpu."""
    mods = _top_level(
        "from portbench import run\n"
        f"run.execute('train-staged-f32', 5, 0.3, 0, device='cpu', "
        f"overrides={TINY!r}, traffic={{'trace_steps': 2}})")
    assert "chore_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = _top_level(
        "import portbench.reference.field\n"
        "import portbench.flops, portbench.rooflines, portbench.control")
    assert not mods & (set(harness.FORBIDDEN) | {"chore_tpu_torch"})


def test_idle_share_of_a_synthetic_trace():
    """Two steps of 100 us; kernels at 10-50, 40-60 (overlapping) and
    150-190: busy 90 of 200 us, so 55% idle; the gaps named by the
    innermost span open on the host."""
    X = "X"
    ev = [{"ph": X, "name": "portbench.step", "ts": 0, "dur": 100},
          {"ph": X, "name": "portbench.step", "ts": 100, "dur": 100},
          {"ph": X, "name": "portbench.loader_next", "ts": 0, "dur": 8},
          {"ph": X, "name": "portbench.train_step", "ts": 8, "dur": 92},
          {"ph": X, "name": "portbench.train_step", "ts": 100, "dur": 100},
          {"ph": X, "cat": "kernel", "name": "a", "ts": 10, "dur": 40},
          {"ph": X, "cat": "kernel", "name": "b", "ts": 40, "dur": 20},
          {"ph": X, "cat": "gpu_memcpy", "name": "c", "ts": 150, "dur": 40},
          {"ph": X, "cat": "kernel", "name": "outside", "ts": 250,
           "dur": 10}]
    t = harness.read_trace(ev)
    assert t["window_s"] == pytest.approx(200e-6)
    assert t["busy_s"] == pytest.approx(90e-6)
    assert t["steps"] == 2
    assert t["device_ops"][0] == ["a", pytest.approx(40e-6)]
    gaps = [(n, round(s * 1e6)) for n, s in t["idle_gaps"]]
    assert gaps[0] == ("train_step", 90)
    assert sorted(gaps[1:]) == [("loader_next", 10), ("train_step", 10)]
    ctx = harness.Context(harness.Run("x", {}, {}, 0, 1, 0, None), {}, t)
    mod = harness.load_module("metrics", "idle_share.train")
    assert mod.read(ctx) == pytest.approx(55.0)


def test_no_trace_gives_no_metric():
    ctx = harness.Context(harness.Run("x", {}, {}, 0, 1, 0, None), {}, None)
    for name in ("idle_share.train", "train_mfu", "train_step_host_ms"):
        assert harness.load_module("metrics", name).read(ctx) is None
