#!/usr/bin/env python3
"""Run one cell of the benchmark of ``chore_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with as many CUDA devices as the
cell asks for. Set-up (imports, weights and inputs made from the seed,
the warm-up of every shape the cell uses) is timed as ``setup_s``; then the
cell's traffic runs for ``--seconds``; then the program's state is freed
and what the timed path produced is compared with the plain reference
(``reference/``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit (also the last lines of standard error).

Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, when the program is missing, and when the process
holds ``jax``, ``jaxlib``, ``flax`` or ``chore_tpu`` after the window.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cache_env(root=ROOT):
    """Every build and kernel cache at a fixed path inside the checkout;
    a library that would load JAX by itself is told not to."""
    cache = os.path.join(root, "portbench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(name, seed, seconds, trace, device=None, overrides=None,
            traffic=None, t0=T0, root=HERE):
    """One run of cell ``name``: returns the result object. ``device``,
    ``overrides`` (configuration keys replaced) and ``traffic`` (traffic
    parameters replaced) are for the CPU tests; a run from the command
    line takes the card."""
    sys.path.insert(0, os.path.dirname(root))
    # the trainer's optional TensorBoard logger (which logs nothing in a
    # train_step) would import TensorFlow and, with it, JAX: it is kept
    # out, and the logger falls back to its JSONL file
    sys.modules.setdefault("torch.utils.tensorboard", None)
    import torch

    from portbench import harness

    bench = harness.load_json(os.path.dirname(root), "BENCHMARK.json")
    cell, cfg = harness.load_cell(name, root)
    cfg = {**cfg, **(overrides or {})}
    cell = {**cell, "traffic": {**cell["traffic"], **(traffic or {})}}
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{name} needs {cell['chips']} CUDA devices, "
                             f"{torch.cuda.device_count()} present")
        device = "cuda"
    device = torch.device(device)
    import chore_tpu_torch  # noqa: F401  (a checkout without it fails here)

    e2e, layer = harness.cell_metrics(bench, name)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        r = harness.Run(name, cell, cfg, seed, seconds, trace, device,
                        t0=t0, tmp=tmp)
        traffic = harness.load_module("traffic", cell["traffic"]["kind"],
                                      root)
        readings, attempted, failed, check = traffic.run(r)
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": cell["chips"],
               "memory_peak_bytes": max(r.peak_before, r.peak_window)}
        dev.update(card_limits(device))
        t_check = time.perf_counter()
        values = check()
        print(f"setup_s {r.setup_s:.3f} window_s {r.window_s:.3f} "
              f"check_s {time.perf_counter() - t_check:.3f}",
              file=sys.stderr)
        found = harness.forbidden_modules()
        if found:
            raise SystemExit(f"the process holds {found} after the window")
        from portbench import training

        checks, correct = training.checks(cell, values)
        readings["setup_s"] = r.setup_s
        out = {"correct": bool(correct and failed == 0),
               "attempted": attempted, "failed": failed}
        if trace:
            tr = r.trace_summary or (harness.load_trace(r.trace_path)
                                     if r.trace_path else None)
            if tr is None:
                raise SystemExit("the trace holds no step of the window")
            out["metrics"] = harness.per_layer(r, layer, readings, tr, root)
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
            out["device"] = dev
            out["breakdown"] = {"device_ops": tr["device_ops"],
                                "idle_gaps": tr["idle_gaps"]}
        else:
            missing = [m["name"] for m in e2e if m["name"] not in readings]
            if missing:
                raise SystemExit(f"{traffic.__name__} measured no {missing}")
            out["metrics"] = {m["name"]: {"value": float(readings[m["name"]]),
                                          "unit": m["unit"]} for m in e2e}
            out["device"] = dev
        out["checks"] = {c["name"]: {"value": c["value"],
                                     "limit": c["limit"]} for c in checks}
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    return out


def card_limits(device):
    """The card's power limit as ``nvidia-smi`` reads it (W), where it
    can."""
    import subprocess

    if device.type != "cuda":
        return {}
    try:
        q = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return {"power_limit_w": float(q.stdout.strip().splitlines()[0])}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {}


def main(argv=None):
    args = parse(argv)
    cache_env()
    out = execute(args.workload, args.seed, args.seconds, args.trace)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
