"""The port's spans (``utils/profiling.py::StepTimer``) in the trainer and
the evaluator, on the CPU at the tiny training field of
``tests/test_torch_port_train.py``:

* one ``Trainer.train_step`` times ``forward``, ``loss``, ``backward`` and
  ``optimizer`` once each; the ``DistributedDataParallel`` construction is
  ``ddp_init``, there only with several processes;
* under ``torch.profiler`` each phase is the range ``chore.<scope>.<phase>``
  of the trace, in the step's order, around the ops it ran;
* with no profiler recording, no ``record_function`` is entered;
* the running sums give what the samples give (count, total, mean, max,
  first), also with phases timed from many threads at once;
* ``chip_smoke.py``'s profiled device time counts the card's kernels and
  copies, not the ranges' copies on the card's trace.
"""
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_port_util import (
    TRAIN_FIELD,
    few_torch_threads,  # noqa: F401 - a fixture
    train_batch,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

PHASES = ["forward", "loss", "backward", "optimizer"]


def make_trainer(exp_dir):
    from chore_tpu_torch.models.chore import FieldConfig, build_field
    from chore_tpu_torch.train import Trainer

    model = build_field(FieldConfig(**TRAIN_FIELD), device="cpu",
                        trainable=True)
    return Trainer(model, str(exp_dir), ck_period_min=1e9)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    # the metrics logger without TensorBoard, whose first import takes
    # ~12 s of one core; no step logs to it
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield make_trainer(tmp_path_factory.mktemp("exp"))


@pytest.fixture(scope="module")
def batch():
    return train_batch(np.random.RandomState(0))


def test_a_step_times_each_phase_once(trainer, batch):
    trainer.timer.reset()
    trainer.train_step(batch)
    s = trainer.timer.summary()
    assert sorted(s) == sorted(PHASES)  # no ddp_init with one process
    for name in PHASES:
        assert s[name]["count"] == 1
        assert s[name]["first_s"] == pytest.approx(
            s[name]["total_s"], abs=1e-4)


def test_phases_are_ranges_of_the_trace_in_order(trainer, batch):
    """Inside one step: forward, loss, backward, optimizer, one after the
    other, each around its own work (the convolutions, their backward,
    Adam's step)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(batch)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("step"):
            trainer.train_step(batch)
    ev = list(prof.events())
    step = next(e.time_range for e in ev if e.name == "step")
    spans = sorted((e for e in ev if e.name.startswith("chore.")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in spans] == [f"chore.train.{p}" for p in PHASES]
    assert step.start <= spans[0].time_range.start
    assert spans[-1].time_range.end <= step.end
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    by_phase = dict(zip(PHASES, (e.time_range for e in spans)))

    def inside(op, phase):
        r = by_phase[phase]
        return any(e.name == op and r.start <= e.time_range.start
                   and e.time_range.end <= r.end for e in ev)

    assert inside("aten::convolution", "forward")
    assert inside("aten::convolution_backward", "backward")
    assert not inside("aten::convolution_backward", "forward")
    assert any(inside(e.name, "optimizer") for e in ev
               if e.name.startswith("Optimizer.step"))


def test_no_range_without_a_profiler(trainer, batch, monkeypatch):
    """Off the profiler the step's phases enter no ``record_function``
    (~13 us each), and still time themselves. (PyTorch's optimizer
    enters its own through ``torch.autograd.profiler``, as before.)"""
    def refuse(*a, **k):
        raise AssertionError("record_function entered off the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trainer.timer.reset()
    trainer.train_step(batch)
    assert {k: v["count"] for k, v in trainer.timer.summary().items()} == {
        p: 1 for p in PHASES}


def test_ddp_init_times_the_wrapper(tmp_path, batch, monkeypatch):
    """With several processes the Trainer wraps the field in
    ``DistributedDataParallel`` inside the ``ddp_init`` phase (here a
    one-process gloo group that the Trainer is told is larger)."""
    import chore_tpu_torch.train.trainer as trainer_mod

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(trainer_mod, "process_count", lambda: 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        tr = make_trainer(tmp_path / "exp")
        assert isinstance(tr.net, torch.nn.parallel.DistributedDataParallel)
        assert list(tr.timer.summary()) == ["ddp_init"]
        tr.train_step(batch)
        s = tr.timer.summary()
        assert {k: v["count"] for k, v in s.items()} == {
            "ddp_init": 1, **{p: 1 for p in PHASES}}
    finally:
        dist.destroy_process_group()


def samples_summary(ts):
    """What the timer gave when it kept every sample."""
    return {"count": len(ts), "total_s": round(sum(ts), 4),
            "mean_ms": round(1e3 * sum(ts) / len(ts), 3),
            "max_ms": round(1e3 * max(ts), 3), "first_s": round(ts[0], 6)}


@pytest.mark.parametrize("kind", ["one", "many", "slow_first", "slow_last"])
def test_running_sums_match_the_samples(kind, monkeypatch):
    """Durations fed through a fake clock: the summary of the running
    sums equals the samples' (the same additions in the same order)."""
    from chore_tpu_torch.utils import profiling

    rng = np.random.RandomState(len(kind))
    ts = {"one": [0.0123456789],
          "many": list(rng.exponential(0.01, 5000)),
          "slow_first": [2.5] + list(rng.uniform(0.3, 0.4, 200)),
          "slow_last": list(rng.uniform(1e-5, 1e-4, 300)) + [0.75]}[kind]
    ticks = np.cumsum([0.0] + [x for t in ts for x in (t, 1.0)])
    clock = iter(ticks.tolist())
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer("test")
    for _ in ts:
        with timer.phase("a"):
            pass
    # each sample as the clock gives it: the end tick less the start tick
    got = [float(e - s) for s, e in zip(ticks[0::2], ticks[1::2])]
    assert timer.summary() == {"a": samples_summary(got)}
    assert timer.summary()["a"]["first_s"] == round(ts[0], 6)


def test_reset_starts_afresh():
    from chore_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer("test")
    with timer.phase("a"):
        pass
    timer.reset()
    assert timer.summary() == {}
    with timer.phase("b"):
        pass
    assert list(timer.summary()) == ["b"]
    assert timer.summary()["b"]["count"] == 1


def test_phases_from_many_threads_all_count():
    """More threads than cores, switching often, each timing phases of the
    same names: no sample is lost from the shared sums."""
    from chore_tpu_torch.utils.profiling import StepTimer

    timer, n_threads, n_each = StepTimer("test"), 16, 400
    interval = sys.getswitchinterval()

    def work():
        for i in range(n_each):
            with timer.phase("ab"[i % 2]):
                pass

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    s = timer.summary()
    assert s["a"]["count"] == s["b"]["count"] == n_threads * n_each // 2


def test_the_evaluators_stages_are_ranges():
    """The evaluation's stages are ``chore.eval.*`` ranges under a
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from chore_tpu_torch.recon.evaluate import _aligned_chamfer

    g = torch.Generator().manual_seed(0)
    pts = [torch.rand(64, 3, generator=g) for _ in range(4)]
    verts = torch.rand(30, 3, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _aligned_chamfer(*pts, verts, verts + 0.01)
    names = [e.name for e in prof.events() if e.name.startswith("chore.")]
    assert names == ["chore.eval.procrustes", "chore.eval.chamfer"]


def test_chip_smokes_device_time_leaves_the_ranges_out():
    """``chip_smoke.py``'s profiled readings (busy share, launches, top
    kernels) sum the device's entries of ``key_averages()``. The card's
    trace repeats each program range as a user annotation that spans the
    kernels it launched (as it does the optimizer's own range): those are
    left out, the kernels and copies kept. The attribute they are told by
    is checked on a real trace."""
    import importlib.util
    import os
    from types import SimpleNamespace as Avg

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chore_tpu_torch.utils.profiling import StepTimer

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with StepTimer("train").phase("backward"):
            torch.ones(4).sum()
    ranges = [e for e in prof.key_averages() if e.key.startswith("chore.")]
    assert [(e.key, e.is_user_annotation) for e in ranges] == [
        ("chore.train.backward", True)]

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    kernel = Avg(key="sm90_xmma_gemm_bf16", device_type=cuda,
                 is_user_annotation=False)
    copy = Avg(key="Memcpy HtoD (Pageable -> Device)", device_type=cuda,
               is_user_annotation=False)
    on_card = Avg(key="chore.train.backward", device_type=cuda,
                  is_user_annotation=True)
    on_host = Avg(key="chore.train.backward", device_type=cpu,
                  is_user_annotation=True)
    host_op = Avg(key="aten::mm", device_type=cpu, is_user_annotation=False)
    step = Avg(key="Optimizer.step#Adam.step", device_type=cuda,
               is_user_annotation=True)
    assert smoke.device_kernels(
        [on_card, kernel, on_host, step, copy, host_op]) == [kernel, copy]
