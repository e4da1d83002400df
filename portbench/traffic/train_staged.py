"""Training with the input pipeline out of the way: ``Trainer.train_step``
over ``batches`` batches made on the card from the seed at set-up, cycled
(``training.synthetic_batch``). The first three steps are the warm-up and
are read for the check; the window runs the same trainer on."""
from __future__ import annotations

from portbench import training


def run(r):
    cfg, dev = r.cfg, r.device
    B = cfg["batch_size"]
    n = r.cell["traffic"]["batches"]
    batches = [training.synthetic_batch(cfg, r.seed, i, dev)
               for i in range(n)]
    params = training.ref.make_params(cfg, r.seed, dev)
    trainer = training.build_trainer(cfg, params, dev, training.exp_dir(r))
    del params
    step = r.spans.wrap("train_step", trainer.train_step)
    first = training.FirstSteps(trainer, cfg, r.seed, dev)
    for i in range(3):
        first.after(step(batches[i])[0])
    prof = r.profiler(r.cell["traffic"]["trace_steps"])
    k = 3
    with r.window() as win:
        while win.open():
            with r.spans.span("step"):
                step(batches[k % n])
            k += 1
            win.add(B)
            if prof is not None:
                prof.step()
    if prof is not None:
        prof.__exit__(None, None, None)
    readings = {"train_images_per_s": win.work / win.seconds,
                "train_peak_gib": r.peak_window / 2 ** 30,
                "steps": win.count, "images_per_step": B}
    first_steps = first.readings()
    del trainer, step, first
    training.free_cuda()
    return readings, win.count, 0, lambda: training.gaps(
        first_steps, training.reference_steps(
            cfg, r.seed, batches[:3], dev))
