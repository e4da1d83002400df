"""How far the synthetic learning check's object error moves with the
trained field and with planted faults, on the card (``--device cpu``: on
the host).

``chore_tpu_torch.tools.e2e_synthetic``'s scenes (8 frames) in a fresh
temporary directory; a field trained as the tool trains it (2 stacks,
256^2, 500 epochs) or loaded; then frame 0 fitted four times, the crop
centre moved by k x 1e-3 px (k = 0..3), each scored by the tool's
evaluation. One JSON line per fitted field.

Usage, from the repository root:
  python3 -m experiments.e2e_spread.port_fits train [--seed N | --init F]
      [--perturb EPS] [--trace F] [--scenes DIR]
  python3 -m experiments.e2e_spread.port_fits field F
  python3 -m experiments.e2e_spread.port_fits faults

``train``: from the port's seeded init (default seed 0, the tool's), or
from a state dict file (``jax_fits --save-init`` writes the JAX package's
init as one). ``field``: fit a trained state dict (``jax_fits
--save-field``). ``faults``: one seed-0 field, fitted by the fitter as it
is and by two faulty fitters, each made by rewriting the source of one
``ReconFitter`` method in memory (no file changes):
  anchor: the object-only and joint phases also pull ``obj_t`` toward the
          network's raw init (the sil phase's ``trans`` term, anchored at
          the raw init as the JAX package's round-4 sil phase did);
  uint8:  uint8 images reach the field as 0..255 (cast to float32 without
          the 1/255 the field applies to integer images).
``--save DIR`` keeps each trained field as a state dict. ``--scenes DIR``
builds the scenes in DIR, or reuses the ones there (the tool's resume
guard): given ``jax_fits --scenes DIR``'s, both packages train on the same
bytes (the port's own body differs from XLA's in the last float32 bits,
and so do a few of its boundary samples). ``--trace F`` writes one JSON
line per training step (``steps.py``; compare with ``trace_gap.py``
against ``jax_fits --trace``)."""
import argparse
import contextlib
import inspect
import json
import os
import tempfile
import textwrap
import time

import numpy as np
import torch

from chore_tpu_torch.recon import fitter as fitter_mod
from chore_tpu_torch.tools import e2e_synthetic as E

IMG, EPOCHS, MOVES = 256, 500, 3
FAULTS = {
    "anchor": ("fit_object", [
        ('            "obj_s": scale,\n        }\n',
         '            "obj_s": scale,\n        }\n'
         '        raw_t = obj_params["obj_t"].clone()\n'),
        ('            ld["ocent"] = L.ocent_loss(obj, obj_center_pred)\n',
         '            ld["ocent"] = L.ocent_loss(obj, obj_center_pred)\n'
         '            ld["trans"] = ((op["obj_t"] - raw_t) ** 2).mean()\n'),
    ]),
    "uint8": ("fit_batch", [
        ("return a.float() if torch.is_floating_point(a) else a",
         "return a.float()"),
    ]),
}


def mutant(name, edits):
    """``ReconFitter.<name>`` compiled from its source with ``edits``."""
    src = inspect.getsource(getattr(fitter_mod.ReconFitter, name))
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the fault's anchor text moved: {old!r}")
        src = src.replace(old, new)
    ns = {}
    exec(compile(textwrap.dedent(src), f"<{name} with a planted fault>",
                 "exec"), vars(fitter_mod), ns)
    return ns[name]


def fits(model, scenes, label, dev, **extra):
    """Frame 0's fit and MOVES crop-moved fits of ``model``: one JSON
    line."""
    paths, gt0, smplh = scenes
    item = E.val_item(paths[0], IMG)
    result, fitter = E.reconstruct(model, smplh, gt0, paths[0], IMG)
    errs = [E.evaluate(*E.recovered_meshes(result, fitter), gt0,
                       gt0["obj"][1], dev)]
    for k in range(1, MOVES + 1):
        r = E.refit(fitter, gt0, item, IMG, 1e-3 * k)
        errs.append(E.evaluate(*E.recovered_meshes(r, fitter), gt0,
                               gt0["obj"][1], dev))
    line = {"label": label, "chamfer_smpl_obj_m": errs,
            "object_median_m": float(np.median([o for _, o in errs])),
            "n_valid_object": int(result["pclouds"]["object"]["n_valid"][0]),
            "iters": result["iters"], **extra}
    print(json.dumps(line), flush=True)
    return line


def train(scenes, root, dev, label, save, seed=0, state_dict=None,
          perturb=0.0, trace=None):
    """The tool's training from ``state_dict``, else from the port's init
    at ``seed`` (seed 0: the tool's own start); ``perturb``: every start
    weight scaled by 1 + perturb (how far rounding-sized changes of the
    start move the trained field); ``trace``: per-step JSON lines."""
    from chore_tpu_torch.models import FieldConfig, build_field
    from chore_tpu_torch.train import Trainer
    from experiments.e2e_spread.steps import trace_to

    if state_dict is None and (seed != 0 or perturb):
        state_dict = build_field(FieldConfig(num_stack=2, num_hourglass=2,
                                             net_img_size=IMG),
                                 device="cpu", seed=seed).state_dict()
    if perturb:
        state_dict = {k: v * (1 + perturb) if v.is_floating_point() else v
                      for k, v in state_dict.items()}
    t0 = time.perf_counter()
    with trace_to(Trainer, trace) if trace else contextlib.nullcontext():
        model, _, losses = E.train_field(scenes[0], root, EPOCHS,
                                         verbose=False, device=dev,
                                         state_dict=state_dict)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    info = {"train_s": time.perf_counter() - t0,
            "last_epoch_loss": float(np.mean(losses[-2:]))}
    if save:
        os.makedirs(save, exist_ok=True)
        torch.save(model.state_dict(), os.path.join(save, f"{label}.pt"))
    return model, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("train", "field", "faults"))
    ap.add_argument("field", nargs="?", help="field: a state dict file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", help="train: start from this state dict")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="train: scale every start weight by 1 + this")
    ap.add_argument("--save", help="keep trained fields in this directory")
    ap.add_argument("--trace", help="train: write per-step JSON lines here")
    ap.add_argument("--scenes", help="build or reuse the scenes here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    root = tempfile.mkdtemp(prefix="e2e_spread_")
    scenes = E.build_scenes(args.scenes or root, 8,
                            np.random.RandomState(0), device=dev)
    if args.what == "field":
        from chore_tpu_torch.models import FieldConfig, build_field

        sd = torch.load(args.field, map_location="cpu")
        model = build_field(FieldConfig(num_stack=2, num_hourglass=2,
                                        net_img_size=IMG), device=dev,
                            state_dict=sd)
        fits(model, scenes, f"field {os.path.basename(args.field)}", dev)
        return
    if args.what == "train":
        sd = (torch.load(args.init, map_location="cpu") if args.init
              else None)
        label = (f"init {os.path.basename(args.init)}" if args.init
                 else f"seed {args.seed}")
        if args.perturb:
            label += f" x (1 + {args.perturb:g})"
        model, info = train(scenes, root, dev, label.replace(" ", "_"),
                            args.save, seed=args.seed, state_dict=sd,
                            perturb=args.perturb, trace=args.trace)
        fits(model, scenes, label, dev, **info)
        return
    model, info = train(scenes, root, dev, "seed_0", args.save)
    fits(model, scenes, "seed 0, healthy fitter", dev, **info)
    for fault, (name, edits) in FAULTS.items():
        orig = getattr(fitter_mod.ReconFitter, name)
        setattr(fitter_mod.ReconFitter, name, mutant(name, edits))
        try:
            fits(model, scenes, f"seed 0, fault {fault}", dev)
        finally:
            setattr(fitter_mod.ReconFitter, name, orig)


if __name__ == "__main__":
    main()
