"""The JAX package's side of ``port_fits``, on the CPU: the reference tool
``tools/e2e_synthetic.py``'s ``train_field`` (2 stacks, 256^2, 500 epochs;
deterministic on the CPU) on its own scenes, from the JAX package's
``PRNGKey(0)`` init (the tool's) or from the port's seeded init, then
the JAX package's fit of frame 0 with the crop centre moved by k x 1e-3 px
(k = 0..3), each scored by the reference tool's glue. One JSON line a fit.

Usage, from the repository root (about an hour on 6 CPU cores):
  python3 -m experiments.e2e_spread.jax_fits [--port-seed N]
      [--perturb EPS] [--trace F] [--scenes DIR] [--save-field F]
      [--save-init F]
  python3 -m experiments.e2e_spread.jax_fits --field F  # fit only

``--perturb EPS`` scales every start weight by 1 + EPS (as ``port_fits
train --perturb`` does, in the port's state dict: the same start bits).
``--trace F`` writes one JSON line per training step (``steps.py``: the
total, the six terms of ``train_step``'s second output, the LR and the
batch's sums; ``trace_gap.py`` compares such files). ``--scenes DIR``
builds the scenes in DIR or reuses the ones there (``port_fits --scenes``
then trains on the same files). ``--field F`` fits a port state dict
(e.g. a field the port trained on the card, ``port_fits --save``) instead
of training. ``--save-field`` / ``--save-init`` write the trained field /
its init as a port state dict (``port_fits field F`` / ``port_fits train
--init F``)."""
import argparse
import contextlib
import importlib.util
import json
import os
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def reference_tool():
    """``tools/e2e_synthetic.py`` as a module (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "reference_e2e_synthetic",
        os.path.join(ROOT, "tools", "e2e_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-seed", type=int,
                    help="start from the port's init at this seed")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="scale every start weight by 1 + this")
    ap.add_argument("--trace", help="write per-step JSON lines here")
    ap.add_argument("--scenes", help="build or reuse the scenes here")
    ap.add_argument("--save-field")
    ap.add_argument("--save-init")
    ap.add_argument("--field", help="fit this port state dict; no training")
    args = ap.parse_args(argv)
    ref = reference_tool()
    from chore_tpu.data import BehaveTrainData
    from chore_tpu.models import CHOREField, FieldConfig
    from chore_tpu.ops.chamfer import chamfer_eval
    from chore_tpu.ops.procrustes import apply_transform, similarity_transform
    from chore_tpu.recon import losses as L
    from chore_tpu.recon.fitter import FitConfig, ReconFitter
    from chore_tpu.recon.generator import SamplerConfig
    from chore_tpu.utils.meshio import sample_surface
    from chore_tpu_torch.models import FieldConfig as PortFieldConfig
    from chore_tpu_torch.models import build_field
    from chore_tpu_torch.models.convert import params_from_jax, params_to_jax

    from experiments.e2e_spread.steps import trace_to

    flax_init = CHOREField.init
    if args.port_seed is not None:
        sd = build_field(
            PortFieldConfig(num_stack=2, num_hourglass=2, net_img_size=256),
            device="cpu", seed=args.port_seed).state_dict()
        if args.perturb:
            sd = {k: v * (1 + args.perturb) if v.is_floating_point() else v
                  for k, v in sd.items()}
        tree = params_to_jax(sd)
        # train_field draws its start with model.init(PRNGKey(0), ...)
        CHOREField.init = lambda self, *a, **k: jax.tree_util.tree_map(
            jnp.asarray, tree)
    elif args.perturb:
        CHOREField.init = lambda self, *a, **k: jax.tree_util.tree_map(
            lambda v: v * np.float32(1 + args.perturb),
            flax_init(self, *a, **k))
    to_port = lambda p: params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, jax.device_get(p)))
    if args.save_init:
        init = CHOREField(cfg=FieldConfig(
            num_stack=2, num_hourglass=2, net_img_size=256)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 5)),
            jnp.zeros((1, 8, 3)), jnp.zeros((1, 2)))
        torch.save(to_port(init), args.save_init)
    out = tempfile.mkdtemp(prefix="e2e_spread_jax_")
    paths, gt0, smplh = ref.build_scenes(args.scenes or out, 8,
                                         np.random.RandomState(0), 0.18)
    if args.field:
        model = CHOREField(cfg=FieldConfig(num_stack=2, num_hourglass=2,
                                           net_img_size=256))
        sd = torch.load(args.field, map_location="cpu")
        params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(sd))
        print(json.dumps({"field": args.field}), flush=True)
    else:
        from chore_tpu.train.trainer import Trainer

        t0 = time.time()
        try:
            with (trace_to(Trainer, args.trace) if args.trace
                  else contextlib.nullcontext()):
                model, params, _, losses = ref.train_field(
                    paths, out, 500, num_stack=2, img_size=256,
                    verbose=False)
        finally:
            CHOREField.init = flax_init
        start = ("port seed %d" % args.port_seed
                 if args.port_seed is not None else "JAX PRNGKey(0)")
        if args.perturb:
            start += " x (1 + %g)" % args.perturb
        print(json.dumps({"start": start,
                          "train_s": time.time() - t0,
                          "last_epoch_loss": float(np.mean(losses[-2:]))}),
              flush=True)
    if args.save_field:
        torch.save(to_port(params), args.save_field)
    tv, tf = gt0["obj"]
    fitter = ReconFitter(model, params, smplh, tv - tv.mean(0), tf,
                         weights=L.BEHAVE_WEIGHTS,
                         cfg=FitConfig(net_in_size=256, sil_rend_size=128),
                         sampler_cfg=SamplerConfig(num_points=4000))
    item = BehaveTrainData([paths[0]], phase="val", total_samplenum=4000,
                           image_size=(256, 256))[0]
    kpts = np.concatenate([np.full((1, 25, 2), 128, np.float32),
                           np.zeros((1, 25, 1), np.float32)], -1)
    gs, gsf = gt0["smpl"]
    go, gof = gt0["obj"]
    for k in range(4):
        t0 = time.time()
        result = fitter.fit_batch(
            item["images"][None], item["crop_center"][None] + 1e-3 * k,
            gt0["pose"], np.zeros((1, 10), np.float32), kpts,
            use_silhouette=False)
        rec_smpl = np.asarray(smplh.verts(result["smpl_params"]))[0]
        rec_obj = np.asarray(fitter.transform_obj(
            result["obj_params"], points=fitter.template_verts))[0]
        r, t, s = similarity_transform(
            jnp.asarray(np.concatenate([rec_smpl, rec_obj])),
            jnp.asarray(np.concatenate([gs, go])))
        rs = np.asarray(apply_transform(jnp.asarray(rec_smpl), r, t, s))
        ro = np.asarray(apply_transform(jnp.asarray(rec_obj), r, t, s))
        es = float(chamfer_eval(jnp.asarray(sample_surface(gs, gsf, 5000)),
                                jnp.asarray(sample_surface(rs, gsf, 5000))))
        eo = float(chamfer_eval(jnp.asarray(sample_surface(go, gof, 5000)),
                                jnp.asarray(sample_surface(ro, tf, 5000))))
        n_valid = int(np.asarray(result["pclouds"]["object"]["n_valid"])[0])
        print(json.dumps({"k": k, "smpl_m": es, "obj_m": eo,
                          "n_valid_object": n_valid,
                          "s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
