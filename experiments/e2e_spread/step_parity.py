"""One training step's arithmetic in both packages at a given field, term
by term: for the total and each of the six loss terms, its value and its
gradient by parameter group (the stem, each stack, each head) from the
JAX package (``chore_tpu``'s ``chore_losses`` under ``jax.grad``) and
from the port (``chore_tpu_torch``'s, under ``backward``), on the tools'
training batches at the learning check's width (2 stacks, 256^2, batch 4
x 4,000 points). The gradient gap of a group is |g_a - g_b| / |g_b| over
the group's elements.

Beside each gap, the same package's gap when every weight w is made w (1
+ eps z), z a seeded standard normal draw, for each eps of ``NUDGES``:
1e-7 is one rounding of the weights; 3e-6 moves the port's df predictions
about as far as the two packages' predictions part at a trained field.
And a float64 reference: the port's field and losses run in float64
(every parameter, every float input, and each ``.float()`` cast of the
port's code made a cast to float64; the images' 1/255 stays float32 as
in both packages), the gap of each package's float32 value and gradient
from it. A fault in a term shows as a port gap far beyond the matched
nudge's gap in both packages, and as the port's float32 lying farther
from float64 than the JAX package's does. Per epoch also: the largest
difference of a df prediction between the packages, between each
package and its nudged twins and from float64; and for ``df_h`` and
``df_o`` the points where the term's gradient with respect to the df
prediction differs between the packages, and how many of those have a
clamped residual of exactly 0 in one package (an L1's kink).

Usage, from the repository root (about 12 min on 3 CPU cores):
  python3 -m experiments.e2e_spread.step_parity FIELD [--scenes DIR]

FIELD: a port state dict (``jax_fits --save-field``, ``port_fits
--save``); ``init`` for the port's seed-0 init. ``--scenes``: as
``jax_fits``. The first batch of each epoch of ``EPOCHS`` is drawn as
the tools' loader draws it. One JSON line per (epoch, term)."""
import argparse
import contextlib
import json
import os
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments.e2e_spread.jax_fits import reference_tool  # noqa: E402
from experiments.e2e_spread.steps import by_group  # noqa: E402

TERMS = ("loss", "df_h", "df_o", "parts", "pca", "smpl_center",
         "obj_center")
IMG = 256
EPOCHS = (0, 250, 499)  # the first epoch, the middle, the last
NUDGES = (1e-7, 3e-6)


def group_gaps(a, b):
    """{group: |a - b| / |b| over the group's elements} of two
    {port name: gradient} dicts."""
    diff = by_group(a, lambda n, x: float(np.sum(
        (x.astype(np.float64) - b[n]) ** 2)))
    norm = by_group(b, lambda n, x: float(np.sum(x.astype(np.float64) ** 2)))
    return {g: (diff[g] / max(norm[g], 1e-60)) ** 0.5 for g in norm}


def nudge(sd, eps, seed=1):
    rng = np.random.RandomState(seed)
    return {k: v * (1 + eps * torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32)))
        if v.is_floating_point() else v for k, v in sd.items()}


@contextlib.contextmanager
def float64():
    """Every ``Tensor.float()`` made a cast to float64 inside the block."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def jax_terms(model, names):
    """(params, batch, k) -> (terms, {port name: gradient of term k}),
    jitted once."""
    from chore_tpu.models import chore_losses
    from chore_tpu_torch.models.convert import params_from_jax

    def weighted(params, batch, w):
        preds = model.apply(params, batch["images"], batch["points"],
                            batch["crop_center"])
        loss, parts = chore_losses(preds, batch, model.cfg)
        terms = jnp.stack([loss] + [parts[k] for k in TERMS[1:]])
        return jnp.dot(w, terms), (terms, [p["df"] for p in preds])

    fn = jax.jit(jax.value_and_grad(weighted, has_aux=True))

    def run(params, batch, k):
        w = jnp.zeros(len(TERMS)).at[k].set(1.0)
        (_, (terms, df)), g = fn(params, batch, w)
        sd = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
        return (np.asarray(terms, np.float64),
                {n: sd[n].numpy() for n in names},
                [np.asarray(d) for d in df])
    return run


def port_terms(model, dtype=torch.float32):
    """(batch, k) -> (terms, {port name: gradient of term k}, the df
    predictions of each stack); float inputs cast to ``dtype``."""
    from chore_tpu_torch.models.chore import chore_losses

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def run(batch, k):
        tb = {key: torch.as_tensor(v) for key, v in batch.items()}
        tb = {key: v.to(dtype) if v.is_floating_point() else v
              for key, v in tb.items()}
        for _, p in named:
            p.grad = None
        preds = model(tb["images"], tb["points"], tb["crop_center"])
        loss, parts = chore_losses(preds, tb, model.cfg)
        terms = [loss] + [parts[t] for t in TERMS[1:]]
        terms[k].backward()
        return (np.array([float(t.detach()) for t in terms]),
                {n: (np.zeros(tuple(p.shape), np.float32)
                     if p.grad is None else p.grad.numpy().copy())
                 for n, p in named},
                [p["df"].detach().numpy() for p in preds])
    return run


def df_points(cfg, params, model, apply, batch, term):
    """(points whose d term / d df prediction differs between the
    packages, of them those with a clamped residual of exactly 0 in
    either), over every stack. ``apply``: the JAX field's, jitted;
    ``model``: the port's field."""
    from chore_tpu.models import chore_losses
    from chore_tpu_torch.models.chore import chore_losses as port_losses

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    preds = apply(params, jb["images"], jb["points"], jb["crop_center"])
    gj = jax.grad(lambda d: chore_losses(
        [{**p, "df": x} for p, x in zip(preds, d)], jb,
        cfg)[1][term])([p["df"] for p in preds])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tp = model(tb["images"], tb["points"], tb["crop_center"])
    td = [p["df"].detach().requires_grad_(True) for p in tp]
    port_losses([{**p, "df": x} for p, x in zip(tp, td)], tb,
                model.cfg)[1][term].backward()
    ch, clamp = TERMS.index(term) - 1, np.float32(cfg.clamp_thres)
    target = np.minimum(np.asarray(batch[term]), clamp)
    leak = np.float32(cfg.df_leak)
    differ = zero = 0
    for g, x, p, y in zip(gj, td, preds, tp):
        d = np.asarray(g)[..., ch] != x.grad.numpy()[..., ch]
        zeros = np.zeros_like(d)
        for pred in (np.asarray(p["df"])[..., ch],
                     y["df"].detach().numpy()[..., ch]):
            clipped = (np.minimum(pred, clamp)
                       + leak * np.maximum(pred - clamp, 0))
            zeros |= clipped - target == 0
        differ += int(d.sum())
        zero += int((d & zeros).sum())
    return {"points_differ": differ, "of_them_zero_residual": zero}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("field")
    ap.add_argument("--scenes")
    args = ap.parse_args(argv)
    from chore_tpu.models import CHOREField, FieldConfig
    from chore_tpu_torch.data import BehaveTrainData, DataLoader
    from chore_tpu_torch.models import FieldConfig as PortFieldConfig
    from chore_tpu_torch.models import build_field
    from chore_tpu_torch.models.convert import params_to_jax, trained_names

    ref = reference_tool()
    root = args.scenes or tempfile.mkdtemp(prefix="e2e_step_parity_")
    paths, _, _ = ref.build_scenes(root, 8, np.random.RandomState(0), 0.18)
    pcfg = PortFieldConfig(num_stack=2, num_hourglass=2, net_img_size=IMG)
    sd = (build_field(pcfg, device="cpu", seed=0).state_dict()
          if args.field == "init"
          else torch.load(args.field, map_location="cpu"))
    states = {"base": sd, **{eps: nudge(sd, eps) for eps in NUDGES}}
    names = trained_names(sd)
    cfg = FieldConfig(num_stack=2, num_hourglass=2, net_img_size=IMG)
    model = CHOREField(cfg=cfg)
    jrun = jax_terms(model, names)
    apply = jax.jit(model.apply)
    jp, tmodels, ports = {}, {}, {}
    for key, s in states.items():
        jp[key] = jax.tree_util.tree_map(jnp.asarray, params_to_jax(s))
        tmodels[key] = build_field(pcfg, device="cpu", state_dict=s,
                                   trainable=True)
        ports[key] = port_terms(tmodels[key])
    f64 = port_terms(build_field(pcfg, device="cpu", state_dict=sd,
                                 trainable=True,
                                 encoder_dtype=torch.float64).double(),
                     torch.float64)
    loader = DataLoader(BehaveTrainData(paths, phase="train",
                                        total_samplenum=4000,
                                        image_size=(IMG, IMG)),
                        batch_size=4, shuffle=True, num_workers=2)
    for epoch in EPOCHS:
        loader.set_epoch(epoch)
        batch = next(iter(loader))
        batch.pop("path", None)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for k, term in enumerate(TERMS):
            j = {key: jrun(jp[key], jb, k) for key in states}
            t = {key: ports[key](batch, k) for key in states}
            with float64():
                exact = f64(batch, k)

            def df_gap(a, b):
                return max(float(np.abs(x - y).max())
                           for x, y in zip(a[2], b[2]))

            def value_gap(a, b):
                return abs(a[0][k] - b[0][k]) / abs(b[0][k])

            line = {
                "field": os.path.basename(args.field), "epoch": epoch,
                "term": term, "value": j["base"][0][k],
                "value_gap": value_gap(t["base"], j["base"]),
                "grad_gap": group_gaps(t["base"][1], j["base"][1])}
            if k == 0:
                line["df_pred_gap"] = df_gap(t["base"], j["base"])
            for pkg, r in (("jax", j), ("port", t)):
                line[f"value_gap_{pkg}_to_f64"] = value_gap(r["base"], exact)
                line[f"grad_gap_{pkg}_to_f64"] = group_gaps(r["base"][1],
                                                            exact[1])
                if k == 0:
                    line[f"df_pred_gap_{pkg}_to_f64"] = df_gap(r["base"],
                                                               exact)
            for eps in NUDGES:
                for pkg, r in (("jax", j), ("port", t)):
                    nudged = f"{pkg}_nudged_{eps:g}"
                    line[f"value_gap_{nudged}"] = value_gap(r[eps],
                                                            r["base"])
                    line[f"grad_gap_{nudged}"] = group_gaps(r[eps][1],
                                                            r["base"][1])
                    if k == 0:
                        line[f"df_pred_gap_{nudged}"] = df_gap(r[eps],
                                                               r["base"])
            if term in ("df_h", "df_o"):
                line["df_points"] = df_points(cfg, jp["base"],
                                              tmodels["base"], apply, batch,
                                              term)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
