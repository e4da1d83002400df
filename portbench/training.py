"""What the training cells share: the port's trainer built with the
benchmark's weights, the first steps read for the check, and the check
against the plain reference (``reference/field.py``).

The check (training): set-up builds one ``Trainer`` and drives it through
its first three steps with the window's own call and feed, on batches
whose rows all differ; the window continues with the same object. Read
from the program: each step's loss, the norm of each leaf's first
gradient as Adam got it (its first moment after one step over 1 - b1),
and the norm of each leaf's change after three steps (read before the
fourth). The reference follows the same three steps from the same weights
and batches. Compared, each against its limit in the cell's file:
  loss_gap    the largest |loss - reference| / |reference| of the steps;
  grad_gap    over the leaves, the largest gap between the two gradient
              norms over the larger of the reference leaf's norm and the
              median leaf's;
  change_gap  the same of the change after three steps, over the leaves
              whose reference gradient is at least a thousandth of the
              median leaf's (a leaf with a gradient that is nought to
              rounding moves under Adam by round-off alone);
  grad_diff   over the leaves, the largest norm of the difference of the
              two first gradients over the same base: a lower precision's
              rounding, nearly uncorrelated with the gradient, barely
              moves a norm, and shows here (compared where the cell's file
              gives it a limit);
  grad_diff.heads  the same over the heads' leaves alone (``ref.HEADS``),
              which "mixed" computes in float32 too: there TF32 in the
              heads shows, under the bfloat16 encoder's rounding.
"""
from __future__ import annotations

import os
import statistics

import numpy as np

from portbench.reference import field as ref


def program_config(cfg):
    """The port's ``ChoreConfig`` for a configuration file."""
    import dataclasses

    from chore_tpu_torch.config import ChoreConfig

    names = {f.name for f in dataclasses.fields(ChoreConfig)}
    return ChoreConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in cfg.items() if k in names})


def build_trainer(cfg, params, device, exp_dir):
    """The port's field with the benchmark's weights ``params``, trainable
    as ``build_field(trainable=True)`` makes it, on ``device``, under the
    port's ``Trainer``."""
    import torch

    from chore_tpu_torch import use_full_f32
    from chore_tpu_torch.models.chore import CHOREField
    from chore_tpu_torch.models.convert import trained_names
    from chore_tpu_torch.train import Trainer

    use_full_f32()
    ccfg = program_config(cfg)
    with torch.device(device):
        model = CHOREField(ccfg.field_config(),
                           encoder_dtype=ccfg.encoder_dtype())
    named = dict(model.named_parameters())
    missing = set(params) - set(named)
    if missing:
        raise SystemExit(f"the port's field lacks {sorted(missing)[:3]}")
    keep = set(trained_names(model.state_dict()))
    with torch.no_grad():
        for name, p in named.items():
            if name in params:
                p.copy_(params[name])
            p.requires_grad_(name in keep)
    model.train()
    return Trainer(model, exp_dir, base_lr=cfg["learning_rate"],
                   milestones=tuple(cfg["milestones"]))


def synthetic_batch(cfg, seed, index, device):
    """One training batch as the loader gives it, drawn on ``device``
    from (seed, index): uint8 RGBM3 crops (noise inside a person and an
    object ellipse), points inside the crop's view between 1.8 and 2.6 m,
    UDFs in [0, 0.25] m, part labels, a rotation as the PCA axes, the
    body centre at z0 and the object's offset from it."""
    import torch

    B, N = cfg["batch_size"], cfg["num_samples_train"]
    S = cfg["net_img_size"][0]
    g = torch.Generator(device=device).manual_seed(
        (seed * 8 + index) % (2 ** 63))

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    yy, xx = torch.meshgrid(torch.arange(S, device=device),
                            torch.arange(S, device=device), indexing="ij")

    def ellipse():
        c = (0.3 + 0.4 * u(B, 2)) * S
        r = (0.1 + 0.25 * u(B, 2)) * S
        d = (((xx - c[:, None, None, 0]) / r[:, None, None, 0]) ** 2
             + ((yy - c[:, None, None, 1]) / r[:, None, None, 1]) ** 2)
        return ((d <= 1).to(torch.uint8) * 255)

    person, obj = ellipse(), ellipse()
    rgb = torch.randint(0, 256, (B, S, S, 3), generator=g, device=device,
                        dtype=torch.uint8)
    rgb = rgb * ((person > 127) | (obj > 127))[..., None].to(torch.uint8)
    images = torch.cat([rgb, person[..., None], obj[..., None]], -1)
    crop = cfg["loadSize"]
    center = torch.stack([1024 + 200 * (u(B) - 0.5),
                          768 + 150 * (u(B) - 0.5)], -1)
    nxy = 1.8 * (u(B, N, 2) - 0.5)
    z = 1.8 + 0.8 * u(B, N, 1)
    size = ref.KINECT["size"]
    px = (nxy[..., 0:1] + 1) * crop / 2 + center[:, None, 0:1] - crop / 2
    py = (nxy[..., 1:2] + 1) * crop / 2 + center[:, None, 1:2] - crop / 2
    x = (px - ref.KINECT["cx"] * size) * z / (ref.KINECT["fx"] * size)
    y = (py - ref.KINECT["cy"] * size) * z / (ref.KINECT["fy"] * size)
    q, _ = torch.linalg.qr(torch.randn(B, 3, 3, generator=g, device=device))
    body = torch.cat([0.4 * (u(B, 2) - 0.5),
                      torch.full((B, 1), cfg["z_0"], device=device)], -1)
    return {
        "images": images,
        "points": torch.cat([x, y, z], -1),
        "df_h": 0.25 * u(B, N),
        "df_o": 0.25 * u(B, N),
        "parts": torch.randint(0, cfg["num_parts"], (B, N), generator=g,
                               device=device, dtype=torch.int32),
        "pca": q,
        "body_center": body,
        "obj_center": 0.3 * (u(B, 3) - 0.5),
        "crop_center": center,
    }


def leaf_norms(tensors):
    return {k: float(v.double().norm()) for k, v in tensors.items()}


class FirstSteps:
    """Reads the program's first three steps: each step's loss, each
    leaf's first gradient (Adam's first moment after step 1 over 1 - b1;
    its norm, and a host copy) and its change after step 3 (against the
    weights regenerated from the seed, as a norm)."""

    def __init__(self, trainer, cfg, seed, device):
        self.trainer, self.cfg = trainer, cfg
        self.seed, self.device = seed, device
        self.losses, self.grad, self.change = [], None, None
        self.grad_vec = None

    def readings(self):
        return self.losses, self.grad, self.change, self.grad_vec

    def after(self, loss):
        """Called after each of the first three steps with its loss."""
        import torch

        self.losses.append(float(loss))
        opt = self.trainer.opt
        named = self.trainer.named_params
        if len(self.losses) == 1:
            b1 = opt.param_groups[0]["betas"][0]
            # a copy: Adam updates its moments in place
            self.grad_vec = {n: opt.state[p]["exp_avg"].to("cpu", copy=True)
                             / (1 - b1) for n, p in named if p in opt.state}
            self.grad = leaf_norms(self.grad_vec)
        if len(self.losses) == 3:
            p0 = ref.make_params(self.cfg, self.seed, self.device)
            with torch.no_grad():
                self.change = {n: float((p.detach() - p0[n]).double().norm())
                               for n, p in named if n in p0}
            del p0


def reference_steps(cfg, seed, batches, device, conv_round=None,
                    batch_fault=None, grad_fault=None):
    """The reference's three steps from the seed's weights: (losses, first
    gradient norms, change norms, first gradients on the host), each batch
    in blocks of a card's ``batch_size`` images (a data-parallel cell's
    joined batch too). ``conv_round``, ``batch_fault`` and
    ``grad_fault`` put a lower precision or a planted fault in place
    (control.py)."""
    p = ref.make_params(cfg, seed, device)
    p0 = {k: v.clone() for k, v in p.items()}
    adam = ref.Adam(cfg["learning_rate"], *cfg["adam_betas"],
                    cfg["adam_eps"])
    losses, grad, vec = [], None, None
    for b in batches:
        if batch_fault is not None:
            b = batch_fault(b)
        loss, grads = ref.loss_and_grads(cfg, p, b, cfg["batch_size"],
                                           conv_round)
        if grad_fault is not None:
            grads = grad_fault(grads)
        losses.append(loss)
        if grad is None:
            vec = {k: g.cpu() for k, g in grads.items()}
            grad = leaf_norms(vec)
        adam.step(p, grads)
        del grads
    change = {k: float((p[k] - p0[k]).double().norm()) for k in p}
    return losses, grad, change, vec


def gaps(prog, want):
    """The numbers compared: ``prog`` and ``want`` are (losses, gradient
    norms, change norms, first gradients)."""
    pl, pg, pc, pv = prog
    wl, wg, wc, wv = want
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pl, wl))
    if len(pl) != len(wl):
        loss_gap = float("inf")
    med = statistics.median(wg.values())

    def worst(got, keys, base):
        out = 0.0
        for k in keys:
            gap = abs(got.get(k, 0.0) - base[k]) / max(base[k], med, 1e-30)
            out = max(out, gap if np.isfinite(gap) else float("inf"))
        return out

    def diff(keys):
        out = max((float((pv[k].double() - wv[k].double()).norm())
                   / max(wg[k], med, 1e-30) if k in pv else 1.0
                   for k in keys), default=0.0)
        return out if np.isfinite(out) else float("inf")

    moved = [k for k in wg if wg[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": worst(pg, wg, wg),
            "change_gap": worst(pc, moved, {k: wc[k] for k in moved}),
            "grad_diff": diff(wv),
            "grad_diff.heads": diff([k for k in wv
                                     if k.startswith(ref.HEADS)])}


def checks(cell, values):
    """[{name, value, limit}] of every number the cell compares (those its
    file gives a limit), and whether each value is within its limit (a
    value that is not finite is not)."""
    limits = cell["limits"]
    out = [{"name": k, "value": float(v), "limit": float(limits[k])}
           for k, v in values.items() if k in limits]
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out)
    return out, ok


def free_cuda():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def exp_dir(run):
    return os.path.join(run.tmp, "exp")
