"""Neural field -> dense point cloud by iterative surface projection.

Counterpart of ``chore_tpu/recon/generator.py``, with the same fixed
capacity: ``num_rounds`` rounds of ``sample_num`` live points, each round
projecting the points onto the surface ``num_steps`` times
(x <- x - normalize(grad) * df, grad of the clamped df sum by autograd),
keeping survivors (df < filter_val) and resampling survivors + Gaussian
noise for the next round. Rounds 1.. are harvested and compacted by a
stable sort: valid points first in round-then-index order, the rest by df
rank. ``jnp.argsort`` is stable and ``torch.argsort`` is not by default, so
every sort here passes ``stable=True`` (out-of-image points share the df
value OUT_DIST, so ties are common).

Random draws come from a ``torch.Generator``, or are injected (``draws``) so
that tests can feed the JAX package's draws.
"""
from __future__ import annotations

import dataclasses

import torch

from chore_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    threshold: float = 2.0  # df clamp during projection
    filter_val: float = 0.004  # surface acceptance
    num_steps: int = 10  # projection steps per round
    sample_num: int = 20000  # live samples per round
    num_rounds: int = 6  # total rounds; rounds 1.. harvest
    num_points: int = 5000  # output points per target


BOX_LO = (-3.0, -2.5, 1.95)
BOX_HI = (3.0, 2.5, 2.45)


def make_draws(cfg: SamplerConfig, batch_size, generator, device):
    """All random numbers one ``sample`` call consumes:
    init_u (B, S, 3) ~ U[0, 1) for the scene box, and per round
    u (R, B, S) ~ U[0, 1), noise (R, B, S, 3) and fresh (R, B, S, 3) ~ N(0, 1)."""
    B, S, R = batch_size, cfg.sample_num, cfg.num_rounds
    kw = dict(generator=generator, device=device)
    return {
        "init_u": torch.rand((B, S, 3), **kw),
        "u": torch.rand((R, B, S), **kw),
        "noise": torch.randn((R, B, S, 3), **kw),
        "fresh": torch.randn((R, B, S, 3), **kw),
    }


def make_surface_sampler(query_fn, cfg: SamplerConfig = SamplerConfig()):
    """query_fn: (points (B, N, 3)) -> head dict ('df' (B,N,2), 'parts',
    'pca', 'centers'). Returns ``sample(df_idx, batch_size, generator=None,
    draws=None)`` -> dict with points (B,P,3), parts (B,P), pca_axis
    (B,3,3), centers (B,6), valid (B,P) bool, n_valid (B,)."""

    def approx_surface(points, df_idx):
        pts = points
        for _ in range(cfg.num_steps):
            p = pts.detach().requires_grad_(True)
            with torch.enable_grad():
                df = query_fn(p)["df"][..., df_idx].clamp(max=cfg.threshold)
                (grad,) = torch.autograd.grad(df.sum(), p)
            gnorm = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True)
                            + 1e-12)
            pts = (p - gnorm * df[..., None]).detach()
        return pts

    @torch.no_grad()
    def sample(df_idx, batch_size, generator=None, draws=None):
        dev = draws["init_u"].device if draws is not None else generator.device
        if draws is None:
            draws = make_draws(cfg, batch_size, generator, dev)
        lo = torch.tensor(BOX_LO, device=dev)
        hi = torch.tensor(BOX_HI, device=dev)
        init = lo + draws["init_u"] * (hi - lo)
        live = init
        S = cfg.sample_num
        harvest = []
        for rnd in range(cfg.num_rounds):
            surf = approx_surface(live, df_idx)
            preds = query_fn(surf)
            dfv = preds["df"][..., df_idx]
            mask = dfv < cfg.filter_val  # (B, S)
            # resample: the r-th survivor for r ~ U{1..n_valid} (cumsum +
            # searchsorted), plus noise; fresh box samples if none survived
            csum = torch.cumsum(mask.to(torch.int64), dim=1)
            n_valid = csum[:, -1:]
            r = torch.floor(draws["u"][rnd] * n_valid).to(torch.int64) + 1
            idx = torch.searchsorted(csum, r, right=False).clamp(max=S - 1)
            picked = torch.gather(surf, 1, idx[..., None].expand(-1, -1, 3))
            picked = picked + (cfg.threshold / 3.0) * draws["noise"][rnd]
            fresh = init + 0.5 * draws["fresh"][rnd]
            live = torch.where(mask.any(dim=1)[:, None, None], picked, fresh)
            if rnd > 0:  # harvest rounds 1.. (round 0 is a warm-up)
                harvest.append({"points": surf, "mask": mask, "df": dfv,
                                "parts": preds["parts"], "pca": preds["pca"],
                                "centers": preds["centers"]})

        flat = {k: torch.cat([h[k] for h in harvest], dim=1)
                for k in harvest[0]}
        mask, dfs = flat["mask"], flat["df"]
        M = mask.shape[1]
        df_rank = torch.argsort(torch.argsort(dfs, dim=1, stable=True),
                                dim=1, stable=True)
        ar = torch.arange(M, device=dev)[None].expand_as(df_rank)
        order_key = torch.where(mask, ar, M + df_rank)
        order = torch.argsort(order_key, dim=1,
                              stable=True)[:, : cfg.num_points]

        def take(x):
            o = order.reshape(*order.shape, *([1] * (x.ndim - 2)))
            return torch.gather(x, 1, o.expand(-1, -1, *x.shape[2:]))

        sel_valid = torch.gather(mask, 1, order)
        sel_centers, sel_pca = take(flat["centers"]), take(flat["pca"])
        vw = sel_valid.to(torch.float32)[..., None]
        # no survivors at all: average over the selected (lowest-df) points
        vw = torch.where(sel_valid.any(dim=1)[:, None, None], vw,
                         torch.ones_like(vw))
        denom = vw.sum(dim=1).clamp(min=1.0)
        return {
            "points": take(flat["points"]),
            "parts": torch.argmax(take(flat["parts"]), dim=-1),
            "pca_axis": (sel_pca * vw[..., None]).sum(dim=1)
            / denom[..., None],
            "centers": (sel_centers * vw).sum(dim=1) / denom,
            "valid": sel_valid,
            "n_valid": sel_valid.sum(dim=1),
        }

    return sample


class Generator:
    """Encode an image batch once, then generate human and object point
    clouds. Runs on ``device`` (the card unless ``device="cpu"``); the
    model is moved there and frozen."""

    def __init__(self, model, cfg: SamplerConfig = SamplerConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.cfg = cfg

    @torch.no_grad()
    def encode(self, images):
        images = torch.as_tensor(images, device=self.device)
        return self.model.encode(images, train=False)

    def sample_from_feats(self, feats, tmpx, crop_center, df_idx,
                          generator=None, draws=None):
        crop_center = torch.as_tensor(crop_center, dtype=torch.float32,
                                      device=self.device)

        def query_fn(points):
            # frozen net: gradients flow to the points only
            return self.model.query_last(feats, tmpx, points, crop_center,
                                         frozen_features=True)

        sampler = make_surface_sampler(query_fn, self.cfg)
        return sampler(df_idx, tmpx.shape[0], generator=generator,
                       draws=draws)

    def generate_from_feats(self, feats, tmpx, crop_center, generator=None,
                            draws=None):
        """{"human": ..., "object": ...}; ``draws`` optionally holds the
        injected draws of each."""
        draws = draws or {}
        return {
            name: self.sample_from_feats(feats, tmpx, crop_center, i,
                                         generator, draws.get(name))
            for i, name in enumerate(("human", "object"))
        }

    def generate_pclouds(self, images, crop_center, generator=None):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        feats, tmpx = self.encode(images)
        return self.generate_from_feats(feats, tmpx, crop_center, generator)
