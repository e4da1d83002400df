"""The model's operation count, taken from the plain reference
(``reference/field.py``) at the configuration's shapes on the meta device:
``torch.utils.flop_counter`` counts 2 operations per multiply-accumulate
of every convolution and matrix product, and nothing else (norms,
samples, pools and activations are left out). The count reads the
published model's work, whatever implements it: the encoder is counted
in float32, where its bicubic upsampling is an interpolation and no
matrix product."""
from __future__ import annotations

import functools
import json

from portbench.reference import field as ref


def _meta_step(cfg, backward):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    c = {**cfg, "precision": "float32"}
    S, N = c["net_img_size"][0], c["num_samples_train"]
    p = {k: torch.empty(v, device="meta", requires_grad=backward)
         for k, v in ref.param_shapes(c).items()}
    batch = {"images": torch.empty(1, S, S, c["input_channels"],
                                   device="meta"),
             "points": torch.empty(1, N, 3, device="meta"),
             "crop_center": torch.empty(1, 2, device="meta"),
             "df_h": torch.empty(1, N, device="meta"),
             "df_o": torch.empty(1, N, device="meta"),
             "parts": torch.zeros(1, N, dtype=torch.long, device="meta"),
             "pca": torch.empty(1, 3, 3, device="meta"),
             "body_center": torch.empty(1, 3, device="meta"),
             "obj_center": torch.empty(1, 3, device="meta")}
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(backward):
        feats, tmpx = ref.Encoder(c, p)(batch["images"])
        preds = ref.query(c, p, feats, tmpx, batch["points"],
                          batch["crop_center"])
        loss, _ = ref.losses(c, preds, batch)
        if backward:
            torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def _cached(key, backward):
    return _meta_step(json.loads(key), backward)


def train_flops_per_image(cfg):
    """One image's forward and backward (every stack's heads at the
    configuration's training points), operations."""
    return _cached(json.dumps(cfg, sort_keys=True), True)


def forward_flops_per_image(cfg):
    """One image's forward alone (encoder and every stack's heads)."""
    return _cached(json.dumps(cfg, sort_keys=True), False)
