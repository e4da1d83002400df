#!/usr/bin/env python3
"""Readings that set and test a training cell's limits, on the card at the
cell's own size (the benchmark's runs do not run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--what control,tf32,half_batch,grad_altered]

For each seed the plain reference takes the three steps the check
compares, from the seed's weights and the cell's first three batches, in
the configuration's precision; then, in the program's place:

  control       the reference one precision lower: TF32 on for a float32
                configuration, the encoder's convolution operands rounded
                to float8 (e4m3, one scale per tensor) for a bfloat16 one;
  tf32          TF32 on for the reference's float32 work: in a "mixed"
                configuration the heads' GEMMs and the upsampling, which
                stay float32 there (the float32 configuration's control);
  half_batch    the reference on the first half of each batch, the mean
                taken over it;
  grad_altered  the reference with one leaf's gradient (the first
                convolution's weight) scaled by 1.1 where it is produced;
  no_exchange   (a data-parallel cell) each rank's shard trained alone:
                the loss the mean of the ranks', the gradient and the
                change rank 0's, as when the gradient exchange is left
                out.

A state left unchanged needs no run: every leaf's change reads 1 by the
change_gap's measure. Prints one JSON line per seed and reading.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import harness, training  # noqa: E402
from portbench.reference import field as ref  # noqa: E402

FP8_MAX = 448.0


def fp8_round(dtype):
    """Round a convolution operand to float8 e4m3 with one scale per
    tensor (its largest magnitude to e4m3's 448), then to ``dtype``."""
    import torch

    def rnd(t):
        amax = t.detach().abs().max().float().clamp(min=1e-12)
        scale = FP8_MAX / amax
        q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
        # the rounding is the fault; gradients pass it unchanged
        return (t.float() + (q - t.float()).detach()).to(dtype)
    return rnd


@contextlib.contextmanager
def tf32():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def first_batches(cell, cfg, seed, device):
    """The three batches of each rank the cell's first steps take: [rank]
    [step] (one rank but in a data-parallel cell)."""
    t = cell["traffic"]
    world = cell["chips"] if t["kind"] == "train_ddp" else 1
    n = t["batches"]
    return [[training.synthetic_batch(cfg, seed, q * n + i, device)
             for i in range(3)] for q in range(world)]


def joined(shards):
    import torch

    return [{k: torch.cat([s[i][k] for s in shards]) for k in s0}
            for i, s0 in enumerate(shards[0])]


def readings(cell, cfg, seed, device, what):
    import torch

    # the reference in the configuration's precision: no TF32 anywhere
    # (cuDNN's default allows it) but inside the TF32 readings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shards = first_batches(cell, cfg, seed, device)
    batches = joined(shards)
    want = training.reference_steps(cfg, seed, batches, device)
    out = {}
    for w in what:
        if w == "tf32" or (w == "control"
                           and cfg["precision"] == "float32"):
            with tf32():
                got = training.reference_steps(cfg, seed, batches, device)
        elif w == "control":
            got = training.reference_steps(
                cfg, seed, batches, device,
                conv_round=fp8_round(ref.encoder_dtype(cfg)))
        elif w == "half_batch":
            got = training.reference_steps(
                cfg, seed, batches, device, batch_fault=lambda b: {
                    k: v[: v.shape[0] // 2] for k, v in b.items()})
        elif w == "grad_altered":
            got = training.reference_steps(cfg, seed, batches, device,
                                           grad_fault=_scale_first_conv)
        elif w == "no_exchange":
            alone = [training.reference_steps(cfg, seed, s, device)
                     for s in shards]
            losses = [sum(a[0][i] for a in alone) / len(alone)
                      for i in range(3)]
            got = (losses, *alone[0][1:])
        else:
            raise SystemExit(f"unknown reading {w!r}")
        out[w] = training.gaps(got, want)
        training.free_cuda()
    return out


def _scale_first_conv(grads):
    key = "image_filter.conv1.weight"
    return {**grads, key: grads[key] * 1.1}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="control,half_batch,grad_altered")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import torch

    cell, cfg = harness.load_cell(a.workload)
    device = torch.device(a.device)
    for s in a.seeds.split(","):
        got = readings(cell, cfg, int(s), device, a.what.split(","))
        for w, v in got.items():
            print(json.dumps({"workload": a.workload, "seed": int(s),
                              "reading": w, **v}), flush=True)


if __name__ == "__main__":
    main()
