"""chore_tpu_torch: the PyTorch/CUDA port of chore_tpu for NVIDIA Hopper.

Mirrors ``chore_tpu``'s module layout; the JAX package is the reference the
port is tested against. Entry points (``ReconFitter``, ``Generator``,
``models.chore.build_field``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise instead of
silently running on the CPU.

Precision: every entry point calls ``use_full_f32()``, which turns TF32 off
for cuDNN convolutions and cuBLAS matmuls and keeps float32 matmuls at
"highest" -- the counterpart of the JAX package's ``Precision.HIGHEST``
rule. The 1-NN distance expansion, LBS and the SO(3) projection cancel
badly under TF32's ~3 decimal digits.
"""
from __future__ import annotations

import torch


def use_full_f32():
    """Full float32 for convolutions and matmuls on the card (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """``device`` as a torch.device; ``None`` means the card, and raises
    when there is none (never a silent fall back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "chore_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' explicitly to run on the "
                "CPU")
        device = "cuda"
    use_full_f32()
    return torch.device(device)
