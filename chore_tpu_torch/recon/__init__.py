"""Reconstruction of the port: point generation, losses, phase optimizer,
fitter (counterpart of ``chore_tpu.recon``)."""
from chore_tpu_torch.recon.fitter import FitConfig, ReconFitter
from chore_tpu_torch.recon.generator import (
    Generator,
    SamplerConfig,
    init_box_samples,
    make_surface_sampler,
)
from chore_tpu_torch.recon.losses import BEHAVE_WEIGHTS, COCO_WEIGHTS
from chore_tpu_torch.recon.optimize import (
    PhaseSpec,
    freeze_all_except,
    run_phase,
)
from chore_tpu_torch.recon.silhouette import SilhouetteLossROI

__all__ = [
    "FitConfig",
    "ReconFitter",
    "Generator",
    "SamplerConfig",
    "init_box_samples",
    "make_surface_sampler",
    "BEHAVE_WEIGHTS",
    "COCO_WEIGHTS",
    "PhaseSpec",
    "freeze_all_except",
    "run_phase",
    "SilhouetteLossROI",
]
