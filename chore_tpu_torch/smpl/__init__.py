"""SMPL-H body model of the port (counterpart of ``chore_tpu.smpl``)."""
from chore_tpu_torch.smpl import const
from chore_tpu_torch.smpl.assets import (
    load_landmark_regressors,
    load_part_labels,
    load_priors,
)
from chore_tpu_torch.smpl.loader import (
    load_model_arrays,
    load_smpl_pickle,
    synthetic_smplh,
)
from chore_tpu_torch.smpl.model import (
    SMPLH,
    init_params,
    pack_betas,
    pack_pose,
    split_params,
)
from chore_tpu_torch.smpl.priors import make_body_prior, make_hand_prior

__all__ = [
    "const",
    "load_landmark_regressors",
    "load_part_labels",
    "load_priors",
    "load_model_arrays",
    "load_smpl_pickle",
    "synthetic_smplh",
    "SMPLH",
    "init_params",
    "pack_betas",
    "pack_pose",
    "split_params",
    "make_body_prior",
    "make_hand_prior",
]
