"""GT preprocessing of the port (counterpart of ``chore_tpu.preprocess``)."""
from chore_tpu_torch.preprocess.boundary_sampler import (
    BoundarySampler,
    flip_part_labels,
)
from chore_tpu_torch.preprocess.preprocess_scale import (
    process_scale_frame,
    process_scale_seq,
)

__all__ = [
    "BoundarySampler",
    "flip_part_labels",
    "process_scale_frame",
    "process_scale_seq",
]
