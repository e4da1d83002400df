"""Field network of the port (counterpart of ``chore_tpu.models``)."""
from chore_tpu_torch.models.chore import (
    CHOREField,
    FieldConfig,
    build_field,
    chore_losses,
)
from chore_tpu_torch.models.hourglass import HGFilter, HourGlass
from chore_tpu_torch.models.layers import (
    ConvBlock,
    bicubic_upsample_2x,
    bicubic_upsample_matrix,
)

__all__ = [
    "CHOREField",
    "FieldConfig",
    "build_field",
    "chore_losses",
    "HGFilter",
    "HourGlass",
    "ConvBlock",
    "bicubic_upsample_2x",
    "bicubic_upsample_matrix",
]
