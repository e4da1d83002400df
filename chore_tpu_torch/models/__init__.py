"""Field network of the port (counterpart of ``chore_tpu.models``)."""
from chore_tpu_torch.models.chore import CHOREField, FieldConfig, build_field

__all__ = ["CHOREField", "FieldConfig", "build_field"]
