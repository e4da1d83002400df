"""Geometry and kernel ops of the port (counterpart of ``chore_tpu.ops``)."""
from chore_tpu_torch.ops.camera import (
    OrthographicCamera,
    PerspectiveCamera,
    Z0,
)
from chore_tpu_torch.ops.chamfer import (
    chamfer_eval,
    masked_chamfer_sq,
    nn_sqdist,
)
from chore_tpu_torch.ops.grid_sample import bilinear_sample
from chore_tpu_torch.ops.point_mesh import point_mesh_udf
from chore_tpu_torch.ops.procrustes import (
    align_points,
    apply_transform,
    similarity_transform,
)
from chore_tpu_torch.ops.rotation import (
    axis_angle_to_matrix,
    init_object_orientation,
    project_so3,
    project_so3_jittered,
)

__all__ = [
    "OrthographicCamera",
    "PerspectiveCamera",
    "Z0",
    "chamfer_eval",
    "masked_chamfer_sq",
    "nn_sqdist",
    "bilinear_sample",
    "point_mesh_udf",
    "align_points",
    "apply_transform",
    "similarity_transform",
    "axis_angle_to_matrix",
    "init_object_orientation",
    "project_so3",
    "project_so3_jittered",
]
