"""Test-time data path of the port (numpy only; counterpart of
``chore_tpu.data``)."""
from chore_tpu_torch.data.loader import DataLoader, collate
from chore_tpu_torch.data.paths import (
    DataPaths,
    load_kpts_json,
    load_mocap,
    load_paths,
)
from chore_tpu_torch.data.test_data import TestImagePrep

__all__ = [
    "DataLoader",
    "DataPaths",
    "TestImagePrep",
    "collate",
    "load_kpts_json",
    "load_mocap",
    "load_paths",
]
