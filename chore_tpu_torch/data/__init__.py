"""Data path of the port (numpy on the host; counterpart of
``chore_tpu.data``)."""
from chore_tpu_torch.data.loader import DataLoader, collate, prefetch_to_device
from chore_tpu_torch.data.paths import (
    DataPaths,
    load_kpts_json,
    load_mocap,
    load_paths,
)
from chore_tpu_torch.data.test_data import TestImagePrep
from chore_tpu_torch.data.train_data import BehaveTrainData

__all__ = [
    "BehaveTrainData",
    "DataLoader",
    "DataPaths",
    "TestImagePrep",
    "collate",
    "load_kpts_json",
    "load_mocap",
    "load_paths",
    "prefetch_to_device",
]
