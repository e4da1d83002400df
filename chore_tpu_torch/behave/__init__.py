"""BEHAVE on-disk readers of the port (counterpart of ``chore_tpu.behave``)."""
from chore_tpu_torch.behave.readers import (
    FrameDataReader,
    KinectCalib,
    KinectFrameReader,
    KinectTransform,
    SeqInfo,
    load_intrinsics,
    load_kinect_poses,
    load_kinect_poses_back,
)

__all__ = [
    "FrameDataReader",
    "KinectCalib",
    "KinectFrameReader",
    "KinectTransform",
    "SeqInfo",
    "load_intrinsics",
    "load_kinect_poses",
    "load_kinect_poses_back",
]
