"""SMPL / SMPL-H parameter layout constants (copy of ``chore_tpu/smpl/const.py``)."""

SMPL_POSE_PARAMS_NUM = 72
SMPLH_POSE_PARAMS_NUM = 156
SMPLH_HANDPOSE_START = 66  # hand pose start index for SMPL-H
NUM_BETAS = 10

GLOBAL_POSE_NUM = 3
BODY_POSE_NUM = 63
HAND_POSE_NUM = 90
TOP_BETA_NUM = 2

SMPL_HAND_POSE_NUM = 6

SMPL_PARTS_NUM = 14
NUM_VERTS = 6890
NUM_JOINTS_SMPL = 24
NUM_JOINTS_SMPLH = 52

# body25 keypoint index of the pelvis == the "SMPL center"
BODY25_PELVIS = 8

PART_NAMES = {
    0: "head",
    1: "left foot",
    2: "left hand",
    3: "left leg",
    4: "left midarm",
    5: "left upper arm",
    6: "right foot",
    7: "right hand",
    8: "right leg",
    9: "right midarm",
    10: "right upper arm",
    11: "torso",
    12: "upper left leg",
    13: "upper right leg",
}
