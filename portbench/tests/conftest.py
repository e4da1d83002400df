"""Shared fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``): tiny sizes of the cells' configurations that the CPU
runs in seconds, and the card where a test needs one."""
from __future__ import annotations

import sys

import pytest

# the trainer's optional TensorBoard logger would import TensorFlow (and
# JAX) into the test process, as ``run.py`` keeps it from doing in a run
sys.modules.setdefault("torch.utils.tensorboard", None)

# the release configuration at a size the CPU holds: two stacks, a 32^2
# input, two images of 300 points, 16 output features; float32, where the
# CPU's bfloat16 convolutions would round more than the card's
TINY = {"num_stack": 2, "net_img_size": [32, 32], "batch_size": 2,
        "num_samples_train": 300, "hourglass_dim": 16, "num_workers": 2,
        "boundary_samples": 2000, "precision": "float32"}


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
