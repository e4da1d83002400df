"""Kernel tests that need the card: each hand-written CUDA kernel against
its plain PyTorch version on CUDA tensors. Marked ``cuda``; they skip where
there is no card. This file imports no JAX (the card's machine has none;
``tests/conftest.py`` does), so on the card run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The seeded cases are shared with ``test_torch_port_nn.py``, which holds the
plain version to the TPU kernel on the CPU.
"""
import numpy as np
import pytest
import torch


def make_case(seed, n_x=700, n_y=450, groups=None, mask=None, dups=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_x, 3).astype(np.float32)
    y = rng.randn(n_y, 3).astype(np.float32)
    if dups:
        y[100:150] = y[:50]  # exact duplicates: lowest index must win
    xg = yg = ym = None
    if groups:
        xg = rng.randint(0, groups, n_x).astype(np.int32)
        yg = rng.randint(0, groups, n_y).astype(np.int32)
    if mask is not None:
        ym = rng.rand(n_y) > mask
    return x, y, ym, xg, yg


CASES = {
    "plain": dict(),
    "groups": dict(groups=5),
    "mask": dict(mask=0.4),
    "groups_mask": dict(groups=4, mask=0.4),
    "duplicates": dict(dups=True),
    "ragged": dict(n_x=13, n_y=7),
    "empty_groups": dict(groups=40, n_y=30),  # many queries unmatched
}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on a card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_port_cuda.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    """The CUDA kernel against the plain version on the card: 1e-5 on
    distances (unit-scale points), identical indices, one launch counted."""
    from chore_tpu_torch.ops import nn as tnn
    from chore_tpu_torch.ops.nn import group_rows

    x, y, ym, xg, yg = make_case(3, **CASES[name])
    dev = cuda_device
    opt = lambda a, dt: (  # noqa: E731
        None if a is None else torch.as_tensor(a, dtype=dt)[None].to(dev))
    tx, ty = (torch.as_tensor(a)[None].to(dev) for a in (x, y))
    qg, rg = group_rows(tx, ty, opt(ym, torch.bool), opt(xg, torch.int64),
                        opt(yg, torch.int64))
    before = tnn.launches["nn_grouped"]
    dk, ik = tnn.nn_grouped(tx, ty, qg, rg)
    dp, ip = tnn.nn_sqdist_plain(tx, ty, qg, rg)
    torch.cuda.synchronize()
    assert tnn.launches["nn_grouped"] == before + 1
    assert torch.equal(ik, ip)
    torch.testing.assert_close(dk, dp, atol=1e-5, rtol=0)
