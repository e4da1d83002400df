"""``chore_tpu_torch.tools.cli_e2e`` against ``tools/cli_e2e.py``:

* ``build_tree`` on 2 frames: given the JAX package's posed body, the same
  files byte for byte (calibrations, info, GT fits, colour, masks, 16-bit
  depth, keypoints, mocap); with the port's own body every file that does
  not hold the body still byte-equal;
* the four port CLIs chained as subprocesses with ``--device cpu`` at
  2 frames, 1 epoch, 1 stack, 64^2 (marked slow: ``cli.recon`` runs the
  release fit schedule, several minutes on the CPU): every child exits 0
  and the results are finite.
"""
import math
import os

import numpy as np
import pytest

from test_torch_port_util import (  # noqa: F401 - a fixture
    few_torch_threads,
    jax_posed_body,
    reference_tool,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

# files of the tree that hold the posed body or a render of it
BODY = ("person_fit.ply", "k1.mocap.ply", "k1.color.json", "k1.color.jpg",
        "k0.color.jpg", "k1.person_mask.jpg")


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("shape,dtype", [
    ((1536, 2048), np.uint16), ((37, 53), np.uint16), ((64, 64, 3), np.uint16),
    ((40, 61), np.uint8), ((40, 61, 3), np.uint8), ((128, 127), np.uint8),
    ((1, 1), np.uint8), ((7, 1), np.uint8), ((1, 9, 3), np.uint8),
    ((3, 5, 3), np.uint8), ((500, 700, 3), np.uint8)])
def test_png_bytes_equal_opencv(shape, dtype):
    """``encode_png`` writes ``cv2.imencode``'s bytes (the tree's 16-bit
    depth maps): small and large, one-pixel-wide, gray and colour."""
    import cv2

    from chore_tpu_torch.data.imageio import encode_png

    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, np.iinfo(dtype).max, shape).astype(dtype)
    if shape == (1536, 2048):
        img[:] = 2000  # the tree's constant depth
    ok, ref = cv2.imencode(".png", img)
    assert ok and encode_png(img) == ref.tobytes()


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax"))
    reference_tool("cli_e2e").build_tree(root, 2)
    return root


def test_build_tree_with_the_reference_body_is_byte_equal(
        reference_tree, tmp_path, monkeypatch):
    from chore_tpu_torch.tools import cli_e2e

    monkeypatch.setattr(cli_e2e, "posed_body", jax_posed_body)
    seq = cli_e2e.build_tree(str(tmp_path), 2, device="cpu")
    assert os.path.basename(seq) == cli_e2e.SEQ_NAME
    files = tree_files(reference_tree)
    assert tree_files(str(tmp_path)) == files and len(files) == 31
    for rel in files:
        assert read(os.path.join(tmp_path, rel)) == read(
            os.path.join(reference_tree, rel)), rel


def test_build_tree_with_its_own_body(reference_tree, tmp_path):
    from chore_tpu_torch.tools import cli_e2e

    cli_e2e.build_tree(str(tmp_path), 2, device="cpu")
    files = tree_files(reference_tree)
    assert tree_files(str(tmp_path)) == files
    for rel in files:
        if os.path.basename(rel) not in BODY:
            assert read(os.path.join(tmp_path, rel)) == read(
                os.path.join(reference_tree, rel)), rel


@pytest.mark.slow
def test_cli_chain_on_the_cpu(tmp_path, capsys):
    from chore_tpu_torch.tools import cli_e2e

    args = cli_e2e.parser().parse_args(
        ["--workdir", str(tmp_path), "--frames", "2", "--epochs", "1",
         "--num-stack", "1", "--img-size", "64", "--device", "cpu"])
    rep, seconds = cli_e2e.chain(args)
    assert rep["cli_chain"] == "preprocess->train->recon->evaluate OK"
    assert rep["frames_evaluated"] == 1
    assert math.isfinite(rep["smpl_cm"]) and math.isfinite(rep["obj_cm"])
    assert list(seconds) == ["build_tree", "preprocess", "train", "recon",
                             "evaluate"]
