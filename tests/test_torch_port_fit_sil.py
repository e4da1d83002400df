"""The whole slice with the silhouette phase against the JAX package:
``ReconFitter.fit_batch(use_silhouette=True)`` in ``chore_tpu`` (its CPU
fit renders through the XLA path) and in ``chore_tpu_torch`` (the plain
versions of K2/K3), on a frame whose masks make the ROI a real crop, with
the same weights, SMPL-H arrays, draws and fixed SO(3) jitter stand-in as
``test_torch_port_fit.py`` (``test_torch_port_util.sil_fit_case``). The
annealed-sigma and offscreen-guard options have a file each
(``test_torch_port_fit_sil_*.py``): a fit pair is the file's budget."""
import numpy as np
import pytest

from test_torch_port_util import (
    assert_final_params_match,
    assert_traces_match,
    sil_fit_case,
)


@pytest.fixture(scope="module")
def both_fits():
    return sil_fit_case()


def test_sil_phase_runs_its_budget(both_fits):
    """Both traces hold the 'sil' phase with iter_sil x steps_per_iter live
    steps (it has no plateau stop), and it moved the object."""
    out_j, out_t = both_fits
    for out in (out_j, out_t):
        live = np.asarray(out["obj_trace"]["sil"]["live"])
        assert live.shape == (2, 3) and live.all()
        assert np.ptp(np.asarray(out["obj_trace"]["sil"]["loss"])) > 0
    assert out_t["iters"]["sil"] == 2


@pytest.mark.parametrize("chain,names", [
    ("smpl_trace", ["global", "pose_kpts"]),
    ("obj_trace", ["obj", "sil", "joint"]),
])
def test_loss_traces(both_fits, chain, names):
    out_j, out_t = both_fits
    assert_traces_match(out_j[chain], out_t[chain], names,
                        moved=chain == "obj_trace")


def test_final_parameters(both_fits):
    assert_final_params_match(*both_fits)
