"""The silhouette-phase fit of ``test_torch_port_fit_sil.py`` with the
offscreen guard on (``offscreen_guard=True``: the hinge on projected
vertices leaving the ROI joins the sil losses), against ``chore_tpu``:
per-step object-chain traces and the final parameters."""
from test_torch_port_util import (
    assert_final_params_match,
    assert_traces_match,
    sil_fit_case,
)


def test_object_chain_matches():
    out_j, out_t = sil_fit_case({"offscreen_guard": True})
    assert_traces_match(out_j["obj_trace"], out_t["obj_trace"],
                        ["obj", "sil", "joint"], moved=True)
    assert_final_params_match(out_j, out_t)
