"""``Reconstructor.reconstruct`` with the silhouette phase (its default),
``chore_tpu`` against the port on the committed example frame with the
same checkpoint and draws (``test_torch_port_util.api_pair``); the
example's object mask makes the sil ROI a real crop."""
import numpy as np

from test_torch_port_util import api_pair, assert_api_outputs_match


def test_reconstruct_with_silhouette_matches_jax(tmp_path):
    out_j, out_t, rec = api_pair(tmp_path, use_silhouette=True)
    assert_api_outputs_match(out_j, out_t)
    assert rec.fitter.timer.summary()["phase_sil"]["count"] == 1
    assert np.isfinite(out_t["obj_verts"]).all()
