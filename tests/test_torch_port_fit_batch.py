"""A multi-frame fit against the JAX package: ``ReconFitter.fit_batch`` at
B=2 with the 'sil' phase, in ``chore_tpu`` and ``chore_tpu_torch``, on two
frames that differ (seeds, person boxes, object disks, crop centres), with
the same weights, SMPL-H arrays and point-generation draws (the JAX draws
replayed into the port) and the fixed 1e-3 SO(3) jitter stand-in.

The fit couples the frames of a batch: every loss term is a mean over the
whole batch, the contact loss divides by the batch's pair count, and the
finite check and the plateau stop read one scalar for the batch. A B=1 test
sees none of that; this one holds the batch semantics to the reference at
the B=1 tests' tolerances.
"""
import numpy as np
import pytest

from test_torch_port_util import (
    SIL_FIT,
    SIL_SAMP,
    assert_clouds_match,
    assert_final_params_match,
    assert_traces_match,
    run_both_fits,
    sil_frame,
)


def position_sensitive_parts(params, gain=2000.0):
    """The field's part head with its first layer's weights on the point's
    position (inputs 256-258: x, y, z - z0) scaled by ``gain``: with the
    tests' small random weights every object point otherwise gets one part
    label, one contact pair per frame, and the batch's pair count is
    always twice a frame's. Here the labels vary with position and the two
    frames' counts differ (3 and 4)."""
    params = {"params": dict(params["params"])}
    parts = dict(params["params"]["parts"])
    k = np.array(parts["fc0"]["kernel"])
    k[256:259] *= gain
    parts["fc0"] = dict(parts["fc0"], kernel=k)
    params["params"]["parts"] = parts
    return params


def two_frames():
    """Two frames (B=2) that differ in every input."""
    a = sil_frame(0)
    b = sil_frame(7, person=(26, 33, 10, 22), disk=(40.2, 35.6, 9.4),
                  crop_center=(990.0, 801.0))
    return tuple(np.concatenate([x, y]) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def both_fits():
    import chore_tpu_torch.recon.losses as L

    counts = []
    contact_loss = L.contact_loss

    def counting(smpl_verts, obj_points, df_hum_o, df_obj_h, part_labels_h,
                 part_labels_o, thresh=0.08, **kw):
        """Records each frame's contact pair count, then the loss."""
        eff_h, eff_o, on = L._contact_masks(df_hum_o, df_obj_h, thresh)
        parts = np.arange(L.SMPL_PARTS_NUM)
        lh = part_labels_h.numpy()[None, :, None] == parts
        lo = part_labels_o.numpy()[..., None] == parts
        nx = (eff_h.numpy()[..., None] & lh).sum(1)
        ny = (eff_o.numpy()[..., None] & lo).sum(1)
        counts.append(((nx > 0) & (ny > 0) & on.numpy()[:, None]).sum(1))
        return contact_loss(smpl_verts, obj_points, df_hum_o, df_obj_h,
                            part_labels_h, part_labels_o, thresh, **kw)

    L.contact_loss = counting
    try:
        out = run_both_fits(SIL_FIT, SIL_SAMP, two_frames(),
                            use_silhouette=True,
                            edit_params=position_sensitive_parts)
    finally:
        L.contact_loss = contact_loss
    return out + (np.array(counts),)


def test_frames_couple_through_the_contact_pair_count(both_fits):
    """The setup reaches the coupling: the two frames' contact pair counts
    differ at some joint step, so the batch's count is not twice a frame's."""
    counts = both_fits[2]
    assert counts.shape[1] == 2 and len(counts) > 0
    assert (counts[:, 0] != counts[:, 1]).any(), counts


def test_point_clouds(both_fits):
    """Each frame's generated clouds from the same draws (1e-4, as B=1)."""
    out_j, out_t, _ = both_fits
    for name in ("human", "object"):
        assert_clouds_match(out_j["pclouds"][name], out_t["pclouds"][name])


@pytest.mark.parametrize("chain,names", [
    ("smpl_trace", ["global", "pose_kpts"]),
    ("obj_trace", ["obj", "sil", "joint"]),
])
def test_loss_traces(both_fits, chain, names):
    """Per-step batch loss of every phase: equal live masks (the same
    early-stop decisions on the batch's scalar) and relative 1e-3."""
    out_j, out_t, _ = both_fits
    assert_traces_match(out_j[chain], out_t[chain], names, moved=True)


def test_iteration_counts(both_fits):
    """Each phase ran as many outer iterations as in the reference (its
    live mask's rows)."""
    out_j, out_t, _ = both_fits
    for chain in ("smpl_trace", "obj_trace"):
        for name, tr in out_j[chain].items():
            want = int(np.asarray(tr["live"]).any(1).sum())
            assert out_t["iters"][name] == want, name


def test_final_parameters(both_fits):
    """Both frames' final SMPL and object parameters, 1e-3 absolute."""
    out_j, out_t, _ = both_fits
    assert_final_params_match(out_j, out_t)
    assert out_t["obj_params"]["obj_t"].shape[0] == 2
