"""``cli.recon`` of the port against ``chore_tpu``'s: ``recon_fit`` over a
one-frame sequence (the committed example) writes the same file set and
the same pickle keys (and shapes) with the same checkpoint; a second run
skips the frame; the flags the port does not carry fail with their
reason (``--debug-viz`` is ported: ``test_torch_port_viewer_demo.py``;
``--data-parallel`` too: ``test_torch_port_recon_parallel.py``)."""
import os
import pickle

import numpy as np
import pytest

from test_torch_port_util import (
    API_FIT,
    API_SAMP,
    EXAMPLE_SEQ,
    SMALL_CFG,
    write_jax_checkpoint,
)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from chore_tpu.cli.recon import recon_fit as jrecon
    from chore_tpu.config import ChoreConfig as JCfg
    from chore_tpu.recon.fitter import FitConfig as JFit
    from chore_tpu.recon.generator import SamplerConfig as JSamp
    from chore_tpu_torch.cli.recon import recon_fit as trecon
    from chore_tpu_torch.config import ChoreConfig as TCfg
    from chore_tpu_torch.recon.fitter import FitConfig as TFit
    from chore_tpu_torch.recon.generator import SamplerConfig as TSamp

    tmp = tmp_path_factory.mktemp("cli")
    exp_root = str(tmp / "experiments")
    write_jax_checkpoint(exp_root)
    out_j, out_t = str(tmp / "out_j"), str(tmp / "out_t")
    common = dict(obj_name="basketball", exp_root=exp_root)
    jrecon(JCfg(**SMALL_CFG), EXAMPLE_SEQ, "fit", out_j,
           fit_cfg=JFit(**API_FIT), sampler_cfg=JSamp(**API_SAMP), **common)
    kw = dict(fit_cfg=TFit(**API_FIT), sampler_cfg=TSamp(**API_SAMP),
              device="cpu", **common)
    trecon(TCfg(**SMALL_CFG), EXAMPLE_SEQ, "fit", out_t, **kw)
    return out_j, out_t, kw


def test_same_files_and_pickle_keys(runs):
    out_j, out_t, _ = runs
    files = _files(out_t)
    assert files == _files(out_j)
    assert "example_synth/frame0000/fit/k1.smpl.ply" in files
    for f in files:
        if f.endswith(".pkl"):
            with open(os.path.join(out_j, f), "rb") as fh:
                want = pickle.load(fh)
            with open(os.path.join(out_t, f), "rb") as fh:
                got = pickle.load(fh)
            assert set(got) == set(want), f
            for k in want:
                assert np.shape(got[k]) == np.shape(want[k]), (f, k)


def test_second_run_skips(runs, capsys, monkeypatch):
    """The second run skips the written frame before preparing it (no
    decode or crop for a frame already done)."""
    from chore_tpu_torch.cli.recon import recon_fit
    from chore_tpu_torch.config import ChoreConfig
    from chore_tpu_torch.data import TestImagePrep

    _, out_t, kw = runs
    ply = os.path.join(out_t, "example_synth", "frame0000", "fit",
                       "k1.object.ply")
    before = os.stat(ply).st_mtime_ns
    prepared = []
    monkeypatch.setattr(TestImagePrep, "prepare",
                        lambda self, f, **kw: prepared.append(f))
    fitter = recon_fit(ChoreConfig(**SMALL_CFG), EXAMPLE_SEQ, "fit", out_t,
                       **kw)
    assert "already done, skipped" in capsys.readouterr().out
    assert prepared == []
    assert os.stat(ply).st_mtime_ns == before
    assert fitter.timer.summary() == {}


@pytest.mark.parametrize("flag,why", [
    (["--fused"], "not ported by design"),
])
def test_flags_not_ported_fail(flag, why, capsys):
    from chore_tpu_torch.cli.recon import main

    with pytest.raises(SystemExit) as e:
        main(["-s", EXAMPLE_SEQ, "-sn", "x", *flag])
    assert e.value.code == 2
    assert why in capsys.readouterr().err


def test_data_parallel_flag_reaches_recon_fit(monkeypatch):
    """``--data-parallel`` is ported: it parses and reaches ``recon_fit``
    with the batch size and device as given (the fits themselves:
    ``test_torch_port_recon_parallel.py``)."""
    import chore_tpu_torch.cli.recon as crecon

    seen = {}
    monkeypatch.setattr(crecon, "recon_fit",
                        lambda *a, **kw: seen.update(kw))
    crecon.main(["-s", EXAMPLE_SEQ, "-sn", "x", "--data-parallel", "-bs",
                 "3", "--device", "cpu"])
    assert seen["data_parallel"] is True and seen["batch_size"] == 3
    assert seen["device"] == "cpu"
