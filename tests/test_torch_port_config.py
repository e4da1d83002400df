"""The port's experiment configuration against ``chore_tpu.config``: the
same ChoreConfig fields and defaults, the same ``config_from_dict`` result
on a reference-style json (aliases, pinned inert keys, a warning for any
other key), a save/load round trip, the ``*_config`` methods' values,
and the flat PATHS.yml reader (which raises on YAML it does not read)."""
import dataclasses
import json
import os
import warnings

import pytest
import torch

import chore_tpu.config as jcfg
import chore_tpu_torch.config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a reference-style experiment json: release values, both name keys (the
# direct field wins over its alias), an alias-only key, inert keys
REFERENCE_JSON = {
    "name": "chore", "exp_name": "chore-release", "schedule": [15, 25],
    "num_threads": 4, "num_stack": 5, "num_hourglass": 2,
    "hourglass_dim": 256, "loadSize": 1200, "z_0": 2.2, "norm": "group",
    "hg_down": "ave_pool", "input_type": "RGBM3", "batch_size": 8,
    "sigmas": [0.08, 0.02, 0.003], "learning_rate": 0.001,
    "gpu_ids": "0", "mlp_dim": [257, 1024, 512], "checkpoints_path": "x",
    "random_flip": True,
}


def test_same_fields_and_defaults():
    j = {f.name: f.default for f in dataclasses.fields(jcfg.ChoreConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tcfg.ChoreConfig)}
    assert t == j
    assert t["precision"] == "mixed"
    assert tcfg.CONFIG_ALIASES == jcfg.CONFIG_ALIASES
    assert tcfg.REFERENCE_INERT_KEYS == jcfg.REFERENCE_INERT_KEYS


@pytest.mark.parametrize("extra", [{}, {"no_such_flag": 3}])
def test_config_from_dict(extra):
    data = {**REFERENCE_JSON, **extra}
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        cj = jcfg.config_from_dict(data)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ct = tcfg.config_from_dict(data)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.exp_name == "chore-release" and ct.milestones == [15, 25]
    assert ct.num_workers == 4
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert len(wt) == len(extra)
    if extra:
        assert "no_such_flag" in str(wt[0].message)


def test_round_trip_between_packages(tmp_path):
    cfg = tcfg.ChoreConfig(exp_name="rt", num_stack=2, precision="float32",
                           net_img_size=(64, 64))
    path = tcfg.save_config(cfg, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "rt.json")
    back = tcfg.load_config("rt", str(tmp_path))
    want = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert dataclasses.asdict(back) == want
    # the JAX package reads the port's file, and the other way round
    assert dataclasses.asdict(jcfg.load_config("rt", str(tmp_path))) == want
    jcfg.save_config(jcfg.ChoreConfig(exp_name="rj"), str(tmp_path))
    assert dataclasses.asdict(tcfg.load_config("rj", str(tmp_path))) == \
        json.loads(json.dumps(dataclasses.asdict(jcfg.ChoreConfig(
            exp_name="rj"))))


@pytest.mark.parametrize("precision,dtype", [("mixed", torch.bfloat16),
                                             ("float32", torch.float32)])
def test_config_methods(precision, dtype):
    """encoder_dtype, and every field of the port's FieldConfig, FitConfig
    and SamplerConfig equal to the JAX methods' same-named field."""
    kw = dict(precision=precision, num_stack=3, loadSize=1100, z_0=2.1,
              net_img_size=(256, 256), filter_val=0.005)
    ct, cj = tcfg.ChoreConfig(**kw), jcfg.ChoreConfig(**kw)
    assert ct.encoder_dtype() == dtype
    assert str(cj.encoder_dtype().dtype if hasattr(cj.encoder_dtype(), "dtype")
               else cj.encoder_dtype()).endswith(str(dtype).split(".")[-1])
    for got, want in ((ct.field_config(), cj.field_config()),
                      (ct.fit_config(), cj.fit_config()),
                      (ct.sampler_config(), cj.sampler_config()),
                      (ct.sampler_config(100), cj.sampler_config(100))):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_load_paths_example_and_nested(tmp_path):
    from chore_tpu_torch.data.paths import load_paths, parse_flat_yaml

    import yaml

    example = os.path.join(REPO, "PATHS.yml.example")
    with open(example) as f:
        text = f.read()
    assert parse_flat_yaml(text) == yaml.safe_load(text)
    load_paths.cache_clear()
    assert load_paths(example)["SMPL_MODEL_ROOT"] == "/data/smpl_models"
    typed = "A: 3\nB: 2.5\nC: true\nD: null\nE: 'q # not a comment'\nF:\n"
    assert parse_flat_yaml(typed) == yaml.safe_load(typed)
    for bad in ("ROOT:\n  SUB: /x\n", "- /a\n- /b\n", "A: &x /p\nB: *x\n",
                "A: [1, 2]\n", "A: |\n  text\n", "---\nA: 1\n"):
        assert isinstance(yaml.safe_load(bad), (dict, list))
        with pytest.raises(ValueError):
            parse_flat_yaml(bad)
    nested = tmp_path / "PATHS.yml"
    nested.write_text("BEHAVE:\n  PATH: /data\n")
    with pytest.raises(ValueError, match="nested"):
        load_paths(str(nested))


def test_seq_info_like_jax(tmp_path):
    from chore_tpu.behave.readers import SeqInfo as JSeqInfo
    from chore_tpu_torch.behave.readers import SeqInfo

    (tmp_path / "info.json").write_text(json.dumps(
        {"cat": "chairwood", "gender": "female", "config": "calib",
         "kinects": [0, 1, 2, 3]}))
    j, t = JSeqInfo(str(tmp_path)), SeqInfo(str(tmp_path))
    for convert in (False, True):
        assert t.get_obj_name(convert) == j.get_obj_name(convert)
    assert t.get_gender() == j.get_gender() == "female"
