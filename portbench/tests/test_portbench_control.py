"""The control of each training cell comes out not correct: the
reference one precision below the configuration's, in the program's
place, fails at least one of the cell's limits (``control.py``; its
readings at the cells' own sizes, on the card, are in PERF.md)."""
from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import TINY


def fails(cell, values):
    return any(values[k] > v for k, v in cell["limits"].items()
               if k in values)


def readings(name, device, cfg_kw, what):
    cell, cfg = harness.load_cell(name)
    return cell, control.readings(cell, {**cfg, **cfg_kw}, 17, device, what)


@pytest.mark.parametrize("name", ["train-staged", "train-ddp4"])
def test_float8_control_of_the_bfloat16_cells(name):
    """On the CPU at a tiny size, in the configuration's bfloat16."""
    tiny = {k: v for k, v in TINY.items() if k != "precision"}
    cell, got = readings(name, torch.device("cpu"), tiny,
                         ["control", "half_batch"])
    assert fails(cell, got["control"]), got
    assert fails(cell, got["half_batch"]), got


def test_no_exchange_reading_of_the_data_parallel_cell():
    cell, got = readings("train-ddp4", torch.device("cpu"), TINY,
                         ["no_exchange"])
    assert fails(cell, got["no_exchange"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("name,what", [("train-staged-f32", "control"),
                                       ("train-staged", "tf32")])
def test_tf32_in_the_references_place_fails(name, what, card):
    """TF32 exists on the card alone: at the cell's own size, TF32 in the
    reference's place fails the float32 cell's limits, and those of the
    mixed cell, whose heads are float32."""
    cell, got = readings(name, card, {}, [what])
    assert fails(cell, got[what]), got
