"""The yardstick's arithmetic: ``flops.py`` against a count worked by hand
from the published layer shapes, and ``rooflines.py`` against the port's
kernel table (PERF.md)."""
from __future__ import annotations

import json
import os

import pytest

from portbench import flops, rooflines

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def release():
    return json.load(open(os.path.join(HERE, "configs",
                                       "chore-release.json")))


def conv_macs(cout, cin, k, h, w):
    return cout * cin * k * k * h * w


def block_macs(cin, cout, h, w):
    half, quarter = cout // 2, cout // 4
    m = (conv_macs(half, cin, 3, h, w) + conv_macs(quarter, half, 3, h, w)
         + conv_macs(quarter, quarter, 3, h, w))
    return m + (conv_macs(cout, cin, 1, h, w) if cin != cout else 0)


def hand_forward(cfg):
    """2 x the multiply-accumulates of every convolution and head layer
    of one image at 512^2 with the configuration's training points."""
    S, N, F = cfg["net_img_size"][0], cfg["num_samples_train"], 256
    o, h = cfg["hourglass_dim"], cfg["hidden_dim"]
    s1, s2 = S // 2, S // 4  # stem output, after the pool
    stem = conv_macs(64, cfg["input_channels"], 7, s1, s1)
    m = stem + block_macs(64, 128, s1, s1)
    m += block_macs(128, 128, s2, s2) + block_macs(128, F, s2, s2)
    per_stack = (block_macs(F, F, s2, s2)                 # b1_2
                 + block_macs(F, F, s2 // 2, s2 // 2)     # b2_2
                 + block_macs(F, F, s2 // 2, s2 // 2)     # b1_1
                 + 3 * block_macs(F, F, s2 // 4, s2 // 4)  # b2_1 b2+ b3_1
                 + block_macs(F, F, s2 // 2, s2 // 2)     # b3_2
                 + block_macs(F, F, s2, s2)               # top_m
                 + conv_macs(F, F, 1, s2, s2)             # conv_last
                 + conv_macs(o, F, 1, s2, s2))            # l
    reinject = conv_macs(F, F, 1, s2, s2) + conv_macs(F, o, 1, s2, s2)
    n = cfg["num_stack"]
    m += n * per_stack + (n - 1) * reinject
    feat = o + 3 + 64
    heads = sum(feat * h + 2 * h * h + h * out
                for out in (2, 9, cfg["num_parts"], 6))
    m += n * N * heads
    return 2 * m, 2 * stem


def test_forward_count_by_hand():
    cfg = release()
    fwd, _ = hand_forward(cfg)
    assert flops.forward_flops_per_image(cfg) == fwd
    assert fwd == pytest.approx(0.3183e12, rel=1e-3)


def test_training_count_by_hand():
    """The backward computes each convolution's and head layer's input
    gradient and weight gradient (each as many operations as its forward),
    but no gradient of the image: 3 x forward less one stem."""
    cfg = release()
    fwd, stem = hand_forward(cfg)
    assert flops.train_flops_per_image(cfg) == 3 * fwd - stem


def test_the_count_does_not_depend_on_the_precision():
    cfg = release()
    assert flops.train_flops_per_image(cfg) == flops.train_flops_per_image(
        {**cfg, "precision": "float32"})


@pytest.mark.parametrize("problems,want,by", [
    # K1 eval 10k^2 x2, the evaluator's frame (4 x 10k^2), label 53k x 6.9k
    ([(1, 10000, 10000, None, False)] * 2, 0.023881, "operations"),
    ([(1, 10000, 10000, None, False)] * 4, 0.047761, "operations"),
    ([(1, 53125, 6890, None, False)], 0.043705, "operations"),
])
def test_k1_bounds_of_the_kernel_table(problems, want, by):
    ms, got_by = rooflines.k1(problems)
    assert round(ms, 6) == want and got_by == by


@pytest.mark.parametrize("faces,want", [(128, 0.000086), (512, 0.000108),
                                        (2048, 0.000196)])
def test_k3_bounds_of_the_kernel_table(faces, want):
    """K3 at 256^2 is bound by its bytes at every template size of the
    table (its live pairs set no larger bound there)."""
    ms, by = rooflines.k3(1, faces, 256, live_pairs=0)
    assert round(ms, 6) == want and by == "bytes"


def test_k2_and_k1_grouped_follow_their_counts():
    """The data-dependent bounds: operations per live or grouped pair."""
    ms, by = rooflines.k2(1, 128, 256, live_pairs=1e9)
    assert by == "operations" and ms == pytest.approx(30e9 / 67e12 * 1e3)
    ms, by = rooflines.k1([(1, 6890, 3000, 21_714_000, True)])
    assert by == "operations"
    assert ms == pytest.approx(8 * 21_714_000 / 67e12 * 1e3)
