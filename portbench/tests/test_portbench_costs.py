"""The work counted for the rooflines and `mfu` against hand counts, and
the launches of each cell's trip or step against the port's known
counts (chip_smoke.py's MT_LAUNCHES and TRAIN_LAUNCHES)."""

import json
import os

import pytest

from portbench import costs
from portbench.reference import codec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_peaks():
    assert costs.HBM_BYTES_PER_S == 3.35e12
    assert costs.F32_FLOP_PER_S == 67e12
    assert costs.F32X3_FLOP_PER_S == 165e12
    assert costs.BF16_FLOP_PER_S == 989e12


def test_gdn_by_hand():
    # (64 * 128 * 128 rows, C 100): x read and written in float32, gamma
    # and beta; products 2 n C^2; x^2, rsqrt, multiply 3 n C
    n, c = 64 * 128 * 128, 100
    assert costs.gdn_cost(n, c) == (2 * n * c * 4 + (c * c + c) * 4,
                                    2 * n * c * c, 3 * n * c)
    assert costs.gdn_cost(n, c, costs.BF16)[0] == 2 * n * c * 2 + (
        c * c + c) * 4
    # at the 3xTF32 rate the bytes bind at C 100 (838.9 MB against
    # 21 GFLOP), the products at C 256 in bf16
    assert costs.bound_s(costs.gdn_cost(n, c), costs.F32) == pytest.approx(
        (2 * n * c * 4 + (c * c + c) * 4) / 3.35e12)
    assert costs.bound_s(costs.gdn_cost(n, 256, costs.BF16),
                         costs.BF16) == pytest.approx(
        max((2 * n * 256 * 2 + (256 * 256 + 256) * 4) / 3.35e12,
            2 * n * 256 * 256 / 989e12))


def test_deconv_igdn_by_hand():
    # 2x2 -> 4x4, 100 -> 100, batch 64: (5*2-3)^2 = 49 input-tap pairs
    nb, prod, elt = costs.deconv_igdn_cost(64, 2, 2, 100, 100, "igdn")
    assert prod == 2 * 64 * 49 * 100 * 100 + 2 * 64 * 16 * 100 * 100
    assert elt == 64 * 16 * 100 + 3 * 64 * 16 * 100
    assert nb == ((64 * 4 * 100 + 64 * 16 * 100) * 4
                  + (25 * 100 * 100 + 100) * 4 + (100 * 100 + 100) * 4)
    # a 1x1 input reaches 2 of 5 kernel rows and columns
    nb1, prod1, _ = costs.deconv_igdn_cost(1, 1, 1, 128, 100, None)
    assert prod1 == 2 * 4 * 128 * 100
    assert nb1 == (128 + 4 * 100) * 4 + (4 * 128 * 100 + 100) * 4


def test_gdn_backward_by_hand():
    n, c = 16 * 64 * 64, 42
    nb, prod, elt = costs.gdn_backward_cost(n, c)
    assert (nb, prod, elt) == (3 * n * c * 4 + (2 * c * c + 2 * c) * 4,
                               6 * n * c * c, 12 * n * c)
    cuda_cores = max(nb / 3.35e12, (prod + elt) / 67e12)
    tensor_cores = max(nb / 3.35e12, prod / 165e12, elt / 67e12)
    assert costs.gdn_backward_bound_s(n, c) == min(cuda_cores, tensor_cores)


def test_valid_taps_by_hand():
    conv = codec.Layer("c", "conv", 1, 1, 5, 2)
    deconv = codec.Layer("d", "deconv", 1, 1, 5, 2)
    conv3 = codec.Layer("c3", "conv", 1, 1, 3, 1)
    # 5x5/2 on 4: output 0 reads inputs -2..2 (3 inside), output 1 reads
    # 0..4 (4 inside)
    assert costs.valid_taps(4, conv) == 3 + 4
    assert costs.valid_taps(1, conv) == 1
    assert costs.valid_taps(1, deconv) == 2
    assert costs.valid_taps(3, deconv) == 5 * 3 - 3
    assert costs.valid_taps(4, conv3) == 2 + 3 + 3 + 2


@pytest.mark.parametrize("name,program,want", [
    ("rgb", "trip", {"gdn": 11, "deconv_igdn": 7}),
    ("rgb", "train", {"gdn": 18, "gdn_backward": 18}),
    ("shared4", "trip", {"gdn": 35, "deconv_igdn": 28}),
    ("shared4", "train", {"gdn": 63, "gdn_backward": 63}),
])
def test_launches_at_each_cell(name, program, want):
    got = costs.launches(config(name), 64, program)
    assert {k: len(v) for k, v in got.items()} == want


def test_model_products_of_the_rgb_trip_by_hand():
    cfg = config("rgb")
    # the encoder head's first conv: 3x3/1 at 256, 3 -> C/2 = 24: every
    # output reads 3 taps along an axis but the border ones 2: 3*256 - 2
    first = 2 * 766 ** 2 * 3 * 24
    ops = costs.trip_ops(cfg, 1, "trip")
    op, shape, la = ops[0]
    assert (op, shape) == ("conv", (1, 256, 3, 24))
    assert costs.products(op, shape, la) == first
    # the first GDN: 256 * 256 rows of C 24
    assert ops[1][:2] == ("gdn", (256 * 256, 24))
    assert costs.products(*ops[1]) == 2 * 256 * 256 * 24 * 24
    total = costs.model_products(cfg, 1, "trip")
    assert total == sum(costs.products(*o) for o in ops)
    assert 1.9e9 < total < 2.0e9
