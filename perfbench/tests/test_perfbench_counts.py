"""The benchmark's counts reproduce the figures worked out by hand from
the models' shapes."""

import json
import os

import pytest

from perfbench import counts
from perfbench.reference import layout as rlayout

from .tiny import BENCH


def _config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_resnet9_macs_and_round_flops():
    assert counts.resnet9_macs_per_image() == 379_261_952
    # forward 0.7585 GFLOP an image, 3x for training: 1.1378 TFLOP a round
    assert counts.round_flops(_config("resnet9-cifar10"), 100, 5) == pytest.approx(
        1.1378e12, rel=1e-4)


def test_gpt2_round_flops():
    cfg = _config("gpt2-small")
    assert counts.gpt2_matmul_params(cfg) == 123_532_032
    assert counts.round_flops(cfg, 4, 8) == pytest.approx(6.304e12, rel=1e-4)


@pytest.mark.parametrize("name, d, nbytes, ms", [
    ("resnet9-cifar10", 6_573_130, 36.8e6, 0.0110),
    ("gpt2-small", 124_439_808, 517.8e6, 0.1546),
])
def test_flat_size_and_sketch_bytes(name, d, nbytes, ms):
    cfg = _config(name)
    assert sum(leaf.size for leaf in rlayout.leaves(cfg)) == d
    f = cfg["fetchsgd"]
    b = counts.sketch_bytes(d, f["num_rows"], f["num_cols"])
    assert b == pytest.approx(nbytes, rel=1e-3)
    assert b / counts.H100_HBM_BYTES_PER_S * 1e3 == pytest.approx(ms, rel=5e-3)
    # a kernel that takes exactly the bound reads 100 %
    assert counts.roofline_share(b, b / counts.H100_HBM_BYTES_PER_S) == pytest.approx(100.0)
