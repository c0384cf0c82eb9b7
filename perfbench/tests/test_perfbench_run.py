"""The command's refusals: without a CUDA device it exits non-zero and
prints no result line."""

import json
import os
import subprocess
import sys

import pytest

from .tiny import ROOT


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "resnet9-sketch-w100", "--seed", str(2**31 + 1), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_unknown_workload_is_refused():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_benchmark_names_its_files(key):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench[key]:
        if key == "configs":
            assert os.path.exists(os.path.join(ROOT, entry["file"]))
        elif key == "workloads":
            assert os.path.exists(os.path.join(ROOT, "perfbench", "workloads",
                                               f"{entry['name']}.json"))
        else:
            assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                               f"{entry['name']}.py"))
            assert key == "per_layer" or 0.01 <= entry["bound"] <= 0.25
