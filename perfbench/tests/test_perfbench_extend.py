"""A new configuration, cell and per-layer metric are files and entries
only: a tiny directory laid out as a checkout adds all three, and a run
of the new cell reports the new metric with no file of the harness
edited."""

import json
import os

from perfbench import harness

from . import tiny

READER = '''"""Rounds of the timed window (a test's metric)."""


def read(ctx):
    return float(ctx.window["rounds"]) or None
'''


def test_new_files_and_entries_only(tmp_path):
    cfg = dict(tiny.TINY_GPT2, n_layer=1, n_embd=16, n_head=4)
    cells = {"new-cell": ("new-config", tiny.workload("new-traffic", "uncompressed", 2, 2))}
    root = tiny.make_root(str(tmp_path), cells, {"new-config": cfg})
    with open(os.path.join(root, "perfbench", "metrics", "window.rounds.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "window.rounds", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "run loop",
                               "moves": "updates_per_s", "workloads": ["new-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = harness.run_cell(root, "new-cell", 11, 0.5, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["window.rounds"]["value"] == out["window_rounds"]
    # a sketch metric lists only sketch cells, so this cell leaves it out
    assert "sketch.accumulate_roofline" not in out["metrics"]
