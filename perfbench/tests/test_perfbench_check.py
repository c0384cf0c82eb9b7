"""Whole runs of tiny cells on the CPU, past the harness's look for a
card: the port's rounds pass the check against the reference, and a
program run in bfloat16 or broken underneath fails it, once for each
fault a training cell can have on one chip (a step that returns its state
unchanged; half of the cohort left out, the mean taken over the rest)."""

import dataclasses
import types

import pytest
import torch

from commefficient_tpu_torch.federated import engine
from perfbench import harness

from . import tiny

SEED = 2**31 + 7  # above what 32 signed bits hold, as the driver's are


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    cfgs = {"tiny-gpt2": tiny.TINY_GPT2, "tiny-resnet9": tiny.TINY_RESNET9,
            "tiny-gpt2-bf16": dict(tiny.TINY_GPT2, dtype="bfloat16")}
    cells = {
        "tiny-gpt2-sketch": ("tiny-gpt2", tiny.workload("t-sketch", "sketch", 4, 2)),
        "tiny-gpt2-uncompressed": ("tiny-gpt2", tiny.workload("t-unc", "uncompressed", 4, 2)),
        "tiny-resnet9-sketch": ("tiny-resnet9", tiny.workload("t-sketch", "sketch", 2, 2)),
        "tiny-gpt2-bf16-sketch": ("tiny-gpt2-bf16", tiny.workload("t-sketch", "sketch", 4, 2)),
    }
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")), cells, cfgs)


def _run(root, cell, trace=False):
    return harness.run_cell(root, cell, SEED, 0.5, trace, device="cpu")


@pytest.mark.parametrize("cell", ["tiny-gpt2-sketch", "tiny-gpt2-uncompressed",
                                  "tiny-resnet9-sketch"])
def test_port_passes(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == out["window_rounds"] * (2 if "resnet9" in cell else 4)
    # the CPU has no device memory statistics: the peak reads nothing there
    assert set(out["metrics"]) == {"updates_per_s", "round_ms_p90", "setup_s"}


def test_bfloat16_program_fails(root):
    out = _run(root, "tiny-gpt2-bf16-sketch")
    assert not out["correct"], out["checks"]


def test_state_left_unchanged_fails(root, monkeypatch):
    real = engine.make_round_step

    def unchanged(loss_fn, cfg, layout):
        step = real(loss_fn, cfg, layout)

        def frozen(state, batch, client_rows, lr):
            new, rows, metrics = step(state, batch, client_rows, lr)
            return dict(state, round=new["round"]), client_rows, metrics

        return frozen

    monkeypatch.setattr(engine, "make_round_step", unchanged)
    out = _run(root, "tiny-gpt2-sketch")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny-gpt2-sketch", "tiny-gpt2-uncompressed"])
def test_half_cohort_left_out_fails(root, monkeypatch, cell):
    real = engine._cohort_part

    def half(cfg, state, batch, num_sampled=None, lo=0):
        batch, n, part = real(cfg, state, batch, num_sampled, lo)
        keep = (torch.arange(part.shape[0], device=part.device) < part.shape[0] // 2)
        return batch, n, part * keep.to(part.dtype)

    monkeypatch.setattr(engine, "_cohort_part", half)
    out = _run(root, cell)
    assert not out["correct"], out["checks"]


def test_traced_run_reads_the_host_metrics(root):
    out = _run(root, "tiny-gpt2-sketch", trace=True)
    assert out["correct"]
    # the CPU has no device timeline: the device metrics read nothing
    assert {"loop.dispatch_ms", "loop.prepare_wait_ms", "device.step_mfu"} == set(out["metrics"])
    assert out["busy_s"] == 0.0 and out["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("n, want", [(10, 9), (100, 90), (1, 1)])
def test_p90_takes_the_nearest_rank(root, n, want):
    read = harness.load_metric(harness.load_cell(root, "tiny-gpt2-sketch"), "round_ms_p90")
    ctx = types.SimpleNamespace(window={"round_ms": [float(i) for i in range(n, 0, -1)]})
    assert read(ctx) == want


def test_cell_files_must_agree(root, tmp_path):
    cell = harness.load_cell(root, "tiny-gpt2-sketch")
    assert dataclasses.asdict(cell)["workload"]["traffic"] == "t-sketch"
    with pytest.raises(SystemExit):
        harness.load_cell(root, "no-such-cell")
