"""On the card: the TF32 control, the reference computed one precision
below the configuration's float32 in the program's place, fails the check
that the program passes, at a small size (the cell's own size is read by
``python3 -m perfbench.control``)."""

import pytest
import torch

from perfbench import check, harness
from perfbench.reference.fetchsgd import follow

from . import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_tf32_control_fails_where_the_program_passes(card, tmp_path):
    cfg = dict(tiny.TINY_GPT2, n_embd=256, n_head=4, vocab_size=4096)
    cells = {"small": ("small-gpt2", tiny.workload("t", "uncompressed", 4, 2))}
    root = tiny.make_root(str(tmp_path), cells, {"small-gpt2": cfg})
    cell = harness.load_cell(root, "small")
    run = harness.build(cell, 5, "cuda")
    snaps = harness.checked_rounds(run)
    harness.free_program(run)
    ref = harness.reference_side(run)
    prog = check.numbers(cfg, "uncompressed", harness.program_side(run, snaps, ref["p0"]), ref)
    torch.use_deterministic_algorithms(False)
    ctl = follow(cfg, cfg["fetchsgd"], "uncompressed", run.W, run.session_seed, ref["p0"],
                 run.data, 3, prec="tf32")
    ctl = check.numbers(cfg, "uncompressed", ctl, ref)
    keys = ("loss1_gap", "grad_gap")
    assert all(ctl[k] > 10 * prog[k] for k in keys), (prog, ctl)
