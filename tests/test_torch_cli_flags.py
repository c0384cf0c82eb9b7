"""The port's CLI against the JAX package's: every option string of the
reference's ``make_parser("cv")`` and ``make_parser("gpt2")`` parses in
the port with the reference's type, choices and default, so a reference
launch command never fails by name; a flag of a feature the port does not
run is refused at any other value, by name and with the ROADMAP item that
brings it. The README's main-path command line parses, and the
reference's served wire-payload command line runs."""

import argparse
import os
import shlex

import pytest

from commefficient_tpu.utils.config import make_parser as jmake_parser
from commefficient_tpu_torch.utils import config as tconfig
from test_torch_runner import tiny_cv  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNPORTED = {flag: (ok, item) for flag, _, ok, _, item in tconfig._unported("gpt2")}


def _options(task):
    return [(task, a) for a in jmake_parser(task)._actions
            for s in a.option_strings if s.startswith("--") and s != "--help"]


OPTIONS = _options("cv") + _options("gpt2")


def _port_action(task, dest):
    return next(a for a in tconfig.make_parser(task)._actions if a.dest == dest)


def _other_value(action, ok):
    """A command-line value of ``action`` that the port does not run."""
    if action.choices:
        return next(c for c in action.choices if c not in ok)
    if action.type is int:
        return str((action.default or 0) + 7)
    if action.type is float:
        return str(action.default + 0.5)
    return "elsewhere"


def _parse(task, argv):
    return tconfig.resolve_defaults(tconfig.make_parser(task).parse_args(argv))


@pytest.mark.parametrize("task,ref", OPTIONS,
                         ids=[f"{t}{a.option_strings[0]}" for t, a in OPTIONS])
def test_every_reference_flag_parses_at_its_default(task, ref):
    port = _port_action(task, ref.dest)
    assert port.option_strings == ref.option_strings
    assert (type(port), port.type, port.choices, port.default, port.nargs) == \
        (type(ref), ref.type, ref.choices, ref.default, ref.nargs)
    flag = ref.option_strings[0]
    store_true = isinstance(ref, argparse._StoreTrueAction)
    argv = [] if store_true or ref.default is None else [flag, str(ref.default)]
    args = _parse(task, argv)
    assert getattr(args, ref.dest) == ref.default or ref.dest in ("error_type",
                                                                   "momentum_type")
    if ref.dest not in UNPORTED:
        return
    ok, item = UNPORTED[ref.dest]
    argv = [flag] if store_true else [flag, _other_value(ref, ok)]
    where = f"ROADMAP Queue 1 item {item}" if item is not None else "not queued"
    with pytest.raises(SystemExit, match=f"^{flag} .*{where}"):
        _parse(task, argv)


def test_readme_main_path_command_parses():
    """The README's FetchSGD command line (the north star's main path,
    ``--sketch_path ravel`` included) parses and resolves in the port."""
    text = open(os.path.join(ROOT, "README.md")).read()
    start = text.index("python -m commefficient_tpu_torch.cv_train --device cuda")
    lines = []
    for line in text[start:].splitlines():
        lines.append(line.rstrip("\\").strip())
        if not line.endswith("\\"):
            break
    argv = shlex.split(" ".join(lines))[3:]
    args = _parse("cv", argv)
    assert (args.mode, args.sketch_path, args.hash_family) == ("sketch", "ravel", "rotation")
    # the same flags, less the port's own --device, give the reference the
    # same namespace
    i = argv.index("--device")
    ref = jmake_parser("cv").parse_args(argv[:i] + argv[i + 2:])
    port = vars(tconfig.make_parser("cv").parse_args(argv))
    assert vars(ref) == {k: v for k, v in port.items() if k != "device"}


def test_reference_no_ops_print_their_note(capsys):
    args = _parse("cv", ["--share_ps_gpu", "--port", "29500", "--topk_recall", "0.5"])
    assert args.share_ps_gpu and args.port == 29500 and args.topk_recall == 0.5
    assert "compatibility no-ops" in capsys.readouterr().out


# the reference's served wire-payload command line (tests/test_serve.py's
# CLI payload run, over the socket)
SERVE_SOCKET_SKETCH = (
    "--dataset cifar10 --num_clients 8 --num_workers 4 --local_batch_size 4 --lr_scale 0.05 "
    "--weight_decay 0 --data_root /nonexistent --serve socket --serve_payload sketch "
    "--mode sketch --k 16 --num_cols 256 --num_rows 3 --serve_quorum 3 --serve_deadline 2.0 "
    "--num_rounds 3 --serve_metrics_port 0")


def test_reference_serve_socket_sketch_command_runs(tiny_cv):  # noqa: F811
    """The reference's ``--serve socket --serve_payload sketch`` command
    line gives both parsers the same namespace, and runs through the port's
    CLI on the CPU (the default event-loop engine) to the last round."""
    import numpy as np
    import torch

    from commefficient_tpu_torch import cv_train

    argv = shlex.split(SERVE_SOCKET_SKETCH)
    ref = vars(jmake_parser("cv").parse_args(argv))
    port = vars(tconfig.make_parser("cv").parse_args(argv))
    assert ref == {k: v for k, v in port.items() if k != "device"}
    session = cv_train.main(argv + ["--device", "cpu"])
    assert session.round == 3 and session.cfg.wire_payloads
    assert np.isfinite(session.state["params"].numpy()).all()
    assert torch.count_nonzero(session.state["mode_state"]["Verror"]) > 0


@pytest.mark.parametrize("task", ["cv", "gpt2"])
def test_sketch_path_layerwise_parses(task):
    """--sketch_path layerwise is no longer refused (it was, naming ROADMAP
    item 8): it parses at the reference's choices in both CLIs."""
    assert "sketch_path" not in UNPORTED
    args = _parse(task, ["--mode", "sketch", "--sketch_path", "layerwise"])
    assert args.sketch_path == "layerwise"


def test_moe_and_topk_impl_flags_parse():
    """--moe_experts, --moe_aux_coef and --topk_impl approx|oversample are
    no longer refused (the first two were, naming ROADMAP item 14): they
    parse at the reference's keywords and the impl reaches the mode config
    (``--topk_recall`` parses; the port's exact selections read it nowhere)."""
    assert not {"moe_experts", "moe_aux_coef", "topk_impl"} & set(UNPORTED)
    args = _parse("gpt2", ["--moe_experts", "8", "--moe_aux_coef", "0.02", "--mode", "sketch",
                           "--topk_impl", "oversample", "--topk_recall", "0.9"])
    assert (args.moe_experts, args.moe_aux_coef, args.topk_recall) == (8, 0.02, 0.9)
    assert tconfig.mode_config_from_args(args, 10_000).topk_impl == "oversample"


def test_sketch_path_layerwise_runs(tiny_cv):  # noqa: F811
    """The CV CLI runs --sketch_path layerwise on the CPU to its last round,
    and the session's round takes the layerwise path."""
    import numpy as np

    from commefficient_tpu_torch import cv_train

    argv = shlex.split(
        "--dataset cifar10 --num_clients 8 --num_workers 4 --local_batch_size 4 --mode sketch "
        "--k 16 --num_cols 256 --num_rows 3 --num_rounds 2 --data_root /nonexistent "
        "--sketch_path layerwise --device cpu")
    session = cv_train.main(argv)
    assert session.round == 2 and session.cfg.sketch_path == "layerwise"
    assert np.isfinite(session.state["params"].numpy()).all()


def test_parallelism_flags_parse():
    """--model_parallel, --seq_parallel and --attn_impl ring are no longer
    refused (they were, naming ROADMAP item 14): they parse at the
    reference's keywords and resolve."""
    assert not {"model_parallel", "seq_parallel", "attn_impl"} & set(UNPORTED)
    args = _parse("gpt2", ["--model_parallel", "2", "--seq_parallel", "4", "--attn_impl",
                           "ring"])
    assert (args.model_parallel, args.seq_parallel, args.attn_impl) == (2, 4, "ring")


GPT2_BASE = ["--device", "cpu", "--model_size", "tiny", "--seq_len", "32", "--num_clients", "4",
             "--num_workers", "2", "--num_rounds", "1", "--data_root", "/nonexistent"]
RING_NEEDS_SEQ = ("--attn_impl ring needs --seq_parallel > 1: without a 'seq' mesh axis the "
                  "model silently runs dense attention")


@pytest.mark.parametrize("argv,error,match", [
    # the reference's own refusals, in its words
    (["--attn_impl", "ring"], SystemExit, RING_NEEDS_SEQ),
    (["--attn_impl", "ring", "--seq_parallel", "1", "--model_parallel", "2"], SystemExit,
     RING_NEEDS_SEQ),
    (["--model_parallel", "2"], ValueError,
     "1 devices not divisible by num_slices=1 x seq_parallel=1 x model_parallel=2"),
    (["--seq_parallel", "2", "--attn_impl", "ring"], ValueError,
     "1 devices not divisible by num_slices=1 x seq_parallel=2 x model_parallel=1"),
])
def test_parallelism_refusals(argv, error, match):
    from commefficient_tpu_torch import gpt2_train

    with pytest.raises(error, match=match):
        gpt2_train.main(GPT2_BASE + argv)


@pytest.mark.parametrize("argv,model,seq", [
    (["--model_parallel", "2", "--eval_f1", "2"], 2, 1),
    (["--seq_parallel", "2", "--attn_impl", "ring", "--eval_f1", "2"], 1, 2),
    (["--model_parallel", "2", "--serve", "inproc", "--serve_payload", "sketch"], 2, 1),
    (["--seq_parallel", "2", "--attn_impl", "ring", "--serve", "inproc"], 1, 2),
])
def test_parallel_eval_f1_and_serve_parse_and_build(argv, model, seq):
    """--eval_f1 and --serve with --model_parallel or --seq_parallel > 1
    (once refused by name) parse, and ``build`` takes
    them past every check of its own to the mesh, which in one process
    refuses the job's single rank in the reference's words, as it does
    without them. Their runs on two ranks are in
    tests/test_torch_parallel_2rank.py."""
    from commefficient_tpu_torch import gpt2_train

    args = _parse("gpt2", GPT2_BASE + argv)
    assert (args.model_parallel, args.seq_parallel) == (model, seq)
    assert args.eval_f1 > 0 or args.serve == "inproc"
    with pytest.raises(ValueError, match=f"1 devices not divisible by num_slices=1 x "
                                         f"seq_parallel={seq} x model_parallel={model}"):
        gpt2_train.build(args)
