"""GPT-2 PersonaChat federated fine-tuning CLI of the port: the twin of the
repository's ``gpt2_train.py`` (one client per persona, the GPT-2 LM loss
or with ``--mc_coef > 0`` the double-head LM + next-utterance objective,
validation NLL and perplexity), driven through the run loop (``runner/``):
async by default, ``--sync_loop`` for the serial path.

FetchSGD on the GPU (the paper's configuration, at GPT-2 small's widths):
    python -m commefficient_tpu_torch.gpt2_train --mode sketch --num_clients 17500 \
        --num_workers 4 --k 50000 --num_cols 1000000 --num_rows 5 --num_blocks 20
On the CPU (small and slow; for checking the path):
    python -m commefficient_tpu_torch.gpt2_train --device cpu --model_size tiny \
        --num_clients 50 --num_workers 4 --num_rounds 10 --mode uncompressed
The double head in bfloat16 (the mc head adds n_embd parameters):
    python -m commefficient_tpu_torch.gpt2_train --mode sketch --num_clients 17500 \
        --num_workers 4 --k 50000 --num_cols 1000000 --num_rows 5 --num_blocks 20 \
        --mc_coef 1 --num_candidates 2 --dtype bfloat16
--init_from DIR starts from a HuggingFace GPT-2 checkpoint (``models/
gpt2_loader.py``) instead of a random init. --checkpoint_dir, --resume and
the preemption exit 75 work as in ``cv_train``.

Observability (``obs/``): --trace and --trace_events record the run's
spans, --profile_rounds START:END (with --profile_dir) a torch.profiler
capture of those rounds, --health_every N the sketch-health block every N
rounds, --ledger PATH one record per committed round (and a postmortem
bundle on exit 75, a watchdog abort or an unhandled exception), --slo
warn|halt the SLO engine; none of them changes a bit of the run.

The port runs the byte-level tokenizer (vocabulary 261) and, without
``personachat_self_original.json`` under --data_root, the deterministic
synthetic persona-grouped corpus, with GPT-2 randomly initialised from
--seed unless --init_from names a checkpoint. Refused by name:
--attn_impl ring, --model_parallel or --seq_parallel > 1 and
--moe_experts > 0.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from .data.personachat import load_personachat_fed
from . import obs
from .federated.api import FederatedSession, FedModel, FedOptimizer
from .models.convert import FlatLayout
from .models.generate import decode_reply, make_generate, word_f1
from .models.gpt2 import SMALL, TINY, GPT2LMHead, init_weights
from .models.gpt2_loader import load_hf_gpt2
from .models.losses import make_lm_loss, make_lm_mc_loss
from .resilience import FaultPlan, RetryPolicy
from .runner import RunnerConfig, run_loop
from .serve import service_from_args
from .utils import checkpoint as ckpt
from .utils.config import make_parser, mode_config_from_args, resolve_defaults
from .utils.device import make_reproducible, resolve_device
from .utils.logging import TableLogger
from .utils.schedules import triangular


def _from_checkpoint(args, tok, with_mc_head: bool) -> tuple[GPT2LMHead, dict, str]:
    """(model, its initial parameters, a note for the start-up line) of
    --init_from: the checkpoint's GPT-2 with the vocabulary grown to the
    tokenizer's and the positions sliced to --seq_len, and with the mc head
    a fresh normal(0.02) ``mc_head`` from a generator seeded --seed."""
    params, cfg = load_hf_gpt2(args.init_from, target_vocab_size=tok.vocab_size,
                               n_positions=max(args.seq_len, 1), dtype=args.dtype)
    cfg = dataclasses.replace(cfg, with_mc_head=with_mc_head)
    model = GPT2LMHead(cfg)
    if with_mc_head:
        gen = torch.Generator().manual_seed(args.seed)
        params["mc_head"] = torch.empty(cfg.n_embd).normal_(0.0, 0.02, generator=gen)
    # structural check: the loaded tree must be the one the model builds
    want = {k: tuple(p.shape) for k, p in model.named_parameters()}
    if {k: tuple(p.shape) for k, p in params.items()} != want:
        raise ValueError(f"checkpoint {args.init_from} does not match the model tree")
    return model, params, f"  init_from={args.init_from}"


def build(args):
    """(session, validation set, {"model", "tok"}) of the parsed flags. The
    model module stays on the host: every forward gets its parameters from
    the session's flat vector (``functional_call``)."""
    fault_plan = FaultPlan.parse(args.fault_plan)  # refuses an unported kind first
    if args.mc_coef > 0 and args.num_candidates < 2:
        raise SystemExit("--mc_coef > 0 needs --num_candidates >= 2 (the MC head scores "
                         "a gold reply against at least one distractor)")
    with_mc_head = args.mc_coef > 0
    if torch.device(args.device).type == "cuda":
        make_reproducible()  # before any CUDA work of the run
    device = resolve_device(args.device)
    train_set, valid_set, tok = load_personachat_fed(
        args.data_root, args.num_clients, args.seq_len, args.seed,
        num_candidates=args.num_candidates if with_mc_head else 1,
        mc_hard_negatives=args.mc_hard_negatives)
    args.num_clients = train_set.num_clients
    if args.init_from:
        model, params, init_note = _from_checkpoint(args, tok, with_mc_head)
    else:
        base = TINY if args.model_size == "tiny" else SMALL
        cfg = dataclasses.replace(base, vocab_size=tok.vocab_size,
                                  n_positions=max(args.seq_len, 1), with_mc_head=with_mc_head,
                                  dtype=args.dtype)
        model = GPT2LMHead(cfg)
        init_weights(model, args.seed)
        params, init_note = dict(model.named_parameters()), ""
    cfg = model.cfg
    layout = FlatLayout(model)
    print(f"model: GPT2({args.model_size})  d={layout.d:,}  vocab={cfg.vocab_size}  "
          f"clients={train_set.num_clients}  mode={args.mode}  dtype={cfg.dtype}  "
          f"device={device}{init_note}", flush=True)
    if with_mc_head:
        train_loss = make_lm_mc_loss(model, True, args.mc_coef, tok.pad_id)
        eval_loss = make_lm_mc_loss(model, False, args.mc_coef, tok.pad_id)
    else:
        train_loss, eval_loss = make_lm_loss(model, train=True), make_lm_loss(model, train=False)
    session = FederatedSession(
        train_loss_fn=train_loss,
        eval_loss_fn=eval_loss,
        params=params,
        net_state={},
        layout=layout,
        mode_cfg=mode_config_from_args(args, layout.d),
        train_set=train_set,
        num_workers=args.num_workers,
        local_batch_size=args.local_batch_size,
        weight_decay=args.weight_decay,
        seed=args.seed,
        on_nonfinite=args.on_nonfinite,
        fault_plan=fault_plan,
        retry_policy=RetryPolicy(max_retries=args.max_retries),
        device=device,
        client_dropout=args.client_dropout,
        dp_clip=args.dp_clip,
        dp_noise=args.dp_noise,
        requeue_policy=args.requeue_policy,
        client_chunk=args.client_chunk,
        # --serve_payload sketch: the two-step wire round (per-client tables,
        # then the table merge) that the service round-trips
        wire_payloads=args.serve != "off" and args.serve_payload == "sketch",
        # the sketch-health estimators at the --health_every cadence and,
        # with --ledger, per-round state fingerprints (both read-only:
        # armed == unarmed, bitwise)
        health_every=args.health_every,
        ledger_fingerprint=bool(args.ledger),
        # the sketch-space quarantine and the robust table merge
        client_update_clip=args.client_update_clip,
        quarantine_window=args.quarantine_window,
        quarantine_scope=args.quarantine_scope,
        merge_policy=args.merge_policy,
        merge_trim=args.merge_trim,
        robust_residual=args.robust_residual == "on",
    )
    return session, valid_set, {"model": model, "tok": tok}


class F1Eval:
    """The generation/F1 evaluator of --eval_f1: decodes the first --eval_f1
    validation dialogs from their packed prompts (the gold reply blanked to
    <pad>) and scores word-level F1 against the gold replies."""

    def __init__(self, args, model, tok, valid_set, device: torch.device):
        ids, types, labels = (np.asarray(a) for a in valid_set.decode_examples(args.eval_f1))
        labelled = labels != -100
        keep = labelled.any(axis=1)  # drop rows whose reply was truncated away
        if not keep.any():
            raise SystemExit(
                f"--eval_f1 {args.eval_f1}: none of the sampled validation packs carry a "
                f"reply at --seq_len {args.seq_len}; raise --seq_len or --eval_f1")
        ids, types, labels, labelled = ids[keep], types[keep], labels[keep], labelled[keep]
        self.prompt_len = labelled.argmax(axis=1).astype(np.int64)
        self.golds = [tok.decode([t for t in row[m] if t != tok.eos_id])
                      for row, m in zip(labels, labelled)]
        tail = np.arange(ids.shape[1])[None] >= self.prompt_len[:, None]
        self.ids = torch.from_numpy(np.where(tail, tok.pad_id, ids)).to(device)
        self.types = torch.from_numpy(np.where(tail, tok.pad_id, types)).to(device)
        self.plen = torch.from_numpy(self.prompt_len).to(device)
        self.tok = tok
        self.generate = make_generate(
            model, eos_id=tok.eos_id, pad_id=tok.pad_id, reply_type_id=tok.speaker2_id,
            max_new=args.decode_max_new, temperature=args.decode_temperature,
            top_p=args.decode_top_p)

    def decode(self, params: dict, rnd: int):
        """(ids [B, T], lengths [B]) on the host; a sampled decode draws from
        a CPU generator seeded 10,000 + rnd."""
        gen = torch.Generator().manual_seed(10_000 + rnd)
        out, lengths = self.generate(params, self.ids, self.types, self.plen, gen)
        return out.cpu().numpy(), lengths.cpu().numpy()

    def __call__(self, params: dict, rnd: int) -> float:
        out, lengths = self.decode(params, rnd)
        preds = [decode_reply(self.tok, row, int(p), int(n))
                 for row, p, n in zip(out, self.prompt_len, lengths)]
        return float(np.mean([word_f1(p, g) for p, g in zip(preds, self.golds)]))


def main(argv=None):
    args = resolve_defaults(make_parser("gpt2").parse_args(argv))
    # arm (or disarm) the tracer before anything emits
    obs.configure_from_args(args)
    session, valid_set, extras = build(args)
    f1_eval = (F1Eval(args, extras["model"], extras["tok"], valid_set, session.device)
               if args.eval_f1 > 0 else None)
    rounds_per_epoch = max(1, math.ceil(args.num_clients / session.num_workers))
    total_rounds = args.num_rounds or int(args.num_epochs * rounds_per_epoch)
    if session.fault_plan is not None:
        # a client_* or wire_* site at a round the run never reaches, or a
        # wire_* site on a run with no payload seam, is refused now
        session.fault_plan.validate_rounds(total_rounds)
        session.fault_plan.validate_wire_context(
            args.serve != "off" and args.serve_payload == "sketch")
    opt = FedOptimizer(triangular(args.lr_scale, args.pivot_epoch, args.num_epochs),
                       rounds_per_epoch)
    model = FedModel(session)

    if args.resume and args.checkpoint_dir:
        # newest verified checkpoint; falls back loudly past damaged ones
        path = ckpt.restore_latest(args.checkpoint_dir, session)
        if path:
            opt.round = session.round
            print(f"resumed from {path} at round {session.round}", flush=True)

    logger = TableLogger(args.log_jsonl or None)

    def build_row(rnd, m, totals, ev, time_s, nonfinite_total):
        train_nll = totals.get("loss_sum", 0.0) / max(totals.get("count", 0.0), 1)
        val_nll = ev["loss_sum"] / max(ev["count"], 1)
        row = {
            "round": rnd,
            "epoch": rnd / rounds_per_epoch,
            "lr": m["lr"],
            "train_nll": train_nll,
            "train_ppl": math.exp(min(train_nll, 20)),
            "val_nll": val_nll,
            "val_ppl": math.exp(min(val_nll, 20)),
            "comm_mb": session.comm_mb_total,
            "time_s": time_s,
            "nonfinite_rounds": nonfinite_total,
        }
        if args.mc_coef > 0:
            # present from the first row: TableLogger freezes its columns
            row["mc_acc"] = totals.get("mc_correct", 0.0) / max(totals.get("mc_count", 0.0), 1)
            row["val_mc_acc"] = ev.get("mc_correct", 0.0) / max(ev.get("mc_count", 0.0), 1)
        if f1_eval is not None:
            row["val_f1"] = f1_eval(model.params, rnd)
        return row

    # --health_every, --slo, --ledger: attached after the restore, so the
    # ledger's resume truncation keys off the restored round
    wiring = obs.attach_from_args(args, session)
    # --serve: the aggregation service drives the loop from its arrival
    # stream (built after the restore, so a resumed service picks up the
    # checkpointed pending queue)
    service = service_from_args(args, session)
    # --profile_dir without --profile_rounds: one capture of the whole run
    capture = obs.profiler.whole_run("" if args.profile_rounds else args.profile_dir,
                                     cuda=session.device.type == "cuda")
    try:
        with capture:
            run_loop(session, opt,
                     RunnerConfig.from_args(args, total_rounds,
                                            args.eval_every or min(rounds_per_epoch, 200)),
                     eval_fn=lambda: model.eval(valid_set, args.eval_batch_size),
                     build_row=build_row, logger=logger,
                     source=service.source() if service is not None else None,
                     slo=wiring.slo_engine, postmortem=wiring.postmortem)
    except Exception as e:
        # the unhandled-exception bundle (the watchdog-abort and exit-75
        # bundles are written inside run_loop)
        if wiring.postmortem is not None:
            wiring.postmortem(f"exception:{type(e).__name__}: {e}")
        raise
    finally:
        logger.close()
        wiring.close()
        if service is not None:
            print(f"serve: final metrics {service.metrics_snapshot()}", flush=True)
            service.close()
        # the Chrome trace is written on the preemption and halt exits too
        obs.flush_trace()
    return session


if __name__ == "__main__":
    main(sys.argv[1:])
