"""The port's command-line flags: every option of the JAX package's
``utils/config.py`` parser, with the same names, types, choices and
defaults, plus ``--device``, so a launch command of the reference parses
here. The flags of features the port does not run yet (``_UNPORTED``:
the layerwise sketch path, the
pipelined, buffered-async, fast-path, sharded and edge-tree serving
variants, meshes and processes, and
GPT-2's ring attention, mixture of experts and parallelism) parse at the
reference's defaults, and ``resolve_defaults`` refuses any other value
by name, with the ROADMAP Queue 1 item that brings the feature: accepted
and ignored is never an outcome. ``--share_ps_gpu`` and ``--port`` are the
reference's own no-ops, and ``--topk_recall`` matters only to the top-k
selections the port refuses (``--topk_impl approx|oversample``)."""

from __future__ import annotations

import argparse

from ..modes.config import MODES, ModeConfig
from ..obs.profiler import parse_rounds_spec
from ..obs.slo import parse_rules


# the reference's flags for what the port does not run: (flag, its
# add_argument keywords as in the reference, the values the port runs, why
# another value is refused, the ROADMAP Queue 1 item that brings it or None
# when none is queued)
_SERVE = "the port runs the synchronous serial service only"
_MULTI = "the port runs one process on one device"
_UNPORTED = (
    ("sketch_path", dict(default="ravel", choices=["ravel", "layerwise"]), ("ravel",),
     "the layerwise sketch path is not ported", 8),
    ("serve_pipeline", dict(action="store_true"), (False,), _SERVE, "9b"),
    ("serve_async", dict(action="store_true"), (False,), _SERVE, "9b"),
    ("serve_buffer", dict(type=int, default=0), (0,), _SERVE, "9b"),
    ("serve_staleness", dict(type=float, default=0.5), (0.5,), _SERVE, "9b"),
    ("serve_stale_rounds", dict(type=int, default=1), (1,), _SERVE, "9b"),
    ("serve_shards", dict(type=int, default=0), (0,), _SERVE, "9b"),
    ("serve_shard_mode", dict(default="thread", choices=["thread", "process"]), ("thread",),
     _SERVE, "9b"),
    ("serve_edges", dict(type=int, default=0), (0,), _SERVE, "9b"),
    ("serve_fastpath", dict(action="store_true"), (False,), _SERVE, "9b"),
    ("serve_gauntlet_workers", dict(type=int, default=2), (2,), _SERVE, "9b"),
    ("split_compile", dict(action="store_true"), (False,),
     "the port runs eagerly and compiles no program to split", None),
    ("multihost", dict(action="store_true"), (False,), _MULTI, 7),
    ("coordinator_address", dict(default=None), (None,), _MULTI, 7),
    ("num_processes", dict(type=int, default=None), (None,), _MULTI, 7),
    ("process_id", dict(type=int, default=None), (None,), _MULTI, 7),
    ("num_devices", dict(type=int, default=0, help="0 = all visible; the port runs one"),
     (0, 1), _MULTI, 7),
    ("mesh", dict(default=""), ("",), _MULTI, 7),
)
_PARALLEL = "tensor, sequence and expert parallelism are not ported"
_UNPORTED_GPT2 = (
    ("attn_impl", dict(default="dense", choices=["dense", "ring"]), ("dense",),
     "ring attention is not ported", 14),
    ("model_parallel", dict(type=int, default=1), (1,), _PARALLEL, 14),
    ("seq_parallel", dict(type=int, default=1), (1,), _PARALLEL, 14),
    ("moe_experts", dict(type=int, default=0), (0,), "mixture of experts is not ported", 14),
    ("moe_aux_coef", dict(type=float, default=0.01), (0.01,),
     "mixture of experts is not ported", 14),
)


def _unported(task: str) -> tuple:
    return _UNPORTED + (_UNPORTED_GPT2 if task == "gpt2" else ())


def make_parser(task: str = "cv") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"commefficient_tpu_torch {task} training")
    # compression / update mode
    p.add_argument("--mode", default="uncompressed", choices=list(MODES))
    p.add_argument("--error_type", default=None, choices=["none", "local", "virtual"],
                   help="default: virtual for sketch/true_topk, local for local_topk, "
                        "else none")
    p.add_argument("--momentum_type", default=None, choices=["none", "virtual", "local"],
                   help="default with --momentum > 0: local for local_topk, else "
                        "virtual; none otherwise")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--k", type=int, default=50000)
    p.add_argument("--num_rows", type=int, default=5)
    p.add_argument("--num_cols", type=int, default=500000)
    p.add_argument("--num_blocks", type=int, default=1)
    p.add_argument("--topk_impl", default="exact", choices=["exact", "approx", "oversample"],
                   help="top-k selection; the port runs exact only (approx and "
                        "oversample raise)")
    p.add_argument("--topk_recall", type=float, default=0.95,
                   help="recall target of --topk_impl approx/oversample; accepted "
                        "at any value (exact top-k does not read it)")
    p.add_argument("--server_state", default="dense", choices=["dense", "sketch"],
                   help="server optimizer state: dense [d] Vvelocity/Verror, or "
                        "r x c Count-Sketch tables (true_topk, and local_topk with "
                        "virtual error; mode=sketch is sketch-state either way)")
    p.add_argument("--hash_family", default="rotation", choices=["rotation", "random"],
                   help="sketch bucket-hash family: rotation (the CUDA kernels' "
                        "family, default) or random (per-coordinate hashing)")
    p.add_argument("--agg_op", default="mean", choices=["mean", "sum"],
                   help="client-wire aggregation: mean or sum (FetchSGD Alg. 1; "
                        "sum@lr == mean@lr*W exactly)")
    # federation shape
    p.add_argument("--num_clients", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=8,
                   help="clients sampled (simulated) per round")
    p.add_argument("--local_batch_size", type=int, default=8)
    p.add_argument("--num_local_iters", type=int, default=1,
                   help="fedavg/localSGD: local SGD steps per round")
    p.add_argument("--server_lr", type=float, default=1.0,
                   help="fedavg/localSGD: server rate on the averaged weight delta "
                        "(with --momentum_type virtual this is slowmo)")
    p.add_argument("--iid", action="store_true")
    # optimisation
    p.add_argument("--num_epochs", type=float, default=24)
    p.add_argument("--lr_scale", type=float, default=0.4)
    p.add_argument("--pivot_epoch", type=float, default=5)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    # differential privacy
    p.add_argument("--dp_clip", type=float, default=0.0,
                   help="L2 clip of each client's update (0 = off)")
    p.add_argument("--dp_noise", type=float, default=0.0,
                   help="central-DP noise multiplier on the aggregate (needs "
                        "--dp_clip; refused with mode=sketch, client-local state "
                        "and batch-norm models)")
    # client participation
    p.add_argument("--client_dropout", type=float, default=0.0,
                   help="per-round probability that each sampled client drops "
                        "before aggregation (straggler simulation)")
    p.add_argument("--requeue_policy", default="fifo", choices=["fifo", "aged"],
                   help="serving order of the dropped-client queue: fifo (drop "
                        "order) or aged (weighted by rounds waiting); neither "
                        "draws from the host sampling stream")
    # the sketch-space quarantine and the Byzantine-robust table merge
    p.add_argument("--client_update_clip", type=float, default=0.0,
                   help="sketch-space quarantine: reject any client whose update L2 "
                        "exceeds this multiple of the running median of live client "
                        "norms (non-finite updates always rejected); the client leaves "
                        "the merge and the renormalization, counted per round as "
                        "clients_quarantined. 0 = off")
    p.add_argument("--quarantine_window", type=int, default=1,
                   help="--client_update_clip baseline: 1 screens against the last "
                        "non-empty round's live-cohort median; K > 1 against the median "
                        "over a ring of the last K rounds' medians")
    p.add_argument("--quarantine_scope", default="cohort", choices=["cohort", "layer"],
                   help="--client_update_clip granularity: cohort (one L2 per client) or "
                        "layer (also each parameter leaf's L2 against that leaf's own "
                        "running-median ring; a client over any of them is rejected)")
    p.add_argument("--merge_policy", default="sum", choices=["sum", "trimmed", "median"],
                   help="how per-client Count-Sketch tables combine: sum (the linear "
                        "ordered sum), trimmed (per table coordinate, drop --merge_trim "
                        "live contributions at each end, ties by client index) or median "
                        "(coordinate-wise). A robust policy runs the per-client-table "
                        "round and needs --mode sketch")
    p.add_argument("--merge_trim", type=int, default=0,
                   help="--merge_policy trimmed: contributions dropped per coordinate from "
                        "each end (needs 2*trim < --num_workers); 0 trims nothing: the "
                        "sum")
    p.add_argument("--robust_residual", default="off", choices=["off", "on"],
                   help="with --merge_policy trimmed|median: add the winsorized "
                        "mean-minus-robust residual into the Verror table, so the honest "
                        "mass the robust merge declines re-enters through error feedback")
    # run plumbing
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--on_nonfinite", default="skip", choices=["off", "skip", "halt"],
                   help="NaN/Inf aggregate guard: skip treats the poisoned round "
                        "as fully dropped (state stays clean; counted in "
                        "metrics), halt additionally checkpoints and exits, off "
                        "lets the poison through")
    p.add_argument("--eval_batch_size", type=int, default=512)
    p.add_argument("--eval_every", type=int, default=0, help="rounds; 0 = once per epoch")
    p.add_argument("--num_rounds", type=int, default=0,
                   help="hard round cap (0 = derive from epochs)")
    p.add_argument("--data_root", default="./data")
    p.add_argument("--log_jsonl", default="")
    # the run loop (runner/)
    p.add_argument("--rounds_per_dispatch", type=int, default=1,
                   help="> 1 runs this many rounds per dispatch with one host-to-"
                        "device copy of their stacked batches and one metrics "
                        "read per block")
    p.add_argument("--client_chunk", type=int, default=0,
                   help="0 vmaps all sampled clients at once; C > 0 vmaps the "
                        "linear grad modes' clients in chunks of C (repaired to a "
                        "divisor of --num_workers), so at most C full gradients "
                        "are live at a time")
    p.add_argument("--sync_loop", action="store_true",
                   help="run the synchronous loop: inline batch assembly, a "
                        "metrics sync per dispatch, blocking checkpoint writes. "
                        "The default async loop overlaps all three and is pinned "
                        "bitwise equal to it")
    p.add_argument("--max_inflight", type=int, default=0,
                   help="async loop: drain when this many rounds are dispatched "
                        "but not committed; 0 = auto-tune from the measured "
                        "host<->device round trip")
    p.add_argument("--prefetch_depth", type=int, default=0,
                   help="async round-preparation lookahead; 0 = auto")
    p.add_argument("--fault_plan", default="",
                   help="deterministic fault injection: ';'-separated "
                        "kind[@round,...][:key=val,...] entries; kinds: preempt, "
                        "stall:secs=S, eval_stall:secs=S, data_fail:times=N, "
                        "nonfinite[:value=inf], ckpt_fail:times=N, ckpt_corrupt, "
                        "ckpt_partial, client_drop:clients=I+J, "
                        "client_straggle:clients=I,secs=S, "
                        "client_poison:clients=I,value=nan|inf|big, "
                        "client_signflip:clients=I, client_scale:clients=I,factor=F, "
                        "client_collude:frac=F, client_normride:clients=I,ride=R, and with "
                        "--serve_payload sketch wire_corrupt/wire_truncate/wire_dup/"
                        "conn_drop:clients=I, wire_delay:clients=I,secs=S; seed=N. "
                        "Unset = no injection")
    p.add_argument("--max_retries", type=int, default=3,
                   help="bounded retries (exponential backoff + jitter) for "
                        "checkpoint IO and data loading")
    p.add_argument("--no_emergency_checkpoint", action="store_true",
                   help="disable the watchdog's emergency checkpoint stage")
    p.add_argument("--watchdog_abort", action="store_true",
                   help="arm the watchdog's last stage: abort a wedged run with "
                        "the resumable exit status 75 (needs --checkpoint_dir)")
    p.add_argument("--checkpoint_dir", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=0, help="rounds; 0 = never")
    # the streaming aggregation service (serve/)
    p.add_argument("--serve", default="off", choices=["off", "inproc", "socket"],
                   help="run the rounds through the aggregation service: in-process "
                        "submissions or a loopback socket")
    p.add_argument("--serve_quorum", type=int, default=0,
                   help="close a served round at this many arrivals (0 = the whole cohort)")
    p.add_argument("--serve_deadline", type=float, default=4.0,
                   help="served round deadline, seconds of (virtual) client latency")
    p.add_argument("--serve_trace", default="",
                   help="traffic trace 'k=v,...' (population, base_rate, "
                        "diurnal_amplitude, diurnal_period_s, burst_rate, burst_size, seed)")
    p.add_argument("--serve_payload", default="announce", choices=["announce", "sketch"],
                   help="announce: submissions announce arrival; sketch: they carry the "
                        "client's Count-Sketch table over the wire (mode=sketch)")
    p.add_argument("--serve_shed_watermark", type=float, default=0.0,
                   help="shed submissions with a retry-after hint past this share of the "
                        "queue's capacity (0 = off)")
    p.add_argument("--serve_transport", default="eventloop", choices=["threaded", "eventloop"],
                   help="socket engine: eventloop (one selectors reactor) or threaded "
                        "(a thread per connection)")
    p.add_argument("--serve_max_conns", type=int, default=0,
                   help="socket connection cap (0 = the engine's default)")
    p.add_argument("--serve_port", type=int, default=0,
                   help="socket bind port (0 = ephemeral)")
    p.add_argument("--serve_metrics_port", type=int, default=-1,
                   help=">= 0 serves GET /metrics on this port (0 = ephemeral)")
    # observability (obs/): the round tracer, the profiler window, sketch
    # health, the round ledger and the SLO engine
    p.add_argument("--trace", default="",
                   help="write a Chrome-trace/Perfetto JSON of the run here: host-side "
                        "spans on named tracks (runner, device, writer, serve-ingest, "
                        "assembler, federated, resilience) with deferred device spans "
                        "closed at drains; no host sync added, a traced run bitwise an "
                        "untraced one. Open in chrome://tracing or ui.perfetto.dev")
    p.add_argument("--trace_events", default="",
                   help="append obs events as JSONL here (one schema-versioned object "
                        "per span or instant, line-buffered whole-line writes); "
                        "independent of --trace, both may be set")
    p.add_argument("--profile_rounds", default="",
                   help="START:END: a torch.profiler capture window that starts before "
                        "round START dispatches and stops after round END commits (whole "
                        "rounds, async pipeline included), exported as a Chrome trace "
                        "into --profile_dir (needed). Without this flag --profile_dir "
                        "captures the whole run")
    p.add_argument("--profile_dir", default="",
                   help="write torch.profiler Chrome traces here")
    p.add_argument("--health_every", type=int, default=0,
                   help="N > 0 computes the sketch-health estimators on the device every "
                        "N rounds (mode=sketch): recall proxy, table saturation, Verror "
                        "health, per-leaf norms, uplink against dense; read at the "
                        "existing drain (no host sync) into health_* registry gauges, the "
                        "trace and the ledger. They only read round state: an armed run "
                        "is bitwise an unarmed one. 0 = off")
    p.add_argument("--ledger", default="",
                   help="append one schema-versioned JSONL record per committed round "
                        "here (cohort, counter deltas, health block, params and "
                        "optimizer fingerprints); --resume continues the same file "
                        "gap-free. Also arms the postmortem bundle at PATH.postmortem/ "
                        "(trace, ledger tail, registry, config, reason) on a watchdog "
                        "abort, an unhandled exception or exit 75. Inspect with "
                        "`python -m commefficient_tpu_torch.obs.ledger diff|replay-check`")
    p.add_argument("--slo", default="off", choices=["off", "warn", "halt"],
                   help="arm the SLO engine: windowed rules over the committed round "
                        "series, evaluated at each commit; warn = stderr, slo_* counters "
                        "and a trace instant; halt = also checkpoint and exit cleanly at "
                        "the next drain boundary")
    p.add_argument("--slo_rules", default="",
                   help="';'-separated rules overriding the default set: "
                        "name:series(>|<|^)threshold[@window], e.g. "
                        "'recall:topk_mass_proxy<0.1@4'. Series: any per-round metric, "
                        "quarantine_rate, stale_fraction, server_idle_ms, or a health "
                        "estimator (needs --health_every). Requires --slo")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="model compute dtype (params, batch-norm statistics, logits "
                        "and the sketched gradient stay float32)")
    # the reference's CLI-compatibility no-ops
    p.add_argument("--share_ps_gpu", action="store_true",
                   help="accepted for reference-CLI compatibility; no-op")
    p.add_argument("--port", type=int, default=0,
                   help="accepted for reference-CLI compatibility; no-op")
    if task == "cv":
        p.add_argument("--dataset", default="cifar10",
                       choices=["cifar10", "cifar100", "femnist"])
        p.add_argument("--synthetic_separation", type=float, default=1.0,
                       help="class-prototype scale for the synthetic CIFAR fallback")
        p.add_argument("--synthetic_train", type=int, default=10000,
                       help="synthetic-CIFAR fallback train-set size")
    else:  # gpt2
        p.add_argument("--dataset", default="personachat", choices=["personachat"])
        p.add_argument("--seq_len", type=int, default=256)
        p.add_argument("--model_size", default="small", choices=["tiny", "small"])
        p.add_argument("--eval_f1", type=int, default=0,
                       help="> 0 decodes this many validation dialogs at every eval "
                            "and logs val_f1 (word-level F1 of the generated reply "
                            "against the gold one)")
        p.add_argument("--decode_max_new", type=int, default=32,
                       help="max generated tokens per reply for --eval_f1")
        p.add_argument("--decode_temperature", type=float, default=0.0,
                       help="0 = greedy; > 0 samples with nucleus top-p")
        p.add_argument("--decode_top_p", type=float, default=0.9)
        p.add_argument("--init_from", default="",
                       help="HF GPT-2 checkpoint dir (config.json + pytorch_model.bin "
                            "or model.safetensors) to fine-tune from; the wte is grown "
                            "for the dialog special tokens")
        p.add_argument("--mc_coef", type=float, default=0.0,
                       help="> 0 enables the next-utterance-classification head: joint "
                            "loss lm + mc_coef * mc over --num_candidates candidate "
                            "replies (transfer-learning-conv-ai double head)")
        p.add_argument("--num_candidates", type=int, default=2,
                       help="candidates per example (gold + distractors) when "
                            "--mc_coef > 0")
        p.add_argument("--mc_hard_negatives", action="store_true",
                       help="synthetic corpus only: draw MC distractors from other "
                            "personas' replies (same word pool) instead of a reserved "
                            "vocabulary half")
    # the reference's flags for what the port does not run: refused by
    # resolve_defaults unless left at the values the port runs
    for flag, kw, ok, why, item in _unported(task):
        p.add_argument(f"--{flag}", **kw, **({} if "help" in kw else {
            "help": f"not ported ({why}); accepted at {ok[0]!r} only"}))
    return p


def resolve_defaults(args: argparse.Namespace) -> argparse.Namespace:
    """Fill the mode-dependent defaults as the reference does, so every flag
    combination maps onto a ModeConfig the mode library implements, and
    refuse contradictory flags."""
    if args.momentum_type is None:
        if args.momentum and args.momentum > 0:
            args.momentum_type = "local" if args.mode == "local_topk" else "virtual"
        else:
            args.momentum_type = "none"
    if args.error_type is None:
        args.error_type = {"sketch": "virtual", "true_topk": "virtual",
                           "local_topk": "local"}.get(args.mode, "none")
    if args.mode in ("fedavg", "localSGD") and args.num_local_iters < 1:
        args.num_local_iters = 1
    for flag, _, ok, why, item in _unported("gpt2"):
        if hasattr(args, flag) and getattr(args, flag) not in ok:
            where = (f"ROADMAP Queue 1 item {item}" if item is not None
                     else "not queued in ROADMAP Queue 1")
            raise SystemExit(f"--{flag} {getattr(args, flag)}: {why} ({where})")
    if args.share_ps_gpu or args.port:
        print("note: --share_ps_gpu/--port are reference-CLI compatibility no-ops (the port "
              "has no worker processes)", flush=True)
    if args.health_every < 0:
        raise SystemExit(f"--health_every must be >= 0, got {args.health_every}")
    if args.health_every and args.mode != "sketch":
        raise SystemExit("--health_every computes SKETCH-wire quality estimators; "
                         f"--mode {args.mode} has no table to estimate from")
    if args.slo_rules and args.slo == "off":
        raise SystemExit("--slo_rules names rules for the SLO engine; arm it with "
                         "--slo warn|halt")
    if args.slo != "off":
        # a typo'd rule fails at launch, not as an absent guard found later
        try:
            parse_rules(args.slo_rules)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.profile_rounds:
        try:
            parse_rounds_spec(args.profile_rounds)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if not args.profile_dir:
            raise SystemExit("--profile_rounds needs --profile_dir (the capture has to be "
                             "written somewhere)")
    if args.robust_residual == "on" and (
            args.merge_policy == "sum" or (args.merge_policy == "trimmed"
                                           and args.merge_trim == 0)):
        # a silent no-op would be found at the postmortem
        raise SystemExit("--robust_residual on names the robust merge's error-feedback "
                         "residual; with --merge_policy sum (or trimmed@0, which is the sum) "
                         "there is no robust merge - arm --merge_policy trimmed (trim > 0) "
                         "or median")
    if args.watchdog_abort and not args.checkpoint_dir:
        raise SystemExit("--watchdog_abort needs --checkpoint_dir: aborting without an "
                         "emergency checkpoint would lose the run instead of resuming it")
    return args


def mode_config_from_args(args: argparse.Namespace, d: int) -> ModeConfig:
    return ModeConfig(
        mode=args.mode,
        d=d,
        k=min(args.k, d) if args.k else 0,
        num_rows=args.num_rows,
        num_cols=args.num_cols,
        num_blocks=args.num_blocks,
        seed=args.seed,
        momentum=args.momentum if args.momentum_type != "none" else 0.0,
        momentum_type=args.momentum_type,
        error_type=args.error_type,
        num_local_iters=args.num_local_iters if args.mode in ("fedavg", "localSGD") else 1,
        server_lr=args.server_lr if args.mode in ("fedavg", "localSGD") else 1.0,
        num_clients=args.num_clients,
        hash_family=args.hash_family,
        agg_op=args.agg_op,
        topk_impl=args.topk_impl,
        server_state=args.server_state,
    )
