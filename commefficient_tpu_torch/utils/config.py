"""The port's command-line flags: every option of the JAX package's
``utils/config.py`` parser, with the same names, types, choices and
defaults, plus ``--device``, so a launch command of the reference parses
here. The flags of features the port does not run (``_UNPORTED``:
``--split_compile``) parse at the reference's defaults, and
``resolve_defaults`` refuses any other value by name: accepted and
ignored is never an outcome. ``--share_ps_gpu`` and ``--port`` are the
reference's own no-ops, and ``--topk_recall`` is the recall target of a
TPU's approximate selection, which the port's exact selections do not
read."""

from __future__ import annotations

import argparse

from ..modes.config import MODES, ModeConfig
from ..obs.profiler import parse_rounds_spec
from ..obs.slo import parse_rules


# the reference's flags for what the port does not run: (flag, its
# add_argument keywords as in the reference, the values the port runs, why
# another value is refused, the ROADMAP Queue 1 item that brings it or None
# when none is queued)
_UNPORTED = (
    ("split_compile", dict(action="store_true"), (False,),
     "the port runs eagerly and compiles no program to split", None),
)


def _unported(task: str) -> tuple:
    return _UNPORTED


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
                   help="top-k selection: exact, approx (the exact selection off "
                        "a TPU), or oversample (an approx 4k-candidate preselect and "
                        "the exact refine)")
    p.add_argument("--topk_recall", type=float, default=0.95,
                   help="recall target of --topk_impl approx/oversample on a TPU; "
                        "accepted at any value (the exact selections here do not "
                        "read it)")
    p.add_argument("--sketch_path", default="ravel", choices=["ravel", "layerwise"],
                   help="mode=sketch only: how the round's Count-Sketch table is built. "
                        "ravel (default) concatenates every layer into one flat [d] "
                        "gradient before compressing (the reference flat path); layerwise "
                        "folds each layer's gradient block straight into the running r x c "
                        "table as it comes off the backward pass — the dense [d] gradient "
                        "(and the flat params copy for the delta apply) never materializes, "
                        "so peak sketch-side memory is O(r*c) + one layer instead of O(d). "
                        "Pinned bit-identical to ravel (fused, split, sharded). In this "
                        "port layerwise gives ravel's bits by construction (the client phase "
                        "is ravel's; only the table is folded leaf by leaf) and does not "
                        "lower peak memory: the flat params and the reduced [d] update stay")
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
    p.add_argument("--serve_pipeline", action="store_true",
                   help="run the serve cycle ahead of the merge on a worker thread "
                        "(serve/pipeline.py): round N+1's invite/collect/close overlaps "
                        "round N's merge, bitwise the serial service")
    p.add_argument("--serve_async", action="store_true",
                   help="buffered asynchronous aggregation (FedBuff-shaped): rounds close at a "
                        "buffer-size trigger (--serve_buffer) instead of the quorum, and late "
                        "tables (stragglers past the trigger, pushes for a recently closed "
                        "round) fold into a later merge weighted (1+lag)^-alpha. Needs "
                        "--serve_payload sketch; with --merge_policy trimmed|median the stale "
                        "tables join the robust order statistics. A run where everyone "
                        "answers on time is bitwise the sync run")
    p.add_argument("--serve_buffer", type=int, default=0,
                   help="--serve_async: the merged-table count that closes a round (replaces "
                        "the quorum; 0 = the --serve_quorum value)")
    p.add_argument("--serve_staleness", type=float, default=0.5,
                   help="--serve_async: the staleness exponent alpha, a table lag rounds late "
                        "folds with weight (1+lag)^-alpha (0 = unweighted)")
    p.add_argument("--serve_stale_rounds", type=int, default=1,
                   help="--serve_async: how many rounds behind the newest window a late table "
                        "is still admitted and folded; older ones bounce OUT_OF_ROUND and a "
                        "parked one is dropped (counted)")
    p.add_argument("--serve_fastpath", action="store_true",
                   help="the zero-copy ingest-to-merge fast path: each accepted r x c table "
                        "is written once, straight into a pinned host ring block sized by "
                        "the cohort (serve/ring.py), and copied to the device in chunks "
                        "while the round's window is still open; over the socket the "
                        "validation also runs in batches (vectorized finite/L2 screen, "
                        "--serve_gauntlet_workers). Verdicts, counters and the served "
                        "round's bytes are bitwise the run without it. Needs "
                        "--serve_payload sketch")
    p.add_argument("--serve_gauntlet_workers", type=int, default=2,
                   help="--serve_fastpath over the socket: threads draining the batched "
                        "validation (up to 32 queued frames a drain, screened as one numpy "
                        "block); in process the validation runs inline and ignores this")
    p.add_argument("--serve_shards", type=int, default=0,
                   help=">= 2 shards the socket ingest that many ways, clients routed by "
                        "client-id hash: connection handling and the payload validation "
                        "spread over reactor threads or worker processes "
                        "(--serve_shard_mode). Per-shard admission and shed counters and "
                        "load-scaled retry-after hints land in /metrics and /metrics.prom. "
                        "Requires --serve socket --serve_transport eventloop. 0 = one "
                        "listener")
    p.add_argument("--serve_shard_mode", default="thread", choices=["thread", "process"],
                   help="--serve_shards >= 2: what a shard is. thread (default): N reactor "
                        "threads over the one admission queue. process: N SO_REUSEPORT "
                        "worker processes, shared nothing: each owns its clients' admission "
                        "state, and with --serve_fastpath lands validated tables in a "
                        "shared-memory ring block the root copies to the device. Bitwise "
                        "the one-listener run; shard_kill faults SIGKILL workers. Does not "
                        "compose with --serve_pipeline/--serve_async/--serve_edges yet")
    p.add_argument("--serve_edges", type=int, default=0,
                   help=">= 2 arms two-tier edge aggregation (serve/scale/edge.py): the "
                        "cohort partitions over this many edge aggregators by client-id hash; "
                        "each edge validates and ordered-sums its shard's tables and forwards "
                        "ONE r x c partial to the root, which folds the partials in fixed edge "
                        "order, bitwise the flat merge of the same edge-armed session over the "
                        "same surviving cohort. An edge dying == its shard dropped and "
                        "re-queued, bitwise (edge_kill fault kind). A robust --merge_policy "
                        "forwards per-client tables through the tree (a NOTE says so). "
                        "Requires --serve_payload sketch; does not compose with "
                        "--serve_async/--serve_pipeline/--serve_fastpath yet. 0 = flat merge")
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
    # ranks and the client mesh (parallel/): one rank per card
    p.add_argument("--multihost", action="store_true",
                   help="force joining the process group at start-up (a torchrun launch "
                        "of 2+ ranks joins without this flag; see parallel/distributed.py)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0 for --multihost on clusters without a "
                        "launcher's environment")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total ranks for --multihost (with --coordinator_address)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank for --multihost (with --coordinator_address)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="0 = every rank of the job; otherwise it must equal the job's rank "
                        "count (one card per rank)")
    p.add_argument("--mesh", default="",
                   help="client mesh of the sharded round: clients=N[,slices=M], N x M "
                        "ranks (one card each). The sampled cohort shards N x M ways; each "
                        "rank sketches its shard's partial Count Sketch and the ranks "
                        "all-gather the r x c tables and merge them in rank order, instead "
                        "of all-reducing the dense [d] gradient. Must match the job's rank "
                        "count. Unset = shard over every rank of the job")
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
        p.add_argument("--model_parallel", type=int, default=1,
                       help="tensor-parallel ways for the GPT-2 path")
        p.add_argument("--attn_impl", default="dense", choices=["dense", "ring"],
                       help="ring = sequence-parallel ring attention (needs "
                            "--seq_parallel > 1; K/V blocks rotate over ICI)")
        p.add_argument("--seq_parallel", type=int, default=1,
                       help="sequence-parallel ways (mesh 'seq' axis) for "
                            "--attn_impl ring")
        p.add_argument("--mc_coef", type=float, default=0.0,
                       help="> 0 enables the next-utterance-classification head: joint "
                            "loss lm + mc_coef * mc over --num_candidates candidate "
                            "replies (transfer-learning-conv-ai double head)")
        p.add_argument("--moe_experts", type=int, default=0,
                       help="> 0 swaps every 2nd block's MLP for a Switch-style top-1 "
                            "MoE with this many experts (the expert axis replicated)")
        p.add_argument("--moe_aux_coef", type=float, default=0.01,
                       help="weight of the MoE load-balancing aux loss")
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
    # the sharded ingest's launch refusals (before the unported flags, so a
    # process-shard run asking for --serve_edges hears why it cannot compose)
    if args.serve_shards:
        if args.serve_shards < 2:
            raise SystemExit(f"--serve_shards must be >= 2 (or 0 = one listener), got "
                             f"{args.serve_shards}")
        if args.serve != "socket":
            raise SystemExit("--serve_shards shards the socket ingest; arm --serve socket")
        if args.serve_transport != "eventloop":
            raise SystemExit("--serve_shards runs N event-loop reactors; arm --serve_transport "
                             "eventloop (thread-per-connection has no reactor to shard)")
    elif args.serve_shard_mode == "process":
        raise SystemExit("--serve_shard_mode process needs --serve_shards >= 2 (one shard IS "
                         "the plain event-loop transport)")
    if args.serve_shard_mode == "process" and (
            args.serve_pipeline or args.serve_async or args.serve_edges >= 2):
        raise SystemExit("--serve_shard_mode process does not compose with "
                         "--serve_pipeline/--serve_async/--serve_edges yet (admission state "
                         "lives in the worker processes; the cross-process band/boundary/edge "
                         "disciplines are named follow-ups) - drop one of the flags")
    if args.serve_edges:
        if args.serve_edges < 2:
            raise SystemExit(f"--serve_edges must be >= 2 (or 0 = flat merge), got "
                             f"{args.serve_edges} (one edge IS the flat merge)")
        if args.serve == "off":
            raise SystemExit("--serve_edges is a serving topology; arm --serve inproc|socket")
        if args.serve_payload != "sketch":
            raise SystemExit("--serve_edges aggregates client TABLES at the edge tier; the "
                             "announce path has none - arm --serve_payload sketch")
        if args.serve_async or args.serve_pipeline:
            raise SystemExit("--serve_edges does not compose with --serve_async/"
                             "--serve_pipeline yet (stale-fold edge assignment and the "
                             "pipelined worker's edge timing are open follow-ups) - drop one "
                             "of the flags")
        if args.serve_fastpath:
            raise SystemExit("--serve_fastpath does not compose with --serve_edges yet (the "
                             "edge tier consumes the host table stack the ring replaces) - "
                             "drop one of the flags")
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
    if args.serve_async:
        # the fold runs over wire tables: both prerequisites fail at launch
        if args.serve == "off":
            raise SystemExit("--serve_async is a serving mode; arm --serve inproc|socket")
        if args.serve_payload != "sketch":
            raise SystemExit("--serve_async merges client tables as they arrive; the announce "
                             "path has none - arm --serve_payload sketch")
    elif args.serve_buffer:
        raise SystemExit("--serve_buffer is the --serve_async trigger size; without "
                         "--serve_async the close discipline is --serve_quorum")
    if args.serve_fastpath:
        if args.serve == "off":
            raise SystemExit("--serve_fastpath is a serving-path optimization; arm --serve "
                             "inproc|socket")
        if args.serve_payload != "sketch":
            raise SystemExit("--serve_fastpath pins client TABLES into a host ring; the "
                             "announce path has none - arm --serve_payload sketch")
    if args.serve_gauntlet_workers < 1:
        raise SystemExit(f"--serve_gauntlet_workers must be >= 1, got "
                         f"{args.serve_gauntlet_workers}")
    if args.mesh:
        from ..parallel.mesh import parse_mesh_spec

        try:
            parse_mesh_spec(args.mesh)
        except ValueError as e:
            raise SystemExit(str(e)) from None
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
