"""The port's command-line flags: the subset of the JAX package's
``utils/config.py`` parser that the port honours, with the same names and
defaults, plus ``--device``. A flag of the reference that is not here is not
accepted (argparse rejects it) rather than accepted and ignored."""

from __future__ import annotations

import argparse

from ..modes.config import MODES, ModeConfig


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="commefficient_tpu_torch cv training")
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
    p.add_argument("--dataset", default="cifar10", choices=["cifar10", "cifar100", "femnist"])
    p.add_argument("--synthetic_separation", type=float, default=1.0,
                   help="class-prototype scale for the synthetic CIFAR fallback")
    p.add_argument("--synthetic_train", type=int, default=10000,
                   help="synthetic-CIFAR fallback train-set size")
    # the run loop (runner/)
    p.add_argument("--rounds_per_dispatch", type=int, default=1,
                   help="> 1 runs this many rounds per dispatch with one host-to-"
                        "device copy of their stacked batches and one metrics "
                        "read per block")
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
                        "ckpt_partial; seed=N. Unset = no injection")
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
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
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
