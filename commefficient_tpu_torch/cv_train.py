"""CV federated training CLI of the port: the twin of the repository's
``cv_train.py`` on CIFAR ResNet-9 and the FEMNIST CNN, in every mode
(sketch, true_topk, local_topk, fedavg, localSGD, uncompressed), driven
through the run loop (``runner/``): async by default, ``--sync_loop`` for
the serial path.

FetchSGD on the GPU (the slice's configuration):
    python -m commefficient_tpu_torch.cv_train --dataset cifar10 --mode sketch \
        --hash_family rotation --num_clients 100 --num_workers 8 \
        --local_batch_size 8 --k 50000 --num_rows 5 --num_cols 524288 \
        --num_rounds 5
On the CPU (small and slow; for checking the path): add --device cpu.
With --checkpoint_dir the run saves verified checkpoints (every
--checkpoint_every rounds and at the end); a SIGTERM makes it finish the
rounds in flight, save and exit 75, and --resume continues from the newest
checkpoint that verifies.

A baseline, e.g. local top-k over 3,550 FEMNIST writers with server-side
(virtual) momentum and error:
    python -m commefficient_tpu_torch.cv_train --dataset femnist --mode local_topk \
        --num_clients 3550 --error_type virtual --momentum_type virtual --k 50000

Observability (``obs/``): --trace and --trace_events record the run's
spans, --profile_rounds START:END (with --profile_dir) a torch.profiler
capture of those rounds, --health_every N the sketch-health block every N
rounds, --ledger PATH one record per committed round (and a postmortem
bundle on exit 75, a watchdog abort or an unhandled exception), --slo
warn|halt the SLO engine; none of them changes a bit of the run.

--dtype bfloat16 computes in bfloat16 as the reference does (parameters,
batch-norm statistics, logits and the sketched gradient stay float32).

The sharded round, one rank per card (``parallel/``): launch the ranks
with torchrun (``torchrun --nproc_per_node 4 -m
commefficient_tpu_torch.cv_train ...``) or with --multihost
--coordinator_address HOST:PORT --num_processes N --process_id I on each;
the cohort shards over them (--mesh clients=N[,slices=M] names the
shape). Every rank trains the same model; rank 0 writes the rows, the
checkpoints and the trace, and rank r > 0 its ledger at PATH.rank<r>. With
--serve the aggregation service runs on rank 0 and shares each close with
the other ranks; --serve_pipeline runs the serve cycle one round ahead on
a worker thread, on one GPU or a group.

Without the CIFAR-10 pickles (or LEAF's FEMNIST json under
--data_root/femnist) the deterministic synthetic set of the same shape is
used.
"""

from __future__ import annotations

import math
import sys

import torch

from .data.cifar import load_cifar_fed
from .data.femnist import load_femnist_fed
from . import obs
from .federated.api import FederatedSession, FedModel, FedOptimizer
from .models.convert import FlatLayout
from .models.femnist_cnn import FEMNISTCNN
from .models.losses import make_classification_loss
from .models.resnet9 import ResNet9, init_weights
from .parallel import distributed
from .resilience import FaultPlan, RetryPolicy
from .runner import RunnerConfig, run_loop
from .serve import service_from_args
from .utils import checkpoint as ckpt
from .utils.config import make_parser, mode_config_from_args, resolve_defaults
from .utils.device import make_reproducible, resolve_device
from .utils.logging import TableLogger
from .utils.schedules import triangular


def build(args, fault_plan=None):
    if fault_plan is None:
        fault_plan = FaultPlan.parse(args.fault_plan)  # refuses an unported kind first
    if torch.device(args.device).type == "cuda":
        make_reproducible()  # before any CUDA work of the run
    device = resolve_device(distributed.local_device(args.device))
    mesh = distributed.cli_mesh(args)
    if args.dataset == "femnist":
        train_set, test_set, num_classes = load_femnist_fed(
            args.data_root, args.num_clients, args.seed)
        model = FEMNISTCNN(num_classes=num_classes, dtype=args.dtype)
    else:
        train_set, test_set, num_classes = load_cifar_fed(
            args.dataset, args.num_clients, args.iid, args.data_root, args.seed,
            synthetic_separation=args.synthetic_separation,
            synthetic_train=args.synthetic_train,
        )
        model = ResNet9(num_classes=num_classes, dtype=args.dtype)
    args.num_clients = train_set.num_clients  # actual shard count
    init_weights(model, args.seed)
    model.to(device)
    layout = FlatLayout(model)
    print(f"model: {type(model).__name__}  d={layout.d:,}  clients={train_set.num_clients}  "
          f"mode={args.mode}  dtype={args.dtype}  device={device}", flush=True)
    session = FederatedSession(
        train_loss_fn=make_classification_loss(model, train=True),
        eval_loss_fn=make_classification_loss(model, train=False),
        params=dict(model.named_parameters()),
        net_state=dict(model.named_buffers()),
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
        # --serve_async: one cohort's worth of stale slots (the trigger
        # bounds how many straggle a round, the band how long they wait)
        stale_slots=args.num_workers if args.serve_async else 0,
        # --serve_edges E >= 2 under the sum (or trimmed at trim 0, which is
        # the sum): the edge tree's merges, the grouped flat twin and the
        # partials root; a robust policy runs the tree in forward mode
        # against the plain robust merge, so the session stays at 0 there
        serve_edges=(args.serve_edges if args.merge_policy == "sum"
                     or (args.merge_policy == "trimmed" and args.merge_trim == 0) else 0),
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
        mesh=mesh,
        sketch_path=args.sketch_path,
    )
    return session, test_set


def main(argv=None):
    args = resolve_defaults(make_parser().parse_args(argv))
    fault_plan = FaultPlan.parse(args.fault_plan)  # refuses an unported kind first
    distributed.join_cli(args, fault_plan)
    # arm (or disarm) the tracer before anything emits
    obs.configure_from_args(args)
    session, test_set = build(args, fault_plan)
    rounds_per_epoch = max(1, math.ceil(args.num_clients / session.num_workers))
    total_rounds = args.num_rounds or int(args.num_epochs * rounds_per_epoch)
    if session.fault_plan is not None:
        # a client_* or wire_* site at a round the run never reaches, a
        # wire_* site on a run with no payload seam, a stale poison with no
        # stale band, an edge kill with no edge tree, or a shard kill with no
        # shard worker to kill, is refused now
        session.fault_plan.validate_rounds(total_rounds, distributed.world_size())
        session.fault_plan.validate_wire_context(
            args.serve != "off" and args.serve_payload == "sketch")
        session.fault_plan.validate_stale_context(
            args.serve != "off" and args.serve_payload == "sketch" and args.serve_async)
        session.fault_plan.validate_edge_context(
            args.serve != "off" and args.serve_payload == "sketch" and args.serve_edges >= 2,
            args.serve_edges)
        session.fault_plan.validate_shard_context(
            args.serve == "socket" and args.serve_shards >= 2
            and args.serve_shard_mode == "process", args.serve_shards)
    opt = FedOptimizer(triangular(args.lr_scale, args.pivot_epoch, args.num_epochs),
                       rounds_per_epoch)
    model = FedModel(session)

    if args.resume and args.checkpoint_dir:
        # newest verified checkpoint; falls back loudly past damaged ones
        path = ckpt.restore_latest(args.checkpoint_dir, session)
        if path:
            opt.round = session.round
            print(f"resumed from {path} at round {session.round}", flush=True)

    logger = TableLogger(args.log_jsonl or None) if distributed.rank() == 0 else None

    def build_row(rnd, m, totals, ev, time_s, nonfinite_total):
        return {
            "round": rnd,
            "epoch": rnd / rounds_per_epoch,
            "lr": m["lr"],
            "train_loss": totals.get("loss_sum", 0.0) / max(totals.get("count", 0.0), 1),
            "train_acc": totals.get("correct", 0.0) / max(totals.get("count", 0.0), 1),
            "test_loss": ev["loss_sum"] / max(ev["count"], 1),
            "test_acc": ev["correct"] / max(ev["count"], 1),
            "comm_mb": session.comm_mb_total,
            "time_s": time_s,
            "nonfinite_rounds": nonfinite_total,
        }

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
                                            args.eval_every or rounds_per_epoch),
                     eval_fn=lambda: model.eval(test_set, args.eval_batch_size),
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
        if logger is not None:
            logger.close()
        wiring.close()
        if service is not None:
            if distributed.rank() == 0:  # a group's other ranks run a follower
                print(f"serve: final metrics {service.metrics_snapshot()}", flush=True)
            service.close()
        # the Chrome trace is written on the preemption and halt exits too
        obs.flush_trace()
    return session


if __name__ == "__main__":
    main(sys.argv[1:])
