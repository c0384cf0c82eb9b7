#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, starts and trains on the card.

Phases (any failure raises, and the exit status is non-zero):
1. card: require CUDA; print the card's name and power limit.
2. build: compile the hand-written CUDA sketch kernels from the checkout.
3. kernel vs plain: each kernel must equal its plain PyTorch version on the
   card (torch.equal: bitwise, up to the sign of zero) at the ResNet-9
   slice's shapes and at small edge shapes (c not a multiple of 4, c below
   the kernels' 2048-item tile, d < c, r = 1 and r = 16).
4. times: each kernel's median over CUDA-event-timed launches, cold (L2
   flushed before each) and warm (its input rewritten just before each, as
   a round finds it), its plain version's, and its bound from the bytes it
   must move at the H100's 3.35 TB/s (or its float32 operations at 67
   TFLOP/s, whichever is larger).
5. main path: ``commefficient_tpu_torch.cv_train.main`` runs 5 FetchSGD
   rounds of full-width ResNet-9 through its default (async) run loop and
   an eval, with the launch counts zeroed
   just before; every logged loss must be finite, each kernel must have
   launched at least once per round, and the params must have moved in at
   most k coordinates per round.
6. checked rounds: one more FetchSGD round, and one uncompressed round
   after the control's first, both at lr 0.1 through ``run_round``; their
   new params are held against the step recomputed on the card from the
   same cohort's reduced gradient (the sketch round through the plain
   sketch and query, the control as ``p - lr * (0.9 V + g)``).
7. card vs CPU: the kernels again on a real reduced gradient and error
   table, and the client reduction of a few cohorts on the card held
   against the same reduction on the CPU; every reading is printed.
8. run loop: the slice through ``cv_train.main``'s run loop (async by
   default), with the launch counts zeroed just before:
   a. the sync loop twice, 6 rounds each, under the entry point's own
      switches (``cv_train.build`` calls ``utils.device.make_reproducible``,
      which makes cuDNN and every other operation deterministic): the final states must be bitwise equal, and every
      comparison below is bitwise;
   b. the async loop with --checkpoint_every 3 (both checkpoints must land
      and verify) and c. with --rounds_per_dispatch 3, each held against
      the sync run (params, Vvelocity, Verror, eval row);
   d. --fault_plan preempt@2 exits 75 with an emergency checkpoint at
      round 3; --resume to round 6 is held against the uninterrupted run;
   e. --fault_plan ckpt_corrupt@3: the resume falls back past the damaged
      round-3 checkpoint to round 2, sets it aside, and ends as (a);
   f. the uncompressed control, 2 rounds, async against sync;
   g. --pairs N alternating sync/async timing pairs (default 2);
   h. the round path between two drains makes no host sync: four
      dispatches run under ``torch.cuda.set_sync_debug_mode("error")``, and
      a profiler window over them and their drain counts the synchronize
      calls.
   Each kernel must have launched exactly once per sketch round of the
   phase; every time is printed beside the card's name and power limit.
9. profile: a torch.profiler window over two more rounds prints the device's
   busy time, idle share and top kernels per round, first under the entry
   point's reproducibility switches, then (for this window only) under
   cuDNN's and PyTorch's defaults: the cost of determinism.
10. baselines: ``cv_train.main`` at full width in FetchSGD's baselines, with
   the launch counts zeroed just before each run:
   a. FEMNIST true_topk, 3,550 synthetic writers, 8 sampled, k = 50,000;
   b. FEMNIST local_topk with virtual momentum and virtual error (no
      client state: 3,550 writers' state would not fit on one card);
   c. ResNet-9 local_topk with the reference's defaults (local momentum and
      local error, 100 clients: 5.3 GB of client state), sync and async
      (with its checkpoint timed) held bitwise, and preempt -> resume
      held bitwise against the uninterrupted run;
   d. ResNet-9 fedavg with 5 local iterations;
   e. ResNet-9 true_topk with --server_state sketch (r = 5, c = 524,288):
      each kernel must launch exactly once per round (the dense-state runs
      must launch none).
   Every logged loss must be finite, and a mode that releases k moves the
   params in at most k coordinates a round. After each run one more round
   at lr 0.1 through ``run_round`` is held against the mode's algebra
   recomputed on the card from the same cohort's per-client updates.

11. GPT-2: ``gpt2_train.main`` fine-tunes GPT-2 small (byte vocabulary
   261, seq_len 256, dropout 0.1, d = 85,453,056) over 17,500 synthetic
   personas with FetchSGD (r = 5, c = 1,000,000, k = 50,000, 4 clients of 8
   rows a round), with the launch counts zeroed before each run:
   a. 4 rounds through the sync loop, with --eval_f1 4; d and the flat
      layout's first and last leaves, peak device memory;
   b. both kernels at this shape bitwise against their plain versions (on a
      random vector and on the run's params and error table) and timed
      cold and warm beside their bound;
   c. the async loop held bitwise against (a), eval row included;
   d. --fault_plan preempt@2 exits 75, and --resume is held bitwise against
      (a), with dropout on;
   e. one round at lr 0.1 held against FetchSGD's algebra on the card;
   g. two greedy decodes of the 4 validation prompts bitwise equal, F1;
   h. a profiler window over 2 rounds, with the host operations that take
      most host time;
   f. the uncompressed control, 2 rounds, async against sync.
   Every logged NLL must be finite, and each kernel must launch once per
   sketch round of every run (none in the control's).
12. cohort: client participation on the slice (ResNet-9 FetchSGD at full
   width, 6-round runs through ``cv_train.main``):
   a. --fault_plan with a drop of positions 0 and 3 at round 1, a
      straggler and a NaN-poisoned client at round 2, and a data load
      failing past its retries at round 3, sync then async: round 1 has 6
      participants and its dropped ids are in round 2's cohort, round 2 is
      skipped as non-finite and keeps its batch-norm statistics, round 3
      degrades (0 participants, its 8 clients queued, a line on stderr);
      each kernel launches once a round (counts zeroed just before the
      sync run), and async == sync bitwise, per-round metrics and the
      committed queue included;
   b. --client_dropout 0.25 --dp_clip 5 --requeue_policy aged with
      drops: async == sync bitwise; preempt@3 exits 75 with a non-empty
      queue in meta.json, and --resume lands bitwise on the uninterrupted
      run, queue and ages included;
   c. one round with positions {0, 3} masked against the same round over
      the 6 survivors alone: bitwise at --client_chunk 1 (one client a
      vmap); at chunk 0 (a vmap of 8 against one of 6) top-k agreement and
      the moved params held as phase 15a holds them;
   d. both kernels bitwise against their plain versions on (c)'s reduced
      gradient and error table;
   f. round time (sync, async) and device busy a round beside a clean run
      of the same shape;
   e. FEMNIST true_topk with --dp_clip 1 --dp_noise 1: the noise on a
      round's aggregate has std dp_noise * dp_clip / participants within
      1%, a fully masked round releases nothing, async == sync bitwise;
   g. phase 8h's sync probe with (b)'s dropout and clip, and with (e)'s
      noise: no host sync between drains.
13. bfloat16, the double head and --init_from, through the entry points,
   with the launch counts zeroed before each run:
   a. ResNet-9 FetchSGD (phase 5's flags) with --dtype bfloat16, 6 rounds
      sync and async: bitwise equal, one launch of each kernel a round,
      the kernels == plain on the run's params and error table; a cohort's
      reduced gradient on the card against the CPU port's in bfloat16
      (bound: the card's own bfloat16-vs-float32 gap on that cohort) and
      its loss sum (1e-2); device busy a round beside phase 9's float32;
   b. GPT-2 small (phase 11's flags) with --mc_coef 1 --num_candidates 2
      --dtype bfloat16 --eval_f1 4, 4 rounds sync and async: d =
      85,453,824, bitwise equal rows (mc_acc, val_mc_acc, val_f1
      included), one launch of each kernel a round, both kernels bitwise
      against their plain versions at this d and timed; cuBLAS's reduced-
      precision bfloat16 reductions timed on and off; device busy and
      matrix-product time a round beside phase 11's float32, peak memory;
   c. a GPT-2-small-shaped checkpoint in HuggingFace's layout (vocabulary
      256, 1,024 positions) written with torch.save; --init_from loads it
      bitwise (the grown rows by the reference's formula) and 2 rounds run.

14. serving: the streaming aggregation service on the slice (phase 5's
   flags, 4-round sync runs through ``cv_train.main``), with the launch
   counts zeroed before (a) and (b):
   a. --serve inproc, announce payloads, quorum 6 of 8 within 1 s: every
      round has casualties; held bitwise (params, mode state, batch-norm
      statistics, eval row, queue and ages) against the batch round with
      the same drops as a client_drop plan; one launch of each kernel a
      round;
   b. --serve_payload sketch (quorum 6 within 30 s, trace seed 3) with a
      corrupt frame, a duplicated frame and a NaN-poisoned client: each
      rejection class counted, the accumulate launched W = 8 times and the
      query once a round, held bitwise against the batch payload round
      (``engine.compose_payload``) with the same drops; every client's
      table of a round == the plain sketch of its update, bitwise;
   c. (b) over the loopback socket, event loop and threaded, == (b)
      bitwise, with one GET /metrics over HTTP;
   d. (b) with preempt@2: exit 75, a ``serve`` block in meta.json, and
      --resume == (b) bitwise;
   e. stage ms, round ms beside the batch twins', the [W, r, c] stack's
      D2H and H2D bytes and ms, socket bytes a round, device busy of the
      payload and announce rounds.

15. batched clients: the client phase is one ``torch.func.vmap`` over the
   cohort (``--client_chunk`` 0, the default every phase above runs), or
   W / C vmapped chunks; every phase above runs chunk 0. Sessions from the
   entry points' build functions:
   a. ResNet-9 FetchSGD (phase 5's flags) at chunk 0, 4 and 1 on one
      state and cohort: per-client loss sums (FWD_REL) and gradients
      (CLIENT_GRAD_REL), and the cohort's reduced gradient (GRAD_REL_L2),
      against chunk 1; one round at lr 0.1 at each chunk: top-k agreement
      (TOPK_AGREE) and the params both moved (GRAD_REL_L2); one launch of
      each kernel a round; the kernels bitwise against their plain
      versions on the chunk-0 reduced gradient; peak memory;
   b. GPT-2 small at full width, LM float32 and MC bfloat16 with dropout
      0.1, at chunk 0, 2 and 1: every client's dropout masks under the
      vmap bitwise its (round, slot, step) generator's; per-client
      gradients and loss sums at chunk 0 against chunk 1; one launch of
      each kernel a round; peak memory at each chunk;
   c. sync timing, chunk 0 and chunk 1 in turns (BATCH_PAIRS each), for
      (a) and both GPT-2 runs: host dispatch ms, round ms, then a
      profiler window: device busy ms a round with the matrix products
      apart and kernel launches a round;
   and no vmap batching-rule fallback warning fires on any of it.

16. observability (``obs/``) through the entry points, with the launch
   counts zeroed before (a), (d) and (e):
   a. ResNet-9 FetchSGD (phase 5's flags), 6 rounds, async, plain and with
      --trace --trace_events --health_every 2 --ledger --slo warn
      --profile_rounds 2:3 --profile_dir: bitwise equal; the trace holds
      the runner's spans and device spans over every round; the capture
      (the exported Chrome trace) holds accumulate_tiles once and
      query_tiles once a round it covers, plus one query_tiles a health
      round; health blocks on rounds 0, 2 and 4 only, each recall proxy
      within 0.05 of the truth; each health round's raw table queried by
      the kernel == its plain query bitwise; the ledger's replay-check and
      diff against a second armed run exit 0;
   b. preempt@2 -> exit 75 -> --resume with --ledger: one gap-free ledger,
      and the exit-75 postmortem bundle (trace, ledger tail, registry,
      config, reason);
   c. phase 8h's sync probe with --trace --health_every 1 --ledger;
   d. GPT-2 (phase 11's flags), 2 sync rounds with --health_every 1: the
      chunked split estimator gives a finite block; its device ms and
      transient memory, and a round with and without it, in turns;
   e. the served sketch-payload round in process, 4 rounds with
      --health_every 1: every health block == the batch payload round's;
   f. sync round ms, plain against armed (off cadence and health rounds),
      3 alternating rounds each.

Prints one JSON line with the kernels' numbers (launches counted over
phase 8; under "gpt2" each kernel's numbers at the GPT-2 shape, launches
counted over phase 11a; "launches_cohort" counted over phase 12a's sync
run; "launches_bf16" over each run of phase 13 and under "gpt2_mc_bf16"
the numbers at phase 13b's shape; "launches_serve" over phase 14a's and
14b's served runs; "launches_batched" over each round of phase 15;
"launches_obs" over phase 16's armed (a), GPT-2 (d) and served (e) runs),
then
as its last line
``{"ok": true, "device": {...}}``. Run from the repository root:
    python3 chip_smoke.py
``--kernels-only`` stops after phase 4 (a short first check of a new kernel),
``--cohorts N`` sets the number of cohorts phase 7 compares (default 4);
``--pairs N`` the sync/async timing pairs of phase 8 (default 2).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SLICE = dict(d=6_573_130, c=524_288, r=5)
# (d, c, r): ragged last slab; d < c; c < the 2048-item tile; whole slabs;
# c not a multiple of 4 at r = 1; r = 16; c far below the tile, many slabs
EDGE_SHAPES = [(3000, 1024, 3), (700, 1024, 3), (1500, 1000, 4), (2048, 1024, 3),
               (5000, 777, 1), (40000, 4096, 16), (2500, 300, 2)]
SLICE_ARGS = ["--dataset", "cifar10", "--mode", "sketch", "--hash_family", "rotation",
              "--num_clients", "100", "--num_workers", "8", "--local_batch_size", "8",
              "--k", "50000", "--num_rows", "5", "--num_cols", "524288",
              "--device", "cuda"]
ROUNDS = 5
TIMED_LAUNCHES = 30
COHORTS = 4
CHECK_LR = 0.1
# a checked round's new params against the step recomputed on the card from
# the same cohort's gradients: the two differ only in the order the card
# sums them, so the params may differ by a sliver of the step; a missing,
# scaled or mis-signed step is O(1)
STEP_REL = 1e-3
# the sketch round's top-k against the plain recomputation: coordinates at
# the k-th |estimate| may swap with that same sliver
TOPK_AGREE = 0.99
# card vs CPU on the same cohort (float32, TF32 off). The forward values
# (loss sums, new batch-norm statistics) are continuous in rounding noise
# and must agree to 1e-5. The gradient is not continuous: rounding moves a
# few ReLU/max-pool branch decisions among the ~24M activations of a 64-row
# cohort, and a decision moved late in the network changes the backward
# signal of every layer before it. Over 16 cohorts (``--cohorts 16``) an
# H100 read relative L2 differences from 1.1e-4 to 2.7e-3, while two
# reductions of one cohort on the card moved the params by a few 1e-6 of
# the step apart (phase 6). So the gradient
# gets a bound of 3x the largest of those readings, which a layout, sign or
# scaling fault (an O(1) difference) cannot pass; its arithmetic is held
# tightly against the JAX package on the CPU (tests/test_torch_*.py).
FWD_REL = 1e-5
GRAD_REL_L2 = 8e-3
# run-loop phase: runs of LOOP_ROUNDS rounds, held bitwise
LOOP_ROUNDS = 6
PAIRS = 2
# baselines phase: rounds per run
BASE_ROUNDS = 4
FEMNIST_ARGS = ["--dataset", "femnist", "--num_clients", "3550", "--num_workers", "8",
                "--local_batch_size", "8", "--k", "50000", "--device", "cuda"]
# phase 11: GPT-2 small (byte vocabulary 261, seq_len 256, dropout 0.1) over
# 17,500 synthetic personas, the paper's configuration #4
GPT2_ARGS = ["--mode", "sketch", "--hash_family", "rotation", "--num_clients", "17500",
             "--num_workers", "4", "--local_batch_size", "8", "--k", "50000",
             "--num_rows", "5", "--num_cols", "1000000", "--num_blocks", "20",
             "--device", "cuda"]
GPT2_D = 85_453_056
GPT2_ROUNDS = 4
RESNET_ARGS = ["--dataset", "cifar10", "--hash_family", "rotation", "--num_clients", "100",
               "--num_workers", "8", "--local_batch_size", "8", "--k", "50000",
               "--device", "cuda"]
# phase 12: client participation on the main path, runs of COHORT_ROUNDS
COHORT_ROUNDS = 6
COHORT_PLAN = ("client_drop@1:clients=0+3;client_straggle@2:clients=1,secs=0.2;"
               "client_poison@2:clients=5,value=nan;data_fail@3:times=4")
DROPOUT_ARGS = ["--client_dropout", "0.25", "--dp_clip", "5.0", "--requeue_policy", "aged"]
DROPOUT_PLAN = "client_drop@1:clients=2+5;client_drop@3:clients=0+4"
# the DP noise's measured std against dp_noise * dp_clip / participants
NOISE_REL = 0.01
# phase 13: bfloat16, the double head and --init_from. A cohort's bf16 loss
# sum on the card against the CPU port's: bf16 rounding moves it by parts
# in 1e4; a fault moves it by O(1)
BF16_ROUNDS = 6
BF16_LOSS_REL = 1e-2
GPT2_MC_D = GPT2_D + 768  # the mc head: one n_embd vector
INIT_VOCAB = 256  # the written checkpoint's vocabulary, grown to the byte tokenizer's 261
INIT_ROUNDS = 2
# phase 14: serving, runs of SERVE_ROUNDS rounds of phase 5's flags through
# the sync loop. (a) closes at 6 of 8 with a 1 s deadline, so every round
# has casualties; (b)-(d) close at 6 of 8 within 30 s (only no-shows miss
# it), on a trace seed whose clients at the faulted positions submit
SERVE_ROUNDS = 4
SERVE_ANNOUNCE = ["--serve", "inproc", "--serve_quorum", "6", "--serve_deadline", "1.0"]
SERVE_PAYLOAD = ["--serve_payload", "sketch", "--serve_quorum", "6", "--serve_deadline",
                 "30.0", "--serve_trace", "seed=3"]
SERVE_PLAN = ("wire_corrupt@1:clients=0;wire_dup@1:clients=1;"
              "client_poison@2:clients=3,value=nan")
# phase 15: batched clients. ResNet-9 at these client chunks, GPT-2 at 0, 2
# and 1 (the timing at 0 and 1); BATCH_PAIRS alternating sync pairs each.
# A vmap over 8 clients and one over 1 run their products at other batch
# sizes, so a float32 client's gradient sums in another order: held within
# GRAD_REL_L2 and its loss sum within FWD_REL. In bfloat16 a product that
# sums in another order may round its output one bfloat16 ulp (2**-8)
# apart, and the backward carries such flips into every layer below: the
# gradient within BF16_GRAD_REL and the loss sum within BF16_LOSS_REL, which
# a layout, mask or scaling fault (an O(1) difference) cannot pass
BATCH_CHUNKS = (0, 4, 1)
GPT2_CHUNKS = (0, 2, 1)
BATCH_PAIRS = 3
BF16_GRAD_REL = 5e-2
# one client's float32 gradient, not a cohort's mean, is what the vmap
# changes: unaveraged, the same branch flips weigh more (an H100 read 6.0e-3
# for the worst of 8 ResNet-9 clients at chunk 0 against chunk 1, the mean
# of the cohort much less); a fault is O(1)
CLIENT_GRAD_REL = 3e-2
# phase 16: observability, runs of OBS_ROUNDS rounds of phase 5's flags;
# OBS_PAIRS alternating sync rounds a side in (f)
OBS_ROUNDS = 6
OBS_PAIRS = 3


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.equal(got, want):
        err = (got - want).abs().max().item() if got.shape == want.shape else math.inf
        fail(f"{name}: kernel disagrees with the plain version (max abs err {err})")
    return (got - want).abs().max().item()


def check_kernels(csvec, spec, v: torch.Tensor, table: torch.Tensor | None = None) -> tuple:
    """(accumulate err, query err) of the kernels against the plain versions
    on the card. The query is checked on `table` (default: v's sketch)."""
    acc = compare(f"sketch_accumulate {spec}", csvec.sketch_vec(spec, v),
                  csvec._sketch_vec_rotation(spec, v))
    if table is None:
        table = csvec._sketch_vec_rotation(spec, v)
    qry = compare(f"sketch_query {spec}", csvec.query_all(spec, table),
                  csvec._query_all_rotation(spec, table))
    return acc, qry


def checked_round(session, engine, lr: float):
    """Run one round of ``session`` at ``lr`` through ``run_round`` and
    return (state before, the round cohort's reduced gradient on the card,
    new params). The cohort is drawn first, and the host RNG rewound so
    that ``run_round`` draws the same one."""
    rng_state = session.rng.get_state()
    batch = session.prepare_round().batch
    session.rng.set_state(rng_state)
    before = {"params": session.state["params"].clone(),
              **{k: v.clone() for k, v in session.state["mode_state"].items()}}
    g, _, _ = engine.reduce_clients(session.train_loss_fn, session.cfg, session.layout,
                                    session.state, session._to_device(batch))
    session.run_round(lr)
    return before, g, session.state["params"]


def check_sketch_round(session, engine, csvec) -> str:
    """FetchSGD Alg. 1 recomputed with the plain sketch and query."""
    mcfg = session.cfg.mode
    spec, k = mcfg.sketch_spec, mcfg.k
    before, g, new = checked_round(session, engine, CHECK_LR)
    V = mcfg.momentum * before["Vvelocity"] + csvec._sketch_vec_rotation(spec, g)
    est = csvec._query_all_rotation(spec, before["Verror"] + CHECK_LR * V)
    idx = torch.topk(est.abs(), k).indices
    moved = new != before["params"]
    n_moved, agree = int(moved.sum()), moved[idx].float().mean().item()
    common = idx[moved[idx]]
    want = before["params"][common] - est[common]
    rel = ((new[common] - want).abs().max() / est[idx].abs().max()).item() if n_moved else math.inf
    verdict = (f"checked sketch round at lr {CHECK_LR}: {n_moved} params moved (k {k}), "
               f"top-k agreement with the plain recomputation {agree:.6f}, "
               f"value error / largest step {rel:.3e}")
    if not (0 < n_moved <= k and agree >= TOPK_AGREE and rel < STEP_REL):
        fail(verdict)
    return verdict


def check_control_round(session, engine) -> str:
    """The uncompressed control: p - lr * (momentum * V + g)."""
    before, g, new = checked_round(session, engine, CHECK_LR)
    lr_t = torch.tensor(CHECK_LR, dtype=torch.float32, device=g.device)
    want = before["params"] - lr_t * (session.cfg.mode.momentum * before["Vvelocity"] + g)
    step = (want - before["params"]).abs().max().item()
    rel = (new - want).abs().max().item() / step if step > 0 else math.inf
    verdict = (f"checked uncompressed round at lr {CHECK_LR}: largest step {step:.3e}, "
               f"error / largest step {rel:.3e}")
    if not rel < STEP_REL:
        fail(verdict)
    return verdict


def card_vs_cpu(session, engine, csvec, cohorts: int, errs: dict) -> None:
    """The kernels on a real round's reduced gradient and error table, and
    the client reduction of ``cohorts`` cohorts on the card against the same
    reduction on the CPU; prints every reading."""
    spec = session.cfg.mode.sketch_spec
    cpu_state = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.cpu() if torch.is_tensor(v) else v)
                 for k, v in session.state.items()}
    readings = []
    for i in range(cohorts):
        batch = session.prepare_round().batch
        weighted, stats, metrics = engine.reduce_clients(
            session.train_loss_fn, session.cfg, session.layout, session.state,
            session._to_device(batch))
        if i == 0:
            a, q = check_kernels(csvec, spec, weighted, session.state["mode_state"]["Verror"])
            errs["sketch_accumulate"] = max(errs["sketch_accumulate"], a)
            errs["sketch_query"] = max(errs["sketch_query"], q)
            print("real round: kernels == plain on its reduced gradient and error table",
                  flush=True)
        cpu_batch = dict(batch)  # host tensors already
        w_cpu, stats_cpu, metrics_cpu = engine.reduce_clients(
            session.train_loss_fn, session.cfg, session.layout, cpu_state, cpu_batch)
        loss_rel = abs(metrics["loss_sum"].item() / metrics_cpu["loss_sum"].item() - 1)
        stats_rel = max(((stats[k].cpu() - v).abs().max() / v.abs().max()).item()
                        for k, v in stats_cpu.items())
        diff = (weighted.cpu() - w_cpu).abs()
        grad_rel = (diff.norm() / w_cpu.norm()).item()
        live = w_cpu.abs() > 1e-6 * w_cpu.abs().max()
        grad_median = (diff[live] / w_cpu.abs()[live]).median().item()
        print(f"card vs CPU, cohort {i}: loss sum rel {loss_rel:.3e}, batch-norm stats rel "
              f"{stats_rel:.3e}, reduced gradient median rel {grad_median:.3e}, "
              f"rel L2 {grad_rel:.3e}", flush=True)
        readings.append((loss_rel, stats_rel, grad_rel))
    worst = [max(r[j] for r in readings) for j in range(3)]
    if not (worst[0] < FWD_REL and worst[1] < FWD_REL and worst[2] < GRAD_REL_L2):
        fail(f"card vs CPU over {cohorts} cohorts: worst loss sum rel {worst[0]:.3e}, "
             f"stats rel {worst[1]:.3e} (bound {FWD_REL}), gradient rel L2 "
             f"{worst[2]:.3e} (bound {GRAD_REL_L2})")


def _is_gemm(kernel_name: str) -> bool:
    """A cuBLAS/CUTLASS matrix-product kernel, by its name."""
    name = kernel_name.lower()
    return any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass"))


def profile_rounds(session, rounds: int = 2, top: int = 12, label: str = "",
                   host_top: int = 0, out: dict | None = None) -> float:
    """Where a steady round's time goes: a torch.profiler window over
    `rounds` more rounds; prints the device's busy time and idle share per
    round, the kernels that took most device time and the ``host_top`` host
    operations that took most host time, and returns the busy ms per round
    (0.0: not measured). ``out``, if given, receives "busy_ms", "wall_ms",
    "gemm_ms" (the matrix-product kernels' ms a round, ``_is_gemm``) and
    "launches" (device kernels a round)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            session.run_round(0.01)
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    if busy_ms <= 0:
        print(f"profile{label}: the profiler recorded no device time (not measured)",
              flush=True)
        return 0.0
    gemms = [e for e in kernels if _is_gemm(e.key)]
    gemm_ms = sum(e.self_device_time_total for e in gemms) / 1e3 / rounds
    launches = sum(e.count for e in kernels) / rounds
    print(f"profile{label}: {rounds} rounds, wall {wall_ms:.2f} ms/round (profiled), device "
          f"busy {busy_ms:.2f} ms/round, idle share {1 - busy_ms / wall_ms:.3f}, matrix "
          f"products {gemm_ms:.2f} ms/round in {len(gemms)} kernels, {launches:.0f} kernel "
          "launches a round", flush=True)
    if out is not None:
        out.update(busy_ms=busy_ms, wall_ms=wall_ms, gemm_ms=gemm_ms, launches=launches)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / rounds
        print(f"  {ms:8.3f} ms/round  {e.count // rounds:5d}x  {e.key[:110]}", flush=True)
    if host_top:
        ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
        print(f"profile{label}: host operations by self host time", flush=True)
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            ms = e.self_cpu_time_total / 1e3 / rounds
            print(f"  {ms:8.3f} ms/round  {e.count // rounds:5d}x  {e.key[:110]}", flush=True)
    return busy_ms


def determinism_cost(session, card: str) -> None:
    """Device busy per round under the entry point's reproducibility
    switches and, for these windows only, under cuDNN's and PyTorch's
    defaults (the port's behaviour before the switches), in turns."""
    on = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
          torch.are_deterministic_algorithms_enabled())
    busy = {"switches on": [], "defaults": []}
    try:
        for turn in range(4):
            det = turn % 2 == 0
            torch.backends.cudnn.deterministic = on[0] if det else False
            torch.use_deterministic_algorithms(on[2] if det else False)
            label = "switches on" if det else "defaults"
            busy[label].append(profile_rounds(session, top=0, label=f" ({label})"))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on[0], on[1]
        torch.use_deterministic_algorithms(on[2])
    print(f"determinism cost: device busy ms/round with the switches {busy['switches on']}, "
          f"with the defaults {busy['defaults']} [{card}]", flush=True)


def _state(session) -> dict:
    return {"params": session.state["params"],
            "Vvelocity": session.state["mode_state"]["Vvelocity"],
            "Verror": session.state["mode_state"]["Verror"]}


def _rel(a: dict, b: dict, p0: torch.Tensor) -> float:
    """Largest relative L2 difference of two runs' states: params against
    their movement from p0, the tables against their own norm."""
    out = 0.0
    for k in a:
        ref = (b[k] - p0) if k == "params" else b[k]
        den = ref.norm().item()
        diff = (a[k] - b[k]).norm().item()
        out = max(out, diff / den if den > 0 else (0.0 if diff == 0 else math.inf))
    return out


def _equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _steady_ms(stats) -> float:
    """Median per-round ms over a run's drain windows, the first (which
    carries the first round's start-up) left out."""
    ms = stats.round_ms[1:] or stats.round_ms
    return statistics.median(ms)


def _times(label: str, stats, card: str) -> str:
    ck = "; ".join(f"save copy {t['copy_ms']:.1f} write {t['write_ms']:.1f} verify "
                   f"{t['verify_ms']:.1f} ms" for t in stats.checkpoints)
    return (f"  {label}: per-round ms {[round(t, 2) for t in stats.round_ms]} "
            f"(rounds per drain {stats.window_rounds}), steady median {_steady_ms(stats):.2f}, "
            f"in-flight depth {stats.max_inflight_used}, rtt {stats.rtt_ms:.4f} ms, host ms "
            f"prepare {stats.prepare_ms:.1f} dispatch {stats.dispatch_ms:.1f} drain "
            f"{stats.drain_ms:.1f}{'; checkpoints: ' + ck if ck else ''} [{card}]")


def run_loop_phase(cv_train, kernels, card: str, pairs: int) -> dict:
    """Phase 8: the run loop at full width; returns the launch counts."""
    import shutil

    from commefficient_tpu_torch.utils import checkpoint as ckpt

    base = os.path.join(ROOT, "build", "chip_smoke", "loop")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    rounds = 0  # sketch rounds committed in this phase

    def run(extra, label, mode="sketch"):
        nonlocal rounds
        log = os.path.join(base, f"{label}.jsonl")
        argv = SLICE_ARGS + ["--num_rounds", str(LOOP_ROUNDS), "--log_jsonl", log,
                             "--mode", mode] + list(extra)
        s = cv_train.main(argv)
        torch.cuda.synchronize()
        if mode == "sketch":
            rounds += s.run_stats.rounds
        with open(log) as f:
            row = [json.loads(line) for line in f][-1]
        print(_times(label, s.run_stats, card), flush=True)
        return s, row

    kernels.reset_launch_counts()
    a, row_a = run(["--sync_loop"], "sync_a")
    b, _ = run(["--sync_loop"], "sync_b")
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
    model0 = ResNet9()
    init_weights(model0, 42)
    p0 = FlatLayout(model0).flatten(dict(model0.named_parameters())).to(a.state["params"].device)
    spread = _rel(_state(a), _state(b), p0)
    verdict = (f"run loop: two sync runs of one seed under the entry point's switches "
               f"(cudnn.deterministic {torch.backends.cudnn.deterministic}, deterministic "
               f"algorithms {torch.are_deterministic_algorithms_enabled()}): relative L2 "
               f"{spread:.3e}")
    if not _equal(_state(a), _state(b)):
        fail(verdict + ", not bitwise equal")
    print(verdict + ", bitwise equal - held", flush=True)

    def hold(label, s, row, ref=a, ref_row=row_a, keys=("train_loss", "train_acc",
                                                          "test_loss", "test_acc", "comm_mb")):
        """Bitwise, and ``keys`` of the eval rows equal too (a resumed run's
        train columns sum only the rounds it ran, so it is held on the
        rest)."""
        got = _rel(_state(s), _state(ref), p0)
        ok = _equal(_state(s), _state(ref)) and all(row[k] == ref_row[k] for k in keys)
        msg = f"run loop: {label} vs sync: relative L2 {got:.3e}"
        if not ok:
            fail(msg + ", not bitwise equal")
        print(msg + " - held bitwise", flush=True)

    ck1 = os.path.join(base, "ck_async")
    c, row_c = run(["--checkpoint_every", "3", "--checkpoint_dir", ck1], "async")
    names = sorted(d for d in os.listdir(ck1) if d.startswith("round_"))
    if names != ["round_00000003", "round_00000006"] or \
            not all(ckpt.verify(os.path.join(ck1, n)) is True for n in names):
        fail(f"async checkpoints: {names}")
    hold("async, checkpoint every 3", c, row_c)
    d, row_d = run(["--rounds_per_dispatch", "3"], "async_blocks")
    hold("async, 3 rounds per dispatch", d, row_d)

    ck2 = os.path.join(base, "ck_preempt")
    try:
        run(["--checkpoint_dir", ck2, "--fault_plan", "preempt@2"], "preempted")
        fail("preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    names = sorted(d for d in os.listdir(ck2) if d.startswith("round_"))
    if names[-1:] != ["round_00000003"] or ckpt.verify(os.path.join(ck2, names[-1])) is not True:
        fail(f"preemption checkpoint: {names}")
    rounds += 3
    print("run loop: preempt@2 exited 75 with a verified emergency checkpoint at round 3",
          flush=True)
    e, row_e = run(["--checkpoint_dir", ck2, "--fault_plan", "preempt@2", "--resume"],
                   "resumed")
    if e.run_stats.rounds != 3:
        fail(f"resume ran {e.run_stats.rounds} rounds, not 3")
    hold("preempt -> resume", e, row_e, ref=c, ref_row=row_c,
         keys=("test_loss", "test_acc", "comm_mb"))

    ck3 = os.path.join(base, "ck_corrupt")
    run(["--checkpoint_dir", ck3, "--checkpoint_every", "2", "--fault_plan", "ckpt_corrupt@3",
         "--num_rounds", "3"], "corrupted")
    f_, row_f = run(["--checkpoint_dir", ck3, "--resume"], "fallback")
    damaged = sorted(x for x in os.listdir(ck3) if x.endswith(".damaged"))
    if damaged != ["round_00000003.damaged"] or f_.run_stats.rounds != 4:
        fail(f"ckpt_corrupt@3: damaged {damaged}, resumed run ran {f_.run_stats.rounds}")
    print("run loop: the resume fell back past the damaged round-3 checkpoint to round 2",
          flush=True)
    hold("corrupt -> fallback resume", f_, row_f, keys=("test_loss", "test_acc", "comm_mb"))
    launches = dict(kernels.launch_counts)
    for name, n in launches.items():
        if n != rounds:
            fail(f"{name} launched {n} times in {rounds} sketch rounds of the run-loop phase")
    print(f"run loop: launches {launches} in {rounds} sketch rounds (one per round)", flush=True)

    ua, _ = run(["--sync_loop", "--num_rounds", "2"], "control_sync_a", "uncompressed")
    ub, _ = run(["--sync_loop", "--num_rounds", "2"], "control_sync_b", "uncompressed")
    uc, _ = run(["--num_rounds", "2"], "control_async", "uncompressed")
    verdict = (f"run loop: control, sync vs sync relative L2 "
               f"{_rel(_state(ua), _state(ub), p0):.3e}, async vs sync "
               f"{_rel(_state(uc), _state(ua), p0):.3e}")
    if not (_equal(_state(ua), _state(ub)) and _equal(_state(uc), _state(ua))):
        fail(verdict + ", not bitwise equal")
    print(verdict + " - held bitwise", flush=True)

    sync_ms, async_ms = [], []
    for i in range(pairs):
        order = [True, False] if i % 2 == 0 else [False, True]
        for sync in order:
            s, _ = run(["--num_rounds", str(2 * LOOP_ROUNDS)] + (["--sync_loop"] if sync else []),
                       f"pair{i}_{'sync' if sync else 'async'}")
            (sync_ms if sync else async_ms).append(_steady_ms(s.run_stats))
    print(f"run loop: {pairs} alternating pairs, steady per-round ms: sync "
          f"{[round(t, 2) for t in sync_ms]}, async {[round(t, 2) for t in async_ms]} [{card}]",
          flush=True)
    return launches


def sync_probe(cv_train, slice_args) -> None:
    """Between two drains the round path must not sync the host. Four
    prefetched dispatches run under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any synchronizing CUDA call; the drain's copy, run under
    it first, must raise (the detector works). A profiler window over the
    dispatches and their drain also counts the synchronize calls: the
    drain's and the profiler's own at its exit, no more. The observability
    flags among ``slice_args`` (--trace, --health_every, --ledger) are
    armed and attached as the entry point does, so their work runs under
    the detector too."""
    from torch.profiler import ProfilerActivity, profile

    from commefficient_tpu_torch import obs
    from commefficient_tpu_torch.runner import RoundPrefetcher
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    args = resolve_defaults(make_parser().parse_args(slice_args))
    obs.configure_from_args(args)
    session, _ = cv_train.build(args)
    wiring = obs.attach_from_args(args, session)
    src = RoundPrefetcher(session, 0, depth=4)
    try:
        session.commit_round(session.dispatch_round(src.next(), 0.01))  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = [session.dispatch_round(src.next(), 0.01) for _ in range(4)]
                try:
                    session.fetch_metrics(pending)
                    fail("sync probe: the drain's copy did not register as a sync")
                except RuntimeError:
                    pass
            finally:
                torch.cuda.set_sync_debug_mode(0)
            session.commit_rounds(pending, session.fetch_metrics(pending))
    finally:
        src.stop()
        wiring.close()
        obs.trace.configure()
    syncs = [e.name for e in prof.events()
             if e.name.startswith("cuda") and "Synchronize" in e.name]
    print(f"sync probe: 4 dispatches ran with no synchronizing call; the profiler window "
          f"(dispatches, drain, its own exit) holds {len(syncs)} synchronize call(s) "
          f"{syncs}", flush=True)
    if len(syncs) > 2:
        fail(f"sync probe: {len(syncs)} synchronize calls, more than the drain's and the "
             "profiler's")

def _initial_params(dataset: str, dev) -> torch.Tensor:
    """The CLI's initial flat params at the parser's default --seed."""
    from commefficient_tpu_torch.cv_train import init_weights
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN
    from commefficient_tpu_torch.models.resnet9 import ResNet9

    model = FEMNISTCNN() if dataset == "femnist" else ResNet9()
    init_weights(model, 42)
    return FlatLayout(model).flatten(dict(model.named_parameters())).to(dev)


def _releases_k(mcfg) -> bool:
    return mcfg.mode == "true_topk" or (mcfg.mode == "local_topk"
                                        and mcfg.error_type == "virtual")


def check_baseline_round(session, engine, csvec) -> str:
    """One round at lr CHECK_LR through ``run_round``, held against the
    mode's algebra recomputed on the card from the same cohort's per-client
    updates (the engine's ``make_client_updates``: gradient plus weight
    decay, or the local-SGD weight delta): per-client top-k with torch.topk
    and the client rows for local_topk, the survivor mean, server momentum
    and error, the plain sketch and query for sketched state."""
    mcfg = session.cfg.mode
    rng_state = session.rng.get_state()
    prep = session.prepare_round()
    session.rng.set_state(rng_state)
    batch = session._to_device(prep.batch)
    batch.pop(engine.VALID_KEY)
    state = session.state
    dev = state["params"].device
    lr = torch.tensor(CHECK_LR, dtype=torch.float32, device=dev)
    p0 = state["params"].clone()
    V0, E0 = (state["mode_state"][k].clone() for k in ("Vvelocity", "Verror"))
    ids = torch.from_numpy(prep.ids.astype("int64")).to(dev)
    rows0 = ({k: v[ids] for k, v in session.client_state.items()}
             if session.client_state is not None else {})
    updates = engine.make_client_updates(session.train_loss_fn, session.cfg, session.layout)
    W, k = len(prep.ids), mcfg.k
    ups = list(updates(state, batch, lr, range(W))[0])
    want_rows = {}
    if mcfg.mode == "local_topk":
        dense = []
        for w, u in enumerate(ups):
            acc = u
            if mcfg.momentum_type == "local":
                acc = mcfg.momentum * rows0["momentum"][w] + u
                want_rows.setdefault("momentum", []).append(acc)
            if mcfg.error_type == "local":
                acc = rows0["error"][w] + acc
            idx = torch.topk(acc.abs(), k).indices
            d_w = torch.zeros_like(acc)
            d_w[idx] = acc[idx]
            dense.append(d_w)
            if mcfg.error_type == "local":
                want_rows.setdefault("error", []).append(acc - d_w)
        ups = dense
    g = sum(ups) / W
    rho = mcfg.momentum if mcfg.momentum_type == "virtual" else 0.0
    session.run_round(CHECK_LR)
    new = session.state["params"]
    if _releases_k(mcfg):
        if mcfg.server_state == "sketch":
            spec = mcfg.sketch_spec
            V = rho * V0 + csvec._sketch_vec_rotation(spec, g)
            est = csvec._query_all_rotation(spec, E0 + lr * V)
        else:
            V = rho * V0 + g
            est = (E0 if mcfg.error_type != "none" else 0.0) + lr * V
        idx = torch.topk(est.abs(), k).indices
        moved = new != p0
        n_moved, agree = int(moved.sum()), moved[idx].float().mean().item()
        common = idx[moved[idx]]
        err = (new[common] - (p0[common] - est[common])).abs().max().item() if n_moved else 0.0
        rel = err / est[idx].abs().max().item() if n_moved else math.inf
        verdict = (f"checked {mcfg.mode} round at lr {CHECK_LR}: {n_moved} params moved "
                   f"(k {k}), top-k agreement {agree:.6f}, value error / largest step "
                   f"{rel:.3e}")
        ok = 0 < n_moved <= k and agree >= TOPK_AGREE and rel < STEP_REL
    else:
        rate = mcfg.server_lr if mcfg.uses_weight_delta else lr
        want = p0 - rate * (rho * V0 + g)
        step = (want - p0).abs().max().item()
        rel = (new - want).abs().max().item() / step if step > 0 else math.inf
        verdict = (f"checked {mcfg.mode} round at lr {CHECK_LR}: largest step {step:.3e}, "
                   f"error / largest step {rel:.3e}")
        ok = rel < STEP_REL
    for key, rows in want_rows.items():
        want_r = torch.stack(rows)
        got_r = session.client_state[key][ids]
        rel_r = ((got_r - want_r).norm() / want_r.norm()).item()
        verdict += f"; client {key} rows rel L2 {rel_r:.3e}"
        ok = ok and rel_r < STEP_REL
    if not ok:
        fail(verdict)
    return verdict


def client_state_ms(session, time_ms, card: str) -> str:
    """Device ms of one round's client-state traffic as ``dispatch_round``
    runs it (median of 5 CUDA-event-timed launches each): the gather of the
    cohort's rows, and the out-of-place scatter of the new rows into new
    [num_clients, d] tensors, beside its byte bound (the old state read and
    the new one written once, at 3.35 TB/s)."""
    cs = session.client_state
    ids = torch.arange(session.num_workers, device=session.device) * 7 % len(
        next(iter(cs.values())))
    rows = {k: v.index_select(0, ids) + 1.0 for k, v in cs.items()}
    gather = time_ms(lambda: {k: v.index_select(0, ids) for k, v in cs.items()}, 5,
                     lambda: None)
    scatter = time_ms(lambda: {k: v.index_copy(0, ids, rows[k]) for k, v in cs.items()}, 5,
                      lambda: None)
    nbytes = sum(2 * v.numel() * 4 for v in cs.values())
    return (f"client state {nbytes / 2e9:.2f} GB: gather {gather:.3f} ms, out-of-place "
            f"scatter {scatter:.3f} ms (byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms) "
            f"[{card}]")


def baselines_phase(cv_train, engine, csvec, kernels, card: str) -> None:
    """Phase 10: FetchSGD's baselines at full width through
    ``cv_train.main``."""
    import shutil

    from commefficient_tpu_torch.utils import checkpoint as ckpt

    base = os.path.join(ROOT, "build", "chip_smoke", "baselines")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    dev = torch.device("cuda")
    p0s, launch_log = {}, {}

    def run(args, label, sketch_launches=0, extra=()):
        log = os.path.join(base, f"{label}.jsonl")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = cv_train.main(list(args) + ["--num_rounds", str(BASE_ROUNDS), "--log_jsonl", log,
                                        *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        if any(n != sketch_launches * s.run_stats.rounds for n in launches.values()):
            fail(f"{label}: launches {launches} in {s.run_stats.rounds} rounds, expected "
                 f"{sketch_launches} per round")
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        if not rows or not all(math.isfinite(r[key]) for r in rows
                               for key in ("train_loss", "test_loss")):
            fail(f"{label}: non-finite or missing loss in {rows}")
        mcfg = s.cfg.mode
        dataset = args[args.index("--dataset") + 1]
        if dataset not in p0s:
            p0s[dataset] = _initial_params(dataset, dev)
        moved = int((s.state["params"] != p0s[dataset]).sum())
        bound = (mcfg.k if _releases_k(mcfg) else
                 s.num_workers * mcfg.k if mcfg.mode == "local_topk" else mcfg.d)
        if not 0 < moved <= s.round * bound:
            fail(f"{label}: {moved} params moved in {s.round} rounds (bound {bound} a round)")
        launch_log[label] = launches
        print(f"baselines {label}: d={mcfg.d:,} {s.run_stats.rounds} rounds in {wall:.1f} s, "
              f"launches {launches}, {moved} params moved, final test loss "
              f"{rows[-1]['test_loss']:.4f}, comm {rows[-1]['comm_mb']:.3f} MB", flush=True)
        print(_times(label, s.run_stats, card), flush=True)
        return s, rows[-1]

    def checked(s, label):
        print(f"baselines {label}: " + check_baseline_round(s, engine, csvec), flush=True)
        profile_rounds(s, top=4, label=f" {label} [{card}]")

    topk = ["--mode", "true_topk"]
    s, _ = run(FEMNIST_ARGS + topk, "femnist_true_topk")
    checked(s, "femnist_true_topk")
    virt = ["--mode", "local_topk", "--error_type", "virtual", "--momentum_type", "virtual"]
    s, _ = run(FEMNIST_ARGS + virt, "femnist_local_topk_virtual")
    checked(s, "femnist_local_topk_virtual")
    del s

    local = RESNET_ARGS + ["--mode", "local_topk"]
    a, row_a = run(local + ["--sync_loop"], "resnet9_local_topk_sync")
    gb = sum(v.numel() * 4 for v in a.client_state.values()) / 1e9
    ck = os.path.join(base, "ck_local")
    c, row_c = run(local, "resnet9_local_topk_async", extra=["--checkpoint_dir", ck])

    def same(x, y):
        return (_equal(_state(x), _state(y)) and x.client_state.keys() == y.client_state.keys()
                and all(torch.equal(x.client_state[k], y.client_state[k])
                        for k in x.client_state))

    if not (same(a, c) and row_a["test_loss"] == row_c["test_loss"]):
        fail("resnet9 local_topk: async run differs from the sync run")
    print(f"baselines: resnet9 local_topk async == sync bitwise, client state "
          f"{sorted(a.client_state)} ({gb:.2f} GB) included", flush=True)
    path = ckpt.latest(ck)
    t0 = time.perf_counter()
    ckpt.restore(path, c)
    torch.cuda.synchronize()
    print(f"baselines: checkpoint of the {gb:.2f} GB client state: "
          + "; ".join(f"copy {t['copy_ms']:.0f} write {t['write_ms']:.0f} verify "
                      f"{t['verify_ms']:.0f} ms" for t in c.run_stats.checkpoints)
          + f"; restore {1e3 * (time.perf_counter() - t0):.0f} ms [{card}]", flush=True)
    del c
    shutil.rmtree(ck, ignore_errors=True)
    ck2 = os.path.join(base, "ck_preempt")
    try:
        run(local, "resnet9_local_topk_preempted",
            extra=["--checkpoint_dir", ck2, "--fault_plan", "preempt@1"])
        fail("preempt@1 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    e_, row_e = run(local, "resnet9_local_topk_resumed",
                    extra=["--checkpoint_dir", ck2, "--fault_plan", "preempt@1", "--resume"])
    if not (e_.run_stats.rounds == BASE_ROUNDS - 2 and same(a, e_)
            and row_a["test_loss"] == row_e["test_loss"] and row_a["comm_mb"] == row_e["comm_mb"]):
        fail("resnet9 local_topk: preempt -> resume differs from the uninterrupted run")
    print("baselines: resnet9 local_topk preempt@1 -> exit 75 -> resume == uninterrupted, "
          "bitwise, client state included", flush=True)
    del e_
    shutil.rmtree(ck2, ignore_errors=True)
    from commefficient_tpu_torch.sketch.time_kernels import time_ms
    print("baselines: " + client_state_ms(a, time_ms, card), flush=True)
    checked(a, "resnet9_local_topk")
    del a

    s, _ = run(RESNET_ARGS + ["--mode", "fedavg", "--num_local_iters", "5"], "resnet9_fedavg")
    checked(s, "resnet9_fedavg")
    del s
    sk = RESNET_ARGS + ["--mode", "true_topk", "--server_state", "sketch", "--num_rows", "5",
                        "--num_cols", "524288"]
    s, _ = run(sk, "resnet9_true_topk_sketch_state", sketch_launches=1)
    checked(s, "resnet9_true_topk_sketch_state")
    return launch_log["resnet9_true_topk_sketch_state"]


class _Tee:
    """A text stream that writes through to another and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


@contextlib.contextmanager
def recording_rounds():
    """Inside the block, every session records each committed round's host
    metrics and the batch-norm statistics as committed, and each round's
    first preparation: (cohort ids, the queue after it)."""
    from commefficient_tpu_torch.federated.api import FederatedSession

    rec = {"metrics": [], "net_state": [], "cohorts": {}}
    commit, prepare = FederatedSession.commit_rounds, FederatedSession.prepare_round

    def commit_rec(self, infls, hosts):
        out = commit(self, infls, hosts)
        rec["metrics"].extend(out)
        rec["net_state"].append({k: v.clone() for k, v in self.state["net_state"].items()})
        return out

    def prepare_rec(self, rnd=None):
        prep = prepare(self, rnd)
        rec["cohorts"].setdefault(prep.rnd, ([int(i) for i in prep.ids], prep.requeue))
        return prep

    FederatedSession.commit_rounds, FederatedSession.prepare_round = commit_rec, prepare_rec
    try:
        yield rec
    finally:
        FederatedSession.commit_rounds, FederatedSession.prepare_round = commit, prepare


def _full_state(s) -> dict:
    return {**_state(s), **{f"bn:{k}": v for k, v in s.state["net_state"].items()}}


def _same_run(a, b, rec_a, rec_b) -> bool:
    """Bitwise: params, mode state, batch-norm statistics, every round's
    metrics, the committed queue and its ages."""
    return (_equal(_full_state(a), _full_state(b)) and rec_a["metrics"] == rec_b["metrics"]
            and a._requeue_committed == b._requeue_committed
            and a._requeue_ages_committed == b._requeue_ages_committed)


def cohort_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 12: client participation on ResNet-9 FetchSGD at full width
    (and DP on the FEMNIST CNN); returns each kernel's launches over the
    sync run of 12a."""
    import shutil

    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "cohort")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    times = {}

    def run(extra, label):
        argv = SLICE_ARGS + ["--num_rounds", str(COHORT_ROUNDS), "--log_jsonl",
                             os.path.join(base, f"{label}.jsonl")] + list(extra)
        with recording_rounds() as rec:
            s = cv_train.main(argv)
        torch.cuda.synchronize()
        times[label] = _steady_ms(s.run_stats)
        print(_times(label, s.run_stats, card), flush=True)
        return s, rec

    # a. scheduled faults, sync and async
    faults = ["--fault_plan", COHORT_PLAN, "--on_nonfinite", "skip", "--requeue_policy", "fifo"]
    tee = _Tee(sys.stderr)
    kernels.reset_launch_counts()
    with contextlib.redirect_stderr(tee):
        a, rec_a = run(faults + ["--sync_loop"], "faults_sync")
    launches = dict(kernels.launch_counts)
    m = rec_a["metrics"]
    cols = {k: [x.get(k) for x in m] for k in ("participants", "clients_dropped",
                                               "requeue_depth", "nonfinite_rounds")}
    print(f"cohort a: per round {json.dumps(cols)}", flush=True)
    cohorts = rec_a["cohorts"]
    gone = {cohorts[1][0][0], cohorts[1][0][3]}
    checks = {
        "round 1: 6 participants, 2 dropped": (cols["participants"][1], cols["clients_dropped"][1])
        == (6.0, 2.0),
        "round 1's dropped ids in round 2's cohort": gone <= set(cohorts[2][0]),
        "round 2 skipped as non-finite": cols["nonfinite_rounds"][2] == 1.0,
        "round 2 keeps round 1's batch-norm statistics": all(
            torch.equal(rec_a["net_state"][2][k], rec_a["net_state"][1][k])
            for k in rec_a["net_state"][1]),
        "round 3 degraded: 0 participants, 8 dropped, 8 queued": (
            cols["participants"][3], cols["clients_dropped"][3], cols["requeue_depth"][3])
        == (0.0, 8.0, 8.0),
        "round 3's whole cohort queued": set(cohorts[3][1]) == set(cohorts[3][0]),
        "round 3's degradation on stderr": "round 3 batch load failed after retries"
        in tee.text(),
        "one launch of each kernel a round": all(n == COHORT_ROUNDS
                                                 for n in launches.values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"cohort a: {bad}; launches {launches}")
    print(f"cohort a: held: {'; '.join(checks)} (launches {launches}) [{card}]", flush=True)
    b, rec_b = run(faults, "faults_async")
    if not _same_run(a, b, rec_a, rec_b):
        fail("cohort a: the async run differs from the sync run")
    print("cohort a: async == sync bitwise (params, Vvelocity, Verror, batch-norm statistics, "
          "per-round metrics, committed queue)", flush=True)
    del b

    # b. random dropout and the clip, then preempt -> resume with a queue
    drop = DROPOUT_ARGS + ["--fault_plan", DROPOUT_PLAN]
    c, rec_c = run(drop + ["--sync_loop"], "dropout_sync")
    d, rec_d = run(drop, "dropout_async")
    parts = [x["participants"] for x in rec_c["metrics"]]
    # rounds 0, 2, 4 and 5 drop clients only at random
    if not _same_run(c, d, rec_c, rec_d) or min(parts[i] for i in (0, 2, 4, 5)) == 8.0:
        fail(f"cohort b: async differs from sync, or dropout dropped nobody ({parts})")
    print(f"cohort b: participants a round {parts}; async == sync bitwise", flush=True)
    del d
    ck = os.path.join(base, "ck")
    preempt = DROPOUT_ARGS + ["--fault_plan", DROPOUT_PLAN + ";preempt@3",
                              "--checkpoint_dir", ck]
    try:
        run(preempt, "dropout_preempted")
        fail("cohort b: preempt@3 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    path = ckpt.latest(ck)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if not path.endswith("round_00000004") or not meta["requeued"]:
        fail(f"cohort b: checkpoint {path} with queue {meta['requeued']}")
    e_, rec_e = run(preempt + ["--resume"], "dropout_resumed")
    if not (e_.run_stats.rounds == 2 and _equal(_full_state(c), _full_state(e_))
            and rec_e["metrics"] == rec_c["metrics"][4:]
            and e_._requeue_committed == c._requeue_committed
            and e_._requeue_ages_committed == c._requeue_ages_committed):
        fail("cohort b: preempt -> resume differs from the uninterrupted run")
    print(f"cohort b: preempt@3 -> exit 75 with queue {meta['requeued']} (ages "
          f"{meta['requeue_ages']}) in meta.json -> resume == uninterrupted, bitwise", flush=True)
    del e_

    # c. masked == surviving cohort, one round on the card: bitwise at
    # --client_chunk 1 (one client a vmap, as the reference pins it); at
    # chunk 0 a vmap of 8 and one of 6 sum in another order (GRAD_REL_L2)
    for chunk in (1, 0):
        args = resolve_defaults(make_parser().parse_args(
            SLICE_ARGS + ["--client_chunk", str(chunk)]))
        s, _ = cv_train.build(args)
        batch = s.prepare_round(0).batch
        masked = dict(batch, _valid=batch["_valid"].clone())
        masked["_valid"][[0, 3]] = 0.0
        surv = [1, 2, 4, 5, 6, 7]
        alone = {k: v[surv] for k, v in batch.items()}
        lr = torch.tensor(CHECK_LR, device=s.device)
        out_m = s._step(s.state, s._to_device(masked), {}, lr)
        out_s = s._step(s.state, s._to_device(alone), {}, lr)
        diffs = {"params": (out_m[0]["params"] - out_s[0]["params"]).abs().max().item()}
        for k in out_m[0]["mode_state"]:
            diffs[k] = (out_m[0]["mode_state"][k] - out_s[0]["mode_state"][k]).abs().max().item()
        print(f"cohort c: chunk {chunk}: positions {{0, 3}} masked vs the 6 survivors alone: "
              f"max abs differences {diffs}", flush=True)
        if chunk == 1:
            same = (torch.equal(out_m[0]["params"], out_s[0]["params"])
                    and all(torch.equal(out_m[0][p][k], out_s[0][p][k])
                            for p in ("mode_state", "net_state") for k in out_m[0][p])
                    and all(torch.equal(out_m[2][k], out_s[2][k]) for k in out_m[2]))
            if not same:
                fail("cohort c: the masked round is not bitwise the surviving cohort's round")
            print("cohort c: chunk 1: masked round == surviving cohort's round, bitwise "
                  "(params, Vvelocity, Verror, batch-norm statistics, metrics)", flush=True)
        else:
            agree, rel, swaps = round_agreement(out_m[0], out_s[0], s.state["params"])
            verdict = (f"cohort c: chunk 0: masked vs surviving: top-k agreement {agree:.6f} "
                       f"(bound {TOPK_AGREE}), moved params rel L2 on the coordinates both "
                       f"moved {rel:.3e} (bound {GRAD_REL_L2}), {swaps} swaps")
            print(verdict, flush=True)
            if not (agree >= TOPK_AGREE and rel < GRAD_REL_L2):
                fail(verdict)

    # d. the kernels on the masked round's reduced gradient and error table
    g, _, _ = engine.reduce_clients(s.train_loss_fn, s.cfg, s.layout, s.state,
                                    s._to_device(masked))
    check_kernels(csvec, s.cfg.mode.sketch_spec, g, out_m[0]["mode_state"]["Verror"])
    print("cohort d: kernels == plain on the masked round's gradient and error table",
          flush=True)
    del s, out_m, out_s

    # f. round time and device busy beside a clean run of the same shape
    e, _ = run(["--sync_loop"], "clean_sync")
    run([], "clean_async")
    busy_clean = profile_rounds(e, top=3, label=f" clean [{card}]")
    busy_cohort = profile_rounds(c, top=3, label=f" dropout+clip [{card}]")
    print(f"cohort f: steady round ms {json.dumps({k: round(v, 2) for k, v in times.items()})}; "
          f"device busy ms a round: clean {busy_clean:.2f}, dropout+clip {busy_cohort:.2f} "
          f"[{card}]", flush=True)
    del a, c, e

    # e. DP noise on FEMNIST true_topk (no batch norm)
    fem = FEMNIST_ARGS + ["--mode", "true_topk", "--dp_clip", "1.0", "--dp_noise", "1.0",
                          "--num_rounds", str(BASE_ROUNDS)]
    s, _ = cv_train.build(resolve_defaults(make_parser().parse_args(fem)))
    batch = s._to_device(s.prepare_round(0).batch)
    weighted, _, met = engine.reduce_clients(s.train_loss_fn, s.cfg, s.layout, s.state, batch)
    noised = engine._dp_noise_agg(s.cfg, {"dense": weighted}, met["participants"], 0)["dense"]
    noise = (noised - weighted).double()
    n_live = met["participants"].item()
    want = s.cfg.dp_noise * s.cfg.dp_clip / n_live
    std = noise.std().item()
    empty = engine._dp_noise_agg(s.cfg, {"dense": weighted}, met["participants"] * 0, 0)
    print(f"cohort e: FEMNIST d={noise.numel():,}, {n_live:.0f} participants: noise std "
          f"{std:.6e} against {want:.6e} ({std / want - 1:+.4%}), mean {noise.mean().item():.3e}",
          flush=True)
    if abs(std / want - 1) > NOISE_REL or not torch.equal(empty["dense"], weighted):
        fail("cohort e: DP noise std off, or noise released with no participant")
    del s, batch, weighted, noised, noise
    s, _ = cv_train.build(resolve_defaults(make_parser().parse_args(
        fem + ["--fault_plan", "data_fail@0:times=9", "--max_retries", "0"])))
    p0 = s.state["params"].clone()
    mh = s.run_round(CHECK_LR)
    ms = s.state["mode_state"]
    if not (mh["participants"] == 0.0 and torch.equal(s.state["params"], p0)
            and not torch.count_nonzero(ms["Vvelocity"]) and not torch.count_nonzero(ms["Verror"])):
        fail("cohort e: a fully masked round with DP noise released something")
    print("cohort e: a fully masked round with DP noise on released nothing (params unchanged, "
          "Vvelocity and Verror exactly zero)", flush=True)
    del s
    fs = cv_train.main(fem + ["--sync_loop"])
    fa = cv_train.main(fem)
    if not _equal(_state(fs), _state(fa)):
        fail("cohort e: FEMNIST DP async differs from sync")
    print("cohort e: FEMNIST true_topk with DP clip and noise, async == sync bitwise", flush=True)
    del fs, fa
    shutil.rmtree(ck, ignore_errors=True)

    # g. the participation mask, the clip and the noise sync nothing
    for label, argv in (("dropout+clip", SLICE_ARGS + DROPOUT_ARGS), ("DP noise", fem)):
        print(f"cohort g: {label}:", end=" ", flush=True)
        sync_probe(cv_train, argv)
    return launches


@contextlib.contextmanager
def serving_runs(fetch_after: int = 2):
    """Inside the block, every round source a service hands out is recorded
    with its service, and the first commit at or past round
    ``fetch_after`` of a service with a metrics endpoint fetches
    ``GET /metrics`` over HTTP into rec["metrics"]."""
    import urllib.request

    from commefficient_tpu_torch.serve import service as svc

    rec = {"runs": [], "metrics": None}
    source, committed = svc.AggregationService.source, svc.ServedSource.on_committed

    def source_rec(self, start_round=None):
        src = source(self, start_round)
        rec["runs"].append((self, src))
        return src

    def committed_rec(self, committed_round):
        committed(self, committed_round)
        ms = self.service.metrics_server
        if ms is not None and rec["metrics"] is None and committed_round >= fetch_after:
            host, port = ms.address
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as r:
                rec["metrics"] = json.loads(r.read())

    svc.AggregationService.source, svc.ServedSource.on_committed = source_rec, committed_rec
    try:
        yield rec
    finally:
        svc.AggregationService.source, svc.ServedSource.on_committed = source, committed


def _drop_plan(closed_rounds) -> str:
    """The batch round's fault plan that drops the positions a served run
    masked, round by round."""
    return ";".join(f"client_drop@{c.rnd}:clients=" + "+".join(
        str(int(p)) for p in np.flatnonzero(c.arrived == 0.0))
        for c in closed_rounds if (c.arrived == 0.0).any())


def serve_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 14: the streaming aggregation service on ResNet-9 FetchSGD at
    full width; returns each kernel's launches over the served runs of (a)
    and (b)."""
    import shutil

    from commefficient_tpu_torch.obs import registry as obreg
    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "serve")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg = obreg.default()
    out = {}

    def run(extra, label, batch=False):
        """One cv_train.main run; returns its record: session, round
        source (served runs), service, logged rows (less time_s), stage
        p50s, socket bytes, table-stack copies."""
        log = os.path.join(base, f"{label}.jsonl")
        argv = SLICE_ARGS + ["--num_rounds", str(SERVE_ROUNDS), "--sync_loop",
                             "--log_jsonl", log] + list(extra)
        for st in obreg.SERVE_STAGES:
            reg.histogram(f"serve_stage_{st}_ms").reset_window()
        mark = reg.mark()
        service_from_args = cv_train.service_from_args
        if batch:  # the same session, driven by the batch round: no service
            cv_train.service_from_args = lambda args, session: None
        try:
            with serving_runs() as rec:
                s = cv_train.main(argv)
        finally:
            cv_train.service_from_args = service_from_args
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in open(log)]
        for r in rows:
            r.pop("time_s")
        svc, src = rec["runs"][0] if rec["runs"] else (None, None)
        info = {"s": s, "src": src, "svc": svc, "rows": rows, "metrics": rec["metrics"],
                "stages": {st: reg.histogram(f"serve_stage_{st}_ms").summary()["p50"]
                           for st in obreg.SERVE_STAGES} if svc is not None else None,
                "wire_bytes": mark.delta("serve_client_wire_bytes_total"),
                "copies": s.wire_copy_stats(), "round_ms": _steady_ms(s.run_stats)}
        print(f"serve {label}: steady round ms {info['round_ms']:.2f}"
              + (f", serve_stage_ms p50 {json.dumps(info['stages'])}" if svc else "")
              + (f", counters {json.dumps(svc.queue.counters())}" if svc else "")
              + f" [{card}]", flush=True)
        out[label] = info
        return info

    def same(a, b, keys=None) -> bool:
        """Bitwise: params, mode state, batch-norm statistics, the queue and
        its ages, and the eval rows (only ``keys`` of them after a resume,
        whose train-loss window starts at the resumed round)."""
        sa, sb = a["s"], b["s"]
        ra, rb = a["rows"], b["rows"]
        if keys is not None:
            ra, rb = ([{k: r[k] for k in keys} for r in x] for x in (ra, rb))
        return (_equal(_full_state(sa), _full_state(sb)) and ra == rb
                and list(sa._requeue_committed) == list(sb._requeue_committed)
                and sa._requeue_ages_committed == sb._requeue_ages_committed)

    # a. announce, inproc, against the batch round with the same drops
    kernels.reset_launch_counts()
    a = run(SERVE_ANNOUNCE, "announce_inproc")
    launches = {"announce_inproc": dict(kernels.launch_counts)}
    plan_a = _drop_plan(a["src"].closed_rounds)
    print(f"serve a: closes {[c.closed_by for c in a['src'].closed_rounds]}, batch twin plan "
          f"{plan_a!r}", flush=True)
    if not plan_a or any(n != SERVE_ROUNDS for n in launches["announce_inproc"].values()):
        fail(f"serve a: no casualties ({plan_a!r}) or launches {launches} not one a round")
    ab = run(SERVE_ANNOUNCE + ["--fault_plan", plan_a], "announce_batch", batch=True)
    if not same(a, ab):
        fail("serve a: the served announce run differs from the batch round with its drops")
    print("serve a: served announce == batch round with the same drops, bitwise (params, "
          "Vvelocity, Verror, batch-norm statistics, eval row, queue and ages); one launch of "
          "each kernel a round", flush=True)

    # b. sketch payload, inproc, against compose_payload with the same drops
    payload = ["--serve", "inproc"] + SERVE_PAYLOAD
    kernels.reset_launch_counts()
    b = run(payload + ["--fault_plan", SERVE_PLAN], "payload_inproc")
    launches["payload_inproc"] = lp = dict(kernels.launch_counts)
    counters = b["svc"].queue.counters()
    W = b["s"].num_workers
    checks = {
        f"accumulate launched {W} times a round": lp["sketch_accumulate"] == W * SERVE_ROUNDS,
        "query launched once a round": lp["sketch_query"] == SERVE_ROUNDS,
        "rejected_malformed >= 1": counters["rejected_malformed"] >= 1,
        "rejected_dup >= 1": counters["rejected_dup"] >= 1,
        "rejected_quarantined >= 1": counters["rejected_quarantined"] >= 1,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"serve b: {bad}; launches {lp}, counters {counters}")
    plan_b = _drop_plan(b["src"].closed_rounds)
    bb = run(payload + ["--fault_plan", plan_b], "payload_batch", batch=True)
    if not same(b, bb):
        fail("serve b: the served payload run differs from the batch payload round")
    print(f"serve b: held: {'; '.join(checks)} (launches {lp}); served payload == "
          f"compose_payload batch round with drops {plan_b!r}, bitwise", flush=True)
    s, _ = cv_train.build(resolve_defaults(make_parser().parse_args(SLICE_ARGS + payload)))
    batch, _ = engine.split_valid(s._to_device(s.prepare_round(0).batch))
    tables = s._payload_client(s.state, batch)[0]
    updates = engine.make_client_updates(s.train_loss_fn, s.cfg, s.layout)
    spec = s.cfg.mode.sketch_spec
    for w, u in enumerate(engine._clip_rows(s.cfg, updates(s.state, batch, None, range(W))[0])):
        got = csvec.sketch_vec(spec, u)
        compare(f"sketch_accumulate client {w}", got, csvec._sketch_vec_rotation(spec, u))
        if not torch.equal(got, tables[w]):
            fail(f"serve b: client {w}'s table in the client step differs from the kernel's "
                 "table of its recomputed update")
    print(f"serve b: each of the {W} per-client tables of round 0 == the plain sketch of its "
          "update, bitwise, and == the client step's table", flush=True)
    del s, batch, tables

    # c. the same over the socket, both engines
    for eng in ("eventloop", "threaded"):
        sock = ["--serve", "socket", "--serve_transport", eng] + SERVE_PAYLOAD
        c = run(sock + ["--fault_plan", SERVE_PLAN]
                + (["--serve_metrics_port", "0"] if eng == "eventloop" else []),
                f"payload_socket_{eng}")
        if not same(b, c):
            fail(f"serve c: the socket ({eng}) run differs from the inproc run")
        print(f"serve c: socket ({eng}) == inproc bitwise; client bytes on the wire "
              f"{c['wire_bytes'] / SERVE_ROUNDS:.0f} a round; counters "
              f"{json.dumps(c['svc'].queue.counters())}", flush=True)
    metrics = out["payload_socket_eventloop"]["metrics"]
    if not metrics or metrics.get("payload") != "sketch":
        fail(f"serve c: GET /metrics returned {metrics}")
    print(f"serve c: GET /metrics over HTTP: {json.dumps(metrics)}", flush=True)

    # d. preempt -> 75 -> resume, against (b)
    ck = os.path.join(base, "ck")
    pre = payload + ["--fault_plan", SERVE_PLAN + ";preempt@2", "--checkpoint_dir", ck]
    try:
        run(pre, "payload_preempted")
        fail("serve d: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    path = ckpt.latest(ck)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if "serve" not in meta:
        fail(f"serve d: no serve block in {path}/meta.json")
    r = run(pre + ["--resume"], "payload_resumed")
    if not (r["s"].run_stats.rounds == SERVE_ROUNDS - 3
            and same(b, r, keys=("round", "test_loss", "test_acc", "comm_mb"))):
        fail("serve d: preempt -> resume differs from the uninterrupted served run")
    print(f"serve d: preempt@2 -> exit 75, checkpoint {os.path.basename(path)} with serve block "
          f"{json.dumps(meta['serve'])} -> resume == uninterrupted served run, bitwise",
          flush=True)
    shutil.rmtree(ck, ignore_errors=True)

    # e. numbers
    for label in ("announce_inproc", "payload_inproc", "payload_socket_eventloop",
                  "payload_socket_threaded"):
        i = out[label]
        print(f"serve e: {label}: serve_stage_ms p50 {json.dumps(i['stages'])}, steady round "
              f"ms {i['round_ms']:.2f} (batch twin: announce {ab['round_ms']:.2f}, payload "
              f"{bb['round_ms']:.2f}) [{card}]", flush=True)
    for direction, d in out["payload_inproc"]["copies"].items():
        print(f"serve e: [W, r, c] stack {direction}: {d['bytes'] / d['copies']:.0f} bytes, "
              f"{d['ms'] / d['copies']:.3f} ms a round ({d['copies']} copies) [{card}]",
              flush=True)
    busy = {k: profile_rounds(out[k]["s"], top=4, label=f" {k} [{card}]")
            for k in ("announce_batch", "payload_batch")}
    print(f"serve e: device busy ms a round: announce round {busy['announce_batch']:.2f}, "
          f"payload round {busy['payload_batch']:.2f} [{card}]", flush=True)
    return launches


def gpt2_phase(kernels, csvec, engine, time_ms, gen: torch.Generator, card: str,
               prof: dict) -> dict:
    """Phase 11: GPT-2 small PersonaChat fine-tuning through
    ``gpt2_train.main``; returns the kernels' fields at the GPT-2 shape and
    fills ``prof`` with its profile window's numbers."""
    import shutil

    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.data.personachat import load_personachat_fed
    from commefficient_tpu_torch.utils import checkpoint as ckpt
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "gpt2")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    args0 = resolve_defaults(make_parser("gpt2").parse_args(GPT2_ARGS))
    t0 = time.perf_counter()
    load_personachat_fed(args0.data_root, args0.num_clients, args0.seq_len, args0.seed)
    print(f"gpt2: synthetic corpus of {args0.num_clients:,} personas at seq_len "
          f"{args0.seq_len} built in {time.perf_counter() - t0:.1f} s (host)", flush=True)

    launch_log = {}

    def run(extra, label, mode="sketch"):
        log = os.path.join(base, f"{label}.jsonl")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = gpt2_train.main(GPT2_ARGS + ["--num_rounds", str(GPT2_ROUNDS), "--log_jsonl", log,
                                         "--mode", mode, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        per_round = 1 if mode == "sketch" else 0
        if any(n != per_round * s.run_stats.rounds for n in launches.values()):
            fail(f"gpt2 {label}: launches {launches} in {s.run_stats.rounds} {mode} rounds, "
                 f"expected {per_round} per round")
        launch_log[label] = launches
        with open(log) as f:
            rows = [json.loads(line) for line in f]
        if not rows or not all(math.isfinite(r[k]) for r in rows
                               for k in ("train_nll", "val_nll")):
            fail(f"gpt2 {label}: non-finite or missing NLL in {rows}")
        print(f"gpt2 {label}: {s.run_stats.rounds} {mode} rounds in {wall:.1f} s (with start-up "
              f"and eval), launches {launches}, final row {rows[-1]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        print(_times(f"gpt2 {label}", s.run_stats, card), flush=True)
        return s, rows[-1]

    def same(a, b):
        return _equal(_state(a), _state(b))

    def rows_equal(x, y, keys=("train_nll", "val_nll", "val_f1", "comm_mb")):
        return all(x[k] == y[k] for k in keys if k in x or k in y)

    # a. the model and its flat vector
    phase_t = time.perf_counter()
    f1 = ["--eval_f1", "4"]
    a, row_a = run(f1 + ["--sync_loop"], "sync")
    layout = a.layout
    vocab = next(leaf.shape[0] for leaf in layout.leaves if leaf.name == "wte")
    print(f"gpt2: d={layout.d:,} (first leaf {layout.leaves[0].name}, last "
          f"{layout.leaves[-1].name}), vocabulary {vocab}, {a.num_workers} clients of "
          f"{a.local_batch_size} rows a round", flush=True)
    if layout.d != GPT2_D:
        fail(f"gpt2: d={layout.d}, expected {GPT2_D}")

    # b. both kernels at this shape, bitwise and timed
    spec = a.cfg.mode.sketch_spec
    v = torch.randn(spec.d, generator=gen, device="cuda")
    errs = [max(e) for e in zip(check_kernels(csvec, spec, v),
                                check_kernels(csvec, spec, a.state["params"],
                                              a.state["mode_state"]["Verror"]))]
    print(f"gpt2: kernels == plain at d={spec.d} c={spec.c} r={spec.r} "
          f"({spec.num_slabs} slabs), on a random vector and on the run's params and error "
          "table", flush=True)
    times = time_kernels(csvec, kernels, time_ms, spec, gen)
    del v

    # c. sync against async, bitwise, with dropout on
    b, row_b = run(f1, "async")
    if not (same(a, b) and rows_equal(row_a, row_b)):
        fail("gpt2: the async run differs from the sync run")
    print(f"gpt2: async == sync bitwise over {GPT2_ROUNDS} rounds (params, Vvelocity, Verror; "
          f"eval row incl. val_f1 {row_b['val_f1']})", flush=True)

    # d. preempt -> exit 75 -> resume, bitwise against the uninterrupted run
    ck = os.path.join(base, "ck_preempt")
    chaos = ["--checkpoint_dir", ck, "--fault_plan", "preempt@2"]
    try:
        run(f1 + chaos, "preempted")
        fail("gpt2: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    if ckpt.latest(ck) is None or not ckpt.latest(ck).endswith("round_00000003"):
        fail(f"gpt2: preemption checkpoint {ckpt.latest(ck)}")
    r_, row_r = run(f1 + chaos + ["--resume"], "resumed")
    if not (r_.run_stats.rounds == GPT2_ROUNDS - 3 and same(a, r_)
            and rows_equal(row_a, row_r, ("val_nll", "val_f1", "comm_mb"))):
        fail("gpt2: preempt -> resume differs from the uninterrupted run")
    print("gpt2: preempt@2 -> exit 75 -> resume == uninterrupted, bitwise, dropout on",
          flush=True)
    del r_
    shutil.rmtree(ck, ignore_errors=True)

    # e. one round at lr 0.1 against FetchSGD's algebra on the card
    print("gpt2: " + check_sketch_round(b, engine, csvec), flush=True)

    # g. greedy decodes of --eval_f1 4: bitwise equal in two calls
    args = resolve_defaults(make_parser("gpt2").parse_args(GPT2_ARGS + f1))
    _, valid_set, extras = gpt2_train.build(args)
    f1_eval = gpt2_train.F1Eval(args, extras["model"], extras["tok"], valid_set, b.device)
    (ids1, len1), (ids2, len2) = (f1_eval.decode(b.params(), 0) for _ in range(2))
    if not ((ids1 == ids2).all() and (len1 == len2).all()):
        fail("gpt2: two greedy decodes differ")
    print(f"gpt2: greedy decodes of {len(len1)} validation prompts bitwise equal in two calls "
          f"(generated lengths {(len1 - f1_eval.prompt_len).tolist()}), val_f1 "
          f"{f1_eval(b.params(), 0):.4f}", flush=True)
    del f1_eval, extras, valid_set

    # h. where a round's time goes
    busy = profile_rounds(b, top=10, label=f" gpt2 [{card}]", host_top=12, out=prof)
    del a, b

    # f. the uncompressed control, async against sync
    ua, row_ua = run(["--sync_loop", "--num_rounds", "2"], "control_sync", "uncompressed")
    ub, row_ub = run(["--num_rounds", "2"], "control_async", "uncompressed")
    if not (same(ua, ub) and rows_equal(row_ua, row_ub)):
        fail("gpt2: the uncompressed control's async run differs from its sync run")
    print("gpt2: uncompressed control, async == sync bitwise over 2 rounds", flush=True)
    print(f"gpt2: phase took {time.perf_counter() - phase_t:.1f} s; device busy {busy:.2f} "
          f"ms/round [{card}]", flush=True)
    return {name: {**times[name], "launches": launch_log["sync"][name],
                   "max_abs_err": errs[i], "d": spec.d, "c": spec.c, "r": spec.r}
            for i, name in enumerate(("sketch_accumulate", "sketch_query"))}


def write_hf_checkpoint(path: str, n_layer: int, n_embd: int, n_head: int, vocab: int,
                        positions: int, gen: torch.Generator) -> dict:
    """A GPT-2 checkpoint in HuggingFace's layout (``transformer.`` names,
    Conv1D weights [in, out], a tied ``lm_head``), random normal(0.02)
    weights and unit LayerNorm scales from ``gen``, written with
    ``torch.save`` beside its ``config.json``; returns the state dict."""
    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    sd = {"transformer.wte.weight": normal(vocab, n_embd),
          "transformer.wpe.weight": normal(positions, n_embd),
          "transformer.ln_f.weight": 1.0 + normal(n_embd), "transformer.ln_f.bias": normal(n_embd)}
    for i in range(n_layer):
        h = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[h + ln + ".weight"], sd[h + ln + ".bias"] = 1.0 + normal(n_embd), normal(n_embd)
        for name, (fan_in, fan_out) in (("attn.c_attn", (n_embd, 3 * n_embd)),
                                        ("attn.c_proj", (n_embd, n_embd)),
                                        ("mlp.c_fc", (n_embd, 4 * n_embd)),
                                        ("mlp.c_proj", (4 * n_embd, n_embd))):
            sd[h + name + ".weight"] = normal(fan_in, fan_out)
            sd[h + name + ".bias"] = normal(fan_out)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"n_head": n_head, "n_layer": n_layer, "n_embd": n_embd,
                   "layer_norm_epsilon": 1e-5}, f)
    return sd


def check_loaded(params: dict, sd: dict, vocab: int) -> str:
    """The port's parameters loaded from ``sd`` against it, bitwise: every
    linear weight transposed back ([out, in] -> HF's [in, out]), ``wte``'s
    first ``vocab`` rows as written and the rows past them the mean row plus
    0.02 x ``RandomState(0)`` normals (the reference's formula, in numpy),
    ``wpe`` sliced to the run's positions. Returns a verdict; calls
    ``fail`` on any difference."""
    import numpy as np

    bad = []
    for name, p in params.items():
        if name == "mc_head":
            continue
        p = p.detach().cpu()
        if name == "wte":
            wte = sd["transformer.wte.weight"].numpy()
            extra = p.shape[0] - vocab
            grown = wte.mean(axis=0, keepdims=True) + 0.02 * np.random.RandomState(
                0).standard_normal((extra, wte.shape[1])).astype(np.float32)
            ok = (torch.equal(p[:vocab], torch.from_numpy(wte))
                  and torch.equal(p[vocab:], torch.from_numpy(grown)))
        elif name == "wpe":
            ok = torch.equal(p, sd["transformer.wpe.weight"][:p.shape[0]])
        else:
            hf = "transformer." + name.replace("h_", "h.", 1)
            want = sd[hf]
            ok = torch.equal(p.t() if p.dim() == 2 else p, want)
        if not ok:
            bad.append(name)
    if bad:
        fail(f"init_from: loaded params differ from the written checkpoint: {bad[:8]}")
    return (f"init_from: {len(params) - 1} loaded leaves equal the written checkpoint bitwise "
            f"(wte rows 0-{vocab - 1} as written, rows {vocab}-{params['wte'].shape[0] - 1} "
            "the reference's mean + RandomState(0) formula)")


def gemm_flag_ms(time_ms, card: str) -> str:
    """cuBLAS's reduced-precision reductions of bfloat16 products, on
    (torch's default) against off (the entry point's setting), in turns on
    the GPT-2 small MLP's widest product: [4096, 768] x [768, 3072], the
    rows of one client (8 sets of 2 candidates x 256 tokens)."""
    a = torch.randn(4096, 768, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(768, 3072, device="cuda", dtype=torch.bfloat16)
    flag = torch.backends.cuda.matmul
    was = flag.allow_bf16_reduced_precision_reduction
    ms = {True: [], False: []}
    try:
        for turn in range(4):
            on = turn % 2 == 0
            flag.allow_bf16_reduced_precision_reduction = on
            ms[on].append(time_ms(lambda: a @ b, 20, lambda: None))
        flag.allow_bf16_reduced_precision_reduction = True
        c_on = a @ b
        flag.allow_bf16_reduced_precision_reduction = False
        c_off = a @ b
    finally:
        flag.allow_bf16_reduced_precision_reduction = was
    exact = (a.double() @ b.double())
    err = {k: ((c.double() - exact).norm() / exact.norm()).item()
           for k, c in (("on", c_on), ("off", c_off))}
    tflops = 2 * 4096 * 768 * 3072 / (min(ms[False]) * 1e-3) / 1e12
    return (f"bf16 reduced-precision reductions: [4096, 768] x [768, 3072] ms on "
            f"{[round(t, 4) for t in ms[True]]}, off {[round(t, 4) for t in ms[False]]} "
            f"({tflops:.0f} TFLOP/s off); relative L2 error against float64: on "
            f"{err['on']:.3e}, off {err['off']:.3e} [{card}]")


def bf16_phase(cv_train, engine, csvec, kernels, time_ms, gen: torch.Generator, card: str,
               f32: dict) -> dict:
    """Phase 13: bfloat16 compute, the double head and --init_from through
    the entry points; ``f32`` holds this run's float32 readings (phase 9's
    and 11's profile windows). Returns the kernels' launch counts and their
    fields at the MC GPT-2 shape."""
    import shutil

    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.data.personachat import load_personachat_fed
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    base = os.path.join(ROOT, "build", "chip_smoke", "bf16")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    launches = {}

    def counted(label, fn, rounds_per_run=1):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = fn()
        torch.cuda.synchronize()
        got = dict(kernels.launch_counts)
        if any(n != rounds_per_run * s.run_stats.rounds for n in got.values()):
            fail(f"bf16 {label}: launches {got} in {s.run_stats.rounds} rounds, expected "
                 f"{rounds_per_run} per round")
        launches[label] = got
        print(f"bf16 {label}: {s.run_stats.rounds} rounds in {time.perf_counter() - t0:.1f} s "
              f"(with start-up and eval), launches {got}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        print(_times(f"bf16 {label}", s.run_stats, card), flush=True)
        return s

    def rows_of(log):
        with open(log) as f:
            return [json.loads(line) for line in f]

    # a. ResNet-9 FetchSGD in bfloat16, sync and async
    res_args = SLICE_ARGS + ["--dtype", "bfloat16", "--num_rounds", str(BF16_ROUNDS)]
    logs = {k: os.path.join(base, f"resnet9_{k}.jsonl") for k in ("sync", "async")}
    a = counted("resnet9_sync", lambda: cv_train.main(
        res_args + ["--sync_loop", "--log_jsonl", logs["sync"]]))
    b = counted("resnet9_async", lambda: cv_train.main(res_args + ["--log_jsonl", logs["async"]]))
    ra, rb = rows_of(logs["sync"])[-1], rows_of(logs["async"])[-1]
    if not (_equal(_full_state(a), _full_state(b))
            and all(ra[k] == rb[k] for k in ("train_loss", "test_loss", "test_acc", "comm_mb"))):
        fail("bf16 resnet9: the async run differs from the sync run")
    if not all(math.isfinite(ra[k]) for k in ("train_loss", "test_loss")):
        fail(f"bf16 resnet9: non-finite loss in {ra}")
    print(f"bf16 resnet9: async == sync bitwise over {BF16_ROUNDS} rounds (params, Vvelocity, "
          f"Verror, batch-norm statistics, eval row {ra})", flush=True)
    del b
    check_kernels(csvec, a.cfg.mode.sketch_spec, a.state["params"], a.state["mode_state"]["Verror"])
    print("bf16 resnet9: kernels == plain on the run's params and error table", flush=True)
    # the card's bf16 gradient against the CPU port's, and against float32
    batch = a.prepare_round().batch
    g_card, _, m_card = engine.reduce_clients(a.train_loss_fn, a.cfg, a.layout, a.state,
                                              a._to_device(batch))
    cpu_state = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.cpu() if torch.is_tensor(v) else v) for k, v in a.state.items()}
    g_cpu, _, m_cpu = engine.reduce_clients(a.train_loss_fn, a.cfg, a.layout, cpu_state,
                                            dict(batch))
    f32_session, _ = cv_train.build(resolve_defaults(make_parser().parse_args(SLICE_ARGS)))
    g_f32, _, _ = engine.reduce_clients(f32_session.train_loss_fn, f32_session.cfg,
                                        f32_session.layout, a.state, a._to_device(batch))
    del f32_session
    cpu_rel = ((g_card.cpu() - g_cpu).norm() / g_cpu.norm()).item()
    gap = ((g_card - g_f32).norm() / g_f32.norm()).item()
    loss_rel = abs(m_card["loss_sum"].item() / m_cpu["loss_sum"].item() - 1)
    verdict = (f"bf16 resnet9: reduced gradient, card bf16 vs CPU bf16 relative L2 {cpu_rel:.3e} "
               f"(bound: the card's own bf16-vs-float32 gap {gap:.3e}; phase 7's float32 card "
               f"vs CPU bound {GRAD_REL_L2}), loss sum rel {loss_rel:.3e} (bound {BF16_LOSS_REL})")
    if not (cpu_rel < gap and loss_rel < BF16_LOSS_REL):
        fail(verdict)
    print(verdict, flush=True)
    prof_res = {}
    profile_rounds(a, top=6, label=f" bf16 resnet9 [{card}]", out=prof_res)
    print(f"bf16 resnet9: device busy {prof_res.get('busy_ms', 0.0):.2f} ms/round against "
          f"float32's {f32.get('resnet9_busy_ms', 0.0):.2f} (phase 9) [{card}]", flush=True)
    del a

    # b. GPT-2 small, the double head in bfloat16
    print(gemm_flag_ms(time_ms, card), flush=True)
    mc = GPT2_ARGS + ["--mc_coef", "1", "--num_candidates", "2", "--dtype", "bfloat16",
                      "--num_rounds", str(GPT2_ROUNDS)]
    args0 = resolve_defaults(make_parser("gpt2").parse_args(mc))
    t0 = time.perf_counter()
    load_personachat_fed(args0.data_root, args0.num_clients, args0.seq_len, args0.seed,
                         num_candidates=2)
    print(f"bf16 gpt2: MC corpus of {args0.num_clients:,} personas x 2 candidates at seq_len "
          f"{args0.seq_len} built in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    logs = {k: os.path.join(base, f"gpt2_{k}.jsonl") for k in ("sync", "async", "init")}
    s = counted("gpt2_mc_sync", lambda: gpt2_train.main(
        mc + ["--sync_loop", "--eval_f1", "4", "--log_jsonl", logs["sync"]]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if s.layout.d != GPT2_MC_D:
        fail(f"bf16 gpt2: d={s.layout.d}, expected {GPT2_MC_D}")
    t = counted("gpt2_mc_async", lambda: gpt2_train.main(
        mc + ["--eval_f1", "4", "--log_jsonl", logs["async"]]))
    rs, rt = rows_of(logs["sync"])[-1], rows_of(logs["async"])[-1]
    keys = ("train_nll", "val_nll", "mc_acc", "val_mc_acc", "val_f1", "comm_mb")
    if not all(math.isfinite(rs[k]) for k in keys):
        fail(f"bf16 gpt2: non-finite value in {rs}")
    if not (_equal(_state(s), _state(t)) and all(rs[k] == rt[k] for k in keys)):
        fail("bf16 gpt2: the async run differs from the sync run")
    print(f"bf16 gpt2: d={s.layout.d:,} (mc_head at {[l.name for l in s.layout.leaves][-3]}), "
          f"async == sync bitwise over {GPT2_ROUNDS} rounds; final row {rs}", flush=True)
    del t
    spec = s.cfg.mode.sketch_spec
    v = torch.randn(spec.d, generator=gen, device="cuda")
    errs = [max(e) for e in zip(check_kernels(csvec, spec, v),
                                check_kernels(csvec, spec, s.state["params"],
                                              s.state["mode_state"]["Verror"]))]
    del v
    print(f"bf16 gpt2: kernels == plain at d={spec.d} c={spec.c} r={spec.r} "
          f"({spec.num_slabs} slabs), on a random vector and on the run's params and error "
          "table", flush=True)
    times = time_kernels(csvec, kernels, time_ms, spec, gen)
    prof = {}
    profile_rounds(s, top=12, label=f" bf16 gpt2 mc [{card}]", host_top=8, out=prof)
    print(f"bf16 gpt2: device busy {prof.get('busy_ms', 0.0):.2f} ms/round, matrix products "
          f"{prof.get('gemm_ms', 0.0):.2f}, peak device memory {peak_gb:.2f} GB; float32 LM "
          f"(phase 11): busy {f32.get('gpt2_busy_ms', 0.0):.2f}, matrix products "
          f"{f32.get('gpt2_gemm_ms', 0.0):.2f} [{card}]", flush=True)
    del s

    # c. --init_from a checkpoint in HuggingFace's layout
    ckpt_dir = os.path.join(base, "hf_gpt2_small")
    t0 = time.perf_counter()
    sd = write_hf_checkpoint(ckpt_dir, 12, 768, 12, INIT_VOCAB, 1024,
                             torch.Generator().manual_seed(0))
    init = mc[:mc.index("--num_rounds")] + ["--num_rounds", str(INIT_ROUNDS), "--init_from",
                                            ckpt_dir]
    session, _, _ = gpt2_train.build(resolve_defaults(make_parser("gpt2").parse_args(init)))
    print(check_loaded(session.params(), sd, INIT_VOCAB) + f" ({time.perf_counter() - t0:.1f} s "
          "to write and load)", flush=True)
    del session
    u = counted("init_from", lambda: gpt2_train.main(init + ["--log_jsonl", logs["init"]]))
    ru = rows_of(logs["init"])[-1]
    if not all(math.isfinite(ru[k]) for k in ("train_nll", "val_nll", "mc_acc")):
        fail(f"bf16 init_from: non-finite value in {ru}")
    print(f"bf16 init_from: {INIT_ROUNDS} rounds from the checkpoint, final row {ru}", flush=True)
    del u, sd
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"launches": launches,
            "gpt2_mc": {name: {**times[name], "launches": launches["gpt2_mc_sync"][name],
                               "max_abs_err": errs[i], "d": spec.d, "c": spec.c, "r": spec.r}
                        for i, name in enumerate(("sketch_accumulate", "sketch_query"))}}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def round_agreement(a: dict, b: dict, p0: torch.Tensor) -> tuple[float, float, int]:
    """Two top-k rounds from one state whose gradients differ by rounding:
    (the share of b's moved coordinates that a moved too, the rel L2 of a's
    movement against b's on the coordinates both moved, the coordinates one
    moved and the other did not). A near-tie at the k-th estimate swaps
    between the two; their state differs by whole steps there."""
    ma, mb = a["params"] != p0, b["params"] != p0
    both = ma & mb
    agree = (both.sum() / mb.sum().clamp_min(1)).item()
    rel = _rel_l2(a["params"][both] - p0[both], b["params"][both] - p0[both])
    return agree, rel, int((ma ^ mb).sum())


def _client_rows(session, engine, batch: dict, chunk: int) -> tuple:
    """The cohort's per-client updates and metric sums as ``client_chunk`` =
    ``chunk`` computes them (0: one vmap of all W; C: W / C vmaps)."""
    updates = engine.make_client_updates(session.train_loss_fn, session.cfg, session.layout)
    W = next(iter(batch.values())).shape[0]
    C = chunk or W
    outs = [updates(session.state, {k: v[lo:lo + C] for k, v in batch.items()}, None,
                    range(lo, lo + C)) for lo in range(0, W, C)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[2]["loss_sum"] for o in outs])


def timed_pairs(sessions: dict, pairs: int, card: str) -> None:
    """Sync rounds of ``sessions`` in turns (a, b, then b, a, ...), each
    batch prepared first: per label the host ms of the dispatch (the round's
    launches, from the call to its return) and of the round (dispatch to
    the device's end), then a profiler window of 2 rounds: device busy,
    matrix products and kernel launches a round; prints them."""
    out = {label: {"dispatch_ms": [], "round_ms": []} for label in sessions}
    order = list(sessions)
    for i in range(pairs):
        for label in (order if i % 2 == 0 else order[::-1]):
            s = sessions[label]
            prep = s.prepare_round()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infl = s.dispatch_round(prep, 0.01)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            s.commit_round(infl)
            out[label]["dispatch_ms"].append((t1 - t0) * 1e3)
            out[label]["round_ms"].append((t2 - t0) * 1e3)
    for label, s in sessions.items():
        prof = {}
        profile_rounds(s, top=0, label=f" {label} [{card}]", out=prof)
        r = out[label]
        r.update(prof)
        busy, gemm = r.get("busy_ms", 0.0), r.get("gemm_ms", 0.0)
        print(f"batched {label}: sync, {pairs} rounds in turns: host dispatch ms "
              f"{[round(t, 2) for t in r['dispatch_ms']]} (median "
              f"{statistics.median(r['dispatch_ms']):.2f}), round ms "
              f"{[round(t, 2) for t in r['round_ms']]} (median "
              f"{statistics.median(r['round_ms']):.2f}); device busy {busy:.2f} ms a round, "
              f"matrix products {gemm:.2f}, the rest {busy - gemm:.2f}; "
              f"{r.get('launches', 0.0):.0f} kernel launches a round [{card}]", flush=True)


def batched_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 15: the batched client phase (one ``torch.func.vmap`` over the
    cohort, ``--client_chunk``) at full width through the entry points'
    build functions; returns each kernel's launches a round, by run."""
    import warnings

    launches = {}
    # a batching rule functorch lacks falls back to a loop over the clients,
    # with this warning
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _batched_runs(cv_train, engine, csvec, kernels, card, launches)
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = sorted({str(w.message)[:160] for w in caught if "fallback" in str(w.message)})
    if fallbacks:
        fail(f"batched: vmap fell back to a loop: {fallbacks}")
    print("batched: no vmap batching-rule fallback on any model's step", flush=True)
    return launches


def _batched_runs(cv_train, engine, csvec, kernels, card: str, launches: dict) -> None:
    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    lr = CHECK_LR

    def counted_round(label, s):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        s.run_round(lr)
        torch.cuda.synchronize()
        got = dict(kernels.launch_counts)
        launches[label] = got
        if any(n != 1 for n in got.values()):
            fail(f"batched {label}: launches {got} in one sketch round, expected 1 each")
        return torch.cuda.max_memory_allocated() / 1e9

    # a. ResNet-9 FetchSGD at chunk 0, 4 and 1
    sessions = {c: cv_train.build(resolve_defaults(make_parser().parse_args(
        SLICE_ARGS + ["--client_chunk", str(c)])))[0] for c in BATCH_CHUNKS}
    s0 = sessions[0]
    p0 = s0.state["params"].clone()
    rng_state = s0.rng.get_state()
    batch, _ = engine.split_valid(s0._to_device(s0.prepare_round().batch))
    s0.rng.set_state(rng_state)
    rows = {c: _client_rows(s0, engine, batch, c) for c in BATCH_CHUNKS}
    grad_rel = {c: max(_rel_l2(rows[c][0][w], rows[1][0][w]) for w in range(len(rows[1][0])))
                for c in BATCH_CHUNKS}
    loss_rel = {c: max(abs(a / b - 1) for a, b in zip(rows[c][1].tolist(), rows[1][1].tolist()))
                for c in BATCH_CHUNKS}
    host_batch = s0.prepare_round().batch
    s0.rng.set_state(rng_state)
    reduced = {c: engine.reduce_clients(s.train_loss_fn, s.cfg, s.layout, s.state,
                                        s._to_device(host_batch))[0]
               for c, s in sessions.items()}
    reduced_rel = {c: _rel_l2(reduced[c], reduced[1]) for c in BATCH_CHUNKS}
    check_kernels(csvec, s0.cfg.mode.sketch_spec, reduced[0], s0.state["mode_state"]["Verror"])
    del rows, reduced
    peak = {c: counted_round(f"resnet9_chunk{c}", s) for c, s in sessions.items()}
    agree = {c: round_agreement(_state(s), _state(sessions[1]), p0)
             for c, s in sessions.items()}
    verdict = (f"batched resnet9: against chunk 1, per-client loss sums worst rel "
               f"{json.dumps(loss_rel)} (bound {FWD_REL}), per-client gradients worst rel L2 "
               f"{json.dumps(grad_rel)} (bound {CLIENT_GRAD_REL}), the cohort's reduced "
               f"gradient rel L2 {json.dumps(reduced_rel)} (bound {GRAD_REL_L2}); a round at lr "
               f"{lr} from one state and cohort: (top-k agreement, moved params rel L2 on the "
               f"coordinates both moved, swaps) {json.dumps(agree)} (bounds {TOPK_AGREE}, "
               f"{GRAD_REL_L2}); launches {launches}; peak device memory GB "
               f"{json.dumps({c: round(v, 2) for c, v in peak.items()})}")
    if not (max(loss_rel.values()) < FWD_REL and max(grad_rel.values()) < CLIENT_GRAD_REL
            and max(reduced_rel.values()) < GRAD_REL_L2
            and min(a[0] for a in agree.values()) >= TOPK_AGREE
            and max(a[1] for a in agree.values()) < GRAD_REL_L2):
        fail(verdict)
    print(verdict + "; kernels == plain on the chunk-0 reduced gradient and error table",
          flush=True)
    timed_pairs({"resnet9 chunk 0": sessions[0], "resnet9 chunk 1": sessions[1]}, BATCH_PAIRS,
                card)
    del sessions, s0, batch

    # b. GPT-2 small at full width: LM float32 and the double head in bfloat16
    mc = ["--mc_coef", "1", "--num_candidates", "2", "--dtype", "bfloat16"]
    for name, extra, grad_bound, loss_bound in (("gpt2_lm", [], CLIENT_GRAD_REL, FWD_REL),
                                                ("gpt2_mc_bf16", mc, BF16_GRAD_REL,
                                                 BF16_LOSS_REL)):
        sessions, peak = {}, {}
        for c in GPT2_CHUNKS:
            args = resolve_defaults(make_parser("gpt2").parse_args(
                GPT2_ARGS + extra + ["--client_chunk", str(c)]))
            sessions[c], _, extras = gpt2_train.build(args)
        keep = 1.0 - extras["model"].cfg.dropout
        del extras
        s0 = sessions[0]
        rng_state = s0.rng.get_state()
        batch, _ = engine.split_valid(s0._to_device(s0.prepare_round().batch))
        s0.rng.set_state(rng_state)
        W = next(iter(batch.values())).shape[0]
        loss_fn, cfg, rnd = s0.train_loss_fn, s0.cfg, s0.state["round"]
        stacked = engine._draw_masks(loss_fn, cfg, rnd, range(W), 0, batch, s0.device)
        for w in range(W):
            one = engine._draw_masks(loss_fn, cfg, rnd, range(w, w + 1), 0,
                                     {k: v[w:w + 1] for k, v in batch.items()}, s0.device)
            # the embedding's mask, as the forward draws it from the generator
            direct = torch.rand(stacked[0][w].shape, device=s0.device,
                                generator=cfg.generator(rnd, w, 0, s0.device)) < keep
            if not (all(torch.equal(a[w], b[0]) for a, b in zip(stacked, one))
                    and torch.equal(stacked[0][w], direct)):
                fail(f"batched {name}: client {w}'s dropout masks under the vmap differ from "
                     "its generator's")
        n_masks = len(stacked)
        del stacked, one, direct
        r0, r1 = _client_rows(s0, engine, batch, 0), _client_rows(s0, engine, batch, 1)
        grad_rel = max(_rel_l2(r0[0][w], r1[0][w]) for w in range(W))
        loss_rel = max(abs(a / b - 1) for a, b in zip(r0[1].tolist(), r1[1].tolist()))
        del r0, r1, batch
        for c, s in sessions.items():
            peak[c] = counted_round(f"{name}_chunk{c}", s)
        verdict = (f"batched {name}: the {n_masks} dropout masks of each of the {W} clients "
                   f"under the vmap == its (round, slot, step) generator's, bitwise; per-client "
                   f"gradient chunk 0 against chunk 1 worst rel L2 {grad_rel:.3e} (bound "
                   f"{grad_bound}), loss sum rel {loss_rel:.3e} (bound {loss_bound}); launches "
                   f"{ {c: launches[f'{name}_chunk{c}'] for c in GPT2_CHUNKS} }; peak device "
                   f"memory GB a round (the three sessions' states live) "
                   f"{json.dumps({c: round(v, 2) for c, v in peak.items()})} [{card}]")
        if not (grad_rel < grad_bound and loss_rel < loss_bound):
            fail(verdict)
        print(verdict, flush=True)
        timed_pairs({f"{name} chunk 0": sessions[0], f"{name} chunk 1": sessions[1]},
                    BATCH_PAIRS, card)
        del sessions, s0


@contextlib.contextmanager
def recording_health(engine):
    """Inside the block, every health block the engine computes records its
    raw aggregate table (a copy), the CUDA events around the block and the
    device memory before it and at its peak (the peak statistics are reset
    just before the block)."""
    rec = []
    orig = engine._health_metrics

    def health(cfg, raw_agg, *a, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0.record()
        out = orig(cfg, raw_agg, *a, **kw)
        t1.record()
        rec.append({"table": raw_agg["table"].clone(), "events": (t0, t1), "base": base,
                    "peak": torch.cuda.max_memory_allocated()})
        return out

    engine._health_metrics = health
    try:
        yield rec
    finally:
        engine._health_metrics = orig


def _capture_kernels(path: str) -> Counter:
    """Device kernel launches by name in an exported torch.profiler trace."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in evs if e.get("cat") == "kernel")


def obs_phase(cv_train, engine, csvec, kernels, card: str) -> dict:
    """Phase 16: the observability layer on the card; returns each kernel's
    launches over (a)'s armed run, (d)'s GPT-2 health run and (e)'s served
    payload run."""
    import dataclasses
    import shutil

    from commefficient_tpu_torch import gpt2_train, obs
    from commefficient_tpu_torch.obs import ledger as tledger
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    phase_t = time.perf_counter()
    base = os.path.join(ROOT, "build", "chip_smoke", "obs")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    launches = {}

    def run(extra, label, main=cv_train.main, argv0=SLICE_ARGS, rounds=OBS_ROUNDS):
        log = os.path.join(base, f"{label}.jsonl")
        s = main(argv0 + ["--num_rounds", str(rounds), "--log_jsonl", log] + list(extra))
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in open(log)]
        for r in rows:
            r.pop("time_s")
        return s, rows

    def armed(tag):
        return ["--trace", os.path.join(base, f"{tag}.trace.json"), "--trace_events",
                os.path.join(base, f"{tag}.events.jsonl"), "--health_every", "2", "--ledger",
                os.path.join(base, f"{tag}.ledger.jsonl"), "--slo", "warn"]

    # a. armed against plain, bitwise; the trace, the capture, the blocks
    plain, rows_p = run([], "plain")
    pdir = os.path.join(base, "prof")
    kernels.reset_launch_counts()
    with recording_health(engine) as hrec:
        arm, rows_a = run(armed("a") + ["--profile_rounds", "2:3", "--profile_dir", pdir],
                          "armed")
    launches["armed"] = la = dict(kernels.launch_counts)
    if not (_equal(_full_state(plain), _full_state(arm)) and rows_p == rows_a):
        fail("obs a: the armed run differs from the plain run")
    health_rounds = [r for r in range(OBS_ROUNDS) if r % 2 == 0]
    want = {"sketch_accumulate": OBS_ROUNDS, "sketch_query": OBS_ROUNDS + len(health_rounds)}
    if la != want:
        fail(f"obs a: launches {la}, expected {want} (one query more a health round)")
    with open(os.path.join(base, "a.trace.json")) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e["ph"] != "M"]
    spans = Counter((e["cat"], e["name"]) for e in evs)
    device = sorted((e["args"]["round_first"], e["args"]["rounds"]) for e in evs
                    if e["cat"] == "device")
    if (any(spans[("runner", p)] < 1 for p in ("prepare", "dispatch", "drain", "commit", "eval"))
            or [r for f, n in device for r in range(f, f + n)] != list(range(OBS_ROUNDS))):
        fail(f"obs a: the trace lacks runner spans or device spans: {spans}, {device}")
    (cap,) = os.listdir(pdir)
    first, last = (int(x) for x in cap.split(".")[0].split("_")[1:3])
    got = _capture_kernels(os.path.join(pdir, cap))
    cap_acc = sum(n for k, n in got.items() if "accumulate_tiles" in k)
    cap_query = sum(n for k, n in got.items() if "query_tiles" in k)
    covered = range(first, last + 1)
    want_q = len(covered) + sum(1 for r in covered if r % 2 == 0)
    if (cap_acc, cap_query) != (len(covered), want_q):
        fail(f"obs a: the capture of rounds {first}..{last} holds accumulate_tiles "
             f"{cap_acc}x and query_tiles {cap_query}x, expected {len(covered)} and {want_q}")
    blocks = list(arm.health_monitor.history)
    if [r for r, _ in blocks] != health_rounds:
        fail(f"obs a: health blocks on rounds {[r for r, _ in blocks]}, not {health_rounds}")
    for r, b in blocks:
        gap = abs(b["topk_mass_proxy"] - b["topk_mass_true"])
        print(f"obs a: round {r}: topk_mass_proxy {b['topk_mass_proxy']:.4f} (width "
              f"{b['topk_proxy_width']:.4f}) against topk_mass_true {b['topk_mass_true']:.4f}, "
              f"gap {gap:.4f}; row_mass_cv {b['row_mass_cv']:.4f}, occupancy "
              f"{b['table_occupancy']:.4f}, verror_ratio {b['verror_ratio']:.4f}", flush=True)
        if not gap <= 0.05:
            fail(f"obs a: round {r}'s recall proxy is {gap:.4f} from the truth (bar 0.05)")
    spec = arm.cfg.mode.sketch_spec
    for h in hrec:
        compare("sketch_query on a health round's raw table", csvec.query_all(spec, h["table"]),
                csvec._query_all_rotation(spec, h["table"]))
    led = os.path.join(base, "a.ledger.jsonl")
    arm2, _ = run(armed("a2"), "armed2")
    codes = (tledger.main(["replay-check", led]),
             tledger.main(["diff", led, os.path.join(base, "a2.ledger.jsonl")]))
    if codes != (0, 0):
        fail(f"obs a: ledger replay-check / diff exit {codes}")
    print(f"obs a: armed run (--trace --trace_events --health_every 2 --ledger --slo warn "
          f"--profile_rounds 2:3) == plain run bitwise; launches {la}; {len(evs)} trace events, "
          f"device spans {device}; capture of rounds {first}..{last}: accumulate_tiles "
          f"{cap_acc}x, query_tiles {cap_query}x; health blocks on rounds {health_rounds}; the "
          "health rounds' raw-table queries == plain bitwise; ledger replay-check 0, diff "
          "against a second armed run 0", flush=True)
    del plain, arm, arm2, hrec

    # b. preempt -> 75 -> resume with --ledger, and the exit-75 bundle
    ck, led_b = os.path.join(base, "ck"), os.path.join(base, "b.ledger.jsonl")
    pre = ["--ledger", led_b, "--trace", os.path.join(base, "b.trace.json"),
           "--checkpoint_dir", ck, "--fault_plan", "preempt@2"]
    try:
        run(pre, "preempted")
        fail("obs b: preempt@2 did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    bundle = led_b + ".postmortem"
    have = sorted(os.listdir(bundle))
    with open(os.path.join(bundle, "reason.json")) as f:
        reason = json.load(f)
    if (have != ["config.json", "ledger_tail.jsonl", "reason.json", "registry.json",
                 "trace.json"] or reason["reason"] != "preemption"
            or reason["artifact_failures"] is not None):
        fail(f"obs b: the exit-75 bundle holds {have}, reason {reason}")
    r_, _ = run(pre + ["--resume"], "resumed")
    recs = tledger.round_records(led_b)
    if tledger.replay_check(led_b) or [r["round"] for r in recs] != list(range(OBS_ROUNDS)):
        fail(f"obs b: the resumed ledger is not gap-free: {[r['round'] for r in recs]}")
    print(f"obs b: preempt@2 -> exit 75 (bundle {have}, reason preemption) -> resume: one "
          f"ledger, rounds {[r['round'] for r in recs]}, no gaps or duplicates", flush=True)
    del r_
    shutil.rmtree(ck, ignore_errors=True)

    # c. the sync probe, armed
    led_c = os.path.join(base, "c.ledger.jsonl")
    print("obs c: --trace --health_every 1 --ledger:", end=" ", flush=True)
    sync_probe(cv_train, SLICE_ARGS + ["--trace", os.path.join(base, "c.trace.json"),
                                       "--health_every", "1", "--ledger", led_c])
    recs = tledger.round_records(led_c)
    if len(recs) != 5 or not all(r["health"] and r["fingerprint"] for r in recs):
        fail(f"obs c: the probe's ledger holds {len(recs)} rounds with health and fingerprints")

    # d. GPT-2: the chunked split estimator at d = 85,453,056
    kernels.reset_launch_counts()
    with recording_health(engine) as hrec:
        g, _ = run(["--sync_loop", "--health_every", "1"], "gpt2", gpt2_train.main, GPT2_ARGS, 2)
    launches["gpt2_health"] = lg = dict(kernels.launch_counts)
    if lg != {"sketch_accumulate": 2, "sketch_query": 4}:
        fail(f"obs d: launches {lg}, expected 2 accumulates and 4 queries")
    for r, b in g.health_monitor.history:
        bad = [k for k, v in b.items() if not np.isfinite(v).all()]
        if bad:
            fail(f"obs d: GPT-2 round {r}'s health block is not finite: {bad}")
        print(f"obs d: GPT-2 round {r}: topk_mass_proxy {b['topk_mass_proxy']:.4f} (width "
              f"{b['topk_proxy_width']:.4f}) against topk_mass_true {b['topk_mass_true']:.4f}; "
              f"{len(b['leaf_norms'])} leaf norms", flush=True)
    torch.cuda.synchronize()
    hms = [h["events"][0].elapsed_time(h["events"][1]) for h in hrec]
    hgb = [(h["peak"] - h["base"]) / 1e9 for h in hrec]
    spec = g.cfg.mode.sketch_spec
    chunk = max(g.cfg.mode.k, csvec.UNSKETCH_SINGLE_SHOT_BYTES // (4 * spec.r))
    del hrec

    def timed_round(session) -> tuple:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        session.run_round(0.01)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1), torch.cuda.max_memory_allocated() / 1e9

    cfg_on = g.cfg
    turns = {"health": [], "off": []}
    for label in ("off", "health", "off", "health"):
        g.cfg = cfg_on if label == "health" else dataclasses.replace(cfg_on, health=False)
        g._build_steps()
        turns[label].append(timed_round(g))
    print(f"obs d: GPT-2 health block (chunked split estimator, chunks of {chunk:,} "
          f"coordinates, {math.ceil(spec.d / chunk)} chunks): device ms between its events "
          f"{[round(t, 2) for t in hms]}, transient peak above the round's live memory "
          f"{[round(x, 2) for x in hgb]} GB; a whole round (device ms, peak GB) with the "
          f"block {turns['health']} against without {turns['off']} [{card}]", flush=True)
    del g

    # e. served payload rounds: the health block == the batch payload round's
    payload = ["--sync_loop", "--serve", "inproc"] + SERVE_PAYLOAD + ["--health_every", "1"]
    kernels.reset_launch_counts()
    with serving_runs() as rec:
        served, _ = run(payload, "served", rounds=SERVE_ROUNDS)
    launches["served_health"] = ls = dict(kernels.launch_counts)
    W = served.num_workers
    if ls != {"sketch_accumulate": W * SERVE_ROUNDS, "sketch_query": 2 * SERVE_ROUNDS}:
        fail(f"obs e: launches {ls}, expected {W} accumulates and 2 queries a round")
    plan = _drop_plan(rec["runs"][0][1].closed_rounds)
    service_from_args = cv_train.service_from_args
    cv_train.service_from_args = lambda args, session: None
    try:
        batch, _ = run(payload + (["--fault_plan", plan] if plan else []), "served_batch",
                       rounds=SERVE_ROUNDS)
    finally:
        cv_train.service_from_args = service_from_args
    hs, hb = list(served.health_monitor.history), list(batch.health_monitor.history)
    if hs != hb or len(hs) != SERVE_ROUNDS or not _equal(_full_state(served),
                                                         _full_state(batch)):
        fail("obs e: the served payload rounds' health blocks differ from the batch twin's")
    print(f"obs e: served payload, {SERVE_ROUNDS} rounds with health: every block == the batch "
          f"payload round's (drops {plan!r}) bitwise; launches {ls}", flush=True)
    del served, batch

    # f. round ms, armed against plain, in turns
    def session(extra):
        args = resolve_defaults(make_parser().parse_args(SLICE_ARGS + list(extra)))
        s, _ = cv_train.build(args)
        return s, obs.attach_from_args(args, s)

    trace_f = os.path.join(base, "f.trace.json")
    (sp, _), (sa, wa) = session([]), session(armed("f"))
    ms = {"plain": [], "armed, off cadence": [], "armed, health round": []}
    for s in (sp, sa):
        s.run_round(0.01)  # warm
    torch.cuda.synchronize()
    for _ in range(OBS_PAIRS * 2):
        for label, s in (("plain", sp), ("armed", sa)):
            obs.trace.configure(trace_f if s is sa else None)
            if s is sa:
                label = "armed, health round" if s.round % 2 == 0 else "armed, off cadence"
            t0 = time.perf_counter()
            s.run_round(0.01)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
    obs.trace.configure()
    wa.close()
    print("obs f: sync round ms (prepare, dispatch, commit, synchronize), in turns: "
          + "; ".join(f"{k} {[round(t, 2) for t in v]} (median {statistics.median(v):.2f})"
                      for k, v in ms.items()) + f" [{card}]", flush=True)
    del sp, sa
    print(f"obs: phase took {time.perf_counter() - phase_t:.1f} s [{card}]", flush=True)
    return launches


REPLACES = {"sketch_accumulate": "commefficient_tpu/sketch/pallas_kernels.py:135",
            "sketch_query": "commefficient_tpu/sketch/pallas_kernels.py:211"}


def time_kernels(csvec, kernels, time_ms, spec, gen: torch.Generator) -> dict:
    """Each kernel's median over CUDA-event-timed launches at ``spec``'s
    shape, cold (L2 flushed before each) and warm (its input just
    rewritten), its plain version's time and its bound: the bytes it must
    move at 3.35 TB/s or its float32 operations at 67 TFLOP/s, whichever
    is larger. Prints one line per kernel."""
    d, c, r = spec.d, spec.c, spec.r
    v = torch.randn(d, generator=gen, device="cuda")
    table = csvec._sketch_vec_rotation(spec, v)
    shifts, ks = csvec._rotation_keys(spec, v.device)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    hash_bytes = 4 * (r * spec.num_slabs + r)
    work = {
        # bytes: v read once, table written once (query: the reverse)
        "sketch_accumulate": dict(
            fn=lambda: kernels.accumulate(v, shifts, ks, c), input=v,
            plain=lambda: csvec._sketch_vec_rotation(spec, v),
            bytes=4 * d + 4 * r * c + hash_bytes,
            ops=2 * r * d),  # a +-1 multiply and an add per (row, coordinate)
        "sketch_query": dict(
            fn=lambda: kernels.query(table, shifts, ks, d), input=table,
            plain=lambda: csvec._query_all_rotation(spec, table),
            bytes=4 * r * c + 4 * d + hash_bytes,
            # r multiplies and the odd-even network's min and max per coordinate
            ops=(r + 2 * sum((r - p % 2) // 2 for p in range(r))) * d),
    }
    out = {}
    for name, w in work.items():
        ms = time_ms(w["fn"], TIMED_LAUNCHES, flush.sum)
        # warm: the input just written, and read from L2 as far as it fits
        warm_ms = time_ms(w["fn"], TIMED_LAUNCHES, lambda: w["input"].mul_(1.0))
        plain_ms = time_ms(w["plain"], 5, flush.sum)
        bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = w["ops"] / FP32_OPS_PER_S * 1e3
        out[name] = {"ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "mb": w["bytes"] / 1e6}
        print(f"{name} at d={d} c={c} r={r}: {ms:.4f} ms (L2 flushed; median of "
              f"{TIMED_LAUNCHES})  warm {warm_ms:.4f} ms  plain {plain_ms:.3f} ms  bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}: "
              f"{w['bytes'] / 1e6:.1f} MB)", flush=True)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.federated import engine
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
    from commefficient_tpu_torch.sketch import _build, csvec, kernels
    from commefficient_tpu_torch.sketch.time_kernels import card_line, ptxas_summary, time_ms

    cohorts = int(argv[argv.index("--cohorts") + 1]) if "--cohorts" in argv else COHORTS
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else PAIRS
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"== phase {name} at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. card
    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s  ({_build.library_path().name})", flush=True)
    if _build.build_log:
        print(f"ptxas: {ptxas_summary(_build.build_log)}", flush=True)

    # 3. kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"sketch_accumulate": 0.0, "sketch_query": 0.0}
    for d, c, r in [(SLICE["d"], SLICE["c"], SLICE["r"]), *EDGE_SHAPES]:
        spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=42, family="rotation")
        v = torch.randn(d, generator=gen, device=dev)
        a, q = check_kernels(csvec, spec, v)
        errs["sketch_accumulate"] = max(errs["sketch_accumulate"], a)
        errs["sketch_query"] = max(errs["sketch_query"], q)
        print(f"kernel == plain at d={d} c={c} r={r}", flush=True)

    # 4. times at the slice's shapes
    phase("4 (times)")
    spec = csvec.CSVecSpec(d=SLICE["d"], c=SLICE["c"], r=SLICE["r"], seed=42,
                           family="rotation")
    rows = {}
    for name, t in time_kernels(csvec, kernels, time_ms, spec, gen).items():
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "commefficient_tpu_torch/sketch/csrc/sketch_kernels.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": 0.0,
            **{k: t[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
        }
    if "--kernels-only" in argv:
        print("chip_smoke: kernels-only run done", flush=True)
        return 0

    # 5. main path
    phase("5 (main path)")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "sketch_rows.jsonl")
    if os.path.exists(log):
        os.remove(log)
    model = ResNet9()
    init_weights(model, 42)  # the parser's default --seed: the run's initial params
    p0 = FlatLayout(model).flatten(dict(model.named_parameters())).to(dev)
    kernels.reset_launch_counts()
    session = cv_train.main(SLICE_ARGS + ["--num_rounds", str(ROUNDS), "--log_jsonl", log])
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    with open(log) as f:
        logged = [json.loads(line) for line in f]
    for row in logged:
        for key in ("train_loss", "test_loss"):
            if not math.isfinite(row[key]):
                fail(f"non-finite {key} in {row}")
    if len(logged) != 1 or logged[0]["round"] != ROUNDS:
        fail(f"expected one eval row at round {ROUNDS}, got {logged}")
    for name, n in launches.items():
        if n < ROUNDS:
            fail(f"{name} launched {n} times in {ROUNDS} sketch rounds")
        rows[name]["launches"] = n
    pflat = session.state["params"]
    if tuple(pflat.shape) != (SLICE["d"],) or not torch.isfinite(pflat).all():
        fail("params are not finite [d]")
    # round 1 runs at lr 0 (the triangular schedule starts there); each
    # later round moves at most k coordinates
    moved = int((pflat != p0).sum())
    if not 0 < moved <= ROUNDS * session.cfg.mode.k:
        fail(f"{moved} params moved in {ROUNDS} rounds of k={session.cfg.mode.k}")
    window_ms = session.run_stats.round_ms
    print(f"main path: {ROUNDS} sketch rounds (async loop), launches {launches}, {moved} "
          f"params moved, per-round ms from drains {[round(t, 2) for t in window_ms]} "
          f"(rounds per drain {session.run_stats.window_rounds}), rtt "
          f"{session.run_stats.rtt_ms:.3f} ms, in-flight depth "
          f"{session.run_stats.max_inflight_used}", flush=True)

    # 6. checked rounds
    phase("6 (checked rounds)")
    print(check_sketch_round(session, engine, csvec), flush=True)
    uncompressed = cv_train.main(SLICE_ARGS + ["--mode", "uncompressed", "--num_rounds", "1"])
    if not torch.isfinite(uncompressed.state["params"]).all():
        fail("uncompressed round produced non-finite params")
    print(f"uncompressed: 1 round (lr 0), {uncompressed.run_stats.round_ms[0]:.2f} ms",
          flush=True)
    print(check_control_round(uncompressed, engine), flush=True)

    # 7. card vs CPU
    phase("7 (card vs CPU)")
    card_vs_cpu(session, engine, csvec, cohorts, errs)

    # 8. run loop
    phase("8 (run loop)")
    card = card_line()
    launches = run_loop_phase(cv_train, kernels, card, pairs)
    for name, n in launches.items():
        rows[name]["launches"] = n
    sync_probe(cv_train, SLICE_ARGS)
    check_kernels(csvec, session.cfg.mode.sketch_spec, session.state["params"],
                  session.state["mode_state"]["Verror"])
    print("run loop: kernels == plain on the run's params and error table", flush=True)

    # 9. profile
    phase("9 (profile)")
    f32 = {"resnet9_busy_ms": profile_rounds(session)}
    determinism_cost(session, card)

    # 10. baselines
    phase("10 (baselines)")
    sketch_state = baselines_phase(cv_train, engine, csvec, kernels, card)
    print(f"baselines: the sketched server state launched {sketch_state} in {BASE_ROUNDS} "
          "rounds (one per round)", flush=True)

    # 11. GPT-2
    phase("11 (gpt2)")
    prof = {}
    gpt2 = gpt2_phase(kernels, csvec, engine, time_ms, gen, card, prof)
    f32.update(gpt2_busy_ms=prof.get("busy_ms", 0.0), gpt2_gemm_ms=prof.get("gemm_ms", 0.0))

    # 12. client participation
    phase("12 (cohort)")
    cohort = cohort_phase(cv_train, engine, csvec, kernels, card)

    # 13. bfloat16, the double head, --init_from
    phase("13 (bf16, double head, init_from)")
    bf16 = bf16_phase(cv_train, engine, csvec, kernels, time_ms, gen, card, f32)

    # 14. serving
    phase("14 (serving)")
    serve = serve_phase(cv_train, engine, csvec, kernels, card)

    # 15. batched clients
    phase("15 (batched clients)")
    batched = batched_phase(cv_train, engine, csvec, kernels, card)

    # 16. observability
    phase("16 (observability)")
    obs_launches = obs_phase(cv_train, engine, csvec, kernels, card)
    phase("end")

    for name in rows:
        rows[name]["max_abs_err"] = max(errs[name], bf16["gpt2_mc"][name]["max_abs_err"])
        rows[name]["gpt2"] = gpt2[name]
        rows[name]["launches_cohort"] = cohort[name]
        rows[name]["gpt2_mc_bf16"] = bf16["gpt2_mc"][name]
        rows[name]["launches_bf16"] = {run: n[name] for run, n in bf16["launches"].items()}
        rows[name]["launches_serve"] = {run: n[name] for run, n in serve.items()}
        rows[name]["launches_batched"] = {run: n[name] for run, n in batched.items()}
        rows[name]["launches_obs"] = {run: n[name] for run, n in obs_launches.items()}
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
