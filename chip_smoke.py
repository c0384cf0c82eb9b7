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
   a. the sync loop twice, 6 rounds each: are the final states bitwise
      equal on the card? If not, the phase sets cuDNN deterministic for
      its own runs and tries again; if still not, every comparison below
      is held at a tolerance of TOL_FACTOR times the measured sync-vs-sync
      spread (relative L2; both are printed), else bitwise;
   b. the async loop with --checkpoint_every 3 (both checkpoints must land
      and verify) and c. with --rounds_per_dispatch 3, each held against
      the sync run (params, Vvelocity, Verror, eval row);
   d. --fault_plan preempt@2 exits 75 with an emergency checkpoint at
      round 3; --resume to round 6 is held against the uninterrupted run;
   e. --fault_plan ckpt_corrupt@3: the resume falls back past the damaged
      round-3 checkpoint to round 2, sets it aside, and ends as (a);
   f. the uncompressed control, 2 rounds, async against sync;
   g. --pairs N alternating sync/async timing pairs (default 3);
   h. the round path between two drains makes no host sync: four
      dispatches run under ``torch.cuda.set_sync_debug_mode("error")``, and
      a profiler window over them and their drain counts the synchronize
      calls.
   Each kernel must have launched exactly once per sketch round of the
   phase; every time is printed beside the card's name and power limit.
9. profile: a torch.profiler window over two more rounds prints the device's
   busy time, idle share and top kernels per round.

Prints one JSON line with the kernels' numbers (launches counted over
phase 8), then as its last line
``{"ok": true, "device": {...}}``. Run from the repository root:
    python3 chip_smoke.py
``--kernels-only`` stops after phase 4 (a short first check of a new kernel);
``--cohorts N`` sets the number of cohorts phase 7 compares (default 4);
``--pairs N`` the sync/async timing pairs of phase 8 (default 3).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

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
# the same cohort's reduced gradient: the two gradients differ only by the
# card's nondeterministic convolution reductions, so the params may differ
# by a sliver of the step; a missing, scaled or mis-signed step is O(1)
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
# run-loop phase: runs of LOOP_ROUNDS rounds; when two sync runs of the same
# seed differ on the card, async runs are held at TOL_FACTOR times that
# spread (relative L2). A wrong cohort, lr or a skipped round moves the
# params by O(1) of their movement; the card's nondeterministic reductions
# move them by the spread
LOOP_ROUNDS = 6
TOL_FACTOR = 10.0
PAIRS = 3


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


def profile_rounds(session, rounds: int = 2, top: int = 12) -> None:
    """Where a steady round's time goes: a torch.profiler window over
    `rounds` more sketch rounds; prints the device's busy time and idle
    share per round and the kernels that took most device time."""
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
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print(f"profile: {rounds} rounds, wall {wall_ms:.2f} ms/round (profiled), device busy "
          f"{busy_ms:.2f} ms/round, idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / rounds
        print(f"  {ms:8.3f} ms/round  {e.count // rounds:5d}x  {e.key[:110]}", flush=True)


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
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    a, row_a = run(["--sync_loop"], "sync_a")
    b, _ = run(["--sync_loop"], "sync_b")
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
    model0 = ResNet9()
    init_weights(model0, 42)
    p0 = FlatLayout(model0).flatten(dict(model0.named_parameters())).to(a.state["params"].device)
    equal = _equal(_state(a), _state(b))
    spread = _rel(_state(a), _state(b), p0)
    print(f"run loop: two sync runs bitwise equal: {equal} (spread, relative L2 {spread:.3e})",
          flush=True)
    if not equal:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        a, row_a = run(["--sync_loop"], "sync_a_det")
        b, _ = run(["--sync_loop"], "sync_b_det")
        equal = _equal(_state(a), _state(b))
        spread = _rel(_state(a), _state(b), p0)
        print(f"run loop: with cudnn.deterministic for this phase's runs: bitwise equal "
              f"{equal} (spread {spread:.3e})", flush=True)
    tol = 0.0 if equal else TOL_FACTOR * spread
    print(f"run loop: holding async runs {'bitwise' if equal else f'at relative L2 <= {tol:.3e}'}"
          f" (cudnn.deterministic {torch.backends.cudnn.deterministic})", flush=True)

    def hold(label, s, row, ref=a, ref_row=row_a, keys=("train_loss", "train_acc",
                                                          "test_loss", "test_acc", "comm_mb")):
        """``keys`` of the eval rows must agree too (a resumed run's train
        columns sum only the rounds it ran, so it is held on the rest)."""
        got = _rel(_state(s), _state(ref), p0)
        ok = _equal(_state(s), _state(ref)) if equal else got <= tol
        loss_rel = abs(row["test_loss"] / ref_row["test_loss"] - 1)
        if equal:
            ok = ok and all(row[k] == ref_row[k] for k in keys)
        msg = (f"run loop: {label} vs sync: relative L2 {got:.3e}, eval loss rel "
               f"{loss_rel:.3e}")
        if not ok:
            fail(msg)
        print(msg + " - held", flush=True)

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

    ua, urow_a = run(["--sync_loop", "--num_rounds", "2"], "control_sync_a", "uncompressed")
    ub, _ = run(["--sync_loop", "--num_rounds", "2"], "control_sync_b", "uncompressed")
    uc, urow_c = run(["--num_rounds", "2"], "control_async", "uncompressed")
    u_equal = _equal(_state(ua), _state(ub))
    u_tol = 0.0 if u_equal else TOL_FACTOR * _rel(_state(ua), _state(ub), p0)
    got = _rel(_state(uc), _state(ua), p0)
    verdict = (f"run loop: control, two sync runs bitwise equal {u_equal}, async vs sync "
               f"relative L2 {got:.3e} (bound {u_tol:.3e})")
    if not (_equal(_state(uc), _state(ua)) if u_equal else got <= u_tol):
        fail(verdict)
    print(verdict + " - held", flush=True)

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
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    return launches


def sync_probe(cv_train, slice_args) -> None:
    """Between two drains the round path must not sync the host. Four
    prefetched dispatches run under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any synchronizing CUDA call; the drain's copy, run under
    it first, must raise (the detector works). A profiler window over the
    dispatches and their drain also counts the synchronize calls: the
    drain's and the profiler's own at its exit, no more."""
    from torch.profiler import ProfilerActivity, profile

    from commefficient_tpu_torch.runner import RoundPrefetcher
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    session, _ = cv_train.build(resolve_defaults(make_parser().parse_args(slice_args)))
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
    syncs = [e.name for e in prof.events()
             if e.name.startswith("cuda") and "Synchronize" in e.name]
    print(f"sync probe: 4 dispatches ran with no synchronizing call; the profiler window "
          f"(dispatches, drain, its own exit) holds {len(syncs)} synchronize call(s) "
          f"{syncs}", flush=True)
    if len(syncs) > 2:
        fail(f"sync probe: {len(syncs)} synchronize calls, more than the drain's and the "
             "profiler's")

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
    d, c, r = SLICE["d"], SLICE["c"], SLICE["r"]
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=42, family="rotation")
    S = spec.num_slabs
    v = torch.randn(d, generator=gen, device=dev)
    table = csvec._sketch_vec_rotation(spec, v)
    shifts, ks = csvec._rotation_keys(spec, v.device)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    hash_bytes = 4 * (r * S + r)
    work = {
        # bytes: v read once, table written once (query: the reverse)
        "sketch_accumulate": dict(
            fn=lambda: kernels.accumulate(v, shifts, ks, c), input=v,
            plain=lambda: csvec._sketch_vec_rotation(spec, v),
            bytes=4 * d + 4 * r * c + hash_bytes,
            ops=2 * r * d,  # a +-1 multiply and an add per (row, coordinate)
            replaces="commefficient_tpu/sketch/pallas_kernels.py:135"),
        "sketch_query": dict(
            fn=lambda: kernels.query(table, shifts, ks, d), input=table,
            plain=lambda: csvec._query_all_rotation(spec, table),
            bytes=4 * r * c + 4 * d + hash_bytes,
            # r multiplies and the odd-even network's min and max per coordinate
            ops=(r + 2 * sum((r - p % 2) // 2 for p in range(r))) * d,
            replaces="commefficient_tpu/sketch/pallas_kernels.py:211"),
    }
    rows = {}
    for name, w in work.items():
        ms = time_ms(w["fn"], TIMED_LAUNCHES, flush.sum)
        # warm: the input just written, and read from L2 as far as it fits
        warm_ms = time_ms(w["fn"], TIMED_LAUNCHES, lambda: w["input"].mul_(1.0))
        plain_ms = time_ms(w["plain"], 5, flush.sum)
        bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = w["ops"] / FP32_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "commefficient_tpu_torch/sketch/csrc/sketch_kernels.cu",
            "replaces": w["replaces"], "launches": 0,
            "max_abs_err": 0.0, "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        print(f"{name}: {ms:.4f} ms (L2 flushed; median of {TIMED_LAUNCHES})  "
              f"warm {warm_ms:.4f} ms  plain {plain_ms:.3f} ms  bound {rows[name]['bound_ms']:.4f} ms "
              f"({rows[name]['bound_by']}: {w['bytes'] / 1e6:.1f} MB)", flush=True)
    del flush
    if "--kernels-only" in argv:
        print("chip_smoke: kernels-only run done", flush=True)
        return 0

    # 5. main path
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
    print(check_sketch_round(session, engine, csvec), flush=True)
    uncompressed = cv_train.main(SLICE_ARGS + ["--mode", "uncompressed", "--num_rounds", "1"])
    if not torch.isfinite(uncompressed.state["params"]).all():
        fail("uncompressed round produced non-finite params")
    print(f"uncompressed: 1 round (lr 0), {uncompressed.run_stats.round_ms[0]:.2f} ms",
          flush=True)
    print(check_control_round(uncompressed, engine), flush=True)

    # 7. card vs CPU
    card_vs_cpu(session, engine, csvec, cohorts, errs)

    # 8. run loop
    card = card_line()
    launches = run_loop_phase(cv_train, kernels, card, pairs)
    for name, n in launches.items():
        rows[name]["launches"] = n
    sync_probe(cv_train, SLICE_ARGS)
    check_kernels(csvec, session.cfg.mode.sketch_spec, session.state["params"],
                  session.state["mode_state"]["Verror"])
    print("run loop: kernels == plain on the run's params and error table", flush=True)

    # 9. profile
    profile_rounds(session)

    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
