"""One run of one cell: set-up, the three checked rounds, the timed window,
the traced stretch, and the check against the plain reference.

The system under test is the port's user path: ``FederatedSession`` built
as its entry points build it, driven by ``runner.loop.run_loop`` in its
default async form (dispatching ahead, eval and checkpoints off). The
harness hands it a data set and initial weights made from the seed
(``inputs.py``), and reads back only its committed state, its round
metrics, its ``RunStats`` and its tracer spans.

Everything that belongs to a configuration, a cell or a metric is a file
found by name: ``<bench>/configs/*.json`` (named in BENCHMARK.json),
``<bench>/workloads/<cell>.json`` and ``<bench>/metrics/<metric>.py``
(``read(ctx)``, the end-to-end metrics' as the per-layer ones').
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import types

import torch

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.personachat import FedTextDataset
from commefficient_tpu_torch.federated.api import FederatedSession, FedOptimizer
from commefficient_tpu_torch.models.convert import FlatLayout
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from commefficient_tpu_torch.models.losses import make_classification_loss, make_lm_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.obs import trace as obtrace
from commefficient_tpu_torch.runner import RunnerConfig, run_loop
from commefficient_tpu_torch.runner.prefetch import RoundPrefetcher
from commefficient_tpu_torch.sketch import csvec
from commefficient_tpu_torch.utils.config import (make_parser, mode_config_from_args,
                                                  resolve_defaults)
from commefficient_tpu_torch.utils.device import make_reproducible, resolve_device

from . import check, counts, devtrace, inputs
from .reference import layout as rlayout
from .reference.sketch import Sketch

NEVER = 10 ** 9  # an eval cadence the run never reaches
SKETCH_RANGES = ("perfbench.sketch_vec", "perfbench.query_all")
MARKER = "perfbench.t0"


# -- the benchmark's files ------------------------------------------------------

@dataclasses.dataclass
class Cell:
    root: str  # the directory holding BENCHMARK.json
    bench: dict  # BENCHMARK.json
    entry: dict  # the cell's entry in "workloads"
    model_cfg: dict  # its configuration file
    workload: dict  # perfbench/workloads/<cell>.json

    @property
    def bench_dir(self) -> str:
        return os.path.join(self.root, self.bench["paths"][0])


def load_cell(root: str, name: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, config["file"])) as f:
        model_cfg = json.load(f)
    with open(os.path.join(root, bench["paths"][0], "workloads", f"{name}.json")) as f:
        workload = json.load(f)
    if workload.get("traffic") != entry["traffic"]:
        raise SystemExit(f"{name}: the workload file's traffic {workload.get('traffic')!r} is "
                         f"not BENCHMARK.json's {entry['traffic']!r}")
    return Cell(root, bench, entry, model_cfg, workload)


def load_metric(cell: Cell, name: str):
    """The reader of a metric: ``read(ctx)`` of ``<bench>/metrics/<name>.py``,
    which returns None where it finds nothing to read."""
    path = os.path.join(cell.bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- building the system under test --------------------------------------------

def _flags(cell: Cell, session_seed: int) -> list[str]:
    f, w = cell.model_cfg["fetchsgd"], cell.workload
    return ["--mode", w["mode"], "--hash_family", f["hash_family"],
            "--num_rows", str(f["num_rows"]), "--num_cols", str(f["num_cols"]),
            "--num_blocks", str(f["num_blocks"]), "--k", str(f["k"]),
            "--momentum", str(f["momentum"]), "--weight_decay", str(f["weight_decay"]),
            "--num_workers", str(w["clients_per_round"]),
            "--local_batch_size", str(w["rows_per_client"]),
            "--client_chunk", str(w["client_chunk"]), "--seed", str(session_seed),
            "--dtype", cell.model_cfg["dtype"]]


def _model(model_cfg: dict, dtype: str):
    """The port's model on the meta device (every forward gets its
    parameters from the session) and its training loss."""
    with torch.device("meta"):
        if model_cfg["model"] == "resnet9":
            model = ResNet9(num_classes=model_cfg["num_classes"],
                            logit_scale=model_cfg["logit_scale"], dtype=dtype)
            return model, make_classification_loss(model, True), \
                make_classification_loss(model, False)
        drops = {model_cfg[k] for k in ("resid_pdrop", "embd_pdrop", "attn_pdrop")}
        if len(drops) != 1:
            raise ValueError("the port's GPT-2 takes one dropout rate for all three sites")
        cfg = GPT2Config(vocab_size=model_cfg["vocab_size"], n_positions=model_cfg["n_positions"],
                         n_embd=model_cfg["n_embd"], n_layer=model_cfg["n_layer"],
                         n_head=model_cfg["n_head"], dropout=drops.pop(), dtype=dtype,
                         ln_eps=model_cfg["layer_norm_epsilon"])
        model = GPT2LMHead(cfg)
        return model, make_lm_loss(model, True), make_lm_loss(model, False)


def _dataset(model_cfg: dict, data: dict):
    from .reference.fetchsgd import shards

    if model_cfg["data"]["kind"] == "images":
        return FedDataset(data["x"], data["y"], shards(model_cfg, data))
    return FedTextDataset(data["input_ids"], data["token_type_ids"], data["labels"],
                          shards(model_cfg, data))


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    session_seed: int
    device: torch.device
    data: dict
    session: FederatedSession
    opt: FedOptimizer
    W: int
    rows: int


def session_seed(seed: int) -> int:
    """The seed the session takes (its host sampling stream is a numpy
    RandomState, which takes 32 bits)."""
    return seed % (1 << 32)


def build(cell: Cell, seed: int, device: str = "cuda") -> Run:
    """The data, the weights and the session of one run, from the seed."""
    if torch.device(device).type == "cuda":
        make_reproducible()  # before any CUDA work, as the entry points do
    dev = resolve_device(device)
    sseed = session_seed(seed)
    args = resolve_defaults(make_parser().parse_args(_flags(cell, sseed)))
    data = inputs.make_data(cell.model_cfg, seed, dev)
    flat = inputs.make_weights(cell.model_cfg, seed, dev)
    model, train_loss, eval_loss = _model(cell.model_cfg, args.dtype)
    layout = FlatLayout(model)
    ref = rlayout.leaves(cell.model_cfg)
    if [(leaf.name, leaf.offset, leaf.size) for leaf in layout.leaves] != \
            [(leaf.name, leaf.offset, leaf.size) for leaf in ref]:
        raise RuntimeError("the port's flat layout is not the reference's")
    net_state = {k: (torch.ones if k.endswith("running_var") else torch.zeros)(
        b.shape, device=dev) for k, b in model.named_buffers()}
    train_set = _dataset(cell.model_cfg, data)
    session = FederatedSession(
        train_loss_fn=train_loss, eval_loss_fn=eval_loss,
        params=layout.unflatten(flat), net_state=net_state, layout=layout,
        mode_cfg=mode_config_from_args(args, layout.d), train_set=train_set,
        num_workers=args.num_workers, local_batch_size=args.local_batch_size,
        weight_decay=args.weight_decay, seed=sseed, on_nonfinite=args.on_nonfinite,
        device=dev, client_chunk=args.client_chunk)
    del flat
    lr = cell.model_cfg["fetchsgd"]["lr"]
    opt = FedOptimizer(lambda epoch: lr, 1)
    return Run(cell, seed, sseed, dev, data, session, opt, session.num_workers,
               args.local_batch_size)


# -- driving the loop ---------------------------------------------------------

class Source:
    """The run loop's round source: the port's prefetcher, plus the
    harness's hooks. After each dispatch it records when the round ends on
    the device (a CUDA event; the host clock on the CPU, where a dispatch
    runs to its end), and once ``seconds`` have passed since ``t0`` it ends
    the loop after the round just dispatched."""

    def __init__(self, run: Run, cfg: RunnerConfig, seconds: float | None = None,
                 on_committed=None):
        self.run, self.cfg, self.seconds = run, cfg, seconds
        self.pf = RoundPrefetcher(run.session, run.session.round, depth=2)
        self.done_marks: list = []
        self.t0 = time.perf_counter()
        self._committed = on_committed

    def next(self):
        return self.pf.next()

    def stop(self):
        self.pf.stop()

    def on_dispatched(self, rnd: int):
        if self.run.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.done_marks.append(ev)
        else:
            self.done_marks.append(time.perf_counter())
        if self.seconds is not None and time.perf_counter() - self.t0 >= self.seconds:
            self.cfg.total_rounds = min(self.cfg.total_rounds, rnd + 1)

    def on_committed(self, rnd: int):
        if self._committed is not None:
            self._committed(rnd, self.cfg)

    def round_ms(self) -> list[float]:
        """Milliseconds from each round's end on the device to the next's."""
        m = self.done_marks
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _loop(run: Run, total_rounds: int, eval_every: int = NEVER, seconds=None,
          on_committed=None, rows: list | None = None):
    cfg = RunnerConfig(total_rounds=total_rounds, eval_every=eval_every)
    src = Source(run, cfg, seconds, on_committed)

    def build_row(**kw):
        return kw["m"]

    stats = run_loop(run.session, run.opt, cfg, source=src,
                     build_row=build_row if rows is not None else None,
                     logger=types.SimpleNamespace(append=rows.append) if rows is not None
                     else None)
    return stats, src


def checked_rounds(run: Run) -> dict:
    """The cell's first rounds, through the window's own call and feed,
    each drained: the round losses and host copies of the committed state
    after the first round and the parameters after the last."""
    n = run.cell.workload["checked_rounds"]
    snaps, rows = {}, []

    def on_committed(rnd: int, cfg: RunnerConfig):
        st = run.session.state
        if rnd == 1:
            snaps["p1"] = st["params"].cpu()
            snaps["mode_state1"] = {k: v.cpu() for k, v in st["mode_state"].items()}
        if rnd == n:
            snaps["p_last"] = st["params"].cpu()

    _loop(run, run.session.round + n, eval_every=1, on_committed=on_committed, rows=rows)
    snaps["losses"] = [m["loss_sum"] / m["count"] for m in rows]
    return snaps


def window(run: Run, seconds: float) -> dict:
    """The timed window: whole rounds until ``seconds`` have passed, then
    the drain of every round in flight."""
    t0 = time.perf_counter()
    stats, src = _loop(run, NEVER, seconds=seconds)
    wall = time.perf_counter() - t0
    # a window of one round has no round-to-round time: its own stands in
    round_ms = src.round_ms() or [wall * 1e3 / max(stats.rounds, 1)]
    return {"seconds": wall, "rounds": stats.rounds, "stats": stats,
            "round_ms": round_ms, "nonfinite": stats.nonfinite_rounds}


@contextlib.contextmanager
def _sketch_ranges():
    """``record_function`` ranges around the port's sketch entry points,
    for the traced stretch only."""
    saved = (csvec.sketch_vec, csvec.query_all)

    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    csvec.sketch_vec, csvec.query_all = (ranged(n, f) for n, f in zip(SKETCH_RANGES, saved))
    try:
        yield
    finally:
        csvec.sketch_vec, csvec.query_all = saved


def traced_stretch(run: Run, path: str) -> dict:
    """At least ``trace_rounds`` more rounds under ``torch.profiler`` (host
    and device activity) with the port's tracer armed: the capture opens at
    the stretch's first drain and closes at the first drain ``trace_rounds``
    rounds later, which ends the stretch, so it holds whole rounds. Returns
    the trace's summary, the rounds it covers and the runner spans."""
    from torch.profiler import ProfilerActivity, profile

    n = run.cell.workload["trace_rounds"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda"
                                     else [])
    prof = profile(activities=acts)
    marks: dict = {}
    tracer = obtrace.get()

    def on_committed(rnd: int, cfg: RunnerConfig):
        if "open" not in marks:
            prof.start()
            with torch.profiler.record_function(MARKER):
                marks["open"] = (rnd, tracer.now_us())
        elif rnd >= marks["open"][0] + n:
            marks["close"] = (rnd, tracer.now_us())
            prof.stop()
            cfg.total_rounds = rnd  # every dispatched round is committed here

    obtrace.configure(trace_path=path + ".spans")  # in memory; never flushed
    try:
        with _sketch_ranges():
            _loop(run, NEVER, on_committed=on_committed)
        spans = [e for e in tracer.events() if e.get("cat") == "runner" and e.get("ph") == "X"]
    finally:
        obtrace.configure()
    prof.export_chrome_trace(path)
    try:
        t_mark = devtrace.marker_ts(path, MARKER)
        (r0, host0), (r1, host1) = marks["open"], marks["close"]
        summary = devtrace.read(path, SKETCH_RANGES, t_mark, t_mark + (host1 - host0))
    finally:
        os.remove(path)
    return {"summary": summary, "rounds": r1 - r0, "spans": spans,
            "offset_us": t_mark - host0}


def _breakdown(traced: dict) -> dict:
    s = traced["summary"]
    ops = sorted(s.device_ops.items(), key=lambda kv: -kv[1])[:10]
    spans = traced["spans"]

    def label(t_trace: float) -> str:
        t = t_trace - traced["offset_us"]
        inside = [e for e in spans if e["ts"] <= t < e["ts"] + e["dur"]]
        return min(inside, key=lambda e: e["dur"])["name"] if inside else "none"

    gaps = sorted(s.gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[name, us / 1e6] for name, us in ops],
            "idle_gaps": [[label(t), us / 1e6] for t, us in gaps]}


# -- the run -------------------------------------------------------------------

def program_side(run: Run, snaps: dict, p0: torch.Tensor) -> dict:
    """The program's readings, worked out from its committed state: the
    round losses, the first update as the server took it, and the
    parameters after the checked rounds. In sketch mode the server took the
    update's sketch S and after one round holds V = S - sketch(q) and
    moved the parameters by the top-k step; with q the step over lr, S is
    V plus the step's sketch over lr."""
    f = run.cell.model_cfg["fetchsgd"]
    ms = snaps["mode_state1"]
    out = {"losses": snaps["losses"], "p_last": snaps["p_last"]}
    if run.cell.workload["mode"] == "sketch":
        sk = Sketch(p0.numel(), f["num_cols"], f["num_rows"], run.session_seed)
        step = p0.to(torch.float64) - snaps["p1"].to(p0.device, torch.float64)
        out["g1_table"] = (ms["Vvelocity"].to(p0.device, torch.float64)
                           + sk.sketch(step) / f["lr"]).cpu()
    else:
        out["g1"] = ms["Vvelocity"].to(torch.float64)
    return out


def free_program(run: Run) -> None:
    run.session = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_side(run: Run) -> dict:
    """The reference's readings from the same seed, on the run's device."""
    from .reference.fetchsgd import follow

    cell = run.cell
    p0 = inputs.make_weights(cell.model_cfg, run.seed, run.device)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)  # float64 scatters, any order
    try:
        ref = follow(cell.model_cfg, cell.model_cfg["fetchsgd"], cell.workload["mode"], run.W,
                     run.session_seed, p0, run.data, cell.workload["checked_rounds"])
    finally:
        torch.use_deterministic_algorithms(det)
    ref["p0"] = p0
    return ref


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None) -> dict:
    """One run; returns the result line's fields and the checks."""
    t_start = t_process if t_process is not None else time.perf_counter()
    cell = load_cell(root, name)
    marks = [("imports", time.perf_counter())]
    run = build(cell, seed, device)
    marks.append(("data, weights, session", time.perf_counter()))
    snaps = checked_rounds(run)
    marks.append(("checked rounds", time.perf_counter()))
    _loop(run, run.session.round + cell.workload["warmup_rounds"])
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up rounds", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("setup: " + ", ".join(f"{n} {t - t0:.2f} s" for (n, t), (_, t0) in
                                zip(marks, [("start", t_start)] + marks)),
          file=sys.stderr, flush=True)
    win = window(run, seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    traced = None
    if trace:
        os.makedirs(os.path.join(root, "build", "perfbench"), exist_ok=True)
        traced = traced_stretch(run, os.path.join(root, "build", "perfbench", "trace.json"))
    free_program(run)
    ref = reference_side(run)
    prog = program_side(run, snaps, ref["p0"])
    checks = check.compare(cell, prog, ref)

    ctx = types.SimpleNamespace(
        cell=cell, W=run.W, rows=run.rows, window=win, traced=traced, peak_bytes=peak,
        setup_s=setup_s, round_flops=counts.round_flops(cell.model_cfg, run.W, run.rows),
        sketch_dims=((ref["p0"].numel(), cell.model_cfg["fetchsgd"]["num_rows"],
                      cell.model_cfg["fetchsgd"]["num_cols"])
                     if cell.workload["mode"] == "sketch" else None))
    # --trace 0 reports the cell's end-to-end metrics, --trace 1 its
    # per-layer ones; each is read by its file under <bench>/metrics
    metrics = {}
    for m in cell.bench["per_layer" if trace else "end_to_end"]:
        if name in m.get("workloads", [name]):
            value = load_metric(cell, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": run.W * win["rounds"], "failed": run.W * win["nonfinite"],
           "metrics": metrics, "peak_bytes": peak, "checks": checks,
           "window_rounds": win["rounds"], "window_s": win["seconds"],
           "round_ms": win["round_ms"]}
    if traced is not None:
        s = traced["summary"]
        out["busy_s"], out["traced_window_s"] = s.busy_us / 1e6, s.window_us / 1e6
        out["traced_rounds"] = traced["rounds"]
        out["breakdown"] = _breakdown(traced)
    return out


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: the port's own package passes)."""
    banned = {"jax", "jaxlib", "flax", "commefficient_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)


