"""The port's tracer, Chrome-trace exporter, profiler window and
Prometheus exposition (``commefficient_tpu_torch/obs/``,
``serve/metrics.py``) against the JAX package's.

Exact: the exported Chrome-trace event list for the same buffered events,
the JSONL event schema, ``parse_rounds_spec``'s errors and the Prometheus
text of two registries fed the same operations. Bitwise: a traced CLI run
(tests/test_torch_runner.py's tiny MLP on the CPU) against an untraced
one, params, server state and every logged row. The tracer and the
registry are process-wide: every test here runs on a fresh registry and
leaves both packages' tracers disarmed."""

import json
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from commefficient_tpu.obs import export as jexport
from commefficient_tpu.obs import registry as jreg
from commefficient_tpu.obs import trace as jtrace
from commefficient_tpu.obs.profiler import parse_rounds_spec as jparse_rounds
from commefficient_tpu.serve.metrics import render_prometheus as jrender
from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.obs import export as texport
from commefficient_tpu_torch.obs import registry as treg
from commefficient_tpu_torch.obs import trace as ttrace
from commefficient_tpu_torch.obs.profiler import ProfileWindow, parse_rounds_spec
from commefficient_tpu_torch.serve.metrics import MetricsServer, render_prometheus
from test_torch_runner import _argv, _assert_state_equal, _rows, tiny_cv  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    """A fresh process-wide registry in both packages for the test, and
    both tracers disarmed after it."""
    monkeypatch.setattr(treg, "_DEFAULT", treg.Registry())
    monkeypatch.setattr(jreg, "_DEFAULT", jreg.Registry())
    yield
    ttrace.configure()
    jtrace.configure()


def _emit(tracer):
    """One fixed sequence of tracer operations (spans, a deferred span,
    instants, a track outside TRACKS)."""
    with tracer.span("runner", "dispatch", round=0, rounds=1):
        tracer.instant("resilience", "fault:preempt", round=0)
    tracer.complete("device", "rounds 0..0", 1.5, 2.25, round_first=0, rounds=1)
    tracer.instant("serve-pipeline", "stage:collect", round=1)
    tracer.instant_signal_safe("resilience", "sigterm", signal="SIGTERM")
    with tracer.span("writer", "checkpoint_save"):
        pass


# ------------------------------------------------------------ the exporter


def _events(seed: int):
    """A synthetic buffered-event list and track map from a numpy seed."""
    rng = np.random.RandomState(seed)
    tracks = {t: i + 1 for i, t in enumerate(ttrace.TRACKS)}
    tracks["serve-pipeline"] = len(tracks) + 1
    names = list(tracks)
    events = []
    for i in range(int(rng.randint(1, 40))):
        track = names[rng.randint(len(names))]
        ev = {"ph": "X" if rng.rand() < 0.6 else "i", "tid": tracks[track], "cat": track,
              "name": f"ev{i}", "ts": round(float(rng.rand() * 1e6), 3),
              "args": {"round": int(rng.randint(100))}}
        if ev["ph"] == "X":
            ev["dur"] = round(float(rng.rand() * 1e4), 3)
        events.append(ev)
    return events, tracks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_events_equal_jax(seed):
    events, tracks = _events(seed)
    assert texport.chrome_trace_events(events, tracks, pid=4242) == \
        jexport.chrome_trace_events(events, tracks, pid=4242)


@pytest.mark.parametrize("dropped", [0, 5])
def test_written_chrome_trace_equals_jax(tmp_path, dropped):
    events, tracks = _events(3)
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    texport.write_chrome_trace(tp, events, tracks, dropped=dropped)
    jexport.write_chrome_trace(jp, events, tracks, dropped=dropped)
    assert json.load(open(tp)) == json.load(open(jp))


def test_tracer_buffers_the_jax_tracers_events():
    """The same operations on both tracers buffer the same events, but for
    the host-clock timestamps of the live spans and instants."""
    t, j = ttrace.Tracer(), jtrace.Tracer()
    t.configure(trace_path="unused")
    j.configure(trace_path="unused")
    _emit(t)
    _emit(j)
    strip = [[{k: v for k, v in e.items()
               if k not in ("ts", "dur") or e["name"] == "rounds 0..0"}
              for e in tr.events()] for tr in (t, j)]
    assert strip[0] == strip[1]
    assert t._tracks == j._tracks and ttrace.TRACKS == jtrace.TRACKS


# ----------------------------------------------------------------- JSONL


def test_jsonl_whole_lines_and_schema(tmp_path):
    """Every span and instant but the signal-safe one is one whole JSON
    line with the schema version and the JAX tracer's keys."""
    tp, jp = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    t, j = ttrace.Tracer(), jtrace.Tracer()
    t.configure(jsonl_path=str(tp))
    j.configure(jsonl_path=str(jp))
    _emit(t)
    _emit(j)
    t.configure()
    j.configure()
    trows = [json.loads(line) for line in tp.read_text().splitlines()]
    jrows = [json.loads(line) for line in jp.read_text().splitlines()]
    assert len(trows) == len(jrows) == 5  # the signal-safe instant skips the sink
    assert [r["schema"] for r in trows] == [ttrace.EVENT_SCHEMA_VERSION] * 5
    assert ttrace.EVENT_SCHEMA_VERSION == jtrace.EVENT_SCHEMA_VERSION
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [(r["track"], r["name"]) for r in trows] == [(r["track"], r["name"]) for r in jrows]
    assert "sigterm" not in {r["name"] for r in trows}


def test_sink_outlives_the_buffer_cap(tmp_path, capsys):
    path = tmp_path / "ev.jsonl"
    tr = ttrace.Tracer(max_events=3)
    tr.configure(trace_path=str(tmp_path / "t.json"), jsonl_path=str(path))
    for i in range(10):
        tr.instant("runner", "commit_round", round=i)
    assert tr.event_count() == 3 and tr.dropped_events == 7
    assert "trace buffer full" in capsys.readouterr().err  # loud on the first drop
    tr.flush()
    doc = json.load(open(tmp_path / "t.json"))
    assert doc["otherData"]["dropped_events"] == 7
    tr.configure()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["args"]["round"] for r in rows] == list(range(10))


def test_disarmed_tracer_is_a_noop(tmp_path):
    tr = ttrace.Tracer()
    _emit(tr)
    assert not tr.enabled and tr.event_count() == 0 and tr.flush() is None
    with tr.span("runner", "x") as s:
        assert s is None


def test_instant_signal_safe_skips_the_sink(tmp_path):
    path = tmp_path / "ev.jsonl"
    tr = ttrace.Tracer()
    tr.configure(trace_path=str(tmp_path / "t.json"), jsonl_path=str(path))
    tr.instant_signal_safe("resilience", "sigterm", signal="SIGTERM")
    tr.configure(trace_path=str(tmp_path / "t.json"))  # closes the sink
    assert path.read_text() == ""
    tr.instant_signal_safe("resilience", "sigterm", signal="SIGTERM")
    assert [e["name"] for e in tr.events()] == ["sigterm"]


# --------------------------------------------- a traced run is a plain run


ROUND_PHASES = ("round.step", "round.client", "round.server")
SKETCH_LEAVES = ("sketch.accumulate", "sketch.query", "sketch.topk")


def _inside(inner: dict, outer: dict, eps: float = 0.01) -> bool:
    """``inner``'s interval lies in ``outer``'s (the exporter rounds each
    timestamp and duration to 1 ns)."""
    return (outer["ts"] - eps <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + eps)


def _rounds_of_steps(evs: list) -> list:
    """(round, [the spans inside it]) of every ``round.step`` span, in
    order: each span of the round step (the federated track's other span,
    ``prepare_round``, runs in ``prepare``) belongs to the one ``dispatch`` span whose
    interval contains it, and the i-th ``round.step`` of a dispatch is the
    dispatch's round + i (a payload round has two: its client and merge
    steps, so they share a round through their position)."""
    disp = sorted((e for e in evs if e["cat"] == "runner" and e["name"] == "dispatch"),
                  key=lambda e: e["ts"])
    fed = sorted((e for e in evs if e["cat"] == "federated" and e["ph"] == "X"
                  and e["name"] in ROUND_PHASES + SKETCH_LEAVES), key=lambda e: e["ts"])
    owned = {id(f): [d for d in disp if _inside(f, d)] for f in fed}
    assert all(len(v) == 1 for v in owned.values())
    out = []
    for d in disp:
        kids = [f for f in fed if owned[id(f)][0] is d]
        steps = [f for f in kids if f["name"] == "round.step"]
        per = len(steps) // d["args"]["rounds"]
        assert per * d["args"]["rounds"] == len(steps) and per >= 1
        for i, step in enumerate(steps):
            inner = [f for f in kids if f is not step and _inside(f, step)]
            out.append((d["args"]["round"] + i // per, inner))
        # nothing of the dispatch runs outside its round steps
        assert all(any(_inside(f, st) for st in steps) for f in kids)
    return out


def _capture_ranges(path) -> list:
    return [e for e in json.load(open(path))["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


@pytest.mark.parametrize("loop", [["--sync_loop"], [], ["--rounds_per_dispatch", "3"]],
                         ids=["sync", "async", "blocks"])
def test_traced_cli_run_bitwise_equal_to_untraced(tiny_cv, tmp_path, loop):  # noqa: F811
    """6 sketch rounds through the CLI, traced (Chrome trace and JSONL)
    and not, and traced under a ``--profile_rounds`` capture: params,
    server state and every row (but time_s) bitwise equal. The trace holds
    the runner's phase spans, a commit_round instant per round and one
    device span per drained dispatch, which together cover every round
    once; on the federated track one round.step, round.client and
    round.server per round, each round.step inside its dispatch and
    holding the round's sketch accumulate, query and top-k. The capture
    holds a round.step range per round it covered."""
    base = _argv(("--num_rounds", "6", "--eval_every", "3", *loop), "sketch")
    la, lb, lc = (str(tmp_path / f"{x}.jsonl") for x in "abc")
    trace, events = str(tmp_path / "t.json"), str(tmp_path / "ev.jsonl")
    a = cv_train.main(base + ["--log_jsonl", la])
    b = cv_train.main(base + ["--log_jsonl", lb, "--trace", trace, "--trace_events", events])
    c = cv_train.main(base + ["--log_jsonl", lc, "--trace", str(tmp_path / "tc.json"),
                              "--profile_rounds", "1:4", "--profile_dir", str(tmp_path / "p")])
    _assert_state_equal(a, b)
    _assert_state_equal(a, c)
    assert _rows(la) == _rows(lb) == _rows(lc)
    evs = [e for e in json.load(open(trace))["traceEvents"] if e["ph"] != "M"]
    names = Counter((e["cat"], e["name"]) for e in evs)
    for phase in ("prepare", "dispatch", "drain", "commit", "eval"):
        assert names[("runner", phase)] >= 1, phase
    assert names[("runner", "commit_round")] == 6
    assert names[("runner", "dispatch")] == (2 if loop == ["--rounds_per_dispatch", "3"] else 6)
    device = sorted((e["args"]["round_first"], e["args"]["rounds"]) for e in evs
                    if e["cat"] == "device")
    assert [r for first, n in device for r in range(first, first + n)] == list(range(6))
    assert len(device) == names[("runner", "dispatch")]
    assert all(e["dur"] >= 0 for e in evs if e["cat"] == "device")
    for phase in ROUND_PHASES:
        assert names[("federated", phase)] == 6, phase
    steps = _rounds_of_steps(evs)
    assert [r for r, _ in steps] == list(range(6))
    for _, inner in steps:
        got = Counter(f["name"] for f in inner)
        assert got["round.client"] == got["round.server"] == 1
        assert all(got[leaf] >= 1 for leaf in SKETCH_LEAVES), got
    rows = [json.loads(line) for line in open(events)]
    assert len(rows) == len(evs)
    (cap,) = (tmp_path / "p").iterdir()
    first, last = map(int, cap.name.split(".")[0].split("_")[1:])
    got = Counter(e["name"] for e in _capture_ranges(cap))
    assert got["round.step"] == got["round.client"] == got["round.server"] == last - first + 1


LOCAL_TOPK = ["--mode", "local_topk", "--k", "100", "--num_workers", "3"]
TABLE_ROUND = ["--mode", "sketch", "--k", "100", "--num_cols", "2000", "--num_rows", "3",
               "--num_workers", "4", "--merge_policy", "trimmed", "--merge_trim", "1"]


@pytest.mark.parametrize("path", [LOCAL_TOPK, TABLE_ROUND], ids=["local_topk", "table_round"])
def test_traced_client_side_compression_bitwise_equal(tiny_cv, tmp_path, path):  # noqa: F811
    """The rounds that compress on the client side: local_topk (each
    client's top-k against its rows of the client state) and the
    per-client-table round (each client's own sketch, then the payload
    pair's merge step). Traced under a capture against untraced, async:
    bitwise equal; the client side's sketch ranges lie inside round.client,
    the server step's inside round.server."""
    base = _argv(path + ["--num_rounds", "4", "--eval_every", "2"])
    la, lb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    trace = str(tmp_path / "t.json")
    a = cv_train.main(base + ["--log_jsonl", la])
    b = cv_train.main(base + ["--log_jsonl", lb, "--trace", trace,
                              "--profile_rounds", "0:3", "--profile_dir", str(tmp_path / "p")])
    _assert_state_equal(a, b)
    if path is LOCAL_TOPK:
        assert torch.equal(a.client_state["error"], b.client_state["error"])
    assert _rows(la) == _rows(lb)
    evs = [e for e in json.load(open(trace))["traceEvents"] if e["ph"] != "M"]
    steps = _rounds_of_steps(evs)
    clients = [e for e in evs if e["cat"] == "federated" and e["name"] == "round.client"]
    servers = [e for e in evs if e["cat"] == "federated" and e["name"] == "round.server"]
    assert len(clients) == len(servers) == 4
    leaves = [e for e in evs if e["cat"] == "federated" and e["name"].startswith("sketch.")]
    for leaf in leaves:
        assert any(_inside(leaf, p) for p in clients + servers), leaf["name"]
    client_leaves = Counter(e["name"] for e in leaves if any(_inside(e, c) for c in clients))
    if path is LOCAL_TOPK:
        assert [r for r, _ in steps] == [0, 1, 2, 3]
        assert client_leaves["sketch.topk"] >= 3 * 4  # a top-k a client, nested in the dense one
    else:
        # the payload pair: a client step and a merge step a round
        assert [r for r, _ in steps] == [0, 0, 1, 1, 2, 2, 3, 3]
        assert client_leaves == Counter({"sketch.accumulate": 4 * 4})  # a table a client
        server = Counter(e["name"] for e in leaves if any(_inside(e, s) for s in servers))
        assert server["sketch.query"] == server["sketch.topk"] == 4
    (cap,) = (tmp_path / "p").iterdir()
    assert Counter(e["name"] for e in _capture_ranges(cap))["round.client"] == 4


def test_capture_holds_the_spans_nested_with_the_tracer_disarmed(tiny_cv, tmp_path):  # noqa: F811
    """A ``--profile_rounds`` capture on the CPU with the tracer disarmed:
    the tracer buffers nothing, but the capture holds the runner's and the
    round step's spans as ``user_annotation`` ranges on the loop's thread,
    nested as the spans nest."""
    cv_train.main(_argv(("--num_rounds", "4", "--sync_loop", "--profile_rounds", "1:2",
                         "--profile_dir", str(tmp_path / "p")), "sketch"))
    assert ttrace.get().event_count() == 0 and not ttrace.get().live
    (path,) = (tmp_path / "p").iterdir()
    ranges = _capture_ranges(path)
    by_name: dict = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["dispatch"]) == len(by_name["round.step"]) == 2
    assert {e["tid"] for e in ranges if e["name"] in ROUND_PHASES + SKETCH_LEAVES} == \
        {by_name["dispatch"][0]["tid"]}

    def parent(e, names):
        return [p for n in names for p in by_name.get(n, ())
                if p is not e and p["tid"] == e["tid"] and _inside(e, p)]

    for step in by_name["round.step"]:
        assert len(parent(step, ["dispatch"])) == 1
    for name in ("round.client", "round.server"):
        assert len(by_name[name]) == 2
        assert all(len(parent(e, ["round.step"])) == 1 for e in by_name[name])
    for name in ("sketch.query", "sketch.topk"):
        assert by_name[name] and all(parent(e, ["round.server"]) for e in by_name[name])
    assert all(parent(e, ["round.step"]) and not parent(e, ["round.client"])
               for e in by_name["sketch.accumulate"])  # the compress-once shortcut
    for name in ("drain", "commit", "prepare"):
        assert len(by_name[name]) >= 2


def test_disarmed_tracer_enters_no_record_function(tiny_cv, monkeypatch):  # noqa: F811
    """With the tracer disarmed and no capture open a span costs one
    attribute check: ``record_function`` is never entered. Armed under an
    open capture, every span enters it once."""
    import torch.profiler

    entered: list = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    argv = _argv(("--num_rounds", "2", "--sync_loop"), "sketch")
    cv_train.main(argv)
    ours = set(ROUND_PHASES + SKETCH_LEAVES + ("dispatch", "drain", "commit", "prepare"))
    assert not [n for n in entered if n in ours]
    tracer = ttrace.get()
    tracer.configure(trace_path="unused")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracer.span("runner", "dispatch"):
            with tracer.span("federated", "round.step"):
                pass
    tracer.configure()
    assert entered == ["dispatch", "round.step"]


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: ``record`` reads a device clock
    the test advances (ms)."""

    clock = [0.0]
    pending: list = []

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = None
        _FakeEvent.pending.append(self)

    def query(self):
        return self.t is not None

    def synchronize(self):
        _FakeEvent.run()

    def elapsed_time(self, other):
        return other.t - self.t

    @classmethod
    def run(cls, to_ms: float | None = None):
        """The device reaches every recorded event (at ``to_ms``)."""
        if to_ms is not None:
            cls.clock[0] = to_ms
        for ev in cls.pending:
            ev.t = cls.clock[0]
        cls.pending.clear()


def test_device_spans_run_on_the_card_clock(monkeypatch):
    """On a card the device span runs from when the card reached the
    dispatch's work to when it finished it, put on the tracer's clock at
    the drain: queue wait ahead of the dispatch is not the dispatch's."""
    from commefficient_tpu_torch.runner.loop import DeviceSpans

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.clock, _FakeEvent.pending = [0.0], []
    tracer = ttrace.Tracer()
    tracer.configure(trace_path="unused")
    spans = DeviceSpans(tracer, cuda=True, sketch_path="ravel")
    start = spans.event()
    spans.dispatched(0.0, 3, 2, start)
    _FakeEvent.pending[0].t = 40.0  # the card reaches the dispatch 40 ms in
    _FakeEvent.pending[1].t = 55.0  # and finishes it 15 ms later
    _FakeEvent.pending.clear()
    spans.drained()  # the anchor is recorded but the card has not run it
    assert tracer.events() == []
    _FakeEvent.run(to_ms=60.0)
    anchor_us = spans._anchored[0][1]
    spans.flush()
    (ev,) = tracer.events()
    assert ev["cat"] == "device" and ev["args"] == {"round_first": 3, "rounds": 2,
                                                    "sketch_path": "ravel"}
    assert ev["dur"] == pytest.approx(15e3)
    assert ev["ts"] == pytest.approx(anchor_us - 20e3, abs=1e-3)
    # disarmed: no event is recorded and no span emitted; the CPU keeps
    # the host timestamps
    tracer.configure()
    assert spans.event() is None
    cpu = DeviceSpans(ttrace.Tracer(), cuda=False, sketch_path="ravel")
    cpu.tracer.configure(trace_path="unused")
    assert cpu.event() is None
    t0 = cpu.tracer.now_us()
    cpu.dispatched(t0, 0, 1, None)
    cpu.drained()
    (ev,) = cpu.tracer.events()
    assert ev["ts"] == round(t0, 3) and ev["dur"] > 0


# ---------------------------------------------------- the profiler window


@pytest.mark.parametrize("spec", ["5", "a:b", "3:1", "-1:2", "1:", ":4", "2:x"])
def test_rounds_spec_errors_equal_jax(spec):
    with pytest.raises(ValueError) as t:
        parse_rounds_spec(spec)
    with pytest.raises(ValueError) as j:
        jparse_rounds(spec)
    assert str(t.value) == str(j.value)


def test_rounds_spec_parses_as_jax():
    for spec in ("", "  ", "2:5", "0:0"):
        assert parse_rounds_spec(spec) == jparse_rounds(spec)
    with pytest.raises(ValueError, match="profile_dir"):
        ProfileWindow(0, 1, "")


class _FakeProfile:
    """A stand-in for torch.profiler.profile recording what the window
    does with it."""

    calls: list = []

    def __init__(self, activities=()):
        self.activities = list(activities)

    def start(self):
        self.calls.append(("start", len(self.activities)))

    def stop(self):
        self.calls.append(("stop",))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))
        open(path, "w").write("{}")


@pytest.fixture()
def fake_profiler(monkeypatch):
    import torch.profiler

    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile.calls


def test_window_starts_and_stops_at_round_boundaries(tmp_path, fake_profiler):
    calls = fake_profiler
    pw = ProfileWindow.parse("1:2", str(tmp_path), cuda=True)
    pw.on_dispatch(0)
    assert calls == []  # before the window
    pw.on_dispatch(1)
    assert calls == [("start", 2)]  # CPU and CUDA activity
    pw.on_dispatch(2)
    pw.on_dispatch(3)  # the async loop may dispatch past END before the drain
    pw.on_committed(2)  # round 1 committed; round 2 (END) still open
    assert len(calls) == 1
    pw.on_committed(4)  # round 2 committed -> stop and export
    path = str(tmp_path / "rounds_1_3.pt.trace.json")
    assert calls[1:] == [("stop",), ("export", path)]
    assert pw.covered == (1, 3) and pw.path == path
    pw.on_dispatch(1)  # one-shot
    pw.close()
    assert len(calls) == 3


def test_window_takes_a_block_overlap_and_notes_a_resume_past(tmp_path, fake_profiler,
                                                              capsys):
    calls = fake_profiler
    pw = ProfileWindow.parse("5:6", str(tmp_path))
    pw.on_dispatch(0, rounds=4)  # block [0..3] ends before the window
    assert calls == []
    pw.on_dispatch(4, rounds=4)  # block [4..7] holds round 5 -> start
    assert calls == [("start", 1)]  # CPU activity only
    pw.on_committed(8)
    assert [c[0] for c in calls] == ["start", "stop", "export"]
    assert pw.covered == (4, 7)

    pw2 = ProfileWindow.parse("5:6", str(tmp_path))
    pw2.on_dispatch(8)  # a resumed run already past the window
    assert "behind the run" in capsys.readouterr().err
    pw2.on_dispatch(5)  # declared dead: stays dead
    pw2.close()
    assert len(calls) == 3 and pw2.path is None


def test_window_degrades_to_a_loud_noop(tmp_path, monkeypatch, capsys):
    import torch.profiler

    class Broken(_FakeProfile):
        def start(self):
            raise RuntimeError("profiler already running")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    pw = ProfileWindow.parse("0:1", str(tmp_path))
    pw.on_dispatch(0)  # must not raise
    assert "degrades to a no-op" in capsys.readouterr().err
    pw.on_committed(5)
    pw.close()
    assert pw.path is None and pw.covered is None


def test_unreachable_window_is_loud_at_launch(tiny_cv, tmp_path, capsys):  # noqa: F811
    cv_train.main(_argv(("--num_rounds", "2", "--profile_rounds", "5:6",
                         "--profile_dir", str(tmp_path / "p")), "sketch"))
    assert "can never fire" in capsys.readouterr().err
    assert not (tmp_path / "p").exists()


def test_cli_window_captures_the_rounds_it_covers(tiny_cv, tmp_path):  # noqa: F811
    """A real CPU capture around rounds 1:2 of a sync CLI run: one Chrome
    trace named by the rounds it covers, holding the rounds' host ops."""
    cv_train.main(_argv(("--num_rounds", "4", "--sync_loop", "--profile_rounds", "1:2",
                         "--profile_dir", str(tmp_path / "p")), "sketch"))
    (path,) = (tmp_path / "p").iterdir()
    assert path.name == "rounds_1_2.pt.trace.json"
    evs = json.load(open(path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in evs)


def test_cli_profile_dir_alone_captures_the_whole_run(tiny_cv, tmp_path):  # noqa: F811
    cv_train.main(_argv(("--num_rounds", "2", "--sync_loop", "--profile_dir",
                         str(tmp_path / "p")), "sketch"))
    (path,) = (tmp_path / "p").iterdir()
    assert path.name == "run.pt.trace.json"
    assert any(e.get("cat") == "cpu_op" for e in json.load(open(path))["traceEvents"])


def test_cli_rejects_bad_window_flags():
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    with pytest.raises(SystemExit, match="START:END"):
        resolve_defaults(make_parser().parse_args(["--profile_rounds", "3"]))
    with pytest.raises(SystemExit, match="profile_dir"):
        resolve_defaults(make_parser().parse_args(["--profile_rounds", "1:2"]))


# ------------------------------------------------ Prometheus exposition


def _feed(reg, seed: int):
    """One seeded sequence of registry operations."""
    rng = np.random.RandomState(seed)
    for i in range(int(rng.randint(3, 30))):
        kind = rng.randint(4)
        name = f"m{rng.randint(6)}_{['total', 'ms', 'x', 'rate'][kind]}"
        if kind == 0:
            reg.counter(name).inc(float(rng.randint(1, 5)))
        elif kind == 1:
            reg.histogram(name).observe(float(np.round(rng.rand() * 100, 3)))
        elif kind == 2:
            reg.gauge(name).set(float(np.round(rng.randn(), 4)))
        else:
            reg.gauge("9bad-name.x").set(float(i))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prometheus_text_equals_jax(seed):
    t, j = treg.Registry(), jreg.Registry()
    _feed(t, seed)
    _feed(j, seed)
    assert render_prometheus(t) == jrender(j)


def test_prometheus_endpoint_serves_beside_json():
    reg = treg.Registry()
    reg.counter("slo_violations_total").inc()
    srv = MetricsServer(lambda: {"round": 1}, port=0, registry=reg)
    srv.start()
    try:
        host, port = srv.address
        with urllib.request.urlopen(f"http://{host}:{port}/metrics.prom", timeout=10) as r:
            assert "text/plain" in r.headers["Content-Type"]
            assert r.read().decode() == render_prometheus(reg)
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
            assert json.loads(r.read())["round"] == 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=10)
    finally:
        srv.stop()
