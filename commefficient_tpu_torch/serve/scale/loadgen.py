"""A multi-process closed-loop load generator for the socket ingest (the
port's copy of the JAX package's ``serve/scale/loadgen.py``).

It measures submissions a second through real sockets from outside the
server's processes: M client processes (``spawn.start_child``; this module
is their import chain, numpy and the standard library only), each running
one selectors reactor over its share of persistent connections to the
service's address (the shared SO_REUSEPORT port of process shards, or one
listener), in stages that double from ``ramp_start`` toward
``connections``.

Each connection is closed-loop: it submits one announce-style line, waits
for the verdict, thinks, and submits again, so the offered load follows
the service rate instead of overrunning it and a stage's submissions a
second are a capacity. The think time follows a traffic model as a rate
multiplier over wall time: "flat" keeps the base think, "diurnal" sweeps a
day's sinusoid (0.1x to 1.0x) across the period, "bursty" alternates a
quiet 0.4x with bursts at 4x for ``burst_duty`` of each period.

Fan-out, counted and reported a stage:

- each client process binds its own loopback source address
  (127.0.1.<w+1>) before it connects, so each has the whole ephemeral
  port range instead of the fleet sharing one;
- each raises its RLIMIT_NOFILE soft limit toward the hard one, caps its
  share of connections at that limit less a headroom, and reports the cap:
  a stage that falls short names the descriptor ceiling it met;
- the verdicts (ACCEPTED, DUPLICATE, SHEDDING, the rejections) come back
  over each process's control connection and add up a stage, so a server
  that refuses shows as refusing, not as throughput.
"""

from __future__ import annotations

import dataclasses
import json
import math
import resource
import selectors
import socket
import struct
import subprocess
import time

from .eventloop import raise_nofile
from .spawn import start_child

_FD_HEADROOM = 128  # descriptors a client process keeps for everything else
_TARGET = "commefficient_tpu_torch.serve.scale.loadgen:_loadgen_worker"


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """One run against a serving address (module docstring)."""

    host: str = "127.0.0.1"
    port: int = 0
    connections: int = 2048    # the ramp's target (stages double toward it)
    processes: int = 4         # client processes
    stage_s: float = 5.0       # measured wall time of a stage
    model: str = "diurnal"     # flat | diurnal | bursty
    think_s: float = 0.05      # a connection's base think time
    period_s: float = 4.0      # the diurnal period, the burst cycle
    burst_duty: float = 0.25   # bursty: the share of a cycle in burst
    round_hint: int = 0        # the round named in the submissions
    client_base: int = 1 << 20  # the ids' floor (clear of real cohorts)
    ramp_start: int = 2048     # the first stage's connections
    source_ips: bool = True    # a loopback source address a process
    connect_timeout_s: float = 10.0


def _rate_mult(model: str, t: float, period_s: float, burst_duty: float) -> float:
    """The offered-rate multiplier at wall time t (think = think_s / mult)."""
    if model == "diurnal":
        return 0.55 + 0.45 * math.sin(2.0 * math.pi * t / period_s)
    if model == "bursty":
        return 4.0 if (t % period_s) < burst_duty * period_s else 0.4
    return 1.0


def fd_cap() -> int:
    """Raise RLIMIT_NOFILE's soft limit to the hard one (as far as allowed)
    and return the connections a process may hold under it."""
    hard = resource.getrlimit(resource.RLIMIT_NOFILE)[1]
    soft = raise_nofile(1 << 20 if hard == resource.RLIM_INFINITY else hard)
    return max(int(soft) - _FD_HEADROOM, 16)


class _Conn:
    __slots__ = ("sock", "out", "buf", "next_t", "cid", "state")

    def __init__(self, sock, cid: int):
        self.sock = sock
        self.out = b""
        self.buf = b""
        self.next_t = 0.0
        self.cid = cid
        self.state = "connecting"


def _loadgen_worker(cfg: dict, wid: int, share: int, ctl) -> None:
    """One client process: ``share`` closed-loop connections on a selectors
    reactor for ``stage_s`` seconds; the result goes over ``ctl``."""
    cap = fd_cap()
    n = min(share, cap)
    src_ip = f"127.0.1.{(wid % 250) + 1}" if cfg["source_ips"] else None
    addr = (cfg["host"], cfg["port"])
    sel = selectors.DefaultSelector()
    conns: list[_Conn] = []
    statuses: dict[str, int] = {}
    errors = submissions = opened = 0

    def line(cid: int) -> bytes:
        return (json.dumps({"client_id": cid, "round": int(cfg["round_hint"]),
                            "latency_s": 0.0}) + "\n").encode()

    t0 = time.monotonic()
    deadline = t0 + float(cfg["stage_s"])
    connect_deadline = t0 + float(cfg["connect_timeout_s"])
    for i in range(n):
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setblocking(False)
            # an abortive close at the stage's end: the fleet leaves no
            # TIME_WAIT behind (a closed connection would hold its port on
            # its client address for a minute, where a later bind of the
            # port on every address would fail)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            if src_ip is not None:
                try:
                    s.bind((src_ip, 0))
                except OSError:
                    pass  # no such loopback address here: the default one
            try:
                s.connect(addr)
            except BlockingIOError:
                pass
            c = _Conn(s, int(cfg["client_base"]) + wid * cap + i)
            sel.register(s, selectors.EVENT_WRITE, c)
            conns.append(c)
            opened += 1
        except OSError:
            errors += 1
            break  # descriptors or ports ran out: report how far it got
    while time.monotonic() < deadline:
        now = time.monotonic()
        for key, mask in sel.select(timeout=0.01):
            c = key.data
            try:
                if c.state == "connecting" and mask & selectors.EVENT_WRITE:
                    err = c.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                    if err:
                        raise OSError(err, "connect failed")
                    if now > connect_deadline:
                        raise OSError("connect deadline")
                    c.state, c.out = "sending", line(c.cid)
                if c.state == "sending" and mask & selectors.EVENT_WRITE:
                    c.out = c.out[c.sock.send(c.out):]
                    if not c.out:
                        c.state = "reading"
                        sel.modify(c.sock, selectors.EVENT_READ, c)
                elif c.state == "reading" and mask & selectors.EVENT_READ:
                    data = c.sock.recv(4096)
                    if not data:
                        raise OSError("server closed connection")
                    c.buf += data
                    if b"\n" in c.buf:
                        reply, _, c.buf = c.buf.partition(b"\n")
                        st = json.loads(reply).get("status", "?")
                        statuses[st] = statuses.get(st, 0) + 1
                        submissions += 1
                        # closed loop: think (as the model says), resubmit
                        mult = _rate_mult(cfg["model"], now - t0, cfg["period_s"],
                                          cfg["burst_duty"])
                        c.next_t = now + float(cfg["think_s"]) / max(mult, 1e-3)
                        c.state = "thinking"
                        sel.unregister(c.sock)
            except (OSError, ValueError):
                errors += 1
                try:
                    sel.unregister(c.sock)
                except (KeyError, ValueError):
                    pass
                try:
                    c.sock.close()
                except OSError:
                    pass
                c.state = "dead"
        for c in conns:
            if c.state == "thinking" and now >= c.next_t:
                c.state, c.out = "sending", line(c.cid)
                sel.register(c.sock, selectors.EVENT_WRITE, c)
    for c in conns:
        try:
            c.sock.close()
        except OSError:
            pass
    ctl.send({"wid": wid, "share": share, "opened": opened, "fd_cap": cap,
              "fd_capped": share > cap, "submissions": submissions, "statuses": statuses,
              "errors": errors})
    ctl.close()


def run_stage(cfg: LoadGenConfig, conns: int) -> dict:
    """One stage: ``conns`` connections over ``cfg.processes`` client
    processes for ``cfg.stage_s``. Returns the stage's record (connections
    opened, submissions a second, the verdicts, the descriptor cap)."""
    per = max(conns // cfg.processes, 1)
    shares = [per] * cfg.processes
    shares[-1] += conns - per * cfg.processes
    wire = dataclasses.asdict(cfg)
    clients = [start_child(_TARGET, (wire, wid, share)) for wid, share in enumerate(shares)]
    t0 = time.monotonic()
    results = []
    for proc, ctl in clients:
        try:
            if ctl.poll(cfg.stage_s + cfg.connect_timeout_s + 30.0):
                results.append(ctl.recv())
        except (EOFError, OSError):
            pass
        try:
            proc.wait(5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        ctl.close()
    total = sum(r["submissions"] for r in results)
    statuses: dict[str, int] = {}
    for r in results:
        for k, v in r["statuses"].items():
            statuses[k] = statuses.get(k, 0) + v
    return {
        "target_conns": conns,
        "opened_conns": sum(r["opened"] for r in results),
        "processes": len(results),
        "submissions": total,
        "submissions_per_s": total / max(cfg.stage_s, 1e-9),
        "wall_s": time.monotonic() - t0,
        "statuses": statuses,
        "errors": sum(r["errors"] for r in results),
        "fd_cap_per_proc": min((r["fd_cap"] for r in results), default=0),
        "fd_capped": any(r["fd_capped"] for r in results),
    }


def run_ramp(cfg: LoadGenConfig, log=print) -> dict:
    """The whole ramp: stages doubling from ``cfg.ramp_start`` toward
    ``cfg.connections``, stopping (and saying why) when the descriptor limit
    or connect failures cap the fleet. Returns {"stages": [...],
    "peak_submissions_per_s": ..., "max_opened_conns": ..., "ceiling": ...}."""
    target = max(int(cfg.connections), 1)
    c = min(max(int(cfg.ramp_start), 1), target)
    plan = [c]
    while c < target:
        c = min(c * 2, target)
        plan.append(c)
    stages, ceiling = [], None
    for conns in plan:
        stage = run_stage(cfg, conns)
        stages.append(stage)
        log(f"loadgen: stage {conns} conns -> opened {stage['opened_conns']}, "
            f"{stage['submissions_per_s']:.1f}/s, errors {stage['errors']}"
            + (f", fd-capped at {stage['fd_cap_per_proc']}/proc" if stage["fd_capped"] else ""))
        if stage["fd_capped"] or stage["opened_conns"] < conns * 0.9:
            soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
            ceiling = {"at_target_conns": conns, "opened_conns": stage["opened_conns"],
                       "rlimit_nofile": [int(soft), int(hard)],
                       "why": ("per-process RLIMIT_NOFILE" if stage["fd_capped"] else
                               "connect failures (port/fd exhaustion or server accept "
                               "ceiling)")}
            log(f"loadgen: ramp CEILING at {conns} target conns - {ceiling['why']} "
                f"(rlimit_nofile={soft}/{hard})")
            break
    return {"stages": stages,
            "peak_submissions_per_s": max((s["submissions_per_s"] for s in stages), default=0.0),
            "max_opened_conns": max((s["opened_conns"] for s in stages), default=0),
            "ceiling": ceiling}
