"""Checkpoint and resume: the port's twin of the JAX package's
``utils/checkpoint.py``, written with ``torch.save`` in place of orbax.

A checkpoint is a directory ``round_XXXXXXXX`` holding ``state.pt`` (params,
batch-norm statistics, Vvelocity/Verror, the quarantine's median rings when
armed, and the [num_clients, d] client state of a mode that keeps one),
``meta.json`` (the round, the measured
``comm_mb_total``, the cohort size, the mode and client count, the host
sampling RNG as plain ints and lists, so ``torch.load(weights_only=True)``
never meets a numpy object, and the committed dropped-client queue,
``requeued``, with each entry's queued round, ``requeue_ages``; a served
run adds ``serve``, the serving layer's pending early submissions at the
committed round) and ``manifest.json``. A checkpoint of another
mode, client count or quarantine tree is refused
(``CheckpointMismatchError``), not set aside as damaged.

- **Split client state**: on a group of ranks whose session splits the
  client state (``session.client_block``), every rank's save gathers its
  block to rank 0, which alone writes the unpadded [num_clients, d] rows;
  a restore reads the file mapped and each rank keeps its own block,
  re-padded. The file is the one a one-device session writes and reads,
  so a checkpoint moves freely between a group and one device.

- **Atomic commit**: everything is written into a ``.tmp_round_*`` staging
  directory and ``os.rename``d to its final name. A crash mid-write leaves
  only a staging directory, which restores never consider and the next
  save sweeps.
- **Integrity manifest**: ``manifest.json`` holds a sha256 per file and is
  written last. ``save`` reads the committed files back against it (media
  that return other bytes than they acknowledged fail the save, counted in
  ``save_verify_failures``, and the write is retried). ``restore_latest``
  walks newest to oldest and falls back loudly past any checkpoint that
  fails verification or restore.
- **Off the round path**: the committed state is immutable (every round
  makes new tensors), so a save holds references to it under the session's
  ``mutate_lock`` and copies it to the host afterwards. On the GPU the copy
  runs on a stream of its own after the event recorded when that state's
  round was dispatched: it waits for that round only, not for the rounds
  queued after it, which matters for the watchdog's emergency save.
- **Retries and fault injection**: the write runs under
  ``resilience.retry`` (site "ckpt_save"); a ``FaultPlan`` can inject
  transient write failures or damage after the commit.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..resilience import retry as rtry

MANIFEST = "manifest.json"
STATE_FILE = "state.pt"
META_FILE = "meta.json"
_TMP_PREFIX = ".tmp_round_"
# a checkpoint that failed verification or restore is renamed to
# <name>.damaged: no longer a restore or prune candidate, kept for a
# post-mortem, the newest KEEP_DAMAGED of them
_DAMAGED_SUFFIX = ".damaged"
KEEP_DAMAGED = 2

# committed checkpoints that failed the read-back since process start
_VERIFY_FAILURES = 0


def save_verify_failures() -> int:
    return _VERIFY_FAILURES


class CheckpointVerifyError(RuntimeError):
    """A just-committed checkpoint failed its read-back against the sha256
    manifest. Raised inside the retry wrapper so the write is retried."""


class CheckpointMismatchError(ValueError):
    """A sound checkpoint of another mode or client count than the
    session's. ``restore_latest`` raises it rather than falling back: the
    checkpoint is not damaged, the run is misconfigured."""


def _round_dirs(ckpt_dir: str) -> list[str]:
    """Restore candidates, sorted: round_* (including .displaced copies of
    the same round) minus damaged ones."""
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("round_") and not d.endswith(_DAMAGED_SUFFIX))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_manifest(path: str) -> None:
    sums = {}
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if f == MANIFEST:
                continue
            full = os.path.join(root, f)
            sums[os.path.relpath(full, path)] = _sha256(full)
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump({"files": sums}, f)


def verify(path: str) -> bool | None:
    """True: manifest present and every file matches. False: mismatch,
    missing file or unreadable manifest. None: no manifest."""
    mf = os.path.join(path, MANIFEST)
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            sums = json.load(f)["files"]
    except (OSError, ValueError, KeyError):
        return False
    for rel, digest in sums.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full) or _sha256(full) != digest:
            return False
    return True


def _state_to_host(session, state: dict, client_state: dict | None, ready) -> dict:
    """Host copy of the server state's and the client state's tensors. On
    the GPU the copy runs on the session's copy stream after ``ready`` (the
    CUDA event recorded when the state's round was dispatched), so it waits
    for that round alone."""
    tree = {"params": state["params"], "net_state": dict(state["net_state"]),
            "mode_state": dict(state["mode_state"])}
    if "quarantine" in state:
        tree["quarantine"] = dict(state["quarantine"])

    def host(fn):
        out = {"params": fn(tree["params"]),
               "net_state": {k: fn(v) for k, v in tree["net_state"].items()},
               "mode_state": {k: fn(v) for k, v in tree["mode_state"].items()}}
        if "quarantine" in tree:
            out["quarantine"] = {k: fn(v) for k, v in tree["quarantine"].items()}
        if client_state is not None:
            out["client_state"] = {k: fn(v) for k, v in client_state.items()}
        return out

    if session.device.type != "cuda":
        return host(lambda t: t.detach().clone())
    stream = session.copy_stream()
    with torch.cuda.device(session.device), torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        # a blocking device-to-host copy synchronizes the current stream
        # (this one) only
        return host(lambda t: t.detach().to("cpu"))


def _rng_to_json(rng_state: tuple) -> list:
    name, keys, pos, has_gauss, cached = rng_state
    return [str(name), [int(k) for k in keys], int(pos), int(has_gauss), float(cached)]


def _rng_from_json(s: list) -> tuple:
    return (s[0], np.asarray(s[1], dtype=np.uint32), int(s[2]), int(s[3]), float(s[4]))


def save(ckpt_dir: str, session, keep: int = 3, fault_plan=None,
         retry_policy: rtry.RetryPolicy | None = None, verify_on_save: bool = True,
         timings: dict | None = None) -> str:
    """Write the session's committed state as ``round_<round>`` and return
    its absolute path. ``timings``, if given, receives the milliseconds of
    the host copy (``copy_ms``), of the writes up to the commit
    (``write_ms``) and of the read-back (``verify_ms``). With a split client
    state every rank of the group calls it at the same round (a collective
    gathers the rows) and every rank but 0 returns None."""
    # one consistent committed view: an emergency save on the watchdog's
    # timer thread must never mix round N's state with round N-1's counter
    with session.mutate_lock:
        rnd = session.round
        state_ref = session.state
        client_ref = session.client_state
        ready = session.committed_event
        rng_state = session.rng_snapshot
        comm_mb_total = float(session.comm_mb_total)
        num_workers = session.num_workers
        # the committed queue, like the RNG snapshot: a prefetcher may have
        # served the live one for rounds that never commit. The queued
        # rounds ride along, so a restored aged queue keeps its real ages
        requeued = [int(i) for i in session._requeue_committed]
        requeue_ages = [[int(c), int(r)] for c, r in session._requeue_ages_committed]
        # the serving layer's block (serve.AggregationService registers the
        # callable), taken at the committed round like the RNG and queue
        serve_meta = session.serve_meta() if callable(session.serve_meta) else None
    final = os.path.abspath(os.path.join(ckpt_dir, f"round_{rnd:08d}"))
    staging = os.path.abspath(os.path.join(ckpt_dir, f"{_TMP_PREFIX}{rnd:08d}"))
    t0 = time.perf_counter()
    # copied once, outside the retry closure: the state is the same on
    # every attempt
    payload = _state_to_host(session, state_ref, client_ref, ready)
    del state_ref, client_ref
    if session.client_block is not None:
        # the split client state: every rank's block goes to rank 0, which
        # writes the unpadded rows once; the other ranks are done
        from ..parallel import distributed

        payload["client_state"] = distributed.gather_rows(payload["client_state"],
                                                          session.train_set.num_clients)
        if payload["client_state"] is None:
            return None
    meta = {"round": rnd, "comm_mb_total": comm_mb_total, "num_workers": num_workers,
            "mode": session.cfg.mode.mode, "num_clients": session.train_set.num_clients,
            "host_rng": _rng_to_json(rng_state), "requeued": requeued,
            "requeue_ages": requeue_ages, "client_chunk": session.cfg.client_chunk}
    if serve_meta is not None:
        meta["serve"] = serve_meta
    times = {"copy_ms": (time.perf_counter() - t0) * 1e3, "write_ms": 0.0, "verify_ms": 0.0}

    def attempt():
        t_w = time.perf_counter()
        if fault_plan is not None:
            fault_plan.fire_transient("ckpt_fail", rnd)
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        torch.save(payload, os.path.join(staging, STATE_FILE))
        with open(os.path.join(staging, META_FILE), "w") as f:
            json.dump(meta, f)
        _write_manifest(staging)
        # overwrite (an emergency save of a round already saved): rename the
        # committed copy aside first, so no window exists in which the
        # round has no copy; the displaced name still starts with "round_"
        old = None
        if os.path.isdir(final):
            old = final + ".displaced"
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.rename(final, old)
        os.rename(staging, final)  # the atomic commit point
        t_v = time.perf_counter()
        times["write_ms"] = (t_v - t_w) * 1e3
        ok = verify(final) is True if verify_on_save else True
        times["verify_ms"] = (time.perf_counter() - t_v) * 1e3
        if not ok:
            # the read-back runs before the displaced copy is deleted: a
            # corrupt re-save must put the verified copy back, never lose it
            global _VERIFY_FAILURES
            _VERIFY_FAILURES += 1
            if old is not None:
                shutil.rmtree(final, ignore_errors=True)
                os.rename(old, final)
            raise CheckpointVerifyError(
                f"checkpoint {final} failed post-commit read-back verification "
                f"(write-path corruption); save-verify failures this process: "
                f"{_VERIFY_FAILURES}")
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        return final

    path = rtry.with_retries(attempt, site="ckpt_save", policy=retry_policy, seed=rnd)
    if fault_plan is not None:
        # post-commit damage lands after the manifest, so verification, not
        # luck, has to catch it
        fault_plan.corrupt_checkpoint(rnd, path)
    _prune(ckpt_dir, keep)
    if timings is not None:
        timings.update(times)
    return path


def latest(ckpt_dir: str) -> str | None:
    """The newest restore candidate, as an absolute path."""
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = _round_dirs(ckpt_dir)
    return os.path.abspath(os.path.join(ckpt_dir, rounds[-1])) if rounds else None


def restore(path: str, session) -> None:
    """Load the checkpoint at ``path`` into ``session`` (on the session's
    device): state, round counter, host RNG and its round-boundary
    snapshot, the measured communication total and the dropped-client
    queue with its ages (an entry without one restarts at the restored
    round). A rank of a group whose session splits the client state keeps
    only its block of the rows, re-padded. Raises
    ``CheckpointMismatchError`` for a checkpoint of another mode or client
    count."""
    if session.inflight_rounds:
        raise RuntimeError("restore() with rounds in flight: drain the pipeline first")
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    want = {"mode": session.cfg.mode.mode, "num_clients": session.train_set.num_clients}
    differ = {k: meta[k] for k in want if k in meta and meta[k] != want[k]}
    if differ:
        raise CheckpointMismatchError(
            f"checkpoint {path} was written by a session with {differ}; this session has "
            f"{want}")
    # a rank of a split client state reads only its block of the rows: the
    # file is mapped, and every tensor copied out of the mapping
    block = session.client_block
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True, mmap=block is not None)
    dev = session.device

    def put(v):
        return v.to(dev, copy=block is not None)

    state = {"params": put(payload["params"]),
             "net_state": {k: put(v) for k, v in payload["net_state"].items()},
             "mode_state": {k: put(v) for k, v in payload["mode_state"].items()},
             "round": int(meta["round"])}
    if "quarantine" in payload:
        state["quarantine"] = {k: put(v) for k, v in payload["quarantine"].items()}
    # the quarantine's rings (cohort or per leaf, window 1 or K) must match
    # this run's: resuming onto another tree would restart or misread them
    want_q = _shapes(session.state.get("quarantine"))
    if _shapes(state.get("quarantine")) != want_q:
        raise CheckpointMismatchError(
            f"checkpoint {path} holds the quarantine state "
            f"{_shapes(state.get('quarantine'))}, this session's quarantine "
            f"(--client_update_clip, --quarantine_window, --quarantine_scope) needs {want_q}")
    client_state = payload.get("client_state")
    if client_state is not None:
        client_state = {k: put(_block_of(v, block)) for k, v in client_state.items()}
    if state["params"].shape != session.state["params"].shape or \
            state["net_state"].keys() != session.state["net_state"].keys() or \
            state["mode_state"].keys() != session.state["mode_state"].keys() or \
            _shapes(client_state) != _shapes(session.client_state):
        raise ValueError(f"checkpoint {path} does not fit this session's model and mode")
    with session.mutate_lock:
        session.state = state
        session.client_state = client_state
        session.committed_event = None
        session.round = int(meta["round"])
        session.rng.set_state(_rng_from_json(meta["host_rng"]))
        session.rng_snapshot = session.rng.get_state()
        session.comm_mb_total = float(meta["comm_mb_total"])
        requeued = [int(i) for i in meta.get("requeued", [])]
        ages = {int(c): int(r) for c, r in meta.get("requeue_ages", [])}
        session._requeue = collections.deque(requeued)
        session._requeue_committed = tuple(requeued)
        session._requeue_enqueued = {cid: ages.get(cid, session.round) for cid in requeued}
        session._requeue_ages_committed = tuple(session._requeue_enqueued.items())
        # for a service that attaches to the restored session (absent = empty)
        session.restored_serve_meta = meta.get("serve")
        saved_chunk = int(meta.get("client_chunk", session.cfg.client_chunk))
        if saved_chunk != session.cfg.client_chunk:
            print(f"note: checkpoint {path} was written at client_chunk={saved_chunk}; "
                  f"resuming at it (this session asked for {session.cfg.client_chunk})",
                  flush=True)
            session.set_client_chunk(saved_chunk)
    saved_w = meta.get("num_workers")
    if saved_w is not None and saved_w != session.num_workers:
        print(f"warning: checkpoint {path} was written with num_workers={saved_w} but "
              f"this session runs {session.num_workers}; the resumed run will NOT replay "
              "the uninterrupted client sequence exactly", flush=True)


def _block_of(rows: torch.Tensor, block: tuple | None) -> torch.Tensor:
    """Rows [lo, lo + B) of the unpadded client-state rows for a group
    rank's ``block`` (lo, B), the pad rows past them zero; all of them
    without a block."""
    if block is None:
        return rows
    lo, B = block
    n = max(0, min(B, rows.shape[0] - lo))
    if n == B:
        return rows[lo:lo + B]
    return torch.cat([rows[lo:lo + n], rows.new_zeros((B - n,) + tuple(rows.shape[1:]))])


def _shapes(tree: dict | None) -> dict | None:
    return None if tree is None else {k: tuple(v.shape) for k, v in tree.items()}


def _set_aside_damaged(ckpt_dir: str, name: str) -> None:
    src = os.path.join(ckpt_dir, name)
    dst = src + _DAMAGED_SUFFIX
    try:
        if os.path.isdir(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.rename(src, dst)
    except OSError as e:
        # best effort: the fallback worked either way, the rename only
        # spares later resumes from verifying a known-bad tree again
        print(f"warning: could not set damaged checkpoint aside ({type(e).__name__}: {e})",
              file=sys.stderr, flush=True)


def _gc_damaged(ckpt_dir: str, keep: int = KEEP_DAMAGED) -> int:
    """Keep the newest ``keep`` damaged checkpoints, delete the rest, and
    return (and print) the number deleted."""
    names = sorted(d for d in os.listdir(ckpt_dir) if d.endswith(_DAMAGED_SUFFIX))
    stale = names[:-keep] if keep > 0 else names
    for name in stale:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    if stale:
        print(f"checkpoint GC: deleted {len(stale)} damaged checkpoint(s) beyond the newest "
              f"{keep} ({', '.join(stale)})", file=sys.stderr, flush=True)
    return len(stale)


def restore_latest(ckpt_dir: str, session) -> str | None:
    """Restore the newest checkpoint that verifies and restores, falling
    back loudly past damaged ones (each renamed to <name>.damaged). Returns
    the restored path, or None when the directory holds no checkpoint (a
    fresh run). Raises when checkpoints exist or existed but none can be
    restored: silently restarting a long run from round 0 is the worst
    outcome. In a group of ranks every rank restores from the shared
    directory and rank 0 alone renames or deletes in it."""
    from ..parallel import distributed

    tidy = distributed.rank() == 0
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = sorted(_round_dirs(ckpt_dir), reverse=True)
    if not rounds:
        if any(d.endswith(_DAMAGED_SUFFIX) for d in os.listdir(ckpt_dir)):
            raise RuntimeError(f"no restorable checkpoint in {ckpt_dir}: only damaged "
                               "checkpoints remain (set aside by a previous restore)")
        return None
    restored_path, skipped = None, 0
    for name in rounds:
        path = os.path.abspath(os.path.join(ckpt_dir, name))
        if verify(path) is False:
            print(f"ERROR: checkpoint {path} FAILED integrity verification (corrupt or "
                  "partial write); falling back to the previous verified-good checkpoint",
                  file=sys.stderr, flush=True)
            if tidy:
                _set_aside_damaged(ckpt_dir, name)
            skipped += 1
            continue
        try:
            restore(path, session)
        except CheckpointMismatchError:
            raise
        except Exception as e:  # noqa: BLE001 — fall back past broken trees
            print(f"ERROR: checkpoint {path} failed to restore ({type(e).__name__}: {e}); "
                  "falling back to the previous verified-good checkpoint",
                  file=sys.stderr, flush=True)
            if tidy:
                _set_aside_damaged(ckpt_dir, name)
            skipped += 1
            continue
        restored_path = path
        break
    if tidy:
        _gc_damaged(ckpt_dir)
    if restored_path is None:
        raise RuntimeError(f"no restorable checkpoint in {ckpt_dir}: all {len(rounds)} "
                           "candidates failed verification or restore")
    if skipped:
        print(f"recovered: restored {restored_path} after skipping {skipped} damaged "
              "checkpoint(s)", file=sys.stderr, flush=True)
    return restored_path


def _prune(ckpt_dir: str, keep: int) -> None:
    names = _round_dirs(ckpt_dir)  # damaged trees never count toward keep
    stale = names[:-keep] if keep > 0 else []
    # abandoned staging directories (a crash mid-write) are dead weight
    stale += [d for d in os.listdir(ckpt_dir) if d.startswith(_TMP_PREFIX)]
    for name in stale:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    _gc_damaged(ckpt_dir)
