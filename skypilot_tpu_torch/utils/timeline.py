"""Chrome trace-event tracing: ``@timeline.event`` + FileLockEvent.

Events are buffered in-process and flushed as Chrome trace-format JSON
(chrome://tracing / Perfetto loadable) to the path in
``SKYTPU_TIMELINE_FILE_PATH`` at process exit. Zero overhead when the
env var is unset.

Metrics bridge: an :class:`Event` (or ``@event`` decorator) given a
``histogram=`` — anything with ``observe(seconds)``, i.e. an
``observability.metrics`` histogram child — records its duration there
on EVERY call, traced or not. One instrumentation point yields both the
Perfetto span and the live latency histogram, under the same name, so
a spike on ``/metrics`` can be cross-examined in the trace.

Copy of ``skypilot_tpu/utils/timeline.py`` (host-only, stdlib): the
same env var, event shapes and file format. One difference: when the
capped buffer trims, it keeps only the newest thread-name event of each
thread that still owns a span. The reference keeps every name event of
such a thread, so under thread churn that reuses one ident the name
events alone outgrow the cap.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

ENV_VAR = "SKYTPU_TIMELINE_FILE_PATH"

_events: List[Dict[str, Any]] = []   # guarded-by: _lock
_lock = threading.Lock()
_flush_lock = threading.Lock()   # serializes writers of the trace file
_registered = False
_named_tids: Dict[int, str] = {}     # guarded-by: _lock
_seq = 0                             # guarded-by: _lock
_flushed_seq = 0                     # guarded-by: _lock
_last_flush_s = 0.0                  # guarded-by: _lock
# Long-lived daemons flush every tick; without a cap the buffer (and
# each flush's serialization cost) grows for the life of the process.
_MAX_EVENTS = 200_000


def enabled() -> bool:
    return bool(os.environ.get(ENV_VAR))


def _save() -> None:
    global _flushed_seq, _last_flush_s
    path = os.environ.get(ENV_VAR)
    if not path:
        return
    with _lock:
        if not _events or _seq == _flushed_seq:
            return               # nothing new since the last flush
        seq_snapshot = _seq
        payload = {"traceEvents": list(_events),
                   "displayTimeUnit": "ms"}
    # Atomic flush: daemons call save_now() periodically and crash
    # whenever — a reader (or the atexit flush racing a mid-run
    # save_now) must never see a truncated JSON. Write a sibling temp
    # file and os.replace it over the target (same-filesystem rename is
    # atomic on POSIX). _flush_lock serializes writers so an older
    # snapshot can never land on top of a newer one.
    with _flush_lock:
        with _lock:
            if seq_snapshot <= _flushed_seq:
                return           # a newer flush already landed
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=os.path.basename(path) + ".")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
            with _lock:
                _flushed_seq = seq_snapshot
                _last_flush_s = time.monotonic()
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise


def _save_atexit() -> None:
    try:
        _save()
    except OSError:
        pass   # best-effort: exit must stay quiet on unwritable paths


def _ensure_atexit() -> None:
    global _registered
    if not _registered:
        atexit.register(_save_atexit)
        _registered = True


def _append(evt: Dict[str, Any]) -> None:
    """Append a trace event, emitting this thread's name metadata the
    first time the thread shows up (Perfetto renders the track name).
    Keyed by (tid, name), not tid alone: CPython reuses idents after a
    thread exits, and a recycled ident must not inherit the dead
    thread's track name."""
    global _seq
    tid = evt["tid"]
    name = threading.current_thread().name
    with _lock:
        if _named_tids.get(tid) != name:
            _named_tids[tid] = name
            _events.append({
                "name": "thread_name", "ph": "M",
                "pid": evt["pid"], "tid": tid,
                "args": {"name": name},
            })
        _events.append(evt)
        _seq += 1
        if len(_events) > _MAX_EVENTS:
            # Drop the oldest half of the spans, and with them the
            # name metadata of threads that no longer own any kept
            # span — under thread churn an every-metadata-survives trim
            # would grow the buffer the cap exists to bound. Dropped
            # names re-emit if their thread records again.
            spans = [e for e in _events if e.get("ph") != "M"]
            del spans[:len(spans) // 2]
            kept_tids = {e["tid"] for e in spans}
            # One name event per kept thread, its newest: an ident the
            # OS reused re-emits its metadata under each new name, and
            # keeping every incarnation's would grow the buffer anyway.
            newest: Dict[int, Dict[str, Any]] = {}
            for e in _events:
                if e.get("ph") == "M" and e["tid"] in kept_tids:
                    newest[e["tid"]] = e
            _events[:] = list(newest.values()) + spans
            for t in list(_named_tids):
                if t not in kept_tids:
                    del _named_tids[t]


class Event:
    """Context manager emitting a complete ('X') trace event, and —
    when constructed with ``histogram=`` — observing the duration into
    that histogram child regardless of tracing state."""

    def __init__(self, name: str, message: Optional[str] = None,
                 histogram: Optional[Any] = None):
        self._name = name
        self._message = message
        self._histogram = histogram
        self._begin_us = 0.0

    def begin(self) -> None:
        self._begin_us = time.time() * 1e6

    @property
    def begin_s(self) -> float:
        """Wall-clock begin time in seconds (0.0 before ``begin()``).
        Lets co-instrumented systems (the tracing event log) reuse this
        span's timestamps instead of re-reading the clock."""
        return self._begin_us / 1e6

    def end(self) -> None:
        dur_us = time.time() * 1e6 - self._begin_us
        if self._histogram is not None:
            self._histogram.observe(dur_us / 1e6)
        if not enabled():
            return
        _ensure_atexit()
        evt = {
            "name": self._name,
            "ph": "X",
            "ts": self._begin_us,
            "dur": dur_us,
            "pid": os.getpid(),
            # The REAL thread ident: the old ``% 100_000`` folding could
            # merge two threads onto one Perfetto track, interleaving
            # their spans into nonsense.
            "tid": threading.get_ident(),
        }
        if self._message:
            evt["args"] = {"message": self._message}
        _append(evt)

    def __enter__(self) -> "Event":
        self.begin()
        return self

    def __exit__(self, *exc) -> None:
        self.end()


def event(fn: Optional[Callable] = None, name: Optional[str] = None,
          histogram: Optional[Any] = None):
    """Decorator tracing every call of ``fn``. With ``histogram=`` it
    also observes every call's duration (metrics are always on); with
    neither tracing enabled nor a histogram it is a no-op passthrough."""
    if fn is None:
        return functools.partial(event, name=name, histogram=histogram)

    evt_name = name or f"{fn.__module__}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not enabled() and histogram is None:
            return fn(*args, **kwargs)
        with Event(evt_name, histogram=histogram):
            return fn(*args, **kwargs)

    return wrapper


class FileLockEvent:
    """An exclusive cross-process file lock (stdlib ``fcntl.flock``)
    whose acquisition waits show up on the trace.

    flock serializes distinct open-file-descriptions, so two THREADS of
    one process exclude each other too (each acquire opens its own fd)
    — the per-cluster launch lock needs both. ``timeout`` < 0 blocks
    forever; otherwise TimeoutError after ~that many seconds.
    """

    def __init__(self, lockfile: str, timeout: float = -1):
        self._lockfile = os.path.abspath(lockfile)
        os.makedirs(os.path.dirname(self._lockfile), exist_ok=True)
        self._timeout = timeout
        self._fd = None

    def acquire(self):
        import fcntl
        with Event(f"filelock.acquire:{self._lockfile}"):
            fd = os.open(self._lockfile, os.O_RDWR | os.O_CREAT, 0o644)
            if self._timeout < 0:
                fcntl.flock(fd, fcntl.LOCK_EX)
            else:
                deadline = time.time() + self._timeout
                while True:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except OSError:
                        if time.time() >= deadline:
                            os.close(fd)
                            raise TimeoutError(
                                f"lock {self._lockfile} not acquired "
                                f"within {self._timeout}s") from None
                        time.sleep(0.05)
            self._fd = fd

    def release(self):
        if self._fd is not None:
            os.close(self._fd)  # closing drops the flock
            self._fd = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def save_now() -> None:
    """Flush buffered events immediately. Idempotent and crash-safe:
    each call atomically replaces the trace file with the full buffer
    so far (no partial writes, no truncation window)."""
    _save()


def save_periodic(min_new_events: int = 512,
                  max_age_s: float = 60.0) -> None:
    """Throttled :func:`save_now` for per-tick daemon callers. Every
    flush re-serializes the WHOLE buffer (up to ``_MAX_EVENTS`` dicts),
    so flushing on each tick turns a short poll interval into a
    JSON-dump loop as the buffer fills. Flush only once at least
    ``min_new_events`` accumulated since the last flush, or the last
    flush is older than ``max_age_s`` — crash-safety with a bounded
    staleness window instead of per-event cost."""
    with _lock:
        if not _events or _seq == _flushed_seq:
            return               # clean buffer: nothing to flush
        pending = _seq - _flushed_seq
        fresh = time.monotonic() - _last_flush_s < max_age_s
    if pending < min_new_events and fresh:
        return
    _save()
