"""Shared ring-buffer + atomic-flush machinery for the recorders.

Copy of ``skypilot_tpu/observability/_ringflush.py``: the port's
tracing and flight recorders keep the reference's ring and flush.

``tracing.py`` (the structured event log) and ``flight.py`` (the
engine flight recorder) grew the same idiom independently — a bounded
in-process ring, a per-process-incarnation log name, an atexit flush,
the snapshot-under-ring-lock / serialize-outside / write-under-flush-
lock discipline (the PR 2 fix), and a daemon heartbeat thread — and
PR 10 deliberately deferred unifying them. This module is that
extraction: one :class:`Ring` owns the state machine, and the
recorders keep only their record *shapes* and public APIs. The
training goodput recorder (``goodput.py``) is the third consumer.

Invariants the Ring guarantees for every consumer:

* recording is a container append under ``_lock`` — no filesystem
  touch, no serialization;
* a flush snapshots under ``_lock``, serializes OUTSIDE it, and
  writes under ``_flush_lock`` via tempfile + ``os.replace`` so a
  reader never sees a torn file and recorder threads never block on
  an O(ring) ``json.dumps`` pass;
* a stale flush (a newer one landed while this one serialized) is
  dropped by the ``seq`` guard rather than clobbering newer data;
* the log name is minted once per process incarnation
  (``<prefix>-<pid>-<start ms>``) so a recycled pid can never clobber
  a dead process's log.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Ring:
    """Bounded record ring with atomic whole-buffer flush.

    ``capacity`` bounds the ring; ``halve_on_overflow=True`` keeps a
    plain list and drops the oldest half when full (the tracing event
    log's amortized-O(1) trim), ``False`` uses a ``deque(maxlen)``
    (the flight recorder's shape). ``name_fn`` mints the per-process
    log filename on first append; ``dir_fn`` resolves the flush
    directory at flush time (it can change under tests); ``seq_field``
    names a record key to stamp with the ring sequence number (the
    flight cursor contract); ``atexit_extra`` runs after the atexit
    flush (tracing's event-log GC).
    """

    def __init__(self, capacity: int, name_fn: Callable[[], str],
                 dir_fn: Callable[[], str], *,
                 halve_on_overflow: bool = False,
                 seq_field: Optional[str] = None,
                 atexit_extra: Optional[Callable[[], None]] = None,
                 thread_name: str = "ring-flush"):
        self.capacity = capacity
        self._name_fn = name_fn
        self._dir_fn = dir_fn
        self._halve = halve_on_overflow
        self._seq_field = seq_field
        self._atexit_extra = atexit_extra
        self._thread_name = thread_name
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()  # serializes log-file writers
        if halve_on_overflow:
            self._records: Any = []                    # guarded-by: _lock
        else:
            self._records = collections.deque(
                maxlen=capacity)                       # guarded-by: _lock
        self._seq = 0                                  # guarded-by: _lock
        self._flushed_seq = 0                          # guarded-by: _lock
        self._last_flush_s = 0.0                       # guarded-by: _lock
        self._registered = False                       # guarded-by: _lock
        # Stable per process incarnation.              # guarded-by: _lock
        self._log_name: Optional[str] = None
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock

    # -- recording (the hot path) ------------------------------------------

    def append(self, rec: Dict[str, Any]) -> None:
        """Append one record: atexit registration + log-name minting on
        first use, seq stamping when configured, overflow trim. The
        caller owns enablement/suppression checks — the Ring never
        reads the environment on the record path."""
        with self._lock:
            if not self._registered:
                atexit.register(self._flush_atexit)
                self._registered = True
            if self._log_name is None:
                self._log_name = self._name_fn()
            self._seq += 1
            if self._seq_field is not None:
                rec[self._seq_field] = self._seq
            self._records.append(rec)
            if self._halve and len(self._records) > self.capacity:
                del self._records[:self.capacity // 2]

    # -- introspection -----------------------------------------------------

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    @property
    def log_name(self) -> Optional[str]:
        with self._lock:
            return self._log_name

    # -- flushing ----------------------------------------------------------

    def flush(self) -> None:
        """Atomically rewrite this process's log file with the whole
        ring. Crash-safe and torn-read-safe: sibling temp file, then
        ``os.replace``; serialization runs outside the ring lock."""
        with self._lock:
            if not self._records or self._seq == self._flushed_seq:
                return
            seq_snapshot = self._seq
            # Snapshot only — serialization happens OUTSIDE the lock
            # so recorder threads never block on an O(ring) dumps.
            snapshot = list(self._records)
            name = self._log_name
        lines = [json.dumps(r, default=str) for r in snapshot]
        with self._flush_lock:
            with self._lock:
                if seq_snapshot <= self._flushed_seq:
                    return       # a newer flush already landed
            d = self._dir_fn()
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=name + ".")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write("\n".join(lines) + "\n")
                os.replace(tmp, os.path.join(d, name))
                with self._lock:
                    self._flushed_seq = seq_snapshot
                    self._last_flush_s = time.monotonic()
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise

    def flush_periodic(self, min_new_records: int = 256,
                       max_age_s: Optional[float] = None) -> None:
        """Throttled :meth:`flush` for per-tick callers: every flush
        re-serializes the whole buffer, so flush only once enough
        records accumulated — or, when ``max_age_s`` is given, when
        the last flush went stale with anything pending."""
        with self._lock:
            if not self._records or self._seq == self._flushed_seq:
                return
            pending = self._seq - self._flushed_seq
            fresh = (max_age_s is None
                     or time.monotonic() - self._last_flush_s < max_age_s)
        if pending < min_new_records and fresh:
            return
        self.flush()

    def _flush_atexit(self) -> None:
        try:
            self.flush()
            if self._atexit_extra is not None:
                self._atexit_extra()
        except OSError:
            pass   # best-effort: exit must stay quiet on unwritable paths

    # -- the durability heartbeat ------------------------------------------

    def ensure_flush_thread(self, interval_s: float = 5.0,
                            min_new_records: int = 256,
                            max_age_s: Optional[float] = None) -> None:
        """Start (once) a daemon thread running :meth:`flush_periodic`
        every ``interval_s`` — durability for latency-critical loops
        without paying a whole-ring serialization inline."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            t = threading.Thread(
                target=self._flush_loop,
                args=(interval_s, min_new_records, max_age_s),
                name=self._thread_name, daemon=True)
            self._thread = t
        t.start()

    def _flush_loop(self, interval_s: float, min_new_records: int,
                    max_age_s: Optional[float]) -> None:
        while True:
            time.sleep(interval_s)
            try:
                self.flush_periodic(min_new_records=min_new_records,
                                    max_age_s=max_age_s)
            except OSError:
                pass   # unwritable events dir: keep trying quietly

    # -- tests -------------------------------------------------------------

    def reset_for_tests(self) -> None:
        """Drop the buffer and per-process log identity (tests only —
        a fresh tmp home must get a fresh log file)."""
        with self._lock:
            self._records.clear()
            self._seq = 0
            self._flushed_seq = 0
            self._log_name = None
