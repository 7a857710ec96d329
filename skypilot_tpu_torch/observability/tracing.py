"""Dependency-free distributed tracing + structured flight-recorder log.

Copy of ``skypilot_tpu/observability/tracing.py`` (the port imports
nothing of the JAX package): the same span/event record shapes, the
same ``traceparent`` wire format and the same per-process JSONL logs
under ``<SKYPILOT_TPU_HOME>/events/``, so the reference's ``skytpu
trace`` and :mod:`trace_view` read a port replica's logs unchanged.

The per-request complement to ``metrics.py``'s aggregates: a Dapper-style
trace context (``trace_id``/``span_id``/``parent_span_id``, W3C
traceparent wire format) rides the request id the stack already mints,
crossing every process boundary of the request lifecycle:

  CLI/SDK --traceparent header--> API server --requests_db ``trace``
  column--> worker subprocess (``SKYTPU_TRACEPARENT`` env) --``trace``
  RPC param--> head-side rpc/skylet daemons.

Completed spans and typed lifecycle events land in a per-process
structured JSONL event log under ``<home>/events/`` — a bounded
in-process ring buffer flushed atomically (tempfile + ``os.replace``,
the ``utils/timeline.py`` pattern), so a reader never sees a torn file
and a crash loses at most the unflushed tail. ``skytpu trace
<request_id>`` reassembles the cross-process span tree from these logs.

Design constraints, in order (same as metrics.py):
  * stdlib only — head-side daemons run under ``python -S``;
  * cheap when idle — recording is a dict append under a lock; nothing
    touches the filesystem until a flush point;
  * safe under concurrency — handler threads, the executor thread and
    the engine loop record into one buffer; the context stack is
    thread-local.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.observability import _ringflush

ENV_VAR = "SKYTPU_TRACEPARENT"
EVENTS_DIR_ENV_VAR = "SKYTPU_EVENTS_DIR"

# version 00, lowercase hex, all-zero ids invalid (W3C trace-context).
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# Flight-recorder bound: a long-lived daemon must not grow its buffer
# (or each flush's serialization cost) forever. Oldest records drop.
_MAX_RECORDS = 20_000


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """Identity of one span within one trace (ids are lowercase hex)."""

    trace_id: str   # 32 hex chars
    span_id: str    # 16 hex chars


# Sentinel for add_event(ctx=DETACHED): record the event with NO trace
# attachment, overriding the ambient-context fallback. For daemons whose
# persisted context is missing (e.g. a pre-upgrade autostop.json): an
# unattributed event beats one misattributed to the spawn-time root.
DETACHED = SpanContext("", "")


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def format_traceparent(ctx: SpanContext) -> str:
    """W3C-style ``00-<trace_id>-<span_id>-01`` (sampled flag set)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a traceparent header; ``None`` on anything malformed (the
    caller then starts a fresh trace — a bad peer must never break
    request handling)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


# ---------------------------------------------------------------------------
# Context: thread-local span stack over a process root from the env.

_tls = threading.local()


def _stack() -> List[SpanContext]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current() -> Optional[SpanContext]:
    """The active span context: this thread's innermost open span, else
    the process root injected via ``SKYTPU_TRACEPARENT`` (how a parent
    process parents every span of a child it spawns), else None."""
    stack = _stack()
    if stack:
        return stack[-1]
    return parse_traceparent(os.environ.get(ENV_VAR))


def traceparent() -> Optional[str]:
    ctx = current()
    return format_traceparent(ctx) if ctx else None


_process_name: Optional[str] = None


def set_process_name(name: str) -> None:
    """Human label for this process in assembled trace trees (defaults
    to the argv-0 basename)."""
    global _process_name
    _process_name = name


def process_name() -> str:
    if _process_name:
        return _process_name
    base = os.path.basename(sys.argv[0] or "") or "python"
    return base[:-3] if base.endswith(".py") else base


# ---------------------------------------------------------------------------
# The event log: bounded ring buffer + atomic whole-buffer flush.
# The state machine lives in observability/_ringflush.py (shared with
# the flight and goodput recorders); this module keeps the record
# shapes and the enablement/suppression policy.


def enabled() -> bool:
    """The flight recorder is on unless explicitly disabled."""
    return os.environ.get("SKYTPU_EVENT_LOG", "1") != "0"


def events_dir() -> str:
    d = os.environ.get(EVENTS_DIR_ENV_VAR)
    if not d:
        from skypilot_tpu_torch.utils import paths
        d = os.path.join(paths.home(), "events")
    return d


def _mint_log_name() -> str:
    # pid + start-ms: unique per process incarnation, so a recycled
    # pid can never clobber a dead process's log.
    return (f"{process_name()}-{os.getpid()}"
            f"-{int(time.time() * 1000)}.jsonl")


def _gc_on_exit() -> None:
    # Self-cleaning: every recording process prunes the dir on the
    # way out (one cheap listdir against a GC-bounded dir). This is
    # what keeps the HEAD's events dir bounded too — short-lived
    # rpc processes are its main writers and nothing else up there
    # runs a GC loop.
    gc_event_logs()


_RING = _ringflush.Ring(_MAX_RECORDS, _mint_log_name, events_dir,
                        halve_on_overflow=True,
                        atexit_extra=_gc_on_exit,
                        thread_name="tracing-flush")


def _append(rec: Dict[str, Any]) -> None:
    if not enabled():
        return
    from skypilot_tpu_torch.observability import metrics
    if metrics.suppressed():
        return   # e.g. the model server's warmup generation
    _RING.append(rec)


def flush() -> None:
    """Atomically rewrite this process's event-log file with the whole
    buffer (crash-safe tempfile + ``os.replace``; see ``_ringflush``)."""
    if not enabled():
        return
    _RING.flush()


def flush_periodic(min_new_records: int = 128,
                   max_age_s: float = 60.0) -> None:
    """Throttled :func:`flush` for per-tick daemon callers: every flush
    re-serializes the whole buffer, so flush only once enough records
    accumulated or the last flush went stale."""
    _RING.flush_periodic(min_new_records=min_new_records,
                         max_age_s=max_age_s)


def ensure_flush_thread(interval_s: float = 5.0) -> None:
    """Start (once) a daemon thread that runs :func:`flush_periodic`
    every ``interval_s``. For latency-critical loops (the model
    server's serving thread): each flush re-serializes the whole ring,
    and paying tens of ms inline between decode waves is a recurring
    tail-latency spike — off-thread, the same durability costs the hot
    path nothing (the buffer lock is only held to snapshot)."""
    _RING.ensure_flush_thread(interval_s, min_new_records=256,
                              max_age_s=interval_s)


def gc_event_logs(max_files: int = 256,
                  max_age_s: float = 7 * 24 * 3600.0) -> int:
    """Prune old per-process log files (every process incarnation writes
    its own file; without GC a busy server's events dir grows forever).
    Keeps the newest ``max_files`` AND anything younger than
    ``max_age_s`` — a file is deleted only when it fails both, so a
    request burst can never GC away minutes-old logs whose requests the
    requests DB still serves. Returns the number of files removed."""
    d = events_dir()
    try:
        all_names = os.listdir(d)
    except OSError:
        return 0
    removed = 0
    entries = []
    for n in all_names:
        try:
            mtime = os.path.getmtime(os.path.join(d, n))
        except OSError:
            continue
        if n.endswith(".jsonl"):
            entries.append((mtime, n))
        elif ".jsonl." in n and mtime < time.time() - max_age_s:
            # Orphaned mkstemp temp (a SIGKILL between mkstemp and
            # os.replace skips the except-cleanup): invisible to the
            # '*.jsonl' readers, so without this it accumulates forever.
            try:
                os.remove(os.path.join(d, n))
                removed += 1
            except OSError:
                pass
    entries.sort(reverse=True)
    cutoff = time.time() - max_age_s
    for i, (mtime, n) in enumerate(entries):
        if i < max_files or mtime >= cutoff:
            continue
        try:
            os.remove(os.path.join(d, n))
            removed += 1
        except OSError:
            pass
    return removed


# ---------------------------------------------------------------------------
# Recording: spans (durations) and events (points in time).

def record_span(name: str, start_s: float, end_s: float, *,
                ctx: Optional[SpanContext] = None,
                parent_id: Optional[str] = None,
                parent: Optional[SpanContext] = None,
                attrs: Optional[Dict[str, Any]] = None,
                status: str = "ok",
                error_type: Optional[str] = None) -> SpanContext:
    """Append one completed span.

    Identity resolution, in order: an explicit ``ctx`` (a pre-minted
    identity, e.g. the request span persisted in requests_db) with an
    optional explicit ``parent_id``; else a fresh child of ``parent``;
    else a fresh child of :func:`current` (or a fresh root trace when
    no context is active). Returns the span's context so callers can
    parent further spans to it."""
    if ctx is None:
        if parent is None:
            parent = current()
        if parent is not None:
            ctx = SpanContext(parent.trace_id, new_span_id())
            if parent_id is None:
                parent_id = parent.span_id
        else:
            ctx = SpanContext(new_trace_id(), new_span_id())
    rec: Dict[str, Any] = {
        "kind": "span", "name": name,
        "trace": ctx.trace_id, "span": ctx.span_id,
        "parent": parent_id,
        "start_s": start_s, "end_s": end_s,
        "pid": os.getpid(), "tid": threading.get_ident(),
        "proc": process_name(),
    }
    if attrs:
        rec["attrs"] = attrs
    if status != "ok":
        rec["status"] = status
    if error_type:
        rec["error_type"] = error_type
    _append(rec)
    return ctx


def add_event(name: str, attrs: Optional[Dict[str, Any]] = None, *,
              ctx: Optional[SpanContext] = None,
              echo: bool = False) -> None:
    """Append one typed lifecycle event (state transition, retry,
    error, ...) attached to ``ctx`` when given, else to the active
    span/trace when one exists. Explicit ``ctx`` is for long-lived
    daemons attributing an event to a PERSISTED context (e.g. the
    skylet attaching autostop outcomes to the request that armed
    autostop) rather than their own process root; ``ctx=DETACHED``
    records with no trace attachment at all. ``echo=True`` also
    writes the record as one JSON line to stderr — the structured
    replacement for a daemon's bare ``print``."""
    if ctx is DETACHED:
        ctx = None
    elif ctx is None:
        ctx = current()
    rec: Dict[str, Any] = {
        "kind": "event", "name": name, "ts_s": time.time(),
        "pid": os.getpid(), "tid": threading.get_ident(),
        "proc": process_name(),
    }
    if ctx is not None:
        rec["trace"] = ctx.trace_id
        rec["parent"] = ctx.span_id
    if attrs:
        rec["attrs"] = attrs
    _append(rec)
    if echo:
        try:
            sys.stderr.write(json.dumps(rec, default=str) + "\n")
            sys.stderr.flush()
        except (OSError, ValueError):
            pass   # a closed stderr must not take the caller down


class start_span:
    """Context manager opening a child span of the active context (or a
    fresh root). The span is recorded on exit; an exception marks it
    ``status=error`` with the exception class and re-raises."""

    def __init__(self, name: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self._name = name
        self._attrs = attrs
        self.ctx: Optional[SpanContext] = None
        self._parent_id: Optional[str] = None
        self._t0 = 0.0

    def __enter__(self) -> "start_span":
        parent = current()
        if parent is not None:
            self.ctx = SpanContext(parent.trace_id, new_span_id())
            self._parent_id = parent.span_id
        else:
            self.ctx = SpanContext(new_trace_id(), new_span_id())
        _stack().append(self.ctx)
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = _stack()
        if stack and stack[-1] == self.ctx:
            stack.pop()
        elif self.ctx in stack:           # tolerate unbalanced exits
            stack.remove(self.ctx)
        record_span(
            self._name, self._t0, time.time(), ctx=self.ctx,
            parent_id=self._parent_id, attrs=self._attrs,
            status="error" if exc_type is not None else "ok",
            error_type=exc_type.__name__ if exc_type is not None
            else None)


# ---------------------------------------------------------------------------
# Introspection (bench --emit-trace, tests).

def span_summary() -> Dict[str, Dict[str, Any]]:
    """Aggregate the in-memory buffer's spans by name:
    ``{name: {count, total_s, mean_s, max_s}}`` — the per-request span
    summary BENCH artifacts carry under ``--emit-trace``."""
    spans = [r for r in _RING.snapshot() if r.get("kind") == "span"]
    out: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        dur = max(float(s["end_s"]) - float(s["start_s"]), 0.0)
        agg = out.setdefault(s["name"],
                             {"count": 0, "total_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += dur
        agg["max_s"] = max(agg["max_s"], dur)
    for agg in out.values():
        agg["mean_s"] = round(agg["total_s"] / agg["count"], 6)
        agg["total_s"] = round(agg["total_s"], 6)
        agg["max_s"] = round(agg["max_s"], 6)
    return out


def buffered_records() -> List[Dict[str, Any]]:
    """Snapshot of the in-memory buffer (tests)."""
    return [dict(r) for r in _RING.snapshot()]


def _reset_for_tests() -> None:
    """Drop the buffer and per-process log identity (tests only — a
    fresh tmp home must get a fresh log file, not the previous test's
    name)."""
    global _process_name
    _RING.reset_for_tests()
    _process_name = None
    _tls.stack = []
