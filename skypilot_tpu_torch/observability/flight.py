"""Engine flight recorder + compile watch: burst-level serving
introspection and the runtime retrace guard.

Two complementary pieces close the gap between the static retrace lint
(``skytpu lint`` promises the compiled-program surface is bounded) and
what actually happens on a live replica:

* :class:`FlightRecorder` — a bounded, lock-disciplined ring of
  per-burst records. Every device dispatch the serving engine makes
  (admission wave, prefill chunk, decode burst, speculative verify,
  single-step decode) appends ONE host-side record: which compiled
  program ran (span rung, bucket, draft K, KV layout), which slots and
  requests rode it, how long the host waited dispatch-to-fetch, how
  many tokens committed, and what block-management events (COW copies,
  prefix evictions, lazy grows) it caused. Recording is a dict append
  under a lock — ZERO device fetches — so when TPOT spikes in
  production the last thousands of bursts answer "which program ran
  this burst and did anything compile?" without re-running anything.

* :class:`CompileWatch` — a program registry keyed on
  ``(entry point, static args)`` wrapped around every jit entry point
  the engine dispatches. First dispatch of a new key records the
  trace+compile wall time (``skytpu_compile_seconds{program}``,
  ``skytpu_programs_compiled_total``); after the engine declares
  warmup complete, any NEW key is the silent mid-traffic XLA compile
  the whole static-shape design exists to prevent — it emits a typed
  ``engine.unexpected_compile`` event (``echo=True``) and increments
  ``skytpu_unexpected_compiles_total``, which the SLO watchdog alarms
  on (the ``unexpected-compiles`` default rule).

Copy of ``skypilot_tpu/observability/flight.py``. What counts as a
compile on the card: the port has no jit, but a program key is still
(entry point, static arguments, plus shape-derived identity such as the
admission wave's row count), and a key's first dispatch pays the
host-synchronous first-use costs of eager PyTorch on CUDA: loading the
``sm_90a`` kernel library (``ops/_build.py``; nvcc at first use when it
is not built yet), cuBLAS handle and workspace creation, and the caching
allocator's growth. The watch times that first dispatch's host wall
WITHOUT a device sync, which is what the reference measures too (a jit
compile is synchronous, its execution is not). After
:meth:`CompileWatch.declare_warm`, a new key is a shape the warm-up
never dispatched (with CUDA graphs, a new capture).

Records flush to per-process JSONL files (``flight-<proc>-<pid>-<ms>
.jsonl``) in the tracing events dir via the same atomic
tempfile+``os.replace`` idiom, so ``skytpu flight --local`` and
``skytpu trace <req>`` (burst records carry member requests' trace
ids) assemble them cross-process. Same design constraints as
``tracing.py``: stdlib + host-only on the record path, cheap when
idle, safe under concurrency, and a disabled recorder
(``SKYTPU_FLIGHT=0`` or ``recorder.enabled = False``) is a no-op
guard — the hot path pays one attribute check, exactly like
``metrics.suppress``.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.observability import _ringflush, metrics, tracing

COMPILE_SECONDS = metrics.histogram(
    "skytpu_compile_seconds",
    "First-dispatch wall time (trace + XLA compile) per engine program "
    "identity — jit compilation is synchronous at first call, so this "
    "is what a request stalled behind that dispatch experienced",
    labelnames=("program",),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0))
PROGRAMS_COMPILED = metrics.counter(
    "skytpu_programs_compiled_total",
    "Engine programs compiled (distinct (entry point, static args) "
    "keys first-dispatched through the compile watch)")
UNEXPECTED_COMPILES = metrics.counter(
    "skytpu_unexpected_compiles_total",
    "Engine programs compiled AFTER warmup was declared complete — "
    "each one is a mid-traffic XLA compile stalling live requests; "
    "the retrace-safety invariant says this stays 0")

# Ring bound: at a production burst cadence (~100 bursts/s across
# groups) 8192 records is over a minute of history, and one flush
# serializes at most this many lines.
_MAX_RECORDS = 8192

_FILE_PREFIX = "flight-"


def enabled() -> bool:
    """The flight recorder is on unless explicitly disabled
    (``SKYTPU_FLIGHT=0``)."""
    return os.environ.get("SKYTPU_FLIGHT", "1") != "0"


class FlightRecorder:
    """Bounded ring of per-burst flight records.

    One recorder per process is the normal shape (:data:`RECORDER`);
    engines take an injectable instance so tests and the bench can
    observe an isolated window. ``enabled`` is a plain attribute the
    owner may flip at runtime — a disabled recorder's :meth:`record`
    returns before touching the lock (the recorder-off no-op guard).
    """

    def __init__(self, capacity: int = _MAX_RECORDS,
                 file_prefix: str = _FILE_PREFIX):
        self.enabled = enabled()
        self.capacity = capacity
        self._ring = _ringflush.Ring(
            capacity,
            lambda: (f"{file_prefix}{tracing.process_name()}"
                     f"-{os.getpid()}-{int(time.time() * 1000)}.jsonl"),
            tracing.events_dir, seq_field="seq",
            thread_name="flight-flush")

    # -- recording (the hot path) ------------------------------------------

    def record(self, burst: str, **fields: Any) -> None:
        """Append one burst record. Host-side values ONLY — the engine
        hands in host bookkeeping (lists, ints, floats), never device
        arrays; fetching one here would stall the dispatch pipeline
        the recorder exists to observe. Honors :func:`metrics.suppress`
        (warmup work must not pollute the ring either)."""
        if not self.enabled or metrics.suppressed():
            return
        rec: Dict[str, Any] = {
            "kind": "flight", "burst": burst, "pid": os.getpid(),
            "proc": tracing.process_name(),
        }
        rec.update(fields)
        self._ring.append(rec)

    # -- introspection -----------------------------------------------------

    def seq(self) -> int:
        return self._ring.seq()

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Snapshot of the newest ``n`` records (all when None),
        oldest first."""
        recs = self._ring.snapshot()
        return recs[-n:] if n else recs

    def since(self, seq: int) -> List[Dict[str, Any]]:
        """Records appended after sequence number ``seq`` that are
        still in the ring (tests/bench window over the shared ring)."""
        return [r for r in self._ring.snapshot() if r["seq"] > seq]

    # -- flushing (the shared _ringflush atomic-replace idiom) -------------

    def flush(self) -> None:
        """Atomically rewrite this process's flight log with the whole
        ring. Serialization happens OUTSIDE the ring lock so recorder
        callers (the engine loop) never block on an O(ring) dumps."""
        self._ring.flush()

    def flush_periodic(self, min_new_records: int = 256) -> None:
        self._ring.flush_periodic(min_new_records=min_new_records)

    def ensure_flush_thread(self, interval_s: float = 5.0) -> None:
        """Start (once) a daemon thread flushing this recorder
        periodically — durability off the owner's hot loop."""
        self._ring.ensure_flush_thread(interval_s, min_new_records=256)

    def _reset_for_tests(self) -> None:
        self._ring.reset_for_tests()


RECORDER = FlightRecorder()


def ensure_flush_thread(interval_s: float = 5.0) -> None:
    """Start (once) a daemon thread flushing :data:`RECORDER`
    periodically — the model server's durability heartbeat, off the
    serving loop (same rationale as tracing.ensure_flush_thread)."""
    RECORDER.ensure_flush_thread(interval_s)


# ---------------------------------------------------------------------------
# Compile watch.

class CompileWatch:
    """Program registry over the engine's jit entry points.

    :meth:`wrap` returns a transparent wrapper that derives a program
    KEY from the call's static arguments (plus an optional ``key_fn``
    for shape-derived identity, e.g. the admission wave's row count —
    jit recompiles on new shapes even under an unchanged static key).
    A key's first dispatch is where jit traces and compiles
    SYNCHRONOUSLY, so that call's wall time is the compile cost a
    stalled request experienced; it lands in
    ``skytpu_compile_seconds{program}``. After :meth:`declare_warm`,
    a new key is a mid-traffic compile: typed
    ``engine.unexpected_compile`` event + counter.

    One watch per engine: program identity is engine-scoped (two
    engines in one process legitimately compile the same key twice).
    ``event_name`` is the typed event a post-warm compile emits — the
    serving engines keep the default ``engine.unexpected_compile``;
    the trainer's own watch emits ``train.unexpected_compile`` so the
    two alarm surfaces stay distinguishable in the event log.
    """

    def __init__(self, event_name: str = "engine.unexpected_compile"):
        self.event_name = event_name
        self._lock = threading.Lock()
        self._programs: Dict[str, float] = {}    # guarded-by: _lock
        self._unexpected: List[str] = []         # guarded-by: _lock
        self._new: List[str] = []                # guarded-by: _lock
        self._warm = False                       # guarded-by: _lock
        # Device-time calibration (attribution.DeviceTimeCalibrator,
        # attached by the engine): every Nth HIT dispatch of a key is
        # routed through the calibrator's timed bracket, maintaining
        # the per-program device-seconds EWMA. None = no calibration.
        self.calibrator = None
        # Key of the most recent dispatch through any wrapper. Loop-
        # thread discipline (the engine reads it right after the
        # dispatch it made), so a plain attribute suffices.
        self.last_key: Optional[str] = None

    def wrap(self, name: str, fn: Callable,
             static_argnames: Sequence[str] = (),
             key_fn: Optional[Callable[[tuple, dict],
                                       Sequence[Tuple[str, Any]]]]
             = None) -> Callable:
        def wrapped(*args, **kwargs):
            parts = [f"{a}={kwargs[a]}" for a in static_argnames
                     if a in kwargs]
            if key_fn is not None:
                parts.extend(f"{k}={v}" for k, v in key_fn(args, kwargs))
            key = name + (f"[{' '.join(parts)}]" if parts else "")
            self.last_key = key
            with self._lock:
                hit = key in self._programs
            if hit:
                # Sampled device-time calibration rides the HIT path
                # only: the first dispatch is the compile, whose wall
                # would poison a pure-execution EWMA.
                cal = self.calibrator
                if cal is not None and cal.tick(key):
                    return cal.timed_call(key, fn, *args, **kwargs)
                return fn(*args, **kwargs)
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            dt = time.monotonic() - t0
            with self._lock:
                if key in self._programs:    # racing first dispatches
                    return out
                self._programs[key] = dt
                self._new.append(key)
                warm = self._warm
                if warm:
                    self._unexpected.append(key)
            COMPILE_SECONDS.labels(program=key).observe(dt)
            PROGRAMS_COMPILED.inc()
            if warm:
                UNEXPECTED_COMPILES.inc()
                tracing.add_event(
                    self.event_name,
                    {"program": key, "compile_s": round(dt, 4)},
                    echo=True)
            return out
        return wrapped

    # -- warmup state ------------------------------------------------------

    def declare_warm(self) -> None:
        """The owner believes every program the live workload can
        reach is compiled; from here on a new key is an alarm."""
        with self._lock:
            self._warm = True

    @property
    def warm(self) -> bool:
        with self._lock:
            return self._warm

    # -- introspection -----------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._programs)

    @property
    def unexpected(self) -> List[str]:
        with self._lock:
            return list(self._unexpected)

    def drain_new(self) -> List[str]:
        """Keys compiled since the last drain — the engine attaches
        them to the flight record of the burst that paid for them."""
        with self._lock:
            new, self._new = self._new, []
        return new

    def summary(self) -> Dict[str, float]:
        """``{program key: first-dispatch wall seconds}``."""
        with self._lock:
            return dict(self._programs)

    def total_compile_s(self) -> float:
        with self._lock:
            return sum(self._programs.values())


# ---------------------------------------------------------------------------
# Loading + rendering (skytpu flight, /debug/flight consumers).

def load_records(dirs: Optional[List[str]] = None,
                 n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Flight records from every flushed per-process log under the
    event-log search dirs, oldest first by (ts, seq). Corrupt lines
    (crash mid-line predates the atomic flush; foreign files) are
    skipped, never fatal."""
    from skypilot_tpu_torch.observability import trace_view
    records: List[Dict[str, Any]] = []
    for d in (dirs if dirs is not None else trace_view.search_dirs()):
        for path in sorted(glob.glob(
                os.path.join(d, _FILE_PREFIX + "*.jsonl"))):
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if (isinstance(rec, dict)
                                and rec.get("kind") == "flight"):
                            records.append(rec)
            except OSError:
                continue
    records.sort(key=lambda r: (r.get("ts_s", 0.0), r.get("seq", 0)))
    return records[-n:] if n else records


def program_label(rec: Dict[str, Any]) -> str:
    """Compact program-identity string for one record, e.g.
    ``decode[k=8 span=256 paged]``."""
    prog = rec.get("program") or {}
    parts = [f"{k}={prog[k]}" for k in sorted(prog) if k != "layout"]
    layout = prog.get("layout")
    if layout:
        parts.append(str(layout))
    inner = " ".join(parts)
    return f"{rec.get('burst', '?')}[{inner}]" if inner \
        else str(rec.get("burst", "?"))


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per-program rollup over a record set: count, tokens committed,
    mean/max host dispatch-to-fetch wall, spec drafted/accepted."""
    out: Dict[str, Dict[str, Any]] = {}
    for r in records:
        agg = out.setdefault(program_label(r), {
            "count": 0, "toks": 0, "total_s": 0.0, "max_s": 0.0,
            "drafted": 0, "accepted": 0, "compiled": 0,
            "dev_s": 0.0, "dev_samples": 0, "flops": 0,
            "hbm_bytes": 0})
        dur = max(float(r.get("dur_s", 0.0)), 0.0)
        agg["count"] += 1
        agg["toks"] += int(r.get("toks", 0))
        agg["total_s"] += dur
        agg["max_s"] = max(agg["max_s"], dur)
        agg["drafted"] += int(r.get("drafted", 0))
        agg["accepted"] += int(r.get("accepted", 0))
        agg["compiled"] += len(r.get("compiled", ()))
        # Device-truth attribution (calibrated estimates + analytical
        # roofline inputs); records predating the attribution layer
        # simply contribute nothing.
        if r.get("dev_ms_est") is not None:
            agg["dev_s"] += float(r["dev_ms_est"]) / 1e3
            agg["dev_samples"] += 1
        agg["flops"] += int(r.get("flops", 0))
        agg["hbm_bytes"] += int(r.get("hbm_bytes", 0))
    for agg in out.values():
        agg["mean_ms"] = round(agg["total_s"] / agg["count"] * 1e3, 3)
        agg["max_s"] = round(agg["max_s"], 6)
        agg["total_s"] = round(agg["total_s"], 6)
        agg["dev_ms"] = (round(agg["dev_s"] / agg["dev_samples"] * 1e3,
                               3)
                         if agg["dev_samples"] else None)
        agg["dev_s"] = round(agg["dev_s"], 6)
    return out


def render_table(records: List[Dict[str, Any]],
                 programs: Optional[Dict[str, float]] = None,
                 last: int = 32) -> str:
    """Human view: the last-N bursts table plus the per-program
    summary (and, when a compile-watch summary is supplied, each
    program's first-dispatch compile cost)."""
    if not records:
        return "no flight records (recorder off, or nothing flushed yet)"
    lines: List[str] = []
    shown = records[-last:]
    t0 = shown[0].get("ts_s", 0.0)
    lines.append(f"last {len(shown)} of {len(records)} bursts:")
    fmt = "{:>9}  {:<34} {:>5} {:>5} {:>9} {:>8}  {}"
    lines.append(fmt.format("T+MS", "PROGRAM", "SLOTS", "TOKS",
                            "HOST-MS", "DEV-MS", "FLAGS"))
    for r in shown:
        flags = []
        if r.get("stall"):
            flags.append("stall")
        if r.get("drafted"):
            flags.append(f"spec {r.get('accepted', 0)}"
                         f"/{r.get('drafted', 0)}")
        # Drafter attribution (PR 14): which drafter kind fed a verify
        # burst (model|ngram|mixed — "draft" records ARE the pipelined
        # predraft dispatch), and how much host wall the round spent
        # dispatching next-round draft work inside the verify's
        # dispatch->fetch window — draft and verify render as
        # OVERLAPPING spans under --perfetto, not a serial chain.
        if r.get("drafter"):
            flags.append(f"drafter={r['drafter']}")
        if r.get("overlap_ms"):
            flags.append(f"overlap={r['overlap_ms']:.2f}ms")
        for k in ("cow", "evictions", "lazy_grows"):
            if r.get(k):
                flags.append(f"{k}={r[k]}")
        # QoS attribution (engine bursts carry tenant composition when
        # a fair scheduler is installed; "preempt" records carry the
        # victim's lane): only non-default make-ups earn a flag.
        tenants = r.get("tenants") or {}
        if tenants and (len(tenants) > 1
                        or next(iter(tenants)) != "default"):
            flags.append("tenants=" + ",".join(
                f"{t}:{n}" for t, n in sorted(tenants.items())))
        # Adapter-catalog composition: which fine-tunes shared this
        # dispatch (base-model members carry no entry).
        ads = r.get("adapters") or {}
        if ads:
            flags.append("adapters=" + ",".join(
                f"{a}:{n}" for a, n in sorted(ads.items())))
        if r.get("burst") == "preempt":
            flags.append(f"prio={r.get('priority', 0)} "
                         f"retired={r.get('retired_rows', 0)}")
        if r.get("compiled"):
            flags.append(f"COMPILED={len(r['compiled'])}")
        dev = r.get("dev_ms_est")
        lines.append(fmt.format(
            f"+{(r.get('ts_s', t0) - t0) * 1e3:.1f}",
            program_label(r)[:34],
            len(r.get("slots", ())), r.get("toks", 0),
            f"{float(r.get('dur_s', 0.0)) * 1e3:.2f}",
            f"{float(dev):.2f}" if dev is not None else "-",
            " ".join(flags)))
    lines.append("")
    lines.append("per-program summary:")
    fmt2 = "{:<40} {:>6} {:>8} {:>9} {:>8} {:>9}  {}"
    lines.append(fmt2.format("PROGRAM", "BURSTS", "TOKS", "MEAN-MS",
                             "DEV-MS", "MAX-MS", "SPEC"))
    for label, agg in sorted(summarize(records).items()):
        spec = (f"{agg['accepted']}/{agg['drafted']}"
                if agg["drafted"] else "-")
        lines.append(fmt2.format(
            label[:40], agg["count"], agg["toks"], agg["mean_ms"],
            agg["dev_ms"] if agg["dev_ms"] is not None else "-",
            round(agg["max_s"] * 1e3, 3), spec))
    if programs:
        lines.append("")
        lines.append("compiled programs (first-dispatch wall):")
        for key in sorted(programs):
            lines.append(f"  {key:<44} {programs[key] * 1e3:9.1f}ms")
    return "\n".join(lines)


def as_spans(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Flight records reshaped as span records so
    ``trace_view.to_perfetto`` renders them as duration tracks
    (``skytpu flight --perfetto``)."""
    spans = []
    for r in records:
        ts = float(r.get("ts_s", 0.0))
        attrs = {k: r[k] for k in ("toks", "drafted", "accepted",
                                   "stall", "rids", "tenants",
                                   "adapters", "priority",
                                   "retired_rows", "drafter",
                                   "overlap_ms", "dev_ms_est",
                                   "dispatch_wall_ms",
                                   "fetch_wall_ms", "flops",
                                   "hbm_bytes")
                 if r.get(k)}
        attrs["slots"] = len(r.get("slots", ()))
        spans.append({
            "kind": "span", "name": program_label(r),
            "start_s": ts, "end_s": ts + float(r.get("dur_s", 0.0)),
            "pid": r.get("pid", 0), "tid": r.get("pid", 0),
            "proc": r.get("proc", "?"), "attrs": attrs,
        })
    return spans
