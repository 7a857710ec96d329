"""Request forensics: the layer that turns raw telemetry into answers.

Copy of ``skypilot_tpu/observability/forensics.py``: the port's
retirement records and ledgers are the reference's, so ``skytpu why``
reads a port replica's ``/debug/forensics`` unchanged.

Five PRs of instrumentation — spans, flight records, typed events,
device-truth attribution — record everything that happens on a serving
replica, but none of them answer the operator's actual question: *why
was THIS request slow?* This module does, three ways:

* :func:`build_ledger` — a per-request critical-path LEDGER assembled
  from existing artifacts (the flight records whose member-rid lists
  include the request, the retirement record's stall episodes, the
  calibrated ``dev_ms_est`` from the attribution layer). The ledger
  decomposes end-to-end latency into named phases — queue wait,
  admission stalls (pool-dry / kv-quota / adapter-pin), prefill
  chunks, per-burst decode device time vs host slack, speculative
  draft/verify, stream delivery — by a cursor sweep that partitions
  ``[submit, end]`` EXACTLY: phases sum to the measured wall by
  construction, and a tier-1 gate (the counter-deltas family) holds
  the decomposition to it over the mixed bench workload. ``skytpu
  why <rid>`` renders it.

* :class:`TailDetector` + :class:`ExemplarStore` — streaming P²
  quantile estimators (five markers per metric, no unbounded
  reservoirs) on TTFT/TPOT per engine. A request crossing the
  configured quantile (default p99.9) pins its FULL evidence — the
  retirement record, every flight record it rode, its ledger — into a
  bounded exemplar store that survives flight-ring rollover. The one
  p99.9 outlier per ten thousand requests keeps its flight records
  long after the 8192-record ring has rolled past them.

* :func:`capture_incident` — the SLO watchdog's breach transition
  triggers an atomic capture bundle (flight-ring tail, recent event
  log, merged metrics snapshot, pinned exemplars, the alert itself)
  into a timestamped, GC'd directory under ``<home>/incidents/``,
  surfaced by ``skytpu incidents list/show`` and linked from the
  ``slo.breach`` event. A breach names a rule; the bundle preserves
  the cause.

Same design constraints as the rest of the observability stack:
stdlib-only, host-side only (assembly happens OFF the hot path — at
retirement, never per burst), bounded memory, and everything the
engine does for forensics sits behind one ``engine.forensics`` flag
whose off-path is bit-identical (gated ≤1.01x overhead on, like the
flight recorder itself).

Knobs: ``SKYTPU_FORENSICS`` (default on), ``SKYTPU_TAIL_QUANTILE``
(default 0.999), ``SKYTPU_TAIL_MIN_SAMPLES`` (default 32),
``SKYTPU_TAIL_EXEMPLARS`` (default 64), ``SKYTPU_INCIDENTS``
(default on), ``SKYTPU_INCIDENTS_KEEP`` (default 16),
``SKYTPU_INCIDENT_MIN_INTERVAL_S`` (default 60).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.observability import metrics, tracing

TAIL_EXEMPLARS_PINNED = metrics.counter(
    "skytpu_tail_exemplars_pinned_total",
    "Requests whose TTFT/TPOT crossed the streaming tail quantile and "
    "had their full flight+ledger evidence pinned into the exemplar "
    "store", labelnames=("metric",))
INCIDENTS_CAPTURED = metrics.counter(
    "skytpu_slo_incidents_total",
    "SLO breach transitions that captured an incident snapshot bundle "
    "(flight tail, event log, metrics, exemplars)")


def forensics_enabled() -> bool:
    """Request forensics is on unless explicitly disabled
    (``SKYTPU_FORENSICS=0``)."""
    return os.environ.get("SKYTPU_FORENSICS", "1") != "0"


# ---------------------------------------------------------------------------
# The per-request critical-path ledger
# ---------------------------------------------------------------------------

# Canonical phase order (render order). Everything except
# ``host_other`` is a NAMED phase — the ledger gate holds named
# coverage to >= 90% of the wall.
PHASE_ORDER: Tuple[str, ...] = (
    "queue_wait", "stall_pool_dry", "stall_kv_quota",
    "stall_adapter_pin", "stall_recover", "preempt_requeue",
    "prefill_wave",
    "prefill_chunk", "prefill_interleave", "decode_device",
    "decode_host", "spec_draft", "spec_verify_device",
    "spec_verify_host", "deliver", "host_other")

_UNNAMED = frozenset({"host_other"})

# Stall causes in the retirement record's ``stalls`` dict, in the
# order queue-ish gaps consume them.
STALL_PHASES = {"pool_dry": "stall_pool_dry",
                "kv_quota": "stall_kv_quota",
                "adapter_pin": "stall_adapter_pin",
                # Engine crash recovery: the request sat requeued while
                # the engine reset and re-admitted its cohort.
                "recover": "stall_recover"}

_DECODEISH = frozenset({"decode", "decode1", "verify", "draft"})


def _device_split(rec: Dict[str, Any], seg_ms: float
                  ) -> Tuple[float, float]:
    """Split one burst record's clipped segment into (device, host)
    milliseconds using the calibrated ``dev_ms_est`` when the record
    carries one. Without an estimate the whole dispatch->fetch wall is
    credited to the device — the record IS a device call, and honest
    under-attribution of host slack beats inventing a split."""
    dev = rec.get("dev_ms_est")
    if dev is None:
        return seg_ms, 0.0
    dev = min(max(float(dev), 0.0), seg_ms)
    return dev, seg_ms - dev


def records_for(rid: int, records: Sequence[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
    """Every flight record whose member-rid list includes ``rid``,
    sorted by timestamp (ties: recorder sequence)."""
    out = [r for r in records if rid in (r.get("rids") or ())]
    out.sort(key=lambda r: (r.get("ts_s", 0.0), r.get("seq", 0)))
    return out


def build_ledger(retire: Dict[str, Any],
                 records: Sequence[Dict[str, Any]]
                 ) -> Dict[str, Any]:
    """Assemble the critical-path ledger for one retired request.

    ``retire`` is the request's ``burst == "retire"`` flight record
    (carries submit/first-token/end stamps and the stall-episode
    totals); ``records`` is any record set containing the request's
    burst records (extras for other rids are filtered out). The sweep
    partitions ``[submit_s, end_s]`` exactly: each burst record claims
    its (overlap-clipped) span, each gap between consecutive spans is
    classified by its neighbours, so ``sum(phases) == wall`` to float
    round-off BY CONSTRUCTION — the gate asserts it anyway, because an
    assembly bug (unsorted records, double-counted overlap) breaks
    exactly that invariant.
    """
    rid = retire["rids"][0]
    submit_s = float(retire["submit_s"])
    end_s = float(retire["end_s"])
    recs = [r for r in records_for(rid, records)
            if r.get("burst") != "retire"]
    phases: Dict[str, float] = {}
    spec_overlap_ms = 0.0
    computed_len = 0

    def add(phase: str, ms: float) -> None:
        if ms > 0.0:
            phases[phase] = phases.get(phase, 0.0) + ms

    # Queue-ish gaps consume the retirement record's stall-episode
    # totals first (the episodes HAPPENED inside those gaps); the
    # remainder is plain queue wait / post-preemption requeue.
    remaining_stalls = {c: max(float(v), 0.0)
                        for c, v in (retire.get("stalls") or {}).items()
                        if c in STALL_PHASES}

    def add_queueish(gap_ms: float, phase: str) -> None:
        for cause in ("pool_dry", "kv_quota", "adapter_pin", "recover"):
            left = remaining_stalls.get(cause, 0.0)
            if left <= 0.0 or gap_ms <= 0.0:
                continue
            take = min(left, gap_ms)
            add(STALL_PHASES[cause], take)
            remaining_stalls[cause] = left - take
            gap_ms -= take
        add(phase, gap_ms)

    cursor = submit_s
    prev_kind: Optional[str] = None
    for rec in recs:
        b = float(rec.get("ts_s", cursor))
        e = b + max(float(rec.get("dur_s", 0.0)), 0.0)
        kind = rec.get("burst", "")
        spec_overlap_ms += float(rec.get("overlap_ms", 0.0) or 0.0)
        if kind == "chunk":
            computed_len += 1
        e = min(e, end_s)
        if e <= cursor:
            # Fully inside an already-claimed span (a pipelined draft
            # dispatched during the previous verify's window): its
            # wall is accounted once, by whoever ran first.
            prev_kind = kind
            continue
        gap_ms = (b - cursor) * 1e3
        if gap_ms > 0.0:
            if prev_kind is None:
                add_queueish(gap_ms, "queue_wait")
            elif prev_kind in ("preempt", "recover"):
                # Crash recovery rides the preemption resume path, so
                # its post-reset wait classifies the same way (the
                # recover stall total is consumed first above).
                add_queueish(gap_ms, "preempt_requeue")
            elif prev_kind == "chunk" and kind == "chunk":
                # Interleaved decode bursts of OTHER slots ran between
                # this request's chunks — the interference chunked
                # prefill exists to bound.
                add("prefill_interleave", gap_ms)
            elif prev_kind in _DECODEISH and kind in _DECODEISH:
                add("decode_host", gap_ms)
            elif prev_kind in ("wave", "chunk") and kind in _DECODEISH:
                add("decode_host", gap_ms)
            else:
                add("host_other", gap_ms)
            cursor = b
        seg_ms = (e - cursor) * 1e3
        if kind == "wave":
            add("prefill_wave", seg_ms)
        elif kind == "chunk":
            add("prefill_chunk", seg_ms)
        elif kind in ("decode", "decode1"):
            dev, host = _device_split(rec, seg_ms)
            add("decode_device", dev)
            add("decode_host", host)
        elif kind == "verify":
            dev, host = _device_split(rec, seg_ms)
            add("spec_verify_device", dev)
            add("spec_verify_host", host)
        elif kind == "draft":
            add("spec_draft", seg_ms)
        else:
            add("host_other", seg_ms)
        cursor = e
        prev_kind = kind
    # Tail: last burst fetch -> retirement stamp (token delivery /
    # completion bookkeeping). With no records at all the whole wall
    # is unattributable.
    tail_ms = (end_s - cursor) * 1e3
    if recs:
        add("deliver", tail_ms)
    else:
        add("host_other", tail_ms)

    wall_ms = (end_s - submit_s) * 1e3
    named_ms = sum(v for k, v in phases.items() if k not in _UNNAMED)
    other_ms = sum(v for k, v in phases.items() if k in _UNNAMED)
    first = retire.get("first_token_s")
    ledger = {
        "rid": rid,
        "wall_ms": round(wall_ms, 4),
        "phases": [
            {"phase": k, "ms": round(phases[k], 4),
             "pct": round(100.0 * phases[k] / wall_ms, 2)
             if wall_ms > 0 else 0.0}
            for k in PHASE_ORDER if k in phases],
        "named_ms": round(named_ms, 4),
        "other_ms": round(other_ms, 4),
        "n_records": len(recs),
        "detail": {
            "ttft_ms": round((float(first) - submit_s) * 1e3, 4)
            if first else None,
            "prompt_len": retire.get("prompt_len"),
            "cached_len": retire.get("cached_len"),
            "resumed_len": retire.get("resumed_len"),
            "n_chunks": retire.get("n_chunks"),
            "computed_chunks": computed_len,
            "n_toks": retire.get("n_toks"),
            "spec_drafted": retire.get("spec_drafted"),
            "spec_accepted": retire.get("spec_accepted"),
            "spec_overlap_ms": round(spec_overlap_ms, 4),
            "preemptions": retire.get("preemptions"),
            "tenant": retire.get("tenants"),
            "adapter": retire.get("adapter"),
        },
    }
    return ledger


def ledger_from_records(rid: int,
                        records: Sequence[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """Find ``rid``'s retirement record in ``records`` and build its
    ledger; None when the request has not retired (or its retirement
    already rolled out of the window)."""
    retire = None
    for r in records:
        if r.get("burst") == "retire" and rid in (r.get("rids") or ()):
            retire = r   # keep the LAST (preempt-resume retires once)
    if retire is None:
        return None
    return build_ledger(retire, records)


def render_ledger(ledger: Dict[str, Any], width: int = 28) -> str:
    """Human-readable phase table for ``skytpu why``."""
    lines = [f"request {ledger['rid']}: "
             f"wall {ledger['wall_ms']:.1f} ms over "
             f"{ledger['n_records']} burst records"]
    det = ledger.get("detail") or {}
    bits = []
    if det.get("ttft_ms") is not None:
        bits.append(f"ttft {det['ttft_ms']:.1f} ms")
    if det.get("n_toks"):
        bits.append(f"{det['n_toks']} toks")
    if det.get("cached_len"):
        bits.append(f"cached {det['cached_len']}")
    if det.get("spec_drafted"):
        bits.append(f"spec {det['spec_accepted']}/{det['spec_drafted']}")
    if det.get("spec_overlap_ms"):
        bits.append(f"overlap {det['spec_overlap_ms']:.1f} ms")
    if det.get("preemptions"):
        bits.append(f"preempted x{det['preemptions']}")
    if bits:
        lines.append("  " + "  ".join(bits))
    lines.append(f"  {'phase':<{width}} {'ms':>10} {'%':>6}")
    for ph in ledger["phases"]:
        bar = "#" * max(int(round(ph["pct"] / 2.5)), 0)
        lines.append(f"  {ph['phase']:<{width}} {ph['ms']:>10.2f} "
                     f"{ph['pct']:>5.1f}% {bar}")
    named_pct = (100.0 * ledger["named_ms"] / ledger["wall_ms"]
                 if ledger["wall_ms"] else 0.0)
    lines.append(f"  {'sum (= wall)':<{width}} "
                 f"{sum(p['ms'] for p in ledger['phases']):>10.2f} "
                 f"{'':>6} named {named_pct:.1f}%")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Streaming tail detection (P-squared quantile estimation)
# ---------------------------------------------------------------------------


class P2Quantile:
    """Streaming quantile estimator (Jain & Chlamtac's P² algorithm):
    five markers track (min, q/2, q, (1+q)/2, max) with parabolic
    height adjustment — O(1) memory and O(1) per observation, no
    reservoir. At millions of requests an exact p99.9 needs the whole
    stream; five floats get within a fraction of a percent."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1): {q}")
        self.q = q
        self.count = 0
        self._init: List[float] = []
        self._heights: Optional[List[float]] = None
        self._pos: List[float] = []
        self._desired: List[float] = []
        self._dn = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def observe(self, x: float) -> None:
        self.count += 1
        h = self._heights
        if h is None:
            self._init.append(x + 0.0)
            if len(self._init) == 5:
                self._init.sort()
                self._heights = list(self._init)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._desired = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                                 3.0 + 2.0 * q, 5.0]
            return
        pos = self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 3
            for i in range(1, 4):
                if x < h[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._dn[i]
        for i in range(1, 4):
            d = self._desired[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, d)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    # Parabolic prediction left the bracket: linear.
                    j = i + 1 if d > 0 else i - 1
                    h[i] += d * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
            / (n[i] - n[i - 1]))

    def value(self) -> Optional[float]:
        """Current quantile estimate; before five observations, the
        empirical quantile of what we have (None when empty)."""
        if self._heights is not None:
            return self._heights[2]
        if not self._init:
            return None
        s = sorted(self._init)
        idx = min(int(self.q * len(s)), len(s) - 1)
        return s[idx]


class TailDetector:
    """Per-engine streaming tail detector over TTFT and TPOT.

    ``observe`` compares the new sample against the estimate built
    from PRIOR samples (then folds it in), so a tail observation is
    "slower than the p-quantile of everything before it" — crossing
    requests get pinned, and the estimator keeps adapting. A warmup
    floor (``min_samples``) stops the first handful of requests from
    all counting as tails of a five-sample distribution."""

    METRICS = ("ttft", "tpot")

    def __init__(self, quantile: Optional[float] = None,
                 min_samples: Optional[int] = None):
        if quantile is None:
            try:
                quantile = float(
                    os.environ.get("SKYTPU_TAIL_QUANTILE", "") or 0.999)
            except ValueError:
                quantile = 0.999
        if min_samples is None:
            try:
                min_samples = int(
                    os.environ.get("SKYTPU_TAIL_MIN_SAMPLES", "") or 32)
            except ValueError:
                min_samples = 32
        self.quantile = quantile
        self.min_samples = max(int(min_samples), 5)
        self._est = {m: P2Quantile(quantile) for m in self.METRICS}

    def observe(self, metric: str, value: float
                ) -> Tuple[bool, Optional[float]]:
        """Fold one sample in; returns (crossed_tail, threshold)."""
        est = self._est[metric]
        threshold = est.value()
        crossed = (est.count >= self.min_samples
                   and threshold is not None and value >= threshold)
        est.observe(value)
        return crossed, threshold

    def snapshot(self) -> Dict[str, Any]:
        return {
            "quantile": self.quantile,
            "min_samples": self.min_samples,
            "estimates": {
                m: {"value": self._est[m].value(),
                    "count": self._est[m].count}
                for m in self.METRICS},
        }


class ExemplarStore:
    """Bounded store of pinned tail exemplars — full evidence (retire
    record, member flight records, ledger) for requests that crossed
    the tail quantile. A deque under a lock: the engine loop pins,
    HTTP threads and the incident capture read. Surviving flight-ring
    rollover is the point: the ring holds ~a minute of bursts, the
    store holds the last N INTERESTING requests regardless of age."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(
                    os.environ.get("SKYTPU_TAIL_EXEMPLARS", "") or 64)
            except ValueError:
                capacity = 64
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque(
            maxlen=self.capacity)

    def pin(self, exemplar: Dict[str, Any]) -> None:
        with self._lock:
            self._items.append(exemplar)

    def get(self, rid: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            for ex in reversed(self._items):
                if ex.get("rid") == rid:
                    return ex
        return None

    def list(self) -> List[Dict[str, Any]]:
        """Newest-first summaries (the full records stay behind
        :meth:`get`/:meth:`snapshot` — a list is a dashboard row)."""
        with self._lock:
            items = list(self._items)
        out = []
        for ex in reversed(items):
            out.append({
                "rid": ex.get("rid"), "metric": ex.get("metric"),
                "value_ms": ex.get("value_ms"),
                "threshold_ms": ex.get("threshold_ms"),
                "ts_s": ex.get("ts_s"),
                "wall_ms": (ex.get("ledger") or {}).get("wall_ms"),
                "n_records": len(ex.get("records") or ()),
            })
        return out

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


# Process-default store (the flight RECORDER idiom): engines pin into
# it unless handed an injectable instance, and the SLO incident
# capture bundles whatever is pinned at breach time.
EXEMPLARS = ExemplarStore()


# ---------------------------------------------------------------------------
# SLO incident snapshots
# ---------------------------------------------------------------------------

_INCIDENTS_DIRNAME = "incidents"
_capture_lock = threading.Lock()
_last_capture_s = 0.0


def incidents_enabled() -> bool:
    return os.environ.get("SKYTPU_INCIDENTS", "1") != "0"


def incidents_dir(base_dir: Optional[str] = None) -> str:
    if base_dir is not None:
        return base_dir
    from skypilot_tpu_torch.utils import paths
    return os.path.join(paths.home(), _INCIDENTS_DIRNAME)


def _keep() -> int:
    try:
        return max(int(
            os.environ.get("SKYTPU_INCIDENTS_KEEP", "") or 16), 1)
    except ValueError:
        return 16


def _min_interval_s() -> float:
    try:
        return float(
            os.environ.get("SKYTPU_INCIDENT_MIN_INTERVAL_S", "") or 60)
    except ValueError:
        return 60.0


def capture_incident(rule: str, attrs: Dict[str, Any],
                     recorder: Optional[Any] = None,
                     exemplars: Optional[ExemplarStore] = None,
                     health: Optional[Dict[str, Any]] = None,
                     base_dir: Optional[str] = None,
                     force: bool = False) -> Optional[str]:
    """Capture one incident snapshot bundle; returns its directory
    (or None when disabled / rate-limited / failed).

    Atomic by the tempdir+rename idiom the flush paths use: the bundle
    materialises under a ``.tmp`` name and renames into place, so a
    reader listing the incidents dir never sees a half-written bundle.
    Rate-limited (one bundle per ``SKYTPU_INCIDENT_MIN_INTERVAL_S``):
    a flapping rule must not turn the home dir into a disk-filling
    event loop — the FIRST transition of a storm carries the evidence.
    """
    global _last_capture_s
    if not incidents_enabled():
        return None
    now = time.time()
    with _capture_lock:
        if not force and now - _last_capture_s < _min_interval_s():
            return None
        _last_capture_s = now
    base = incidents_dir(base_dir)
    name = f"{int(now * 1e3)}-{rule}"
    final = os.path.join(base, name)
    tmp = final + ".tmp"
    try:
        os.makedirs(tmp, exist_ok=True)
        if recorder is None:
            from skypilot_tpu_torch.observability import flight as flight_lib
            recorder = flight_lib.RECORDER
        store = exemplars if exemplars is not None else EXEMPLARS
        meta = {"rule": rule, "ts_s": now, "pid": os.getpid(),
                "attrs": dict(attrs)}
        _write_json(os.path.join(tmp, "meta.json"), meta)
        _write_json(os.path.join(tmp, "alert.json"), dict(attrs))
        _write_json(os.path.join(tmp, "health.json"), health or {})
        _write_json(os.path.join(tmp, "exemplars.json"),
                    store.snapshot())
        with open(os.path.join(tmp, "flight.jsonl"), "w",
                  encoding="utf-8") as f:
            tail = recorder.tail() if recorder is not None else []
            for rec in tail:
                f.write(json.dumps(rec) + "\n")
        with open(os.path.join(tmp, "events.jsonl"), "w",
                  encoding="utf-8") as f:
            for rec in tracing.buffered_records():
                f.write(json.dumps(rec) + "\n")
        with open(os.path.join(tmp, "metrics.prom"), "w",
                  encoding="utf-8") as f:
            f.write(metrics.REGISTRY.render())
        os.rename(tmp, final)
    except OSError:
        return None
    finally:
        if os.path.isdir(tmp):
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
    INCIDENTS_CAPTURED.inc()
    _gc_incidents(base)
    return final


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, default=str)


def _gc_incidents(base: str) -> None:
    try:
        names = sorted(n for n in os.listdir(base)
                       if not n.endswith(".tmp")
                       and os.path.isdir(os.path.join(base, n)))
    except OSError:
        return
    import shutil
    for n in names[:-_keep()]:
        shutil.rmtree(os.path.join(base, n), ignore_errors=True)


def list_incidents(base_dir: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
    """Newest-first incident summaries from the incidents dir."""
    base = incidents_dir(base_dir)
    try:
        names = sorted((n for n in os.listdir(base)
                        if not n.endswith(".tmp")
                        and os.path.isdir(os.path.join(base, n))),
                       reverse=True)
    except OSError:
        return []
    out = []
    for n in names:
        meta: Dict[str, Any] = {}
        try:
            with open(os.path.join(base, n, "meta.json"),
                      encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        out.append({"name": n, "rule": meta.get("rule"),
                    "ts_s": meta.get("ts_s"),
                    "attrs": meta.get("attrs") or {}})
    return out


def load_incident(name: str, base_dir: Optional[str] = None
                  ) -> Optional[Dict[str, Any]]:
    """One incident's metadata plus its bundle file inventory."""
    base = incidents_dir(base_dir)
    path = os.path.join(base, name)
    if not os.path.isdir(path) or os.path.dirname(name):
        return None
    meta: Dict[str, Any] = {}
    try:
        with open(os.path.join(path, "meta.json"),
                  encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        pass
    files = []
    for fn in sorted(os.listdir(path)):
        fp = os.path.join(path, fn)
        if os.path.isfile(fp):
            try:
                lines = None
                if fn.endswith(".jsonl"):
                    with open(fp, encoding="utf-8") as f:
                        lines = sum(1 for _ in f)
                files.append({"file": fn,
                              "bytes": os.path.getsize(fp),
                              "lines": lines})
            except OSError:
                continue
    return {"name": name, "path": path, "meta": meta, "files": files}
