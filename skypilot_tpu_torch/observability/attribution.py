"""Device-truth performance attribution: per-program device timing,
the HBM ledger, roofline FLOPs/bytes accounting, and bubble analysis.

The port's copy of ``skypilot_tpu/observability/attribution.py``. The
host pieces (:class:`HbmLedger`'s bookkeeping, :class:`Roofline`,
:func:`analyze_bubbles`, :func:`idle_spans`, :func:`render_bubbles`)
are the reference's. Three parts are the card's own:

* :meth:`DeviceTimeCalibrator.timed_call` brackets one sampled dispatch
  with CUDA events (the stream synchronized first, ``end.synchronize()``
  after). On the card a program is tens of eager launches and decode is
  host-bound, so the events' span includes the launch gaps between
  them: ``dev_ms_est`` is the program's device-stream span, not the sum
  of its kernels' busy time. On the CPU the bracket is the wall.
* :func:`device_peaks` matches the card by ``torch.cuda.get_device_name``
  (an H100: 989e12 bf16 FLOP/s and 3.35e12 B/s, NVIDIA's H100 SXM data
  sheet); no TPU row is consulted for a CUDA device.
* :meth:`HbmLedger.cross_check` reads the caching allocator
  (``allocated_bytes.all.current``) and the card's total memory; on a
  card a failed read raises, on the CPU the typed
  ``attribution.memstats_unavailable`` event is emitted once.

Every observability layer before this one measured HOST wall time: a
flight record's dispatch->fetch window conflates device execution with
host scheduling, and under the async draft/verify pipeline that
conflation is structural. This module closes the host/device gap on
three axes, all host-side except one deliberate, sampled sync:

* :class:`DeviceTimeCalibrator` — a sampled calibration pass. Every
  Nth dispatch of a program identity (``SKYTPU_DEVTIME_EVERY``, 0 =
  off) is timed synchronously: a dispatch -> completion bracket,
  maintaining an EWMA of device seconds per program key in the
  compile-watch registry. Flight records then carry
  ``dev_ms_est`` (the EWMA at record time) next to host wall, so
  ``skytpu flight`` and the perfetto export render host-vs-device per
  burst and pipeline overlap becomes measured-calibrated instead of
  inferred. The bracket is the ONE sanctioned host sync of the
  attribution layer — it rides the lint baseline exactly like the
  engine's completion fetches, and at the default sampling rate its
  cost amortizes below the flight recorder's own overhead gate.

* :class:`HbmLedger` — analytical byte accounting of every
  device-resident tensor family (weights, KV pool + scales, draft
  pool, adapter pool, prefix-pinned blocks, workspace estimate),
  published as ``skytpu_hbm_bytes{component}`` gauges and
  cross-checked against ``device.memory_stats()`` where the backend
  provides one (CPU does not: typed ``attribution.memstats_
  unavailable`` event once, then analytical-only — never a crash, and
  never a zero gauge masquerading as truth). The ``hbm-headroom`` SLO
  rule alarms on ledger-total vs limit before the next admission
  would OOM.

* :class:`Roofline` + :func:`analyze_bubbles` — analytical FLOPs and
  HBM bytes per program identity (rows, span rung, K, bucket — all
  already in the record schema) turn each flight record into
  achieved-vs-roofline attribution; the counters feed the windowed
  serving MFU / bandwidth-utilization columns on ``skytpu top``, and
  the bubble analyzer attributes inter-dispatch device-idle gaps to
  named host causes (admission, qos_reorder, drafter_sync, stall,
  dispatch_overhead).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.observability import metrics, tracing

DEVICE_FLOPS = metrics.counter(
    "skytpu_device_flops_total",
    "Analytical FLOPs dispatched to the device, accumulated per flight "
    "record from the roofline model — rate / skytpu_roofline_peak_flops "
    "is the windowed serving MFU on skytpu top")
DEVICE_HBM_MOVED = metrics.counter(
    "skytpu_device_hbm_moved_bytes_total",
    "Analytical HBM bytes moved (weight streams + KV reads/writes) "
    "accumulated per flight record — rate / "
    "skytpu_roofline_peak_hbm_bytes_per_s is bandwidth utilization")
DEVICE_SECONDS = metrics.counter(
    "skytpu_device_seconds_total",
    "Estimated pure device-busy seconds (calibrated EWMA per program, "
    "accumulated per flight record) — the device-truth numerator the "
    "host-wall histograms cannot provide")
DEVTIME_CALIBRATIONS = metrics.counter(
    "skytpu_devtime_calibrations_total",
    "Sampled device-time calibration brackets taken (each is one "
    "deliberate dispatch->block_until_ready sync)")
DEVTIME_EWMA_MS = metrics.gauge(
    "skytpu_devtime_ewma_ms",
    "Calibrated EWMA of pure device milliseconds per compiled program "
    "identity",
    labelnames=("program",))
HBM_BYTES = metrics.gauge(
    "skytpu_hbm_bytes",
    "Analytical HBM ledger: bytes each device-resident tensor family "
    "holds (weights, kv_pool, kv_used, draft_pool, adapter_pool, "
    "prefix_pinned, workspace)",
    labelnames=("component",))
HBM_LIMIT = metrics.gauge(
    "skytpu_hbm_limit_bytes",
    "Device HBM capacity the ledger is checked against "
    "(device.memory_stats bytes_limit when the backend reports one, "
    "else SKYTPU_HBM_LIMIT_BYTES)")
HBM_DEVICE_IN_USE = metrics.gauge(
    "skytpu_hbm_device_bytes_in_use",
    "device.memory_stats() bytes_in_use — the runtime's own view, "
    "published only when the backend reports it (the analytical "
    "ledger's cross-check)")
ROOFLINE_PEAK_FLOPS = metrics.gauge(
    "skytpu_roofline_peak_flops",
    "Peak device FLOP/s the MFU column divides by "
    "(SKYTPU_PEAK_TFLOPS, else a device-kind table, else a CPU "
    "placeholder)")
ROOFLINE_PEAK_BW = metrics.gauge(
    "skytpu_roofline_peak_hbm_bytes_per_s",
    "Peak HBM bandwidth (bytes/s) the bandwidth-utilization column "
    "divides by (SKYTPU_PEAK_GBPS, else a device-kind table)")

# Peak FLOP/s (bf16) and HBM bytes/s per device kind: the roofline
# denominators, matched by substring against the card's name
# (``torch.cuda.get_device_name``). H100: NVIDIA's H100 SXM data sheet
# (dense bf16, HBM3). The CPU fallback is a deliberately modest
# placeholder so MFU stays a meaningful nonzero ratio in tests.
_PEAKS: Dict[str, tuple] = {
    "h100": (989e12, 3.35e12),
    "cpu": (0.5e12, 50e9),
}


def devtime_every(default: int = 64) -> int:
    """Calibration sampling period (bursts per program key between
    brackets). ``SKYTPU_DEVTIME_EVERY=0`` disables calibration."""
    try:
        return int(os.environ.get("SKYTPU_DEVTIME_EVERY", str(default))
                   or 0)
    except ValueError:
        return default


def _torch_device(device=None):
    import torch
    if device is None:
        if torch.cuda.is_available():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """The device's name as the peaks table matches it: the CUDA card's
    name, lowercased, or ``cpu``."""
    import torch
    dev = _torch_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev).lower()
    return dev.type


def datasheet_peaks(kind: str) -> Optional[tuple]:
    """(peak FLOP/s, peak HBM bytes/s) of the table's row that names
    ``kind`` (a :func:`device_kind` string), or None when no row does.
    The table alone: no env override is read."""
    for k, peaks in _PEAKS.items():
        if k in kind:
            return peaks
    return None


def device_peaks(device=None) -> tuple:
    """(peak FLOP/s, peak HBM bytes/s) for ``device`` (default: the
    current card, else the CPU), env overrides first
    (SKYTPU_PEAK_TFLOPS / SKYTPU_PEAK_GBPS). A card the table does not
    name gets the CPU placeholder, as an unknown device kind does in the
    reference."""
    flops, bw = datasheet_peaks(device_kind(device)) or _PEAKS["cpu"]
    env_f = os.environ.get("SKYTPU_PEAK_TFLOPS")
    if env_f:
        try:
            flops = float(env_f) * 1e12
        except ValueError:
            pass
    env_b = os.environ.get("SKYTPU_PEAK_GBPS")
    if env_b:
        try:
            bw = float(env_b) * 1e9
        except ValueError:
            pass
    return flops, bw


def tensor_bytes(tree: Any) -> int:
    """Total bytes of the storages under a (nested dict/list/tuple) tree
    of tensors, each storage counted once: the KV pool's planes and any
    views of them share storage and must not count twice. Metadata
    reads only, never a device fetch."""
    if tree is None:
        return 0
    import torch
    seen = set()
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            key = (str(x.device), st.data_ptr(), st.nbytes())
            if key not in seen:
                seen.add(key)
                total += int(st.nbytes())
    return total


# ---------------------------------------------------------------------------
# (a) Per-program device timing: the sampled calibration pass.

class DeviceTimeCalibrator:
    """EWMA of pure device seconds per compiled-program identity.

    Attached to a :class:`~skypilot_tpu_torch.observability.flight.
    CompileWatch` (``watch.calibrator = cal``): the watch's hit path
    asks :meth:`tick` whether THIS dispatch of the key should be the
    sampled one and, when it is, routes through :meth:`timed_call` —
    the dispatch -> completion bracket that turns one burst
    per key per period into a device-truth sample. Everything else is
    lock-guarded host dicts.

    Staleness bound: a key redispatched every burst is recalibrated
    every ``every`` bursts, so the EWMA (alpha 0.25) lags a step
    change by ~4*every bursts; :meth:`summary` reports each key's
    ``age_s`` so consumers can see exactly how stale an estimate is.
    """

    def __init__(self, every: Optional[int] = None, alpha: float = 0.25,
                 device=None):
        self._every = every          # None: read the env per tick
        self.alpha = alpha
        # The engine's device: CUDA events bracket on a card, the wall
        # on the CPU. None: the wall (host-only callers, tests).
        self.device = None if device is None else _torch_device(device)
        self._lock = threading.Lock()
        self._ewma: Dict[str, float] = {}      # guarded-by: _lock
        self._counts: Dict[str, int] = {}      # guarded-by: _lock
        self._stamp: Dict[str, float] = {}     # guarded-by: _lock
        self.samples = 0                       # guarded-by: _lock

    @property
    def every(self) -> int:
        return self._every if self._every is not None else devtime_every()

    def tick(self, key: str) -> bool:
        """Count one dispatch of ``key``; True when this one should be
        calibration-timed (the first post-compile dispatch, then every
        ``every``-th). Suppressed contexts (warmup sweeps) never
        sample — a warm-grid bracket would serialize the sweep."""
        n = self.every
        if n <= 0 or metrics.suppressed():
            return False
        with self._lock:
            c = self._counts.get(key, 0) + 1
            self._counts[key] = c
        return c % n == 1 or n == 1

    def timed_call(self, key: str, fn, *args, **kwargs):
        """The calibration bracket: one synchronous dispatch of ``fn``
        timed to completion. On a card: synchronize the stream, record a
        start ``torch.cuda.Event``, dispatch, record the end event, then
        ``end.synchronize()`` and ``elapsed_time``; the span holds the
        program's kernels AND the launch gaps between them (an eager
        program is tens of launches). On the CPU: the wall. Deliberate
        host sync, the ONE the attribution layer owns."""
        dev = self.device
        if dev is not None and dev.type == "cuda":
            import torch
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev)
                stream.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                out = fn(*args, **kwargs)
                end.record(stream)
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            dt = time.monotonic() - t0
        self.update(key, dt)
        return out

    def update(self, key: str, dev_s: float) -> None:
        dev_s = max(float(dev_s), 0.0)
        with self._lock:
            prev = self._ewma.get(key)
            cur = (dev_s if prev is None
                   else prev + self.alpha * (dev_s - prev))
            self._ewma[key] = cur
            self._stamp[key] = time.monotonic()
            self.samples += 1
        DEVTIME_CALIBRATIONS.inc()
        DEVTIME_EWMA_MS.labels(program=key).set(cur * 1e3)

    def estimate(self, key: Optional[str]) -> Optional[float]:
        """Calibrated device seconds for one program key (None when the
        key has never been bracketed)."""
        if key is None:
            return None
        with self._lock:
            return self._ewma.get(key)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return {
                k: {"dev_ms": round(v * 1e3, 4),
                    "samples": self._counts.get(k, 0),
                    "age_s": round(now - self._stamp.get(k, now), 3)}
                for k, v in sorted(self._ewma.items())
            }


# ---------------------------------------------------------------------------
# (b) The HBM ledger.

class HbmLedger:
    """Analytical byte accounting of device-resident tensor families.

    ``set_bytes`` is absolute (the owner recomputes each component
    from its own authoritative host bookkeeping — allocator block
    counts, prefix payloads, array nbytes), so the ledger can never
    drift from the structures it mirrors: a leak in the ledger IS a
    leak in the structure. Publishing happens inline through the
    ``skytpu_hbm_bytes{component}`` gauge.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._components: Dict[str, int] = {}   # guarded-by: _lock
        self._memstats_warned = False           # guarded-by: _lock

    def set_bytes(self, component: str, n: int) -> None:
        n = max(int(n), 0)
        with self._lock:
            self._components[component] = n
        HBM_BYTES.labels(component=component).set(n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._components)

    def total(self) -> int:
        with self._lock:
            return sum(self._components.values())

    def clear(self) -> None:
        with self._lock:
            comps = list(self._components)
            self._components.clear()
        for c in comps:
            HBM_BYTES.labels(component=c).set(0)

    def set_limit(self, n: int) -> None:
        HBM_LIMIT.set(max(int(n), 0))

    def cross_check(self, device=None) -> Optional[Dict[str, int]]:
        """The runtime's own view. On a card: the caching allocator's
        ``allocated_bytes.all.current`` as bytes_in_use and the card's
        total memory as bytes_limit, both published; a failed read
        raises (no fallback hides the device). On the CPU: the typed
        ``attribution.memstats_unavailable`` event ONCE and None, the
        analytical ledger staying the only truth."""
        import torch
        dev = _torch_device(device)
        if dev.type != "cuda":
            with self._lock:
                warned, self._memstats_warned = self._memstats_warned, True
            if not warned:
                tracing.add_event(
                    "attribution.memstats_unavailable",
                    {"platform": dev.type,
                     "fallback": "analytical_ledger_only"})
            return None
        stats = torch.cuda.memory_stats(dev)
        out = {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
               "bytes_limit": int(
                   torch.cuda.get_device_properties(dev).total_memory)}
        HBM_DEVICE_IN_USE.set(out["bytes_in_use"])
        self.set_limit(out["bytes_limit"])
        return out


# ---------------------------------------------------------------------------
# (c) Roofline FLOPs / bytes per program identity.

class Roofline:
    """Analytical cost model over the engine's burst kinds.

    Built from the serving model's dims plus the engine's ACTUAL
    resident byte counts (quantized weights count at their quantized
    size; int8 KV counts its scales). Every input a record needs is
    already in the record schema — rows, span rung, K, bucket — so
    record cost is pure host arithmetic at record time.

    Formulas (P = param count, d = d_model, L = layers, nh/hd =
    heads/head_dim, W = weight bytes, kvt = KV bytes per token):

    * matmul FLOPs   = 2 * P * tokens_computed
    * attn FLOPs     = 4 * L * nh * hd * span * tokens_computed
    * bytes moved    = passes * W  +  passes * rows * span * kvt
                       + tokens_written * kvt
      where ``passes`` is how many times the program streams the
      weights (decode burst: k sequential steps; wave/chunk/verify:
      one forward).
    """

    def __init__(self, *, param_count: int, weight_bytes: int,
                 kv_token_bytes: int, d_model: int, n_layers: int,
                 n_heads: int, head_dim: int, max_len: int,
                 chunk_tokens: Optional[int] = None):
        self.param_count = int(param_count)
        self.weight_bytes = int(weight_bytes)
        self.kv_token_bytes = int(kv_token_bytes)
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.max_len = max_len
        self.chunk_tokens = chunk_tokens or 0

    def _attn_flops(self, tokens: int, span: int) -> int:
        return 4 * self.n_layers * self.n_heads * self.head_dim \
            * int(span) * int(tokens)

    def _cost(self, tokens: int, rows: int, span: int,
              passes: int = 1) -> tuple:
        flops = 2 * self.param_count * tokens \
            + self._attn_flops(tokens, span)
        moved = passes * self.weight_bytes \
            + passes * rows * int(span) * self.kv_token_bytes \
            + tokens * self.kv_token_bytes
        return int(flops), int(moved)

    def record_cost(self, burst: str, program: Dict[str, Any],
                    n_slots: int, toks: int) -> tuple:
        """(FLOPs, HBM bytes) DISPATCHED for one flight record — the
        work the device was asked for (a decode burst costs its full
        k x rows grid even when a retirement discards the tail),
        which is what achieved-vs-roofline must charge."""
        prog = program or {}
        rows = max(int(n_slots), 1)
        span = int(prog.get("span") or self.max_len)
        if burst == "wave":
            rows = int(prog.get("rows") or rows)
            bucket = int(prog.get("bucket") or self.max_len)
            # Causal prefill: the average key span of a bucket-wide
            # prompt is bucket/2.
            return self._cost(rows * bucket, rows,
                              max(bucket // 2, 1))
        if burst == "chunk":
            c = self.chunk_tokens or span
            return self._cost(c, 1, span)
        if burst == "decode":
            k = int(prog.get("k") or 1)
            return self._cost(k * rows, rows, span, passes=k)
        if burst == "decode1":
            return self._cost(rows, rows, span)
        if burst == "verify":
            k = int(prog.get("k") or 1)
            return self._cost((k + 1) * rows, rows, span)
        if burst == "draft":
            # The draft model's pipelined rollout: k sequential steps
            # per row, exactly a decode burst — the caller passes the
            # Roofline built on the DRAFT config.
            k = int(prog.get("k") or 1)
            return self._cost(k * rows, rows, span, passes=k)
        return 0, 0


# ---------------------------------------------------------------------------
# Bubble analysis: where the serving loop left the device idle.

# Every cause the analyzer can name. ``host_other`` is the residue —
# the acceptance bar (>= 90% attributed) counts everything above it.
BUBBLE_CAUSES = ("admission", "qos_reorder", "drafter_sync", "stall",
                 "dispatch_overhead", "host_other")

# Gaps below this are dispatch jitter, not bubbles worth a span.
_MIN_GAP_MS = 0.01


def _gap_cause(prev: Dict[str, Any], nxt: Dict[str, Any]) -> str:
    """Name the host-side cause of a device-idle gap between two
    consecutive flight records."""
    if prev.get("burst") == "preempt" or nxt.get("burst") == "preempt" \
            or nxt.get("priorities") or prev.get("priorities"):
        return "qos_reorder"
    if nxt.get("burst") in ("wave", "chunk"):
        # The host was assembling prompts / claiming blocks /
        # running admission before this dispatch.
        return "admission"
    if nxt.get("burst") in ("verify", "draft") \
            or prev.get("burst") in ("draft", "verify"):
        # Host drafting (n-gram walks, draft batch assembly, predraft
        # reconcile) between device dispatches of the spec path.
        return "drafter_sync"
    if nxt.get("stall") or prev.get("stall"):
        return "stall"
    if nxt.get("burst") in ("decode", "decode1") \
            and prev.get("burst") in ("decode", "decode1", "wave",
                                      "chunk"):
        # Steady-state decode chaining: the gap is host bookkeeping
        # (token append/retire/stream framing) between bursts.
        return "dispatch_overhead"
    return "host_other"


def analyze_bubbles(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Attribute device-idle time over a window of flight records.

    Two idle populations: gaps BETWEEN consecutive records (the host
    ran admission/drafting/QoS/bookkeeping with nothing dispatched)
    and the slack WITHIN a record (host wall beyond the calibrated
    ``dev_ms_est`` — dispatch overhead plus the completion fetch wait
    after the device finished). Returns totals, a per-cause
    breakdown, the individual bubbles (for the perfetto export), and
    ``coverage`` — the fraction of idle attributed to a cause other
    than ``host_other``.
    """
    recs = sorted((r for r in records
                   if r.get("kind") == "flight" and "ts_s" in r),
                  key=lambda r: (r.get("ts_s", 0.0), r.get("seq", 0)))
    out: Dict[str, Any] = {
        "n_records": len(recs), "window_ms": 0.0,
        "device_busy_ms": 0.0, "device_idle_ms": 0.0,
        "by_cause": {}, "bubbles": [], "coverage": 1.0,
    }
    if len(recs) < 2:
        return out
    by_cause: Dict[str, float] = {}
    bubbles: List[Dict[str, Any]] = []
    busy = 0.0
    prev_end = float(recs[0].get("ts_s", 0.0))
    prev = None
    for r in recs:
        ts = float(r.get("ts_s", 0.0))
        dur_ms = max(float(r.get("dur_s", 0.0)), 0.0) * 1e3
        dev_ms = r.get("dev_ms_est")
        dev_ms = (min(float(dev_ms), dur_ms) if dev_ms is not None
                  else dur_ms)
        busy += dev_ms
        if prev is not None:
            gap_ms = (ts - prev_end) * 1e3
            if gap_ms > _MIN_GAP_MS:
                cause = _gap_cause(prev, r)
                by_cause[cause] = by_cause.get(cause, 0.0) + gap_ms
                bubbles.append({
                    "start_s": prev_end, "end_s": ts,
                    "gap_ms": round(gap_ms, 4), "cause": cause,
                    "next": r.get("burst"), "pid": r.get("pid", 0),
                    "proc": r.get("proc", "?"),
                })
        # Within-record slack: host wall past the device estimate is
        # device idle spent in dispatch overhead + the fetch wait.
        slack = dur_ms - dev_ms
        if slack > _MIN_GAP_MS:
            by_cause["dispatch_overhead"] = \
                by_cause.get("dispatch_overhead", 0.0) + slack
        prev_end = max(prev_end, ts + dur_ms / 1e3)
        prev = r
    first = float(recs[0].get("ts_s", 0.0))
    window_ms = max((prev_end - first) * 1e3, 0.0)
    idle = sum(by_cause.values())
    named = idle - by_cause.get("host_other", 0.0)
    out.update({
        "window_ms": round(window_ms, 3),
        "device_busy_ms": round(busy, 3),
        "device_idle_ms": round(idle, 3),
        "by_cause": {c: round(v, 3)
                     for c, v in sorted(by_cause.items(),
                                        key=lambda kv: -kv[1])},
        "bubbles": bubbles,
        "coverage": round(named / idle, 4) if idle > 0 else 1.0,
    })
    return out


def idle_spans(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Inter-dispatch bubbles reshaped as synthetic spans so the
    perfetto export renders device-idle gaps as named tracks next to
    the burst spans."""
    report = analyze_bubbles(records)
    return [{
        "kind": "span", "name": f"bubble:{b['cause']}",
        "start_s": b["start_s"], "end_s": b["end_s"],
        "pid": b["pid"], "tid": b["pid"], "proc": b["proc"],
        "attrs": {"gap_ms": b["gap_ms"], "next": b["next"]},
    } for b in report["bubbles"]]


def render_bubbles(report: Dict[str, Any], last: int = 16) -> str:
    """Human view of a bubble report (``skytpu flight --bubbles``)."""
    lines = [
        f"window {report['window_ms']:.1f}ms over "
        f"{report['n_records']} records: device busy "
        f"{report['device_busy_ms']:.1f}ms, idle "
        f"{report['device_idle_ms']:.1f}ms "
        f"({report['coverage'] * 100:.1f}% of idle attributed)",
    ]
    if report["by_cause"]:
        lines.append("")
        lines.append("idle by cause:")
        total = max(report["device_idle_ms"], 1e-9)
        for cause, ms in report["by_cause"].items():
            lines.append(f"  {cause:<20} {ms:>9.2f}ms "
                         f"{ms / total * 100:>5.1f}%")
    biggest = sorted(report["bubbles"], key=lambda b: -b["gap_ms"])
    if biggest:
        lines.append("")
        lines.append(f"largest bubbles (top {min(last, len(biggest))}):")
        for b in biggest[:last]:
            lines.append(f"  +{b['gap_ms']:>8.2f}ms  {b['cause']:<18} "
                         f"before {b['next']}")
    return "\n".join(lines)
