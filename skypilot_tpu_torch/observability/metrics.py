"""Dependency-free metrics core: Counter/Gauge/Histogram + Registry.

Copy of ``skypilot_tpu/observability/metrics.py`` (the port imports
nothing of the JAX package, not even its stdlib-only modules). Every
serving path of the port records into the process-global
:data:`REGISTRY`, and the model server renders it as Prometheus text
exposition (format 0.0.4) on ``GET /metrics``, byte for byte as the
reference renders the same samples, under the reference's metric
names: the fleet federation, the SLO burn-rate autoscaler and the
reference's :func:`parse_exposition` read a GPU replica as they read a
TPU one.

Design constraints, in order:
  * stdlib only;
  * cheap when unscraped: one dict lookup + float add under a lock per
    record;
  * safe under concurrency: handler threads and the engine loop thread
    record into one registry.

The reference's ``write_exposition_file`` (for daemons without an HTTP
surface) is left out: no port process publishes its registry that way.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Prometheus' classic latency ladder: 5 ms .. 10 s. TTFT on a cold
# bucket and a relayed chip can exceed 10 s, hence the 30/60 tail.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Serving-latency ladder for the user-visible histograms (TTFT, TPOT,
# HTTP request seconds): DEFAULT_BUCKETS puts exactly TWO boundaries
# between 25 ms and 250 ms — the region serving SLOs actually live in
# — so a p99 read off it can be interpolated across a 2.5x-wide
# bucket. This ladder is dense where decisions are made (1 ms .. 400
# ms) and still covers the cold-compile tail. Quantiles read from ANY
# histogram are linear interpolations within a bucket; see
# docs/observability.md ("quantile interpolation bias").
SERVING_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03, 0.045,
    0.065, 0.1, 0.15, 0.25, 0.4, 0.65, 1.0, 1.5, 2.5, 5.0, 10.0,
    30.0, 60.0)

_INF = float("inf")


def latency_buckets(default: Sequence[float] = SERVING_LATENCY_BUCKETS
                    ) -> Tuple[float, ...]:
    """Bucket ladder for the serving-latency histograms:
    ``SKYTPU_LATENCY_BUCKETS`` (comma-separated seconds) when set,
    else ``default``. The env var applies to every process that
    declares these histograms, so a fleet whose replicas share the
    environment stays merge-consistent — an override set on ONE
    replica is exactly the bucket-layout mismatch the fleet merge
    detects and refuses to sum. A malformed value falls back to the
    default (a typo must not take down metric declaration at import
    time)."""
    env = os.environ.get("SKYTPU_LATENCY_BUCKETS", "")
    if env:
        try:
            parsed = sorted(float(v) for v in env.split(",") if v.strip())
            if parsed and all(b > 0 for b in parsed):
                return tuple(parsed)
        except ValueError:
            pass
    return tuple(default)

_suppress_local = threading.local()


def _suppressed() -> bool:
    return getattr(_suppress_local, "depth", 0) > 0


def suppressed() -> bool:
    """Whether this thread is inside a :func:`suppress` block. Public
    so sibling recorders (the tracing event log) can honor the same
    discard window — warmup work skewing span summaries is the same
    bug as warmup work skewing histograms."""
    return _suppressed()


@contextlib.contextmanager
def suppress():
    """Discard every observation THIS thread records inside the block
    (``labels()`` lookups still resolve; values just don't change).
    For known-unrepresentative work driven through an instrumented
    path — e.g. the model server's warmup generation, whose XLA
    compile would permanently skew the serving histograms' sums."""
    _suppress_local.depth = getattr(_suppress_local, "depth", 0) + 1
    try:
        yield
    finally:
        _suppress_local.depth -= 1


def _format_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
    return "{" + inner + "}"


class _Child:
    """One (metric, label-values) time series. Thread-safe."""

    __slots__ = ("_lock", "_value", "_sum", "_counts", "_buckets")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None):
        self._lock = threading.Lock()
        self._value = 0.0
        if buckets is not None:
            self._sum = 0.0
            self._buckets = buckets
            self._counts = [0] * (len(buckets) + 1)   # +1 for +Inf

    # counter / gauge ------------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if _suppressed():
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if _suppressed():
            return
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        if _suppressed():
            return
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    # histogram ------------------------------------------------------------
    def observe(self, value: float) -> None:
        if _suppressed():
            return
        value = float(value)
        # ``le`` is inclusive: a value exactly on a boundary lands in
        # that boundary's bucket (bisect_left gives the first bound
        # >= value).
        i = bisect.bisect_left(self._buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def hist_state(self) -> Tuple[List[int], float]:
        with self._lock:
            return list(self._counts), self._sum

    # timing sugar ---------------------------------------------------------
    def time(self) -> "_Timer":
        return _Timer(self)


class _CounterChild(_Child):
    """A counter series is monotone: a negative increment would read as
    a counter reset to ``rate()``/``increase()``, so it is an error
    here, not data."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        super().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        raise TypeError("counters cannot decrease")

    def set(self, value: float) -> None:
        raise TypeError("counters cannot be set")


class _Timer:
    """``with HIST.labels(...).time(): ...`` observes the block wall."""

    def __init__(self, child: _Child):
        self._child = child

    def __enter__(self) -> "_Timer":
        import time
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        import time
        self._child.observe(time.monotonic() - self._t0)


class Metric:
    """A named metric family; label values select concrete children."""

    type: str = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}  # guarded-by: _lock
        if not self.labelnames:
            # Unlabeled metric: one implicit child so .inc()/.set()/
            # .observe() work directly on the family.
            self._default = self._labels(())
        else:
            self._default = None

    def _new_child(self) -> _Child:
        return _Child()

    def _labels(self, values: Tuple[str, ...]) -> _Child:
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def labels(self, *args, **kwargs) -> _Child:
        if args and kwargs:
            raise ValueError(
                f"{self.name}: pass labels positionally or by name, "
                f"not both")
        if kwargs:
            if set(kwargs) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels "
                    f"{list(self.labelnames)}, got {sorted(kwargs)}")
            values = tuple(str(kwargs[n]) for n in self.labelnames)
        else:
            if len(args) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected {len(self.labelnames)} "
                    f"label values {list(self.labelnames)}, "
                    f"got {len(args)}")
            values = tuple(str(a) for a in args)
        return self._labels(values)

    def _require_default(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {list(self.labelnames)}; "
                f"use .labels(...)")
        return self._default

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # rendering ------------------------------------------------------------
    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        for values, child in self.children():
            lines.append(
                f"{self.name}"
                f"{_render_labels(self.labelnames, values)} "
                f"{_format_value(child.value)}")
        return lines

    def snapshot(self) -> dict:
        return {
            "type": self.type,
            "help": self.help,
            "samples": [
                {"labels": dict(zip(self.labelnames, values)),
                 "value": child.value}
                for values, child in self.children()],
        }


class Counter(Metric):
    type = "counter"

    def _new_child(self) -> _Child:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        self._require_default().inc(amount)


class Gauge(Metric):
    type = "gauge"

    def set(self, value: float) -> None:
        self._require_default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._require_default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._require_default().dec(amount)


class Histogram(Metric):
    type = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: need at least one bucket bound")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: duplicate bucket bounds")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self) -> _Child:
        return _Child(buckets=self.buckets)

    def observe(self, value: float) -> None:
        self._require_default().observe(value)

    def time(self) -> "_Timer":
        return self._require_default().time()

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        for values, child in self.children():
            counts, total = child.hist_state()
            cum = 0
            for bound, n in zip(self.buckets, counts):
                cum += n
                lines.append(
                    f"{self.name}_bucket"
                    f"{_render_labels(self.labelnames, values, ('le', _format_value(bound)))}"
                    f" {cum}")
            cum += counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{_render_labels(self.labelnames, values, ('le', '+Inf'))}"
                f" {cum}")
            base = _render_labels(self.labelnames, values)
            lines.append(f"{self.name}_sum{base} {_format_value(total)}")
            lines.append(f"{self.name}_count{base} {cum}")
        return lines

    def snapshot(self) -> dict:
        samples = []
        for values, child in self.children():
            counts, total = child.hist_state()
            cum, by_le = 0, {}
            for bound, n in zip(self.buckets, counts):
                cum += n
                by_le[_format_value(bound)] = cum
            cum += counts[-1]
            by_le["+Inf"] = cum
            samples.append({"labels": dict(zip(self.labelnames, values)),
                            "count": cum, "sum": total,
                            "buckets": by_le})
        return {"type": self.type, "help": self.help, "samples": samples}


class Registry:
    """Process-wide metric store; rendering is the scrape surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}  # guarded-by: _lock

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                raise ValueError(f"metric {metric.name!r} already "
                                 f"registered as {existing.type}")
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (not isinstance(existing, cls)
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        f"type or labels (have {existing.type}"
                        f"{list(existing.labelnames)})")
                if "buckets" in kwargs:
                    bounds = tuple(sorted(
                        float(b) for b in kwargs["buckets"]))
                    if existing.buckets != bounds:
                        raise ValueError(
                            f"metric {name!r} re-declared with "
                            f"different buckets (have "
                            f"{list(existing.buckets)}, got "
                            f"{list(bounds)})")
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition (0.0.4) of every metric."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able dump (bench artifacts, tests)."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        return {m.name: m.snapshot() for m in metrics}

    def reset(self) -> None:
        """Drop every metric (tests only: module-level metric handles
        held by instrumented code keep recording into detached
        families, so production code must never call this)."""
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# Module-level sugar: instrumentation sites declare their metric once at
# import with these (idempotent against double import).
def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Sequence[str] = (),
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def render() -> str:
    return REGISTRY.render()


def write_exposition(handler) -> None:
    """Serve ``GET /metrics`` on a ``BaseHTTPRequestHandler``: render
    the global registry with the 0.0.4 content type. Shared by the
    model server and the API server so exposition details live in ONE
    place."""
    body = render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse text exposition back into ``{family: {"type", "samples"}}``
    where samples is ``[(labels_dict, value)]`` keyed by the SAMPLE name
    (``_bucket``/``_sum``/``_count`` suffixes intact in the labels via
    ``__name__``). Round-trips :meth:`Registry.render`; the CLI metrics
    view and the exposition tests consume it."""
    families: Dict[str, dict] = {}
    ftype = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(None, 3)
            ftype[name] = typ
            families.setdefault(name, {"type": typ, "samples": []})
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            sample_name, rest = line.split("{", 1)
            labels_s, value_s = rest.rsplit("} ", 1)
            labels = {}
            for part in _split_label_pairs(labels_s):
                k, v = part.split("=", 1)
                labels[k] = _unescape_label(v[1:-1])
        else:
            sample_name, value_s = line.rsplit(" ", 1)
            labels = {}
        family = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[:-len(suffix)] \
                if sample_name.endswith(suffix) else None
            if base and ftype.get(base) == "histogram":
                family = base
                labels["__name__"] = sample_name
                break
        families.setdefault(family, {"type": ftype.get(family, "untyped"),
                                     "samples": []})
        families[family]["samples"].append((labels, float(value_s)))
    return families


def _unescape_label(v: str) -> str:
    """Inverse of :func:`_escape_label`. A single left-to-right scan —
    ordered ``str.replace`` chains corrupt values like ``a\\nb``
    (literal backslash + n) by decoding the pair as a newline."""
    out, i = [], 0
    while i < len(v):
        ch = v[i]
        if ch == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _split_label_pairs(s: str) -> List[str]:
    """Split 'a="x",b="y,z"' on commas outside quoted values."""
    parts, buf, in_quote, escaped = [], [], False, False
    for ch in s:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quote = not in_quote
            buf.append(ch)
            continue
        if ch == "," and not in_quote:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return parts
