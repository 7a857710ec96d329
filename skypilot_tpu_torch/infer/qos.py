"""Multi-tenant QoS: admission control, weighted fair queueing,
priority lanes.

Three host-side pieces protect a serving fleet from a hot tenant
(ROADMAP item 4 — nothing here touches a device program, so tenant
count can never enter program identity):

* :class:`AdmissionController` — per-tenant token-bucket rate limits
  plus a queue-depth overload check, shared by the model server and
  the load balancer. A shed is TYPED: :class:`RateLimitedError` maps
  to HTTP 429 (``{"type": "rate_limited", "retry_after_ms": ...}``),
  :class:`OverloadedError` to HTTP 503 (``{"type": "overloaded"}``) —
  clients back off deterministically instead of parsing prose.

* :class:`FairScheduler` — deficit-round-robin over per-tenant
  subqueues of the engine's ``waiting`` deque, weighted by configured
  tenant weight and costed in TOKENS (prompt + committed + budget), so
  one tenant's hundred queued requests cannot starve a neighbor's one.
  Priority lanes sort strictly above the DRR interleave; WFQ applies
  within a lane. The scheduler only REORDERS the deque before an
  admission pass — bucketed waves, chunked claims and span regrouping
  downstream are untouched.

* Priority preemption-by-eviction lives in the engine
  (:meth:`InferenceEngine.preempt_slot`): the scheduler here just puts
  the outranking request at the head so admission finds it first.

Tenant identity comes from a request header (``SKYTPU_TENANT_HEADER``,
default ``x-skytpu-tenant``) or the request body's ``tenant`` field
(the SDK path); priority from ``x-skytpu-priority`` / ``priority``.
Tenants are client-supplied strings, so every metric label rides
:func:`tenant_label`, which caps the live label set and collapses the
overflow into ``other`` — a scanner must not mint unbounded series.

Config (env): ``SKYTPU_QOS=1`` enables, ``SKYTPU_QOS_RATE`` /
``SKYTPU_QOS_BURST`` set the default per-tenant bucket,
``SKYTPU_QOS_MAX_WAITING`` the overload shed depth,
``SKYTPU_QOS_QUANTUM`` the DRR quantum (tokens), and
``SKYTPU_QOS_TENANTS`` a JSON object of per-tenant overrides
(``{"free-tier": {"rate": 2, "burst": 4, "weight": 1,
"priority": -1}}``).

Copy of ``skypilot_tpu/infer/qos.py`` with the reference's env names,
typed bodies, headers and metric families; the ``qos.shed`` chaos point
in :meth:`AdmissionController.admit` turns an injected fault into a
typed shed with reason ``injected``. One deliberate difference: the
port has no tracing layer, so a malformed ``SKYTPU_QOS_TENANTS`` falls
back to the defaults with a line on stderr instead of a
``qos.tenants_invalid`` event.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from skypilot_tpu_torch import chaos
from skypilot_tpu_torch.observability import metrics, tracing

DEFAULT_TENANT = "default"
TENANT_HEADER_ENV = "SKYTPU_TENANT_HEADER"
DEFAULT_TENANT_HEADER = "x-skytpu-tenant"
PRIORITY_HEADER = "x-skytpu-priority"

QOS_REQUESTS = metrics.counter(
    "skytpu_qos_requests_total",
    "Requests admitted past QoS admission control, by tenant "
    "(label set capped; overflow tenants collapse into 'other') and "
    "tier — LB-admitted requests are admitted AGAIN at the server, so "
    "fleet req/s must read one tier, not the sum",
    labelnames=("tenant", "where"))
QOS_SHED = metrics.counter(
    "skytpu_qos_shed_total",
    "Requests load-shed by QoS admission control, by tenant, reason "
    "(rate_limited | overloaded | injected) and tier (server | lb)",
    labelnames=("tenant", "reason", "where"))
QOS_PREEMPTIONS = metrics.counter(
    "skytpu_qos_preemptions_total",
    "Decode slots preempted-by-eviction for a higher-priority "
    "request, by the VICTIM's tenant",
    labelnames=("tenant",))
QOS_TENANTS = metrics.gauge(
    "skytpu_qos_tenants",
    "Distinct tenant label values currently tracked (capped — the "
    "cap, not the true tenant cardinality, bounds this)")

# Metric-label cap: tenants are client-supplied strings and label
# children are never evicted — past the cap everything reads 'other'.
_MAX_TENANT_LABELS = 32
_label_lock = threading.Lock()
_labels_seen: set = set()        # guarded-by: _label_lock

# Bucket-table key for post-cap strangers: a sentinel OBJECT, not the
# string "other" — a real tenant named "other" must keep its own
# bucket, not pool quota with every overflow stranger.
_OVERFLOW_BUCKET_KEY = object()


def retry_after_header(retry_after_s: float) -> str:
    """The ``Retry-After`` header value (integer seconds, ceiling,
    min 1) — one implementation so the LB and the model server cannot
    drift apart on the same shed."""
    return str(max(int(retry_after_s + 0.999), 1))


def tenant_label(tenant: str, cfg: Optional["QosConfig"] = None) -> str:
    """The metric-label value for a tenant: itself while the live
    label set is under the cap, ``other`` past it. A CONFIGURED
    tenant bypasses the cap for the same reason it bypasses the
    bucket-table cap: the cap defends against scanner-minted names,
    and config — not scanners — bounds real tenants. Without the
    bypass, 32 throwaway names seen at startup would permanently
    collapse the operator's own tenants into ``other``."""
    with _label_lock:
        if tenant in _labels_seen:
            return tenant
        if (len(_labels_seen) >= _MAX_TENANT_LABELS
                and not (cfg is not None and tenant in cfg.tenants)):
            return "other"
        _labels_seen.add(tenant)
        QOS_TENANTS.set(len(_labels_seen))
        return tenant


def _reset_labels_for_tests() -> None:
    with _label_lock:
        _labels_seen.clear()


class ShedError(Exception):
    """Base of the typed load-shed family: carries the HTTP status and
    the ``typed_error`` body the server/LB return verbatim (the
    PromptTooLongError idiom — a shed is the caller's signal to back
    off, never a 500)."""

    http_status = 503

    def __init__(self, message: str, typed_error: Dict[str, Any],
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.typed_error = typed_error
        self.retry_after_s = retry_after_s

    def retry_after_header(self) -> str:
        return retry_after_header(self.retry_after_s)


class RateLimitedError(ShedError):
    """Tenant over its token-bucket rate -> HTTP 429."""

    http_status = 429

    def __init__(self, tenant: str, retry_after_s: float,
                 reason: str = "rate_limited"):
        msg = (f"tenant {tenant!r} over its request rate; retry in "
               f"{retry_after_s:.2f}s")
        super().__init__(msg, {
            "type": "rate_limited",
            "tenant": tenant,
            "retry_after_ms": int(retry_after_s * 1000),
            "message": msg,
        }, retry_after_s=retry_after_s)
        self.tenant = tenant
        self.reason = reason


class OverloadedError(ShedError):
    """Queue depth past the shed threshold -> HTTP 503."""

    def __init__(self, depth: int, max_waiting: int):
        msg = (f"server overloaded: {depth} queued requests "
               f"(shed threshold {max_waiting})")
        super().__init__(msg, {
            "type": "overloaded",
            "queued": depth,
            "max_waiting": max_waiting,
            "message": msg,
        }, retry_after_s=1.0)


class TokenBucket:
    """Classic token bucket; not thread-safe (the owner holds the
    lock). ``take`` returns 0.0 when a token was consumed, else the
    seconds until one accrues (the typed 429's Retry-After)."""

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.last_s = time.monotonic() if now is None else now

    def take(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        # max(..., 0): a caller-supplied clock must never bank debt.
        self.tokens = min(self.burst, self.tokens
                          + max(now - self.last_s, 0.0) * self.rate)
        self.last_s = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if self.rate <= 0.0:
            return 1.0
        return (1.0 - self.tokens) / self.rate


@dataclasses.dataclass
class TenantSpec:
    """Per-tenant QoS knobs. ``rate`` 0 = unlimited; ``weight`` scales
    the tenant's DRR share; ``priority`` is the default lane for the
    tenant's requests (a per-request header may override);
    ``max_kv_blocks`` caps the paged KV blocks the tenant's resident
    slots may reference at once (0 = unlimited) — the engine stalls
    the tenant's admissions at the cap (typed ``qos.kv_quota_stall``,
    never a 503) so a hot tenant cannot hog the block pool via long
    contexts while rate-limited."""

    rate: float = 0.0
    burst: float = 0.0           # 0 -> max(2 * rate, 4)
    weight: int = 1
    priority: int = 0
    max_kv_blocks: int = 0

    def bucket_burst(self) -> float:
        return self.burst if self.burst > 0 else max(2 * self.rate, 4.0)


@dataclasses.dataclass
class QosConfig:
    """The env-derived QoS policy shared by server, LB and engine."""

    enabled: bool = False
    default_rate: float = 0.0        # req/s per tenant; 0 = unlimited
    default_burst: float = 0.0
    max_waiting: int = 0             # queued requests before 503; 0 = off
    quantum: int = 256               # DRR quantum, in tokens
    tenants: Dict[str, TenantSpec] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def from_env(cls) -> "QosConfig":
        def _f(name, default):
            try:
                return float(os.environ.get(name, "") or default)
            except ValueError:
                return default
        tenants: Dict[str, TenantSpec] = {}
        raw = os.environ.get("SKYTPU_QOS_TENANTS", "").strip()
        if raw:
            try:
                for name, spec in json.loads(raw).items():
                    tenants[str(name)] = TenantSpec(
                        rate=float(spec.get("rate", 0.0)),
                        burst=float(spec.get("burst", 0.0)),
                        weight=max(int(spec.get("weight", 1)), 1),
                        priority=int(spec.get("priority", 0)),
                        max_kv_blocks=max(
                            int(spec.get("max_kv_blocks", 0)), 0))
            except (ValueError, TypeError, AttributeError):
                # A typo'd override must not silently disable QoS for
                # every tenant; fall back to the defaults, loudly.
                tracing.add_event("qos.tenants_invalid",
                                  {"raw": raw[:200]}, echo=True)
                tenants = {}
        return cls(
            enabled=os.environ.get("SKYTPU_QOS", "") == "1",
            default_rate=_f("SKYTPU_QOS_RATE", 0.0),
            default_burst=_f("SKYTPU_QOS_BURST", 0.0),
            max_waiting=int(_f("SKYTPU_QOS_MAX_WAITING", 0)),
            quantum=max(int(_f("SKYTPU_QOS_QUANTUM", 256)), 1),
            tenants=tenants)

    def tenant(self, name: str) -> TenantSpec:
        spec = self.tenants.get(name)
        if spec is not None:
            return spec
        return TenantSpec(rate=self.default_rate,
                          burst=self.default_burst)


def tenant_header() -> str:
    return (os.environ.get(TENANT_HEADER_ENV, "").strip().lower()
            or DEFAULT_TENANT_HEADER)


def request_identity(headers, body: Optional[Dict[str, Any]] = None,
                     cfg: Optional[QosConfig] = None
                     ) -> Tuple[str, int]:
    """(tenant, priority) for one request: header first, then the
    body's ``tenant``/``priority`` fields (the SDK path), then the
    tenant's configured default lane. Tenant strings are capped at 64
    chars; priority clamps to [-9, 9]. Whenever a QoS config is in
    force the tenant's lane (configured spec, else the default spec)
    is also a ceiling — a request may deprioritize itself, but a
    client-supplied header must never outrank the operator's lane
    (priority gates preemption rights; the hostile hot tenant this
    module defends against must not control them, and minting a fresh
    unconfigured tenant name must not be the escape hatch)."""
    tenant = None
    prio_raw = None
    if headers is not None:
        tenant = headers.get(tenant_header())
        prio_raw = headers.get(PRIORITY_HEADER)
    if not tenant and isinstance(body, dict):
        tenant = body.get("tenant")
    if prio_raw is None and isinstance(body, dict):
        prio_raw = body.get("priority")
    # Strip BEFORE the emptiness check: a whitespace-only header value
    # must read as the default tenant, not mint a tenant="" series,
    # bucket and DRR lane of its own.
    tenant = (str(tenant).strip()[:64] if tenant else "") or DEFAULT_TENANT
    if prio_raw is None and cfg is not None:
        priority = cfg.tenant(tenant).priority
    else:
        try:
            priority = int(prio_raw) if prio_raw is not None else 0
        except (TypeError, ValueError):
            priority = 0
        if cfg is not None:
            priority = min(priority, cfg.tenant(tenant).priority)
    return tenant, max(-9, min(priority, 9))


class AdmissionController:
    """Token-bucket admission + overload shed; thread-safe (handler
    threads call :meth:`admit` concurrently)."""

    def __init__(self, cfg: QosConfig, where: str = "server"):
        self.cfg = cfg
        self.where = where
        self._lock = threading.Lock()
        self._buckets: Dict[Any, TokenBucket] = {}  # guarded-by: _lock

    def _shed(self, tenant: str, reason: str, err: ShedError):
        QOS_SHED.labels(tenant=tenant_label(tenant, self.cfg),
                        reason=reason, where=self.where).inc()
        raise err

    def admit(self, tenant: str, depth: Optional[int] = None) -> None:
        """Admit one request or raise the typed shed. ``depth`` is the
        caller's queue depth (inbox + in-flight) for the overload
        check; None skips it (the LB has no queue)."""
        try:
            chaos.point("qos.shed", tenant=tenant, where=self.where)
        except Exception:  # noqa: BLE001 — an injected fault IS a shed
            self._shed(tenant, "injected",
                       RateLimitedError(tenant, 1.0, reason="injected"))
        if (self.cfg.max_waiting and depth is not None
                and depth >= self.cfg.max_waiting):
            self._shed(tenant, "overloaded",
                       OverloadedError(depth, self.cfg.max_waiting))
        spec = self.cfg.tenant(tenant)
        if spec.rate > 0:
            with self._lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    # Bucket table is bounded like the label set: past
                    # the cap, UNCONFIGURED tenants share one 'other'
                    # bucket at the default spec (they already share
                    # its metric label). Explicitly configured tenants
                    # always get their own bucket — the config, not a
                    # scanner minting throwaway names, bounds those —
                    # so a paid tenant first seen past the cap is never
                    # throttled to the strangers' shared quota.
                    if (tenant not in self.cfg.tenants
                            and len(self._buckets) >= _MAX_TENANT_LABELS):
                        bucket = self._buckets.get(_OVERFLOW_BUCKET_KEY)
                        if bucket is None:
                            bucket = TokenBucket(spec.rate,
                                                 spec.bucket_burst())
                            self._buckets[_OVERFLOW_BUCKET_KEY] = bucket
                    else:
                        bucket = TokenBucket(spec.rate,
                                             spec.bucket_burst())
                        self._buckets[tenant] = bucket
                wait_s = bucket.take()
            if wait_s > 0:
                self._shed(tenant, "rate_limited",
                           RateLimitedError(tenant, wait_s))
        QOS_REQUESTS.labels(tenant=tenant_label(tenant, self.cfg),
                            where=self.where).inc()


class FairScheduler:
    """Deficit-round-robin reorder of the engine's ``waiting`` deque.

    Called by the engine at the top of each admission pass (loop
    thread only — no locking needed). Requests split into
    ``(priority, tenant)`` lanes preserving per-tenant FIFO; lanes
    emit highest priority first, and within a priority level tenants
    interleave by DRR — each round a tenant's deficit grows by
    ``min(quantum, cheapest queued head) * weight`` tokens and it
    releases queued requests while the head request's token cost fits
    (the cap keeps rotation request-granular when the configured
    quantum dwarfs the workload's request cost). Cost is the request's KV
    footprint (prompt + committed tokens + remaining budget), so
    fairness is over the resource requests actually consume, not
    request count. The rotation start follows SERVICE: each call
    observes which requests left the queue since the last one (the
    claim loop consumes the head, so a missing request was admitted)
    and starts the next round at the tenant after the last one
    served. A pass that admits nothing must not advance the rotation
    — admission capacity frees on the engine's schedule, and a
    counter that ticks per CALL can land the same tenant at the
    front on exactly the passes that claim, starving the other lane
    deterministically.
    """

    def __init__(self, cfg: Optional[QosConfig] = None,
                 quantum: Optional[int] = None):
        self.cfg = cfg or QosConfig(enabled=True)
        self.quantum = int(quantum if quantum is not None
                           else self.cfg.quantum)
        # Last reorder's output as (rid, priority, tenant), head
        # first; diffed against the live deque to observe admissions.
        self._prev_order: List[Tuple[int, int, str]] = []
        self._last_served: Dict[int, str] = {}   # priority -> tenant

    def weight(self, tenant: str) -> int:
        w = self.cfg.tenant(tenant).weight      # already an int (config)
        return w if w > 1 else 1

    def request_cost(self, req) -> int:
        """Token footprint of one queued request (its DRR cost)."""
        return max(len(req.prompt) + len(req.tokens)
                   + req.max_new_tokens, 1)

    def reorder(self, waiting: Deque) -> None:
        """Rebuild ``waiting`` in (priority lane, DRR) order, in
        place. Pure host bookkeeping over request lists."""
        # Observe service since the last pass: a request gone from the
        # deque was claimed off the head — iterating the previous
        # output head-first leaves the LAST tenant served per lane,
        # which the rotation below starts after.
        if self._prev_order:
            present = {r.rid for r in waiting}
            for rid, prio, tenant in self._prev_order:
                if rid not in present:
                    self._last_served[prio] = tenant
        if len(waiting) < 2:
            self._prev_order = [(r.rid, r.priority, r.tenant)
                                for r in waiting]
            return
        lanes: Dict[Tuple[int, str], List] = {}
        tenant_order: Dict[int, List[str]] = {}
        for r in waiting:
            key = (r.priority, r.tenant)
            if key not in lanes:
                lanes[key] = []
                tenant_order.setdefault(r.priority, []).append(r.tenant)
            lanes[key].append(r)
        if len(lanes) < 2:
            self._prev_order = [(r.rid, r.priority, r.tenant)
                                for r in waiting]
            return                      # one lane: FIFO already fair
        out: List = []
        for prio in sorted(tenant_order, reverse=True):
            tenants = tenant_order[prio]
            last = self._last_served.get(prio)
            start = ((tenants.index(last) + 1) % len(tenants)
                     if last in tenants else 0)
            tenants = tenants[start:] + tenants[:start]
            queues = {t: lanes[(prio, t)] for t in tenants}
            heads = {t: 0 for t in tenants}
            deficit = {t: 0 for t in tenants}
            remaining = sum(len(q) for q in queues.values())
            while remaining:
                # Per-round top-up: the configured quantum capped at the
                # cheapest head still queued this round. A fleet quantum
                # sized for production prompts must not let one lane's
                # first top-up drain its whole queue ahead of a small
                # workload's other tenants; the cap keeps rotation
                # request-granular at any cost scale while weights stay
                # token-proportional, and it guarantees the cheapest
                # head's lane releases every round (the loop is O(n)
                # rounds, not cost-ratio-many).
                step = min([self.quantum]
                           + [self.request_cost(queues[t][heads[t]])
                              for t in tenants
                              if heads[t] < len(queues[t])])
                for t in tenants:
                    q, i = queues[t], heads[t]
                    if i >= len(q):
                        deficit[t] = 0
                        continue
                    deficit[t] += step * self.weight(t)
                    while i < len(q) and \
                            self.request_cost(q[i]) <= deficit[t]:
                        deficit[t] -= self.request_cost(q[i])
                        out.append(q[i])
                        i += 1
                        remaining -= 1
                    heads[t] = i
        waiting.clear()
        waiting.extend(out)
        self._prev_order = [(r.rid, r.priority, r.tenant) for r in out]


def admission_from_env(where: str = "server"
                       ) -> Optional[AdmissionController]:
    """The process's admission controller, or None when QoS is off
    (``SKYTPU_QOS`` != 1) — a None policy is the zero-cost path."""
    cfg = QosConfig.from_env()
    if not cfg.enabled:
        return None
    return AdmissionController(cfg, where=where)


def scheduler_from_env() -> Optional[FairScheduler]:
    """The engine's fair scheduler, or None when QoS is off."""
    cfg = QosConfig.from_env()
    if not cfg.enabled:
        return None
    return FairScheduler(cfg)
