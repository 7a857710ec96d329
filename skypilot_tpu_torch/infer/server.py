"""HTTP model server: the continuous-batching engine behind a stdlib
server.

Counterpart of ``skypilot_tpu/infer/server.py`` for the routes a
replica serves in this slice of the port, with the reference's request
and response JSON keys:

  GET  /health              -> 200 {"status": "ok"} once warm,
                               503 {"status": "warming"} before,
                               503 {"status": "draining"} while draining
  GET  /healthz             -> 200 {"status": "healthy" | "draining" |
                               "degraded", "reason", "last_seen_s"}
  GET  /metrics             -> Prometheus text exposition of the
                               process registry, the reference's metric
                               names (TTFT/TPOT histograms, queue depth,
                               slots, HTTP latencies, QoS counters)
  POST /drain               {"grace_s": s} -> {"draining", "in_flight",
                               "drained", "deadline_s"}; idempotent, the
                               controller polls it until drained
  POST /generate            {"tokens": [...], "max_new_tokens": N}
                            -> {"tokens": [...], "ttft_ms": ..., ...}
  POST /generate + "stream": true
                            -> Transfer-Encoding: chunked, one JSON
                               line per emission ({"tokens": [...]}),
                               closing line {"done": true, ...}
  POST /prefill             {"tokens": [...], "max_new_tokens": N}
                            -> {"committed": [t], "export": {...}, ...}
                               (409 {"type": "handoff_ineligible"})
  POST /handoff             {"tokens", "committed", "export",
                             "max_new_tokens"[, "stream"]} -> as
                            /generate, the committed tokens first
  GET  /debug/flight        ?n=K | ?since=SEQ -> {"records", "seq",
                               "enabled", "programs", "warm",
                               "unexpected", "devtime", "hbm"}: the
                               engine's flight ring, compile watch,
                               device-time estimates and HBM ledger
  GET  /debug/forensics     -> {"enabled", "tail", "exemplars"};
                            ?rid=N -> {"rid", "ledger", "records",
                               "exemplar"} (400 on a bad rid, 404 on one
                               not in the ring or the exemplar store)

A ``traceparent`` header on ``/generate``, ``/prefill`` and ``/handoff``
parents the request's engine spans and flight records to the caller's
trace. The engine's spans, events and flight records flush to
``<SKYPILOT_TPU_HOME>/events/`` from two background threads, where the
reference CLI (``skytpu flight --local``, ``skytpu trace``) reads them.

``/prefill`` and ``/handoff`` are the two tiers of the reference's
disaggregated serving, driven by its load balancer: a prefill-tier
replica runs the prompt to one committed token and exports the stored
prefix's KV blocks (:func:`encode_export`, the reference's wire form); a
decode-tier replica imports them (:func:`decode_export`) and resumes
the prompt plus the committed token through its prefix cache. A port
replica serves either tier, beside the reference's replicas.

Typed errors carry the reference's bodies: 400 ``prompt_too_long`` and
``kv_quota_unsatisfiable``, 404 ``unknown_adapter``, 409
``handoff_ineligible``, 411 ``length_required``, 429 ``rate_limited``
and 503 ``overloaded`` (QoS admission, with ``Retry-After``), 503
``draining`` and 503 ``adapter_load_failed``.

Multi-LoRA (``--adapters '{"name": "ckpt.npz"}'``, or
``SKYTPU_ADAPTERS``): a request names its fine-tune in the
``x-skytpu-model`` header or, failing that, the body's ``model`` (an
empty or whitespace name is the base model) on ``/generate``,
``/prefill`` and ``/handoff``. An unknown name is the typed 404 before
any stream bytes go out; a checkpoint that fails to load is the typed
503 on a blocking request and a typed error chunk on an open stream.
The trailer's ``model`` names the fine-tune that generated the tokens,
and ``/metrics`` carries the ``skytpu_adapter_*`` families. With
``SKYTPU_QOS=1`` the handler sheds by tenant before a request reaches
the engine (``x-skytpu-tenant``, ``x-skytpu-priority`` or the body's
``tenant``/``priority``; ``SKYTPU_QOS_TENANTS`` sets per-tenant rate,
weight, priority and ``max_kv_blocks``), and the engine schedules its
queue by weighted fair queueing and priority lanes, preempting
lower-priority slots. ``--kv-lazy`` grows each slot's KV blocks as its
bursts need rows.

Prompts longer than ``--prefill-chunk`` (512) prefill in chunks, one
chunk between decode bursts; the trailer's ``prefill_chunks`` counts
them. The reference server's other two defaults are on as well: a
prefix cache of ``--prefix-pool`` (8) shared prompt prefixes (trailer:
``cache_hit``, ``cached_tokens``) and n-gram speculation at ``--spec-k``
(4) draft tokens (trailer: ``spec_drafted``, ``spec_accepted``,
``drafter``); ``SKYTPU_PREFIX_POOL`` and ``SKYTPU_SPEC_K`` set the
defaults, the flags win. ``--kv-int8 --weights-int8`` serve the
reference's int8 recipe (``llm/serve-8b-w8a8.yaml``): an int8 KV cache
and w8a8 weights. ``--open-burst``, ``--open-window`` and ``--coalesce``
are the reference's burst and admission-coalescing knobs, so the
recipe's command line runs as it stands. ``--draft-model`` (env
``SKYTPU_DRAFT_MODEL``: ``self:N``, the target's first N layers, or a
config name such as ``llama3-400m`` drawn at random with the target's
vocabulary) puts a draft model's ``model`` rung above the n-gram
drafter (trailer ``drafter``: ``model``, ``ngram`` after a demotion, or
``off``), and ``--spec-pipeline`` (env ``SKYTPU_SPEC_PIPELINE``, default
1) enqueues its next draft burst behind each verify. ``--kv-block 0``
(env ``SKYTPU_KV_BLOCK=0``) serves the contiguous KV layout: one
``max_len`` row per slot, a pool of prefix rows, no handoff (``/prefill``
answers the typed 409 ``handoff_ineligible``, ``/handoff`` resumes cold).

    python -m skypilot_tpu_torch.infer.server --config llama3-8b
    python -m skypilot_tpu_torch.infer.server --config llama3-8b \
        --kv-block 0
    python -m skypilot_tpu_torch.infer.server --config llama3-8b \
        --kv-int8 --weights-int8
    python -m skypilot_tpu_torch.infer.server --config llama3-8b \
        --draft-model llama3-400m --spec-pipeline 1
    python -m skypilot_tpu_torch.infer.server --config llama3-8b \
        --adapters '{"ft-a": "/ckpt/ft-a.npz"}' --adapter-slots 8
    SKYTPU_QOS=1 SKYTPU_QOS_TENANTS='{"free": {"rate": 2}}' \
        python -m skypilot_tpu_torch.infer.server --config llama3-8b \
        --kv-lazy

serves greedy decoding on the CUDA card (``--device cpu`` runs the
plain PyTorch versions on the CPU). ``--warm-grid`` (env
``SKYTPU_WARM_GRID=1``) dispatches every program key once before
``/health`` flips and arms the compile watch (the typed
``server.programs_warmed`` event), so a later new key raises
``engine.unexpected_compile``.

Crash recovery: when a step of the serving loop raises the engine's
recoverable :class:`engine.EngineDispatchError`, the loop calls
``engine.recover()``, which resets the engine and re-admits every
in-flight request through the preemption resume path; open streams
continue with the same tokens, and the trailer's ``recoveries`` counts
the crashes a request survived. A storm guard allows at most
``SKYTPU_RECOVERY_STORM_LIMIT`` (3) recoveries per
``SKYTPU_RECOVERY_STORM_WINDOW_S`` (30) seconds; past it, and for any
other error, the in-flight requests fail and the engine resets (a
failed reset turns ``/health`` to 503). Fault plans (``chaos``,
``SKYTPU_CHAOS_PLAN_JSON`` or ``SKYTPU_CHAOS_PLAN``) reach the engine's
seams, QoS admission, the adapter loader and, with ``replica.kill``,
the NDJSON stream, which then drops the connection with no terminal
chunk.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from socketserver import ThreadingMixIn
from typing import Dict, List, Optional

import torch

from skypilot_tpu_torch import DeviceLike, chaos, resolve_device
from skypilot_tpu_torch.infer import adapters as ad_lib
from skypilot_tpu_torch.infer import draft as draft_lib
from skypilot_tpu_torch.infer import engine as eng
from skypilot_tpu_torch.infer import qos as qos_lib
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import flight as flight_lib
from skypilot_tpu_torch.observability import forensics as forensics_lib
from skypilot_tpu_torch.observability import health as health_lib
from skypilot_tpu_torch.observability import metrics, tracing
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.utils import timeline

# The reference server's metric families (``skypilot_tpu/infer/
# server.py``), same names, types, labels and help.
HTTP_SECONDS = metrics.histogram(
    "skytpu_http_request_seconds",
    "Model-server HTTP request latency (streaming requests span the "
    "full generation)", labelnames=("route",),
    buckets=metrics.latency_buckets())
HTTP_REQUESTS = metrics.counter(
    "skytpu_http_requests_total",
    "Model-server HTTP requests by route and status code",
    labelnames=("route", "code"))
INBOX_DEPTH = metrics.gauge(
    "skytpu_server_inbox_depth",
    "Requests accepted by handler threads, not yet drained into the "
    "engine (queue depth ahead of admission)")
PENDING_REQUESTS = metrics.gauge(
    "skytpu_server_pending_requests",
    "Requests in flight in the serving loop (drained, not finished)")
BURST_FLUSHES = metrics.counter(
    "skytpu_server_burst_flushes_total",
    "Async decode bursts landed (fetched + streamed) by the loop")
WAVE_FLUSH_SECONDS = metrics.histogram(
    "skytpu_server_wave_flush_seconds",
    "Post-admission-wave flush (stream first tokens + re-drain inbox)")
SERVER_DRAINING = metrics.gauge(
    "skytpu_server_draining",
    "1 while this replica is draining (POST /drain received: new "
    "admissions get a typed 503, in-flight requests finish, /healthz "
    "reports 'draining' so the LB and controller stop routing here)")

_KNOWN_ROUTES = frozenset({"/health", "/healthz", "/metrics",
                           "/generate", "/prefill", "/handoff",
                           "/drain", "/debug/flight",
                           "/debug/forensics"})


class _Pending:
    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[Dict] = None
        self.enqueued_s = time.time()
        self.stream = False
        # Streaming: the loop pushes token batches as decoded
        # ({"tokens": [...]}); a {"done"/"error"} dict terminates.
        self.req: Optional[eng.Request] = None
        self.cursor = 0           # tokens already pushed to the stream
        self.chunks: queue.Queue = queue.Queue()
        # /prefill: the finished pass attaches the retired request's
        # stored-prefix export to the result.
        self.export_prefix = False


class ModelServer:
    """Engine + request inbox + batching loop.

    The loop thread is the ONLY thread that touches the engine. Handler
    threads drop (tokens, pending) into an inbox under a small lock and
    wait on their pending's event or chunk queue.
    """

    def __init__(self, engine: eng.InferenceEngine, max_burst: int = 8,
                 open_burst: int = 4, open_window_s: float = 1.0,
                 coalesce_s: float = 0.012,
                 qos: Optional[qos_lib.AdmissionController] = None):
        self.engine = engine
        self.max_burst = max_burst
        # Multi-tenant QoS admission: handler threads run the
        # token-bucket and overload check before a request reaches the
        # inbox; None is the zero-cost path.
        self.qos = qos
        # Admission coalescing: when the inbox yields less than a full
        # wave but a request arrived within ``coalesce_s``, wait a beat
        # (2 ms slices, re-draining) so a burst of arrivals shares one
        # wave instead of splitting into several.
        self.coalesce_s = coalesce_s
        # Burst length while free slots exist and traffic is arriving:
        # a late arrival waits at most one short burst for its prefill.
        # Full bursts run when every slot is busy or no request arrived
        # for ``open_window_s``.
        self.open_burst = min(open_burst, max_burst)
        self.open_window_s = open_window_s
        self._last_arrival = 0.0      # guarded-by: _inbox_lock
        # Double-buffered decode: burst k+1 is dispatched before burst
        # k's tokens are fetched and streamed. Speculative engines run
        # the synchronous path instead: the next verify round's window
        # needs the tokens this one commits, and decode_burst routes to
        # the verify round there.
        self._burst: Optional[eng.BurstHandle] = None
        self._async_decode = not engine.spec_k
        self._inbox_lock = threading.Lock()
        self._inbox: list = []        # guarded-by: _inbox_lock
        self._pending: Dict[int, _Pending] = {}   # loop-thread only
        self._ready = threading.Event()
        self._stop = threading.Event()
        self.warmup_error: Optional[BaseException] = None
        # /healthz detail: "warming" until the warmup ends, "" while
        # serving, a reason after a failed engine reset.
        self.health_reason = "warming"
        # Graceful drain: once draining, new admissions get a typed 503
        # and in-flight requests run to completion; past the deadline
        # the replica self-reports degraded. Written by handler threads,
        # read everywhere (benign unlocked reads, as queue_depth()).
        self._draining = False
        self._drain_deadline_s = 0.0
        # Crash-recovery storm guard: at most ``_storm_limit``
        # recoveries per rolling ``_storm_window_s``, then the fail-all
        # path (a card that keeps crashing needs replacing, not a
        # recover/crash loop that never fails a request visibly).
        self._storm_limit = int(os.environ.get(
            "SKYTPU_RECOVERY_STORM_LIMIT", "3"))
        self._storm_window_s = float(os.environ.get(
            "SKYTPU_RECOVERY_STORM_WINDOW_S", "30"))
        self._recover_times: list = []    # loop-thread only
        # Off-thread flush heartbeats: spans, events and flight records
        # become durable (visible to a separate-process ``skytpu trace``
        # or ``skytpu flight --local``) within ~5 s, and the O(ring)
        # serialization never runs on the serving loop.
        tracing.ensure_flush_thread()
        flight_lib.ensure_flush_thread()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def queue_depth(self) -> int:
        """Inbox + in-flight requests, the overload-shed input (benign
        racy len() reads from handler threads)."""
        return len(self._inbox) + len(self._pending)

    # -- graceful drain ----------------------------------------------------

    def start_drain(self, grace_s: float = 30.0) -> Dict:
        """Enter (or re-poll) the draining state: the first call stamps
        the deadline, repeats report progress, so the controller polls
        ``POST /drain`` until ``drained``."""
        if not self._draining:
            self._draining = True
            self._drain_deadline_s = time.time() + max(grace_s, 0.0)
            SERVER_DRAINING.set(1)
            tracing.add_event(
                "server.draining",
                {"in_flight": self.queue_depth(), "grace_s": grace_s},
                echo=True)
        return self.drain_status()

    def draining(self) -> bool:
        return self._draining

    def drain_status(self) -> Dict:
        depth = self.queue_depth()
        return {
            "draining": self._draining,
            "in_flight": depth,
            "drained": self._draining and depth == 0,
            "deadline_s": round(self._drain_deadline_s, 3),
        }

    def _add(self, tokens, max_new_tokens: int, stream: bool = False,
             trace_ctx=None,
             tenant: str = qos_lib.DEFAULT_TENANT, priority: int = 0,
             adapter: Optional[str] = None, export_prefix: bool = False,
             handoff: Optional[Dict] = None) -> _Pending:
        # Validate eagerly (oversized prompt, unsatisfiable KV quota ->
        # clean 400, unknown adapter -> 404) without touching the
        # engine's mutable state from this thread.
        eng._bucket(len(tokens), self.engine.buckets)
        self.engine.check_kv_quota(tenant, len(tokens), max_new_tokens)
        self.engine.check_adapter(adapter)
        p = _Pending()
        p.stream = stream
        p.export_prefix = export_prefix
        with self._inbox_lock:
            # The caller's trace context rides the inbox: admission
            # runs on the loop thread, which has no ambient context.
            self._inbox.append((list(tokens), max_new_tokens, p,
                                trace_ctx, tenant, priority, adapter,
                                handoff))
            self._last_arrival = time.monotonic()
            INBOX_DEPTH.set(len(self._inbox))
        return p

    def submit(self, tokens, max_new_tokens: int, trace_ctx=None,
               tenant: str = qos_lib.DEFAULT_TENANT, priority: int = 0,
               adapter: Optional[str] = None, export_prefix: bool = False,
               handoff: Optional[Dict] = None) -> Dict:
        """Blocking: the result dict once the request finishes (or
        ``{"error": {...}, "http_status": n}`` when it failed typed).
        ``trace_ctx``: the caller's span (a parsed ``traceparent``).
        ``tenant``/``priority``: the request's QoS identity. ``adapter``:
        the fine-tune (None: the base model).
        ``export_prefix`` (``/prefill``) adds the engine's prefix export
        under ``"export"`` (None when none is resident); ``handoff``
        (``/handoff``: ``{"committed": [...], "export": {...} or None}``)
        imports the export and resumes after the committed tokens."""
        p = self._add(tokens, max_new_tokens, trace_ctx=trace_ctx,
                      tenant=tenant, priority=priority, adapter=adapter,
                      export_prefix=export_prefix, handoff=handoff)
        t0 = time.time()
        p.event.wait()
        out = dict(p.result or {})
        out["total_ms"] = round((time.time() - t0) * 1e3, 2)
        return out

    def submit_stream(self, tokens, max_new_tokens: int, trace_ctx=None,
                      tenant: str = qos_lib.DEFAULT_TENANT,
                      priority: int = 0, adapter: Optional[str] = None,
                      handoff: Optional[Dict] = None):
        """Iterator of chunk dicts: {"tokens": [...]} as decoded, then
        one {"done": true, "ttft_ms": ...} (or {"error": ...}).
        Validation happens before any bytes are written, so an
        oversized prompt or an unknown adapter raises here as a clean
        400/404. ``handoff`` as in :meth:`submit`; the committed tokens
        stream first."""
        p = self._add(tokens, max_new_tokens, stream=True,
                      trace_ctx=trace_ctx, tenant=tenant,
                      priority=priority, adapter=adapter, handoff=handoff)

        def gen():
            while True:
                chunk = p.chunks.get()
                yield chunk
                if "done" in chunk or "error" in chunk:
                    return

        return gen()

    def wait_ready(self, timeout: float) -> None:
        """Block until warm; raise the warmup's error, or on timeout."""
        deadline = time.monotonic() + timeout
        while not self._ready.wait(timeout=0.5):
            if self.warmup_error is not None:
                raise RuntimeError("model server warmup failed") \
                    from self.warmup_error
            if time.monotonic() > deadline:
                raise TimeoutError(f"model server not warm after "
                                   f"{timeout} s")

    def _loop(self) -> None:
        # Warm up before /health flips: the first call pays the kernel
        # build. A failed warmup (a kernel that does not build or
        # launch) stops the loop with /health at 503 and the error kept
        # in ``warmup_error``.
        # The warmup records nothing: its one sample (a kernel build)
        # would skew the serving histograms for the process's life.
        try:
            with metrics.suppress():
                self.engine.generate([[1]], max_new_tokens=2)
        except Exception as e:  # noqa: BLE001 — reported, then stop
            self.warmup_error = e
            self.health_reason = "warmup failed"
            tracing.add_event("server.warmup_failed", {"error": str(e)},
                              echo=True)
            return
        self.engine.finished.clear()
        self.health_reason = ""
        self._ready.set()
        while not self._stop.is_set():
            try:
                busy = self._step()
            except Exception as e:  # noqa: BLE001 — never let the
                # serving thread die while /health reports ok.
                self._burst = None    # a poisoned in-flight burst
                # Recovery first: a typed recoverable dispatch failure
                # resets the engine and re-queues every in-flight
                # request; the _pending entries and their Request
                # objects survive, so open streams continue.
                if self._try_recover(e):
                    continue
                # Unrecoverable (or storming): fail the in-flight
                # requests loudly. The engine's slot state is reset so
                # later requests do not re-drive the poisoned ones; if
                # even the reset fails the card is gone and /health
                # turns 503 before the failures are delivered.
                try:
                    self.engine.reset()
                except Exception as e2:  # noqa: BLE001
                    tracing.add_event("server.engine_reset_failed",
                                      {"error": str(e2)}, echo=True)
                    self.health_reason = "engine reset failed"
                    self._ready.clear()
                for p in self._pending.values():
                    p.result = {"error": f"engine failure: {e!r}"}
                    if p.stream:
                        p.chunks.put({"error": p.result["error"]})
                    p.event.set()
                self._pending.clear()
                PENDING_REQUESTS.set(0)
                busy = False
            if not busy:
                time.sleep(0.002)

    def _try_recover(self, e: BaseException) -> bool:
        """Engine crash recovery for a typed recoverable dispatch
        failure (loop thread only). True when the engine reset and
        re-queued its in-flight requests; False routes to the fail-all
        path (not recoverable, the storm guard tripped, or recover()
        itself failed)."""
        if not (getattr(e, "recoverable", False)
                and hasattr(self.engine, "recover")):
            return False
        now = time.monotonic()
        self._recover_times = [t for t in self._recover_times
                               if now - t < self._storm_window_s]
        if len(self._recover_times) >= self._storm_limit:
            tracing.add_event(
                "server.recovery_storm",
                {"recoveries": len(self._recover_times),
                 "window_s": self._storm_window_s,
                 "error": str(e)}, echo=True)
            return False
        self._recover_times.append(now)
        try:
            n = self.engine.recover(e)
        except Exception as e2:  # noqa: BLE001 — the reset failed; the
            # fail-all path retries it and turns /health to 503.
            tracing.add_event("server.engine_recover_failed",
                              {"error": str(e2)}, echo=True)
            return False
        tracing.add_event(
            "server.engine_recovered",
            {"seam": getattr(e, "seam", None), "victims": n,
             "error": str(e)}, echo=True)
        return True

    def _drain_inbox(self) -> None:
        with self._inbox_lock:
            new, self._inbox = self._inbox, []
            INBOX_DEPTH.set(0)
        for tokens, max_new, p, trace_ctx, tenant, priority, adapter, \
                handoff in new:
            committed = None
            if handoff is not None:
                # Decode tier: install the prefill tier's blocks here
                # (the loop thread is the engine's only user), then
                # admit prompt + committed through the resume path. A
                # failed or skipped import resumes cold, with the same
                # tokens: never an error.
                committed = list(handoff.get("committed") or [])
                export = handoff.get("export")
                if export is not None:
                    try:
                        self.engine.import_prefix(
                            list(tokens) + committed, export,
                            salt=export.get("salt", b""))
                    except Exception as e:  # noqa: BLE001 — cold resume
                        tracing.add_event(
                            "server.handoff_import_failed",
                            {"error": str(e)}, echo=True)
            rid = self.engine.add_request(tokens, max_new, tenant=tenant,
                                          priority=priority, adapter=adapter,
                                          committed=committed,
                                          trace_ctx=trace_ctx)
            p.req = self.engine.waiting[-1]
            # TTFT counts from when the handler enqueued the request.
            p.req.submit_s = p.enqueued_s
            self._pending[rid] = p
        if new:
            PENDING_REQUESTS.set(len(self._pending))

    def _flush_streams(self) -> None:
        """Push newly decoded tokens to every pending stream (diffs
        req.tokens against the cursor)."""
        for p in self._pending.values():
            if p.req is None or not p.stream:
                continue
            new = p.req.tokens[p.cursor:]
            if new:
                p.cursor += len(new)
                p.chunks.put({"tokens": list(new)})

    @timeline.event(name="skytpu_server_wave_flush_seconds",
                    histogram=WAVE_FLUSH_SECONDS)
    def _on_wave(self) -> None:
        # After each admission wave: stream its first tokens, then pull
        # requests that arrived during the wave's prefill into this
        # admission pass.
        self._flush_streams()
        self._drain_inbox()

    def _complete_burst(self) -> None:
        if self._burst is not None:
            handle, self._burst = self._burst, None
            self.engine.complete_decode_burst(handle)
            BURST_FLUSHES.inc()
            self._flush_streams()

    def _step(self) -> bool:
        self._drain_inbox()
        e = self.engine
        if not (e.waiting or e.slot_req or e.chunking
                or self._burst is not None):
            return False
        if e.waiting and e.free_slots:
            target = min(e.max_wave or len(e.free_slots),
                         len(e.free_slots))
            deadline = time.monotonic() + self.coalesce_s
            while (len(e.waiting) < target
                   and time.monotonic() < deadline
                   and time.monotonic() - self._last_arrival
                   < self.coalesce_s):
                time.sleep(0.002)
                self._drain_inbox()
        # Admission has priority over decode, but it needs accurate
        # slot state: the outstanding burst lands first (its
        # retirements may free the slots admission wants).
        if e.waiting:
            self._complete_burst()
            admit = bool(e.free_slots)
            if not admit and e.slot_req and e.qos is not None:
                # Saturated replica: admission is the only path into the
                # engine's priority-preemption pass, so it still runs
                # when a queued request outranks a resident.
                floor = min(r.priority for r in e.slot_req.values())
                admit = any(w.priority > floor for w in e.waiting)
            if admit:
                e.admit(on_wave=self._on_wave)
                self._flush_streams()
        if e.chunking:
            # Chunk -> decode alternation: the outstanding burst lands,
            # ONE prefill chunk runs, then the next burst is dispatched
            # below, so a long prompt stalls the decoding slots for one
            # chunk at a time. The final chunk emits a first token.
            self._complete_burst()
            e.prefill_chunk_step()
            self._flush_streams()
        if e.slot_req:
            quiet = (time.monotonic() - self._last_arrival
                     > self.open_window_s)
            # While a chunked prefill is in flight bursts stay short:
            # the alternation's granularity bounds its TTFT.
            k = (self.max_burst
                 if (not e.free_slots or quiet) and not e.chunking
                 else self.open_burst)
            if self._async_decode:
                nxt = e.dispatch_decode_burst(max_burst=k)
                self._complete_burst()
                self._burst = nxt
            else:
                e.decode_burst(max_burst=k)
                self._flush_streams()
        else:
            self._complete_burst()
        for req in e.finished:
            p = self._pending.pop(req.rid, None)
            if p is None:
                continue
            if req.error is not None:
                # Typed per-request failure (an adapter that did not
                # load): the body rides with the error's HTTP status,
                # and no base-model tokens are served in its place.
                err = dict(req.error)
                status = err.pop("http_status", 500)
                p.result = {"error": err, "http_status": status}
                if p.stream:
                    p.chunks.put({"error": err})
                p.event.set()
                continue
            ttft = ((req.first_token_s - req.submit_s) * 1e3
                    if req.first_token_s is not None else None)
            ttft = round(ttft, 2) if ttft is not None else None
            # The reference trailer's keys.
            stats = {"cache_hit": bool(req.cached_len),
                     "cached_tokens": req.cached_len,
                     "spec_drafted": req.spec_drafted,
                     "spec_accepted": req.spec_accepted,
                     "drafter": req.spec_mode or "off",
                     "preemptions": req.preemptions,
                     "recoveries": req.recoveries}
            p.result = {"tokens": req.tokens, "ttft_ms": ttft,
                        "prefill_chunks": req.n_chunks,
                        "model": req.adapter,
                        **stats}
            if p.export_prefix:
                # /prefill: the stored prefix stays a ref-counted LRU
                # resident here, so a lost handoff leaks nothing; None
                # when it was evicted before the request retired.
                p.result["export"] = e.export_prefix_for(req)
            if p.stream:
                p.chunks.put({"done": True, "ttft_ms": ttft,
                              "n_tokens": len(req.tokens), **stats})
            p.event.set()
        if e.finished:
            PENDING_REQUESTS.set(len(self._pending))
        e.finished.clear()
        return True

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def encode_export(export: Dict) -> Dict:
    """JSON-safe wire form of an engine prefix export (the /prefill
    response body's ``export`` field): block tensors as base64 raw
    bytes + shape/dtype, the adapter salt as base64. bfloat16 scale
    planes widen to float32 on the wire (exact, and the receiver's
    scatter casts back), so every wire dtype is plain numpy."""
    import base64

    import numpy as np
    tensors = {}
    for name, arr in export["tensors"].items():
        arr = np.ascontiguousarray(arr)
        if str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        tensors[name] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "data": base64.b64encode(arr.tobytes()).decode()}
    return {"cached_len": int(export["cached_len"]),
            "kv_block": int(export["kv_block"]),
            "n_blocks": int(export["n_blocks"]),
            "salt": base64.b64encode(export.get("salt")
                                     or b"").decode(),
            "tensors": tensors}


def decode_export(wire: Dict) -> Dict:
    """Inverse of :func:`encode_export` — the dict
    ``InferenceEngine.import_prefix`` consumes. Raises ValueError /
    KeyError / TypeError on malformed wire payloads (the /handoff
    handler maps those to a 400)."""
    import base64

    import numpy as np
    tensors = {}
    for name, spec in wire["tensors"].items():
        arr = np.frombuffer(
            base64.b64decode(spec["data"]),
            dtype=np.dtype(str(spec["dtype"]))).reshape(
                [int(d) for d in spec["shape"]])
        tensors[str(name)] = arr
    return {"cached_len": int(wire["cached_len"]),
            "kv_block": int(wire["kv_block"]),
            "n_blocks": int(wire["n_blocks"]),
            "salt": base64.b64decode(wire.get("salt") or ""),
            "tensors": tensors}


class _Threading(ThreadingMixIn, HTTPServer):
    daemon_threads = True
    # A burst of concurrent clients overflows the default listen
    # backlog of 5 -> connection resets under load.
    request_queue_size = 128


def make_handler(model: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _observe(self, code: int) -> None:
            route = self.path.split("?", 1)[0]
            if route not in _KNOWN_ROUTES:
                # Label children are never evicted; scanner paths must
                # not mint unbounded series.
                route = "other"
            HTTP_REQUESTS.labels(route=route, code=str(code)).inc()
            t0 = getattr(self, "_t0", None)
            if t0 is not None:
                HTTP_SECONDS.labels(route=route).observe(
                    time.monotonic() - t0)
                self._t0 = None

        def _json(self, code, obj, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
            self._observe(code)

        def do_GET(self):
            self._t0 = time.monotonic()
            if self.path == "/health":
                if model._draining:
                    # 503 stops the LB and controller routing here; the
                    # in-flight work continues.
                    return self._json(503, {"status": "draining"},
                                      headers={"Retry-After": "1"})
                if model._ready.is_set():
                    return self._json(200, {"status": "ok"})
                return self._json(503, {"status": "warming"})
            if self.path == "/healthz":
                # Always 200 (the probe succeeded); the status carries
                # the verdict.
                if model._draining:
                    depth = model.queue_depth()
                    past = (depth > 0
                            and time.time() > model._drain_deadline_s)
                    health_lib.write_healthz(
                        self,
                        health_lib.DEGRADED if past
                        else health_lib.DRAINING,
                        reason=(f"draining past deadline "
                                f"({depth} in flight)" if past
                                else f"draining ({depth} in flight)"))
                    return self._observe(200)
                ready = model._ready.is_set()
                health_lib.write_healthz(
                    self,
                    health_lib.HEALTHY if ready else health_lib.DEGRADED,
                    reason=model.health_reason)
                return self._observe(200)
            if self.path == "/metrics":
                metrics.write_exposition(self)
                return self._observe(200)
            route, _, query = self.path.partition("?")
            if route == "/debug/flight":
                return self._debug_flight(query)
            if route == "/debug/forensics":
                return self._debug_forensics(query)
            return self._json(404, {"error": "not found"})

        def _debug_flight(self, query: str):
            """Burst-level introspection, the reference's body: the
            engine's live flight ring (``?n=`` caps the tail, default 128;
            ``?since=<seq>`` returns only newer records), the compile
            watch's registry, the calibrated device-time estimates and
            the HBM ledger."""
            from urllib.parse import parse_qs
            qs = parse_qs(query)
            n, since = 128, None
            try:
                n = max(int(qs.get("n", ["128"])[0]), 1)
            except ValueError:
                pass
            try:
                if "since" in qs:
                    since = int(qs["since"][0])
            except ValueError:
                pass
            e = model.engine
            fl, watch = e.flight, e.compile_watch
            records = fl.since(since) if since is not None else fl.tail(n)
            return self._json(200, {
                "records": records, "seq": fl.seq(),
                "enabled": bool(fl.enabled),
                "programs": watch.summary(), "warm": watch.warm,
                "unexpected": watch.unexpected,
                "devtime": e.devtime.summary(),
                "hbm": e.hbm_ledger.snapshot()})

        def _debug_forensics(self, query: str):
            """Request forensics, the reference's body: bare, the tail
            estimates and pinned exemplars; ``?rid=N``, that request's
            critical-path ledger from the live ring (or its pinned
            exemplar once the ring rolled over), what ``skytpu why``
            renders."""
            from urllib.parse import parse_qs
            qs = parse_qs(query)
            rid = None
            try:
                if "rid" in qs:
                    rid = int(qs["rid"][0])
            except ValueError:
                return self._json(400, {"error": "bad rid"})
            e = model.engine
            if rid is None:
                return self._json(200, {
                    "enabled": bool(e.forensics),
                    "tail": e.tail.snapshot(),
                    "exemplars": e.exemplars.list()})
            recs = e.flight.tail()
            ledger = forensics_lib.ledger_from_records(rid, recs)
            records = forensics_lib.records_for(rid, recs)
            exemplar = e.exemplars.get(rid)
            if ledger is None and exemplar is not None:
                ledger = exemplar.get("ledger")
                records = exemplar.get("records") or []
            if ledger is None:
                return self._json(404, {
                    "error": f"no retired request {rid} in the flight "
                             f"ring or exemplar store"})
            return self._json(200, {"rid": rid, "ledger": ledger,
                                    "records": records,
                                    "exemplar": exemplar is not None})

        def _stream(self, chunks):
            """Chunked NDJSON: tokens flow as the engine decodes them."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            code = 200
            try:
                for chunk in chunks:
                    # Chaos: a replica.kill fault drops the connection
                    # mid-stream with no terminal chunk; to the load
                    # balancer the replica died, and it fails the stream
                    # over to a survivor.
                    chaos.point("replica.kill", route="/generate")
                    data = json.dumps(chunk).encode() + b"\n"
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            except chaos.ChaosError:
                code = 500
                self.close_connection = True
                return
            except ConnectionError:
                # Client went away mid-stream: 499 (client closed
                # request), not a success.
                code = 499
                return
            finally:
                self._observe(code)
            try:
                self.wfile.write(b"0\r\n\r\n")
            except ConnectionError:
                pass

        def _bad_request(self, e):
            # Client errors carry a typed body and status where the
            # engine minted one (prompt too long, unsatisfiable KV
            # quota, unknown adapter).
            return self._json(
                getattr(e, "http_status", 400),
                {"error": getattr(e, "typed_error", None) or str(e)})

        def do_POST(self):
            self._t0 = time.monotonic()
            if "chunked" in (self.headers.get("Transfer-Encoding")
                             or "").lower():
                # No Content-Length: the body cannot be read, and an
                # unread body would corrupt the next keep-alive request.
                self.close_connection = True
                return self._json(411, {"error": {
                    "type": "length_required",
                    "message": "chunked request bodies are not "
                               "supported; send Content-Length"}})
            length = int(self.headers.get("Content-Length") or 0)
            body_bytes = self.rfile.read(length)
            if self.path == "/drain":
                try:
                    body = json.loads(body_bytes or b"{}")
                    grace = float(body.get("grace_s", 30.0))
                except (ValueError, TypeError, AttributeError):
                    return self._json(400,
                                      {"error": "bad drain request"})
                return self._json(200, model.start_drain(grace))
            if self.path not in ("/generate", "/prefill", "/handoff"):
                return self._json(404, {"error": "not found"})
            if model._draining:
                # Typed drain shed (the body was consumed above): the
                # LB retries on a surviving replica, direct clients back
                # off per Retry-After.
                return self._json(
                    503,
                    {"error": {
                        "type": "draining",
                        "message": "replica is draining; retry "
                                   "against another replica"}},
                    headers={"Retry-After": "1"})
            try:
                body = json.loads(body_bytes or b"{}")
                tokens = [int(t) for t in body["tokens"]]
                max_new = int(body.get("max_new_tokens", 64))
                stream = bool(body.get("stream", False))
                # The fine-tune: the header first, the body's ``model``
                # (the SDK path) as the fallback, the order the LB
                # resolves in. Stripped, cut to 128 characters; empty
                # or whitespace is the base model at both tiers.
                model_name = (self.headers.get(ad_lib.MODEL_HEADER)
                              or body.get("model"))
                model_name = (str(model_name).strip()[:128] or None
                              if model_name else None)
            except (ValueError, TypeError, KeyError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            # The caller's trace: a malformed header starts a fresh one.
            trace_ctx = tracing.parse_traceparent(
                self.headers.get("traceparent"))
            # QoS: identity from header or body, then the token-bucket
            # and overload check before any engine state is touched; a
            # shed is a typed 429/503 with Retry-After.
            tenant, priority = qos_lib.request_identity(
                self.headers, body,
                cfg=model.qos.cfg if model.qos is not None else None)
            if model.qos is not None:
                try:
                    model.qos.admit(tenant, depth=model.queue_depth())
                except qos_lib.ShedError as e:
                    return self._json(
                        e.http_status, {"error": e.typed_error},
                        headers={"Retry-After": e.retry_after_header()})
            who = {"tenant": tenant, "priority": priority,
                   "adapter": model_name, "trace_ctx": trace_ctx}
            if self.path == "/prefill":
                return self._prefill(tokens, max_new, who)
            handoff = None
            if self.path == "/handoff":
                # Decode tier: import the prefill tier's blocks, then
                # resume prompt + committed; the committed tokens
                # stream first (cursor 0), so the client's TTFT is the
                # prefill tier's.
                try:
                    handoff = {
                        "committed": [int(t) for t in
                                      body.get("committed") or []],
                        "export": (decode_export(body["export"])
                                   if body.get("export") else None)}
                except (ValueError, TypeError, KeyError) as e:
                    return self._json(400,
                                      {"error": f"bad handoff: {e}"})
            try:
                if stream:
                    return self._stream(model.submit_stream(
                        tokens, max_new, handoff=handoff, **who))
                out = model.submit(tokens, max_new, handoff=handoff, **who)
            except ValueError as e:   # oversized prompt, KV quota, 404
                return self._bad_request(e)
            if "error" in out:
                return self._json(out.pop("http_status", 500), out)
            return self._json(200, out)

        def _prefill(self, tokens, max_new, who):
            """Prefill tier: run the request to ONE committed token and
            return it with the stored prefix's export; the load
            balancer hands both to a decode replica. A request that
            cannot hand off, or whose prefix was evicted before the
            export, gets the typed 409 the balancer answers by serving
            it single-tier."""
            if not model.engine.handoff_eligible(tokens, max_new):
                return self._json(409, {"error": {
                    "type": "handoff_ineligible",
                    "message": "request cannot hand off (prompt "
                               "shorter than one prefill chunk, "
                               "single-token budget, or prefix "
                               "cache off); route single-tier"}})
            try:
                out = model.submit(tokens, 1, export_prefix=True, **who)
            except ValueError as e:
                return self._bad_request(e)
            if "error" in out:
                return self._json(out.pop("http_status", 500), out)
            export = out.pop("export", None)
            if export is None:
                return self._json(409, {"error": {
                    "type": "handoff_ineligible",
                    "message": "prefix evicted before export "
                               "(pool pressure); route single-tier"}})
            out["committed"] = out.pop("tokens")
            out["export"] = encode_export(export)
            return self._json(200, out)

        def log_message(self, *a):
            pass

    return Handler


def serve(engine: eng.InferenceEngine, host: str = "0.0.0.0",
          port: int = 8080, max_burst: int = 8, open_burst: int = 4,
          open_window_s: float = 1.0, coalesce_s: float = 0.012,
          qos: Optional[qos_lib.AdmissionController] = None):
    model = ModelServer(engine, max_burst=max_burst, open_burst=open_burst,
                        open_window_s=open_window_s, coalesce_s=coalesce_s,
                        qos=qos)
    httpd = _Threading((host, port), make_handler(model))
    return model, httpd


def warm_grid(engine: eng.InferenceEngine, max_burst: int = 8) -> int:
    """``--warm-grid``: dispatch every program key once before
    ``/health`` can flip, then arm the compile watch; emits the typed
    ``server.programs_warmed`` event. Returns the keys warmed."""
    t0 = time.time()
    n = engine.warm_programs(max_burst=max_burst)
    engine.declare_warmup_complete()
    tracing.add_event(
        "server.programs_warmed",
        {"programs": n, "warm_s": round(time.time() - t0, 2)}, echo=True)
    return n


def make_engine(config: str, slots: int = 16, max_len: int = 1024,
                admit_wave: int = 8, kv_block: Optional[int] = None,
                kv_blocks: Optional[int] = None, span_buckets=None,
                prefill_chunk: int = 512, prefix_pool: int = 8,
                spec_k: int = 4, temperature: float = 0.0,
                kv_int8: bool = False, weights_int8: bool = False,
                kv_lazy: Optional[bool] = None,
                qos: Optional[qos_lib.FairScheduler] = None,
                device: DeviceLike = None,
                seed: int = 0, adapters: Optional[str] = None,
                adapter_slots: Optional[int] = None,
                adapter_rank: Optional[int] = None,
                draft_model: Optional[str] = None,
                spec_pipeline: Optional[bool] = None, tp: int = 1
                ) -> eng.InferenceEngine:
    """The serving engine ``main()`` runs: ``config``'s model with
    random weights drawn in ``cfg.dtype`` on ``device`` from ``seed``,
    paged KV of ``kv_block``-row blocks (None reads ``SKYTPU_KV_BLOCK``,
    default 256; 0 the contiguous layout) and ``kv_blocks`` blocks (None
    for one max_len row per slot),
    prompt buckets (128, 512, max_len), chunked prefill above
    ``prefill_chunk`` tokens, a prefix cache of ``prefix_pool`` entries
    and ``spec_k``-token n-gram speculation (0 disables each), the
    reference server's defaults; ``temperature`` 0 decodes greedily.
    ``span_buckets``: the span ladder (None the default, 0 off).
    ``kv_int8``: an int8 KV cache; ``weights_int8``: w8a8 weights,
    quantized once on ``device`` from the drawn weights, whose float
    copies are then dropped. ``kv_lazy``: lazy KV growth (None reads
    ``SKYTPU_KV_LAZY``); ``qos``: the engine's fair scheduler.
    ``adapters`` (JSON ``{name: checkpoint}``), ``adapter_slots`` and
    ``adapter_rank``: the multi-LoRA catalog through
    :func:`adapters.catalog_from_env` (None each: ``SKYTPU_ADAPTERS``,
    ``SKYTPU_ADAPTER_SLOTS``, ``SKYTPU_ADAPTER_RANK``). ``draft_model``:
    the model drafter through :func:`draft.draft_engine_from_env` (None:
    ``SKYTPU_DRAFT_MODEL``; its pool int8 under ``kv_int8``), built
    before the engine drops the float tree, as the reference builds it;
    ``spec_pipeline``: the engine's (None: ``SKYTPU_SPEC_PIPELINE``).
    ``tp`` above 1: the engine over the tp group :func:`tp_devices`, its
    weights drawn straight into their shards
    (``InferenceEngine.sharded_init``); a ``self:N`` draft then takes
    the first N layers gathered whole onto the first device."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[config]
    spec = (draft_model if draft_model is not None
            else os.environ.get("SKYTPU_DRAFT_MODEL", "")).strip()
    mesh = tp_devices(tp, dev) if tp > 1 else None
    catalog = ad_lib.catalog_from_env(cfg, adapters_json=adapters,
                                      slots=adapter_slots,
                                      rank=adapter_rank, device=dev)
    if mesh is not None:
        # Drawn into their shards: a model that fits only split never
        # exists whole on one device.
        params = eng.InferenceEngine.sharded_init(cfg, mesh, seed)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    draft_params = params
    if mesh is not None and spec.startswith("self:"):
        n = int(spec.split(":", 1)[1])
        draft_params = sharding.gather_tree(
            sharding.Shards(dict(p, blocks={k: w[:n] for k, w in
                                            p["blocks"].items()})
                            for p in params),
            llama.param_logical_axes(cfg), dev)
    draft = draft_lib.draft_engine_from_env(
        draft_params, cfg, n_slots=slots, max_len=max_len, spec=spec,
        kv_int8=kv_int8, device=dev)
    if weights_int8 and spec.startswith("self:"):
        # A self:N draft keeps the float slices of its N layers, as the
        # reference's does; as views they would keep the whole float
        # tree resident after the engine drops it. A named config's
        # draft owns its weights already.
        draft.params = dict(draft.params, blocks={
            n: w.clone() for n, w in draft.params["blocks"].items()})
    buckets = tuple(sorted({min(128, max_len), min(512, max_len),
                            max_len}))
    engine = eng.InferenceEngine(
        params, cfg, n_slots=slots, max_len=max_len,
        prompt_buckets=buckets,
        sampling_params=sampling.SamplingParams(temperature=temperature),
        max_wave=admit_wave, kv_block=kv_block, kv_blocks=kv_blocks,
        span_buckets=span_buckets, prefill_chunk=prefill_chunk,
        prefix_pool=prefix_pool, spec_k=spec_k, kv_int8=kv_int8,
        weights_int8=weights_int8, device=None if mesh else dev, seed=seed,
        kv_lazy=kv_lazy, qos=qos, adapters=catalog, draft_engine=draft,
        spec_pipeline=spec_pipeline, mesh=mesh)
    # Under weights_int8 the engine keeps only the slim tree; this
    # reference must go too, or the float block matrices stay resident.
    del params
    return engine


def tp_devices(tp: int, device: DeviceLike = None) -> List[torch.device]:
    """The tp group ``--tp`` serves on: the first ``tp`` cards
    (``cuda:0`` .. ``cuda:tp-1``), or ``tp`` shards of the CPU when
    ``device`` is the CPU. Fewer cards than ``tp`` exit with the
    reference's message."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * tp
    found = torch.cuda.device_count()
    if found < tp:
        raise SystemExit(f"--tp {tp} needs {tp} devices, found {found}")
    return [torch.device(dev.type, i) for i in range(tp)]


def _span_buckets(arg: Optional[str]):
    """``--span-buckets``: None (unset) -> the engine's default ladder
    (or ``SKYTPU_SPAN_BUCKETS``); "0" -> off; a comma list -> that
    ladder."""
    if arg is None:
        env = os.environ.get("SKYTPU_SPAN_BUCKETS", "").strip()
        if not env:
            return None
        arg = env
    rungs = [int(t) for t in arg.replace(",", " ").split()]
    return [r for r in rungs if r > 0] or 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="llama3-8b",
                    choices=sorted(llama.CONFIGS))
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-burst", type=int, default=8,
                    help="decode tokens per device call")
    ap.add_argument("--open-burst", type=int, default=4,
                    help="decode burst while free slots remain AND "
                         "traffic arrived within --open-window — keeps "
                         "late arrivals from waiting out a full burst "
                         "before their prefill")
    ap.add_argument("--open-window", type=float, default=1.0,
                    help="seconds since the last arrival during which "
                         "bursts stay short when slots are free; after "
                         "a quiet spell bursts go long (dispatch "
                         "amortization on a partially loaded server)")
    ap.add_argument("--admit-wave", type=int, default=8,
                    help="admission wave cap (0 = uncapped)")
    ap.add_argument("--coalesce", type=float, default=0.012,
                    help="seconds to wait for a filling admission wave "
                         "when the newest arrival is fresher than this "
                         "(prevents 1-row waves on bursts)")
    ap.add_argument("--kv-block", type=int, default=None,
                    help="paged KV cache block length: slots rent "
                         "blocks of this many rows instead of a "
                         "contiguous max-len row (0 = contiguous "
                         "layout; default env SKYTPU_KV_BLOCK or 256)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV pool size in blocks (default env "
                         "SKYTPU_KV_BLOCKS, or one max-len row per "
                         "slot: slots*max_len/block)")
    ap.add_argument("--span-buckets", default=None,
                    help="span-bucketed decode attention: comma-"
                         "separated ladder of KV-row spans (each "
                         "decode/verify/chunk call reads only that many "
                         "rows, so decode bandwidth tracks the active "
                         "span, not --max-len). Default: max_len/8,/4,/2 "
                         "ladder (env SKYTPU_SPAN_BUCKETS); 0 disables "
                         "(full-view reads only)")
    ap.add_argument("--kv-lazy", action="store_true", default=None,
                    help="lazy paged-KV growth: admission reserves "
                         "prompt + one burst of blocks instead of "
                         "the full max_new_tokens worst case; the "
                         "rest allocates at burst dispatch (dry pool "
                         "= the slot sits a burst out). Default env "
                         "SKYTPU_KV_LAZY; eager reservation is the "
                         "default")
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="prefill prompts longer than this in chunks of "
                         "this many tokens between decode bursts "
                         "(0 = off)")
    ap.add_argument("--prefix-pool", type=int,
                    default=int(os.environ.get("SKYTPU_PREFIX_POOL", "8")
                                or 0),
                    help="prefix KV cache: resident prompt prefixes, kept "
                         "as shared blocks, for suffix-only prefill "
                         "(0 = off; default env SKYTPU_PREFIX_POOL or 8)")
    ap.add_argument("--spec-k", type=int,
                    default=int(os.environ.get("SKYTPU_SPEC_K", "4")
                                or 0),
                    help="speculative decoding: n-gram draft tokens per "
                         "slot verified in one round (0 = off; default "
                         "env SKYTPU_SPEC_K or 4)")
    ap.add_argument("--draft-model", default=None,
                    help="model-backed speculative drafter: 'self:N' "
                         "(truncated-layer draft sharing the target's "
                         "first N blocks — zero extra weights) or a "
                         "llama config name (e.g. llama3-400m; a "
                         "distilled checkpoint's config). The draft "
                         "model runs the engine's own staged-burst "
                         "program on its own paged KV, advanced/"
                         "rolled-back in lockstep with the verifier; "
                         "unset = the n-gram drafter only (env "
                         "SKYTPU_DRAFT_MODEL)")
    ap.add_argument("--spec-pipeline", type=int, default=None,
                    help="async draft/verify pipeline (model drafter "
                         "only): 1 = dispatch the next round's draft "
                         "rollout while the verify is in flight, "
                         "reconciling on fetch; 0 = synchronous "
                         "draft-then-verify (default env "
                         "SKYTPU_SPEC_PIPELINE or 1)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache: int8 rows with a bfloat16 scale "
                         "per row and kv-head")
    ap.add_argument("--weights-int8", action="store_true",
                    help="w8a8: int8 block matrices and head, int8 "
                         "activations per token")
    ap.add_argument("--adapters", default=None,
                    help="multi-LoRA adapter catalog: JSON object of "
                         "{name: checkpoint path} (adapters.save_"
                         "adapter .npz files). Requests pick a "
                         "fine-tune via the body's 'model' field or "
                         "the x-skytpu-model header; unknown names "
                         "get a typed 404. Default env "
                         "SKYTPU_ADAPTERS (how the serve controller "
                         "hands a replica its catalog)")
    ap.add_argument("--adapter-slots", type=int, default=None,
                    help="device adapter-pool capacity (fine-tunes "
                         "resident at once; LRU hot-load/evict past "
                         "it; default env SKYTPU_ADAPTER_SLOTS or 8)")
    ap.add_argument("--adapter-rank", type=int, default=None,
                    help="adapter-pool LoRA rank (lower-rank "
                         "checkpoints zero-pad; default env "
                         "SKYTPU_ADAPTER_RANK or 16)")
    ap.add_argument("--warm-grid", action="store_true",
                    default=os.environ.get("SKYTPU_WARM_GRID") == "1",
                    help="dispatch the engine's whole program grid once "
                         "at startup and arm the compile watch: any "
                         "later new program key is a mid-traffic "
                         "first dispatch and raises the typed "
                         "engine.unexpected_compile alarm + "
                         "skytpu_unexpected_compiles_total (env "
                         "SKYTPU_WARM_GRID=1)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard weights + KV "
                         "cache over the first N local devices "
                         "(Megatron head/mlp/vocab split — serves "
                         "models bigger than one card's memory); with "
                         "--device cpu, N shards on the CPU")
    ap.add_argument("--device", default=None,
                    help="cuda (the default, the card) or cpu")
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error("--tp must be at least 1")
    # A long-lived daemon: sever any inherited trace root, or every
    # headerless request would attach its spans to the launch's trace.
    # Requests that carry their own traceparent are unaffected.
    os.environ.pop(tracing.ENV_VAR, None)
    tracing.set_process_name("model-server")
    kv_blocks = args.kv_blocks
    if kv_blocks is None:
        kv_blocks = int(os.environ.get("SKYTPU_KV_BLOCKS", "0") or 0)
    engine = make_engine(args.config, slots=args.slots,
                         max_len=args.max_len, admit_wave=args.admit_wave,
                         kv_block=args.kv_block, kv_blocks=kv_blocks,
                         span_buckets=_span_buckets(args.span_buckets),
                         prefill_chunk=args.prefill_chunk,
                         prefix_pool=args.prefix_pool,
                         spec_k=args.spec_k, temperature=args.temperature,
                         kv_int8=args.kv_int8,
                         weights_int8=args.weights_int8,
                         kv_lazy=args.kv_lazy,
                         qos=qos_lib.scheduler_from_env(),
                         device=args.device, adapters=args.adapters,
                         adapter_slots=args.adapter_slots,
                         adapter_rank=args.adapter_rank,
                         draft_model=args.draft_model,
                         spec_pipeline=(bool(args.spec_pipeline)
                                        if args.spec_pipeline is not None
                                        else None),
                         tp=args.tp)
    if args.warm_grid:
        warm_grid(engine, args.max_burst)
    model, httpd = serve(engine, port=args.port, max_burst=args.max_burst,
                         open_burst=args.open_burst,
                         open_window_s=args.open_window,
                         coalesce_s=args.coalesce,
                         qos=qos_lib.admission_from_env("server"))
    tracing.add_event("server.listening",
                      {"port": args.port, "device": str(engine.device)},
                      echo=True)
    try:
        httpd.serve_forever()
    finally:
        model.shutdown()


if __name__ == "__main__":
    main()
