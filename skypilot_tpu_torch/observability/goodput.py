"""Training goodput forensics: the step-phase ledger, cumulative
goodput accounting, the loss/grad anomaly watchdog, and multi-host
straggler attribution for the train loop.

The serving side already answers "where did this request's wall time
go?" (forensics.py) and "what did the device actually do?"
(attribution.py). The train loop had neither: a slow run showed up as
a drifting ``skytpu_train_step_seconds`` histogram with no
decomposition, a NaN loss showed up as a diverging curve hours later,
and on a pod slice nobody could say WHICH host was dragging the
collective. This module closes those gaps with the same design
discipline as the serving stack — host-side bookkeeping only, bounded
state, typed events, and evidence that survives the process:

* :class:`GoodputRecorder` — the per-step flight record (reusing
  :class:`flight.FlightRecorder` with a ``train_step`` burst kind) and
  the cumulative goodput ledger. Each step's wall is decomposed into
  named phases (``data_wait``, ``h2d``, ``compute``, ``ckpt_save``,
  ``ckpt_wait``, ``eval``, ``anomaly_pause``) that sum to the measured
  step wall BY CONSTRUCTION: the remainder is ``host_other``, never
  silence. Across steps, a monotonic cursor attributes every second of
  run wall to exactly one goodput bucket (productive, warmup/compile,
  input-bound, checkpoint stall, restart replay, anomaly pause, eval,
  host other) — :meth:`GoodputRecorder.snapshot` sums to elapsed wall
  exactly, and the cumulative stamps persist in the checkpoint
  directory (``goodput.json``) so the ratio survives restarts instead
  of resetting to 100% after every preemption.

* :class:`AnomalyWatchdog` — streaming NaN/Inf guards (latched: one
  injected NaN batch produces exactly ONE typed ``train.anomaly``
  event, not one per logging interval) plus spike detection over
  loss/grad-norm deltas using the P² quantile estimator the serving
  tail detector already trusts. An anomaly emits the typed event,
  increments ``skytpu_train_anomalies_total{kind}``, and captures a
  :func:`forensics.capture_incident` bundle — the last N step records,
  buffered events, and a metrics snapshot, on disk before the loop
  crashes or the operator notices.

* Straggler attribution — each host publishes its own step wall as
  ``skytpu_train_host_step_seconds{host}``; the aggregate tier
  federates the per-host gauges, and ``skytpu top`` renders
  ``straggler host-K (+N ms)`` from the spread.

The recorder-off run (``SKYTPU_GOODPUT=0``) is the contract:
bit-identical training (the recorder never touches batches or state);
the reference's bench budgets its step-time overhead at 1.01x.

Copy of ``skypilot_tpu/observability/goodput.py``: the same families,
names, labels, record schema, stamps file and renderers, so the
reference's readers (``flight.load_records``, ``ledger_for_step``,
``skytpu train-why``, ``GoodputRecorder.load_stamps``) and its SLO
rules (``train-goodput-floor``) read a port run unchanged. The
aggregate tier, the SLO watchdog and ``skytpu top`` stay the
reference's: they read this module's families over ``/metrics`` and
its records from disk. What differs on the card:

* A "compile" is a program key's first dispatch through the trainer's
  :class:`flight.CompileWatch` (the port has no jit; the first call
  pays kernel-library loads, cuBLAS handles and allocator growth), so
  the warmup step's ``compute`` is ``warmup_compile`` as in the
  reference.
* The device tail of a step. The reference books the ``compute``
  phase's host wall as the step's device time: donated-state
  back-pressure makes a post-warmup jit call's wall converge to the
  device step. An eager CUDA step returns while up to a launch queue's
  worth of kernels is still pending, and that tail would land in the
  next host sync -- the ``eval`` loss fetch -- as badput. So the
  port's train loop (``train/run.py``) ends ``compute`` on the step's
  completion at every step whose loss the logging cadence fetches: it
  records a CUDA event after the step and waits on it inside the
  phase, which moves the sync the fetch pays anyway into ``compute``
  and leaves ``eval`` the scalar fetch alone. Steps the cadence does
  not fetch add no sync (queue back-pressure carries them, as in the
  reference), and with the recorder off the loop waits on nothing.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from skypilot_tpu_torch.observability import attribution, flight, \
    forensics, metrics, tracing

GOODPUT_RATIO = metrics.gauge(
    "skytpu_train_goodput_ratio",
    "Cumulative training goodput: productive (post-warmup compute) "
    "seconds / attributed elapsed wall, including stamps restored from "
    "the checkpoint directory — survives restarts instead of resetting "
    "to 100% after every preemption")
WALL_SECONDS = metrics.counter(
    "skytpu_train_wall_seconds_total",
    "Elapsed train-run wall seconds attributed to goodput buckets "
    "(the goodput denominator; equals the sum of the productive and "
    "unproductive counters by construction)")
PRODUCTIVE_SECONDS = metrics.counter(
    "skytpu_train_productive_seconds_total",
    "Wall seconds spent in post-warmup train-step compute — the "
    "goodput numerator")
UNPRODUCTIVE_SECONDS = metrics.counter(
    "skytpu_train_unproductive_seconds_total",
    "Wall seconds NOT spent in productive compute, by named bucket "
    "(warmup_compile, input_bound, ckpt_stall, restart_replay, "
    "anomaly_pause, eval, host_other)",
    labelnames=("bucket",))
ANOMALIES = metrics.counter(
    "skytpu_train_anomalies_total",
    "Training anomalies detected by the watchdog (non_finite = "
    "NaN/Inf loss or grad, latched per excursion; loss_spike / "
    "grad_spike = delta beyond the spike factor x streaming P2 "
    "quantile)",
    labelnames=("kind",))
HOST_STEP_SECONDS = metrics.gauge(
    "skytpu_train_host_step_seconds",
    "This host's most recent train-step wall seconds — federated "
    "across the slice by the aggregate tier, the spread is the "
    "straggler signal skytpu top renders",
    labelnames=("host",))

# Per-step phases, render order. ``host_other`` is the constructed
# remainder (step wall minus every named phase) — the partition is
# exact by definition, and a fat host_other is itself a finding.
PHASES = ("data_wait", "h2d", "compute", "ckpt_save", "ckpt_wait",
          "eval", "anomaly_pause", "host_other")

# Cumulative goodput buckets, render order. Everything the cursor
# attributes lands in exactly one of these; ``productive`` is the
# goodput numerator and the rest are the named badput decomposition.
BUCKETS = ("productive", "warmup_compile", "input_bound", "ckpt_stall",
           "restart_replay", "anomaly_pause", "eval", "host_other")

# Step phase -> goodput bucket. ``compute`` maps to ``productive``
# except on the warmup step, where the first dispatch's one-time costs
# dominate the call and the whole phase is warmup_compile.
_PHASE_BUCKET = {
    "data_wait": "input_bound",
    "h2d": "input_bound",
    "compute": "productive",
    "ckpt_save": "ckpt_stall",
    "ckpt_wait": "ckpt_stall",
    "eval": "eval",
    "anomaly_pause": "anomaly_pause",
    "host_other": "host_other",
}

STAMPS_FILE = "goodput.json"


def enabled() -> bool:
    """Goodput recording is on unless explicitly disabled
    (``SKYTPU_GOODPUT=0`` — the parity/overhead baseline)."""
    return os.environ.get("SKYTPU_GOODPUT", "1") != "0"


def host_id() -> str:
    """This host's identity in the slice — the runtime env contract's
    host index (``SKYTPU_HOST_ID``), '0' for single-host runs."""
    return os.environ.get("SKYTPU_HOST_ID", "0")


class GoodputRecorder:
    """Per-step phase ledger + cumulative goodput accounting.

    The train loop drives it::

        gp = GoodputRecorder(param_count=cfg.num_params())
        with gp.account("restart_replay"):
            state = mgr.restore(target)          # outside-step bucket
        for step in ...:
            gp.step_start(step)
            with gp.phase("data_wait"):
                batch = next(batches)
            with gp.phase("compute"):
                state, m = step_fn(state, batch)
            gp.step_end(tokens=..., loss=..., grad_norm=...)

    Single-writer by design (the train loop), with a lock guarding the
    cumulative state so the metrics endpoint and tests can snapshot
    concurrently. Two exactness invariants hold at all times:

    * per step: the record's phases sum to its measured wall — the
      remainder is stored as ``host_other``, never dropped;
    * cumulatively: bucket totals sum to attributed elapsed wall
      (``snapshot`` folds the not-yet-attributed residue into
      ``host_other`` on the fly, so the books always balance).
    """

    def __init__(self, recorder: Optional[flight.FlightRecorder] = None,
                 host: Optional[str] = None, param_count: int = 0,
                 watch: Optional[flight.CompileWatch] = None,
                 calibrator: Optional[Any] = None,
                 enable: Optional[bool] = None):
        self.enabled = enabled() if enable is None else bool(enable)
        self.recorder = recorder if recorder is not None \
            else flight.RECORDER
        self.param_count = int(param_count)
        self.watch = watch
        self.calibrator = calibrator
        self._host = host if host is not None else host_id()
        self._lock = threading.Lock()
        now = time.monotonic()
        self._t_start = now
        self._t_last = now                     # guarded-by: _lock
        self._buckets = {b: 0.0 for b in BUCKETS}  # guarded-by: _lock
        self._steps = 0                        # guarded-by: _lock
        self._tokens = 0                       # guarded-by: _lock
        self._prior = {"elapsed_s": 0.0,
                       "buckets": {b: 0.0 for b in BUCKETS},
                       "steps": 0, "tokens": 0}
        # Loop-thread state (the single writer): the open step.
        self._warm = False
        self._step: Optional[int] = None
        self._step_t0 = 0.0
        self._step_ts = 0.0
        self._phases: Dict[str, float] = {}

    # -- cursor attribution (call with _lock held) --------------------------

    def _credit_locked(self, bucket: str, dur: float) -> None:
        if dur <= 0.0:
            return
        self._buckets[bucket] += dur
        WALL_SECONDS.inc(dur)
        if bucket == "productive":
            PRODUCTIVE_SECONDS.inc(dur)
        else:
            UNPRODUCTIVE_SECONDS.labels(bucket=bucket).inc(dur)

    def _advance_locked(self, now: float, bucket: str) -> None:
        self._credit_locked(bucket, now - self._t_last)
        self._t_last = now

    # -- outside-step attribution -------------------------------------------

    @contextlib.contextmanager
    def account(self, bucket: str) -> Iterator[None]:
        """Attribute the body's wall to ``bucket`` (restore ->
        restart_replay, init -> warmup_compile, final save/wait ->
        ckpt_stall). The gap since the last attribution point goes to
        host_other so the cursor never skips time."""
        if bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket: {bucket}")
        if not self.enabled:
            yield
            return
        t_enter = time.monotonic()
        with self._lock:
            self._advance_locked(t_enter, "host_other")
        try:
            yield
        finally:
            now = time.monotonic()
            with self._lock:
                self._advance_locked(now, bucket)

    # -- the per-step ledger -------------------------------------------------

    def step_start(self, step: int) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            # The inter-step gap (logging, loop bookkeeping the caller
            # didn't wrap) is host_other — named phases start inside.
            self._advance_locked(now, "host_other")
        self._step = step
        self._step_t0 = now
        self._step_ts = time.time()
        self._phases = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time one named slice of the open step. Disabled or
        outside a step it is a bare yield — the loop body never
        branches on recorder state."""
        if name not in _PHASE_BUCKET:
            raise ValueError(f"unknown step phase: {name}")
        if not self.enabled or self._step is None:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self._phases[name] = self._phases.get(name, 0.0) + dt

    def step_end(self, tokens: int = 0, loss: Optional[float] = None,
                 grad_norm: Optional[float] = None
                 ) -> Optional[Dict[str, Any]]:
        """Close the open step: build the exact phase partition,
        credit the goodput buckets, publish metrics, and append the
        ``train_step`` flight record. Returns the record (tests/bench
        introspection) or None when disabled."""
        if not self.enabled or self._step is None:
            return None
        now = time.monotonic()
        wall = now - self._step_t0
        phases = dict(self._phases)
        named = sum(phases.values())
        other = wall - named
        if other < 0.0:
            # Clock granularity can make disjoint sub-timers overshoot
            # the outer bracket by an epsilon; the partition stays
            # exact by definition: wall IS the sum.
            other = 0.0
            wall = named
        phases["host_other"] = other
        step, warm = self._step, self._warm
        self._step = None
        self._warm = True

        with self._lock:
            for name in PHASES:
                if name not in phases:
                    continue
                bucket = _PHASE_BUCKET[name]
                if bucket == "productive" and not warm:
                    bucket = "warmup_compile"
                self._credit_locked(bucket, phases[name])
            self._t_last = self._step_t0 + wall
            self._steps += 1
            self._tokens += tokens

        # Device-truth attribution: calibrated EWMA when the trainer's
        # calibrator has sampled this program, else nothing (the
        # warmup step's wall is compile, not execution — estimating
        # from it would poison the device-seconds counter).
        compiled = self.watch.drain_new() if self.watch is not None \
            else []
        dev_ms = None
        if (warm and self.calibrator is not None
                and self.watch is not None
                and self.watch.last_key is not None):
            est = self.calibrator.estimate(self.watch.last_key)
            if est is not None:
                dev_ms = est * 1e3
        if dev_ms is None and warm:
            # The compute phase is the fallback estimate: it ends on
            # the step's completion at fetch steps (the train loop
            # waits on the step's CUDA event there) and is carried by
            # queue back-pressure elsewhere (module docstring).
            dev_ms = phases.get("compute", 0.0) * 1e3
        if dev_ms is not None:
            dev_ms = round(dev_ms, 4)
        flops = 6 * self.param_count * tokens \
            if (self.param_count and tokens) else 0

        # Counters and the record carry the SAME values — the tier-1
        # counter-deltas-match-record-sums gate depends on it.
        if warm and flops:
            attribution.DEVICE_FLOPS.inc(flops)
        if warm and dev_ms:
            attribution.DEVICE_SECONDS.inc(dev_ms / 1e3)
        HOST_STEP_SECONDS.labels(host=self._host).set(wall)
        GOODPUT_RATIO.set(self.snapshot()["goodput_ratio"])

        rec_fields: Dict[str, Any] = {
            "ts_s": self._step_ts, "step": step,
            "dur_s": round(wall, 6),
            "phases": {k: round(v * 1e3, 4) for k, v in phases.items()},
            "toks": tokens, "host": self._host, "warm": warm,
        }
        if warm:
            rec_fields["flops"] = flops
            rec_fields["dev_ms_est"] = dev_ms
        if compiled:
            rec_fields["compiled"] = compiled
        if loss is not None:
            rec_fields["loss"] = loss
        if grad_norm is not None:
            rec_fields["grad_norm"] = grad_norm
        self.recorder.record("train_step", **rec_fields)
        return dict(rec_fields, burst="train_step")

    # -- cumulative accounting ----------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative goodput state including restored stamps. The
        buckets sum to ``elapsed_s`` exactly: the not-yet-attributed
        residue since the last cursor advance folds into host_other."""
        now = time.monotonic()
        with self._lock:
            buckets = dict(self._buckets)
            residue = now - self._t_last
            elapsed = now - self._t_start
            steps, tokens = self._steps, self._tokens
        buckets["host_other"] += max(residue, 0.0)
        prior = self._prior
        total = {b: buckets[b] + prior["buckets"].get(b, 0.0)
                 for b in BUCKETS}
        elapsed_total = elapsed + prior["elapsed_s"]
        ratio = (total["productive"] / elapsed_total
                 if elapsed_total > 0 else 0.0)
        return {
            "host": self._host,
            "elapsed_s": elapsed_total,
            "session_elapsed_s": elapsed,
            "buckets": total,
            "goodput_ratio": ratio,
            "steps": steps + prior["steps"],
            "tokens": tokens + prior["tokens"],
        }

    # -- restart-surviving stamps --------------------------------------------

    def stamps(self) -> Dict[str, Any]:
        snap = self.snapshot()
        return {"version": 1, "elapsed_s": snap["elapsed_s"],
                "buckets": snap["buckets"], "steps": snap["steps"],
                "tokens": snap["tokens"]}

    def persist(self, directory: str) -> bool:
        """Atomically write cumulative stamps next to the checkpoints.
        Best-effort: a bucket-mounted or gs:// dir that rejects posix
        writes must never fail a save."""
        if not self.enabled:
            return False
        data = self.stamps()
        tmp = None
        try:
            os.makedirs(directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=directory,
                                       prefix=STAMPS_FILE + ".")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f)
            os.replace(tmp, os.path.join(directory, STAMPS_FILE))
            return True
        except OSError:
            if tmp is not None:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            return False

    def load_stamps(self, directory: str) -> bool:
        """Fold a previous incarnation's stamps into the cumulative
        totals (call once, before the loop). Missing or corrupt stamps
        are a fresh start, never a crash."""
        try:
            with open(os.path.join(directory, STAMPS_FILE),
                      encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        if not isinstance(data, dict):
            return False
        buckets = data.get("buckets") or {}
        self._prior = {
            "elapsed_s": float(data.get("elapsed_s", 0.0)),
            "buckets": {b: float(buckets.get(b, 0.0)) for b in BUCKETS},
            "steps": int(data.get("steps", 0)),
            "tokens": int(data.get("tokens", 0)),
        }
        return True


# ---------------------------------------------------------------------------
# The loss/grad anomaly watchdog.

class AnomalyWatchdog:
    """Streaming NaN/Inf guards + spike detection over the losses the
    train loop ALREADY fetched (its logging cadence) — the watchdog
    never forces a device sync of its own.

    Non-finite values latch: one NaN excursion emits exactly one typed
    ``train.anomaly`` event and one incident bundle, however many
    logging intervals it spans, and the latch re-arms when values turn
    finite again. Spikes compare each |delta| against ``spike_factor``
    x the streaming P² quantile of PRIOR deltas (compare-then-fold,
    the tail detector's discipline), with a warmup floor and a
    cooldown so a noisy warmup or one excursion cannot storm the event
    log. ``forensics.capture_incident`` applies its own global rate
    limit on top.
    """

    def __init__(self, quantile: float = 0.99,
                 spike_factor: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 cooldown_steps: Optional[int] = None,
                 recorder: Optional[flight.FlightRecorder] = None,
                 goodput: Optional[GoodputRecorder] = None):
        if spike_factor is None:
            try:
                spike_factor = float(os.environ.get(
                    "SKYTPU_ANOMALY_SPIKE_FACTOR", "") or 4.0)
            except ValueError:
                spike_factor = 4.0
        if min_samples is None:
            try:
                min_samples = int(os.environ.get(
                    "SKYTPU_ANOMALY_MIN_SAMPLES", "") or 16)
            except ValueError:
                min_samples = 16
        if cooldown_steps is None:
            try:
                cooldown_steps = int(os.environ.get(
                    "SKYTPU_ANOMALY_COOLDOWN_STEPS", "") or 50)
            except ValueError:
                cooldown_steps = 50
        self.spike_factor = spike_factor
        self.min_samples = max(int(min_samples), 5)
        self.cooldown_steps = max(int(cooldown_steps), 0)
        self.recorder = recorder
        self.goodput = goodput
        self._loss_deltas = forensics.P2Quantile(quantile)
        self._grad_deltas = forensics.P2Quantile(quantile)
        self._last_loss: Optional[float] = None
        self._last_grad: Optional[float] = None
        self._non_finite = False           # the latch
        self._last_anomaly_step: Optional[int] = None

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None
                ) -> Optional[Dict[str, Any]]:
        """Fold one logged (loss, grad_norm) sample in; returns the
        anomaly info dict when one fired, else None."""
        kind = None
        detail: Dict[str, Any] = {}
        bad_loss = not math.isfinite(loss)
        bad_grad = grad_norm is not None and not math.isfinite(grad_norm)
        if bad_loss or bad_grad:
            if self._non_finite:
                return None        # latched: this excursion already fired
            self._non_finite = True
            kind = "non_finite"
            detail["signal"] = "loss" if bad_loss else "grad_norm"
            # NaN/Inf never feed the estimators or the last-value
            # state — a poisoned baseline would mute spike detection
            # for the rest of the run.
        else:
            self._non_finite = False
            in_cooldown = (
                self._last_anomaly_step is not None
                and step - self._last_anomaly_step < self.cooldown_steps)
            if self._last_loss is not None:
                d = abs(loss - self._last_loss)
                thr = self._loss_deltas.value()
                if (not in_cooldown and kind is None
                        and self._loss_deltas.count >= self.min_samples
                        and thr is not None
                        and d > self.spike_factor * max(thr, 1e-12)):
                    kind = "loss_spike"
                    detail.update(delta=round(d, 6),
                                  threshold=round(thr, 6))
                self._loss_deltas.observe(d)
            if grad_norm is not None and self._last_grad is not None:
                d = abs(grad_norm - self._last_grad)
                thr = self._grad_deltas.value()
                if (not in_cooldown and kind is None
                        and self._grad_deltas.count >= self.min_samples
                        and thr is not None
                        and d > self.spike_factor * max(thr, 1e-12)):
                    kind = "grad_spike"
                    detail.update(delta=round(d, 6),
                                  threshold=round(thr, 6))
                self._grad_deltas.observe(d)
            self._last_loss = loss
            if grad_norm is not None:
                self._last_grad = grad_norm
        if kind is None:
            return None
        self._last_anomaly_step = step
        info: Dict[str, Any] = {"kind": kind, "step": step,
                                "loss": loss}
        if grad_norm is not None:
            info["grad_norm"] = grad_norm
        info.update(detail)
        ANOMALIES.labels(kind=kind).inc()
        gp = self.goodput
        if gp is not None and gp.enabled and gp._step is not None:
            # The capture wall is badput with a name: anomaly_pause,
            # not a mystery host_other bump in this step's ledger.
            with gp.phase("anomaly_pause"):
                self._emit(kind, info)
        else:
            self._emit(kind, info)
        return info

    def _emit(self, kind: str, info: Dict[str, Any]) -> None:
        tracing.add_event("train.anomaly", dict(info), echo=True)
        bundle = forensics.capture_incident(
            f"train-anomaly-{kind}", dict(info), recorder=self.recorder)
        if bundle:
            info["incident"] = os.path.basename(bundle)


# ---------------------------------------------------------------------------
# Ledger building + rendering (skytpu train-why, tests).

def train_records(records: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """The ``train_step`` subset of a flight record set."""
    return [r for r in records if r.get("burst") == "train_step"]


def ledger_for_step(records: List[Dict[str, Any]],
                    step: Optional[int] = None
                    ) -> Optional[Dict[str, Any]]:
    """Phase ledger for one recorded step (default: the newest).
    None when the step was never recorded."""
    recs = train_records(records)
    rec = None
    if step is None:
        rec = recs[-1] if recs else None
    else:
        for r in recs:
            if r.get("step") == step:
                rec = r
    if rec is None:
        return None
    wall_ms = float(rec.get("dur_s", 0.0)) * 1e3
    raw = rec.get("phases") or {}
    phases = []
    for name in PHASES:
        if name in raw:
            ms = float(raw[name])
            phases.append({
                "phase": name, "ms": ms,
                "pct": 100.0 * ms / wall_ms if wall_ms else 0.0})
    named_ms = sum(p["ms"] for p in phases
                   if p["phase"] != "host_other")
    return {
        "step": rec.get("step"), "host": rec.get("host"),
        "wall_ms": wall_ms, "phases": phases, "named_ms": named_ms,
        "toks": int(rec.get("toks", 0)), "loss": rec.get("loss"),
        "grad_norm": rec.get("grad_norm"),
        "dev_ms_est": rec.get("dev_ms_est"),
        "compiled": rec.get("compiled") or [],
        "warm": bool(rec.get("warm", True)),
    }


def summarize_steps(records: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Aggregate phase distribution across every recorded step —
    where the RUN's wall went, not just one step's."""
    recs = train_records(records)
    if not recs:
        return None
    totals = {name: 0.0 for name in PHASES}
    wall_ms = 0.0
    toks = 0
    for r in recs:
        wall_ms += float(r.get("dur_s", 0.0)) * 1e3
        toks += int(r.get("toks", 0))
        for name, ms in (r.get("phases") or {}).items():
            if name in totals:
                totals[name] += float(ms)
    phases = [{"phase": n, "ms": totals[n],
               "pct": 100.0 * totals[n] / wall_ms if wall_ms else 0.0}
              for n in PHASES if totals[n] > 0.0]
    return {"steps": len(recs), "wall_ms": wall_ms, "toks": toks,
            "phases": phases,
            "named_ms": sum(p["ms"] for p in phases
                            if p["phase"] != "host_other")}


def render_step_ledger(ledger: Dict[str, Any], width: int = 28) -> str:
    """Human phase table for one step (the forensics ledger's visual
    language: ms, %, a # bar, and the sum-equals-wall footer)."""
    lines = [f"train step {ledger['step']} on host "
             f"{ledger.get('host', '?')}: wall "
             f"{ledger['wall_ms']:.2f} ms"]
    bits = []
    if ledger.get("toks"):
        bits.append(f"toks {ledger['toks']}")
    if ledger.get("loss") is not None:
        bits.append(f"loss {ledger['loss']:.4f}")
    if ledger.get("grad_norm") is not None:
        bits.append(f"grad {ledger['grad_norm']:.4f}")
    if ledger.get("dev_ms_est") is not None:
        bits.append(f"dev {float(ledger['dev_ms_est']):.2f} ms")
    if not ledger.get("warm", True):
        bits.append("WARMUP (compile step)")
    if ledger.get("compiled"):
        bits.append(f"COMPILED x{len(ledger['compiled'])}")
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


def render_summary(summary: Dict[str, Any], width: int = 28) -> str:
    """Human phase table for the whole recorded run."""
    lines = [f"all {summary['steps']} recorded steps: total wall "
             f"{summary['wall_ms']:.2f} ms, toks {summary['toks']}"]
    lines.append(f"  {'phase':<{width}} {'ms':>10} {'%':>6}")
    for ph in summary["phases"]:
        bar = "#" * max(int(round(ph["pct"] / 2.5)), 0)
        lines.append(f"  {ph['phase']:<{width}} {ph['ms']:>10.2f} "
                     f"{ph['pct']:>5.1f}% {bar}")
    named_pct = (100.0 * summary["named_ms"] / summary["wall_ms"]
                 if summary["wall_ms"] else 0.0)
    lines.append(f"  {'named':<{width}} {summary['named_ms']:>10.2f} "
                 f"{named_pct:>5.1f}%")
    return "\n".join(lines)
