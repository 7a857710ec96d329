"""Deterministic fault injection for the port's serving path.

A copy of the reference's injector (``skypilot_tpu/chaos/__init__.py``).
Named injection points (``chaos.point("engine.dispatch", seam=...)``)
sit on the replica's serving path: the engine's device dispatch seams
and KV block allocation, QoS admission, the adapter catalog's hot load
and the server's NDJSON stream (catalog in :mod:`.plan`). A fault plan,
JSON with a seed, schedules failures against those points:
fail-N-times, fail with a probability under a seeded PRNG, skip the
first N hits, inject latency. The same plan and seed reproduce the same
injection sequence, and every fired fault records a typed
``chaos.injected`` event, echoed to stderr
(:func:`skypilot_tpu_torch.observability.tracing.add_event`).

Activation, in precedence order:

* programmatic: ``chaos.configure(plan_dict)`` (tests);
* ``SKYTPU_CHAOS_PLAN_JSON``: inline JSON (how a plan crosses process
  boundaries: a replica inherits its controller's env);
* ``SKYTPU_CHAOS_PLAN``: path to a plan file.

With no plan configured, ``chaos.point`` is a no-op costing one
attribute check.

Stdlib-only.
"""

from __future__ import annotations

import builtins
import dataclasses
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.chaos.plan import (KNOWN_POINTS, FaultRule, Plan,
                                           load_plan_file, parse_plan,
                                           unknown_points)
from skypilot_tpu_torch.observability import tracing

ENV_PLAN_JSON = "SKYTPU_CHAOS_PLAN_JSON"
ENV_PLAN = "SKYTPU_CHAOS_PLAN"

__all__ = ["ChaosError", "Injector", "KNOWN_POINTS", "FaultRule", "Plan",
           "SkyTpuError", "active", "configure", "deactivate", "injector",
           "point", "load_plan_file", "parse_plan", "unknown_points"]


class SkyTpuError(Exception):
    """Base of the port's errors a fault plan may name (the reference's
    ``skypilot_tpu.exceptions.SkyTpuError``)."""


class ChaosError(SkyTpuError):
    """Default injected failure (a rule may name any subclass of
    :class:`SkyTpuError` or a builtin exception instead, e.g.
    ``OSError`` for an adapter load the catalog retries)."""


def _subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


def _resolve_error(name: str):
    for cls in _subclasses(SkyTpuError):
        if cls.__name__ == name:
            return cls
    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    return ChaosError


class Injector:
    """Runtime half of a plan: matches point hits against rules, fires
    effects, and keeps the bookkeeping tests assert against:
    ``observed`` (every hit per point, fault or not) and ``fired`` (the
    injection sequence, reproducible per seed)."""

    def __init__(self, plan: Plan):
        # Private rule copies: hits/fired are runtime counters, and a
        # caller re-running the same parsed Plan must start from zero.
        self.plan = Plan(seed=plan.seed, rules=[
            dataclasses.replace(r, hits=0, fired=0) for r in plan.rules])
        self.rng = random.Random(plan.seed)
        self.fired: List[Dict[str, Any]] = []         # guarded-by: _lock
        self.observed: Dict[str, int] = {}            # guarded-by: _lock
        self.observations: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def point(self, name: str, ctx: Dict[str, Any]) -> None:
        sctx = {k: str(v) for k, v in ctx.items()}
        with self._lock:
            self.observed[name] = self.observed.get(name, 0) + 1
            self.observations.append({"point": name, "ctx": sctx})
            rule = self._select(name, sctx)
            if rule is None:
                return
            rule.fired += 1
            rec = {"seq": len(self.fired), "point": name, "ctx": sctx,
                   "effect": rule.effect(), "latency_s": rule.latency_s}
            self.fired.append(rec)
        tracing.add_event(
            "chaos.injected",
            attrs={"point": name, "effect": rec["effect"],
                   "seq": rec["seq"], **{f"ctx.{k}": v
                                         for k, v in sctx.items()}},
            echo=True)
        if rule.latency_s > 0:
            time.sleep(rule.latency_s)
        if rule.error is not None or rule.latency_s <= 0:
            err = _resolve_error(rule.error or "ChaosError")
            msg = rule.message or (
                f"[chaos] injected {rec['effect']} at {name} ({sctx})")
            raise err(msg)

    def _select(self, name: str, sctx: Dict[str, str]
                ) -> Optional[FaultRule]:
        """First rule that fires wins (plan order). The PRNG is drawn
        once per eligible probabilistic hit, in hit order: that is the
        whole determinism contract."""
        for rule in self.plan.rules:
            if rule.point != name:
                continue
            if any(sctx.get(k) != v for k, v in rule.match.items()):
                continue
            rule.hits += 1
            if rule.hits <= rule.after:
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if (rule.probability is not None
                    and self.rng.random() >= rule.probability):
                continue
            return rule
        return None


# Lazily initialized: None = inactive, _UNSET = env not consulted yet.
_UNSET = object()
_injector: Any = _UNSET
_init_lock = threading.Lock()


def _get() -> Optional[Injector]:
    global _injector
    if _injector is _UNSET:
        with _init_lock:
            if _injector is _UNSET:
                _injector = _from_env()
    return _injector


def _from_env() -> Optional[Injector]:
    inline = os.environ.get(ENV_PLAN_JSON)
    path = os.environ.get(ENV_PLAN)
    try:
        if inline:
            return Injector(parse_plan(json.loads(inline)))
        if path:
            return Injector(load_plan_file(path))
    except (OSError, ValueError) as e:
        # A typo'd plan must not poison the serving path (the first
        # point sits inside handlers that would misread a ValueError as
        # a device failure): injection disables, loudly.
        tracing.add_event(
            "chaos.plan_invalid",
            attrs={"source": ENV_PLAN_JSON if inline else ENV_PLAN,
                   "error_type": type(e).__name__,
                   "message": str(e)[:500]},
            echo=True)
        return None
    return None


def point(name: str, **ctx: Any) -> None:
    """Declare a fault-injection point. No-op unless a plan is active;
    an active plan may sleep here (latency fault) or raise (failure
    fault): call sites own surviving exactly the exceptions their layer
    claims to handle."""
    inj = _get()
    if inj is not None:
        inj.point(name, ctx)


def configure(plan: Any) -> Injector:
    """Install a plan programmatically (dict, or a parsed Plan).
    Replaces any active injector; returns the new one."""
    global _injector
    inj = Injector(plan if isinstance(plan, Plan) else parse_plan(plan))
    with _init_lock:
        _injector = inj
    return inj


def deactivate() -> None:
    """Remove the active injector and stop consulting the env
    (:func:`_reset_for_tests` restores lazy env activation)."""
    global _injector
    with _init_lock:
        _injector = None


def _reset_for_tests() -> None:
    global _injector
    with _init_lock:
        _injector = _UNSET


def active() -> bool:
    return _get() is not None


def injector() -> Optional[Injector]:
    """The live injector (tests read ``.fired`` / ``.observed``)."""
    return _get()
