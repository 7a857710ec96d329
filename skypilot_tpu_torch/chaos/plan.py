"""Fault-plan schema: the declarative half of the port's chaos layer.

A copy of ``skypilot_tpu/chaos/plan.py``. A plan is JSON, a seed plus an
ordered list of fault rules, so a chaos run is a reproducible artifact:
the same seed fires the same faults in the same order. The catalog is
the reference's whole catalog, so a plan the controller hands a replica
through ``SKYTPU_CHAOS_PLAN_JSON`` parses the same way on a card
replica; the port's own call sites use the serving points
(``engine.dispatch``, ``kv.alloc``, ``qos.shed``, ``adapter.load``,
``replica.kill``).

Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

# Injection-point catalog, the reference's: every chaos.point() call
# site of either package names one of these (tests/test_torch_chaos.py
# asserts the port's call sites and this catalog agree).
KNOWN_POINTS: Dict[str, str] = {
    "provision.run_instances":
        "instance create/resume, per provider attempt "
        "(ctx: provider, cluster, zone)",
    "provision.stop_instances":
        "instance stop (ctx: provider, cluster, zone)",
    "provision.terminate_instances":
        "instance teardown (ctx: provider, cluster, zone)",
    "provision.query_instances":
        "cloud-side status query (ctx: provider, cluster, zone)",
    "provision.wait_instances":
        "wait-until-ready poll (ctx: provider, cluster, zone)",
    "rpc.transport":
        "cluster RPC transport attempt, client side; ConnectionError "
        "faults ride the transport-failure retry path "
        "(ctx: method, cluster)",
    "jobs.transition":
        "cluster job-queue status write (ctx: status, job_id)",
    "jobs.recovery":
        "managed-job recovery relaunch (ctx: strategy, cluster)",
    "skylet.tick":
        "skylet poll-loop iteration (ctx: cluster)",
    "serve.probe":
        "replica readiness probe; a fault counts as one probe failure "
        "(ctx: service, replica)",
    "serve.lb.forward":
        "load-balancer forward attempt; a fault triggers replica "
        "failover (ctx: backend)",
    "qos.shed":
        "QoS admission decision at the model server and the load "
        "balancer; a fault forces a typed 429 shed for the request "
        "(ctx: tenant, where=server|lb)",
    "adapter.load":
        "adapter-catalog hot-load attempt (checkpoint fetch + device "
        "pool install); a transient fault retries via utils/retry, "
        "exhaustion fails the request typed adapter_load_failed — "
        "never a silent fall-through to the base model (ctx: adapter)",
    "engine.dispatch":
        "inference-engine device dispatch seam (admission wave, "
        "prefill chunk, decode burst, spec verify); a fault surfaces "
        "as a recoverable EngineDispatchError — the server resets the "
        "engine and re-admits every in-flight request through the "
        "preemption resume path, greedy output bit-identical "
        "(ctx: seam=admit|chunk|decode|verify)",
    "kv.alloc":
        "paged KV block allocation (admission claim, lazy per-burst "
        "growth); a fault rides the enclosing dispatch seam's "
        "recovery path (ctx: need)",
    "handoff.transfer":
        "disaggregated prefill->decode KV handoff, per decode-replica "
        "attempt at the load balancer; a fault simulates the decode "
        "replica dying mid-transfer — the export (held in LB memory) "
        "retries on a surviving decode replica, the prefill tier "
        "keeps its refcounted copy, zero requests lost and zero "
        "blocks leaked (ctx: backend)",
    "replica.kill":
        "model-server streaming response mid-flight; a fault drops "
        "the client connection with no terminal chunk — the replica "
        "looks SIGKILLed to the LB, which fails the stream over to a "
        "surviving replica (ctx: route)",
    "train.checkpoint_save":
        "checkpoint save dispatch (ctx: step)",
    "train.checkpoint_restore":
        "checkpoint restore (ctx: step)",
}


@dataclasses.dataclass
class FaultRule:
    """One fault schedule bound to an injection point.

    Selection: a point hit is *eligible* when ``point`` matches and
    every ``match`` key equals the point's context (stringified). The
    first ``after`` eligible hits pass through untouched; then the rule
    fires on each eligible hit — every time by default, with chance
    ``probability`` under the plan's seeded PRNG, at most ``times``
    total. Effect: sleep ``latency_s`` (if set), then raise ``error``
    (unless the rule is latency-only). A rule with neither ``times``
    nor ``probability`` is a standing fault — e.g. a network partition
    of one RPC target — active for the whole run.
    """

    point: str
    match: Dict[str, str] = dataclasses.field(default_factory=dict)
    times: Optional[int] = None       # max fires; None = unlimited
    after: int = 0                    # eligible hits to skip first
    probability: Optional[float] = None   # None = always fire
    latency_s: float = 0.0
    error: Optional[str] = None       # exception name; None + latency
                                      # = latency-only fault
    message: str = ""

    # runtime counters (not part of the schema)
    hits: int = 0
    fired: int = 0

    def effect(self) -> str:
        if self.error is None and self.latency_s > 0:
            return "latency"
        return self.error or "ChaosError"


@dataclasses.dataclass
class Plan:
    seed: int
    rules: List[FaultRule]


_RULE_FIELDS = {"point", "match", "times", "after", "probability",
                "latency_s", "error", "message"}


def parse_plan(raw: Any) -> Plan:
    """Validate a decoded plan dict into a :class:`Plan`; raises
    ``ValueError`` naming the offending rule/field (a typo'd plan must
    fail the run loudly, not silently inject nothing)."""
    if not isinstance(raw, dict):
        raise ValueError(f"chaos plan must be a JSON object, got "
                         f"{type(raw).__name__}")
    unknown_top = set(raw) - {"seed", "faults"}
    if unknown_top:
        raise ValueError(f"chaos plan: unknown keys {sorted(unknown_top)}")
    seed = raw.get("seed", 0)
    if not isinstance(seed, int):
        raise ValueError(f"chaos plan: seed must be an int, got {seed!r}")
    faults = raw.get("faults", [])
    if not isinstance(faults, list):
        raise ValueError("chaos plan: 'faults' must be a list of rules")
    rules: List[FaultRule] = []
    for i, r in enumerate(faults):
        where = f"faults[{i}]"
        if not isinstance(r, dict):
            raise ValueError(f"chaos plan: {where} must be an object")
        unknown = set(r) - _RULE_FIELDS
        if unknown:
            raise ValueError(
                f"chaos plan: {where}: unknown keys {sorted(unknown)}")
        point = r.get("point")
        if not point or not isinstance(point, str):
            raise ValueError(f"chaos plan: {where}: 'point' is required")
        match = r.get("match", {})
        if not isinstance(match, dict):
            raise ValueError(f"chaos plan: {where}: 'match' must be an "
                             f"object of context-key -> value")
        times = r.get("times")
        if times is not None and (not isinstance(times, int) or times < 0):
            raise ValueError(f"chaos plan: {where}: 'times' must be a "
                             f"non-negative int")
        after = r.get("after", 0)
        if not isinstance(after, int) or after < 0:
            raise ValueError(f"chaos plan: {where}: 'after' must be a "
                             f"non-negative int")
        prob = r.get("probability")
        if prob is not None and not (isinstance(prob, (int, float))
                                     and 0.0 <= prob <= 1.0):
            raise ValueError(f"chaos plan: {where}: 'probability' must "
                             f"be in [0, 1]")
        latency = r.get("latency_s", 0.0)
        if not isinstance(latency, (int, float)) or latency < 0:
            raise ValueError(f"chaos plan: {where}: 'latency_s' must be "
                             f"a non-negative number")
        error = r.get("error")
        if error is not None and not isinstance(error, str):
            raise ValueError(f"chaos plan: {where}: 'error' must be an "
                             f"exception class name")
        rules.append(FaultRule(
            point=point, match={k: str(v) for k, v in match.items()},
            times=times, after=after, probability=prob,
            latency_s=float(latency), error=error,
            message=str(r.get("message", ""))))
    return Plan(seed=seed, rules=rules)


def load_plan_file(path: str) -> Plan:
    with open(os.path.expanduser(path), encoding="utf-8") as f:
        return parse_plan(json.load(f))


def unknown_points(plan: Plan) -> List[str]:
    """Rule points absent from the catalog: allowed at runtime (a plan
    may predate a renamed point), but they inject nothing."""
    return sorted({r.point for r in plan.rules
                   if r.point not in KNOWN_POINTS})
