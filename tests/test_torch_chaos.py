"""The port's chaos layer (``skypilot_tpu_torch/chaos``) against the
reference's (``skypilot_tpu/chaos``): the same plans parse or fail the
same way, the same plan and seed fire the same sequence, the catalog is
the reference's, every ``chaos.point`` call site of the port names a
cataloged point, and a malformed plan in the environment disables
injection with a ``chaos.plan_invalid`` line on stderr."""

import ast
import json
import pathlib
import time

import pytest

from skypilot_tpu import chaos as jchaos
from skypilot_tpu_torch import chaos

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SKYTPU_CHAOS_PLAN", raising=False)
    monkeypatch.delenv("SKYTPU_CHAOS_PLAN_JSON", raising=False)
    chaos._reset_for_tests()
    jchaos._reset_for_tests()
    yield
    chaos._reset_for_tests()
    jchaos._reset_for_tests()


PLANS = [
    {"seed": 3, "faults": [{"point": "engine.dispatch", "times": 1,
                            "match": {"seam": "verify"}}]},
    {"faults": [{"point": "kv.alloc", "after": 2, "probability": 0.5,
                 "error": "OSError", "message": "m"}]},
    {"seed": 1, "faults": [{"point": "serve.probe", "latency_s": 0.1}]},
    {"seed": 0, "faults": []},
    {},
    {"seed": "nope"},
    {"faults": [{"times": 1}]},
    {"faults": [{"point": "x", "probability": 2}]},
    {"faults": [{"point": "x", "nope": 1}]},
    {"faults": [{"point": "x", "times": -1}]},
    {"faults": [{"point": "x", "after": 1.5}]},
    {"faults": [{"point": "x", "latency_s": -1}]},
    {"faults": [{"point": "x", "error": 3}]},
    {"faults": [{"point": "x", "match": [1]}]},
    {"faults": {"point": "x"}},
    {"faults": ["x"]},
    {"seed": 0, "other": 1},
    [1, 2],
]


@pytest.mark.parametrize("raw", PLANS, ids=lambda r: json.dumps(r)[:40])
def test_parse_plan_accepts_and_rejects_as_the_reference(raw):
    try:
        want = jchaos.parse_plan(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            chaos.parse_plan(raw)
        assert str(got.value) == str(e)
        return
    got = chaos.parse_plan(raw)
    assert got.seed == want.seed
    assert [vars(r) for r in got.rules] == [vars(r) for r in want.rules]


def test_catalog_is_the_references():
    assert chaos.KNOWN_POINTS == jchaos.KNOWN_POINTS
    plan = {"faults": [{"point": "engine.dispatch"}, {"point": "gone"}]}
    assert (chaos.unknown_points(chaos.parse_plan(plan))
            == jchaos.unknown_points(jchaos.parse_plan(plan)) == ["gone"])


def _sequence(mod, plan, hits):
    inj = mod.configure(plan)
    seq = []
    for name, ctx in hits:
        try:
            mod.point(name, **ctx)
            seq.append(".")
        except Exception as e:  # noqa: BLE001 — recorded by type name
            seq.append(type(e).__name__)
    return seq, [(f["seq"], f["point"], f["ctx"], f["effect"])
                 for f in inj.fired], dict(inj.observed)


@pytest.mark.parametrize("seed", [1234, 99])
def test_same_plan_and_seed_fire_as_the_reference(seed):
    """A probabilistic rule, a counted one behind ``after`` with a
    ``match``, and a named builtin error: the port's injector fires the
    reference's sequence hit for hit, and a rerun of the same plan
    repeats it."""
    plan = {"seed": seed, "faults": [
        {"point": "engine.dispatch", "match": {"seam": "decode"},
         "after": 3, "times": 2},
        {"point": "engine.dispatch", "probability": 0.3,
         "error": "ConnectionError"},
        {"point": "adapter.load", "probability": 0.5, "error": "OSError"}]}
    hits = [("engine.dispatch", {"seam": s}) for s in
            ("admit", "decode", "chunk", "decode", "verify") * 8]
    hits += [("adapter.load", {"adapter": f"ft-{i % 3}"}) for i in range(20)]
    want = _sequence(jchaos, plan, hits)
    got = _sequence(chaos, plan, hits)
    assert got == want
    assert "ChaosError" in got[0] and "ConnectionError" in got[0]
    assert _sequence(chaos, plan, hits) == got


def test_named_errors_resolve_to_the_ports_classes():
    class InjectedDeviceFault(chaos.SkyTpuError):
        pass

    for name, cls in (("InjectedDeviceFault", InjectedDeviceFault),
                      ("OSError", OSError), ("NoSuchError", chaos.ChaosError),
                      (None, chaos.ChaosError)):
        rule = {"point": "kv.alloc", "times": 1}
        if name:
            rule["error"] = name
        chaos.configure({"faults": [rule]})
        with pytest.raises(cls):
            chaos.point("kv.alloc", need=1)
        chaos.point("kv.alloc", need=1)       # exhausted


def test_port_call_sites_are_cataloged():
    """Every ``chaos.point`` call in ``skypilot_tpu_torch/`` names a
    cataloged point, and the port injects at the serving points and at
    the train loop's checkpoint save and restore."""
    in_code = set()
    for path in (ROOT / "skypilot_tpu_torch").rglob("*.py"):
        if "chaos" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "point"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "chaos"):
                assert node.args and isinstance(node.args[0], ast.Constant)
                in_code.add(node.args[0].value)
    assert in_code <= set(chaos.KNOWN_POINTS), in_code
    assert in_code == {"engine.dispatch", "kv.alloc", "qos.shed",
                       "adapter.load", "replica.kill",
                       "train.checkpoint_save", "train.checkpoint_restore"}


def test_malformed_env_plan_disables_injection_loudly(monkeypatch, capfd):
    """A typo'd plan never raises into the serving path: injection turns
    off, with one ``chaos.plan_invalid`` line on stderr."""
    monkeypatch.setenv("SKYTPU_CHAOS_PLAN_JSON", "{not json")
    chaos._reset_for_tests()
    chaos.point("engine.dispatch", seam="decode")      # no raise
    assert not chaos.active()
    lines = [json.loads(ln) for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("{")]
    assert [ln["name"] for ln in lines] == ["chaos.plan_invalid"]
    assert lines[0]["attrs"]["source"] == "SKYTPU_CHAOS_PLAN_JSON"
    assert lines[0]["attrs"]["error_type"] == "JSONDecodeError"


def test_env_plans_activate_and_print_injected_events(tmp_path, monkeypatch,
                                                      capfd):
    """An inline plan fires on its matching hit only, once; a plan file
    with a latency-only rule sleeps without raising. Each fired fault
    prints one ``chaos.injected`` line."""
    monkeypatch.setenv("SKYTPU_CHAOS_PLAN_JSON", json.dumps(
        {"seed": 0, "faults": [{"point": "engine.dispatch", "times": 1,
                                "match": {"seam": "verify"}}]}))
    chaos._reset_for_tests()
    assert chaos.active()
    chaos.point("engine.dispatch", seam="decode")
    with pytest.raises(chaos.ChaosError):
        chaos.point("engine.dispatch", seam="verify")
    chaos.point("engine.dispatch", seam="verify")
    assert chaos.injector().observed == {"engine.dispatch": 3}
    monkeypatch.delenv("SKYTPU_CHAOS_PLAN_JSON")
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": [{"point": "replica.kill",
                                            "latency_s": 0.05}]}))
    monkeypatch.setenv("SKYTPU_CHAOS_PLAN", str(path))
    chaos._reset_for_tests()
    t0 = time.monotonic()
    chaos.point("replica.kill", route="/generate")
    assert time.monotonic() - t0 >= 0.04
    events = [json.loads(ln) for ln in capfd.readouterr().err.splitlines()
              if ln.startswith("{")]
    assert [(e["name"], e["attrs"]["effect"]) for e in events] == [
        ("chaos.injected", "ChaosError"), ("chaos.injected", "latency")]
    assert events[0]["attrs"]["ctx.seam"] == "verify"
    chaos.deactivate()
    assert not chaos.active()
