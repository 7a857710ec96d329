"""The port's request forensics (``skypilot_tpu_torch/observability/
forensics.py``) against the JAX package's on the CPU: ``P2Quantile``,
``TailDetector``, ``ExemplarStore``, ``build_ledger`` and
``render_ledger`` give the reference's answers on the same inputs
(``tests/test_forensics.py:25-330``); incident bundles and their GC;
then the port's engine: an exemplar survives ring rollover, and
forensics off is inert."""

import json
import os

import numpy as np
import pytest
import torch

from skypilot_tpu.observability import forensics as jfo
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import flight as tfl
from skypilot_tpu_torch.observability import forensics as tfo
from skypilot_tpu_torch.observability import metrics as tm
from skypilot_tpu_torch.observability import tracing as ttr

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _events_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(ttr.EVENTS_DIR_ENV_VAR, str(tmp_path / "events"))


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 0.999])
def test_p2_equals_the_reference_and_tracks_numpy(q):
    """One seeded lognormal stream through both estimators: the same
    value at every checkpoint, within 8% of numpy's exact quantile at
    the end (q <= 0.99, as the reference holds it)."""
    rng = np.random.default_rng(3)
    xs = rng.lognormal(mean=3.0, sigma=0.6, size=5_000)
    mine, ref = tfo.P2Quantile(q), jfo.P2Quantile(q)
    for i, x in enumerate(xs):
        mine.observe(float(x))
        ref.observe(float(x))
        if i % 997 == 0:
            assert mine.value() == ref.value()
    assert mine.value() == ref.value() and mine.count == len(xs)
    if q <= 0.99:
        assert mine.value() == pytest.approx(
            float(np.percentile(xs, 100 * q)), rel=0.08)


def test_p2_small_stream_and_validation():
    with pytest.raises(ValueError):
        tfo.P2Quantile(1.0)
    est = tfo.P2Quantile(0.9)
    assert est.value() is None
    for x in (5.0, 1.0, 3.0):
        est.observe(x)
    assert est.value() == 5.0


def test_tail_detector_equals_the_reference(monkeypatch):
    monkeypatch.setenv("SKYTPU_TAIL_QUANTILE", "0.9")
    monkeypatch.setenv("SKYTPU_TAIL_MIN_SAMPLES", "10")
    mine, ref = tfo.TailDetector(), jfo.TailDetector()
    assert (mine.quantile, mine.min_samples) == (0.9, 10)
    rng = np.random.default_rng(5)
    for x in rng.lognormal(2.0, 0.8, 400):
        for metric in ("ttft", "tpot"):
            assert mine.observe(metric, float(x)) == \
                ref.observe(metric, float(x))
    assert mine.snapshot() == ref.snapshot()
    crossed, thr = mine.observe("ttft", 1e6)
    assert crossed and thr is not None


def test_exemplar_store_bounded_newest_wins():
    mine, ref = tfo.ExemplarStore(capacity=3), jfo.ExemplarStore(capacity=3)
    for i in range(6):
        for s in (mine, ref):
            s.pin({"rid": i % 2, "metric": "ttft", "value_ms": i,
                   "ledger": {"wall_ms": 1.0}, "records": [{}]})
    assert len(mine) == 3 and mine.get(1)["value_ms"] == 5
    assert mine.get(99) is None
    assert mine.list() == ref.list()
    assert [r["value_ms"] for r in mine.list()] == [5, 4, 3]


_RETIRE = {"burst": "retire", "rids": [1], "submit_s": 100.0,
           "end_s": 100.5, "first_token_s": 100.3,
           "stalls": {"kv_quota": 60.0, "pool_dry": 20.0,
                      "recover": 10.0}, "n_toks": 4}
_LEDGER_CASES = {
    "stalls_and_gaps": [
        _RETIRE,
        {"burst": "chunk", "rids": [1], "ts_s": 100.2, "dur_s": 0.05,
         "seq": 1},
        {"burst": "chunk", "rids": [1], "ts_s": 100.3, "dur_s": 0.05,
         "seq": 2},
        {"burst": "decode", "rids": [1], "ts_s": 100.4, "dur_s": 0.05,
         "seq": 3, "dev_ms_est": 30.0}],
    "spec_and_overlap": [
        _RETIRE,
        {"burst": "wave", "rids": [1, 2], "ts_s": 100.05, "dur_s": 0.05,
         "seq": 1},
        {"burst": "verify", "rids": [1], "ts_s": 100.15, "dur_s": 0.1,
         "seq": 2, "dev_ms_est": 40.0, "overlap_ms": 3.0},
        {"burst": "draft", "rids": [1], "ts_s": 100.17, "dur_s": 0.01,
         "seq": 3},
        {"burst": "preempt", "rids": [1], "ts_s": 100.3, "dur_s": 0.0,
         "seq": 4},
        {"burst": "chunk", "rids": [1], "ts_s": 100.4, "dur_s": 0.02,
         "seq": 5}],
    "no_records": [dict(_RETIRE, stalls={})],
}


@pytest.mark.parametrize("case", sorted(_LEDGER_CASES))
def test_ledgers_equal_the_reference(case):
    recs = _LEDGER_CASES[case]
    led = tfo.build_ledger(recs[0], recs)
    assert led == jfo.build_ledger(recs[0], recs)
    assert tfo.render_ledger(led) == jfo.render_ledger(led)
    assert tfo.ledger_from_records(1, recs) == \
        jfo.ledger_from_records(1, recs)
    assert tfo.records_for(1, recs) == jfo.records_for(1, recs)
    assert sum(p["ms"] for p in led["phases"]) == pytest.approx(
        led["wall_ms"], abs=0.05)
    if case == "no_records":
        assert led["named_ms"] == 0.0 and led["n_records"] == 0
    if case == "stalls_and_gaps":
        ph = {p["phase"]: p["ms"] for p in led["phases"]}
        assert ph["stall_pool_dry"] == pytest.approx(20.0, abs=0.01)
        assert ph["stall_recover"] == pytest.approx(10.0, abs=0.01)


def test_incident_capture_bundle_and_gc(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYTPU_INCIDENTS_KEEP", "2")
    rec = tfl.FlightRecorder()
    rec.record("decode", toks=3)
    store = tfo.ExemplarStore()
    store.pin({"rid": 7, "metric": "ttft"})
    base = str(tmp_path / "inc")
    paths = [tfo.capture_incident(f"rule{i}", {"v": i}, recorder=rec,
                                  exemplars=store, base_dir=base,
                                  force=True) for i in range(3)]
    assert all(paths)
    names = sorted(os.listdir(base))
    assert len(names) == 2 and not any(n.endswith(".tmp") for n in names)
    got = tfo.load_incident(os.path.basename(paths[-1]), base_dir=base)
    files = {f["file"] for f in got["files"]}
    assert {"meta.json", "alert.json", "flight.jsonl", "events.jsonl",
            "metrics.prom", "exemplars.json", "health.json"} <= files
    with open(os.path.join(paths[-1], "exemplars.json")) as f:
        assert json.load(f)[0]["rid"] == 7
    assert [i["rule"] for i in tfo.list_incidents(base_dir=base)] == \
        ["rule2", "rule1"]
    monkeypatch.setenv("SKYTPU_INCIDENTS", "0")
    assert tfo.capture_incident("x", {}, base_dir=base, force=True) is None


def _tiny(**kw):
    cfg = tl.CONFIGS["llama3-tiny"]
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(cfg, gen, device="cpu", dtype=torch.float32)
    return te.InferenceEngine(params, cfg, n_slots=2, max_len=64,
                              prompt_buckets=(16,), device="cpu",
                              **dict(dict(
                                  flight_recorder=tfl.FlightRecorder()),
                                  **kw))


def test_exemplar_survives_ring_rollover(monkeypatch):
    """A request crossing the tail bar pins its ledger and records; the
    pin still answers after the ring rolled past them. A p5 bar makes
    the crossing all but certain whatever the host's timing."""
    monkeypatch.setenv("SKYTPU_TAIL_QUANTILE", "0.05")
    monkeypatch.setenv("SKYTPU_TAIL_MIN_SAMPLES", "5")
    store = tfo.ExemplarStore(capacity=8)
    e = _tiny(flight_recorder=tfl.FlightRecorder(capacity=32),
              exemplar_store=store)
    rid = None
    for _ in range(20):
        i = e.add_request([4, 9, 2], max_new_tokens=3)
        e.run_to_completion(4)
        if store.get(i) is not None:
            rid = i
            break
    assert rid is not None, "no retirement crossed a p5 tail bar"
    ex = store.get(rid)
    assert ex["ledger"]["rid"] == rid and ex["records"]
    assert ex["trace_id"] == next(r for r in e.finished
                                  if r.rid == rid).span_ctx.trace_id
    for _ in range(40):
        e.flight.record("decode", toks=0)
    assert tfo.ledger_from_records(rid, e.flight.tail()) is None
    led = store.get(rid)["ledger"]
    assert sum(p["ms"] for p in led["phases"]) == pytest.approx(
        led["wall_ms"], abs=0.05)
    assert tm.REGISTRY.snapshot()[
        "skytpu_tail_exemplars_pinned_total"]["samples"]


def test_forensics_off_is_inert(monkeypatch):
    """``SKYTPU_FORENSICS=0``: no retire record, no tail observation,
    the same tokens."""
    monkeypatch.setenv("SKYTPU_FORENSICS", "0")
    off = _tiny()
    assert off.forensics is False
    out_off = off.generate([[3, 1, 4], [1, 5, 9, 2]], max_new_tokens=4)
    assert not any(r["burst"] == "retire" for r in off.flight.tail())
    assert off.tail.snapshot()["estimates"]["ttft"]["count"] == 0
    monkeypatch.delenv("SKYTPU_FORENSICS")
    on = _tiny()
    assert on.generate([[3, 1, 4], [1, 5, 9, 2]],
                       max_new_tokens=4) == out_off
    assert sum(r["burst"] == "retire" for r in on.flight.tail()) == 2
