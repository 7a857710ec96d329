"""The port's flight recorder and compile watch
(``skypilot_tpu_torch/observability/flight.py``) and the engine's
records, against the JAX package on the CPU.

Host units: the ring, thread safety, suppression, the disabled
recorder, the env switch, flush and load, the compile watch's keys and
alarm, ``summarize``/``render_table``/``as_spans`` equal to the
reference's on the same records (``tests/test_flight.py:24-160``).

Engine parity, float32 at llama3-tiny: the port's engine and the JAX
engine (its Pallas paged kernel in interpret mode, ``kv_kernel=True``,
the program the port's kernel path is held to) run the reference's
flown workload (``tests/test_flight.py:161-200``) and its chunk/verify
interleave (``:336``); their record sequences are equal record for
record on ``burst``, ``rids``, ``slots``, ``toks``, ``stall``,
``drafted``, ``accepted``, ``cow``, ``evictions``, ``lazy_grows``,
``program.k``, ``program.span``, ``program.final``, ``program.bucket``
and ``program.attn``, the retire records on their request fields, and
the roofline's FLOPs and bytes on every record but the waves. What the
documented differences change, and is therefore not compared:
``program.rows`` and the waves' FLOPs and bytes (the JAX engine pads a
wave to ``max_wave`` rows; the port dispatches each at its own size),
``compiled`` (program keys: the port's carry its real wave rows and no
spare slot), and every timing (``ts_s``, ``dur_s``,
``dispatch_wall_ms``, ``fetch_wall_ms``, ``dev_ms_est``, the retire
stamps and stall totals) with ``seq``, ``pid``, ``proc`` and the
``traces`` ids (fresh random ids; their count is compared).

Then the port alone: counter deltas equal record sums, ledgers sum to
their walls, the ring survives ``reset()``, a disabled recorder still
serves, warm-up then mixed traffic gives zero unexpected compiles (and a
second sweep warms nothing) with the same tokens and no leaked block,
an unwarmed engine alarms; the reference's readers (``flight.
load_records``, ``forensics.ledger_from_records``, ``trace_view.
load_trace``) read the port's flushed files; the port server's
``/debug/flight`` and ``/debug/forensics`` bodies have the JAX
server's keys; the bench's ``run_flight`` report has the reference's
keys."""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.models import llama as jl
from skypilot_tpu.observability import flight as jfl
from skypilot_tpu.observability import forensics as jfo
from skypilot_tpu.observability import trace_view as jtv
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import flight as fl
from skypilot_tpu_torch.observability import forensics as tfo
from skypilot_tpu_torch.observability import metrics as tm
from skypilot_tpu_torch.observability import tracing as ttr

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

# The reference's flown engine (tests/test_flight.py::_mk_engine); the
# JAX side keeps its pad_waves, the port has none.
KW = dict(n_slots=4, max_len=128, prompt_buckets=(16, 64),
          prefill_chunk=8, prefix_pool=4, spec_k=2, kv_block=16,
          max_wave=4)
FIELDS = ("burst", "rids", "slots", "toks", "stall", "drafted",
          "accepted", "cow", "evictions", "lazy_grows")
PROGRAM = ("k", "span", "final", "bucket", "attn", "layout")
RETIRE = ("submit_s", "first_token_s", "end_s")   # timings
RETIRE_FIELDS = ("prompt_len", "n_toks", "cached_len", "resumed_len",
                 "n_chunks", "spec_drafted", "spec_accepted",
                 "preemptions", "tenants", "adapter")


@pytest.fixture(autouse=True)
def _events_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(ttr.EVENTS_DIR_ENV_VAR, str(tmp_path / "events"))
    monkeypatch.delenv(ttr.ENV_VAR, raising=False)


def _models(**rep):
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"],
                               dtype=jnp.float32, **rep)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32, **rep)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _mixed_prompts(n_short=2, n_long=2):
    rng = np.random.default_rng(7)
    shorts = [rng.integers(1, 40, 6).tolist() for _ in range(n_short)]
    longs = [rng.integers(1, 40, 20).tolist() for _ in range(n_long)]
    return shorts + longs


def _port(tp, tcfg, **kw):
    return te.InferenceEngine(tp, tcfg, device="cpu",
                              flight_recorder=fl.FlightRecorder(),
                              **dict(KW, **kw))


def _jax(jp, jcfg, **kw):
    return je.InferenceEngine(jp, jcfg, kv_kernel=True, pad_waves=True,
                              flight_recorder=jfl.FlightRecorder(),
                              **dict(KW, **kw))


def _key(r):
    prog = r.get("program") or {}
    out = tuple(r.get(f) for f in FIELDS)
    out += tuple(prog.get(f) for f in PROGRAM)
    out += (len(r.get("traces") or ()),)
    if r["burst"] == "retire":
        out += tuple(r.get(f) for f in RETIRE_FIELDS)
    if r["burst"] != "wave":
        out += (r.get("flops"), r.get("hbm_bytes"))
    return out


def _flown(e, prompts):
    before = tm.REGISTRY.snapshot()
    seq0 = e.flight.seq()
    ids = [e.add_request(p, max_new_tokens=10) for p in prompts]
    e.run_to_completion(max_burst=4)
    return dict(window=e.flight.since(seq0), before=before,
                after=tm.REGISTRY.snapshot(), ids=ids,
                finished={r.rid: r for r in e.finished})


def _interleave(e, vocab):
    """The reference's chunk/verify interleave: shorts decode (spec kicks
    in on the small vocabulary's cycling output), then longs arrive so
    their chunks interleave with live verify rounds."""
    rng = np.random.default_rng(1)
    before = tm.REGISTRY.snapshot()
    seq0 = e.flight.seq()
    for _ in range(2):
        e.add_request(rng.integers(1, vocab, 6).tolist(),
                      max_new_tokens=40)
    e.admit()
    for _ in range(3):
        e.decode_burst(4)
    for _ in range(2):
        e.add_request(rng.integers(1, vocab, 30).tolist(),
                      max_new_tokens=40)
    e.run_to_completion(max_burst=4)
    return dict(window=e.flight.since(seq0), before=before,
                after=tm.REGISTRY.snapshot(),
                finished={r.rid: r for r in e.finished})


@pytest.fixture(scope="module")
def flown(models):
    jcfg, tcfg, jp, tp = models
    return (_flown(_jax(jp, jcfg), _mixed_prompts()),
            _flown(_port(tp, tcfg), _mixed_prompts()))


@pytest.fixture(scope="module")
def interleaved():
    jcfg, tcfg, jp, tp = _models(vocab_size=12)
    return (_interleave(_jax(jp, jcfg, spec_k=3), 12),
            _interleave(_port(tp, tcfg, spec_k=3), 12))


# -- recorder core -----------------------------------------------------------

def test_ring_bounded():
    rec = fl.FlightRecorder(capacity=16)
    for i in range(100):
        rec.record("decode", toks=i)
    assert [r["toks"] for r in rec.tail()] == list(range(84, 100))
    assert rec.seq() == 100


def test_concurrent_records_thread_safe():
    rec = fl.FlightRecorder(capacity=10_000)

    def worker(t):
        for i in range(200):
            rec.record("decode", t=t, i=i)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    recs = rec.tail()
    assert len(recs) == 1600 and len({r["seq"] for r in recs}) == 1600


def test_suppress_disabled_and_env(monkeypatch):
    rec = fl.FlightRecorder()
    with tm.suppress():
        rec.record("decode", toks=1)
    assert rec.tail() == []
    rec.enabled = False
    rec.record("decode", toks=1)
    assert rec.seq() == 0
    rec.enabled = True
    rec.record("decode", toks=1)
    assert rec.seq() == 1
    monkeypatch.setenv("SKYTPU_FLIGHT", "0")
    assert fl.FlightRecorder().enabled is False


def test_flush_load_roundtrip_corrupt_skip_both_readers(tmp_path):
    """The port's flushed log loads through the port's AND the
    reference's ``load_records``; torn lines and foreign files are
    skipped."""
    rec = fl.FlightRecorder()
    rec.record("decode", ts_s=2.0, toks=3,
               program={"k": 8, "span": 64, "layout": "paged"})
    rec.record("chunk", ts_s=1.0, toks=1,
               program={"final": True, "layout": "paged"})
    rec.flush()
    d = ttr.events_dir()
    (name,) = [n for n in os.listdir(d) if n.startswith("flight-")]
    with open(os.path.join(d, name), "a", encoding="utf-8") as f:
        f.write("{not json\n")
    with open(os.path.join(d, "flight-foreign-1-2.jsonl"), "w") as f:
        f.write("junk\n{}\n")
    for load in (fl.load_records, jfl.load_records):
        assert [r["burst"] for r in load(dirs=[d])] == ["chunk", "decode"]


def test_compile_watch_keys_costs_and_unexpected():
    watch = fl.CompileWatch()
    wrapped = watch.wrap("prog", lambda *a, **kw: None, ("k", "span"))
    before = tm.REGISTRY.snapshot()
    wrapped(1, k=8, span=64)
    wrapped(1, k=8, span=64)
    wrapped(1, k=4, span=64)
    assert watch.drain_new() == ["prog[k=8 span=64]", "prog[k=4 span=64]"]
    assert not watch.unexpected and not watch.warm
    assert _counter(before, tm.REGISTRY.snapshot(),
                    "skytpu_programs_compiled_total") == 2
    watch.declare_warm()
    wrapped(1, k=2, span=None)
    assert watch.unexpected == ["prog[k=2 span=None]"]
    ev = [r for r in ttr.buffered_records()
          if r.get("name") == "engine.unexpected_compile"]
    assert ev and ev[-1]["attrs"]["program"] == "prog[k=2 span=None]"
    shapes = fl.CompileWatch()
    kf = shapes.wrap("wave", lambda *a, **kw: None, ("bucket",),
                     key_fn=lambda a, kw: (("rows", len(a[0])),))
    kf([1, 2], bucket=128)
    kf([1, 2, 3], bucket=128)
    assert set(shapes.summary()) == {"wave[bucket=128 rows=2]",
                                     "wave[bucket=128 rows=3]"}


_RECS = [
    {"kind": "flight", "burst": "decode", "ts_s": 1.0, "dur_s": 0.01,
     "toks": 8, "slots": [0, 1], "rids": [3, 4],
     "program": {"k": 8, "span": 64, "layout": "paged"},
     "compiled": ["decode_burst[k=8 span=64]"], "dev_ms_est": 4.0,
     "flops": 10, "hbm_bytes": 20, "dispatch_wall_ms": 1.0,
     "fetch_wall_ms": 9.0},
    {"kind": "flight", "burst": "verify", "ts_s": 1.1, "dur_s": 0.02,
     "toks": 5, "slots": [0], "rids": [3],
     "program": {"k": 4, "span": 64, "layout": "paged"}, "drafted": 4,
     "accepted": 3, "drafter": "model", "overlap_ms": 1.5, "stall": True,
     "tenants": {"a": 1, "b": 2}, "adapters": {"ft": 1}},
    {"kind": "flight", "burst": "preempt", "ts_s": 1.2, "dur_s": 0.0,
     "toks": 0, "slots": [1], "program": {"layout": "paged"},
     "priority": 1, "retired_rows": 8, "cow": 1, "evictions": 2,
     "lazy_grows": 3},
]


@pytest.mark.parametrize("fn", ["summarize", "program_label",
                                "render_table", "as_spans"])
def test_host_views_equal_the_reference(fn):
    if fn == "program_label":
        for r in _RECS:
            assert fl.program_label(r) == jfl.program_label(r)
        return
    args = (_RECS,) + (({"decode_burst[k=8 span=64]": 1.25},)
                       if fn == "render_table" else ())
    assert getattr(fl, fn)(*args) == getattr(jfl, fn)(*args)


# -- engine parity -----------------------------------------------------------

@pytest.mark.parametrize("workload", ["flown", "interleave"])
def test_records_equal_the_jax_engine(flown, interleaved, workload):
    jax_run, port_run = flown if workload == "flown" else interleaved
    jw, pw = jax_run["window"], port_run["window"]
    assert [_key(r) for r in pw] == [_key(r) for r in jw]
    assert {r["burst"] for r in pw} >= {"wave", "chunk", "retire"}
    if workload == "interleave":
        assert sum(r.get("drafted", 0) for r in pw) > 0
        assert any(r["burst"] == "chunk" for r in pw)
    # The documented differences, named: the JAX waves pad to max_wave.
    assert all(r["program"]["rows"] == KW["max_wave"]
               for r in jw if r["burst"] == "wave")
    assert [r["program"]["rows"] for r in pw if r["burst"] == "wave"] \
        == [len(r["rids"]) for r in pw if r["burst"] == "wave"]
    assert {i: r.tokens for i, r in port_run["finished"].items()} == \
        {i: r.tokens for i, r in jax_run["finished"].items()}


def _counter(before, after, name):
    def total(snap):
        if name not in snap:
            return 0.0
        return sum(s.get("value", s.get("count", 0))
                   for s in snap[name]["samples"])
    return total(after) - total(before)


def _hist_count(before, after, name):
    def total(snap):
        if name not in snap:
            return 0
        return sum(s["count"] for s in snap[name]["samples"])
    return total(after) - total(before)


@pytest.mark.parametrize("workload", ["flown", "interleave"])
def test_counter_deltas_match_record_sums(flown, interleaved, workload):
    run = (flown if workload == "flown" else interleaved)[1]
    w, b, a = run["window"], run["before"], run["after"]
    assert _counter(b, a, "skytpu_prefill_chunks_total") == \
        sum(1 for r in w if r["burst"] == "chunk")
    assert _counter(b, a, "skytpu_decode_tokens_total") == \
        sum(r["toks"] for r in w if r["burst"] in ("decode", "verify"))
    drafted = sum(r.get("drafted", 0) for r in w)
    accepted = sum(r.get("accepted", 0) for r in w)
    assert _counter(b, a, "skytpu_spec_drafted_total") == drafted
    assert _counter(b, a, "skytpu_spec_accepted_total") == accepted
    assert _counter(b, a, "skytpu_spec_rollbacks_total") == \
        drafted - accepted
    assert _counter(b, a, "skytpu_prefill_requests_total") == \
        sum(r["toks"] for r in w if r["burst"] == "wave") + \
        sum(1 for r in w if r["burst"] == "chunk" and r["program"]["final"])
    assert _hist_count(b, a, "skytpu_decode_stall_seconds") == \
        sum(1 for r in w if r.get("stall"))
    flops = sum(r.get("flops", 0) for r in w)
    hbm = sum(r.get("hbm_bytes", 0) for r in w)
    assert flops > 0 and hbm > 0
    assert _counter(b, a, "skytpu_device_flops_total") == flops
    assert _counter(b, a, "skytpu_device_hbm_moved_bytes_total") == hbm
    dev_s = sum(r.get("dev_ms_est", 0.0) for r in w) / 1e3
    assert _counter(b, a, "skytpu_device_seconds_total") == \
        pytest.approx(dev_s, abs=1e-6)
    for r in w:
        if "dispatch_wall_ms" in r:
            assert r["dispatch_wall_ms"] >= 0 and r["fetch_wall_ms"] >= 0
            assert r["dispatch_wall_ms"] + r["fetch_wall_ms"] == \
                pytest.approx(r["dur_s"] * 1e3, abs=1e-3)
    # A non-final chunk is not fetched (a documented difference).
    assert all(r["fetch_wall_ms"] == 0 for r in w
               if r["burst"] == "chunk" and not r["program"]["final"])


def test_ledger_sums_to_wall(flown):
    """Every retired request of the flown workload: a ledger whose
    phases partition its wall with at least 90% named, equal to what
    the reference's ``ledger_from_records`` builds from the same port
    records; both renders name the request."""
    run = flown[1]
    w = run["window"]
    assert {r["rids"][0] for r in w if r["burst"] == "retire"} == \
        set(run["ids"])
    for rid in run["ids"]:
        led = tfo.ledger_from_records(rid, w)
        assert led == jfo.ledger_from_records(rid, w)
        total = sum(p["ms"] for p in led["phases"])
        assert total == pytest.approx(led["wall_ms"], abs=0.05)
        assert led["named_ms"] >= 0.90 * led["wall_ms"]
        assert led["detail"]["n_toks"] == len(run["finished"][rid].tokens)
        assert tfo.render_ledger(led) == jfo.render_ledger(led)


def test_reset_mid_flight_ring_survives(models):
    _, tcfg, _, tp = models
    e = _port(tp, tcfg)
    rec = e.flight
    e.add_request(list(range(1, 21)), max_new_tokens=4)
    e.admit()
    e.prefill_chunk_step()
    n = rec.seq()
    assert n >= 1
    e.reset()
    assert rec.seq() == n
    assert len(e.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3
    assert rec.seq() > n
    e.clear_prefix_cache()
    assert e.blocks_used() == 0


def test_recorder_off_engine_still_serves(models):
    _, tcfg, _, tp = models
    e = _port(tp, tcfg)
    e.flight.enabled = False
    out = e.generate(_mixed_prompts(1, 1), max_new_tokens=5)
    assert all(len(o) == 5 for o in out)
    assert e.flight.tail() == []


def test_warm_programs_then_zero_unexpected(models, flown):
    """Warm-up, then the flown workload: no unexpected key, the same
    tokens as the unwarmed run, no leaked block; a second sweep warms
    nothing."""
    _, tcfg, _, tp = models
    e = _port(tp, tcfg)
    assert e.warm_programs(max_burst=4) > 0
    assert e.blocks_used() == 0
    e.declare_warmup_complete()
    ids = [e.add_request(p, max_new_tokens=10) for p in _mixed_prompts()]
    e.run_to_completion(max_burst=4)
    assert e.compile_watch.unexpected == []
    got = {r.rid: r.tokens for r in e.finished}
    want = flown[1]["finished"]
    assert [got[i] for i in ids] == [want[i].tokens for i in
                                     flown[1]["ids"]]
    e.clear_prefix_cache()
    assert e.blocks_used() == 0
    assert e.warm_programs(max_burst=4) == 0


def test_warm_programs_needs_a_free_slot(models):
    _, tcfg, _, tp = models
    e = _port(tp, tcfg, n_slots=1)
    e.add_request([1, 2, 3], max_new_tokens=8)
    e.admit()
    with pytest.raises(te.NoFreeSlotError):
        e.warm_programs()


def test_unwarmed_engine_alarms_after_declare(models):
    _, tcfg, _, tp = models
    e = _port(tp, tcfg)
    before = tm.REGISTRY.snapshot()
    e.declare_warmup_complete()
    e.generate([[1, 2, 3]], max_new_tokens=3)
    assert e.compile_watch.unexpected
    assert _counter(before, tm.REGISTRY.snapshot(),
                    "skytpu_unexpected_compiles_total") > 0
    assert "engine.unexpected_compile" in [
        r.get("name") for r in ttr.buffered_records()]


def test_reference_readers_read_the_port_files(models):
    """The port's flushed flight and event logs load through the
    reference's ``flight.load_records``, ``forensics.
    ledger_from_records`` and ``trace_view.load_trace`` (the request's
    spans and the bursts it rode)."""
    _, tcfg, _, tp = models
    ttr._reset_for_tests()
    e = _port(tp, tcfg)
    rid = e.add_request(list(range(1, 21)), max_new_tokens=6)
    e.run_to_completion(max_burst=4)
    req = next(r for r in e.finished if r.rid == rid)
    ttr.flush()
    e.flight.flush()
    d = ttr.events_dir()
    recs = jfl.load_records(dirs=[d])
    assert sorted(r["seq"] for r in recs) == [r["seq"] for r in
                                             e.flight.tail()]
    led = jfo.ledger_from_records(rid, recs)
    assert led["rid"] == rid and led["n_records"] > 0
    trace = jtv.load_trace(req.span_ctx.trace_id, dirs=[d])
    names = {r.get("name") for r in trace}
    assert {"engine.request", "engine.queue_wait", "engine.prefill",
            "engine.decode"} <= names
    assert any(r.get("kind") == "flight" for r in trace)
    assert "bursts ridden" in jtv.render(trace, req.span_ctx.trace_id)
    ttr._reset_for_tests()


# -- the server's debug routes -----------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve(engine, server_mod):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    model, httpd = server_mod.serve(engine, host="127.0.0.1", port=port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    model.wait_ready(timeout=300) if hasattr(model, "wait_ready") else \
        model._ready.wait(300)
    return model, httpd, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def debug_bodies(models):
    """The same requests (one carrying a traceparent) to a port replica
    and a JAX replica; their /debug bodies."""
    from skypilot_tpu.infer import server as jsrv
    from skypilot_tpu_torch.infer import server as tsrv
    jcfg, tcfg, jp, tp = models
    caller = ttr.SpanContext(ttr.new_trace_id(), ttr.new_span_id())
    out = {}
    for side, engine, mod in (
            ("jax", _jax(jp, jcfg), jsrv), ("port", _port(tp, tcfg), tsrv)):
        model, httpd, base = _serve(engine, mod)
        try:
            tp_hdr = {"traceparent": ttr.format_traceparent(caller)}
            _post(f"{base}/generate", {"tokens": list(range(1, 21)),
                                       "max_new_tokens": 6}, tp_hdr)
            _post(f"{base}/generate", {"tokens": [5, 6, 7],
                                       "max_new_tokens": 4})
            fl_body = _get(f"{base}/debug/flight?n=512")
            rid = next(r["rids"][0] for r in fl_body[1]["records"]
                       if r["burst"] == "retire")
            out[side] = {
                "flight": fl_body,
                "since": _get(f"{base}/debug/flight?since=2"),
                "forensics": _get(f"{base}/debug/forensics"),
                "why": _get(f"{base}/debug/forensics?rid={rid}"),
                "bad": _get(f"{base}/debug/forensics?rid=x"),
                "unknown": _get(f"{base}/debug/forensics?rid=999"),
            }
        finally:
            httpd.shutdown()
            httpd.server_close()
            model.shutdown()
    return out, caller


@pytest.mark.parametrize("route", ["flight", "since", "forensics", "why",
                                   "bad", "unknown"])
def test_debug_bodies_have_the_reference_keys(debug_bodies, route):
    out, _ = debug_bodies
    (jcode, jbody), (pcode, pbody) = out["jax"][route], out["port"][route]
    assert pcode == jcode
    assert set(pbody) == set(jbody)
    if route == "why":
        assert set(pbody["ledger"]) == set(jbody["ledger"])
        total = sum(p["ms"] for p in pbody["ledger"]["phases"])
        assert total == pytest.approx(pbody["ledger"]["wall_ms"], abs=0.05)
    if route == "since":
        assert all(r["seq"] > 2 for r in pbody["records"])


def test_traceparent_comes_back_as_the_trace_id(debug_bodies):
    out, caller = debug_bodies
    recs = out["port"]["flight"][1]["records"]
    traced = [r for r in recs if caller.trace_id in (r.get("traces") or ())]
    assert {"chunk", "retire"} <= {r["burst"] for r in traced}
    spans = [r for r in ttr.buffered_records()
             if r.get("trace") == caller.trace_id
             and r.get("name") == "engine.request"]
    assert spans and spans[-1]["parent"] == caller.span_id


def test_run_flight_report_has_the_reference_keys():
    """The bench's ``run_flight`` at a CI size: the reference's keys, the
    paged layout and its contiguous twin, zero unexpected compiles,
    coverage and the three parity guards on each."""
    from skypilot_tpu_torch.infer import bench_serve
    r = bench_serve.run_flight(smoke=True, requests=5, new_tokens=8,
                               device="cpu")
    ref = {"warmup_compile_s", "unexpected_compiles", "coverage_ok",
           "parity_ok", "calibration_parity_ok", "calibration_samples",
           "n_records", "overhead_ratio", "forensics_parity_ok",
           "forensics_overhead_ratio", "layouts", "config", "spec_k",
           "kv_int8", "weights_int8"}
    assert ref <= set(r) and list(r["layouts"]) == ["paged", "contig"]
    for lay in r["layouts"].values():
        assert lay["unexpected_compiles"] == 0 and lay["coverage_ok"]
        assert lay["parity_ok"] and lay["forensics_parity_ok"]
    assert r["unexpected_compiles"] == 0
    assert r["coverage_ok"] and r["parity_ok"]
    assert r["calibration_parity_ok"] and r["forensics_parity_ok"]
