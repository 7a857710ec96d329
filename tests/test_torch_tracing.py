"""The port's tracing layer (``skypilot_tpu_torch/observability/
tracing.py`` and ``trace_view.py``) against the JAX package's on the
CPU: the ``traceparent`` wire format and its parser on the same headers
(malformed ones included), the span context stack, the env root, the
ring, suppression, the flush, and the reference's ``trace_view``
reading the port's logs; then the engine's per-request spans
(``tests/test_tracing.py:421``) and the server's ``traceparent``."""

import json
import os
import time

import pytest
import torch

from skypilot_tpu.observability import trace_view as jtv
from skypilot_tpu.observability import tracing as jtr
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import metrics as tm
from skypilot_tpu_torch.observability import trace_view as ttv
from skypilot_tpu_torch.observability import tracing as ttr

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh(tmp_path, monkeypatch):
    monkeypatch.setenv(ttr.EVENTS_DIR_ENV_VAR, str(tmp_path / "events"))
    monkeypatch.delenv(ttr.ENV_VAR, raising=False)
    ttr._reset_for_tests()
    yield str(tmp_path / "events")
    ttr._reset_for_tests()


_HEADERS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "  00-" + "0123456789abcdef" * 2 + "-" + "0123456789abcdef" + "-00 ",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-01",          # upper case
    None, "", "garbage", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",           # zero trace
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",           # zero span
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
]


@pytest.mark.parametrize("header", _HEADERS)
def test_parse_traceparent_equals_the_reference(header):
    got, want = ttr.parse_traceparent(header), jtr.parse_traceparent(header)
    assert (None if got is None else (got.trace_id, got.span_id)) == \
        (None if want is None else (want.trace_id, want.span_id))
    if got is not None:
        assert ttr.format_traceparent(got) == jtr.format_traceparent(want)


def test_traceparent_round_trip_and_ids():
    ctx = ttr.SpanContext(ttr.new_trace_id(), ttr.new_span_id())
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    assert ttr.parse_traceparent(ttr.format_traceparent(ctx)) == ctx
    assert jtr.parse_traceparent(ttr.format_traceparent(ctx)).trace_id == \
        ctx.trace_id


def test_nested_spans_env_root_and_error_status(monkeypatch):
    root = ttr.SpanContext(ttr.new_trace_id(), ttr.new_span_id())
    monkeypatch.setenv(ttr.ENV_VAR, ttr.format_traceparent(root))
    with ttr.start_span("outer") as outer:
        with ttr.start_span("inner") as inner:
            ttr.add_event("tick", {"n": 1})
    with pytest.raises(ValueError):
        with ttr.start_span("boom"):
            raise ValueError("x")
    recs = {r["name"]: r for r in ttr.buffered_records()}
    assert recs["outer"]["parent"] == root.span_id
    assert recs["inner"]["parent"] == outer.ctx.span_id
    assert recs["tick"]["parent"] == inner.ctx.span_id
    assert {r["trace"] for r in recs.values()} == {root.trace_id}
    assert recs["boom"]["status"] == "error"
    assert recs["boom"]["error_type"] == "ValueError"
    ttr.add_event("lone", ctx=ttr.DETACHED)
    assert "trace" not in ttr.buffered_records()[-1]


def test_echo_line_is_the_record(capfd):
    ttr.add_event("server.engine_recovered", {"seam": "decode"}, echo=True)
    (line,) = [ln for ln in capfd.readouterr().err.splitlines()
               if ln.startswith("{")]
    rec = json.loads(line)
    assert rec["kind"] == "event" and rec["name"] == \
        "server.engine_recovered"
    assert rec["attrs"] == {"seam": "decode"}
    assert rec == ttr.buffered_records()[-1]


def test_ring_bounded_and_suppressed(monkeypatch):
    monkeypatch.setattr(ttr._RING, "capacity", 10)
    for i in range(25):
        ttr.add_event("e", {"i": i})
    assert len(ttr.buffered_records()) <= 10
    ttr._reset_for_tests()
    with tm.suppress():
        ttr.record_span("s", 1.0, 2.0)
    assert ttr.buffered_records() == []
    monkeypatch.setenv("SKYTPU_EVENT_LOG", "0")
    ttr.add_event("off")
    assert ttr.buffered_records() == []


def test_events_dir_follows_the_reference_home(tmp_path, monkeypatch):
    """With no events-dir override, both packages put the logs under
    ``$SKYPILOT_TPU_HOME/events``, where the reference CLI looks."""
    monkeypatch.delenv(ttr.EVENTS_DIR_ENV_VAR)
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    assert ttr.events_dir() == jtr.events_dir() == str(
        tmp_path / "home" / "events")


def test_flush_load_trace_render_and_perfetto(fresh):
    """The port's flushed log reads through the reference's trace_view:
    the same records, tree rendering and Perfetto export as the port's
    own copy; torn lines are skipped."""
    with ttr.start_span("req", {"rid": 1}) as sp:
        ttr.record_span("child", time.time(), time.time() + 0.01)
        ttr.add_event("evt", {"k": "v"})
    ttr.flush()
    (name,) = os.listdir(fresh)
    with open(os.path.join(fresh, name), "a", encoding="utf-8") as f:
        f.write('{"trace": "' + sp.ctx.trace_id + '" torn\n')
    got = jtv.load_trace(sp.ctx.trace_id, dirs=[fresh])
    assert got == ttv.load_trace(sp.ctx.trace_id, dirs=[fresh])
    assert {r["name"] for r in got} == {"req", "child", "evt"}
    assert jtv.render(got) == ttv.render(got)
    assert jtv.to_perfetto(got) == ttv.to_perfetto(got)
    assert ttv.build_tree(got)[0]["rec"]["name"] == "req"


def test_gc_event_logs(fresh):
    os.makedirs(fresh, exist_ok=True)
    old = time.time() - 30 * 24 * 3600
    for i in range(5):
        p = os.path.join(fresh, f"x-{i}.jsonl")
        open(p, "w").close()
        os.utime(p, (old, old))
    assert ttr.gc_event_logs(max_files=2) == 3
    assert len(os.listdir(fresh)) == 2


def test_engine_records_one_decode_span_per_request():
    """The reference's span volume guard: one ``engine.decode`` per
    finished multi-token request, plus its queue wait, prefill and
    request span, the request span parented to the caller's."""
    cfg = tl.CONFIGS["llama3-tiny"]
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(cfg, gen, device="cpu", dtype=torch.float32)
    e = te.InferenceEngine(params, cfg, n_slots=2, max_len=64,
                           prompt_buckets=(16, 64), device="cpu")
    caller = ttr.SpanContext(ttr.new_trace_id(), ttr.new_span_id())
    e.add_request([1, 2, 3], max_new_tokens=12, trace_ctx=caller)
    e.run_to_completion(max_burst=4)
    recs = [r for r in ttr.buffered_records()
            if r.get("trace") == caller.trace_id]
    names = [r["name"] for r in recs]
    for n in ("engine.decode", "engine.request", "engine.prefill",
              "engine.queue_wait"):
        assert names.count(n) == 1, names
    req = next(r for r in recs if r["name"] == "engine.request")
    assert req["parent"] == caller.span_id
    assert req["attrs"]["n_tokens"] == 12
    kids = [r for r in recs if r["name"] != "engine.request"]
    assert all(r["parent"] == req["span"] for r in kids)
    # No ambient or explicit context: a fresh trace per request.
    e.add_request([4, 5], max_new_tokens=2)
    e.run_to_completion()
    assert e.finished[-1].span_ctx.trace_id != caller.trace_id
    assert e.finished[-1].parent_id is None


def test_server_main_severs_the_inherited_root(monkeypatch):
    """The server daemon drops an inherited ``SKYTPU_TRACEPARENT`` and
    names its process, as the reference's does."""
    from skypilot_tpu_torch.infer import server as ts
    root = ttr.SpanContext(ttr.new_trace_id(), ttr.new_span_id())
    monkeypatch.setenv(ttr.ENV_VAR, ttr.format_traceparent(root))
    monkeypatch.setattr(ts, "make_engine",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("stop")))
    with pytest.raises(RuntimeError, match="stop"):
        ts.main(["--device", "cpu", "--config", "llama3-tiny"])
    assert ttr.ENV_VAR not in os.environ
    assert ttr.process_name() == "model-server"
