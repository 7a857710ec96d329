"""The port's timeline (``skypilot_tpu_torch/utils/timeline.py``) and
step callbacks (``skypilot_tpu_torch/callbacks``), held to the cases of
the reference's ``tests/test_observability.py`` (the timeline and
callback ones) and ``tests/test_metrics.py``'s histogram bridge.

Durations come from a fake clock patched over the module's ``time``,
never from sleeps, and the trim case drives ident reuse and distinct
idents deterministically, so no case depends on a loaded machine's
timing. The trace file the port writes is read back as the reference's
writes are, and both packages' files carry the same event shapes."""

import json
import os
import threading

import pytest
import torch

import skypilot_tpu.callbacks as jcb
import skypilot_tpu_torch.callbacks as sky_callback
from skypilot_tpu.utils import timeline as jtl
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.utils import timeline

# One intra-op thread: the suite runs several test files at once on a
# few cores.
torch.set_num_threads(1)


class FakeClock:
    """Stands in for the ``time`` module: ``sleep`` advances both
    clocks by exactly its argument."""

    def __init__(self, t0: float = 1_000_000.0):
        self.t = t0

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clean(monkeypatch):
    timeline._events.clear()
    timeline._named_tids.clear()
    yield
    timeline._events.clear()
    timeline._named_tids.clear()


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(timeline, "time", c)
    return c


def test_timeline_disabled_is_noop(monkeypatch, clean):
    monkeypatch.delenv(timeline.ENV_VAR, raising=False)

    @timeline.event
    def f():
        return 42

    assert f() == 42
    assert not timeline._events


def test_timeline_records_and_saves(tmp_path, monkeypatch, clean, clock):
    out = tmp_path / "trace.json"
    monkeypatch.setenv(timeline.ENV_VAR, str(out))

    @timeline.event(name="my-op")
    def f():
        clock.sleep(0.01)
        return 1

    f()
    with timeline.Event("manual", message="hello"):
        pass
    timeline.save_now()
    data = json.loads(out.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert "my-op" in names and "manual" in names
    evt = next(e for e in data["traceEvents"] if e["name"] == "my-op")
    assert evt["ph"] == "X" and evt["dur"] == pytest.approx(10_000)
    manual = next(e for e in data["traceEvents"] if e["name"] == "manual")
    assert manual["args"] == {"message": "hello"}


def test_event_shapes_equal_the_reference(tmp_path, monkeypatch, clean):
    """One process writing both packages' spans: the same keys, phases
    and metadata, so one Perfetto file holds either."""
    monkeypatch.setenv(timeline.ENV_VAR, str(tmp_path / "t.json"))
    jtl._events.clear()
    jtl._named_tids.clear()
    try:
        with timeline.Event("span", message="m"):
            pass
        with jtl.Event("span", message="m"):
            pass
        got = [(e["ph"], sorted(e)) for e in timeline._events]
        want = [(e["ph"], sorted(e)) for e in jtl._events]
        assert got == want
    finally:
        jtl._events.clear()
        jtl._named_tids.clear()


def test_filelock_event(tmp_path, monkeypatch, clean):
    monkeypatch.setenv(timeline.ENV_VAR, str(tmp_path / "t.json"))
    with timeline.FileLockEvent(str(tmp_path / "x.lock")):
        pass
    assert any("filelock.acquire" in e["name"] for e in timeline._events)


def test_filelock_excludes_and_times_out(tmp_path):
    lock = str(tmp_path / "y.lock")
    with timeline.FileLockEvent(lock):
        with pytest.raises(TimeoutError):
            timeline.FileLockEvent(lock, timeout=0).acquire()
    with timeline.FileLockEvent(lock, timeout=0):
        pass


def test_timeline_save_is_atomic_and_repeatable(tmp_path, monkeypatch,
                                                clean):
    out = tmp_path / "trace.json"
    monkeypatch.setenv(timeline.ENV_VAR, str(out))
    with timeline.Event("one"):
        pass
    timeline.save_now()
    first = json.loads(out.read_text())
    with timeline.Event("two"):
        pass
    timeline.save_now()
    timeline.save_now()           # repeat is safe, full buffer each time
    data = json.loads(out.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert "one" in names and "two" in names
    assert len(data["traceEvents"]) >= len(first["traceEvents"])
    leftovers = [p for p in os.listdir(tmp_path)
                 if p != "trace.json" and p.startswith("trace.json")]
    assert leftovers == []


def test_timeline_real_thread_ids_and_names(tmp_path, monkeypatch, clean):
    monkeypatch.setenv(timeline.ENV_VAR, str(tmp_path / "t.json"))

    def record():
        with timeline.Event("in-thread"):
            pass

    t = threading.Thread(target=record, name="worker-thread")
    t.start()
    t.join()
    with timeline.Event("in-main"):
        pass
    spans = {e["name"]: e for e in timeline._events if e["ph"] == "X"}
    assert spans["in-thread"]["tid"] != spans["in-main"]["tid"]
    meta = [e for e in timeline._events
            if e["ph"] == "M" and e["name"] == "thread_name"]
    by_tid = {e["tid"]: e["args"]["name"] for e in meta}
    assert by_tid[spans["in-thread"]["tid"]] == "worker-thread"
    assert spans["in-main"]["tid"] in by_tid


def test_timeline_thread_name_not_inherited_on_ident_reuse(
        tmp_path, monkeypatch, clean):
    monkeypatch.setenv(timeline.ENV_VAR, str(tmp_path / "t.json"))
    cur = threading.current_thread()
    old = cur.name
    try:
        cur.name = "incarnation-1"   # same ident, two names = reuse
        with timeline.Event("a"):
            pass
        cur.name = "incarnation-2"
        with timeline.Event("b"):
            pass
    finally:
        cur.name = old
    meta = [e for e in timeline._events
            if e["ph"] == "M" and e["name"] == "thread_name"]
    assert [e["args"]["name"] for e in meta] == \
        ["incarnation-1", "incarnation-2"]


@pytest.mark.parametrize("churn", ["reused_ident", "distinct_idents"])
def test_timeline_trim_drops_stale_thread_metadata(tmp_path, monkeypatch,
                                                   clean, churn):
    """Under thread churn, name metadata of threads whose spans aged out
    of the capped buffer must not accumulate without bound. Both kinds
    of churn are driven deterministically: 120 incarnations of one ident
    (the current thread renamed, which is what the OS's ident reuse
    looks like to the buffer), and 120 threads kept alive until all
    have recorded, so no two share an ident."""
    monkeypatch.setenv(timeline.ENV_VAR, str(tmp_path / "t.json"))
    monkeypatch.setattr(timeline, "_MAX_EVENTS", 40)

    def record():
        with timeline.Event("churn"):
            pass

    if churn == "reused_ident":
        cur = threading.current_thread()
        old = cur.name
        try:
            for i in range(120):
                cur.name = f"w{i}"
                record()
        finally:
            cur.name = old
    else:
        go = threading.Event()
        done = threading.Barrier(121)

        def worker():
            record()
            done.wait()
            go.wait()

        threads = [threading.Thread(target=worker, name=f"w{i}")
                   for i in range(120)]
        for t in threads:
            t.start()
        done.wait()
        assert len({t.ident for t in threads}) == 120
        go.set()
        for t in threads:
            t.join()
    assert len(timeline._events) <= 2 * 40
    meta = [e for e in timeline._events if e["ph"] == "M"]
    span_tids = {e["tid"] for e in timeline._events if e["ph"] != "M"}
    assert {e["tid"] for e in meta} <= span_tids   # no orphaned names
    if churn == "reused_ident":
        # A trim keeps one name of the reused ident, its newest; the
        # names emitted since then follow it in order.
        names = [e["args"]["name"] for e in meta]
        assert names[-1] == "w119" and len(names) <= 40
        assert names == sorted(names, key=lambda n: int(n[1:]))


def test_timeline_flush_skips_clean_buffer(tmp_path, monkeypatch, clean):
    out = tmp_path / "t.json"
    monkeypatch.setenv(timeline.ENV_VAR, str(out))
    with timeline.Event("tick-span"):
        pass
    timeline.save_now()
    sentinel = '{"traceEvents": [], "sentinel": true}'
    out.write_text(sentinel)
    timeline.save_now()                    # clean buffer -> no rewrite
    assert out.read_text() == sentinel
    with timeline.Event("tick-span-2"):    # dirty again -> rewrites
        pass
    timeline.save_now()
    names = [e["name"] for e in
             json.loads(out.read_text())["traceEvents"]]
    assert "tick-span-2" in names


def test_save_periodic_throttles_full_buffer_rewrites(tmp_path,
                                                      monkeypatch, clean):
    out = tmp_path / "t.json"
    monkeypatch.setenv(timeline.ENV_VAR, str(out))
    with timeline.Event("first"):
        pass
    timeline.save_now()           # flush: _last_flush_s is now fresh
    with timeline.Event("second"):
        pass
    timeline.save_periodic(min_new_events=100, max_age_s=60.0)
    names = [e["name"] for e in
             json.loads(out.read_text())["traceEvents"]]
    assert "second" not in names  # few events + fresh flush: skipped
    timeline.save_periodic(min_new_events=1, max_age_s=60.0)
    names = [e["name"] for e in
             json.loads(out.read_text())["traceEvents"]]
    assert "second" in names      # enough pending events: flushed
    with timeline.Event("third"):
        pass
    monkeypatch.setattr(timeline, "_last_flush_s", 0.0)
    timeline.save_periodic(min_new_events=100, max_age_s=60.0)
    names = [e["name"] for e in
             json.loads(out.read_text())["traceEvents"]]
    assert "third" in names       # stale last flush: age triggers


def test_unwritable_path_is_quiet_at_exit(tmp_path, monkeypatch, clean):
    blocked = tmp_path / "blocked"
    blocked.write_text("")        # a FILE where a directory is needed
    monkeypatch.setenv(timeline.ENV_VAR, str(blocked / "nested.json"))
    with timeline.Event("span"):
        pass
    with pytest.raises(OSError):
        timeline.save_now()
    timeline._save_atexit()       # the exit hook swallows it


# -- the histogram bridge (tests/test_metrics.py:271-312) -------------------

def test_timeline_event_records_histogram_without_tracing(monkeypatch,
                                                          clean):
    monkeypatch.delenv(timeline.ENV_VAR, raising=False)
    reg = metrics.Registry()
    h = reg.histogram("span_seconds", "", buckets=(60.0,))
    with timeline.Event("span_seconds", histogram=h._require_default()):
        pass
    (_, child), = h.children()
    counts, _ = child.hist_state()
    assert sum(counts) == 1
    assert not timeline._events        # tracing stayed off


def test_timeline_decorator_histogram_bridge(monkeypatch, tmp_path, clean,
                                             clock):
    reg = metrics.Registry()
    h = reg.histogram("op_seconds", "", buckets=(0.5, 60.0))

    @timeline.event(name="op_seconds", histogram=h._require_default())
    def op():
        clock.sleep(1.0)
        return 7

    monkeypatch.delenv(timeline.ENV_VAR, raising=False)
    assert op() == 7
    out = tmp_path / "t.json"
    monkeypatch.setenv(timeline.ENV_VAR, str(out))
    assert op() == 7
    timeline.save_now()
    (_, child), = h.children()
    counts, total = child.hist_state()
    assert sum(counts) == 2 and total == pytest.approx(2.0)
    evt = next(e for e in json.loads(out.read_text())["traceEvents"]
               if e["name"] == "op_seconds")
    # The span and the histogram sample are one measurement.
    assert evt["dur"] == pytest.approx(1e6)


# -- step callbacks (tests/test_observability.py:86-100) --------------------

def test_callbacks_summary(tmp_path, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(sky_callback, "time", clock)
    monkeypatch.setenv("SKYTPU_CALLBACK_LOG_DIR", str(tmp_path))
    sky_callback.init(total_steps=10, warmup_steps=1)
    for dur in (9.0, 0.5, 0.7):
        with sky_callback.step():
            clock.sleep(dur)
    s = sky_callback.summary()
    assert s["steps"] == 3
    assert s["avg_step_s"] == pytest.approx(0.6)   # warmup excluded
    assert s["eta_s"] == pytest.approx(4.2)
    assert s["elapsed_s"] == pytest.approx(10.2)
    sky_callback.write_summary()
    on_disk = json.loads((tmp_path / sky_callback.SUMMARY_FILE).read_text())
    assert on_disk == s
    assert sky_callback.SUMMARY_FILE == jcb.SUMMARY_FILE


def test_callbacks_summary_keys_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYTPU_CALLBACK_LOG_DIR", str(tmp_path))
    for mod in (sky_callback, jcb):
        mod.init(total_steps=4)
        with mod.step():
            pass
    assert set(sky_callback.summary()) == set(jcb.summary())


def test_callbacks_log_dir_follows_the_home(tmp_path, monkeypatch):
    monkeypatch.delenv("SKYTPU_CALLBACK_LOG_DIR", raising=False)
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    sky_callback.init(total_steps=2)
    with sky_callback.step():
        pass
    sky_callback.write_summary()
    assert (tmp_path / "home" / sky_callback.SUMMARY_FILE).exists()


def test_callbacks_without_init_are_inert(monkeypatch):
    monkeypatch.setattr(sky_callback, "_state", None)
    with sky_callback.step():
        pass
    assert sky_callback.summary() == {}
    sky_callback.write_summary()
