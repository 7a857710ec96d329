"""The port's goodput ledger and anomaly watchdog
(``skypilot_tpu_torch/observability/goodput.py``), held to every case of
the reference's ``tests/test_goodput.py``, and read by the reference's
own consumers.

Every duration comes from a fake clock patched over the module's
``time`` (``sleep`` advances it by exactly its argument), so the
partition and share checks hold to the digit on any machine: the
reference's ``test_ledger_sums_gate`` (``named_ms >= 0.90 * wall_ms``
over real sleeps) is timing-sensitive, its counterpart here is not.

Cross-package: the port's flushed ``train_step`` records are read by
the reference's ``flight.load_records``, ``goodput.ledger_for_step``/
``summarize_steps`` and ``skytpu train-why``; its ``goodput.json`` by
the reference's ``load_stamps`` and the other way round; its
``/metrics`` families, parsed by the reference's ``parse_exposition``,
by the reference's ``slo.Watchdog`` under ``slo.DEFAULT_RULES`` and by
``skytpu top``'s train columns."""

import json
import math
import os

import pytest
import torch

from skypilot_tpu.observability import flight as jfl
from skypilot_tpu.observability import goodput as jgp
from skypilot_tpu.observability import metrics as jm
from skypilot_tpu.observability import slo
from skypilot_tpu_torch.observability import flight as fl
from skypilot_tpu_torch.observability import forensics
from skypilot_tpu_torch.observability import goodput as gp_lib
from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.observability import tracing

# One intra-op thread: the suite runs several test files at once on a
# few cores.
torch.set_num_threads(1)


class FakeClock:
    """Stands in for the ``time`` module."""

    def __init__(self, t0: float = 1_000_000.0):
        self.t = t0

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(gp_lib, "time", c)
    return c


def _counter_delta(before, after, name):
    def total(snap):
        if name not in snap:
            return 0.0
        return sum(s.get("value", s.get("count", 0))
                   for s in snap[name]["samples"])
    return total(after) - total(before)


def _drive_steps(gp, clock, n_steps=3, tokens=64, sleep=0.004,
                 gap=0.0, data=None):
    """Drive the recorder the way train/run.py does; returns the
    records. ``gap`` is unwrapped host time inside each step."""
    recs = []
    for step in range(n_steps):
        gp.step_start(step)
        with gp.phase("data_wait"):
            clock.sleep(sleep if data is None else data)
        with gp.phase("compute"):
            clock.sleep(2 * sleep)
        with gp.phase("eval"):
            clock.sleep(sleep / 2)
        clock.sleep(gap)
        rec = gp.step_end(tokens=tokens, loss=2.0 - 0.1 * step)
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# The exact-partition invariants.

def test_step_record_phases_sum_to_wall(clock):
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, host="0",
                                param_count=1000, enable=True)
    records = _drive_steps(gp, clock, n_steps=4, gap=0.001)
    assert len(records) == 4
    for r in records:
        assert sum(r["phases"].values()) == \
            pytest.approx(r["dur_s"] * 1e3, abs=0.05)
        assert r["phases"]["host_other"] == pytest.approx(1.0)
        assert r["phases"] == pytest.approx(
            {"data_wait": 4.0, "compute": 8.0, "eval": 2.0,
             "host_other": 1.0})
    assert records[0]["warm"] is False
    assert "flops" not in records[0] and "dev_ms_est" not in records[0]
    for r in records[1:]:
        assert r["warm"] is True
        assert r["flops"] == 6 * 1000 * 64
        assert r["dev_ms_est"] == pytest.approx(8.0)   # compute fallback
    # The ring holds what step_end returned, field for field.
    tail = rec.tail()
    assert len(tail) == len(records)
    assert all({k: t[k] for k in r} == r for t, r in zip(tail, records))


def test_ledger_sums_gate(tmp_path, monkeypatch, clock):
    """Loaded back off disk, every train_step ledger's phases sum to
    its wall and the named share is exactly what the run spent in named
    phases: 14 ms of each 15 ms step (the reference's 0.90 floor over
    sleeps, made exact)."""
    monkeypatch.setenv(tracing.EVENTS_DIR_ENV_VAR, str(tmp_path))
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, host="0", enable=True)
    _drive_steps(gp, clock, n_steps=3, sleep=0.004, gap=0.001)
    rec.flush()
    for lib in (fl, jfl):              # both packages' loaders
        records = lib.load_records(dirs=[str(tmp_path)])
        train = gp_lib.train_records(records)
        assert len(train) == 3
        for r in train:
            led = gp_lib.ledger_for_step(records, step=r["step"])
            assert led is not None
            assert sum(p["ms"] for p in led["phases"]) == \
                pytest.approx(led["wall_ms"], abs=0.05)
            assert led["named_ms"] == pytest.approx(14.0)
            assert led["named_ms"] >= 0.90 * led["wall_ms"]
        summary = gp_lib.summarize_steps(records)
        assert summary["steps"] == 3
        assert sum(p["ms"] for p in summary["phases"]) == \
            pytest.approx(summary["wall_ms"], abs=0.2)
        assert "sum (= wall)" in gp_lib.render_step_ledger(
            gp_lib.ledger_for_step(records))
        assert "named" in gp_lib.render_summary(summary)


def test_ledger_views_equal_the_reference(tmp_path, monkeypatch, clock):
    """The reference's ledger functions and renderers give what the
    port's give on the port's flushed records."""
    monkeypatch.setenv(tracing.EVENTS_DIR_ENV_VAR, str(tmp_path))
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, host="3", enable=True,
                                param_count=77)
    _drive_steps(gp, clock, n_steps=4, gap=0.002)
    rec.flush()
    records = jfl.load_records(dirs=[str(tmp_path)])
    assert jgp.train_records(records) == gp_lib.train_records(records)
    for step in (None, 0, 2, 3, 9):
        assert jgp.ledger_for_step(records, step) == \
            gp_lib.ledger_for_step(records, step)
    led = gp_lib.ledger_for_step(records)
    assert jgp.render_step_ledger(led) == gp_lib.render_step_ledger(led)
    summ = gp_lib.summarize_steps(records)
    assert jgp.summarize_steps(records) == summ
    assert jgp.render_summary(summ) == gp_lib.render_summary(summ)
    assert (gp_lib.PHASES, gp_lib.BUCKETS, gp_lib.STAMPS_FILE) == \
        (jgp.PHASES, jgp.BUCKETS, jgp.STAMPS_FILE)
    assert gp_lib._PHASE_BUCKET == jgp._PHASE_BUCKET


def test_counter_deltas_match_record_sums(clock):
    before = metrics_lib.REGISTRY.snapshot()
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, host="gate-host",
                                param_count=500, enable=True)
    records = _drive_steps(gp, clock, n_steps=4, tokens=32)
    snap = gp.snapshot()
    after = metrics_lib.REGISTRY.snapshot()
    flops = sum(r.get("flops", 0) for r in records)
    assert flops == 3 * 6 * 500 * 32          # warm steps only
    assert _counter_delta(before, after,
                          "skytpu_device_flops_total") == flops
    dev_s = sum(r.get("dev_ms_est", 0.0) for r in records) / 1e3
    assert _counter_delta(before, after,
                          "skytpu_device_seconds_total") == \
        pytest.approx(dev_s, abs=1e-6)
    assert snap["tokens"] == sum(r["toks"] for r in records)
    assert snap["steps"] == len(records)
    wall = _counter_delta(before, after,
                          "skytpu_train_wall_seconds_total")
    prod = _counter_delta(before, after,
                          "skytpu_train_productive_seconds_total")
    unprod = _counter_delta(
        before, after, "skytpu_train_unproductive_seconds_total")
    assert wall == pytest.approx(prod + unprod, abs=1e-9)
    assert prod == pytest.approx(3 * 0.008)
    assert unprod == pytest.approx(4 * 0.006 + 0.008)
    gauge = metrics_lib.REGISTRY.get("skytpu_train_host_step_seconds")
    assert gauge.labels(host="gate-host").value == pytest.approx(0.014)


def test_calibrated_device_time_wins_over_the_fallback(clock):
    """A calibrator that has sampled the watch's last key supplies
    ``dev_ms_est``; the warm-up step never carries one."""
    class Cal:
        def estimate(self, key):
            return 0.0055 if key == "train_step[tokens=2x8]" else None

    watch = fl.CompileWatch(event_name="train.unexpected_compile")
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(), enable=True,
                                watch=watch, calibrator=Cal())
    step = watch.wrap("train_step", lambda s, b: clock.sleep(0.01),
                      key_fn=lambda a, k: [("tokens", "2x8")])
    recs = []
    for i in range(2):
        gp.step_start(i)
        with gp.phase("compute"):
            step(None, None)
        recs.append(gp.step_end(tokens=16))
    assert recs[0]["compiled"] == ["train_step[tokens=2x8]"]
    assert "dev_ms_est" not in recs[0]
    assert recs[1]["dev_ms_est"] == 5.5 and "compiled" not in recs[1]


def test_snapshot_buckets_sum_to_elapsed(clock):
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                host="0", enable=True)
    with gp.account("restart_replay"):
        clock.sleep(0.01)
    _drive_steps(gp, clock, n_steps=2)
    clock.sleep(0.003)                 # unattributed residue
    snap = gp.snapshot()
    assert sum(snap["buckets"].values()) == \
        pytest.approx(snap["elapsed_s"], abs=1e-9)
    assert snap["buckets"]["restart_replay"] == pytest.approx(0.01)
    assert snap["buckets"]["host_other"] == pytest.approx(0.003)
    assert 0.0 <= snap["goodput_ratio"] <= 1.0
    assert snap["goodput_ratio"] == pytest.approx(
        snap["buckets"]["productive"] / snap["elapsed_s"])


def test_disabled_recorder_is_noop():
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, enable=False)
    gp.step_start(0)
    with gp.phase("compute"):
        pass
    with gp.account("ckpt_stall"):
        pass
    assert gp.step_end(tokens=8) is None
    assert rec.tail() == []
    assert gp.snapshot()["buckets"]["productive"] == 0.0


def test_env_disable_and_host_id(monkeypatch):
    monkeypatch.setenv("SKYTPU_GOODPUT", "0")
    assert gp_lib.GoodputRecorder(recorder=fl.FlightRecorder()) \
        .enabled is False
    monkeypatch.delenv("SKYTPU_GOODPUT")
    assert gp_lib.GoodputRecorder(recorder=fl.FlightRecorder()) \
        .enabled is True
    monkeypatch.setenv("SKYTPU_HOST_ID", "5")
    assert gp_lib.host_id() == "5"
    assert gp_lib.GoodputRecorder(
        recorder=fl.FlightRecorder()).snapshot()["host"] == "5"


def test_unknown_phase_and_bucket_rejected():
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                enable=True)
    with pytest.raises(ValueError):
        with gp.phase("mystery"):
            pass
    with pytest.raises(ValueError):
        with gp.account("mystery"):
            pass


# ---------------------------------------------------------------------------
# Restart-surviving stamps.

def test_stamps_persist_and_fold_across_restart(tmp_path, clock):
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                host="0", enable=True)
    _drive_steps(gp, clock, n_steps=2, tokens=16)
    assert gp.persist(str(tmp_path)) is True
    stamps = json.load(open(tmp_path / gp_lib.STAMPS_FILE))
    assert stamps["steps"] == 2 and stamps["tokens"] == 32
    gp2 = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                 host="0", enable=True)
    assert gp2.load_stamps(str(tmp_path)) is True
    _drive_steps(gp2, clock, n_steps=1, tokens=16)
    snap = gp2.snapshot()
    assert snap["steps"] == 3 and snap["tokens"] == 48
    assert snap["elapsed_s"] > stamps["elapsed_s"]
    assert sum(snap["buckets"].values()) == \
        pytest.approx(snap["elapsed_s"], abs=1e-9)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stamps_cross_package(tmp_path, monkeypatch, clock, writer):
    """Each package's ``load_stamps`` folds the other's ``goodput.json``
    in: the same file, the same fold."""
    monkeypatch.setattr(jgp, "time", clock)
    libs = {"port": (gp_lib, fl), "reference": (jgp, jfl)}
    w_lib, w_fl = libs[writer]
    r_lib, r_fl = libs["reference" if writer == "port" else "port"]
    w = w_lib.GoodputRecorder(recorder=w_fl.FlightRecorder(), host="0",
                              enable=True)
    with w.account("warmup_compile"):
        clock.sleep(2.0)
    _drive_steps(w, clock, n_steps=3, tokens=10)
    assert w.persist(str(tmp_path))
    stamps = w.stamps()
    r = r_lib.GoodputRecorder(recorder=r_fl.FlightRecorder(), host="0",
                              enable=True)
    assert r.load_stamps(str(tmp_path)) is True
    snap = r.snapshot()
    assert snap["steps"] == 3 and snap["tokens"] == 30
    assert snap["elapsed_s"] == pytest.approx(stamps["elapsed_s"])
    assert snap["buckets"] == pytest.approx(stamps["buckets"])
    assert snap["buckets"]["warmup_compile"] == pytest.approx(2.008)


def test_stamps_corrupt_or_missing_is_fresh_start(tmp_path):
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                enable=True)
    assert gp.load_stamps(str(tmp_path)) is False
    (tmp_path / gp_lib.STAMPS_FILE).write_text("{not json")
    assert gp.load_stamps(str(tmp_path)) is False
    (tmp_path / gp_lib.STAMPS_FILE).write_text("[1, 2]")
    assert gp.load_stamps(str(tmp_path)) is False
    off = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                 enable=False)
    assert off.persist(str(tmp_path / "off")) is False
    assert not (tmp_path / "off").exists()
    blocked = tmp_path / "blocked"
    blocked.write_text("")            # a FILE where a directory goes
    assert gp.persist(str(blocked / "d")) is False


# ---------------------------------------------------------------------------
# The anomaly watchdog.

@pytest.fixture
def fresh_events(tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.EVENTS_DIR_ENV_VAR, str(tmp_path))
    monkeypatch.delenv(tracing.ENV_VAR, raising=False)
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SKYTPU_INCIDENT_MIN_INTERVAL_S", "0")
    forensics._last_capture_s = 0.0
    tracing._reset_for_tests()
    yield str(tmp_path)
    tracing._reset_for_tests()


def _anomaly_events():
    return [r for r in tracing.buffered_records()
            if r.get("name") == "train.anomaly"]


def test_nan_latch_exactly_one_event_and_bundle(fresh_events):
    rec = fl.FlightRecorder()
    rec.record("train_step", step=1, dur_s=0.01)
    wd = gp_lib.AnomalyWatchdog(recorder=rec)
    before = metrics_lib.REGISTRY.snapshot()
    for step in range(5):
        wd.observe(step, 2.0 - 0.01 * step)
    info = wd.observe(5, float("nan"))
    assert info["kind"] == "non_finite" and info["signal"] == "loss"
    assert wd.observe(6, float("nan")) is None
    assert wd.observe(7, float("inf")) is None
    after = metrics_lib.REGISTRY.snapshot()
    assert _counter_delta(before, after,
                          "skytpu_train_anomalies_total") == 1
    assert len(_anomaly_events()) == 1
    base = forensics.incidents_dir()
    bundles = [n for n in os.listdir(base)
               if n.endswith("train-anomaly-non_finite")]
    assert len(bundles) == 1
    assert info["incident"] in bundles
    flight_tail = open(os.path.join(
        base, bundles[0], "flight.jsonl")).read()
    assert json.loads(flight_tail.splitlines()[0])["step"] == 1
    assert wd.observe(8, 1.9) is None
    info2 = wd.observe(9, float("nan"))
    assert info2 is not None and info2["kind"] == "non_finite"
    assert len(_anomaly_events()) == 2


def test_nan_grad_fires_and_never_poisons_estimators(fresh_events):
    wd = gp_lib.AnomalyWatchdog(recorder=fl.FlightRecorder())
    wd.observe(0, 2.0, grad_norm=1.0)
    info = wd.observe(1, 2.0, grad_norm=float("inf"))
    assert info["kind"] == "non_finite" and info["signal"] == "grad_norm"
    assert wd._last_grad == 1.0
    assert math.isfinite(wd._last_loss)


def test_spike_detection_and_cooldown(fresh_events):
    wd = gp_lib.AnomalyWatchdog(min_samples=5, cooldown_steps=10,
                                spike_factor=4.0,
                                recorder=fl.FlightRecorder())
    step = 0
    for _ in range(12):
        wd.observe(step, 2.0 + 0.01 * (step % 2))
        step += 1
    info = wd.observe(step, 12.0)
    assert info is not None and info["kind"] == "loss_spike"
    assert info["delta"] > info["threshold"]
    assert wd.observe(step + 1, 30.0) is None
    assert len(_anomaly_events()) == 1


def test_grad_spike_and_env_knobs(fresh_events, monkeypatch):
    monkeypatch.setenv("SKYTPU_ANOMALY_SPIKE_FACTOR", "3")
    monkeypatch.setenv("SKYTPU_ANOMALY_MIN_SAMPLES", "6")
    monkeypatch.setenv("SKYTPU_ANOMALY_COOLDOWN_STEPS", "bogus")
    wd = gp_lib.AnomalyWatchdog(recorder=fl.FlightRecorder())
    assert (wd.spike_factor, wd.min_samples, wd.cooldown_steps) == \
        (3.0, 6, 50)
    for step in range(10):
        assert wd.observe(step, 2.0, grad_norm=1.0 + 0.01 * (step % 2)) \
            is None
    info = wd.observe(10, 2.0, grad_norm=9.0)
    assert info["kind"] == "grad_spike"


def test_spike_needs_min_samples(fresh_events):
    wd = gp_lib.AnomalyWatchdog(min_samples=50,
                                recorder=fl.FlightRecorder())
    for step in range(10):
        wd.observe(step, 2.0)
    assert wd.observe(10, 100.0) is None


def test_anomaly_pause_lands_in_open_step_ledger(fresh_events):
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, host="0", enable=True)
    wd = gp_lib.AnomalyWatchdog(recorder=rec, goodput=gp)
    gp.step_start(0)
    with gp.phase("compute"):
        pass
    assert wd.observe(0, float("nan"))["kind"] == "non_finite"
    r = gp.step_end(tokens=1)
    assert r["phases"].get("anomaly_pause", 0.0) >= 0.0
    assert "anomaly_pause" in r["phases"]


# ---------------------------------------------------------------------------
# The reference's SLO rules over the port's /metrics.

def _fams():
    """The port's exposition as the reference's watchdog receives it."""
    return jm.parse_exposition(metrics_lib.render())


def _train_events(events, rule):
    return [e["event"] for e in events if e["rule"] == rule]


def test_goodput_floor_rule_reads_the_port_families():
    (rule,) = [r for r in slo.DEFAULT_RULES
               if r.name == "train-goodput-floor"]
    for name in (rule.metric, rule.denominator):
        fam = metrics_lib.REGISTRY.get(name)
        assert fam is not None and fam.type == "counter"
    assert metrics_lib.REGISTRY.get(rule.metric).labelnames == ("bucket",)
    assert "warmup_compile" in gp_lib.BUCKETS


def _watch_windows(drive, span=310.0):
    """Feed the reference watchdog (its DEFAULT_RULES) three snapshots
    of the port's families, ``span`` seconds apart (both of its windows
    then reach the previous snapshot), calling ``drive`` between them;
    returns the transition events of every pass."""
    wd = slo.Watchdog(rules=list(slo.DEFAULT_RULES))
    t0 = 1_000_000.0
    events = wd.observe(_fams(), [], ts=t0)
    for i in (1, 2):
        drive()
        events += wd.observe(_fams(), [], ts=t0 + i * span)
    return events


def test_goodput_floor_breaches_on_an_input_bound_run(clock, fresh_events):
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(), host="0",
                                enable=True)
    _drive_steps(gp, clock, n_steps=1)            # the warm-up step

    def input_bound():
        # 40 s of wall a window, three quarters of it waiting on data.
        _drive_steps(gp, clock, n_steps=4, sleep=1.0, data=7.5)

    events = _watch_windows(input_bound)
    assert _train_events(events, "train-goodput-floor") == ["slo.breach"]


def test_goodput_floor_ignores_warmup_compile(clock, fresh_events):
    gp = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(), host="0",
                                enable=True)

    def cold_start():
        # A long warm-up, then productive steps: badput, but expected.
        with gp.account("warmup_compile"):
            clock.sleep(60.0)
        _drive_steps(gp, clock, n_steps=4, sleep=1.0, data=0.01)

    events = _watch_windows(cold_start)
    assert _train_events(events, "train-goodput-floor") == []


def test_step_regression_fires_from_the_trainer_families(monkeypatch, fresh_events):
    """The port trainer's own instrumentation feeds the
    ``train-step-regression`` rule: a trailing median of fast steps,
    then a window of slow ones."""
    from skypilot_tpu_torch.train import trainer as tt
    clock = FakeClock()
    monkeypatch.setattr(tt, "time", clock)
    durs = iter([5.0] + [0.1] * 40 + [1.0] * 6)

    def step(state, batch):
        clock.sleep(next(durs))
        return state, {}

    fn = tt._instrument_step(step)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64)}
    for _ in range(41):
        fn(None, batch)

    def slow():
        for _ in range(3):
            fn(None, batch)

    events = _watch_windows(slow)
    assert _train_events(events, "train-step-regression") == \
        ["slo.breach"]
    median = metrics_lib.REGISTRY.get("skytpu_train_step_median_seconds")
    assert median._require_default().value == pytest.approx(0.1)


def test_unexpected_compile_fires_the_reference_rule(fresh_events):
    """A batch-shape change after warm-up: exactly one typed
    ``train.unexpected_compile`` event, and the reference's
    ``unexpected-compiles`` rule pages on the port's counter."""
    from skypilot_tpu_torch.models import llama as tl
    from skypilot_tpu_torch.train import trainer as tt
    cfg = tl.CONFIGS["llama3-tiny"]
    tc = tt.TrainConfig(warmup_steps=1, total_steps=4)
    watch = fl.CompileWatch(event_name="train.unexpected_compile")
    step = tt.make_train_step(cfg, tc, watch=watch)
    state = tt.create_train_state(cfg, tc, device="cpu")
    small = tt.synthetic_batch(cfg, 1, 8, device="cpu")
    big = tt.synthetic_batch(cfg, 2, 8, device="cpu")
    step(state, small)
    watch.declare_warm()

    def shape_change():
        step(state, small)
        step(state, big)
        step(state, big)

    # The first window holds the new shape's first dispatch: a page.
    # The second holds only programs already seen: it recovers.
    wd_events = _watch_windows(shape_change)
    assert _train_events(wd_events, "unexpected-compiles") == \
        ["slo.breach", "slo.recovered"]
    typed = [r for r in tracing.buffered_records()
             if r.get("name") == "train.unexpected_compile"]
    assert [r["attrs"]["program"] for r in typed] == \
        ["train_step[tokens=2x8]"]
    assert watch.unexpected == ["train_step[tokens=2x8]"]


# ---------------------------------------------------------------------------
# CLI surfaces: `skytpu train-why` and `skytpu top` over the port.

def test_train_why_cli(fresh_events, clock):
    from click.testing import CliRunner
    from skypilot_tpu.client import cli as cli_mod
    rec = fl.FlightRecorder()
    gp = gp_lib.GoodputRecorder(recorder=rec, host="0", enable=True)
    _drive_steps(gp, clock, n_steps=3)
    rec.flush()
    runner = CliRunner()
    res = runner.invoke(cli_mod.cli, ["train-why"])
    assert res.exit_code == 0, res.output
    assert "train step 2" in res.output
    assert "sum (= wall)" in res.output
    assert "compute" in res.output
    res = runner.invoke(cli_mod.cli, ["train-why", "--step", "1"])
    assert res.exit_code == 0 and "train step 1" in res.output
    res = runner.invoke(cli_mod.cli, ["train-why", "--json"])
    assert res.exit_code == 0
    payload = json.loads(res.output)
    assert payload["ledger"]["step"] == 2
    assert payload["summary"]["steps"] == 3
    res = runner.invoke(cli_mod.cli, ["train-why", "--step", "99"])
    assert res.exit_code != 0


def test_train_why_cli_no_records(fresh_events):
    from click.testing import CliRunner
    from skypilot_tpu.client import cli as cli_mod
    res = CliRunner().invoke(cli_mod.cli, ["train-why"])
    assert res.exit_code != 0


def test_top_train_columns_over_the_port_families(clock, fresh_events):
    """``skytpu top``'s train line over two scrapes of the port's
    registry: the host's goodput, and the straggler lag between two
    hosts' step gauges."""
    from skypilot_tpu.client import cli as cli_mod
    from skypilot_tpu_torch.observability import attribution
    attribution.ROOFLINE_PEAK_FLOPS.set(0.5e12)
    slow = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                  host="top-3", enable=True)
    fast = gp_lib.GoodputRecorder(recorder=fl.FlightRecorder(),
                                  host="top-0", enable=True,
                                  param_count=10**9)
    _drive_steps(fast, clock, n_steps=2, sleep=0.010)    # 35 ms steps
    _drive_steps(slow, clock, n_steps=2, sleep=0.02)     # 70 ms steps
    before = _fams()
    _drive_steps(fast, clock, n_steps=2, sleep=0.010)
    after = _fams()
    # Other recorders in this process publish their own host series:
    # keep this test's two.
    for fams in (before, after):
        name = "skytpu_train_host_step_seconds"
        fams[name]["samples"] = [(lab, v) for lab, v in fams[name]["samples"]
                                 if lab["host"].startswith("top-")]
    frame = cli_mod._render_top_frame(
        before, 1000.0, after, 1010.0, {"components": [], "alerts": []})
    train = next(line for line in frame.splitlines()
                 if line.startswith("train"))
    assert "straggler host-top-3 (+35 ms)" in train
    # The gauge holds the newest step's recorder ratio; the window's
    # FLOPs are fast's two warm steps over 10 s at a 0.5e12 peak.
    assert f"goodput {fast.snapshot()['goodput_ratio']:5.1%}" in train
    assert f"mfu {2 * 6 * 10**9 * 64 / 10 / 0.5e12:5.1%}" in train
