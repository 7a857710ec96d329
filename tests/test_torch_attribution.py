"""The port's device-time attribution (``skypilot_tpu_torch/
observability/attribution.py``) against the JAX package's on the CPU:
the calibrator's cadence, EWMA and suppression, the HBM ledger and its
CPU cross-check (the typed event once), the peaks table (an H100
matched by the card's name, the env overrides, the CPU placeholder),
``Roofline.record_cost`` on the reference's program dicts,
``analyze_bubbles``/``idle_spans``/``render_bubbles`` on the same
records, and ``tensor_bytes`` counting each storage once
(``tests/test_attribution.py:41-330``); then the port's engine: the
ledger's leak audit, the published peaks and limit, calibration during
serving, and ``SKYTPU_DEVTIME_EVERY=0`` giving the same tokens. The
CUDA-event bracket and the allocator cross-check are held on the card
(``tests/test_torch_kernels_gpu.py``)."""

import numpy as np
import pytest
import torch

from skypilot_tpu.observability import attribution as jat
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import attribution as at
from skypilot_tpu_torch.observability import flight as fl
from skypilot_tpu_torch.observability import metrics as tm
from skypilot_tpu_torch.observability import tracing as ttr

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


def _gauge(name, **labels):
    for smp in tm.REGISTRY.snapshot()[name]["samples"]:
        if smp["labels"] == labels:
            return smp["value"]
    return None


def _counter(name):
    snap = tm.REGISTRY.snapshot()
    return sum(s["value"] for s in snap[name]["samples"]) \
        if name in snap else 0.0


def test_devtime_every_env(monkeypatch):
    monkeypatch.delenv("SKYTPU_DEVTIME_EVERY", raising=False)
    assert at.devtime_every() == 64
    for raw, want in (("8", 8), ("0", 0), ("nonsense", 64)):
        monkeypatch.setenv("SKYTPU_DEVTIME_EVERY", raw)
        assert at.devtime_every() == want == jat.devtime_every()


def test_tick_cadence_off_and_suppressed():
    cal = at.DeviceTimeCalibrator(every=4)
    assert [cal.tick("a") for _ in range(9)] == [
        True, False, False, False, True, False, False, False, True]
    assert cal.tick("b") is True
    assert not any(at.DeviceTimeCalibrator(every=0).tick("p")
                   for _ in range(4))
    cal2 = at.DeviceTimeCalibrator(every=1)
    with tm.suppress():
        assert cal2.tick("p") is False
    assert cal2.tick("p") is True


def test_ewma_update_estimate_and_metrics():
    n0 = _counter("skytpu_devtime_calibrations_total")
    cal, ref = at.DeviceTimeCalibrator(every=1), \
        jat.DeviceTimeCalibrator(every=1)
    for dt in (0.1, 0.2, 0.05):
        cal.update("prog[x]", dt)
        ref.update("prog[x]", dt)
    assert cal.estimate("prog[x]") == ref.estimate("prog[x]")
    assert cal.estimate("never") is None and cal.estimate(None) is None
    assert _counter("skytpu_devtime_calibrations_total") - n0 == 3
    assert _gauge("skytpu_devtime_ewma_ms", program="prog[x]") == \
        pytest.approx(cal.estimate("prog[x]") * 1e3)
    assert cal.summary()["prog[x]"]["dev_ms"] == pytest.approx(
        cal.estimate("prog[x]") * 1e3, abs=1e-4)


def test_timed_call_on_the_cpu_is_a_wall_bracket():
    cal = at.DeviceTimeCalibrator(every=1, device="cpu")
    out = cal.timed_call("prog[y]", lambda a, b: a + b, torch.ones(4),
                         torch.ones(4))
    assert torch.equal(out, torch.full((4,), 2.0))
    assert cal.estimate("prog[y]") > 0 and cal.samples == 1


def test_compile_watch_calibrator_rides_hit_path_only():
    watch = fl.CompileWatch()
    cal = at.DeviceTimeCalibrator(every=1, device="cpu")
    watch.calibrator = cal
    wrapped = watch.wrap("prog", lambda x, k=0: x * k, ("k",))
    wrapped(2, k=3)
    assert cal.samples == 0 and watch.last_key == "prog[k=3]"
    wrapped(2, k=3)
    assert cal.samples == 1 and cal.estimate("prog[k=3]") is not None


def test_ledger_set_snapshot_total_clear():
    led = at.HbmLedger()
    led.set_bytes("weights", 1000)
    led.set_bytes("kv_pool", 500)
    led.set_bytes("kv_used", -3)
    assert led.snapshot() == {"weights": 1000, "kv_pool": 500,
                              "kv_used": 0}
    assert led.total() == 1500
    assert _gauge("skytpu_hbm_bytes", component="weights") == 1000
    led.clear()
    assert led.snapshot() == {} and led.total() == 0


def test_memstats_unavailable_typed_event_once():
    led = at.HbmLedger()

    def events():
        return [r for r in ttr.buffered_records()
                if r.get("name") == "attribution.memstats_unavailable"]

    n0 = len(events())
    assert led.cross_check("cpu") is None
    assert len(events()) == n0 + 1
    assert events()[-1]["attrs"] == {"platform": "cpu",
                                     "fallback": "analytical_ledger_only"}
    assert led.cross_check("cpu") is None
    assert len(events()) == n0 + 1


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (989e12, 3.35e12)),
    ("NVIDIA A100-SXM4-80GB", (0.5e12, 50e9)),
    ("cpu", (0.5e12, 50e9)),
])
def test_device_peaks_by_card_name(monkeypatch, name, want):
    """The card matched by its name; no TPU row exists for a CUDA card
    to fall into, and an unknown card gets the CPU placeholder."""
    monkeypatch.delenv("SKYTPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("SKYTPU_PEAK_GBPS", raising=False)
    monkeypatch.setattr(at, "device_kind", lambda device=None: name.lower())
    assert at.device_peaks() == want
    assert not any(k.startswith("v") for k in at._PEAKS)


def test_device_peaks_env_override_and_cpu(monkeypatch):
    monkeypatch.delenv("SKYTPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("SKYTPU_PEAK_GBPS", raising=False)
    assert at.device_peaks("cpu") == at._PEAKS["cpu"] == jat._PEAKS["cpu"]
    monkeypatch.setenv("SKYTPU_PEAK_TFLOPS", "918")
    monkeypatch.setenv("SKYTPU_PEAK_GBPS", "1638")
    f, b = at.device_peaks("cpu")
    assert f == pytest.approx(918e12) and b == pytest.approx(1638e9)
    # The table alone (the smoke's yardstick) reads no override.
    assert at.datasheet_peaks("nvidia h100 80gb hbm3") == (989e12, 3.35e12)
    assert at.datasheet_peaks("nvidia a100-sxm4-80gb") is None


def _roofline(mod):
    return mod.Roofline(param_count=1000, weight_bytes=2000,
                        kv_token_bytes=16, d_model=8, n_layers=2,
                        n_heads=2, head_dim=4, max_len=128, chunk_tokens=8)


@pytest.mark.parametrize("burst,program,n_slots,toks", [
    ("decode", {"k": 2, "span": 32}, 3, 6),
    ("decode", {"k": 8, "span": None}, 1, 8),
    ("decode1", {"k": 1, "span": 64}, 2, 2),
    ("wave", {"rows": 2, "bucket": 16}, 2, 2),
    ("wave", {"bucket": 64}, 3, 3),
    ("chunk", {"span": 64, "final": True}, 1, 1),
    ("chunk", {"span": None, "final": False}, 1, 0),
    ("verify", {"k": 2, "span": 32}, 2, 4),
    ("draft", {"k": 5, "span": None}, 4, 0),
    ("preempt", {}, 1, 0),
    ("retire", {"layout": "paged"}, 1, 0),
])
def test_roofline_equals_the_reference(burst, program, n_slots, toks):
    assert _roofline(at).record_cost(burst, program, n_slots, toks) == \
        _roofline(jat).record_cost(burst, program, n_slots, toks)


def _rec(ts, dur, burst, **kw):
    r = {"kind": "flight", "ts_s": ts, "dur_s": dur, "burst": burst,
         "program": {}, "toks": 0, "pid": 1, "proc": "p"}
    r.update(kw)
    return r


_WINDOWS = {
    "mixed": [
        _rec(0.000, 0.010, "wave"),
        _rec(0.015, 0.008, "chunk"),
        _rec(0.026, 0.010, "decode", dev_ms_est=6.0),
        _rec(0.040, 0.010, "verify"),
        _rec(0.052, 0.010, "decode", priorities={"1": 2}),
        _rec(0.070, 0.004, "draft"),
        _rec(0.080, 0.0, "preempt"),
        _rec(0.090, 0.010, "decode", stall=True)],
    "residue": [_rec(0.0, 0.010, "flush"), _rec(0.020, 0.010, "decode")],
    "single": [_rec(0.0, 0.01, "decode")],
    "empty": [],
}


@pytest.mark.parametrize("window", sorted(_WINDOWS))
def test_bubbles_equal_the_reference(window):
    recs = _WINDOWS[window]
    rep = at.analyze_bubbles(recs)
    assert rep == jat.analyze_bubbles(recs)
    assert at.idle_spans(recs) == jat.idle_spans(recs)
    assert at.render_bubbles(rep) == jat.render_bubbles(rep)
    if window == "mixed":
        assert rep["coverage"] >= 0.9
        assert set(rep["by_cause"]) <= set(at.BUBBLE_CAUSES)


def test_tensor_bytes_counts_each_storage_once():
    k = torch.zeros((2, 4, 8))
    tree = {"k": k, "views": [k[0], k[:, 1:]], "v": (torch.zeros(3),),
            "none": None}
    assert at.tensor_bytes(tree) == k.numel() * 4 + 3 * 4
    assert at.tensor_bytes(None) == 0


def _engine(**kw):
    cfg = tl.CONFIGS["llama3-tiny"]
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(cfg, gen, device="cpu", dtype=torch.float32)
    return te.InferenceEngine(
        params, cfg, device="cpu", **dict(dict(
            n_slots=4, max_len=128, prompt_buckets=(16, 64),
            prefill_chunk=8, prefix_pool=4, kv_block=16, max_wave=4), **kw))


def _prompts():
    rng = np.random.default_rng(7)
    return ([rng.integers(1, 40, 6).tolist() for _ in range(2)]
            + [rng.integers(1, 40, 20).tolist() for _ in range(2)])


def test_engine_ledger_leak_audit():
    """Admit, retire, clear: every component returns to its post-build
    baseline (the ledger mirrors the engine's own bookkeeping); the
    weights component counts the parameters' storage once."""
    e = _engine()
    base = e.hbm_ledger.snapshot()
    assert base["weights"] == sum(
        t.untyped_storage().nbytes() for t in {
            id(v): v for v in _leaves(e.params)}.values())
    assert base["kv_pool"] == at.tensor_bytes(e.cache) > 0
    assert base["workspace"] > 0
    assert base["kv_used"] == 0 and base["prefix_pinned"] == 0
    e.generate(_prompts(), max_new_tokens=6)
    mid = e.hbm_ledger.snapshot()
    for c in ("weights", "kv_pool", "prefix_pool", "draft_pool",
              "adapter_pool", "workspace"):
        assert mid[c] == base[c], c
    assert mid["prefix_pinned"] > 0
    e.clear_prefix_cache()
    e._refresh_hbm_ledger()
    end = e.hbm_ledger.snapshot()
    assert end == base
    for comp, val in end.items():
        assert _gauge("skytpu_hbm_bytes", component=comp) == val


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_engine_publishes_roofline_peaks_and_limit():
    e = _engine()
    assert _gauge("skytpu_roofline_peak_flops") == at._PEAKS["cpu"][0]
    assert _gauge("skytpu_roofline_peak_hbm_bytes_per_s") == \
        at._PEAKS["cpu"][1]
    assert _gauge("skytpu_hbm_limit_bytes") >= e.hbm_ledger.total()


def test_engine_devtime_calibrates_and_off_is_bit_identical(monkeypatch):
    monkeypatch.setenv("SKYTPU_DEVTIME_EVERY", "1")
    e = _engine(spec_k=2, flight_recorder=fl.FlightRecorder())
    out_on = e.generate(_prompts(), max_new_tokens=6)
    assert e.devtime.samples > 0 and e.devtime.summary()
    assert any("dev_ms_est" in r for r in e.flight.tail())
    monkeypatch.setenv("SKYTPU_DEVTIME_EVERY", "0")
    e2 = _engine(spec_k=2)
    assert e2.generate(_prompts(), max_new_tokens=6) == out_on
    assert e2.devtime.samples == 0
