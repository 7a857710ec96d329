"""The port's training loop observed (``skypilot_tpu_torch/train/run.py``
with ``observability/goodput.py``, the trainer's and the checkpoints'
families, timeline spans and step callbacks), against the reference on
the CPU at llama3-tiny.

- The metric families of the port's trainer, checkpoints and goodput
  module equal the reference's in name, type, labels, help and buckets.
- ``train.run.main``'s summary line has the reference's keys
  (``goodput`` among them); recorder on and off (``SKYTPU_GOODPUT=0``)
  give bit-equal losses and state; a run crashed by a
  ``train.checkpoint_save`` fault and resumed folds the first run's
  stamps and books the restore as ``restart_replay``; a
  ``train.checkpoint_restore`` fault fires through a plan.
- The records a run flushes are read by the reference's ``skytpu
  train-why``; the timeline file holds the checkpoint spans; the step
  callback's summary counts the steps.
- The device tail: the loop ends ``compute`` on the step's completion
  at exactly the steps whose loss it fetches, and never with the
  recorder off."""

import ast
import json
import pathlib

import pytest
import torch

from skypilot_tpu_torch import chaos
from skypilot_tpu_torch.observability import flight as fl
from skypilot_tpu_torch.observability import goodput as gp_lib
from skypilot_tpu_torch.observability import metrics as tm
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.train import checkpoints as ck
from skypilot_tpu_torch.train import run
from skypilot_tpu_torch.train import trainer as tt
from skypilot_tpu_torch.utils import timeline

# One intra-op thread: the suite runs several test files at once on a
# few cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMON = ["--device", "cpu", "--config", "llama3-tiny", "--batch", "2",
          "--seq", "32", "--steps", "4", "--log-every", "1",
          "--ckpt-every", "2"]


@pytest.fixture
def env(tmp_path, monkeypatch):
    """Logs, incidents and step summaries of this test's own."""
    monkeypatch.setenv(tracing.EVENTS_DIR_ENV_VAR, str(tmp_path / "ev"))
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SKYTPU_CALLBACK_LOG_DIR", str(tmp_path / "cb"))
    monkeypatch.delenv("SKYTPU_GOODPUT", raising=False)
    monkeypatch.delenv(timeline.ENV_VAR, raising=False)
    fl.RECORDER._reset_for_tests()
    chaos._reset_for_tests()
    yield tmp_path
    chaos._reset_for_tests()


def _main(capsys, *argv):
    res = run.main([*COMMON, *argv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return res, line


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _counter(name, **labels):
    fam = tm.REGISTRY.get(name)
    return (fam.labels(**labels) if labels else fam._require_default()).value


# ---------------------------------------------------------------------------
# Families.

@pytest.mark.parametrize("mod", ["train.trainer", "train.checkpoints",
                                 "observability.goodput"])
def test_families_equal_the_reference(mod):
    import importlib
    from skypilot_tpu.observability import metrics as jm
    mine = importlib.import_module(f"skypilot_tpu_torch.{mod}")
    theirs = importlib.import_module(f"skypilot_tpu.{mod}")

    def families(m, metric_cls):
        return {v.name: v for v in vars(m).values()
                if isinstance(v, metric_cls)}

    got = families(mine, tm.Metric)
    want = families(theirs, jm.Metric)
    assert sorted(got) == sorted(want) and got
    for name, fam in got.items():
        ref = want[name]
        assert (fam.type, fam.labelnames, fam.help) == \
            (ref.type, ref.labelnames, ref.help), name
        assert getattr(fam, "buckets", None) == \
            getattr(ref, "buckets", None), name


# ---------------------------------------------------------------------------
# train.run.main.

def _reference_summary_keys():
    """The keys of the dict the reference's ``main`` prints last."""
    tree = ast.parse((ROOT / "skypilot_tpu/train/run.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "final_loss" in keys:
                return set(keys)
    raise AssertionError("no summary dict in the reference's run.py")


def test_summary_keys_and_families_move(env, capsys):
    steps0 = _counter("skytpu_train_steps_total")
    saves0 = _counter("skytpu_checkpoint_saves_total")
    res, line = _main(capsys, "--ckpt-dir", str(env / "a"))
    assert set(line) == _reference_summary_keys()
    assert 0.0 < line["goodput"] < 1.0
    assert line["goodput"] == round(res["snapshot"]["goodput_ratio"], 4)
    assert _counter("skytpu_train_steps_total") - steps0 == 4
    assert _counter("skytpu_checkpoint_saves_total") - saves0 == 2
    state = ck.CheckpointManager(str(env / "a")).restore()
    from skypilot_tpu_torch.observability import attribution
    assert _counter("skytpu_ckpt_bytes", kind="total") == \
        attribution.tensor_bytes(state)
    assert _counter("skytpu_train_loss") == pytest.approx(
        res["losses"][-1])
    # The ledger: four records, the first the warm-up, each an exact
    # partition; the stamps beside the checkpoints.
    recs = res["records"]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert [r["warm"] for r in recs] == [False, True, True, True]
    assert recs[0]["compiled"] == ["train_step[tokens=2x32]"]
    for r in recs:
        assert sum(r["phases"].values()) == \
            pytest.approx(r["dur_s"] * 1e3, abs=0.05)
        assert r["loss"] in res["losses"] and r["toks"] == 64
    assert [("ckpt_save" in r["phases"]) for r in recs] == \
        [False, True, False, True]
    snap = res["snapshot"]
    assert snap["steps"] == 4 and snap["tokens"] == 256
    assert sum(snap["buckets"].values()) == \
        pytest.approx(snap["elapsed_s"], abs=1e-6)
    assert snap["buckets"]["warmup_compile"] > 0
    stamps = json.loads((env / "a" / gp_lib.STAMPS_FILE).read_text())
    assert stamps["steps"] == 4
    cb = json.loads((env / "cb" / "benchmark_summary.json").read_text())
    assert cb["total_steps"] == 4 and cb["steps"] >= 1


def test_recorder_off_is_bit_equal(env, capsys, monkeypatch):
    on, _ = _main(capsys, "--ckpt-dir", str(env / "on"))
    monkeypatch.setenv("SKYTPU_GOODPUT", "0")
    off, line = _main(capsys, "--ckpt-dir", str(env / "off"))
    assert off["losses"] == on["losses"]
    assert _equal(ck.CheckpointManager(str(env / "on")).restore(step=4),
                  ck.CheckpointManager(str(env / "off")).restore(step=4))
    assert off["records"] == [] and line["goodput"] == 0.0
    assert not (env / "off" / gp_lib.STAMPS_FILE).exists()


def test_crash_then_resume_folds_the_stamps(env, capsys):
    """A ``train.checkpoint_save`` fault at step 4 kills the run after
    step 2's save; the resumed run equals an uninterrupted one and its
    snapshot carries the first run's stamps."""
    full, _ = _main(capsys, "--ckpt-dir", str(env / "a"))
    b = str(env / "b")
    inj = chaos.configure({"seed": 0, "faults": [
        {"point": "train.checkpoint_save", "match": {"step": "4"},
         "times": 1}]})
    with pytest.raises(chaos.ChaosError):
        run.main([*COMMON, "--ckpt-dir", b])
    assert [f["ctx"] for f in inj.fired] == [{"step": "4"}]
    chaos.deactivate()
    assert ck.CheckpointManager(b).all_steps() == [2]
    prior = json.loads((env / "b" / gp_lib.STAMPS_FILE).read_text())
    assert prior["steps"] >= 1 and prior["elapsed_s"] > 0
    resumed, line = _main(capsys, "--ckpt-dir", b, "--resume")
    assert line["steps"] == 2
    assert resumed["losses"] == full["losses"][2:]
    assert _equal(ck.CheckpointManager(str(env / "a")).restore(step=4),
                  ck.CheckpointManager(b).restore(step=4))
    snap = resumed["snapshot"]
    assert snap["steps"] == prior["steps"] + 2
    assert snap["tokens"] == prior["tokens"] + 2 * 64
    assert snap["buckets"]["restart_replay"] > 0
    assert snap["elapsed_s"] > snap["session_elapsed_s"]
    assert snap["elapsed_s"] == pytest.approx(
        prior["elapsed_s"] + snap["session_elapsed_s"])
    # A resumed run's first step is its warm-up, as the reference's.
    assert [r["warm"] for r in resumed["records"]] == [False, True]


def test_restore_fault_fires_through_a_plan(env, capsys):
    d = str(env / "c")
    _main(capsys, "--ckpt-dir", d, "--steps", "2")
    inj = chaos.configure({"seed": 0, "faults": [
        {"point": "train.checkpoint_restore", "times": 1}]})
    with pytest.raises(chaos.ChaosError):
        run.main([*COMMON, "--ckpt-dir", d, "--resume"])
    assert [f["point"] for f in inj.fired] == ["train.checkpoint_restore"]
    assert inj.observed["train.checkpoint_restore"] == 1


def test_train_why_and_timeline_read_the_run(env, capsys, monkeypatch):
    from click.testing import CliRunner
    from skypilot_tpu.client import cli as cli_mod
    trace = env / "trace.json"
    monkeypatch.setenv(timeline.ENV_VAR, str(trace))
    timeline._events.clear()
    try:
        _main(capsys, "--ckpt-dir", str(env / "a"))
        timeline.save_now()
    finally:
        timeline._events.clear()
        timeline._named_tids.clear()
    fl.RECORDER.flush()
    res = CliRunner().invoke(cli_mod.cli, ["train-why", "--json"])
    assert res.exit_code == 0, res.output
    payload = json.loads(res.output)
    assert payload["ledger"]["step"] == 3
    assert payload["summary"]["steps"] == 4
    assert sum(p["ms"] for p in payload["ledger"]["phases"]) == \
        pytest.approx(payload["ledger"]["wall_ms"], abs=0.05)
    res = CliRunner().invoke(cli_mod.cli, ["train-why", "--step", "1"])
    assert res.exit_code == 0 and "ckpt_save" in res.output
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert names.count("skytpu_checkpoint_save_seconds") == 2
    assert names.count("skytpu_checkpoint_wait_seconds") == 1
    spans = [r["name"] for r in tracing.buffered_records()
             if r.get("kind") == "span"]
    for name in ("train.step", "train.checkpoint_save",
                 "train.checkpoint_wait"):
        assert name in spans, name


@pytest.mark.parametrize("goodput", ["1", "0"])
def test_device_tail_waits_only_at_fetch_steps(env, capsys, monkeypatch,
                                               goodput):
    """``compute`` ends on the step's completion at the steps whose loss
    the cadence fetches (2, 4 and the last, 5, at --log-every 2), and
    the recorder off never waits."""
    monkeypatch.setenv("SKYTPU_GOODPUT", goodput)
    drained = []
    monkeypatch.setattr(run, "_drain", lambda dev: drained.append(dev))
    res, _ = _main(capsys, "--steps", "5", "--log-every", "2")
    assert len(res["losses"]) == 3
    assert len(drained) == (3 if goodput == "1" else 0)
    if goodput == "1":
        assert [("eval" in r["phases"]) for r in res["records"]] == \
            [False, True, False, True, True]


def test_entry_point_needs_a_card_unless_asked(monkeypatch):
    """``train.run`` resolves its device through ``resolve_device``: on
    a machine without a card, asking for nothing raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--config", "llama3-tiny", "--steps", "1"])


def test_instrumented_step_skips_the_first_call(monkeypatch):
    calls0 = tm.REGISTRY.get("skytpu_train_step_seconds") \
        ._require_default().hist_state()[0]
    before = sum(calls0)
    cfg = tt.llama.CONFIGS["llama3-tiny"]
    tc = tt.TrainConfig(warmup_steps=1, total_steps=3)
    state = tt.create_train_state(cfg, tc, device="cpu")
    batch = tt.synthetic_batch(cfg, 1, 8, device="cpu")
    step = tt.make_train_step(cfg, tc)
    tokens0 = _counter("skytpu_train_tokens_total")
    for _ in range(3):
        state, metrics = step(state, batch)
    after = sum(tm.REGISTRY.get("skytpu_train_step_seconds")
                ._require_default().hist_state()[0])
    assert after - before == 2
    assert _counter("skytpu_train_tokens_total") - tokens0 == 3 * 8
    assert _counter("skytpu_train_tokens_per_second") > 0
    assert tt._batch_key_fn((state, batch), {}) == [("tokens", "1x8")]
