"""The port's checkpoints, train entry point and evaluation on the CPU:
async save/restore semantics (interval, force, max_to_keep, the host
snapshot taken before ``save`` returns), resume equal to an
uninterrupted run through ``train.run.main``, the summary line's keys,
``evaluate.main``, and no thread left behind."""

import json
import math
import os
import shutil
import threading

import pytest
import torch

from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.train import checkpoints as ck
from skypilot_tpu_torch.train import evaluate as ev
from skypilot_tpu_torch.train import run
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


def _state(seed=0):
    return tt.create_train_state(tl.CONFIGS["llama3-tiny"],
                                 tt.TrainConfig(mu_dtype="bfloat16"),
                                 device="cpu", seed=seed)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _writers():
    return [t for t in threading.enumerate()
            if t.name.startswith("ckpt-save")]


def test_round_trip_and_restore_into_target(tmp_path):
    state = _state()
    state["step"] = 7
    with ck.CheckpointManager(str(tmp_path / "c")) as mgr:
        assert mgr.save(7, state)
        mgr.wait()
        assert mgr.latest_step() == 7 and mgr.all_steps() == [7]
        got = mgr.restore()
        assert _equal(got, state)
        assert got["opt_state"]["mu"]["embed"].dtype == torch.bfloat16
        target = _state(seed=1)
        assert not _equal(target, state)
        out = mgr.restore(target)
        assert out is target and _equal(target, state)
        with pytest.raises(ValueError):
            bad = _state()
            bad["params"]["embed"] = bad["params"]["embed"][:3]
            mgr.restore(bad)
    assert os.path.exists(tmp_path / "c" / "7" / "state.pt")


def test_interval_force_and_max_to_keep(tmp_path):
    state = _state()
    with ck.CheckpointManager(str(tmp_path / "c"), max_to_keep=2,
                              save_interval_steps=2) as mgr:
        assert not mgr.save(1, state)          # off the interval
        assert mgr.save(2, state)
        assert not mgr.save(2, state, force=True)   # already saved
        assert mgr.save(3, state, force=True)
        assert not mgr.save(2, state)          # not after the latest
        assert mgr.save(4, state)
        assert mgr.save(6, state)
        mgr.wait()
        assert mgr.all_steps() == [4, 6]
    assert sorted(os.listdir(tmp_path / "c")) == ["4", "6"]


def test_save_snapshots_before_returning(tmp_path):
    """The train step updates the state in place; a save must hold the
    values of the moment it was called."""
    state = _state()
    before = ck._map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else x, state)
    with ck.CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(1, state)
        for t in tt._layer_leaves(state["params"]):
            t.add_(1.0)                        # mutate while it writes
        state["opt_state"]["count"] = 99
        mgr.wait()
        assert _equal(mgr.restore(), before)


def test_restore_missing_raises(tmp_path):
    with ck.CheckpointManager(str(tmp_path / "none")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        with pytest.raises(FileNotFoundError):
            mgr.restore(step=3)


def test_failed_write_is_reraised_by_wait(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "c"))
    assert mgr.save(1, {"bad": threading.Lock()})   # cannot be pickled
    with pytest.raises(TypeError):
        mgr.wait()
    assert mgr.all_steps() == []
    mgr.close()
    assert not _writers()


def test_no_thread_left_after_close(tmp_path):
    state = _state()
    mgr = ck.CheckpointManager(str(tmp_path / "c"))
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.close()
    assert not _writers()
    assert mgr.all_steps() == [1, 2, 3]


def _run(capsys, *argv):
    res = run.main(["--device", "cpu", "--config", "llama3-tiny",
                    "--batch", "2", "--seq", "32", "--log-every", "1",
                    *argv])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    return res, json.loads(last)


def test_resume_equals_uninterrupted_run(tmp_path, capsys):
    """4 steps with a checkpoint every 2; step 2 copied to a fresh
    directory and resumed to 4 gives the same losses and the same
    step-4 state, bit for bit."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["--steps", "4", "--ckpt-every", "2"]
    full, line = _run(capsys, *common, "--ckpt-dir", a)
    assert set(line) == {"final_loss", "steps", "wall_s", "tokens_per_sec",
                         "tokens_per_sec_per_chip", "goodput", "mesh"}
    assert line["steps"] == 4 and line["mesh"] == {}
    assert line["tokens_per_sec"] == line["tokens_per_sec_per_chip"] > 0
    assert len(full["losses"]) == 4 and full["losses"][-1] < full["losses"][0]
    shutil.copytree(os.path.join(a, "2"), os.path.join(b, "2"))
    resumed, line_b = _run(capsys, *common, "--ckpt-dir", b, "--resume")
    assert line_b["steps"] == 2
    assert resumed["losses"] == full["losses"][2:]
    assert line_b["final_loss"] == line["final_loss"]
    assert _equal(ck.CheckpointManager(a).restore(step=4),
                  ck.CheckpointManager(b).restore(step=4))
    # Resuming at the end trains nothing.
    done, line_c = _run(capsys, *common, "--ckpt-dir", b, "--resume")
    assert line_c == {"steps": 0, "resumed_step": 4, "mesh": {}}
    assert not _writers()


def test_packed_run_and_evaluate(tmp_path, capsys):
    d = str(tmp_path / "p")
    res, line = _run(capsys, "--steps", "2", "--packed", "--ckpt-dir", d,
                     "--xent-chunk", "8")
    assert line["steps"] == 2 and all(map(math.isfinite, res["losses"]))
    assert not [t for t in threading.enumerate() if t.name == "prefetch"]
    out = ev.main(["--device", "cpu", "--config", "llama3-tiny",
                   "--ckpt-dir", d, "--batches", "2", "--batch", "2",
                   "--seq", "32", "--packed"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and out["batches"] == 2 and out["tokens"] > 0
    assert out["perplexity"] > 1 and 0 <= out["accuracy"] <= 1
    fresh = ev.main(["--device", "cpu", "--config", "llama3-tiny",
                     "--batches", "1", "--batch", "2", "--seq", "16"])
    assert fresh["tokens"] == 2 * 15


def test_evaluate_weights_by_tokens():
    batches = [{"l": 1.0, "t": 10.0, "a": 0.5}, {"l": 3.0, "t": 30.0,
                                                 "a": 0.0}]

    def loss_fn(_, b):
        return (torch.tensor(b["l"]), {"tokens": torch.tensor(b["t"]),
                                       "accuracy": torch.tensor(b["a"])})

    out = ev.evaluate(loss_fn, None, batches)
    assert out["loss"] == 2.5 and out["tokens"] == 40
    assert out["accuracy"] == 0.125 and out["batches"] == 2
    assert ev.evaluate(loss_fn, None, [])["batches"] == 0
