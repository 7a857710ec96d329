"""``train.run`` and the checkpoints over a device mesh of CPU ranks
(gloo): ``--tp 2``, ``--fsdp`` (the default factorization) and ``--dp
2`` against the world-1 run, the summary's ``mesh``, the flags still
refused, the reference's argument errors, checkpoints that cross meshes
bit for bit, and ``--model pipeline --pp 2`` and ``--sp 2 --zigzag
--packed`` against the JAX step on the same mesh."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_ranks
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability.goodput import STAMPS_FILE
from skypilot_tpu_torch.parallel import distributed as tdist
from skypilot_tpu_torch.train import checkpoints as tck
from skypilot_tpu_torch.train import run as trun
from skypilot_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

ARGV = ["--device", "cpu", "--config", "llama3-tiny", "--seq", "32",
        "--steps", "3", "--log-every", "1", "--batch", "8"]

_RUN_BODY = """
import contextlib, io
from skypilot_tpu_torch.train import run
argv = json.load(open(os.path.join(DIR, "argv.json")))
with contextlib.redirect_stdout(io.StringIO()) as buf:
    res = run.main(argv)
summary = json.loads(buf.getvalue().strip().splitlines()[-1])
json.dump({"losses": res.get("losses"), "summary": summary},
          open(os.path.join(DIR, f"rank{RANK}.json"), "w"))
"""


def _run_ranks(tmp_path, argv, n=2):
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(argv, f)
    torch_ranks.run_ranks(n, _RUN_BODY, tmp_path)
    return [json.load(open(tmp_path / f"rank{r}.json")) for r in range(n)]


def _world1(argv, capsys):
    res = trun.main(argv)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return res, summary


MESH_FLAGS = {"tp2": (["--tp", "2"], dict(tp=2, fsdp=1, dp=1)),
              "fsdp2": ([], dict(tp=1, fsdp=2, dp=1)),
              "dp2": (["--dp", "2"], dict(tp=1, fsdp=1, dp=2))}


@pytest.mark.parametrize("name", list(MESH_FLAGS))
def test_run_over_two_ranks_gives_the_world_1_losses(name, tmp_path,
                                                     capsys):
    """llama3-tiny, 3 steps of one batch of 8 x 32 over two ranks: every
    rank logs the world-1 run's losses. The activations are bf16 (the
    config's), and a sharded product rounds its partial sums to bf16
    before adding them, so the losses agree to 1e-3 relative (they read
    within 1e-4). The summary's ``mesh`` is the reference's dict, and
    tokens/s per chip divides by the world."""
    flags, sizes = MESH_FLAGS[name]
    want, _ = _world1(ARGV, capsys)
    got = _run_ranks(tmp_path, ARGV + flags)
    for r in got:
        assert len(r["losses"]) == 3
        for a, b in zip(r["losses"], want["losses"]):
            assert a == pytest.approx(b, rel=1e-3)
        mesh = r["summary"]["mesh"]
        assert mesh == dict(pp=1, ep=1, sp=1, **sizes)
        assert r["summary"]["tokens_per_sec_per_chip"] == pytest.approx(
            r["summary"]["tokens_per_sec"] / 2, abs=0.1)
    assert got[0]["losses"] == got[1]["losses"]


def test_world_1_summary_keeps_the_reference_mesh_dict(capsys):
    res, summary = _world1(ARGV[:-2] + ["--steps", "1"], capsys)
    assert summary["mesh"] == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1,
                               "tp": 1, "sp": 1}
    assert summary["tokens_per_sec_per_chip"] == summary["tokens_per_sec"]
    assert res["steps"] == 1


REFUSED = {"ep": (["--ep", "2"], "expert parallelism")}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_flags_are_refused_by_name(name, capsys):
    flags, what = REFUSED[name]
    with pytest.raises(SystemExit):
        trun.main(ARGV + flags)
    err = capsys.readouterr().err
    assert "not ported yet" in err and what in err


ARG_ERRORS = {
    "packed-pipeline": ["--model", "pipeline", "--packed"],
    "packed-before-zigzag": ["--model", "pipeline", "--packed", "--zigzag"],
    "zigzag-pipeline": ["--model", "pipeline", "--zigzag"],
    "lora-pipeline": ["--model", "pipeline", "--lora", "4"],
    "qlora-moe": ["--model", "moe", "--qlora", "4"],
}


@pytest.mark.parametrize("name", list(ARG_ERRORS))
def test_argument_errors_are_the_references(name, capsys, monkeypatch):
    """The reference's ``train/run.py`` argument errors, in its order,
    word for word (both mains exit before any model or device work)."""
    import sys
    from skypilot_tpu.train import run as jrun
    argv = ["--steps", "1"] + ARG_ERRORS[name]
    monkeypatch.setattr(sys, "argv", ["run"] + argv)
    with pytest.raises(SystemExit):
        jrun.main()
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit):
        trun.main(argv)
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split("error: ")[1] == want.split("error: ")[1]


@pytest.mark.parametrize("flags,what", [
    (["--model", "moe", "--config", "moe-tiny"], "sharded MoE step"),
    (["--lora", "4"], "sharded LoRA step")],
    ids=["moe", "lora"])
def test_mesh_only_refusals_need_more_than_one_rank(flags, what, capsys,
                                                    monkeypatch):
    """``--model moe`` and ``--lora`` run on one rank and are refused
    over more (the world size patched to 2, before any group opens)."""
    monkeypatch.setattr(tdist, "world_size", lambda: 2)
    argv = [a for a in ARGV if a != "llama3-tiny"]
    argv = argv[:argv.index("--config")] + argv[argv.index("--config") + 1:]
    with pytest.raises(SystemExit):
        trun.main(argv + flags)
    err = capsys.readouterr().err
    assert "not ported yet" in err and what in err


def test_a_mesh_that_the_world_does_not_fill_is_refused(capsys):
    with pytest.raises(ValueError, match="not divisible"):
        trun.main(ARGV + ["--tp", "2"])


_CKPT_BODY = """
import dataclasses
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import checkpoints, trainer as tt
cfg = dataclasses.replace(llama.CONFIGS["llama3-tiny"], dtype=torch.float32)
tc = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
mesh = mesh_lib.make_mesh(mesh_lib.MeshShape(tp=2), "cpu")
# 1. A tp 2 state, one step on, saved: rank 0 writes it whole.
state = tt.create_train_state(cfg, tc, "cpu", seed=5, mesh=mesh)
tt.make_train_step(cfg, tc, mesh=mesh)(
    state, tt.synthetic_batch(cfg, 2, 17, seed=2, device="cpu"))
with checkpoints.CheckpointManager(os.path.join(DIR, "from_tp2")) as mgr:
    mgr.save(1, state)
    mgr.wait()
    assert mgr.latest_step() == 1
whole = {p: t.full_tensor() for p, t in leaves(state["params"])}
whole.update({"mu/" + p: t.full_tensor()
              for p, t in leaves(state["opt_state"]["mu"])})
if RANK == 0:
    torch.save(whole, os.path.join(DIR, "tp2_whole.pt"))
# 2. A world-1 checkpoint restored onto tp 2: each rank's shard is its
# slice of the saved tensor, the whole is the saved tensor.
mgr = checkpoints.CheckpointManager(os.path.join(DIR, "from_w1"))
got = mgr.restore(device="cpu", shardings=tt.state_shardings(cfg, mesh))
saved = mgr.restore(device="cpu")
for part in ("params",):
    for (p, t), (_, w) in zip(leaves(got[part]), leaves(saved[part])):
        assert torch.equal(t.to_local(), distribute_tensor(
            w, mesh, t.placements, src_data_rank=None).to_local()), p
        assert torch.equal(t.full_tensor(), w), p
for (p, t), (_, w) in zip(leaves(got["opt_state"]["nu"]),
                          leaves(saved["opt_state"]["nu"])):
    assert torch.equal(t.full_tensor(), w), p
assert got["step"] == saved["step"] == 1
# ... and into a sharded target in place.
target = tt.create_train_state(cfg, tc, "cpu", seed=9, mesh=mesh)
mgr.restore(target)
for (p, t), (_, w) in zip(leaves(target["params"]), leaves(saved["params"])):
    assert torch.equal(t.full_tensor(), w), p
mgr.close()
# The next step on the restored state runs.
_, m = tt.make_train_step(cfg, tc, mesh=mesh)(
    got, tt.synthetic_batch(cfg, 2, 17, seed=2, device="cpu"))
print("RESULT", float(m["loss"]), flush=True)
"""


def test_checkpoints_cross_meshes_bit_for_bit(tmp_path):
    """A tp 2 checkpoint restores at world 1 bit for bit (the ranks'
    gathered tensors), and a world-1 checkpoint restores onto tp 2 bit
    for bit (each rank's shard its slice), through ``shardings=`` and
    into a sharded target."""
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32)
    tc = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    w1 = tt.create_train_state(cfg, tc, "cpu", seed=7)
    tt.make_train_step(cfg, tc)(w1, tt.synthetic_batch(cfg, 2, 17, seed=2,
                                                       device="cpu"))
    with tck.CheckpointManager(str(tmp_path / "from_w1")) as mgr:
        mgr.save(1, w1)
        mgr.wait()
    outs = torch_ranks.run_ranks(2, _CKPT_BODY, tmp_path)
    losses = {o.strip().splitlines()[-1] for o, _ in outs}
    assert len(losses) == 1, losses     # every rank: the same loss
    whole = torch.load(tmp_path / "tp2_whole.pt")
    restored = tck.CheckpointManager(str(tmp_path / "from_tp2")).restore(
        device="cpu")
    assert restored["step"] == 1 and restored["opt_state"]["count"] == 1
    for path, t in _leaves(restored["params"]):
        assert torch.equal(t, whole[path]), path
    for path, t in _leaves(restored["opt_state"]["mu"]):
        assert torch.equal(t, whole["mu/" + path]), path


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_run_resumes_a_tp2_checkpoint_at_world_1(tmp_path, capsys):
    """``train.run`` saves at tp 2 (two ranks, 2 steps) and resumes at
    world 1 to step 3: the resumed run's last loss is the uninterrupted
    world-1 run's, to the bf16 tolerance above."""
    ckpt = str(tmp_path / "ckpt")
    argv = ARGV[:ARGV.index("--steps")] + ARGV[ARGV.index("--steps") + 2:]
    _run_ranks(tmp_path, argv + ["--steps", "2", "--tp", "2",
                                 "--ckpt-dir", ckpt])
    assert tck.CheckpointManager(ckpt).latest_step() == 2
    # Rank 0 alone wrote the goodput stamps beside the checkpoints.
    assert os.path.exists(os.path.join(ckpt, STAMPS_FILE))
    res, summary = _world1(argv + ["--steps", "3", "--ckpt-dir", ckpt,
                                   "--resume"], capsys)
    assert summary["steps"] == 1
    want, _ = _world1(ARGV, capsys)
    assert res["losses"][-1] == pytest.approx(want["losses"][-1], rel=1e-3)
    assert not torch.distributed.is_initialized()


# -- context and pipeline parallelism through train.run ----------------------


def _jax_run_losses(model: str, argv_cfg, shape: dict, rules, batches,
                    tstate, steps: int):
    """The JAX step on a ``shape`` mesh of its CPU devices from the port's
    initial state ``tstate`` (numpy), ``train.run``'s schedule (lr 3e-4,
    warmup max(1, min(100, steps // 10))), over ``batches``: its losses."""
    import jax
    import jax.numpy as jnp
    from skypilot_tpu.parallel import mesh as jmesh
    from skypilot_tpu.train import trainer as jt
    if model == "pipeline":
        from skypilot_tpu.parallel import pipeline as jm
    else:
        from skypilot_tpu.models import llama as jm
    cfg = jm.CONFIGS[argv_cfg]
    tc = jt.TrainConfig(learning_rate=3e-4,
                        warmup_steps=max(1, min(100, steps // 10)),
                        total_steps=steps)
    mesh = jmesh.make_mesh(jmesh.MeshShape(**shape),
                           jax.devices()[:2])
    state = jt.create_train_state(cfg, tc, mesh, model=jm)
    state = dict(state, params=jax.device_put(
        jax.tree.map(jnp.asarray, tstate),
        jt.state_shardings(cfg, mesh, model=jm)["params"]))
    step = jt.make_train_step(cfg, tc, mesh, model=jm, act_rules=rules)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else
            v.detach().float().numpy() for k, v in tree.items()}


def test_pipeline_over_two_pp_ranks_matches_the_jax_step(tmp_path):
    """``train.run --model pipeline --pp 2`` (pp-tiny, bf16, batch 8 x
    32, 3 steps) on two CPU ranks, one stage each: every rank logs the
    losses of the JAX pipeline step on a pp 2 mesh from the port's
    initial parameters, within 5e-3 relative (bf16 activations; the two
    sides round their products' partial sums apart)."""
    from skypilot_tpu.parallel import sharding as jsh
    from skypilot_tpu_torch.parallel import pipeline as tpl
    argv = ["--device", "cpu", "--model", "pipeline", "--seq", "32",
            "--steps", "3", "--log-every", "1", "--batch", "8", "--pp", "2"]
    got = _run_ranks(tmp_path, argv)
    cfg = tpl.CONFIGS["pp-tiny"]
    tc = tt.TrainConfig()
    init = tt.create_train_state(cfg, tc, "cpu", model=tpl)["params"]
    batch = {k: v.numpy() for k, v in
             tt.synthetic_batch(cfg, 8, 32, device="cpu").items()}
    want = _jax_run_losses("pipeline", "pp-tiny", dict(pp=2),
                           jsh.ACT_RULES, [batch] * 3, _np_tree(init), 3)
    for r in got:
        assert r["summary"]["mesh"]["pp"] == 2
        for a, b in zip(r["losses"], want):
            assert a == pytest.approx(b, rel=5e-3)
    assert got[0]["losses"] == got[1]["losses"]


def test_sp2_zigzag_packed_run_matches_the_jax_step(tmp_path):
    """``train.run --sp 2 --zigzag --packed`` (llama3-tiny, bf16, packed
    documents of 64, 3 steps) on two CPU ranks: the zigzag ring over sp
    2, every rank's losses those of the JAX step on an sp 2 mesh with
    the zigzag rule, from the port's initial parameters on the same
    packed batches, within 5e-3 relative."""
    from skypilot_tpu.parallel import sharding as jsh
    from skypilot_tpu_torch.data import input_pipeline as ip
    argv = ["--device", "cpu", "--config", "llama3-tiny", "--seq", "64",
            "--steps", "3", "--log-every", "1", "--sp", "2", "--zigzag",
            "--packed"]
    got = _run_ranks(tmp_path, argv)
    cfg = tl.CONFIGS["llama3-tiny"]
    init = tt.create_train_state(cfg, tt.TrainConfig(), "cpu")["params"]
    docs = ip.synthetic_doc_stream(256, cfg.vocab_size, mean_len=64 // 3,
                                   seed=0)
    stream = ip.packed_batches(docs, 4, 64)
    batches = [{k: np.asarray(v) for k, v in next(stream).items()}
               for _ in range(3)]
    want = _jax_run_losses("llama", "llama3-tiny", dict(sp=2),
                           dict(jsh.ACT_RULES, seq_layout="zigzag"),
                           batches, _np_tree(init), 3)
    for r in got:
        assert r["summary"]["mesh"]["sp"] == 2
        for a, b in zip(r["losses"], want):
            assert a == pytest.approx(b, rel=5e-3)
    assert got[0]["losses"] == got[1]["losses"]


def test_pipeline_over_two_tp_ranks_gives_the_world_1_losses(tmp_path,
                                                            capsys):
    """``train.run --model pipeline --tp 2`` (no pp axis: both stages run
    in turn on each rank, over DTensors split on tp): every rank logs the
    world-1 pipeline run's losses to 1e-3 (bf16 partial sums)."""
    argv = ["--device", "cpu", "--model", "pipeline", "--seq", "32",
            "--steps", "3", "--log-every", "1", "--batch", "8"]
    want, _ = _world1(argv, capsys)
    got = _run_ranks(tmp_path, argv + ["--tp", "2"])
    for r in got:
        assert r["summary"]["mesh"]["tp"] == 2
        assert len(r["losses"]) == 3
        for a, b in zip(r["losses"], want["losses"]):
            assert a == pytest.approx(b, rel=1e-3)
