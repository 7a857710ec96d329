"""The port's LoRA fine-tuning (``skypilot_tpu_torch/train/lora.py``) and
``train.run``'s fine-tuning flags, against the JAX package on the CPU at
llama3-tiny in float32.

- ``merge`` and the merged model's forward equal the reference's; the
  loss and the adapter gradients equal ``jax.value_and_grad`` of the
  reference's merged loss (unchunked, chunked and packed); five steps
  from a shared mid-warmup state equal ``make_lora_train_step``'s
  (adapters, moments, count, loss and ``grad_norm``). Adapters cross
  over through numpy, with a nonzero B (at B = 0, A's gradient is 0).
- The reference tests' contracts (``tests/test_lora.py`` but the
  sharded case): identity at init, the trainable share, the base
  untouched while the adapters learn, an unknown target rejected.
- ``remat_policy="dots"`` gives the loss and gradients of "none" bit
  for bit.
- ``train.run``: the reference's argument errors; ``--lora`` resumed
  from a checkpoint equals the uninterrupted run bit for bit and books
  ``restart_replay``; an adapter the port trained, written by
  ``infer/adapters.save_adapter``, serves through the port's engine and
  catalog the greedy tokens of the port's engine over ``merge``d
  weights, wherever the plain top-2 gap exceeds 1e-2."""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jl
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import run as jrun
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.data import input_pipeline as tip
from skypilot_tpu_torch.infer import adapters as ad
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.train import checkpoints as ck
from skypilot_tpu_torch.train import lora
from skypilot_tpu_torch.train import run
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0


def _cfgs(**kw):
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _np_tree(tree):
    # np.array copies: a donated JAX buffer must not alias these.
    return jax.tree.map(lambda x: np.array(x), tree)


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.fixture(scope="module")
def base():
    jcfg, tcfg = _cfgs()
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jp, tl.params_from_numpy(_np_tree(jp), tcfg, device="cpu")


def _adapters(seed=1, b_std=0.05):
    """The reference's init, with B drawn from seeded numpy: numpy
    leaves for both packages."""
    jcfg, _ = _cfgs()
    a = jlora.init_lora_params(jax.random.key(seed), jcfg,
                               jlora.LoRAConfig(rank=RANK, alpha=ALPHA))
    rng = np.random.default_rng(seed)
    return {t: {"a": np.array(ab["a"]),
                "b": (rng.standard_normal(ab["b"].shape) * b_std
                      ).astype(np.float32)} for t, ab in a.items()}


def _batch(kind):
    rng = np.random.default_rng(5)
    if kind == "packed":
        docs = list(tip.synthetic_doc_stream(40, 512, mean_len=20, seed=0))
        return next(tip.packed_batches(docs, 2, 64))
    return {"tokens": rng.integers(0, 512, (2, 33)).astype(np.int32)}


def test_merge_and_forward_match_jax(base):
    jp, tp = base
    jcfg, tcfg = _cfgs()
    lc, jlc = lora.LoRAConfig(RANK, ALPHA), jlora.LoRAConfig(RANK, ALPHA)
    npa = _adapters()
    jm = jlora.merge(jp, jax.tree.map(jnp.asarray, npa), jlc)
    tm = lora.merge(tp, _to_torch(npa), lc)
    for t in lc.targets:
        np.testing.assert_allclose(tm["blocks"][t].numpy(),
                                   np.asarray(jm["blocks"][t]), atol=1e-6)
    for k in ("embed", "final_norm", "lm_head"):
        assert tm[k] is tp[k]
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24))
    want = np.asarray(jl.forward(jm, jnp.asarray(tokens), jcfg))
    got = tl.forward(tm, torch.from_numpy(tokens), tcfg).numpy()
    # The base forward's rule (tests/test_torch_llama.py): summation
    # order moves a logit by up to ~5e-6.
    np.testing.assert_allclose(got, want, atol=1e-5)
    # The per-layer merge the step runs holds the same numbers.
    per = lora.merged_layers(tp, _to_torch(npa), lc)
    for t in lc.targets:
        torch.testing.assert_close(torch.stack(per["blocks"][t]),
                                   tm["blocks"][t], rtol=0, atol=1e-7)


def test_identity_at_init(base):
    """B starts at zero: the merged model is the base model exactly."""
    _, tp = base
    _, tcfg = _cfgs()
    lc = lora.LoRAConfig(RANK, ALPHA)
    state = lora.create_lora_state(tcfg, lc, tt.TrainConfig(), "cpu", seed=1)
    adapters = state["params"]
    assert all(not ab["b"].any() for ab in adapters.values())
    a = adapters["wq"]["a"]
    assert a.dtype == torch.float32 and a.shape == (2, 128, RANK)
    assert abs(a.std().item() * 128 ** 0.5 - 1) < 0.1    # N(0, 1/d_in)
    merged = lora.merge(tp, adapters, lc)
    for t in lc.targets:
        assert torch.equal(merged["blocks"][t], tp["blocks"][t])
    tokens = torch.tensor([[3, 17, 42, 7]])
    assert torch.equal(tl.forward(merged, tokens, tcfg),
                       tl.forward(tp, tokens, tcfg))
    assert state["step"] == 0 and state["opt_state"]["count"] == 0


def test_trainable_fraction_tiny():
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    lc = lora.LoRAConfig(RANK, ALPHA)
    n = lora.num_trainable_params(tcfg, lc)
    assert n == jlora.num_trainable_params(jcfg, jlora.LoRAConfig(RANK,
                                                                  ALPHA))
    assert 0 < n < tcfg.num_params() * 0.2
    assert lc.scale == jlora.LoRAConfig(RANK, ALPHA).scale == 2.0


@pytest.mark.parametrize("bad", [dict(targets=("w_nonexistent",)),
                                 dict(rank=0)], ids=["target", "rank"])
def test_unknown_target_rejected(bad):
    with pytest.raises(ValueError):
        lora.LoRAConfig(**bad)
    with pytest.raises(ValueError):
        jlora.LoRAConfig(**bad)


# (batch kind, xent_chunk): unchunked, chunked with padding, packed.
LOSS_CASES = [("plain", 0), ("plain", 8), ("packed", 16)]


@pytest.mark.parametrize("kind,chunk", LOSS_CASES,
                         ids=[f"{k}-chunk{c}" for k, c in LOSS_CASES])
def test_loss_and_grads_match_jax(base, kind, chunk):
    """fp32 on both sides: the loss within 1e-5 relative, each adapter
    gradient within 1e-5 of its largest magnitude."""
    jp, tp = base
    jcfg, tcfg = _cfgs(xent_chunk=chunk)
    lc, jlc = lora.LoRAConfig(RANK, ALPHA), jlora.LoRAConfig(RANK, ALPHA)
    npa = _adapters()
    batch = _batch(kind)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.value_and_grad(
        lambda a: jl.loss_fn(jlora.merge(jp, a, jlc), jbatch, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, npa))
    adapters = _to_torch(npa)
    loss, metrics, grads = tt.value_and_grads(
        adapters, lambda a: lora.loss_fn(a, tp, tip.to_device(batch, "cpu"),
                                         tcfg, lc))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["accuracy"].item(),
                               float(jm["accuracy"]), atol=1e-6)
    want = tt._layer_leaves(_np_tree(jg), adapters)
    assert len(want) == len(grads) == 8
    for w, g in zip(want, grads):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clip", "noclip"])
def test_five_steps_match_jax_trainer(base, clip):
    """Three JAX steps reach a mid-warmup state with B moved off zero;
    both steps then take five more from it. Per step, loss and grad_norm
    within 1e-4 relative; after them the adapters within 2e-6 + 1e-4
    relative (the dense trainer test's rule) and the moments within
    1e-4 relative of each leaf's largest."""
    jp, tp = base
    jcfg, tcfg = _cfgs()
    tc_kw = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20,
                 grad_clip=clip)
    jtc, ttc = jt.TrainConfig(**tc_kw), tt.TrainConfig(**tc_kw)
    jlc = jlora.LoRAConfig(RANK, ALPHA)
    batch = _batch("plain")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jlora.make_lora_train_step(jcfg, jlc, jtc, None)
    jstate = jlora.create_lora_state(jcfg, jlc, jtc, None, seed=0)
    for _ in range(3):
        jstate, _ = jstep(jstate, jp, jbatch)
    state = lora.lora_state_from_numpy(_np_tree(jstate), device="cpu")
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    tstep = lora.make_lora_train_step(tcfg, lora.LoRAConfig(RANK, ALPHA),
                                      ttc)
    tbatch = tip.to_device(batch, "cpu")
    snapshot = {k: v.clone() for k, v in tp["blocks"].items()}
    fired = []
    for i in range(5):
        jstate, jm = jstep(jstate, jp, jbatch)
        state, m = tstep(state, tp, tbatch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
        fired.append(float(jm["grad_norm"]) >= clip)
    assert all(fired) if clip < 1 else not any(fired)
    assert state["step"] == int(jstate["step"]) == 8
    want = lora.lora_state_from_numpy(_np_tree(jstate), device="cpu")
    assert state["opt_state"]["count"] == want["opt_state"]["count"] == 8
    for w, p in zip(tt._layer_leaves(want["params"], state["params"]),
                    tt._layer_leaves(state["params"])):
        np.testing.assert_allclose(p.numpy(), w.numpy(), atol=2e-6,
                                   rtol=1e-4)
    for moment in ("mu", "nu"):
        for w, p in zip(tt._layer_leaves(want["opt_state"][moment],
                                         state["params"]),
                        tt._layer_leaves(state["opt_state"][moment],
                                         state["params"])):
            np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4 * w.abs().max().item())
    for k, w in tp["blocks"].items():
        assert torch.equal(w, snapshot[k])


def test_adapters_learn_base_frozen(base):
    """The reference's test: eight steps at lr 5e-3 lower the loss, B
    moves off zero, and the base stays bit for bit."""
    _, tp = base
    _, tcfg = _cfgs()
    lc = lora.LoRAConfig(RANK, ALPHA)
    tc = tt.TrainConfig(learning_rate=5e-3, warmup_steps=1, total_steps=20)
    state = lora.create_lora_state(tcfg, lc, tc, "cpu")
    step = lora.make_lora_train_step(tcfg, lc, tc)
    batch = tt.synthetic_batch(tcfg, 2, 32, device="cpu")
    snapshot = {k: v.clone() for k, v in tp.items()
                if isinstance(v, torch.Tensor)}
    blocks = {k: v.clone() for k, v in tp["blocks"].items()}
    first = None
    for _ in range(8):
        state, metrics = step(state, tp, batch)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first
    assert state["params"]["wq"]["b"].abs().max() > 0
    for k, v in snapshot.items():
        assert torch.equal(tp[k], v)
    for k, v in blocks.items():
        assert torch.equal(tp["blocks"][k], v)


def test_dots_policy_equals_none_for_llama():
    """Saving the 2-D products' outputs changes what the backward
    recomputes, never a number: loss and gradients bit-equal."""
    _, tcfg = _cfgs()
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = tip.to_device(_batch("packed"), "cpu")
    a = tt.grads_of(params, batch, tcfg)
    b = tt.grads_of(params, batch,
                    dataclasses.replace(tcfg, remat_policy="dots"))
    assert a[0].item() == b[0].item()
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


# -- train.run ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--lora", "-1"],
                                  ["--lora", "4", "--qlora", "4"],
                                  ["--qlora", "-2"]],
                         ids=["lora-negative", "exclusive",
                              "qlora-negative"])
def test_run_argument_errors_equal_the_reference(argv, capsys,
                                                 monkeypatch):
    def error_of(call):
        with pytest.raises(SystemExit) as e:
            call()
        assert e.value.code == 2
        return capsys.readouterr().err.strip().splitlines()[-1].split(
            "error: ", 1)[1]

    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    want = error_of(jrun.main)
    assert error_of(lambda: run.main(["--device", "cpu", *argv])) == want


COMMON = ["--device", "cpu", "--config", "llama3-tiny", "--batch", "2",
          "--seq", "32", "--log-every", "1", "--ckpt-every", "2"]


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


def test_lora_resume_equals_uninterrupted_run(tmp_path, capsys,
                                              monkeypatch):
    """``--lora`` 4 steps with a checkpoint every 2; step 2 copied to a
    fresh directory and resumed to 4 gives the same losses and step-4
    adapter state bit for bit, the restore booked as restart_replay."""
    monkeypatch.setenv("SKYTPU_EVENTS_DIR", str(tmp_path / "ev"))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full, line = _main(capsys, "--lora", "4", "--steps", "4",
                       "--ckpt-dir", a)
    assert line["steps"] == 4 and full["losses"][-1] < full["losses"][0]
    state = ck.CheckpointManager(a).restore(step=4)
    assert set(state["params"]) == {"wq", "wk", "wv", "wo"}
    assert state["params"]["wo"]["a"].shape == (2, 4, 32, 4)
    shutil.copytree(os.path.join(a, "2"), os.path.join(b, "2"))
    resumed, line_b = _main(capsys, "--lora", "4", "--steps", "4",
                            "--ckpt-dir", b, "--resume")
    assert line_b["steps"] == 2 and line_b.keys() == line.keys()
    assert resumed["losses"] == full["losses"][2:]
    assert _equal(state, ck.CheckpointManager(b).restore(step=4))
    assert resumed["snapshot"]["buckets"]["restart_replay"] > 0
    assert full["snapshot"]["buckets"]["restart_replay"] == 0


def _first_fork(merged, cfg, prompt, got, want):
    """Hold ``got`` to ``want`` wherever the plain top-2 gap (of the
    merged model, over the context both agree on) exceeds 1e-2: at the
    first token where they part the gap must be within 1e-2, and the
    contexts differ after it."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            ctx = torch.tensor([prompt + want[:i]])
            top2 = tl.forward(merged, ctx, cfg)[0, -1].topk(2).values
            assert (top2[0] - top2[1]).item() <= 1e-2, (i, got, want)
            return i
    assert len(got) == len(want)
    return None


def test_trained_adapter_serves_through_the_catalog(base, tmp_path):
    """An adapter the port trained, saved with ``save_adapter`` (alpha
    from its LoRAConfig), served through the engine's catalog, gives
    the greedy tokens of the engine over ``lora.merge``d weights."""
    _, tp = base
    _, tcfg = _cfgs()
    lc = lora.LoRAConfig(rank=RANK)           # alpha 32: scale 8
    tc = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=8)
    state = lora.create_lora_state(tcfg, lc, tc, "cpu", seed=3)
    step = lora.make_lora_train_step(tcfg, lc, tc)
    batch = tt.synthetic_batch(tcfg, 2, 32, device="cpu")
    for _ in range(6):
        state, _ = step(state, tp, batch)
    path = str(tmp_path / "ft.npz")
    ad.save_adapter(path, state["params"], alpha=lc.alpha)
    merged = lora.merge(tp, state["params"], lc)
    cat = ad.AdapterCatalog(tcfg, n_adapters=2, rank=RANK, device="cpu")
    cat.register("ft", path=path)
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(8, 16), kv_block=16,
              prefill_chunk=8, device="cpu")
    prompts = [[3, 17, 42, 5], [7, 9, 11, 13, 2], list(range(30, 42))]
    served = te.InferenceEngine(tp, tcfg, adapters=cat, **kw)
    ids = [served.add_request(p, 8, adapter="ft") for p in prompts]
    served.run_to_completion()
    got = {r.rid: r.tokens for r in served.finished}
    want = te.InferenceEngine(merged, tcfg, **kw).generate(
        prompts, max_new_tokens=8)
    base_out = te.InferenceEngine(tp, tcfg, **kw).generate(
        prompts, max_new_tokens=8)
    assert want != base_out, "the trained adapter changed nothing"
    for rid, p, w in zip(ids, prompts, want):
        _first_fork(merged, tcfg, p, got[rid], w)
