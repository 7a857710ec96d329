"""The port's QLoRA fine-tuning (``skypilot_tpu_torch/train/qlora.py``)
against the JAX package on the CPU at llama3-tiny in float32, over the
JAX package's own int8 weights (``kvcache.quantize_block_weights`` and
``quantize_head`` of one float init, carried across by
``kvcache.qweights_from_numpy``) and adapters carried through numpy
with a nonzero B.

- ``dequant_weight`` equals the reference's bit for bit; the loss and
  the adapter gradients equal ``jax.value_and_grad`` of the reference's
  ``loss_fn`` (unchunked, chunked, masked, packed); five steps from a
  shared mid-warmup state equal ``make_qlora_train_step``'s.
- The reference tests' contracts (``tests/test_qlora.py``): zero
  adapters against the float model, the loss falling over eight steps,
  every adapter gradient finite and ``wq.b``'s nonzero,
  ``random_quantized_params``' dtypes.
- ``remat_policy="dots"`` gives "none"'s loss and gradients bit for
  bit; the head is dequantized once a step, not once a chunk.
- ``train.run --qlora``: a resume from a checkpoint equals the
  uninterrupted run bit for bit and books ``restart_replay``; the
  summary line has the reference's keys; ``--qlora-random-base`` and
  the quantized float init both train."""

import ast
import dataclasses
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.models import llama as jl
from skypilot_tpu.train import lora as jlora
from skypilot_tpu.train import qlora as jqlora
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.data import input_pipeline as tip
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.train import checkpoints as ck
from skypilot_tpu_torch.train import lora, qlora, run
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK = 4


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
def quantized():
    """(JAX float params, JAX qweights, JAX slim tree, port qweights,
    port slim tree, port float params)."""
    jcfg, tcfg = _cfgs()
    params = jl.init_params(jax.random.key(0), jcfg)
    jqw = jax.jit(lambda p: {"blocks": jkv.quantize_block_weights(p),
                             "head": jkv.quantize_head(p, jcfg)})(params)
    jfp = jkv.slim_params(params)
    tqw = tkv.qweights_from_numpy(_np_tree(jqw), "cpu")
    tfp = tl.params_from_numpy(_np_tree(jfp), tcfg, device="cpu")
    tp = tl.params_from_numpy(_np_tree(params), tcfg, device="cpu")
    return params, jqw, jfp, tqw, tfp, tp


def _adapters(seed=1, b_std=0.05):
    jcfg, _ = _cfgs()
    a = jlora.init_lora_params(jax.random.key(seed), jcfg,
                               jlora.LoRAConfig(rank=RANK))
    rng = np.random.default_rng(seed)
    return {t: {"a": np.array(ab["a"]),
                "b": (rng.standard_normal(ab["b"].shape) * b_std
                      ).astype(np.float32)} for t, ab in a.items()}


def _batch(kind):
    rng = np.random.default_rng(5)
    if kind == "packed":
        docs = list(tip.synthetic_doc_stream(40, 512, mean_len=20, seed=0))
        return next(tip.packed_batches(docs, 2, 64))
    b = {"tokens": rng.integers(0, 512, (2, 33)).astype(np.int32)}
    if kind == "masked":
        b["mask"] = (rng.random((2, 33)) < 0.7).astype(np.float32)
    return b


def test_dequant_weight_matches_jax(quantized):
    _, jqw, _, tqw, _, _ = quantized
    for name, nc in tkv.QUANT_CONTRACT.items():
        jw = {k: v[1] for k, v in jqw["blocks"][name].items()}
        tw = tkv.qlayer_slice(tqw, 1)[name]
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jqlora.dequant_weight(jw, nc, jdt)
                              .astype(jnp.float32))
            got = qlora.dequant_weight(tw, nc, tdt)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.float().numpy(), want)
    head = qlora.dequant_weight(tqw["head"], 1, torch.float32)
    np.testing.assert_array_equal(
        head.numpy(), np.asarray(jqlora.dequant_weight(jqw["head"], 1,
                                                       jnp.float32)))


LOSS_CASES = [("plain", 0), ("plain", 8), ("masked", 12), ("packed", 16)]


@pytest.mark.parametrize("kind,chunk", LOSS_CASES,
                         ids=[f"{k}-chunk{c}" for k, c in LOSS_CASES])
def test_loss_and_grads_match_jax(quantized, kind, chunk):
    """fp32 on both sides: the loss within 1e-5 relative, each adapter
    gradient within 1e-5 of its largest magnitude."""
    _, jqw, jfp, tqw, tfp, _ = quantized
    jcfg, tcfg = _cfgs(xent_chunk=chunk)
    lc, jlc = lora.LoRAConfig(rank=RANK), jlora.LoRAConfig(rank=RANK)
    npa = _adapters()
    batch = _batch(kind)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda a: jqlora.loss_fn(jqw, jfp, a, jbatch, jcfg, jlc),
        has_aux=True))(jax.tree.map(jnp.asarray, npa))
    adapters = _to_torch(npa)
    loss, metrics, grads = tt.value_and_grads(
        adapters, lambda a: qlora.loss_fn(tqw, tfp, a,
                                          tip.to_device(batch, "cpu"),
                                          tcfg, lc))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["accuracy"].item(),
                               float(jm["accuracy"]), atol=1e-6)
    assert metrics["tokens"].item() == float(jm["tokens"])
    want = tt._layer_leaves(_np_tree(jg), adapters)
    assert len(want) == len(grads) == 8
    for w, g in zip(want, grads):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_five_steps_match_jax_trainer(quantized):
    """As ``tests/test_torch_lora.py``'s: three JAX steps, then five on
    each side from the shared state; loss and grad_norm within 1e-4
    relative per step, adapters within 2e-6 + 1e-4 relative, moments
    within 1e-4 relative of each leaf's largest."""
    _, jqw, jfp, tqw, tfp, _ = quantized
    jcfg, tcfg = _cfgs()
    tc_kw = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20,
                 grad_clip=0.5)
    jtc, ttc = jt.TrainConfig(**tc_kw), tt.TrainConfig(**tc_kw)
    jlc = jlora.LoRAConfig(rank=RANK)
    batch = _batch("plain")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jqlora.make_qlora_train_step(jcfg, jlc, jtc)
    jstate = jqlora.create_qlora_state(jcfg, jlc, jtc, seed=0)
    for _ in range(3):
        jstate, _ = jstep(jstate, jqw, jfp, jbatch)
    state = lora.lora_state_from_numpy(_np_tree(jstate), device="cpu")
    tstep = qlora.make_qlora_train_step(tcfg, lora.LoRAConfig(rank=RANK),
                                        ttc)
    tbatch = tip.to_device(batch, "cpu")
    for i in range(5):
        jstate, jm = jstep(jstate, jqw, jfp, jbatch)
        state, m = tstep(state, tqw, tfp, tbatch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
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


def test_zero_adapters_match_fp_model(quantized):
    """The reference's test: with B = 0 the int8 forward is the float
    model up to quantization error (rtol 5e-3 on the loss)."""
    _, _, _, tqw, tfp, tp = quantized
    _, tcfg = _cfgs()
    lc = lora.LoRAConfig(rank=RANK)
    adapters = lora.create_lora_state(tcfg, lc, tt.TrainConfig(), "cpu",
                                      seed=1)["params"]
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        1, 512, (2, 32)).astype(np.int32))}
    with torch.no_grad():
        loss_q, metrics = qlora.loss_fn(tqw, tfp, adapters, batch, tcfg, lc)
        loss_fp, _ = tl.loss_fn(tp, batch, tcfg)
    np.testing.assert_allclose(loss_q.item(), loss_fp.item(), rtol=5e-3)
    assert np.isfinite(metrics["accuracy"].item())


def test_qlora_adapters_learn(quantized):
    """The reference's test: the loss drops by more than 0.5 over eight
    steps at lr 1e-2 on a fixed batch, the base frozen."""
    _, _, _, tqw, tfp, _ = quantized
    _, tcfg = _cfgs()
    lc = lora.LoRAConfig(rank=8)
    tc = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1)
    step = qlora.make_qlora_train_step(tcfg, lc, tc)
    state = qlora.create_qlora_state(tcfg, lc, tc, "cpu")
    snapshot = {n: qw["w"].clone() for n, qw in tqw["blocks"].items()}
    batch = tt.synthetic_batch(tcfg, 2, 32, device="cpu")
    losses = []
    for _ in range(8):
        state, metrics = step(state, tqw, tfp, batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] - 0.5, losses
    assert metrics["grad_norm"].item() > 0
    for n, w in snapshot.items():
        assert torch.equal(tqw["blocks"][n]["w"], w)


def test_qlora_grads_only_adapters(quantized):
    """The reference's test: every adapter gradient finite, and wq's B
    gradient nonzero from B = 0 (it flows through A)."""
    _, _, _, tqw, tfp, _ = quantized
    _, tcfg = _cfgs()
    lc = lora.LoRAConfig(rank=RANK)
    adapters = lora.create_lora_state(tcfg, lc, tt.TrainConfig(), "cpu",
                                      seed=3)["params"]
    batch = {"tokens": torch.ones((2, 32), dtype=torch.int32)}
    _, _, grads = tt.value_and_grads(
        adapters, lambda a: qlora.loss_fn(tqw, tfp, a, batch, tcfg, lc))
    assert all(torch.isfinite(g).all() for g in grads)
    names = [f"{t}.{k}" for t in adapters for k in adapters[t]]
    assert grads[names.index("wq.b")].abs().sum() > 0


def test_random_quantized_params_device_side():
    """The 8B recipe's weight builder: int8 blocks and head, a bf16
    embedding, float32 norms and scales; the loss on it is finite."""
    cfg = tl.CONFIGS["llama3-tiny"]
    fp, qw = tkv.random_quantized_params(cfg, seed=1, device="cpu")
    jfp, jqw = jkv.random_quantized_params(jl.CONFIGS["llama3-tiny"], seed=1)
    for name, q in qw["blocks"].items():
        assert q["w"].dtype == torch.int8 and q["s"].dtype == torch.float32
        assert q["w"].shape == jqw["blocks"][name]["w"].shape
        assert q["s"].shape == jqw["blocks"][name]["s"].shape
    assert qw["head"]["w"].dtype == torch.int8
    assert qw["head"]["s"].shape == jqw["head"]["s"].shape
    assert fp["embed"].dtype == torch.bfloat16
    lc = lora.LoRAConfig(rank=RANK)
    adapters = lora.create_lora_state(cfg, lc, tt.TrainConfig(),
                                      "cpu")["params"]
    with torch.no_grad():
        loss, _ = qlora.loss_fn(qw, fp, adapters,
                                {"tokens": torch.ones((1, 16),
                                                      dtype=torch.int32)},
                                cfg, lc)
    assert torch.isfinite(loss)


def test_dots_policy_equals_none_and_head_once(quantized, monkeypatch):
    """``remat_policy="dots"`` against "none" on a packed, chunked
    batch: loss and gradients bit-equal. The head is dequantized once a
    step (with 4 xent chunks)."""
    _, _, _, tqw, tfp, _ = quantized
    _, tcfg = _cfgs(xent_chunk=16)
    lc = lora.LoRAConfig(rank=RANK)
    adapters = _to_torch(_adapters())
    batch = tip.to_device(_batch("packed"), "cpu")
    calls = []
    real = qlora.dequant_weight

    def counted(qw, n_contract, dtype):
        calls.append(qw["w"].shape)
        return real(qw, n_contract, dtype)

    monkeypatch.setattr(qlora, "dequant_weight", counted)
    runs = [tt.value_and_grads(adapters, lambda a: qlora.loss_fn(
        tqw, tfp, a, batch, dataclasses.replace(tcfg, remat_policy=p), lc))
        for p in ("none", "dots")]
    assert runs[0][0].item() == runs[1][0].item()
    for x, y in zip(runs[0][2], runs[1][2]):
        assert torch.equal(x, y)
    head = tuple(tqw["head"]["w"].shape)
    assert sum(tuple(s) == head for s in calls) == 2       # one a run
    with pytest.raises(ValueError):
        qlora.loss_fn(tqw, tfp, adapters, batch,
                      dataclasses.replace(tcfg, remat_policy="bogus"), lc)


# -- train.run --qlora --------------------------------------------------------

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


@pytest.mark.parametrize("base", ["random", "quantized"])
def test_qlora_resume_equals_uninterrupted_run(tmp_path, capsys,
                                               monkeypatch, base):
    """``--qlora`` 4 steps with a checkpoint every 2 (over the random
    int8 base, or the quantized float init); step 2 copied to a fresh
    directory and resumed to 4 gives the same losses and step-4 state
    bit for bit, the restore booked as ``restart_replay``."""
    monkeypatch.setenv("SKYTPU_EVENTS_DIR", str(tmp_path / "ev"))
    flags = ["--qlora", "4", "--steps", "4"] + (
        ["--qlora-random-base"] if base == "random" else [])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full, line = _main(capsys, *flags, "--ckpt-dir", a)
    assert set(line) == _reference_summary_keys()
    assert line["steps"] == 4 and all(np.isfinite(full["losses"]))
    assert full["losses"][-1] < full["losses"][0]
    shutil.copytree(os.path.join(a, "2"), os.path.join(b, "2"))
    resumed, line_b = _main(capsys, *flags, "--ckpt-dir", b, "--resume")
    assert line_b["steps"] == 2
    assert resumed["losses"] == full["losses"][2:]
    state = ck.CheckpointManager(a).restore(step=4)
    assert set(state["params"]) == {"wq", "wk", "wv", "wo"}
    assert _equal(state, ck.CheckpointManager(b).restore(step=4))
    assert resumed["snapshot"]["buckets"]["restart_replay"] > 0
