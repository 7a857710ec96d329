"""The port's sparse MoE decoder against the JAX package's on the CPU, at
moe-tiny in float32: the expert FFN's routing (expert choices and
capacity keep masks) and outputs where tokens drop and where none do,
the forward, loss, aux loss and gradients, five trainer steps,
``train.run --model moe`` resuming from a checkpoint and
``train.evaluate --model moe``; and MoE serving through the port's
``InferenceEngine``: greedy tokens equal to the JAX engine's across a
wave, a chunked prompt, a prefix hit and n-gram verify rounds, the
reference's own decode contracts, and the ``weights_int8`` refusal."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from skypilot_tpu.infer import engine as je
from skypilot_tpu.models import moe as jm
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.data import input_pipeline as tip
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.models import moe as tm
from skypilot_tpu_torch.train import checkpoints as ck
from skypilot_tpu_torch.train import evaluate as ev
from skypilot_tpu_torch.train import run
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

# A token whose router probabilities have two neighbours (among the
# first k + 1, sorted) closer than this may order its choices either way
# under float32 summation-order noise; routing is compared on the rest.
_GAP = 1e-5


def _cfgs(**kw):
    jcfg = dataclasses.replace(jm.CONFIGS["moe-tiny"], dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(tm.CONFIGS["moe-tiny"], dtype=torch.float32,
                               **kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return _np_tree(jm.init_params(jax.random.key(0), jcfg))


def _port_params(jp, tcfg):
    return tm.params_from_numpy(jp, tcfg, device="cpu")


# -- the expert FFN -----------------------------------------------------------

def _jax_route(jcfg, h, w_router):
    """The JAX module's router and capacity assignment
    (``skypilot_tpu/models/moe.py`` ``moe_ffn``), step for step."""
    B, S, _ = h.shape
    E, K = jcfg.n_experts, jcfg.top_k
    C = jm.expert_capacity(jcfg, S)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", h, w_router), axis=-1)
    _, idx = lax.top_k(probs, K)
    mask = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = mask.reshape(B, S * K, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(B, S, K, E)
    return np.asarray(probs), np.asarray(idx), np.asarray(mask * (pos < C))


@pytest.mark.parametrize("capacity", [1.25, 4.0],
                         ids=["drops", "generous"])
def test_moe_ffn_routing_and_output_match_jax(jax_params, capacity):
    """At the default capacity factor tokens drop; at 4.0 none do. Expert
    choices agree for every token whose router gap exceeds 1e-5, keep
    masks on every row with no such near-tie (a flipped near-tie
    reorders the row's later claims); the output within 1e-5 of
    max|out|."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity)
    rng = np.random.default_rng(3)
    layer = {k: v[0] for k, v in jax_params["blocks"].items()}
    # Tilted toward expert 0's router column, so that expert's buffer
    # overflows at the default capacity (balanced inputs fit it here).
    w0 = layer["w_router"][:, 0]
    h = (rng.standard_normal((3, 40, jcfg.d_model))
         + 1.5 * w0 / np.linalg.norm(w0)).astype(np.float32)
    jout, jaux = jm.moe_ffn(jcfg, jnp.asarray(h),
                            jax.tree.map(jnp.asarray, layer))
    jprobs, jidx, jkeep = _jax_route(jcfg, jnp.asarray(h),
                                     jnp.asarray(layer["w_router"]))
    tlayer = {k: torch.from_numpy(v) for k, v in layer.items()}
    th = torch.from_numpy(h)
    out, aux = tm.moe_ffn(tcfg, th, tlayer)
    _, _, idx, keep, _ = tm.route(tcfg, th, tlayer["w_router"])

    top = -np.sort(-jprobs, axis=-1)[..., :jcfg.top_k + 1]
    clear = (np.abs(np.diff(top, axis=-1)) > _GAP).all(axis=-1)   # [B, S]
    print(f"capacity {capacity}: {int((~clear).sum())} of {clear.size} "
          f"tokens within {_GAP} of a routing tie")
    np.testing.assert_array_equal(idx.numpy()[clear], jidx[clear])
    rows = clear.all(axis=1)
    np.testing.assert_array_equal(keep.numpy()[rows], jkeep[rows])
    kept, pairs = int(jkeep.sum()), jkeep.shape[0] * 40 * jcfg.top_k
    assert (kept < pairs) if capacity < 2 else (kept == pairs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=1e-5 * np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_expert_capacity_matches_jax():
    jcfg, tcfg = _cfgs()
    for S in (1, 8, 16, 32, 40, 1024):
        assert tm.expert_capacity(tcfg, S) == jm.expert_capacity(jcfg, S)
    assert tm.expert_capacity(tcfg, 32) == int(
        np.ceil(1.25 * tcfg.top_k * 32 / tcfg.n_experts))
    big = dataclasses.replace(tm.CONFIGS["mixtral-8x7b"])
    assert tm.expert_capacity(big, 1) == 1          # decode: S = 1


def test_full_capacity_routes_all_tokens():
    """With capacity >= S * k every (token, choice) pair is kept and each
    token's combine weights sum to 1 (the reference's :40)."""
    _, tcfg = _cfgs(capacity_factor=4.0)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(2), "cpu")
    layer = {k: v[0] for k, v in params["blocks"].items()}
    h = torch.randn((2, 16, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    out, aux = tm.moe_ffn(tcfg, h, layer)
    assert out.shape == h.shape and torch.isfinite(out).all()
    _, gate_vals, _, keep, _ = tm.route(tcfg, h, layer["w_router"])
    assert int(keep.sum()) == 2 * 16 * tcfg.top_k
    weights = (gate_vals[..., None] * keep).sum(dim=(2, 3))
    torch.testing.assert_close(weights, torch.ones_like(weights))
    assert 0.5 < aux.item() < tcfg.n_experts


def test_top_k_breaks_ties_by_index():
    """``lax.top_k``'s order: equal values keep their index order."""
    p = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tm.top_k(p, 2)
    want_v, want_i = lax.top_k(jnp.asarray(p.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_param_counts_match_jax(jax_params):
    for name in ("mixtral-8x7b", "moe-small", "moe-tiny"):
        assert tm.CONFIGS[name].num_params() == \
            jm.CONFIGS[name].num_params()
        assert tm.CONFIGS[name].num_active_params() == \
            jm.CONFIGS[name].num_active_params()
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jax_params))
    assert n == tm.CONFIGS["moe-tiny"].num_params()
    _, tcfg = _cfgs()
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(x.numel() for x in tt._layer_leaves(p)) == n
    assert jax.tree.structure(jax_params) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, p))


# -- forward, loss and gradients ----------------------------------------------

def _batch(kind):
    rng = np.random.default_rng(5)
    if kind == "packed":
        docs = tip.synthetic_doc_stream(40, 512, mean_len=12, seed=0)
        return next(tip.packed_batches(docs, 2, 33))
    return {"tokens": rng.integers(0, 512, (2, 33)).astype(np.int32)}


LOSS_CASES = [("plain", 0), ("packed", 8)]


@pytest.mark.parametrize("kind,chunk", LOSS_CASES,
                         ids=[f"{k}-chunk{c}" for k, c in LOSS_CASES])
def test_forward_loss_and_grads_match_jax(jax_params, kind, chunk):
    """Logits and aux of ``forward``, the loss and its metrics, and every
    gradient (through the per-layer remat that carries aux), float32
    on both sides: within 1e-5 relative."""
    jcfg, tcfg = _cfgs(xent_chunk=chunk)
    jp = jax.tree.map(jnp.asarray, jax_params)
    tp = _port_params(jax_params, tcfg)
    batch = _batch(kind)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "plain":
        jl, ja = jm.forward(jp, jbatch["tokens"], jcfg)
        tl_, ta = tm.forward(tp, torch.from_numpy(batch["tokens"]), tcfg)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl),
                                   atol=1e-5 * np.abs(np.asarray(jl)).max())
        np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch, jcfg), has_aux=True)(jp)
    loss, met, grads = tt.grads_of(tp, tip.to_device(batch, "cpu"), tcfg,
                                   model=tm)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(met) == {"loss", "xent", "aux_loss", "accuracy", "tokens"}
    for key in ("xent", "aux_loss"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(met["accuracy"].item(),
                               float(jmet["accuracy"]), atol=1e-6)
    assert met["tokens"].item() == float(jmet["tokens"])
    want = tt._layer_leaves(_np_tree(jg), tp)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_remat_carries_aux():
    _, tcfg = _cfgs()
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = tip.to_device(_batch("plain"), "cpu")
    a = tt.grads_of(params, batch, tcfg, model=tm)
    b = tt.grads_of(params, batch, dataclasses.replace(tcfg, remat=False),
                    model=tm)
    assert a[0].item() == b[0].item()
    assert a[1]["aux_loss"].item() == b[1]["aux_loss"].item()
    for x, y in zip(a[2], b[2]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_five_steps_match_jax_trainer():
    """Three JAX steps reach a mid-warmup state; both trainers take five
    more: loss and grad_norm within 1e-4 relative per step, the
    parameters after them within 2e-6 + 1e-4 relative (the llama
    trainer test's bounds)."""
    jcfg, tcfg = _cfgs()
    kw = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20,
              grad_clip=0.5)
    jtc, ttc = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    batch = _batch("plain")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jt.make_train_step(jcfg, jtc, None, model=jm)
    jstate = jt.create_train_state(jcfg, jtc, None, seed=0, model=jm)
    for _ in range(3):
        jstate, _ = jstep(jstate, jbatch)
    state = tt.train_state_from_numpy(_np_tree(jstate), tcfg, device="cpu",
                                      model=tm)
    tstep = tt.make_train_step(tcfg, ttc, model=tm)
    tbatch = tip.to_device(batch, "cpu")
    for i in range(5):
        jstate, jmet = jstep(jstate, jbatch)
        state, met = tstep(state, tbatch)
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
    assert state["step"] == int(jstate["step"]) == 8
    want = _np_tree(jstate)
    for w, p in zip(tt._layer_leaves(want["params"], state["params"]),
                    tt._layer_leaves(state["params"])):
        np.testing.assert_allclose(p.numpy(), w, atol=2e-6, rtol=1e-4)


# -- the entry points ---------------------------------------------------------

def _run(capsys, *argv):
    res = run.main(["--device", "cpu", "--model", "moe", "--config",
                    "moe-tiny", "--batch", "2", "--seq", "32",
                    "--log-every", "1", *argv])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    return res, json.loads(last)


def test_run_moe_resumes_bit_for_bit_and_evaluates(tmp_path, capsys):
    """``train.run --model moe``: 4 steps with a checkpoint every 2, the
    step-2 checkpoint resumed to 4 gives the same losses and state bit
    for bit; ``train.evaluate --model moe`` reads the checkpoint."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["--steps", "4", "--ckpt-every", "2", "--xent-chunk", "8"]
    full, line = _run(capsys, *common, "--ckpt-dir", a)
    assert line["steps"] == 4 and line["mesh"] == {
        "pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "tp": 1, "sp": 1}
    assert full["losses"][-1] < full["losses"][0]
    shutil.copytree(os.path.join(a, "2"), os.path.join(b, "2"))
    resumed, line_b = _run(capsys, *common, "--ckpt-dir", b, "--resume")
    assert resumed["losses"] == full["losses"][2:]
    state_a = ck.CheckpointManager(a).restore(step=4)
    state_b = ck.CheckpointManager(b).restore(step=4)
    assert "we_gate" in state_a["params"]["blocks"]
    for x, y in zip(tt._layer_leaves(state_a["params"]),
                    tt._layer_leaves(state_b["params"])):
        assert torch.equal(x, y)
    out = ev.main(["--device", "cpu", "--model", "moe", "--config",
                   "moe-tiny", "--ckpt-dir", a, "--batches", "2",
                   "--batch", "2", "--seq", "32"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and out["tokens"] == 2 * 2 * 31
    assert out["perplexity"] > 1


def test_run_defaults_and_errors(capsys, monkeypatch):
    """The reference's per-model default config (moe-small, and pp-tiny
    for ``--model pipeline``), and its argument errors for adapters on
    MoE and for packed batches on the pipeline."""
    seen = {}

    class Stop(Exception):
        pass

    def spy(cfg, tc, device=None, seed=0, model=None, mesh=None):
        seen["cfg"], seen["model"] = cfg, model
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(tt, "create_train_state", spy)
        with pytest.raises(Stop):
            run.main(["--device", "cpu", "--model", "moe", "--steps", "1"])
    assert seen["cfg"] == tm.CONFIGS["moe-small"] and seen["model"] is tm
    for argv, words in (
            (["--lora", "4"], "--lora currently supports --model llama only"),
            (["--qlora", "4"],
             "--qlora currently supports --model llama only")):
        with pytest.raises(SystemExit):
            run.main(["--device", "cpu", "--model", "moe", *argv])
        assert words in capsys.readouterr().err
    from skypilot_tpu_torch.parallel import pipeline as tpl
    with monkeypatch.context() as m:
        m.setattr(tt, "create_train_state", spy)
        with pytest.raises(Stop):
            run.main(["--device", "cpu", "--model", "pipeline", "--steps",
                      "1"])
    assert seen["cfg"] == tpl.CONFIGS["pp-tiny"] and seen["model"] is tpl
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--model", "pipeline", "--packed"])
    assert ("--packed is not supported with --model pipeline"
            in capsys.readouterr().err)


# -- serving --------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(jax_params):
    jcfg, tcfg = _cfgs()
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jax_params), \
        _port_params(jax_params, tcfg)


# A shared system prompt of 16 tokens (two chunks of 8), so the pair's
# second prompt hits the first's stored prefix and resumes as a chunk.
_SYSTEM = list(range(5, 21))


def _serve_workload(mk, vocab):
    """One engine (4 slots, max_len 64, blocks of 16, chunks of 8, a
    prefix pool of 4, n-gram K 4, waves of 2): two wave prompts, a
    20-token prompt (three chunks) and the first of a shared-prefix
    pair; then the pair's second, which hits, beside a prompt that
    repeats the first wave prompt after its own continuation, so the
    n-gram drafter proposes that continuation. Returns (engine, per
    request in rid order: tokens, cached_len, chunks, drafted and
    accepted)."""
    rng = np.random.default_rng(7)
    e = mk(n_slots=4, max_len=64, prompt_buckets=(16, 32), kv_block=16,
           prefill_chunk=8, prefix_pool=4, spec_k=4, max_wave=2)
    first = [rng.integers(1, vocab, 5).tolist(),
             rng.integers(1, vocab, 7).tolist(),
             rng.integers(1, vocab, 20).tolist(),
             _SYSTEM + [40, 41, 42]]
    out = e.generate(first, max_new_tokens=24)
    echo = first[0] + out[0][:8] + first[0]
    e.generate([_SYSTEM + [50, 51], echo], max_new_tokens=24)
    return e, [(r.tokens, r.cached_len, r.n_chunks, r.spec_drafted,
                r.spec_accepted)
               for r in sorted(e.finished, key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def jax_served(served):
    jcfg, _, jp, _ = served
    e, toks = _serve_workload(
        lambda **kw: je.InferenceEngine(jp, jcfg, kv_kernel=True, **kw),
        jcfg.vocab_size)
    return toks


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_engine_tokens_match_jax_engine(served, jax_served, plain):
    """moe-tiny in float32 at capacity 1.25: the port engine's greedy
    tokens equal the JAX engine's across waves, a chunked prompt, a
    prefix hit that resumes as a chunk and n-gram verify rounds."""
    _, tcfg, _, tp = served
    e, toks = _serve_workload(
        lambda **kw: te.InferenceEngine(tp, tcfg, device="cpu",
                                        plain_attention=plain, **kw),
        tcfg.vocab_size)
    assert toks == jax_served
    assert e.prefix_hits == 1 and e.verify_calls >= 2
    assert toks[2][2] == 3 and toks[4][1] == 16     # chunks, the hit
    assert toks[4][3] > 0 and toks[5][3] > 0        # drafted


@pytest.fixture(scope="module")
def generous():
    """The reference's MoE serving setup: moe-tiny (bf16 compute) with
    capacity 4.0, so no routing drops."""
    cfg = dataclasses.replace(tm.CONFIGS["moe-tiny"], capacity_factor=4.0)
    return cfg, tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _oracle(params, cfg, seq):
    return tm.forward(params, torch.tensor([seq]), cfg)[0][0, -1]


def test_moe_engine_serves(generous):
    """The reference's ``test_moe_engine_serves`` on the paged programs:
    the wave prefill's logits and the next decode step's match the full
    forward (rtol 2e-2, atol 6e-2), and the engine generates."""
    cfg, params = generous
    prompt = [3, 17, 42, 7]
    cache = tkv.init_paged_cache(cfg, 1, 2, 16, "cpu")
    table = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :4] = torch.tensor(prompt)
    prefix, logits0 = tkv.prefill_batch(params, padded, torch.tensor([4]),
                                        cfg)
    tok0 = int(logits0[0].argmax())
    tkv.insert(cache, {k: v[:, 0] for k, v in prefix.items()}, 0, 4, tok0,
               table)
    logits1 = tkv.step_logits(params, cache, cfg, table)
    torch.testing.assert_close(logits1[0], _oracle(params, cfg,
                                                   prompt + [tok0]),
                               rtol=2e-2, atol=6e-2)
    torch.testing.assert_close(logits0[0], _oracle(params, cfg, prompt),
                               rtol=2e-2, atol=6e-2)
    e = te.InferenceEngine(params, cfg, n_slots=2, max_len=32,
                           prompt_buckets=(16,), kv_block=16, device="cpu")
    out = e.generate([prompt], max_new_tokens=4)[0]
    assert len(out) == 4 and all(0 <= t < cfg.vocab_size for t in out)


def test_staged_burst_cache_matches_oracle(generous):
    """The reference's ``test_staged_burst_cache_matches_oracle[moe]``:
    after one staged burst of 4, the next step's logits through the
    flushed cache match a full forward over prompt + generated tokens."""
    cfg, params = generous
    e = te.InferenceEngine(params, cfg, n_slots=2, max_len=64,
                           prompt_buckets=(8,), kv_block=16,
                           prefill_chunk=0, device="cpu")
    prompt = [3, 17, 42, 7]
    e.add_request(list(prompt), max_new_tokens=16)
    e.admit()
    out = e.decode_burst(max_burst=4)
    (req,) = e.slot_req.values()
    assert len(req.tokens) == 5
    assert list(out.values())[0] == req.tokens[1:]
    logits = tkv.step_logits(e.params, e.cache, cfg, e.table_device())
    torch.testing.assert_close(logits[req.slot],
                               _oracle(params, cfg, prompt + req.tokens),
                               rtol=2e-2, atol=6e-2)


def test_weights_int8_refuses_moe(generous):
    cfg, params = generous
    with pytest.raises(NotImplementedError,
                       match="weights_int8 is not supported for MoE"):
        te.InferenceEngine(params, cfg, n_slots=1, max_len=32,
                           prompt_buckets=(16,), kv_block=16,
                           weights_int8=True, device="cpu")
    with pytest.raises(NotImplementedError):
        je.InferenceEngine(
            jm.init_params(jax.random.key(0), jm.CONFIGS["moe-tiny"]),
            jm.CONFIGS["moe-tiny"], n_slots=1, max_len=32,
            prompt_buckets=(16,), weights_int8=True)
