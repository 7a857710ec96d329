"""Tensor-parallel serving in the port on the CPU: the engine over a tp
group of two shards (``InferenceEngine(mesh=["cpu", "cpu"])``) against
the port's one-device engine, the JAX engine at tp 1 and the JAX engine
on its 2-device mesh, at llama3-tiny (4 q-heads over 2 kv heads, so tp
<= 2) in float32.

The first seven tests are ``tests/test_infer_tp.py``'s, in order. As
there, parity holds where the joins are exact or below a greedy tie:
float32 (the shards' partial products summed in float32 part from the
unsplit product by float32 rounding, ~1e-7 of the logits) and the w8a8
path with an int8 KV cache, whose int32 partial sums are exact under
any split. Tokens are compared exactly; the per-program outputs within
``RTOL`` of their unsplit twins.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import adapters as tad
from skypilot_tpu_torch.infer import draft as td
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import sampling as tsamp
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.parallel import sharding as sh

import torch_ranks

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

CPU = torch.device("cpu")
TP2 = [CPU, CPU]
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12]]
# One layer's shard-joined outputs against the unsplit program's:
# float32 summation-order noise of the split contractions.
RTOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _engine(models, mesh=None, **kw):
    _, tcfg, _, tp = models
    kw = dict(dict(n_slots=4, max_len=32, prompt_buckets=(8,)), **kw)
    return te.InferenceEngine(tp, tcfg, device=None if mesh else "cpu",
                              mesh=mesh, **kw)


def _generate(models, mesh=None, **kw):
    return _engine(models, mesh, **kw).generate(PROMPTS, max_new_tokens=6)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- tests/test_infer_tp.py, ported -------------------------------------------

@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contig"])
def test_tp_engine_matches_single_device(models, kv_block):
    assert _generate(models, TP2, kv_block=kv_block) == \
        _generate(models, kv_block=kv_block)


@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contig"])
def test_tp_engine_matches_w8a8_and_kv_int8(models, kv_block):
    """The quantized path shards too: int8 weights and their
    per-channel scales split by the same logical names, the int8 KV
    cache and its scales by kv heads."""
    kw = dict(weights_int8=True, kv_int8=True, kv_block=kv_block)
    assert _generate(models, TP2, **kw) == _generate(models, **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "w8a8"])
def test_tp_shardings_actually_split(models, quant):
    """Every big tensor is split, not replicated: each shard holds 1/tp
    of wq, wk, wv, wo, w_gate, w_up, w_down, the embedding and the head
    (int8 and scales under w8a8), and of the cache's kv heads; the norms
    stay whole; the HBM ledger counts one shard's bytes."""
    _, tcfg, _, tp = models
    kw = dict(weights_int8=quant, kv_int8=quant)
    whole, e = _engine(models, **kw), _engine(models, TP2, **kw)
    assert isinstance(e.params, sh.Shards) and len(e.params) == 2
    assert isinstance(e.cache, sh.Shards) and e.tp == 2
    trees = [(whole.params, e.params, tl.param_logical_axes(tcfg))]
    if quant:
        trees.append((whole.qweights, e.qweights,
                      tkv.qweight_logical_axes(tcfg)))
    trees.append((whole.cache, e.cache, tkv.cache_logical_axes(whole.cache)))
    split = set()
    for w_tree, shards, axes in trees:
        for path, w in _leaves(w_tree):
            d = sh.tp_dim(_at(axes, path))
            for r, shard in enumerate(shards):
                got = _at(shard, path)
                if d is None:
                    assert got.shape == w.shape, path
                    continue
                split.add(path)
                assert got.shape[d] * 2 == w.shape[d], path
                assert torch.equal(got, w.chunk(2, dim=d)[r]), path
    names = {p[-1] if p[-1] not in ("w", "s") else p[-2] for p in split}
    assert {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "embed", "k", "v"} <= names
    assert ("head" if quant else "lm_head") in names
    if quant:
        assert {"k_scale", "v_scale"} <= names
    for shard in e.params:
        assert shard["final_norm"].shape == (tcfg.d_model,)
        assert shard["blocks"]["ln1"].shape == (tcfg.n_layers, tcfg.d_model)
    led, whole_led = e.hbm_ledger.snapshot(), whole.hbm_ledger.snapshot()
    # Each shard holds half the kv planes and its own copy of the
    # lengths and pending tokens.
    meta = sum(whole.cache[n].nbytes for n in ("length", "last_token"))
    assert led["kv_pool"] * 2 == whole_led["kv_pool"] + meta
    assert whole_led["weights"] / 2 < led["weights"] < whole_led["weights"]


def test_tp_reset_preserves_shardings(models):
    """After a failure and reset the cache stays split (a whole rebuild
    would not fit the model it exists for), and after a crash recovery
    the requests finish with the uninterrupted run's tokens."""
    e = _engine(models, TP2)
    e.generate(PROMPTS[:1], max_new_tokens=3)
    before = [(c["k"].data_ptr(), c["k"].shape) for c in e.cache]
    e.reset()
    assert isinstance(e.cache, sh.Shards)
    assert [(c["k"].data_ptr(), c["k"].shape) for c in e.cache] == before
    assert all(not c["length"].any() for c in e.cache)
    assert e.generate(PROMPTS[:1], max_new_tokens=3)
    want = _generate(models)
    ids = [e.add_request(p, 6) for p in PROMPTS]
    e.admit()
    e.decode_burst(2)
    assert e.recover() == len(PROMPTS)
    assert isinstance(e.cache, sh.Shards)
    e.run_to_completion()
    by_rid = {r.rid: r for r in e.finished}
    assert [by_rid[i].tokens for i in ids] == want


def test_qweight_logical_axes_match_quantized_tree(models):
    """The axes tree mirrors the quantized tree's structure and ranks (a
    drifted name would replicate that tensor), with the reference's
    names; so do the cache's and the prefix pool's."""
    jcfg, tcfg, _, tp = models
    q = tkv.quantize_weights(tp, tcfg)
    axes = tkv.qweight_logical_axes(tcfg)
    assert axes == jkv.qweight_logical_axes(jcfg)
    for path, arr in _leaves(q):
        node = _at(axes, path)
        assert isinstance(node, tuple), path
        assert len(node) == arr.dim(), (path, node, arr.shape)
    for kv_int8 in (False, True):
        jc = jkv.init_cache(jcfg, 2, 16, kv_int8=kv_int8)
        tc = tkv.init_cache(tcfg, 2, 16, kv_int8=kv_int8, device="cpu")
        assert tkv.cache_logical_axes(tc) == jkv.cache_logical_axes(jc)
        jpool = jkv.init_prefix_pool(jcfg, 2, 16, kv_int8=kv_int8)
        tpool = tkv.init_prefix_pool(tcfg, 2, 16, kv_int8=kv_int8,
                                     device="cpu")
        assert tkv.pool_logical_axes(tpool) == \
            jkv.pool_logical_axes(jpool)


def test_sharded_init_materializes_on_mesh(models):
    """``sharded_init`` draws each shard straight into its slices (the
    embedding vocab-split), equal on the CPU to the split of
    ``init_params`` from the same seed; the engine takes the result
    unchanged and serves the one-device engine's tokens."""
    _, tcfg, _, _ = models
    params = te.InferenceEngine.sharded_init(tcfg, TP2, seed=3)
    assert isinstance(params, sh.Shards) and len(params) == 2
    axes = tl.param_logical_axes(tcfg)
    assert params[0]["blocks"]["wq"].shape[2] * 2 == tcfg.n_heads
    assert params[0]["embed"].shape[0] * 2 == tcfg.vocab_size
    whole = tl.init_params(tcfg, torch.Generator().manual_seed(3),
                           device="cpu", dtype=tcfg.dtype)
    for got, want in zip(params, sh.split_tree(whole, axes, TP2)):
        for path, t in _leaves(want):
            assert torch.equal(_at(got, path), t), path
    assert sh.gather_tree(params, axes, CPU)["embed"].equal(whole["embed"])
    e = te.InferenceEngine(params, tcfg, n_slots=2, max_len=32,
                           prompt_buckets=(8,), mesh=TP2)
    assert e.params is params
    base = te.InferenceEngine(whole, tcfg, n_slots=2, max_len=32,
                              prompt_buckets=(8,), device="cpu")
    assert e.generate(PROMPTS, max_new_tokens=6) == \
        base.generate(PROMPTS, max_new_tokens=6)


def test_server_main_tp_end_to_end():
    """``infer.server --tp 2 --device cpu`` as a real process: /health
    turns ready, /generate returns its tokens, and /metrics counts one
    shard's bytes."""
    port = torch_ranks.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "skypilot_tpu_torch.infer.server",
         "--config", "llama3-tiny", "--device", "cpu", "--port", str(port),
         "--tp", "2", "--slots", "2", "--max-len", "64"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert time.time() < deadline, "server never became ready"
            assert proc.poll() is None, "server process died"
            try:
                with urllib.request.urlopen(f"{url}/health",
                                            timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.5)
        req = urllib.request.Request(
            f"{url}/generate",
            data=json.dumps({"tokens": [1, 2, 3],
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert len(out["tokens"]) == 4
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
            text = r.read().decode()
        cfg = tl.CONFIGS["llama3-tiny"]
        kv_pool = next(float(line.split()[-1]) for line in text.splitlines()
                       if line.startswith('skytpu_hbm_bytes{component='
                                          '"kv_pool"}'))
        # One shard: K and V of 2 slots' blocks of 64 rows and the trash
        # block, bf16, half the kv heads; lengths (int32) and pending
        # tokens (int64) of 2 slots.
        rows = (2 + 1) * 64
        assert kv_pool == (2 * cfg.n_layers * rows * cfg.n_kv_heads // 2
                           * cfg.head_dim * 2 + 2 * 4 + 2 * 8)
    finally:
        proc.terminate()
        proc.wait(timeout=20)


# -- the port's own checks ----------------------------------------------------

def test_tp_devices_needs_the_cards(monkeypatch):
    """``--tp N`` takes the first N cards and exits with the reference's
    message when there are fewer; on the CPU it makes N shards."""
    assert ts.tp_devices(3, "cpu") == [CPU] * 3
    monkeypatch.setattr(ts, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--tp 4 needs 4 devices, found 1"):
        ts.tp_devices(4)


@pytest.mark.parametrize("case", ["tp3", "moe"])
def test_tp_refuses(models, case):
    """A group that does not divide the heads raises ``ValueError``; MoE
    configs are not ported under tp and raise the typed refusal naming
    the ROADMAP item."""
    _, tcfg, _, tp = models
    if case == "tp3":
        with pytest.raises(ValueError, match="tp 3 does not divide"):
            te.InferenceEngine(tp, tcfg, mesh=[CPU] * 3)
        return
    from skypilot_tpu_torch.models import moe
    mcfg = moe.CONFIGS["moe-tiny"]
    mp = moe.init_params(mcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(te.TpUnsupportedError, match="Queue 1 item 1"):
        te.InferenceEngine(mp, mcfg, mesh=TP2)


def _adapter_tree(cfg, seed, rank=4):
    rng = np.random.default_rng(seed)
    return {t: {"a": rng.normal(size=(cfg.n_layers,) + sa).astype(
                    np.float32) * 0.05,
                "b": rng.normal(size=(cfg.n_layers,) + sb).astype(
                    np.float32) * 0.05}
            for t, (sa, sb) in tad.target_shapes(cfg, rank).items()}


@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contig"])
def test_tp_adapters_match_single_device(models, kv_block):
    """Multi-LoRA under tp: the pool stays whole on the first device and
    each shard applies its heads' slices (wq/wk/wv's B, wo's A, the wo
    partials joined with the shards'); requests under two fine-tunes
    and the base model, through waves, a chunked prompt and its prefix
    hit, give the one-device engine's tokens."""
    _, tcfg, _, _ = models
    prompts = [list(range(1, 21)), [7, 8, 9], [11, 12, 13, 14]]
    names = ["ft-0", "ft-1", None]

    def run(mesh):
        cat = tad.AdapterCatalog(tcfg, n_adapters=3, rank=4, device="cpu")
        for i in range(2):
            cat.register(f"ft-{i}", params=_adapter_tree(tcfg, 100 + i))
        e = _engine(models, mesh, adapters=cat, prefill_chunk=8,
                    prefix_pool=2, kv_block=kv_block, max_len=64,
                    prompt_buckets=(8, 64))
        ids = [e.add_request(p, 8, adapter=a) for p, a in
               zip(prompts, names)]
        e.run_to_completion()
        ids.append(e.add_request(prompts[0], 8, adapter="ft-0"))
        e.run_to_completion()
        by_rid = {r.rid: r.tokens for r in e.finished}
        return [by_rid[i] for i in ids], e

    got, e = run(TP2)
    want, _ = run(None)
    assert got == want
    assert e.prefix_hits == 1
    assert got[0] != _engine(models, max_len=64, prompt_buckets=(8, 64)
                             ).generate(prompts[:1], 8)[0]


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_tp_draft_engine_matches_single_device(models, pipeline):
    """The model drafter under tp: a self-distilled one-layer draft runs
    whole on the first device beside the split target; the verify
    rounds accept and the tokens are the one-device engine's."""
    _, tcfg, _, tp = models
    target, dparams, dcfg = td.self_distilled_pair(tp, tcfg, 1)
    prompts = [list(range(1, 12)), [5, 6, 7, 8] * 3]

    def run(mesh):
        draft = td.DraftEngine(dparams, dcfg, n_slots=4, max_len=64,
                               device="cpu")
        e = te.InferenceEngine(target, tcfg, n_slots=4, max_len=64,
                               prompt_buckets=(16,), spec_k=3,
                               draft_engine=draft, spec_pipeline=pipeline,
                               device=None if mesh else "cpu", mesh=mesh)
        return e.generate(prompts, 16), e

    got, e = run(TP2)
    want, e1 = run(None)
    assert got == want
    assert e.verify_calls > 0 and e._spec_accepted_total > 0
    assert (e._spec_drafted_total, e._spec_accepted_total) == \
        (e1._spec_drafted_total, e1._spec_accepted_total)


def test_make_engine_tp_with_a_self_draft():
    """``make_engine(tp=2, draft_model="self:1")``: the draft takes the
    target's first layer gathered whole onto the first device, equal to
    the one-device engine's draft weights."""
    e = ts.make_engine("llama3-tiny", slots=2, max_len=64, device="cpu",
                       tp=2, draft_model="self:1")
    whole = ts.make_engine("llama3-tiny", slots=2, max_len=64, device="cpu",
                           draft_model="self:1")
    assert isinstance(e.params, sh.Shards)
    for path, t in _leaves(whole.draft_engine.params):
        assert torch.equal(_at(e.draft_engine.params, path), t), path
    assert len(e.generate([[1, 2, 3, 1, 2, 3]], 6)[0]) == 6


def test_tp_splits_prebuilt_qweights(models):
    """A pre-built int8 tree (the reference's ``random_quantized_params``
    carried over through numpy) splits by ``qweight_logical_axes`` and
    serves the one-device engine's tokens."""
    jcfg, tcfg, _, _ = models
    jp, jq = jkv.random_quantized_params(jcfg)
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    qweights = tkv.qweights_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    kw = dict(n_slots=4, max_len=32, prompt_buckets=(8,), kv_int8=True)
    e = te.InferenceEngine(params, tcfg, mesh=TP2, qweights=qweights, **kw)
    assert isinstance(e.qweights, sh.Shards)
    assert e.qweights[1]["blocks"]["wo"]["w"].shape[1] * 2 == tcfg.n_heads
    base = te.InferenceEngine(params, tcfg, device="cpu", qweights=qweights,
                              **kw)
    assert e.generate(PROMPTS, 6) == base.generate(PROMPTS, 6)


# -- against the JAX engine at tp 1 and on its 2-device mesh ------------------

SHARED = [5, 6, 7, 8] * 4
WAVE_A = [SHARED + [9, 10, 11], [1, 2, 3, 1, 2, 3, 1, 2, 3], [40, 41]]
WAVE_B = [SHARED + [12, 13, 14, 15, 16], [3, 1, 2, 3, 1, 2]]
JAX_CASES = {"paged": dict(kv_block=8), "contig": dict(kv_block=0),
             "paged-w8a8-int8kv": dict(kv_block=8, weights_int8=True,
                                       kv_int8=True)}


def _workload(mk, **kw):
    """Two waves through chunked prefill (chunks of 8), the prefix pool
    (the second wave's long prompt shares 16 tokens with the first's)
    and n-gram verify rounds (K 2): the tokens, prefix hits and verify
    calls."""
    e = mk(n_slots=4, max_len=64, prompt_buckets=(8, 16, 64),
           prefill_chunk=8, prefix_pool=2, spec_k=2, **kw)
    out = e.generate(WAVE_A, 24) + e.generate(WAVE_B, 24)
    return out, e


@pytest.fixture(scope="module")
def jax_tokens(models):
    jcfg, _, jp, _ = models
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    cache = {}

    def get(case, on_mesh):
        if (case, on_mesh) not in cache:
            kw = JAX_CASES[case]

            def mk(**more):
                # The Pallas paged kernel in interpret mode on a paged
                # cache: the program the port's kernel path is held to.
                return je.InferenceEngine(
                    jp, jcfg, kv_kernel=kw["kv_block"] > 0,
                    mesh=mesh if on_mesh else None, **more)
            cache[case, on_mesh] = _workload(mk, **kw)[0]
        return cache[case, on_mesh]

    return get


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_tp_tokens_match_jax(models, jax_tokens, case):
    """The port's tp-2 engine: the greedy tokens of the port's tp-1
    engine, the JAX engine at tp 1 and the JAX engine on its 2-device
    mesh, with chunked prefill, a prefix hit and n-gram verify rounds."""
    got, e = _workload(lambda **kw: _engine(models, TP2, **kw),
                       **JAX_CASES[case])
    assert e.prefix_hits >= 1 and e.verify_calls > 0
    assert got == _workload(lambda **kw: _engine(models, **kw),
                            **JAX_CASES[case])[0]
    assert got == jax_tokens(case, False)
    assert got == jax_tokens(case, True)


# -- the KV handoff across tp degrees -----------------------------------------

CHUNK = 8
PROMPT = list(range(5, 21)) + [31, 32, 33]      # 19 tokens: 16 cached


def _handoff_engine(models, tp, **kw):
    kw = dict(dict(n_slots=4, max_len=64, prompt_buckets=(48,),
                   prefill_chunk=CHUNK, prefix_pool=8, kv_block=CHUNK,
                   spec_k=0), **kw)
    if tp == "jax":
        jcfg, _, jp, _ = models
        return je.InferenceEngine(jp, jcfg, kv_kernel=True, **kw)
    return _engine(models, TP2 if tp == 2 else None, **kw)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2), (2, "jax")])
def test_tp_handoff_round_trip(models, src, dst, kv_int8):
    """Prefill on one engine, export (every kv head on the wire, whatever
    the tp degree), the reference's wire, import on an engine of another
    tp degree (or the JAX engine), resume: the single-tier tokens over
    the 16 imported rows."""
    from skypilot_tpu.infer import server as js
    want = _handoff_engine(models, 1, kv_int8=kv_int8).generate(
        [PROMPT], 6)[0]
    p = _handoff_engine(models, src, kv_int8=kv_int8)
    d = _handoff_engine(models, dst, kv_int8=kv_int8)
    p.add_request(PROMPT, 1)
    p.run_to_completion()
    (req,) = p.finished
    export = p.export_prefix_for(req)
    cfg = tl.CONFIGS["llama3-tiny"]
    assert export["tensors"]["k"].shape[3] == cfg.n_kv_heads
    dec = js.decode_export if dst == "jax" else ts.decode_export
    wire = dec(json.loads(json.dumps(ts.encode_export(export))))
    assert d.import_prefix(PROMPT + req.tokens, wire,
                           salt=wire["salt"]) == 16
    d.add_request(PROMPT, 6, committed=req.tokens)
    d.run_to_completion()
    (out,) = d.finished
    assert out.tokens == want


# -- each program, one layer, split against whole -----------------------------

PROGRAMS = ["prefill_batch", "prefill_chunk", "decode_step",
            "decode_burst_staged", "verify_draft_staged"]


def _program_case(models, program, contig, quant):
    """(run(params, qweights, cache) -> outputs, whole params, qweights,
    a filled whole cache) for ``program`` at one layer."""
    _, tcfg, _, tp = models
    cfg = dataclasses.replace(tcfg, n_layers=1)
    params = dict(tp, blocks={k: v[:1] for k, v in tp["blocks"].items()})
    qweights = tkv.quantize_weights(params, cfg) if quant else None
    if quant:
        params = tkv.slim_params(params)
    B, bl, max_len = 3, 8, 32
    nb = max_len // bl
    if contig:
        cache = tkv.init_cache(cfg, B, max_len, kv_int8=quant, device="cpu")
        table = None
    else:
        cache = tkv.init_paged_cache(cfg, B, B * nb, bl, CPU, kv_int8=quant)
        table = torch.tensor([list(range(s * nb, (s + 1) * nb)) + [B * nb]
                              for s in range(B)], dtype=torch.int32)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 16)))
    lens = torch.tensor([16, 11, 5])
    prefix, logits = tkv.prefill_batch(params, toks, lens, cfg,
                                       qweights=qweights)
    for s in range(B):
        tkv.insert(cache, tkv.wave_row(prefix, s), s, lens[s],
                   logits[s].argmax(), table)
    active = torch.tensor([True, True, False])
    sp = tsamp.SamplingParams()
    chunk = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8,)))
    draft = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 3)))

    def run(p, q, c):
        if program == "prefill_batch":
            pre, lg = tkv.prefill_batch(p, toks, lens, cfg, qweights=q)
            return [lg] + [torch.cat([part[n] for part in
                                      sh.shards_of(pre)], dim=3)
                           for n in ("k", "v")]
        if program == "prefill_chunk":
            tok = tkv.prefill_chunk(p, c, chunk, 5, 6, 2, 11, cfg, sp, table,
                                    final=True, qweights=q)
            return [tok]
        if program == "decode_step":
            return [tkv.decode_step(p, c, cfg, table, qweights=q)]
        if program == "decode_burst_staged":
            return [tkv.decode_burst_staged(p, c, active, 3, cfg, sp, table,
                                            qweights=q)]
        return list(tkv.verify_draft_staged(p, c, draft,
                                            torch.tensor([3, 2, 0]), active,
                                            3, cfg, table, qweights=q))

    return cfg, run, params, qweights, cache


# The wave prefill reads no cache: one layout runs it.
PROGRAM_CASES = [(p, layout) for p in PROGRAMS for layout in ("paged",
                                                              "contig")
                 if (p, layout) != ("prefill_batch", "contig")]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "w8a8-int8kv"])
@pytest.mark.parametrize("program,layout", PROGRAM_CASES)
def test_program_split_matches_whole(models, program, layout, quant):
    """Each program at one layer over two shards against the unsplit
    program on the same inputs: outputs within ``RTOL`` of max|whole|
    (tokens equal), and the cache afterwards, gathered back to every kv
    head, within the same bound (int8 rows within one step)."""
    cfg, run, params, qweights, cache = _program_case(
        models, program, layout == "contig", quant)
    axes = tl.param_logical_axes(cfg)
    caxes = tkv.cache_logical_axes(cache)
    p2 = sh.split_tree(params, axes, TP2)
    q2 = (sh.split_tree(qweights, tkv.qweight_logical_axes(cfg), TP2)
          if quant else None)
    c2 = sh.split_tree(cache, caxes, TP2)
    want = run(params, qweights, cache)
    got = run(p2, q2, c2)
    for g, w in zip(got, want):
        if not w.is_floating_point():
            assert torch.equal(g, w)
            continue
        assert (g - w).abs().max() <= RTOL * w.abs().max(), program
    joined = sh.gather_tree(c2, caxes, CPU)
    for name, w in cache.items():
        g = joined[name]
        if w.dtype == torch.int8:
            assert (g.int() - w.int()).abs().max() <= 1, name
        elif w.is_floating_point():
            assert (g.float() - w.float()).abs().max() <= \
                RTOL * max(w.float().abs().max(), 1e-6), name
        else:
            assert torch.equal(g, w), name
