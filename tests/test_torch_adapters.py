"""The port's multi-LoRA adapter catalog against the JAX package on the
CPU, in float32 at llama3-tiny with rank-4 adapters drawn from seeded
numpy (``tests/test_adapters.py``'s workloads): the catalog's units,
the content digest and the ``.npz`` files across the packages, the
per-slot deltas and the paged programs against the JAX functions, the
greedy parity matrix against the JAX engine, the engine's adapter
bookkeeping (prefix salt, pinned pools, preemption, in-place installs,
typed load failures), and the HTTP tier: ``model`` and
``x-skytpu-model``, the typed 404 and 503, the trailer, ``main``'s
flags, ``/prefill`` -> ``/handoff`` under an adapter, and the reference
load balancer before port replicas.

The JAX engine runs its Pallas paged kernel in interpret mode
(``kv_kernel=True``), the program the port's kernel path is held to.
Here a load failure is made by a checkpoint file that is missing or
corrupt; ``tests/test_torch_recovery.py`` injects it through the
``adapter.load`` chaos point."""

import dataclasses
import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import adapters as jad
from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.infer import sampling as jsamp
from skypilot_tpu.infer import server as js
from skypilot_tpu.models import llama as jl
from skypilot_tpu.serve import load_balancer, serve_state
from skypilot_tpu_torch.infer import adapters as ad
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import qos as tq
from skypilot_tpu_torch.infer import sampling as tsamp
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

RANK = 4
PROMPTS = [[3, 17, 42, 5], [7, 9, 11, 13, 2], [23, 29, 31]]
# A fourth prompt longer than the parity matrix's chunk of 8: it runs
# the chunk program under its adapter.
LONG = [5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 98, 87]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


CFG = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=torch.float32)


def _mk_params(seed, rank=RANK, targets=None, scale=0.05):
    """A random nonzero adapter tree in the train/lora layout."""
    r = np.random.default_rng(seed)
    L = CFG.n_layers
    out = {}
    for t, (sa, sb) in ad.target_shapes(CFG, rank).items():
        if targets is not None and t not in targets:
            continue
        out[t] = {"a": r.normal(size=(L,) + sa).astype(np.float32) * scale,
                  "b": r.normal(size=(L,) + sb).astype(np.float32) * scale}
    return out


def _catalog(n_adapters=4, rank=RANK, register=3):
    cat = ad.AdapterCatalog(CFG, n_adapters=n_adapters, rank=rank,
                            device="cpu")
    for i in range(register):
        cat.register(f"ft-{i}", params=_mk_params(100 + i, rank))
    return cat


def _jcatalog(jcfg, n_adapters=4, register=3):
    cat = jad.AdapterCatalog(jcfg, n_adapters=n_adapters, rank=RANK)
    for i in range(register):
        cat.register(f"ft-{i}", params=_mk_params(100 + i))
    return cat


def _engine(tp, catalog=None, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", (8, 16))
    kw.setdefault("kv_block", 16)
    kw.setdefault("prefill_chunk", 0)
    return te.InferenceEngine(tp, CFG, adapters=catalog, device="cpu", **kw)


def _bind_fake_loader(cat):
    loads = []

    def loader(pool, slot, weights):
        loads.append(int(slot))
        return pool

    cat.bind_loader(loader)
    return loads


def _run(e, prompt, n, adapter=None, **kw):
    rid = e.add_request(prompt, n, adapter=adapter, **kw)
    e.run_to_completion()
    req = [r for r in e.finished if r.rid == rid][0]
    e.finished.clear()
    return req


# -- catalog units (tests/test_adapters.py:85-245) ----------------------------

def test_unknown_adapter_typed():
    cat = _catalog()
    with pytest.raises(ad.UnknownAdapterError) as e:
        cat.check("nope")
    assert e.value.typed_error == {
        "type": "unknown_adapter", "adapter": "nope",
        "message": "unknown adapter 'nope'",
        "known": ["ft-0", "ft-1", "ft-2"]}
    assert e.value.http_status == 404
    cat.check("ft-0")
    cat.check(None)


def test_engine_without_catalog_knows_no_adapters(models):
    e = _engine(models[3])
    with pytest.raises(ad.UnknownAdapterError):
        e.add_request(PROMPTS[0], 4, adapter="ft-0")
    e.check_adapter(None)


def test_content_addressed_sharing():
    cat = ad.AdapterCatalog(CFG, n_adapters=4, rank=RANK, device="cpu")
    same = _mk_params(1)
    cat.register("alias-a", params=same)
    cat.register("alias-b", params={t: {k: v.copy() for k, v in ab.items()}
                                    for t, ab in same.items()})
    loads = _bind_fake_loader(cat)
    s1 = cat.acquire("alias-a")
    s2 = cat.acquire("alias-b")
    assert s1 == s2 and loads == [s1] and cat.resident_count() == 1


def test_alpha_is_part_of_content_identity():
    cat = ad.AdapterCatalog(CFG, n_adapters=4, rank=RANK, device="cpu")
    same = _mk_params(3)
    cat.register("a16", params=same, alpha=16.0)
    cat.register("a32", params={t: {k: v.copy() for k, v in ab.items()}
                                for t, ab in same.items()}, alpha=32.0)
    loads = _bind_fake_loader(cat)
    s1, s2 = cat.acquire("a16"), cat.acquire("a32")
    assert s1 != s2 and loads == [s1, s2] and cat.resident_count() == 2


def test_path_alias_shares_one_slot(tmp_path):
    path = str(tmp_path / "ft.npz")
    ad.save_adapter(path, _mk_params(9), alpha=8.0)
    cat = ad.AdapterCatalog(CFG, n_adapters=4, rank=RANK, device="cpu")
    cat.register("alias-a", path=path)
    cat.register("alias-b", path=path)
    _bind_fake_loader(cat)
    s1, s2 = cat.acquire("alias-a"), cat.acquire("alias-b")
    assert s1 == s2 and cat.resident_count() == 1 and cat.pins(s1) == 2
    cat.register("other", params=_mk_params(11))
    assert cat.acquire("other") not in (None, s1)
    assert cat.evictions == 0


def test_lru_eviction_and_pinning():
    cat = ad.AdapterCatalog(CFG, n_adapters=3, rank=RANK, device="cpu")
    for i in range(4):
        cat.register(f"ft-{i}", params=_mk_params(200 + i))
    _bind_fake_loader(cat)
    s0, s1 = cat.acquire("ft-0"), cat.acquire("ft-1")
    assert cat.resident_count() == 2
    assert cat.acquire("ft-2") is None and cat.evictions == 0
    cat.release(s0)
    assert cat.acquire("ft-2") == s0 and cat.evictions == 1
    assert cat.resident_count() == 2
    assert cat.acquire("ft-1") == s1 and cat.loads == 3


def test_release_refcounts():
    cat = ad.AdapterCatalog(CFG, n_adapters=2, rank=RANK, device="cpu")
    cat.register("ft-0", params=_mk_params(1))
    cat.register("ft-1", params=_mk_params(2))
    _bind_fake_loader(cat)
    s = cat.acquire("ft-0")
    assert cat.acquire("ft-0") == s and cat.pins(s) == 2
    cat.release(s)
    assert cat.pins(s) == 1 and cat.acquire("ft-1") is None
    cat.release(s)
    assert cat.pins(s) == 0 and cat.acquire("ft-1") is not None
    assert cat.acquire(None) == 0
    cat.release(0)


def test_rank_validation():
    cat = ad.AdapterCatalog(CFG, n_adapters=2, rank=2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        cat.register("big", params=_mk_params(1, rank=4))
    cat.register("small", params=_mk_params(1, rank=1))    # zero-pads
    with pytest.raises(ValueError, match="adapter pool needs"):
        ad.AdapterCatalog(CFG, n_adapters=1, device="cpu")


def test_save_load_roundtrip(tmp_path, models):
    """A path-registered .npz serves end to end and matches the same
    adapter registered in memory."""
    tree = _mk_params(7)
    path = str(tmp_path / "ft.npz")
    ad.save_adapter(path, tree, alpha=8.0)
    loaded, alpha = ad.load_adapter_file(path)
    assert alpha == 8.0 and set(loaded) == set(tree)
    cat_mem = _catalog(register=0)
    cat_mem.register("ft", params=tree, alpha=8.0)
    cat_path = _catalog(register=0)
    cat_path.register("ft", path=path)
    outs = [_run(_engine(models[3], c), PROMPTS[0], 6, "ft").tokens
            for c in (cat_mem, cat_path)]
    assert outs[0] == outs[1]


def test_catalog_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("SKYTPU_ADAPTERS", raising=False)
    assert ad.catalog_from_env(CFG, device="cpu") is None
    monkeypatch.setenv("SKYTPU_ADAPTERS", json.dumps(
        {"ft-a": str(tmp_path / "a.npz"), "ft-b": str(tmp_path / "b.npz")}))
    monkeypatch.setenv("SKYTPU_ADAPTER_SLOTS", "3")
    monkeypatch.setenv("SKYTPU_ADAPTER_RANK", "2")
    cat = ad.catalog_from_env(CFG, device="cpu")
    assert (cat.names(), cat.n_adapters, cat.rank) == (["ft-a", "ft-b"],
                                                       3, 2)
    assert cat.pool["wq"]["a"].shape == (CFG.n_layers, 3, CFG.d_model, 2)
    # Explicit arguments (the server's flags) win; a malformed value
    # registers nothing.
    cat = ad.catalog_from_env(CFG, adapters_json="[1, 2]", slots=5, rank=8,
                              device="cpu")
    assert (cat.names(), cat.n_adapters, cat.rank) == ([], 5, 8)


# -- digests and files across the packages ------------------------------------

@pytest.mark.parametrize("alpha", [32.0, 8.0, 0.5])
def test_content_digest_byte_equal_to_jax(alpha):
    for seed, rank, targets in ((1, RANK, None), (2, 2, ("wq", "wo")),
                                (3, 1, ("wv",))):
        tree = _mk_params(seed, rank, targets)
        assert ad._content_digest(tree, alpha) == \
            jad._content_digest(tree, alpha)
    assert ad._content_digest(_mk_params(1), 16.0) != \
        ad._content_digest(_mk_params(1), 32.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_crosses_packages_and_stacks_equal(tmp_path, models, writer):
    """A ``.npz`` written by either package loads in the other; both
    packages' ``_stack`` (alpha/rank folded into B, rank zero-padded to
    the pool's, a missing target all zeros) give equal arrays."""
    jcfg = models[0]
    tree = _mk_params(5, rank=2, targets=("wq", "wk", "wo"))
    path = str(tmp_path / "ft.npz")
    {"port": ad, "jax": jad}[writer].save_adapter(path, tree, alpha=6.0)
    (tp_, ta), (jp_, ja) = ad.load_adapter_file(path), \
        jad.load_adapter_file(path)
    assert ta == ja == 6.0 and set(tp_) == set(jp_) == set(tree)
    for t in tree:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(tp_[t][leaf], jp_[t][leaf])
    tw = ad.AdapterCatalog(CFG, n_adapters=2, rank=RANK,
                           device="cpu")._stack(tp_, ta, 2)
    jw = jad.AdapterCatalog(jcfg, n_adapters=2, rank=RANK)._stack(
        jp_, ja, 2)
    assert set(tw) == set(jw) == set(ad.TARGETS)
    for t in ad.TARGETS:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(tw[t][leaf].numpy(),
                                          np.asarray(jw[t][leaf]))
    assert not tw["wv"]["a"].any()


# -- the deltas and the programs against the JAX functions --------------------

def _pool(seed, n=3, rank=RANK):
    """A random numpy pool (slot 0 zero, as an engine's) in both
    packages' forms."""
    r = np.random.default_rng(seed)
    pool = {}
    for t, (sa, sb) in ad.target_shapes(CFG, rank).items():
        ab = {"a": r.normal(size=(CFG.n_layers, n) + sa) * 0.05,
              "b": r.normal(size=(CFG.n_layers, n) + sb) * 0.4}
        for v in ab.values():
            v[:, 0] = 0.0
        pool[t] = {k: v.astype(np.float32) for k, v in ab.items()}
    return ({t: {k: jnp.asarray(v) for k, v in ab.items()}
             for t, ab in pool.items()},
            {t: {k: torch.from_numpy(v) for k, v in ab.items()}
             for t, ab in pool.items()})


def test_lora_deltas_match_jax():
    r = np.random.default_rng(0)
    jpool, tpool = _pool(1)
    aid = np.array([2, 0, 1, 2])
    h = r.normal(size=(4, 5, CFG.d_model)).astype(np.float32)
    o = r.normal(size=(4, 5, CFG.n_heads, CFG.head_dim)).astype(np.float32)
    for t in ("wq", "wk", "wv", "wo"):
        x = o if t == "wo" else h
        jfn = jkv._lora_out_delta if t == "wo" else jkv._lora_in_delta
        tfn = tkv._lora_out_delta if t == "wo" else tkv._lora_in_delta
        jab = {k: v[1] for k, v in jpool[t].items()}         # layer 1
        want = np.asarray(jfn(jnp.asarray(x), jab, jnp.asarray(aid)))
        got = tfn(torch.from_numpy(x), ad.lora_layer(tpool, 1)[t],
                  torch.from_numpy(aid)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        assert not got[1].any()                  # slot 0: exact zeros


_BL, _NBLK, _ML = 8, 8, 32


def _prefilled(models, pools, aid_w):
    """Both packages' paged caches after a wave prefill of three
    prompts under ``aid_w`` (slot w <- wave row w), and the wave's
    logits."""
    jcfg, tcfg, jp, tp = models
    jpool, tpool = pools
    lens = np.array([7, 11, 5])
    toks = np.zeros((3, 16), np.int64)
    r = np.random.default_rng(4)
    for w, n in enumerate(lens):
        toks[w, :n] = r.integers(1, tcfg.vocab_size, n)
    table = np.full((3, _ML // _BL + 1), _NBLK, np.int32)
    table[0, :2], table[1, :3], table[2, :2] = [4, 1], [0, 5, 2], [6, 3]
    jpre, jlog = jkv.prefill_batch(jp, jnp.asarray(toks), jnp.asarray(lens),
                                   jcfg, lora=jpool, aid=jnp.asarray(aid_w))
    tpre, tlog = tkv.prefill_batch(tp, torch.from_numpy(toks),
                                   torch.from_numpy(lens), tcfg, lora=tpool,
                                   aid=torch.from_numpy(aid_w))
    jc = jkv.init_paged_cache(jcfg, 3, _NBLK, _BL)
    tc = tkv.init_paged_cache(tcfg, 3, _NBLK, _BL, "cpu")
    first = np.asarray(jnp.argmax(jlog, -1))
    for w in range(3):
        jc = jkv.insert(jc, {"k": jpre["k"][:, w], "v": jpre["v"][:, w]}, w,
                        jnp.asarray(lens[w]), jnp.asarray(first[w]),
                        table=jnp.asarray(table))
        tkv.insert(tc, {"k": tpre["k"][:, w], "v": tpre["v"][:, w]}, w,
                   int(lens[w]), torch.tensor(first[w]),
                   torch.from_numpy(table))
    return (jpre, jlog, jc), (tpre, tlog, tc), table, toks, lens


def _cache_close(tc, jc, atol=1e-5):
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n][:, :_NBLK].numpy(),
                                   np.asarray(jc[n]), atol=atol)
    for n in ("length", "last_token"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


def test_prefill_batch_with_mixed_aid_matches_jax(models):
    pools = _pool(2)
    aid_w = np.array([2, 0, 1])
    (jpre, jlog, jc), (tpre, tlog, tc), _, toks, lens = _prefilled(
        models, pools, aid_w)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpre[n].numpy(), np.asarray(jpre[n]),
                                   atol=1e-5)
    _cache_close(tc, jc)
    # The adapters move the logits: the test is not vacuous.
    _, base = tkv.prefill_batch(models[3], torch.from_numpy(toks),
                                torch.from_numpy(lens), models[1])
    assert torch.equal(tlog[1], base[1])            # pool slot 0
    assert not torch.allclose(tlog[0], base[0], atol=1e-2)


def test_decode_and_verify_with_mixed_aid_match_jax(models):
    """A staged decode burst and a verify round over three slots under
    pool slots (2, 0, 1): the JAX programs' tokens, commit counts and
    flushed cache rows (which carry the wk/wv deltas)."""
    jcfg, tcfg, jp, tp = models
    pools = _pool(3)
    aid = np.array([2, 0, 1])
    (_, _, jc), (_, _, tc), table, _, _ = _prefilled(models, pools, aid)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    active = np.array([True, True, True])
    jc, _, jtoks = jkv.decode_burst_staged(
        jp, jc, jax.random.key(0), jnp.asarray(active), 3, jcfg,
        jsamp.SamplingParams(), table=jt, kv_kernel=True, lora=pools[0],
        aid=jnp.asarray(aid))
    ttoks = tkv.decode_burst_staged(
        tp, tc, torch.from_numpy(active), 3, tcfg, tsamp.SamplingParams(),
        tt, lora=pools[1], aid=torch.from_numpy(aid))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _cache_close(tc, jc)
    draft = np.asarray(jtoks).T[:, :2].copy()        # a mostly wrong draft
    draft[1] = [7, 7]
    n_draft = np.array([2, 2, 1])
    jc, jv, jn = jkv.verify_draft_staged(
        jp, jc, jnp.asarray(draft), jnp.asarray(n_draft),
        jnp.asarray(active), 2, jcfg, table=jt, kv_kernel=True,
        lora=pools[0], aid=jnp.asarray(aid))
    tv, tn = tkv.verify_draft_staged(
        tp, tc, torch.from_numpy(draft), torch.from_numpy(n_draft),
        torch.from_numpy(active), 2, tcfg, tt, lora=pools[1],
        aid=torch.from_numpy(aid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _cache_close(tc, jc)


def test_prefill_chunk_with_aid_matches_jax(models):
    """Slot 1 of three (pool slot 2) prefills 21 tokens in chunks of 8:
    the JAX chunk program's rows after every chunk and its first token.
    Both programs round the intra-chunk block to bf16 (a plain bf16
    product in the JAX program), so a rounding that falls the other way
    moves the next layer's rows: up to ~3e-5 at these adapter
    magnitudes, held at 1e-4."""
    jcfg, tcfg, jp, tp = models
    jpool, tpool = _pool(4)
    aid = np.array([1, 2, 0])
    prompt = np.random.default_rng(6).integers(1, tcfg.vocab_size, 21)
    table = np.full((3, _ML // _BL + 1), _NBLK, np.int32)
    table[1, :3] = [5, 0, 3]
    jc = jkv.claim_slot(jkv.init_paged_cache(jcfg, 3, _NBLK, _BL), 1, _ML)
    tc = tkv.init_paged_cache(tcfg, 3, _NBLK, _BL, "cpu")
    tkv.claim_slot(tc, 1, _ML)
    rng = jax.random.key(0)
    for start in range(0, 21, 8):
        nv = min(8, 21 - start)
        final = start + nv >= 21
        chunk = np.zeros((8,), np.int64)
        chunk[:nv] = prompt[start:start + nv]
        new_len = 21 if final else _ML
        jc, rng, jtok = jkv.prefill_chunk(
            jp, jc, jnp.asarray(chunk, jnp.int32), start, nv, 1, new_len,
            rng, jcfg, jsamp.SamplingParams(), final=final,
            table=jnp.asarray(table), kv_kernel=True, lora=jpool,
            aid=jnp.asarray(aid))
        ttok = tkv.prefill_chunk(
            tp, tc, torch.from_numpy(chunk), start, nv, 1, new_len, tcfg,
            tsamp.SamplingParams(), torch.from_numpy(table), final=final,
            lora=tpool, aid=torch.from_numpy(aid))
        _cache_close(tc, jc, atol=1e-4)
        assert int(ttok) == int(jtok)


# -- the parity matrix (tests/test_adapters.py::test_parity_matrix) -----------

_MIXED = ["ft-0", "ft-1", None, "ft-2"]


def _matrix_engines(models, kv_int8, spec_k, w8a8):
    """(JAX engine factory, port engine factory) on the same weights:
    float32 llama3-tiny, or the reference's ``random_quantized_params``
    carried across through numpy."""
    jcfg, tcfg, jp, tp = models
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(8, 16), kv_block=16,
              kv_int8=kv_int8, spec_k=spec_k, prefill_chunk=8,
              prefix_pool=2)
    jq = tqw = None
    if w8a8:
        jp, jq = jkv.random_quantized_params(jcfg)
        tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
        tqw = tkv.qweights_from_numpy(jax.tree.map(np.asarray, jq), "cpu")

    def jax_engine():
        return je.InferenceEngine(jp, jcfg, adapters=_jcatalog(jcfg),
                                  kv_kernel=True, qweights=jq, **kw)

    def port_engine(catalog=True):
        return _engine(tp, _catalog() if catalog else None, qweights=tqw,
                       **kw)

    return jax_engine, port_engine


@pytest.mark.parametrize("kv_int8,spec_k,w8a8", [
    (False, 0, False), (False, 2, False), (True, 0, False),
    (True, 2, False), (True, 2, True)],
    ids=["fp32-spec0", "fp32-spec2", "int8kv-spec0", "int8kv-spec2",
         "w8a8-int8kv-spec2"])
def test_parity_matrix(models, kv_int8, spec_k, w8a8):
    """(a) A mixed batch (two fine-tunes, the base, a third fine-tune on
    a chunked prompt) gives the JAX engine's greedy tokens under the
    same registrations. (b) Zero-adapter output on an adapter engine is
    bit-identical to the adapterless engine. (c) The mixed batch equals
    the per-request sequential runs. (d) An adapter's output differs
    from the base's."""
    jax_engine, port_engine = _matrix_engines(models, kv_int8, spec_k, w8a8)
    prompts = PROMPTS + [LONG]
    j = jax_engine()
    jids = [j.add_request(p, 6, adapter=n) for p, n in zip(prompts, _MIXED)]
    j.run_to_completion()
    jout = {r.rid: r.tokens for r in j.finished}
    want = [jout[i] for i in jids]

    base = port_engine(catalog=False).generate(prompts, max_new_tokens=6)
    assert port_engine().generate(prompts, max_new_tokens=6) == base, \
        "zero-adapter output drifted from adapterless"

    e = port_engine()
    ids = [e.add_request(p, 6, adapter=n) for p, n in zip(prompts, _MIXED)]
    e.run_to_completion()
    mixed = {r.rid: r.tokens for r in e.finished}
    got = [mixed[i] for i in ids]
    assert got == want, "port tokens differ from the JAX engine's"
    assert any(r.n_chunks for r in e.finished)
    for i, (p, n) in enumerate(zip(prompts, _MIXED)):
        assert _run(port_engine(), p, 6, n).tokens == got[i], \
            f"mixed batch diverged from sequential for {n}"
        if n is None:
            assert got[i] == base[i]
        else:
            assert got[i] != base[i], "adapter output equals base"


# -- engine behaviour ----------------------------------------------------------

def test_prefix_cache_is_adapter_scoped(models):
    """A prefix warmed under one fine-tune never serves another or the
    base; within one fine-tune the warm hit equals cold. The engine's
    salt is the adapter's content digest, and the stored key equals the
    reference index's digest and the LB's ``prefix_affinity_key`` under
    it."""
    tp = models[3]
    shared = list(np.random.default_rng(5).integers(1, CFG.vocab_size, 24))
    tails = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    kw = dict(prefill_chunk=8, prefix_pool=4, max_len=64,
              prompt_buckets=(8, 32))

    def run(e, tail, adapter):
        req = _run(e, shared + tail, 5, adapter)
        return list(req.tokens), req.cached_len

    want = {n: run(_engine(tp, _catalog(), **kw), tails[i], n)[0]
            for i, n in enumerate(["ft-0", "ft-1", None])}
    e = _engine(tp, _catalog(), **kw)
    assert run(e, tails[0], "ft-0") == (want["ft-0"], 0)
    assert run(e, tails[1], "ft-1") == (want["ft-1"], 0), \
        "cross-adapter prefix hit"
    assert run(e, tails[2], None) == (want[None], 0), \
        "adapter-warmed prefix served the base"
    out, cached = run(e, tails[2], "ft-0")
    assert cached > 0
    assert out == run(_engine(tp, _catalog(), **kw), tails[2], "ft-0")[0]
    # The salt and the keys.
    salt = ad._content_digest(_mk_params(100), 32.0)
    req = te.Request(rid=0, prompt=[], max_new_tokens=1, adapter="ft-0")
    req.adapter_slot = next(s for s, n in e.adapters.slot_names().items()
                            if n == "ft-0")
    assert e._prefix_salt(req) == salt
    assert e._prefix_salt(te.Request(rid=1, prompt=[], max_new_tokens=1)) \
        == b""
    ctx = shared + tails[0]
    key = load_balancer.prefix_affinity_key(ctx, 8, salt)
    assert key == e._prefix_index._digest(ctx, 24, salt) == \
        je.PrefixIndex(4, 8)._digest(ctx, 24, salt)
    assert key in e._prefix_index._keys


def test_pinned_pool_stall_steps_aside(models):
    cat = ad.AdapterCatalog(CFG, n_adapters=2, rank=RANK, device="cpu")
    cat.register("ft-0", params=_mk_params(1))
    cat.register("ft-1", params=_mk_params(2))
    e = _engine(models[3], cat, n_slots=4)
    r0 = e.add_request(PROMPTS[0], 8, adapter="ft-0")
    r1 = e.add_request(PROMPTS[1], 4, adapter="ft-1")    # pool pinned
    r2 = e.add_request(PROMPTS[2], 4)                    # base, behind
    e.admit()
    admitted = {r.rid for r in e.slot_req.values()}
    assert r0 in admitted and r1 not in admitted
    assert r2 in admitted, "base request head-of-line blocked"
    assert e.waiting[0].stall_cause == "adapter_pin"
    e.run_to_completion()
    by_rid = {r.rid: r for r in e.finished}
    assert by_rid[r1].error is None and len(by_rid[r1].tokens) == 4
    assert "adapter_pin" in by_rid[r1].stall_ms
    assert cat.evictions == 1 and cat.pins(1) == 0


def test_aid_device_cache_dirty_tracking(models):
    e = _engine(models[3], _catalog())
    d1 = e.aid_device()
    assert e.aid_device() is d1
    rid = e.add_request(PROMPTS[0], 3, adapter="ft-0")
    e.admit()
    d2 = e.aid_device()
    assert d2 is not d1 and e.aid_device() is d2
    slot = [r for r in e.slot_req.values() if r.rid == rid][0].slot
    assert int(d2[slot]) > 0
    e.decode_burst(max_burst=1)
    assert e.adapter_mix == {"ft-0": 1}     # the burst's composition
    e.run_to_completion()
    assert int(e.aid_device()[slot]) == 0
    assert _engine(models[3]).aid_device() is None


def test_preempted_adapter_request_resumes_under_its_adapter(models):
    """A low-priority fine-tune request, evicted mid-decode by a
    high-priority base request on a one-slot engine, releases its pin at
    the eviction, resumes warm under its adapter's salt and gives the
    tokens of its unpreempted run (which differ from the base's)."""
    tp = models[3]
    prompt = list(range(5, 17))
    kw = dict(n_slots=1, max_len=64, prompt_buckets=(48,), prefill_chunk=8,
              prefix_pool=4, kv_block=64, kv_blocks=2)
    want = _run(_engine(tp, _catalog(), **kw), prompt, 14, "ft-1").tokens
    assert want != _run(_engine(tp, _catalog(), **kw), prompt, 14).tokens
    cat = _catalog()
    e = _engine(tp, cat, qos=tq.FairScheduler(), **kw)
    rid = e.add_request(prompt, 14, priority=0, adapter="ft-1")
    while not e.slot_req:
        e.step_burst(max_burst=2)
    for _ in range(2):
        e.decode_burst(max_burst=2)
    (slot,) = e.slot_req
    pool_slot = e.slot_req[slot].adapter_slot
    assert cat.pins(pool_slot) == 1
    e.add_request([3, 1, 4], 4, priority=1)
    e.admit()                                  # preempts the fine-tune
    low = [r for r in e.waiting if r.rid == rid][0]
    assert low.preemptions == 1 and not low.adapter_pinned
    assert cat.pins(pool_slot) == 0 and int(e.adapter_ids[slot]) == 0
    e.run_to_completion(max_burst=2)
    low = {r.rid: r for r in e.finished}[rid]
    assert low.tokens == want and low.resumed_len >= 8
    assert all(cat.pins(s) == 0 for s in range(cat.n_adapters))
    e.clear_prefix_cache()
    assert e.allocator.used == 0


def test_installs_keep_the_pool_addresses(models):
    """Six fine-tunes hot-load through a 2-slot pool mid-traffic: every
    install writes in place, so the pool's tensors keep their
    addresses, and slot 0 stays zero."""
    cat = ad.AdapterCatalog(CFG, n_adapters=3, rank=RANK, device="cpu")
    for i in range(6):
        cat.register(f"ft-{i}", params=_mk_params(300 + i))
    ptrs = {(t, k): v.data_ptr() for t, ab in cat.pool.items()
            for k, v in ab.items()}
    e = _engine(models[3], cat, spec_k=2, prefill_chunk=8, max_wave=4)
    for i in range(6):
        req = _run(e, PROMPTS[i % 3], 4, f"ft-{i}")
        assert req.error is None and len(req.tokens) == 4
    assert cat.loads >= 6 and cat.evictions >= 4
    assert {(t, k): v.data_ptr() for t, ab in cat.pool.items()
            for k, v in ab.items()} == ptrs
    assert all(not ab[k][:, 0].any() for ab in cat.pool.values()
               for k in ab)


@pytest.mark.parametrize("fault", ["missing", "corrupt"])
def test_load_failure_fails_typed_never_base(tmp_path, models, fault):
    """A checkpoint that is missing or corrupt fails its request typed
    (503 ``adapter_load_failed``, no tokens: never the base model's)
    while other requests admit; the slot never becomes resident, and
    once the file is good the same name serves."""
    path = str(tmp_path / "ft.npz")
    if fault == "corrupt":
        with open(path, "wb") as f:
            f.write(b"not an npz" * 100)
    cat = _catalog(register=2)
    cat.register("bad", path=path)
    e = _engine(models[3], cat)
    rid_bad = e.add_request(PROMPTS[0], 5, adapter="bad")
    rid_ok = e.add_request(PROMPTS[1], 5, adapter="ft-1")
    rid_base = e.add_request(PROMPTS[2], 5)
    e.run_to_completion()
    by_rid = {r.rid: r for r in e.finished}
    bad = by_rid[rid_bad]
    assert bad.error["type"] == "adapter_load_failed"
    assert bad.error["adapter"] == "bad" and bad.error["http_status"] == 503
    assert bad.tokens == []
    assert len(by_rid[rid_ok].tokens) == len(by_rid[rid_base].tokens) == 5
    assert cat.resident_count() == 1 and cat.loads == 1
    e.finished.clear()
    ad.save_adapter(path, _mk_params(100))          # ft-0's weights
    got = _run(e, PROMPTS[0], 5, "bad")
    assert got.error is None
    assert got.tokens == _run(_engine(models[3], _catalog()), PROMPTS[0], 5,
                              "ft-0").tokens


# -- the model server ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_json(url, payload, headers=None):
    code, body = _post(url, payload, headers)
    return code, json.loads(body)


def _lines(body: bytes):
    return [json.loads(x) for x in body.decode().strip().split("\n") if x]


def _start(engine):
    port = _free_port()
    mod = ts if isinstance(engine, te.InferenceEngine) else js
    model, httpd = mod.serve(engine, host="127.0.0.1", port=port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    assert model._ready.wait(timeout=300)

    def stop():
        httpd.shutdown()
        httpd.server_close()
        model.shutdown()

    return f"http://127.0.0.1:{port}", stop


@pytest.fixture(scope="module")
def model_server(models, tmp_path_factory):
    corrupt = str(tmp_path_factory.mktemp("ad") / "corrupt.npz")
    with open(corrupt, "wb") as f:
        f.write(b"\x00" * 512)
    cat = _catalog()
    cat.register("corrupt", path=corrupt)
    engine = te.InferenceEngine(models[3], CFG, n_slots=2, max_len=64,
                                prompt_buckets=(16,), adapters=cat,
                                device="cpu")
    url, stop = _start(engine)
    yield url, engine
    stop()


def _solo(models, prompt, n, adapter):
    return _run(_engine(models[3], _catalog(), prompt_buckets=(16,),
                        n_slots=1), prompt, n, adapter).tokens


@pytest.mark.parametrize("how", ["body", "header", "header_wins",
                                 "whitespace_header"])
def test_http_model_routing(model_server, models, how):
    """The body's ``model``, the ``x-skytpu-model`` header, the header
    over the body, and a whitespace header meaning the base model: the
    tokens are that model's (a solo engine's) and the trailer names it."""
    url, _ = model_server
    prompt = [3, 17, 42]
    body, headers, want = {"tokens": prompt, "max_new_tokens": 5}, None, None
    if how == "body":
        body["model"], want = "ft-0", "ft-0"
    elif how == "header":
        headers, want = {ad.MODEL_HEADER: "ft-1"}, "ft-1"
    elif how == "header_wins":
        body["model"] = "ft-0"
        headers, want = {ad.MODEL_HEADER: " ft-2 "}, "ft-2"
    else:
        headers = {ad.MODEL_HEADER: "   "}
    code, out = _post_json(f"{url}/generate", body, headers)
    assert code == 200 and out["model"] == want
    assert out["tokens"] == _solo(models, prompt, 5, want)


@pytest.mark.parametrize("stream", [False, True])
def test_http_unknown_adapter_404_before_any_stream_bytes(model_server,
                                                          stream):
    url, _ = model_server
    code, body = _post(f"{url}/generate",
                       {"tokens": [1, 2], "max_new_tokens": 3,
                        "stream": stream, "model": "nope"})
    assert code == 404
    out = json.loads(body)            # one JSON body, not an NDJSON stream
    assert out["error"]["type"] == "unknown_adapter"
    assert out["error"]["adapter"] == "nope"
    assert "ft-0" in out["error"]["known"]


def test_http_corrupt_checkpoint_typed_503_and_stream_chunk(model_server):
    url, _ = model_server
    code, out = _post_json(f"{url}/generate",
                           {"tokens": [1, 2], "max_new_tokens": 3,
                            "model": "corrupt"})
    assert code == 503
    assert out["error"]["type"] == "adapter_load_failed"
    assert out["error"]["adapter"] == "corrupt" and "tokens" not in out
    # Stream: the failure comes at the claim, after the stream opened.
    code, body = _post(f"{url}/generate",
                       {"tokens": [1, 2], "max_new_tokens": 3,
                        "stream": True, "model": "corrupt"})
    lines = _lines(body)
    assert code == 200 and lines[-1]["error"]["type"] == \
        "adapter_load_failed"
    assert not any("tokens" in c for c in lines)
    # The replica keeps serving.
    code, out = _post_json(f"{url}/generate",
                           {"tokens": [1, 2], "max_new_tokens": 3})
    assert code == 200 and len(out["tokens"]) == 3


def test_http_stream_trailer_and_metrics(model_server, models):
    url, _ = model_server
    code, body = _post(f"{url}/generate",
                       {"tokens": [9, 8, 7], "max_new_tokens": 4,
                        "stream": True, "model": "ft-2"})
    lines = _lines(body)
    toks = [t for c in lines for t in c.get("tokens", [])]
    assert code == 200 and lines[-1]["done"]
    assert toks == _solo(models, [9, 8, 7], 4, "ft-2")
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        text = r.read().decode()
    for fam in ("skytpu_adapter_loads_total", "skytpu_adapter_evictions_total",
                "skytpu_adapter_active", "skytpu_adapter_slots"):
        assert f"# TYPE {fam} " in text


def test_main_parses_the_adapter_flags(monkeypatch, tmp_path):
    """``main`` hands ``--adapters/--adapter-slots/--adapter-rank`` to
    ``make_engine`` (None when unset, so the environment's defaults
    apply), and ``make_engine`` builds the catalog through
    ``catalog_from_env``."""
    made = []

    class Stop(Exception):
        pass

    def fake_make_engine(config, **kw):
        made.append(kw)
        raise Stop

    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    raw = json.dumps({"ft-a": str(tmp_path / "a.npz")})
    for argv in ([], ["--adapters", raw, "--adapter-slots", "3",
                      "--adapter-rank", "4"]):
        with pytest.raises(Stop):
            ts.main(["--config", "llama3-tiny", "--device", "cpu"] + argv)
    assert [(k["adapters"], k["adapter_slots"], k["adapter_rank"])
            for k in made] == [(None, None, None), (raw, 3, 4)]
    monkeypatch.undo()
    monkeypatch.delenv("SKYTPU_ADAPTERS", raising=False)
    e = ts.make_engine("llama3-tiny", slots=2, max_len=64, kv_block=16,
                       device="cpu", adapters=raw, adapter_slots=3,
                       adapter_rank=4)
    assert e.adapters.names() == ["ft-a"]
    assert (e.adapters.n_adapters, e.adapters.rank) == (3, 4)
    assert ts.make_engine("llama3-tiny", slots=2, max_len=64, kv_block=16,
                          device="cpu").adapters is None


# -- the KV handoff under an adapter -------------------------------------------

_SYSTEM = list(range(5, 21))
_HPROMPT = _SYSTEM + [31, 32, 33]             # 19 tokens, 16 cached


def _hkw():
    return dict(n_slots=4, max_len=64, prompt_buckets=(48,), prefill_chunk=8,
                prefix_pool=8, kv_block=8, spec_k=0)


def _hengine(models, kind):
    jcfg, _, jp, tp = models
    if kind == "jax":
        return je.InferenceEngine(jp, jcfg, kv_kernel=True,
                                  adapters=_jcatalog(jcfg), **_hkw())
    return _engine(tp, _catalog(), **_hkw())


@pytest.mark.parametrize("src,dst", [("port", "port"), ("port", "jax"),
                                     ("jax", "port")])
def test_handoff_under_an_adapter(models, src, dst):
    """Prefill under ft-1 on one engine, export (the salt is ft-1's
    content digest), the reference's wire, import under that salt and
    resume under ft-1: the decode tier hits the 16 imported rows and
    gives the single-tier tokens of ft-1 (the JAX engine's)."""
    enc = {"port": ts.encode_export, "jax": js.encode_export}
    dec = {"port": ts.decode_export, "jax": js.decode_export}
    jcfg = models[0]
    single = je.InferenceEngine(models[2], jcfg, kv_kernel=True,
                                adapters=_jcatalog(jcfg), **_hkw())
    rid = single.add_request(_HPROMPT, 6, adapter="ft-1")
    single.run_to_completion()
    want = [r.tokens for r in single.finished if r.rid == rid][0]
    p, d = _hengine(models, src), _hengine(models, dst)
    preq = _run(p, _HPROMPT, 1, "ft-1") if src == "port" else None
    if preq is None:
        rid = p.add_request(_HPROMPT, 1, adapter="ft-1")
        p.run_to_completion()
        preq = [r for r in p.finished if r.rid == rid][0]
    export = p.export_prefix_for(preq)
    salt = ad._content_digest(_mk_params(101), 32.0)
    assert export["salt"] == salt and export["cached_len"] == 16
    wire = json.loads(json.dumps(enc[src](export)))
    assert wire["salt"] and dec[dst](wire)["salt"] == salt
    imp = dec[dst](wire)
    assert d.import_prefix(_HPROMPT + preq.tokens, imp, salt=imp["salt"]) \
        == 16
    d.finished.clear()
    rid = d.add_request(_HPROMPT, 6, adapter="ft-1", committed=preq.tokens)
    d.run_to_completion()
    req = [r for r in d.finished if r.rid == rid][0]
    assert req.resumed_len == 16
    assert req.tokens == want


def test_http_prefill_handoff_under_an_adapter(models):
    """``/prefill`` on one port replica and ``/handoff`` on another, the
    fine-tune named by the header on both: the wire carries ft-0's
    salt, the decode tier resumes over the imported rows, and the tokens
    and trailer are ft-0's single-tier ones."""
    p_url, p_stop = _start(_engine(models[3], _catalog(), **_hkw()))
    d_eng = _engine(models[3], _catalog(), **_hkw())
    d_url, d_stop = _start(d_eng)
    try:
        hdr = {ad.MODEL_HEADER: "ft-0"}
        code, out = _post_json(f"{p_url}/prefill",
                               {"tokens": _HPROMPT, "max_new_tokens": 6},
                               hdr)
        assert code == 200 and out["model"] == "ft-0"
        assert ts.decode_export(out["export"])["salt"] == \
            ad._content_digest(_mk_params(100), 32.0)
        code, got = _post_json(f"{d_url}/handoff",
                               {"tokens": _HPROMPT, "max_new_tokens": 6,
                                "committed": out["committed"],
                                "export": out["export"]}, hdr)
        assert code == 200 and got["model"] == "ft-0"
        assert got["tokens"] == _run(_engine(models[3], _catalog(),
                                             **_hkw()),
                                     _HPROMPT, 6, "ft-0").tokens
        assert d_eng.prefix_hits == 1
        code, out = _post_json(f"{d_url}/handoff",
                               {"tokens": _HPROMPT, "max_new_tokens": 6,
                                "committed": out["committed"],
                                "export": out["export"]},
                               {ad.MODEL_HEADER: "nope"})
        assert code == 404 and out["error"]["type"] == "unknown_adapter"
    finally:
        p_stop()
        d_stop()


# -- the reference load balancer before port replicas --------------------------

@pytest.fixture()
def adapter_lb(models, tmp_path, monkeypatch):
    """``tests/test_adapters.py``'s ``adapter_lb`` with two port replicas
    (each registering ft-a and ft-b) in place of its fake replicas; each
    replica counts the requests it admits, by adapter."""
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    load_balancer._adapter_cache.clear()
    engines, urls, stops, seen = [], [], [], []
    for i in range(2):
        cat = ad.AdapterCatalog(CFG, n_adapters=3, rank=RANK, device="cpu")
        cat.register("ft-a", params=_mk_params(100))
        cat.register("ft-b", params=_mk_params(101))
        e = te.InferenceEngine(models[3], CFG, n_slots=2, max_len=64,
                               prompt_buckets=(16,), adapters=cat,
                               device="cpu")
        real = e.add_request

        def counted(prompt, *a, _i=i, _real=real, **kw):
            seen.append((_i, kw.get("adapter")))
            return _real(prompt, *a, **kw)

        e.add_request = counted
        url, stop = _start(e)
        engines.append(e)
        urls.append(url)
        stops.append(stop)
    seen.clear()                                   # the warmups
    serve_state.add_service(
        "tadlb", {"adapters": {"ft-a": "/ckpt/a.npz",
                               "ft-b": "/ckpt/b.npz"}}, {}, 0)
    for i, u in enumerate(urls):
        serve_state.upsert_replica("tadlb", i + 1, f"r{i + 1}",
                                   serve_state.ReplicaStatus.READY, u)
    httpd = load_balancer._ThreadingServer(
        ("127.0.0.1", 0),
        load_balancer.make_handler("tadlb",
                                   load_balancer.LeastLoadPolicy()))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", seen
    httpd.shutdown()
    httpd.server_close()
    for stop in stops:
        stop()
    serve_state.remove_service("tadlb")
    load_balancer._adapter_cache.clear()


@pytest.mark.parametrize("stream", [False, True])
def test_lb_unknown_adapter_404_before_any_hop(adapter_lb, stream):
    lb_url, seen = adapter_lb
    code, body = _post(f"{lb_url}/generate",
                       {"tokens": [1], "model": "nope", "stream": stream})
    assert code == 404
    assert json.loads(body)["error"]["type"] == "unknown_adapter"
    assert not seen                     # rejected before a proxied hop


def test_lb_known_adapter_routes_with_affinity(adapter_lb, models):
    """A known name reaches a port replica, sticks to one replica
    (rendezvous affinity keeps its pool warm), generates the fine-tune's
    tokens under the header path as under the body path; base traffic
    spreads over both replicas."""
    lb_url, seen = adapter_lb
    cat = ad.AdapterCatalog(CFG, n_adapters=3, rank=RANK, device="cpu")
    cat.register("ft-a", params=_mk_params(100))
    want = _run(te.InferenceEngine(models[3], CFG, n_slots=2, max_len=64,
                                   prompt_buckets=(16,), adapters=cat,
                                   device="cpu"), [1, 2], 3, "ft-a").tokens
    for _ in range(4):
        code, out = _post_json(f"{lb_url}/generate",
                               {"tokens": [1, 2], "max_new_tokens": 3,
                                "model": "ft-a"})
        assert code == 200 and out["model"] == "ft-a"
        assert out["tokens"] == want
    code, out = _post_json(f"{lb_url}/generate",
                           {"tokens": [1, 2], "max_new_tokens": 3},
                           {ad.MODEL_HEADER: "ft-a"})
    assert code == 200 and out["tokens"] == want
    replicas = {i for i, a in seen if a == "ft-a"}
    assert len(replicas) == 1 and len(seen) == 5
    for _ in range(4):
        code, _ = _post_json(f"{lb_url}/generate",
                             {"tokens": [1], "max_new_tokens": 2})
        assert code == 200
    assert {i for i, a in seen if a is None} == {0, 1}
