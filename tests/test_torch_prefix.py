"""The port's prefix KV cache against the JAX package's on the CPU, in
float32: the prefix digest (byte-equal to the reference index's and to
the load balancer's affinity key), the index's LRU bookkeeping, the
copy-on-write block copy, and the paged engine's warm hits (shared
blocks, copy-on-share and copy-on-write of a partial block, dry-pool
eviction, a hit admitted against a dry pool) against the JAX engine's
tokens and counts on the reference's own workloads
(``tests/test_paged_kv.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.models import llama as jl
from skypilot_tpu.serve import load_balancer
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.models import llama as tl


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


# -- PrefixIndex -------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 512])
@pytest.mark.parametrize("salt", [b"", b"\x9a" * 16],
                         ids=["base", "adapter"])
def test_digest_matches_reference_and_affinity_key(chunk, salt):
    """For seeded prompts of many lengths the port's digest of the
    longest chunk-aligned proper prefix is the reference index's and the
    load balancer's ``prefix_affinity_key``, byte for byte; a prompt no
    longer than one chunk is ineligible in all three."""
    rng = np.random.default_rng(chunk)
    ti, ji = te.PrefixIndex(4, chunk), je.PrefixIndex(4, chunk)
    for n in (1, chunk, chunk + 1, 2 * chunk, 3 * chunk + 5, 1500):
        prompt = rng.integers(0, 128_256, n).tolist()
        key = load_balancer.prefix_affinity_key(prompt, chunk, salt)
        assert ti.eligible(prompt) == ji.eligible(prompt) == \
            (key is not None)
        if key is None:
            continue
        cut = ((n - 1) // chunk) * chunk
        assert ti._digest(prompt, cut, salt) == \
            ji._digest(prompt, cut, salt) == key


def test_index_bookkeeping_matches_reference():
    """One sequence of insert_entry / lookup / register / evict_lru calls
    with tuple payloads (the paged engine's) gives the reference index's
    results and LRU order at every step."""
    a, b, c = (list(range(s, s + 20)) for s in (100, 200, 300))
    idx = {"port": te.PrefixIndex(rows=2, block=4),
           "ref": je.PrefixIndex(rows=2, block=4)}

    def both(call, *args):
        out = {k: getattr(i, call)(*args) for k, i in idx.items()}
        assert out["port"] == out["ref"], (call, args, out)
        assert idx["port"].payloads_lru() == idx["ref"].payloads_lru()
        return out["port"]

    assert both("insert_entry", a, 8, (0, 1)) == []
    assert both("insert_entry", b, 8, (2, 3)) == []
    assert both("lookup", a) == ((0, 1), 8)       # a is now the newest
    assert both("insert_entry", c, 12, (4, 5, 6)) == [(2, 3)]
    assert both("lookup", b) is None
    assert both("lookup", c) == ((4, 5, 6), 12)
    assert both("lookup", a[:4] + [9] * 5) == ((0, 1), 4)
    assert both("lookup", a[:8]) == ((0, 1), 4)   # one suffix token left
    both("register", a, 16, (0, 1))
    assert both("lookup", a) == ((0, 1), 16)
    assert both("evict_lru") == (4, 5, 6)
    assert both("lookup", c) is None
    assert both("payloads") == [(0, 1)]
    both("evict_entry", (0, 1))
    assert both("evict_lru") is None and both("lookup", a) is None


def test_copy_block_matches_jax():
    rng = np.random.default_rng(0)
    shape = (2, 5, 8, 2, 16)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v)}
    for src, dst in ((3, 1), (0, 4)):
        jcache = jkv.copy_block(jcache, jnp.asarray(src), jnp.asarray(dst))
        tkv.copy_block(tcache, src, dst)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(jcache[name]))
    assert np.array_equal(tcache["k"][:, 1].numpy(), k[:, 3])


# -- the engine --------------------------------------------------------------

_SYSTEM = list(range(5, 21))                       # 16 tokens = 2 chunks


def _pair_kw(kv_block, chunk=8, pool=4):
    return dict(n_slots=4, max_len=64, prompt_buckets=(16, 48),
                prefill_chunk=chunk, prefix_pool=pool, kv_block=kv_block,
                spec_k=0)


def _jax_engine(jp, jcfg, **kw):
    # The Pallas paged kernel in interpret mode: the program the port's
    # kernel path is held to.
    return je.InferenceEngine(jp, jcfg, kv_kernel=True, **kw)


def _torch_engine(tp, tcfg, plain, **kw):
    return te.InferenceEngine(tp, tcfg, device="cpu",
                              plain_attention=plain, **kw)


_PATHS = pytest.mark.parametrize("plain", [False, True],
                                 ids=["kernel", "plain"])


def _cow():
    return je.KV_COW_COPIES._require_default().value


@_PATHS
def test_warm_equals_cold_equals_jax_block_aligned(models, plain):
    """Chunk 8, blocks of 8: the stored prefix is block-aligned, so the
    hit maps shared blocks with no copy; the warm request prefills one
    chunk from row 16, and warm, cold-after-clear and the JAX engine's
    warm tokens are equal."""
    jcfg, tcfg, jp, tp = models
    pa, pb = _SYSTEM + [31, 32, 33, 34], _SYSTEM + [41, 42, 43]
    kw = _pair_kw(kv_block=8)
    ref = _jax_engine(jp, jcfg, **kw)
    e = _torch_engine(tp, tcfg, plain, **kw)
    for eng in (ref, e):
        eng.generate([pa], max_new_tokens=6)
        eng.finished.clear()
    cow0 = _cow()
    want = ref.generate([pb], max_new_tokens=6)[0]
    assert _cow() == cow0
    warm = e.generate([pb], max_new_tokens=6)[0]
    (req,) = e.finished
    (jreq,) = ref.finished
    assert (req.cached_len, req.n_chunks) == (jreq.cached_len,
                                              jreq.n_chunks) == (16, 1)
    assert e.cow_copies == 0 and e.prefix_hits == 1
    assert e.prefix_misses == 1                     # pa's cold claim
    e.finished.clear()
    e.clear_prefix_cache()
    cold = e.generate([pb], max_new_tokens=6)[0]
    assert e.finished[0].cached_len == 0
    assert warm == cold == want


@_PATHS
def test_partial_block_copy_on_share_then_write(models, plain):
    """Chunk 8, blocks of 16: a 24-token stored prefix ends mid-block, so
    storing copies the partial block (copy-on-share) and the hit copies
    it again before its suffix prefill writes there (copy-on-write), as
    the JAX engine counts; tokens equal the JAX engine's and the cold
    run's."""
    jcfg, tcfg, jp, tp = models
    system = list(range(5, 29))                     # 24 tokens
    pa, pb = system + [31, 32, 33], system + [41, 42]
    kw = _pair_kw(kv_block=16)
    ref = _jax_engine(jp, jcfg, **kw)
    e = _torch_engine(tp, tcfg, plain, **kw)
    cow0 = _cow()
    want_a = ref.generate([pa], max_new_tokens=6)[0]
    jcow_a = _cow() - cow0
    assert e.generate([pa], max_new_tokens=6)[0] == want_a
    assert e.cow_copies == jcow_a == 1
    ref.finished.clear()
    e.finished.clear()
    want_b = ref.generate([pb], max_new_tokens=6)[0]
    warm = e.generate([pb], max_new_tokens=6)[0]
    assert e.cow_copies == _cow() - cow0 == 2
    assert e.finished[0].cached_len == ref.finished[0].cached_len == 24
    e.finished.clear()
    e.clear_prefix_cache()
    assert warm == want_b == e.generate([pb], max_new_tokens=6)[0]


def _dry_engine(cls, params, cfg, **kw):
    if cls is je.InferenceEngine:
        kw["kv_kernel"] = True
    return cls(params, cfg, n_slots=2, max_len=64, prompt_buckets=(48,),
               prefill_chunk=8, kv_block=8, kv_blocks=9, spec_k=0, **kw)


@_PATHS
def test_dry_pool_evicts_prefix_entries(models, plain):
    """Nine blocks, a stored prefix holding 2: two 40-token requests
    needing 6 blocks each find the pool dry; LRU entries that free blocks
    are evicted (counted as the JAX engine counts them) and everyone
    completes with the JAX engine's tokens."""
    jcfg, tcfg, jp, tp = models
    ref = _dry_engine(je.InferenceEngine, jp, jcfg, prefix_pool=4)
    e = _dry_engine(te.InferenceEngine, tp, tcfg, prefix_pool=4,
                    device="cpu", plain_attention=plain)
    long_ = [list(range(100, 140)), list(range(150, 190))]
    ev0 = je.PREFIX_EVICTIONS._require_default().value
    for eng in (ref, e):
        eng.generate([_SYSTEM + [31, 32]], max_new_tokens=4)
        eng.finished.clear()
    assert e.blocks_used() == ref.blocks_used == 2
    want = ref.generate(long_, max_new_tokens=4)
    assert e.generate(long_, max_new_tokens=4) == want
    jev = je.PREFIX_EVICTIONS._require_default().value - ev0
    assert e.prefix_evictions == jev > 0
    assert not e.waiting and not e.chunking


@_PATHS
def test_hit_survives_dry_pool_admission(models, plain):
    """A hit claimed against a dry pool pins its shared blocks before
    eviction, so it never evicts its own entry (which would free
    nothing) and stalls until the hog retires: still warm, no eviction,
    the JAX engine's tokens; then clear_prefix_cache() frees every
    block."""
    jcfg, tcfg, jp, tp = models
    pb = _SYSTEM + [41, 42, 43, 44, 45, 46, 47, 48]
    out = {}
    for name, eng in (
            ("ref", _dry_engine(je.InferenceEngine, jp, jcfg,
                                prefix_pool=2)),
            ("port", _dry_engine(te.InferenceEngine, tp, tcfg,
                                 prefix_pool=2, device="cpu",
                                 plain_attention=plain))):
        eng.generate([_SYSTEM + [31, 32]], max_new_tokens=4)
        eng.finished.clear()
        ev0 = (je.PREFIX_EVICTIONS._require_default().value
               if name == "ref" else eng.prefix_evictions)
        eng.add_request([1, 2, 3, 4], max_new_tokens=44)   # 6 blocks
        eng.admit()
        assert len(eng.slot_req) == 1
        eng.add_request(pb, max_new_tokens=4)
        eng.run_to_completion(max_burst=4)
        ev = (je.PREFIX_EVICTIONS._require_default().value
              if name == "ref" else eng.prefix_evictions) - ev0
        req = next(r for r in eng.finished if r.prompt == pb)
        out[name] = (req.tokens, req.cached_len, ev)
    assert out["port"] == out["ref"]
    assert out["port"][1:] == (16, 0)
    eng.clear_prefix_cache()
    assert eng.blocks_used() == 0


@_PATHS
def test_blocks_return_to_the_entries_then_to_zero(models, plain):
    """A mixed workload (waves, chunked prompts, a store and a hit):
    once the queue drains only the resident entries hold blocks (as in
    the JAX engine), clear_prefix_cache() frees them, and reset() clears
    the index."""
    jcfg, tcfg, jp, tp = models
    prompts = [_SYSTEM + [31, 32], [3, 1, 4], _SYSTEM + [41, 42, 43]]
    kw = _pair_kw(kv_block=8)
    ref = _jax_engine(jp, jcfg, **kw)
    e = _torch_engine(tp, tcfg, plain, **kw)
    want = ref.generate(prompts, max_new_tokens=5)
    assert e.generate(prompts, max_new_tokens=5) == want
    assert not e.slot_req and not e.chunking
    held = sum(len(p) for p in e._prefix_index.payloads())
    assert e.blocks_used() == ref.blocks_used == held > 0
    e.clear_prefix_cache()
    assert e.blocks_used() == 0
    e.generate([_SYSTEM + [7, 8]], max_new_tokens=2)
    assert e._prefix_index.payloads()
    e.reset()
    assert not e._prefix_index.payloads() and e.blocks_used() == 0
    assert e.generate([_SYSTEM + [7, 8]], max_new_tokens=2)[0]


def test_prefix_pool_needs_chunking(models):
    _, tcfg, _, tp = models
    e = te.InferenceEngine(tp, tcfg, n_slots=1, max_len=32,
                           prompt_buckets=(16,), kv_block=8,
                           prefill_chunk=0, prefix_pool=3, device="cpu")
    assert e.prefix_pool == 0 and e._prefix_index is None
