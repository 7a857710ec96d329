"""The port's speculative decoding against the JAX package's on the CPU,
in float32: the n-gram drafter's drafts, the verify round
(``verify_draft_staged``) on the same cache and drafts, the rollback
invariant (a rejected draft leaves the cache bit-equal to a
never-drafted one), and the engine's spec tokens and per-request spec
counts on the reference's own workloads (``tests/test_spec_decode.py``),
each also equal to the port's spec-off tokens. The engine cases run on
the kernel-path engine and on the ``plain_attention=True`` one (both
plain on the CPU, through the same dispatch)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import sampling as tsamp
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


# -- drafter -----------------------------------------------------------------

_DRAFT_STREAMS = {
    "match": [1, 2, 3, 9, 1, 2],
    "miss": [1, 2, 3, 4, 5],
    "cycle": [7, 8, 7, 8, 7, 8],
    "empty": [],
    "one": [5],
    "pair": [5, 5],
}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_drafter_matches_reference(n):
    """Drafts for k = 0..6 after every token of the reference's literal
    streams and of seeded streams over small vocabularies (so n-grams
    repeat and cycles form), and the same after catch_up."""
    rng = np.random.default_rng(n)
    streams = list(_DRAFT_STREAMS.values()) + [
        rng.integers(0, v, 40).tolist() for v in (2, 3, 5, 50)]
    for toks in streams:
        tp, jp = te.NGramDrafter([], n=n), je.NGramDrafter([], n=n)
        for t in toks:
            tp.extend([t])
            jp.extend([t])
            for k in range(7):
                assert tp.draft(k) == jp.draft(k), (toks, k)
        half = len(toks) // 2
        tc, jc = (cls(toks[:half], n=n) for cls in (te.NGramDrafter,
                                                    je.NGramDrafter))
        for d in (tc, jc):
            d.catch_up(toks[:half], toks[half:])
            d.catch_up(toks[:half], toks[half:])     # idempotent
        assert tc.tokens == jc.tokens == toks
        assert tc.draft(4) == jc.draft(4)


def test_drafter_reference_cases():
    assert te.NGramDrafter([1, 2, 3, 9, 1, 2]).draft(3) == [3, 9, 1]
    assert te.NGramDrafter([7, 8, 7, 8, 7, 8]).draft(6) == [7, 8] * 3
    assert te.NGramDrafter([5, 5], n=3).draft(4) == []
    assert te.NGramDrafter([1, 2, 1, 2]).draft(0) == []


# -- the verify round --------------------------------------------------------

MAX_LEN, BL, N_BLOCKS, K = 32, 8, 8, 4
NB = MAX_LEN // BL


@pytest.fixture(scope="module")
def verify_setup(models):
    """Three slots prefilled through the JAX and the port's programs: slot
    0 (13 rows) and slot 1 (9 rows) active, slot 2 inactive with a
    stale length; table rows past each allocation are the sentinel."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(0)
    table = np.full((3, NB + 1), N_BLOCKS, np.int32)
    table[0, :3] = [4, 1, 6]
    table[1, :3] = [0, 5, 2]
    table[2, :1] = [7]
    lens = np.array([13, 9, 5], np.int64)
    tokens = np.zeros((3, 16), np.int64)
    for w, n in enumerate(lens):
        tokens[w, :n] = rng.integers(1, tcfg.vocab_size, n)
    prefix, logits = jkv.prefill_batch(jp, jnp.asarray(tokens),
                                       jnp.asarray(lens), jcfg)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    jcache = jkv.init_paged_cache(jcfg, 3, N_BLOCKS, BL)
    tcache = tkv.init_paged_cache(tcfg, 3, N_BLOCKS, BL, "cpu")
    tt = torch.from_numpy(table)
    for w in range(3):
        row = {n: prefix[n][:, w] for n in ("k", "v")}
        jcache = jkv.insert(jcache, row, w, jnp.asarray(lens[w]), first[w],
                            table=jnp.asarray(table))
        tkv.insert(tcache, {n: torch.from_numpy(np.array(r))
                            for n, r in row.items()},
                   w, int(lens[w]), int(first[w]), tt)
    # The greedy continuation of slots 0 and 1 (an oracle draft).
    _, _, cont = jkv.decode_burst_staged(
        jp, jcache, jax.random.key(0), jnp.asarray([True, True, False]),
        K + 1, jcfg, jkv.sampling_mod.SamplingParams(),
        table=jnp.asarray(table), kv_kernel=True)
    return table, jcache, tcache, np.asarray(cont).T


def _cache_rows(cache, table, slot, n):
    """Slot ``slot``'s logical rows [0, n) of every layer (k and v)."""
    blk, off = tkv._phys({"k": torch.empty((1, 1, BL))},
                         torch.from_numpy(table), slot, torch.arange(n))
    return [np.asarray(cache[name])[:, blk.numpy(), off.numpy()]
            for name in ("k", "v")]


@pytest.mark.parametrize("span", [None, 16], ids=["full", "span16"])
@pytest.mark.parametrize("case", ["oracle", "partial", "short"])
def test_verify_matches_jax(models, verify_setup, span, case):
    """The same cache, draft, n_draft, active mask and span through both
    verify programs: equal window tokens, n_commit, lengths, last
    tokens, and cache rows below the new lengths. ``oracle``: slot 0
    drafts its true continuation (all accepted); ``partial``: slot 1's
    third draft token is wrong; ``short``: slot 0 drafts 2 tokens and
    slot 1 none."""
    jcfg, tcfg, jp, tp = models
    table, jcache, tcache0, cont = verify_setup
    tcache = {n: t.clone() for n, t in tcache0.items()}
    draft = np.zeros((3, K), np.int64)
    draft[:2] = cont[:2, :K]
    n_draft = np.array([K, K, K], np.int64)
    if case == "partial":
        draft[1, 2] = (draft[1, 2] + 1) % tcfg.vocab_size
    if case == "short":
        n_draft[:] = [2, 0, 0]
    active = np.array([True, True, False])
    jcache, jtoks, jcommit = jkv.verify_draft_staged(
        jp, jcache, jnp.asarray(draft, jnp.int32),
        jnp.asarray(n_draft, jnp.int32), jnp.asarray(active), K, jcfg,
        table=jnp.asarray(table), span=span, kv_kernel=True)
    ttoks, tcommit = tkv.verify_draft_staged(
        tp, tcache, torch.from_numpy(draft), torch.from_numpy(n_draft),
        torch.from_numpy(active), K, tcfg, torch.from_numpy(table),
        span=span)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tcommit.numpy(), np.asarray(jcommit))
    want_commit = {"oracle": [K + 1, K + 1, 0], "partial": [K + 1, 3, 0],
                   "short": [3, 1, 0]}[case]
    assert tcommit.tolist() == want_commit
    for name in ("length", "last_token"):
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(jcache[name]))
    for slot in (0, 1):
        n = int(tcache["length"][slot])
        for got, want in zip(_cache_rows(tcache, table, slot, n),
                             _cache_rows(jcache, table, slot, n)):
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_rejected_draft_leaves_the_cache_bit_equal(models, verify_setup):
    """A verify round whose draft is fully rejected leaves every
    committed row, the lengths and the last tokens bit-equal to the same
    round run with no draft: rejected rows sit past the committed
    length."""
    _, tcfg, _, tp = models
    table, _, tcache0, cont = verify_setup
    active = torch.tensor([True, True, False])
    tt = torch.from_numpy(table)
    out = {}
    for name, d, nd in (
            ("rejected", (cont[:, :K] + 1) % tcfg.vocab_size, [K, K, 0]),
            ("bare", np.zeros((3, K), np.int64), [0, 0, 0])):
        cache = {n: t.clone() for n, t in tcache0.items()}
        toks, commit = tkv.verify_draft_staged(
            tp, cache, torch.as_tensor(d, dtype=torch.long),
            torch.tensor(nd), active, K, tcfg, tt)
        out[name] = (cache, toks, commit)
    (rej, rt, rc), (bare, bt, bc) = out["rejected"], out["bare"]
    assert rc.tolist() == bc.tolist() == [1, 1, 0]
    assert torch.equal(rt[:, 0], bt[:, 0])
    assert torch.equal(rej["length"], bare["length"])
    assert torch.equal(rej["last_token"], bare["last_token"])
    for slot in (0, 1):
        n = int(bare["length"][slot])
        for a, b in zip(_cache_rows(rej, table, slot, n),
                        _cache_rows(bare, table, slot, n)):
            assert np.array_equal(a, b)


# -- the engine on the reference's workloads ---------------------------------

def _prompts(vocab, n=3, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).tolist() for _ in range(n)]


def _replay_drafter(outputs, transform=None):
    """Drafter factory replaying a known continuation per prompt: the
    oracle (transform None, every draft accepted) or an always-wrong
    variant."""

    class Replay:
        def __init__(self, req):
            self.out = outputs[tuple(req.prompt)]
            self.seen = 0

        def catch_up(self, prompt, generated):
            self.seen = len(generated)

        def draft(self, k):
            nxt = self.out[self.seen:self.seen + k]
            return [transform(t) for t in nxt] if transform else list(nxt)

    return Replay


def _kw(**kw):
    base = dict(n_slots=4, max_len=128, prompt_buckets=(32,), kv_block=8,
                prefill_chunk=0, prefix_pool=0)
    base.update(kw)
    return base


def _requests(engine):
    """Per request, in rid order: prompt, tokens and spec counts."""
    return [(r.prompt, r.tokens, r.spec_drafted, r.spec_accepted,
             r.spec_off, r.cached_len)
            for r in sorted(engine.finished, key=lambda r: r.rid)]


def _generate(mk, prompts, max_new, spec_k, **kw):
    e = mk(spec_k=spec_k, **kw)
    e.generate(prompts, max_new_tokens=max_new)
    return e


def w_paged(mk, vocab):
    """Spec-on greedy generation on the paged layout (:134)."""
    return _generate(mk, _prompts(vocab), 24, 4, **_kw())


def w_warm_prefix_chunked(mk, vocab):
    """Cold chunked then warm suffix-only admission (:160): the second
    prompt hits the first's 16-token prefix."""
    system = list(range(5, 21))
    e = mk(spec_k=4, **_kw(prompt_buckets=(48,), max_len=96,
                           prefill_chunk=8, prefix_pool=4))
    for p in (system + [31, 32, 33], system + [41, 42]):
        e.generate([p], max_new_tokens=10)
    return e


def w_max_len(mk, vocab):
    """Generation capped by max_len: slots near it draft nothing
    (:205)."""
    return _generate(mk, _prompts(vocab, n=2), 64, 4,
                     **_kw(n_slots=2, max_len=32))


def _spec_off_tokens(mk, prompts_budgets, **kw):
    """The spec-off engine's tokens per prompt, each prompt alone."""
    out = {}
    for p, budget in prompts_budgets:
        e = mk(spec_k=0, **kw)
        out[tuple(p)] = e.generate([p], max_new_tokens=budget)[0]
    return out


def w_tight_slot(mk, vocab):
    """A slot within K+1 rows of max_len beside a drafting neighbour fed
    by an oracle (:218)."""
    tight, roomy = list(range(1, 21)), [3, 1, 4]
    kw = _kw(n_slots=2, max_len=32, prompt_buckets=(24,))
    oracle = _spec_off_tokens(mk, [(tight, 64), (roomy, 12)], **kw)
    e = mk(spec_k=4, spec_drafter=_replay_drafter(oracle), **kw)
    e.add_request(tight, max_new_tokens=64)
    e.add_request(roomy, max_new_tokens=12)
    e.run_to_completion(max_burst=4)
    return e


def w_eos_mid_commit(mk, vocab):
    """EOS inside an accepted run retires the request where spec-off does
    (:248)."""
    prompts = _prompts(vocab, n=2)
    ref = _generate(mk, prompts, 24, 0, **_kw())
    first = sorted(ref.finished, key=lambda r: r.rid)[0].tokens
    return _generate(mk, prompts, 24, 4, eos_id=first[len(first) // 2],
                     **_kw())


def w_oracle(mk, vocab):
    """An oracle drafter: every draft accepted (:264)."""
    prompts = _prompts(vocab, n=2)
    oracle = _spec_off_tokens(mk, [(p, 20) for p in prompts], **_kw())
    return _generate(mk, prompts, 20, 4,
                     spec_drafter=_replay_drafter(oracle), **_kw())


def w_anti_oracle(mk, vocab):
    """An always-wrong drafter with the collapse ladder off: every draft
    rolled back (:297, engine level)."""
    prompts = _prompts(vocab, n=2)
    oracle = _spec_off_tokens(mk, [(p, 16) for p in prompts], **_kw())
    e = mk(spec_k=3, spec_drafter=_replay_drafter(
        oracle, transform=lambda t: (t + 1) % vocab), **_kw())
    e.spec_min_rate = 0.0
    e.generate(prompts, max_new_tokens=16)
    return e


def w_collapse(mk, vocab):
    """Acceptance collapse turns a request's speculation off (:381)."""
    prompts = _prompts(vocab, n=1, length=8)
    oracle = _spec_off_tokens(mk, [(prompts[0], 32)], **_kw())
    e = mk(spec_k=4, spec_drafter=_replay_drafter(
        oracle, transform=lambda t: (t + 1) % vocab), **_kw())
    e.spec_min_drafted = 8
    e.generate(prompts, max_new_tokens=32)
    return e


def w_no_draft(mk, vocab):
    """No slot drafts: the verify round declines and a plain burst runs
    (:402)."""
    e = mk(spec_k=4, **_kw())
    e.add_request(list(range(1, 9)), max_new_tokens=4)
    e.admit()
    assert e.spec_decode_burst() is None
    e.decode_burst(4)
    e.run_to_completion()
    return e


_WORKLOADS = {f.__name__[2:]: f for f in (
    w_paged, w_warm_prefix_chunked, w_max_len, w_tight_slot,
    w_eos_mid_commit, w_oracle, w_anti_oracle, w_collapse, w_no_draft)}


@pytest.fixture(scope="module")
def jax_runs(models):
    jcfg, _, jp, _ = models
    cache = {}

    def mk(**kw):
        # The Pallas paged kernel in interpret mode: the program the
        # port's kernel path is held to.
        return je.InferenceEngine(jp, jcfg, kv_kernel=True, **kw)

    def get(name):
        if name not in cache:
            e = _WORKLOADS[name](mk, jcfg.vocab_size)
            off = _WORKLOADS[name](_spec_off(mk), jcfg.vocab_size)
            cache[name] = (_requests(e), e._spec_drafted_total,
                           e._spec_accepted_total,
                           [r[1] for r in _requests(off)])
        return cache[name]

    return get


def _spec_off(mk):
    """``mk`` with speculation off: the workload's spec-off twin."""
    def mk_off(**kw):
        kw["spec_k"] = 0
        kw.pop("spec_drafter", None)
        return mk(**kw)
    return mk_off


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
@pytest.mark.parametrize("workload", list(_WORKLOADS))
def test_engine_spec_matches_jax_and_spec_off(models, jax_runs, workload,
                                              plain):
    """The port's spec engine: tokens, per-request spec counts and
    collapse state equal to the JAX spec engine's, and tokens equal to
    the port's own spec-off engine's on the same workload."""
    _, tcfg, _, tp = models

    def mk(**kw):
        return te.InferenceEngine(tp, tcfg, device="cpu",
                                  plain_attention=plain, **kw)

    e = _WORKLOADS[workload](mk, tcfg.vocab_size)
    got = _requests(e)
    want, jdrafted, jaccepted, jax_off = jax_runs(workload)
    assert got == want
    assert (e._spec_drafted_total, e._spec_accepted_total) == \
        (jdrafted, jaccepted)
    off = _WORKLOADS[workload](_spec_off(mk), tcfg.vocab_size)
    off_tokens = [r[1] for r in _requests(off)]
    assert off_tokens == jax_off
    assert off.verify_calls == 0
    # Spec-on equals spec-off wherever the JAX kernel path's pair does.
    # That path computes the staged columns (a round's or a burst's own
    # rows) as bf16 products and the cached ones in float32, so a verify
    # round, which splits the columns at other rows than a plain burst,
    # may flip a greedy token where two logits lie within ~1e-2 (the
    # collapse workload: a 6.4e-3 top-2 gap at step 25); the port then
    # parts exactly where the reference does, by the equalities above.
    if [r[1] for r in want] == jax_off:
        assert [r[1] for r in got] == off_tokens
    reqs = {tuple(r[0]): r for r in got}
    if workload in ("oracle", "tight_slot"):
        assert e._spec_drafted_total > 0
        assert e.verify_calls > 0
    if workload == "oracle":
        assert e._spec_accepted_total == e._spec_drafted_total
    if workload == "anti_oracle":
        assert e._spec_drafted_total > 0 and e._spec_accepted_total == 0
    if workload == "collapse":
        (_, _, drafted, accepted, spec_off, _), = got
        assert spec_off and accepted == 0 and 8 <= drafted < 31
    if workload == "warm_prefix_chunked":
        assert got[1][5] == 16
    if workload == "max_len":
        assert all(len(p) + len(t) == 32 for p, t, *_ in got)
    if workload == "tight_slot":
        roomy = reqs[(3, 1, 4)]
        assert roomy[2] > 0 and roomy[3] == roomy[2]
        assert reqs[tuple(range(1, 21))][2] <= 32 - 20 - 5 + 4
    if workload == "eos_mid_commit":
        assert any(len(r[1]) < 24 for r in got)
    if workload == "no_draft":
        assert e._spec_drafted_total == 0 and e.verify_calls == 0


def test_spec_k_is_clamped_and_greedy_only(models):
    _, tcfg, _, tp = models

    def mk(**kw):
        return te.InferenceEngine(tp, tcfg, device="cpu", **_kw(**kw))

    assert mk().spec_k == 0
    assert mk(spec_k=-5).spec_k == 0
    assert mk(spec_k=99).spec_k == 16
    assert mk(spec_k=4, sampling_params=tsamp.SamplingParams(
        temperature=0.7)).spec_k == 0
