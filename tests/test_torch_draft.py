"""The port's draft model and async draft/verify pipeline against the JAX
package's on the CPU, in float32: ``infer/draft.py`` (truncated and
self-distilled drafts, ``draft_engine_from_env``, the ``DraftEngine``'s
lockstep, rollback, predraft reuse and release), ``kvcache.sync_slots``,
and the engine's ``model`` rung, pipelined and synchronous, on the
workloads of the reference's own ``tests/test_draft_model.py``: tokens,
per-request spec counts and rungs, and the drafter's counters equal to
the JAX engine's and its ``DraftEngine``'s on the same call sequence, and
tokens equal to spec-off.

The JAX target runs its Pallas paged kernel in interpret mode
(``kv_kernel=True``), the program the port's kernel path is held to
(``tests/test_torch_spec.py``). The JAX ``DraftEngine`` calls
``kvcache.decode_burst_staged`` and ``prefill_chunk`` without the
switch, so :func:`_jax_drafter_on_the_kernel` runs its programs on the
same kernel: on its gather path the draft model's tokens part from the
port's (and from its own target's) at top-2 gaps near 1e-2, which moves
its rollback and reuse counts, though never the committed tokens.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import adapters as jad
from skypilot_tpu.infer import draft as jd
from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import adapters as tad
from skypilot_tpu_torch.infer import draft as td
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import flight as flight_lib

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def distilled(models):
    """The distilled pairs on both sides: (JAX target, draft params,
    draft config), (port target, draft params, draft config)."""
    jcfg, tcfg, jp, tp = models
    return (jd.self_distilled_pair(jp, jcfg, 1),
            td.self_distilled_pair(tp, tcfg, 1))


@pytest.fixture(scope="module")
def random_draft(models):
    """A 1-layer random draft model on both sides (the reference's
    ``_random_draft``, seed 7): acceptance ~0 on a full-vocab
    workload."""
    jcfg, tcfg, _, _ = models
    jdc = dataclasses.replace(jcfg, n_layers=1)
    tdc = dataclasses.replace(tcfg, n_layers=1)
    jrp = jl.init_params(jax.random.key(7), jdc)
    trp = tl.params_from_numpy(jax.tree.map(np.asarray, jrp), tdc,
                               device="cpu")
    return (jrp, jdc), (trp, tdc)


@contextlib.contextmanager
def _jax_drafter_on_the_kernel():
    """The JAX programs on the Pallas paged kernel in interpret mode
    while the block runs (see the module docstring); an explicit
    ``kv_kernel`` argument still wins."""
    real_burst, real_chunk = jkv.decode_burst_staged, jkv.prefill_chunk
    jkv.decode_burst_staged = functools.partial(real_burst, kv_kernel=True)
    jkv.prefill_chunk = functools.partial(real_chunk, kv_kernel=True)
    try:
        yield
    finally:
        jkv.decode_burst_staged, jkv.prefill_chunk = real_burst, real_chunk


def _prompts(vocab, n=3, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).tolist() for _ in range(n)]


def _kw(**kw):
    base = dict(n_slots=4, max_len=128, prompt_buckets=(32,))
    base.update(kw)
    return base


def _jax_engine(params, cfg, **kw):
    return je.InferenceEngine(params, cfg, kv_kernel=True, **_kw(**kw))


def _port_engine(params, cfg, **kw):
    return te.InferenceEngine(params, cfg, device="cpu", **_kw(**kw))


def _jax_draft(dparams, dcfg, slots=4, max_len=128, **kw):
    return jd.DraftEngine(dparams, dcfg, n_slots=slots, max_len=max_len,
                          **kw)


def _port_draft(dparams, dcfg, slots=4, max_len=128, **kw):
    return td.DraftEngine(dparams, dcfg, n_slots=slots, max_len=max_len,
                          device="cpu", **kw)


def _requests(engine):
    """Per request, in rid order: tokens, spec counts and final rung."""
    return [(r.tokens, r.spec_drafted, r.spec_accepted, r.spec_mode)
            for r in sorted(engine.finished, key=lambda r: r.rid)]


# -- draft-model construction --------------------------------------------------

def test_truncated_draft_shapes_and_views(models):
    _, tcfg, _, tp = models
    dparams, dcfg = td.truncated_draft(tp, tcfg, 1)
    assert dcfg.n_layers == 1
    for name, w in dparams["blocks"].items():
        assert w.shape[0] == 1
        assert w.shape[1:] == tp["blocks"][name].shape[1:]
        # A view of the target's stacked tensor, no copy.
        assert w.data_ptr() == tp["blocks"][name].data_ptr()
    assert dparams["embed"] is tp["embed"]
    assert td.truncated_draft(tp, tcfg, 99)[1].n_layers == tcfg.n_layers
    assert td.truncated_draft(tp, tcfg, 0)[1].n_layers == 1


def test_self_distilled_pair_agrees_exactly(models, distilled):
    """The port's distilled target is the JAX one's, value for value,
    and its truncated draft gives bit-equal logits (adding exact zeros
    is exact)."""
    jcfg, tcfg, _, tp = models
    (jt, _, _), (tt, tdp, tdc) = distilled
    want = tl.params_from_numpy(jax.tree.map(np.asarray, jt), tcfg,
                                device="cpu")
    for name in ("wo", "w_down"):
        assert torch.equal(tt["blocks"][name], want["blocks"][name])
        assert not torch.equal(tt["blocks"][name], tp["blocks"][name])
    # ``params`` itself is left as it was.
    assert tp["blocks"]["wo"][1:].abs().sum() > 0
    toks = torch.tensor([[5, 9, 2, 6, 5, 3, 5, 8]])
    lens = torch.tensor([8])
    _, lt = tkv.prefill_batch(tt, toks, lens, tcfg)
    _, ld = tkv.prefill_batch(tdp, toks, lens, tdc)
    assert torch.equal(lt, ld)


def test_draft_engine_from_env(models, monkeypatch):
    jcfg, tcfg, jp, tp = models
    de = td.draft_engine_from_env(tp, tcfg, 2, 64, spec="self:1",
                                  device="cpu")
    assert de is not None and de.cfg.n_layers == 1
    assert de.params["blocks"]["wq"].data_ptr() == \
        tp["blocks"]["wq"].data_ptr()
    assert td.draft_engine_from_env(tp, tcfg, 2, 64, spec="",
                                    device="cpu") is None
    monkeypatch.setenv("SKYTPU_DRAFT_MODEL", "self:1")
    assert td.draft_engine_from_env(tp, tcfg, 2, 64,
                                    device="cpu") is not None
    monkeypatch.delenv("SKYTPU_DRAFT_MODEL")
    assert td.draft_engine_from_env(tp, tcfg, 2, 64, device="cpu") is None
    # A config name: that shape with the target's vocabulary.
    de = td.draft_engine_from_env(tp, tcfg, 2, 64, spec="llama3-tiny",
                                  device="cpu")
    assert de.cfg.vocab_size == tcfg.vocab_size
    assert de.params["embed"].shape == (tcfg.vocab_size, tcfg.d_model)
    with pytest.raises(ValueError) as got:
        td.draft_engine_from_env(tp, tcfg, 2, 64, spec="no-such-model",
                                 device="cpu")
    with pytest.raises(ValueError) as want:
        jd.draft_engine_from_env(jp, jcfg, 2, 64, spec="no-such-model")
    assert str(got.value) == str(want.value)


def test_draft_engine_layout(distilled):
    """The port's layout: no spare slot, the sentinel column pointing
    at the trash block, one full-length allocation per slot; with
    ``kv_block`` 0 the contiguous layout (one max_len row per slot and
    the trash slot, no table)."""
    _, (_, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc, slots=3, max_len=64, kv_block=16)
    assert de.kv_block == 16 and de.blocks_per_slot == 4
    assert de.n_kv_blocks == 12 and de.block_table.shape == (3, 5)
    assert (de.block_table == 12).all()
    assert de.cache["k"].shape[1] == 13            # + the trash block
    assert de.cache["length"].shape == (3,)
    de = _port_draft(tdp, tdc, slots=3, max_len=64, kv_block=0)
    assert not de.paged and de.block_table is None
    assert de.table_device() is None and de.blocks_used == 0
    assert de.cache["k"].shape[1:3] == (4, 64)     # + the trash slot


# -- kvcache.sync_slots ------------------------------------------------------

def test_sync_slots_matches_jax(models):
    jcfg, tcfg, _, _ = models
    rng = np.random.default_rng(3)
    lengths0 = rng.integers(0, 60, 5).astype(np.int32)
    last0 = rng.integers(0, 500, 5).astype(np.int32)
    active = np.array([True, False, True, True, False])
    lengths = rng.integers(0, 60, 5).astype(np.int32)
    tokens = rng.integers(0, 500, 5).astype(np.int32)
    jc = jkv.init_paged_cache(jcfg, 5, 8, 8)
    jc = dict(jc, length=jnp.asarray(lengths0),
              last_token=jnp.asarray(last0))
    jc = jkv.sync_slots(jc, jnp.asarray(active), jnp.asarray(lengths),
                        jnp.asarray(tokens))
    tc = tkv.init_paged_cache(tcfg, 5, 8, 8, "cpu")
    tc["length"].copy_(torch.from_numpy(lengths0))
    tc["last_token"].copy_(torch.from_numpy(last0))
    k_before = tc["k"].clone()
    tkv.sync_slots(tc, torch.from_numpy(active), torch.from_numpy(lengths),
                   torch.from_numpy(tokens))
    assert tc["length"].dtype == torch.int32
    assert tc["last_token"].dtype == torch.long
    assert tc["length"].tolist() == np.asarray(jc["length"]).tolist()
    assert tc["last_token"].tolist() == \
        np.asarray(jc["last_token"]).tolist()
    assert torch.equal(tc["k"], k_before)


# -- DraftEngine: lockstep and rollback --------------------------------------

def _slot_rows(de, slot, rows):
    """A draft slot's first ``rows`` K/V rows (and scales on int8) in
    logical order, through its block table."""
    out = []
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in de.cache:
            continue
        arr = de.cache[name].float().numpy()     # bf16 scales: exact
        nb = -(-rows // de.kv_block)
        blocks = de.block_table[slot, :nb]
        if name in ("k", "v"):
            rs = arr[:, blocks].reshape(arr.shape[0], -1,
                                        *arr.shape[3:])[:, :rows]
        else:                     # scales: [L, nb, G, bl] -> [L, G, rows]
            rs = arr[:, blocks].transpose(0, 2, 1, 3).reshape(
                arr.shape[0], arr.shape[2], -1)[..., :rows]
        out.append(rs)
    return out


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_rejected_rollout_leaves_kv_bit_equal(distilled, kv_int8):
    """A draft round the verifier rejects in full (the correction token
    differs at position 0) leaves every committed row, and the slot's
    length and pending token, bit-equal to a drafter that never drafted:
    the rollback is a length that does not advance."""
    _, (_, tdp, tdc) = distilled
    ctx = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    de = _port_draft(tdp, tdc, slots=2, max_len=64, kv_int8=kv_int8)
    d = de.draft_batch({0: ctx}, 4)
    assert len(d[0]) == 4
    corr = (d[0][0] + 1) % tdc.vocab_size or 1
    ctx2 = ctx + [corr]
    st = de._state[0]
    fix = {}
    assert de._sync_slot(0, st, ctx2, fix) == []
    de._dispatch_sync(fix)
    assert st.toks == ctx2[:-1] and st.last == corr
    de2 = _port_draft(tdp, tdc, slots=2, max_len=64, kv_int8=kv_int8)
    st2 = de2._acquire(0)
    fix2 = {}
    de2._sync_slot(0, st2, ctx2, fix2)
    de2._dispatch_sync(fix2)
    rows = len(ctx2) - 1
    for a, b in zip(_slot_rows(de, 0, rows), _slot_rows(de2, 0, rows)):
        assert np.array_equal(a, b)
    for name in ("length", "last_token"):
        assert de.cache[name][0] == de2.cache[name][0]


def _reconcile_sequence(de):
    """The reference's predraft reconcile-and-reuse sequence on ``de``;
    returns every draft and the counters after each step."""
    seen = []
    ctx = [3, 1, 4, 1, 5, 9, 2, 6]
    d = de.draft_batch({0: ctx}, 3)[0]
    seen.append((d, de.stats()))
    assert de.rollout([0], 4)
    seen.append(de.stats())
    rolls0 = de.rollouts
    de._apply_pending()
    st = de._state[0]
    bonus = (st.toks + [st.last])[len(ctx) + 3]
    ctx_full = ctx + d + [bonus]
    d2 = de.draft_batch({0: ctx_full}, 3)[0]
    assert len(d2) == 3
    assert de.rollouts == rolls0             # no new rollout
    assert de.reuse_hits >= 1
    seen.append((d2, de.stats()))
    corr = (d2[0] + 1) % de.cfg.vocab_size or 1
    rb0 = de.rollbacks
    d3 = de.draft_batch({0: ctx_full + [corr]}, 3)[0]
    assert len(d3) == 3
    assert de.rollbacks > rb0
    assert de.rollouts == rolls0 + 1
    seen.append((d3, de.stats()))
    return seen


def test_predraft_reconcile_and_reuse_matches_jax(distilled):
    """A predraft whose chain matches the committed context serves the
    next round with no new device work (``reuse_hits``); a mispredicted
    one is dropped (``rollbacks``) and the round redrafts. Drafts and
    ``stats()`` equal the JAX ``DraftEngine``'s after every call."""
    (_, jdp, jdc), (_, tdp, tdc) = distilled
    with _jax_drafter_on_the_kernel():
        want = _reconcile_sequence(_jax_draft(jdp, jdc, slots=2,
                                              max_len=64))
    got = _reconcile_sequence(_port_draft(tdp, tdc, slots=2, max_len=64))
    assert got == want


def test_release_frees_blocks_and_reacquire_reingests(distilled):
    _, (_, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc, slots=2, max_len=64)
    de.draft_batch({0: [1, 2, 3, 4, 5]}, 2)
    assert de.blocks_used > 0 and de.claimed(0)
    de.release(0)
    assert de.blocks_used == 0 and not de.claimed(0)
    assert (de.block_table[0] == de.n_kv_blocks).all()
    ic0 = de.ingest_chunks
    d = de.draft_batch({0: [9, 8, 7, 6, 5, 4]}, 2)
    assert len(d[0]) == 2
    assert de.ingest_chunks > ic0


def test_rollout_of_a_released_slot_is_dropped(distilled):
    """A predraft whose slot is released before the fetch: its tokens
    are dropped (the slot has no state), the other slot's applied."""
    _, (_, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc, slots=2, max_len=64)
    de.draft_batch({0: [1, 2, 3, 4, 5], 1: [6, 7, 8]}, 2)
    n1 = len(de._state[1].toks)
    assert de.rollout([0, 1], 3)
    de.release(0)
    de._apply_pending()
    assert not de.claimed(0) and len(de._state[1].toks) == n1 + 3


# -- the engine: parity with the JAX engine and with spec-off ------------------

@pytest.fixture(scope="module")
def jax_runs(models, distilled, random_draft):
    """The JAX engine's runs, computed once each: name -> (requests,
    drafter counters or None)."""
    jcfg, _, jp, _ = models
    (jt, jdp, jdc), _ = distilled
    (jrp, jrc), _ = random_draft
    prompts = _prompts(jcfg.vocab_size)
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        kind, *rest = name
        with _jax_drafter_on_the_kernel():
            if kind == "off":
                (kv8,) = rest
                e = _jax_engine(jt, jcfg, spec_k=0, kv_int8=kv8)
                e.generate(prompts, max_new_tokens=24)
                cache[name] = (_requests(e), None)
            elif kind == "model":
                kv8, pipe = rest
                de = _jax_draft(jdp, jdc, kv_int8=kv8)
                e = _jax_engine(jt, jcfg, spec_k=4, draft_engine=de,
                                spec_pipeline=pipe, kv_int8=kv8)
                e.generate(prompts, max_new_tokens=24)
                cache[name] = (_requests(e), de.stats())
            elif kind == "random":
                de = _jax_draft(jrp, jrc)
                e = _jax_engine(jt, jcfg, spec_k=4, draft_engine=de,
                                spec_pipeline=True)
                e.generate(prompts, max_new_tokens=24)
                cache[name] = (_requests(e), de.stats())
        return cache[name]

    return run


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_model_draft_parity(models, distilled, jax_runs, kv_int8,
                            pipeline):
    """Greedy tokens with the model drafter, pipelined and synchronous,
    fp32 and int8 KV: the JAX engine's, which are its spec-off tokens;
    per-request spec counts and rungs, and the drafter's counters, equal
    to the JAX engine's and ``DraftEngine``'s."""
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc, kv_int8=kv_int8)
    e = _port_engine(tt, tcfg, spec_k=4, draft_engine=de,
                     spec_pipeline=pipeline, kv_int8=kv_int8)
    e.generate(_prompts(tcfg.vocab_size), max_new_tokens=24)
    want, want_stats = jax_runs(("model", kv_int8, pipeline))
    off, _ = jax_runs(("off", kv_int8))
    assert _requests(e) == want
    assert [r[0] for r in want] == [r[0] for r in off]
    assert de.stats() == want_stats
    port_off = _port_engine(tt, tcfg, spec_k=0, kv_int8=kv_int8)
    assert port_off.generate(_prompts(tcfg.vocab_size),
                             max_new_tokens=24) == [r[0] for r in off]


def test_model_draft_parity_low_acceptance(models, distilled, random_draft,
                                           jax_runs):
    """A random 1-layer draft (acceptance ~0, every round rolls back)
    still emits the spec-off tokens, with the JAX engine's per-request
    counts and rungs and its drafter's counters."""
    _, tcfg, _, _ = models
    _, (tt, _, _) = distilled
    _, (trp, trc) = random_draft
    de = _port_draft(trp, trc)
    e = _port_engine(tt, tcfg, spec_k=4, draft_engine=de,
                     spec_pipeline=True)
    e.generate(_prompts(tcfg.vocab_size), max_new_tokens=24)
    want, want_stats = jax_runs(("random",))
    off, _ = jax_runs(("off", False))
    assert _requests(e) == want
    assert [r[0] for r in want] == [r[0] for r in off]
    assert de.stats() == want_stats
    assert de.rollbacks > 0


def _adapter_weights(cfg, rank=4, seed=11):
    """The reference test's fine-tune: seeded normal A and B, x 0.05."""
    rng = np.random.default_rng(seed)
    aw = {}
    for t, (sa, sb) in jad.target_shapes(cfg, rank).items():
        sa = sa[:-1] + (rank,)
        sb = (rank,) + sb[1:]
        aw[t] = {"a": rng.normal(size=(cfg.n_layers,) + sa).astype(
                     np.float32) * 0.05,
                 "b": rng.normal(size=(cfg.n_layers,) + sb).astype(
                     np.float32) * 0.05}
    return aw


def test_model_draft_parity_with_adapters(models, distilled):
    """A mixed base/fine-tune batch under the model drafter emits the
    spec-off tokens, and the JAX engine's. The drafter drafts from the
    base draft model: the fine-tune shapes only the target's verify."""
    jcfg, tcfg, _, _ = models
    (jt, jdp, jdc), (tt, tdp, tdc) = distilled
    aw = _adapter_weights(jcfg)
    prompts = _prompts(jcfg.vocab_size)

    def run(side, spec_k, draft=False):
        if side == "jax":
            cat = jad.AdapterCatalog(jcfg, n_adapters=4, rank=4)
            cat.register("ft-0", params=aw)
            e = _jax_engine(jt, jcfg, spec_k=spec_k, adapters=cat,
                            draft_engine=(_jax_draft(jdp, jdc) if draft
                                          else None),
                            spec_pipeline=draft)
        else:
            cat = tad.AdapterCatalog(tcfg, n_adapters=4, rank=4,
                                     device="cpu")
            cat.register("ft-0", params=aw)
            e = _port_engine(tt, tcfg, spec_k=spec_k, adapters=cat,
                             draft_engine=(_port_draft(tdp, tdc) if draft
                                           else None),
                             spec_pipeline=draft)
        ids = [e.add_request(p, max_new_tokens=16,
                             adapter="ft-0" if i == 1 else None)
               for i, p in enumerate(prompts)]
        e.run_to_completion()
        by_rid = {r.rid: r for r in e.finished}
        return [(by_rid[i].tokens, by_rid[i].spec_drafted,
                 by_rid[i].spec_accepted) for i in ids]

    with _jax_drafter_on_the_kernel():
        want = run("jax", 4, draft=True)
    got = run("port", 4, draft=True)
    assert got == want
    off = run("port", 0)
    assert [g[0] for g in got] == [o[0] for o in off]
    # The fine-tune changed its request's tokens.
    base = _port_engine(tt, tcfg, spec_k=0).generate(
        [prompts[1]], max_new_tokens=16)[0]
    assert got[1][0] != base


def test_pipelined_equals_synchronous(models, distilled):
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    outs = []
    for pipeline in (True, False):
        de = _port_draft(tdp, tdc)
        e = _port_engine(tt, tcfg, spec_k=4, draft_engine=de,
                         spec_pipeline=pipeline)
        outs.append(e.generate(_prompts(tcfg.vocab_size),
                               max_new_tokens=16))
    assert outs[0] == outs[1]


def test_distilled_acceptance_and_reuse(models, distilled):
    """The distilled pair accepts (nearly) everything, the pipelined
    predraft serves rounds without new draft work, every request stays
    on the model rung, and the drafter's slots release with their
    requests."""
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc)
    e = _port_engine(tt, tcfg, spec_k=4, draft_engine=de,
                     spec_pipeline=True)
    e.generate(_prompts(tcfg.vocab_size), max_new_tokens=16)
    drafted = sum(r.spec_drafted for r in e.finished)
    accepted = sum(r.spec_accepted for r in e.finished)
    assert drafted > 0 and accepted / drafted > 0.9
    assert de.reuse_hits > 0
    assert all(r.spec_mode == "model" for r in e.finished)
    assert de.blocks_used == 0 and not de._state


def test_pipeline_overlap_structural(models, distilled):
    """The pipeline's structure, timing-free, read off the flight
    records as the reference's bench reads it: in pipelined mode every
    round drafts with the model and every verify record has a ``draft``
    record (the predraft) dispatched inside its window (after its verify
    calls were enqueued, done before its fetch) with its overlap
    attributed, and the overlap
    counter grew; in synchronous mode there is no ``draft`` record and
    no verify record carries an overlap."""
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    overlap = te.SPEC_OVERLAP_WALL.labels().value
    verify = te.SPEC_VERIFY_WALL.labels().value
    de = _port_draft(tdp, tdc)
    e = _port_engine(tt, tcfg, spec_k=4, draft_engine=de,
                     spec_pipeline=True,
                     flight_recorder=flight_lib.FlightRecorder())
    e.generate(_prompts(tcfg.vocab_size), max_new_tokens=16)
    recs = e.flight.tail()
    verifies = [r for r in recs if r["burst"] == "verify"]
    drafts = [r for r in recs if r["burst"] == "draft"]
    assert verifies and all(v["drafter"] == "model" for v in verifies)
    assert drafts
    for d in drafts:
        assert d["drafter"] == "model" and d["program"]["k"] == 5
    # Every round carries its predraft: each verify record (each part of
    # a round shares the round's begin and end) holds a draft record
    # between its last enqueue and its fetch.
    for v in verifies:
        assert v["overlap_ms"] > 0
        enqueued = v["ts_s"] + v["dispatch_wall_ms"] / 1e3
        fetched = v["ts_s"] + v["dur_s"]
        assert any(enqueued <= d["ts_s"] + 1e-6
                   and d["ts_s"] + d["dur_s"] <= fetched + 1e-6
                   for d in drafts)
    assert te.SPEC_OVERLAP_WALL.labels().value > overlap
    assert te.SPEC_VERIFY_WALL.labels().value > verify
    de2 = _port_draft(tdp, tdc)
    e2 = _port_engine(tt, tcfg, spec_k=4, draft_engine=de2,
                      spec_pipeline=False,
                      flight_recorder=flight_lib.FlightRecorder())
    e2.generate(_prompts(tcfg.vocab_size), max_new_tokens=16)
    recs2 = e2.flight.tail()
    assert any(r["burst"] == "verify" for r in recs2)
    assert not any(r["burst"] == "draft" for r in recs2)
    assert not any(r.get("overlap_ms") for r in recs2)


def test_draft_tokens_metric_by_drafter(models, distilled):
    _, tcfg, _, tp = models
    _, (tt, tdp, tdc) = distilled
    model = te.SPEC_DRAFT_TOKENS.labels(drafter="model")
    ngram = te.SPEC_DRAFT_TOKENS.labels(drafter="ngram")
    m0, n0 = model.value, ngram.value
    e = _port_engine(tt, tcfg, spec_k=4, draft_engine=_port_draft(tdp, tdc))
    e.generate(_prompts(tcfg.vocab_size), max_new_tokens=16)
    assert model.value - m0 == e._spec_drafted_total > 0
    assert ngram.value == n0


# -- the demotion ladder ---------------------------------------------------------

class _Wrong:
    """Factory drafter replaying a known continuation shifted by one:
    every position mismatches."""

    def __init__(self, out):
        self.out, self.seen = out, 0

    def catch_up(self, prompt, generated):
        self.seen = len(generated)

    def draft(self, k):
        return self.out[self.seen:self.seen + k]


def _ladder(make_engine, make_draft, params, cfg, prompts, oracle_out):
    wrong = {tuple(p): [(t + 1) % cfg.vocab_size for t in o]
             for p, o in zip(prompts, oracle_out)}
    de = make_draft()
    e = make_engine(params, cfg, spec_k=4, draft_engine=de,
                    spec_pipeline=True,
                    spec_drafter=lambda r: _Wrong(wrong[tuple(r.prompt)]))
    for p in prompts:
        e.add_request(p, max_new_tokens=32)
    e.admit()
    modes = []
    while e.slot_req:
        req = next(iter(e.slot_req.values()))
        modes.append(req.spec_mode)
        e.decode_burst(4)
    return e, de, modes


def test_collapse_demotes_model_to_ngram_to_off(models, random_draft):
    """The demotion chain, step for step as in the JAX engine: a random
    draft model's acceptance collapses, the request falls to the factory
    drafter (ngram) with its draft slot released; that rung collapses
    too (an always-wrong drafter) and speculation turns off. The output
    stays the greedy one throughout."""
    jcfg, tcfg, jp, tp = models
    (jrp, jrc), (trp, trc) = random_draft
    prompts = _prompts(tcfg.vocab_size, n=1)
    oracle = _port_engine(tp, tcfg, spec_k=0).generate(prompts,
                                                       max_new_tokens=32)
    with _jax_drafter_on_the_kernel():
        je_, _, jmodes = _ladder(_jax_engine,
                                 lambda: _jax_draft(jrp, jrc), jp, jcfg,
                                 prompts, oracle)
    e, de, modes = _ladder(_port_engine, lambda: _port_draft(trp, trc), tp,
                           tcfg, prompts, oracle)
    assert modes == jmodes
    assert set(modes) >= {"model", "ngram"}
    req = e.finished[0]
    assert req.spec_mode == "off" and req.spec_off
    assert [r.tokens for r in e.finished] == oracle
    assert _requests(e) == _requests(je_)
    assert de.blocks_used == 0


def test_no_draft_engine_keeps_ngram_ladder(models):
    _, tcfg, _, tp = models
    e = _port_engine(tp, tcfg, spec_k=2)
    e.generate(_prompts(tcfg.vocab_size, n=1), max_new_tokens=8)
    assert e.finished[0].spec_mode in ("ngram", None)
    assert e.draft_engine is None and not e.spec_pipeline


def test_spec_pipeline_env_knob(models, distilled, monkeypatch):
    _, tcfg, _, tp = models
    _, (tt, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc)
    monkeypatch.setenv("SKYTPU_SPEC_PIPELINE", "0")
    assert not _port_engine(tt, tcfg, spec_k=4,
                            draft_engine=de).spec_pipeline
    monkeypatch.delenv("SKYTPU_SPEC_PIPELINE")
    assert _port_engine(tt, tcfg, spec_k=4, draft_engine=de).spec_pipeline
    assert not _port_engine(tp, tcfg, spec_k=4,
                            spec_pipeline=True).spec_pipeline
    # Slot s of the drafter mirrors slot s of the engine.
    with pytest.raises(ValueError):
        _port_engine(tt, tcfg, spec_k=4, n_slots=2, draft_engine=de)


def test_engine_reset_resets_drafter(models, distilled):
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    de = _port_draft(tdp, tdc)
    e = _port_engine(tt, tcfg, spec_k=4, draft_engine=de)
    for p in _prompts(tcfg.vocab_size, n=2):
        e.add_request(p, max_new_tokens=32)
    e.admit()
    e.decode_burst(4)
    assert de.blocks_used > 0 and de.stats()["pending"] == 1
    e.reset()
    assert de.blocks_used == 0 and not de._state
    assert de.stats()["pending"] == 0
    assert int(de.cache["length"].abs().sum()) == 0


# -- port-only: preemption and an imported prefix under the model drafter -------

def _chunked(params, cfg, **kw):
    """Chunks of 8 and a prefix pool, blocks of 8, the reference's pool
    size ((slots + 1) rows of blocks, which a one-slot preemption needs
    to keep its victim's stored prefix)."""
    return _port_engine(params, cfg, **_kw(
        n_slots=2, max_len=64, prompt_buckets=(32,), kv_block=8,
        kv_blocks=3 * 8, prefill_chunk=8, prefix_pool=4, **kw))


def test_preemption_under_the_model_drafter(models, distilled):
    """A request preempted mid-decode under the model drafter resumes
    through the chunk path and finishes with its unpreempted tokens
    (the spec-off tokens); its draft slot was released at the eviction
    and re-ingests its context on resume, and the draft pool drains to
    0 when the engine does."""
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    prompts = [list(range(3, 15)), list(range(40, 52))]
    off = _chunked(tt, tcfg, spec_k=0).generate(prompts, max_new_tokens=40)
    de = _port_draft(tdp, tdc, slots=2, max_len=64, kv_block=8)
    e = _chunked(tt, tcfg, spec_k=4, draft_engine=de)
    ids = [e.add_request(p, max_new_tokens=40) for p in prompts]
    while len(e.slot_req) < 2 or e.chunking:
        e.step_burst(max_burst=4)
    (victim,) = [s for s, r in e.slot_req.items() if r.rid == ids[0]]
    while len(e.slot_req[victim].tokens) < 12:
        e.decode_burst(4)
    assert de.claimed(victim)
    ingested = de.ingest_chunks
    assert e.preempt_slot(victim)
    assert not de.claimed(victim)
    e.run_to_completion(max_burst=4)
    by_rid = {r.rid: r for r in e.finished}
    assert by_rid[ids[0]].preemptions == 1
    assert [by_rid[i].tokens for i in ids] == off
    assert de.ingest_chunks > ingested
    assert all(r.spec_mode == "model" and r.spec_drafted > 0
               for r in e.finished)
    assert de.blocks_used == 0 and not de._state


def test_imported_prefix_resume_drafts(models, distilled):
    """A handoff's decode tier with a model drafter: the request resumes
    over the imported blocks (``resumed_len`` 16), its draft slot
    ingests the whole context from zero, it drafts on the model rung,
    and its tokens are the single tier's."""
    _, tcfg, _, _ = models
    _, (tt, tdp, tdc) = distilled
    prompt = list(range(5, 25))
    single = _chunked(tt, tcfg, spec_k=0).generate([prompt],
                                                   max_new_tokens=12)[0]
    p = _chunked(tt, tcfg, spec_k=0)
    p.add_request(prompt, 1)
    p.run_to_completion()
    (req,) = p.finished
    export = p.export_prefix_for(req)
    de = _port_draft(tdp, tdc, slots=2, max_len=64, kv_block=8)
    d = _chunked(tt, tcfg, spec_k=4, draft_engine=de)
    committed = req.tokens
    assert d.import_prefix(prompt + committed, export) == 16
    d.add_request(prompt, 12, committed=committed)
    d.run_to_completion(max_burst=4)
    (got,) = d.finished
    assert got.resumed_len == 16
    assert got.tokens == single
    assert got.spec_mode == "model" and got.spec_drafted > 0
    assert de.ingest_chunks >= -(-(len(prompt) + 1 - 1) // de.ingest_chunk)
    assert de.blocks_used == 0
