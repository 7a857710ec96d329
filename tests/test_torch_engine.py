"""The port's serving engine against the JAX package's on the CPU:
greedy tokens of a pinned multi-prompt workload (kv_block 16, max_len
64, prefill_chunk 0, prefix_pool 0, spec_k 0, the paged-attention
kernel on in interpret mode), the JAX package's pinned chunked-prefill
workload (chunk 8), plus the engine's own contracts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

# Prompt lengths cross block boundaries (none block-aligned) and two
# buckets; more prompts than slots, so slots recycle mid-run and span
# regrouping sees several rungs.
_PROMPT_LENS = (5, 11, 3, 20, 30, 9, 17)
_BUCKETS = (16, 32)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in _PROMPT_LENS]


def _torch_engine(tp, tcfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", _BUCKETS)
    kw.setdefault("kv_block", 16)
    kw.setdefault("max_wave", 2)
    return te.InferenceEngine(tp, tcfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_tokens(models):
    jcfg, _, jp, _ = models
    e = je.InferenceEngine(jp, jcfg, n_slots=4, max_len=64,
                           prompt_buckets=_BUCKETS, kv_block=16,
                           prefill_chunk=0, prefix_pool=0, spec_k=0,
                           kv_kernel=True, max_wave=2)
    assert e.kv_kernel
    return e.generate(_prompts(jcfg.vocab_size), max_new_tokens=10)


# The JAX package's pinned chunked-prefill workload
# (tests/test_paged_attention.py): prompt lengths (5, 11, 3, 20), seed 1,
# chunk 8 (11 and 20 take 2 and 3 chunks, the last partial; 5 and 3 ride
# waves), kv_block 16, max_len 64, 4 slots, bucket 32.
_CHUNK_LENS = (5, 11, 3, 20)


def _chunk_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, n).tolist() for n in _CHUNK_LENS]


def _chunk_engine(tp, tcfg, **kw):
    return te.InferenceEngine(tp, tcfg, n_slots=4, max_len=64,
                              prompt_buckets=(32,), kv_block=16,
                              prefill_chunk=8, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_chunked(models):
    jcfg, _, jp, _ = models
    e = je.InferenceEngine(jp, jcfg, n_slots=4, max_len=64,
                           prompt_buckets=(32,), kv_block=16,
                           prefill_chunk=8, prefix_pool=0, spec_k=0,
                           kv_kernel=True)
    toks = e.generate(_chunk_prompts(jcfg.vocab_size), max_new_tokens=10)
    return toks, {r.rid: r.n_chunks for r in e.finished}


def test_greedy_tokens_match_jax_engine(models, jax_tokens):
    _, tcfg, _, tp = models
    e = _torch_engine(tp, tcfg)
    got = e.generate(_prompts(tcfg.vocab_size), max_new_tokens=10)
    assert got == jax_tokens
    assert all(len(t) == 10 for t in got)
    # Every block came back; every slot is free again.
    assert e.blocks_used() == 0 and sorted(e.free_slots) == [0, 1, 2, 3]


@pytest.mark.parametrize("kw", [
    {"span_buckets": 0}, {"max_wave": None}, {"n_slots": 2},
    {"plain_attention": True}],
    ids=["no-span-ladder", "uncapped-wave", "two-slots", "plain"])
def test_tokens_invariant_to_scheduling(models, jax_tokens, kw):
    """Span rungs, wave sizes, slot count and the attention path change
    the schedule, never the greedy tokens (fp32)."""
    _, tcfg, _, tp = models
    got = _torch_engine(tp, tcfg, **kw).generate(
        _prompts(tcfg.vocab_size), max_new_tokens=10)
    assert got == jax_tokens


def test_prompt_too_long_is_typed(models):
    _, tcfg, _, tp = models
    e = _torch_engine(tp, tcfg)
    with pytest.raises(te.PromptTooLongError) as ei:
        e.add_request(list(range(1, 40)))
    jerr = je.PromptTooLongError(39, 32)
    assert ei.value.typed_error == jerr.typed_error
    assert not e.waiting


def test_eos_and_budget_retire(models, jax_tokens):
    _, tcfg, _, tp = models
    eos = jax_tokens[0][3]
    e = _torch_engine(tp, tcfg, eos_id=eos)
    out = e.generate(_prompts(tcfg.vocab_size)[:1], max_new_tokens=10)[0]
    assert out == jax_tokens[0][:jax_tokens[0].index(eos) + 1]
    assert e.blocks_used() == 0


def test_dry_pool_stalls_admission_then_recovers(models, jax_tokens):
    """A pool too small for every slot admits what fits and the rest
    waits for retirements (eager reservation: decode never runs dry)."""
    _, tcfg, _, tp = models
    e = _torch_engine(tp, tcfg, kv_blocks=4)
    got = e.generate(_prompts(tcfg.vocab_size), max_new_tokens=10)
    assert got == jax_tokens


@pytest.mark.parametrize("kw", [{}, {"plain_attention": True}],
                         ids=["kernel", "plain"])
def test_chunked_prefill_matches_jax_engine(models, jax_chunked, kw):
    """Greedy fp32 tokens and every request's chunk count equal the JAX
    engine's on its pinned chunk workload."""
    _, tcfg, _, tp = models
    want, want_chunks = jax_chunked
    e = _chunk_engine(tp, tcfg, **kw)
    assert e.generate(_chunk_prompts(tcfg.vocab_size),
                      max_new_tokens=10) == want
    assert {r.rid: r.n_chunks for r in e.finished} == want_chunks
    assert sorted(want_chunks.values()) == [0, 0, 2, 3]
    assert e.blocks_used() == 0 and not e.chunking


def test_dry_pool_stalls_a_chunk_claim_then_recovers(models, jax_chunked,
                                                     monkeypatch):
    """Four blocks of 16 rows for requests that need 1, 2, 1 and 2: the
    20-token prompt's chunk claim finds the pool dry, goes back to the
    queue's head, and claims once a retirement frees blocks; its tokens
    and chunks are unchanged."""
    _, tcfg, _, tp = models
    want, want_chunks = jax_chunked
    e = _chunk_engine(tp, tcfg, kv_blocks=4)
    claims = []
    real = te.InferenceEngine._claim_chunked
    monkeypatch.setattr(te.InferenceEngine, "_claim_chunked",
                        lambda self, req: claims.append(
                            (req.rid, real(self, req))) or claims[-1][1])
    assert e.generate(_chunk_prompts(tcfg.vocab_size),
                      max_new_tokens=10) == want
    assert (3, "stall") in claims and claims[-1] == (3, "ok")
    assert {r.rid: r.n_chunks for r in e.finished} == want_chunks
    assert e.blocks_used() == 0


def test_chunk_state_clears_on_reset(models):
    _, tcfg, _, tp = models
    e = _chunk_engine(tp, tcfg)
    e.add_request(list(range(1, 21)), max_new_tokens=4)
    e.admit()
    assert len(e.chunking) == 1 and e.cache["length"][0] == 64
    assert e.prefill_chunk_step() and e.chunking[0].pos == 8
    e.reset()
    assert not e.chunking and e.blocks_used() == 0
    assert not e.prefill_chunk_step()


def test_span_ladder_and_bucket_helpers():
    assert te._span_ladder(None, 1024) == je._span_ladder(None, 1024)
    assert te._span_ladder(0, 64) == (64,)
    assert te._span_ladder([8, 100, 16], 64) == \
        je._span_ladder([8, 100, 16], 64)
    assert te._bucket(17, (16, 32)) == 32
    with pytest.raises(te.PromptTooLongError):
        te._bucket(33, (16, 32))


def test_sampling_temperature_distribution():
    from skypilot_tpu_torch.infer import sampling
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]]))
    gen = torch.Generator().manual_seed(0)
    sp = sampling.SamplingParams(temperature=1.0)
    draws = torch.stack([sampling.sample(logits, sp, gen)
                         for _ in range(4000)]).flatten()
    freq = torch.bincount(draws, minlength=4).float() / draws.numel()
    assert torch.allclose(freq, torch.tensor([0.1, 0.2, 0.3, 0.4]),
                          atol=0.03)
    topk = sampling.SamplingParams(temperature=1.0, top_k=2)
    draws = torch.stack([sampling.sample(logits, topk, gen)
                         for _ in range(200)])
    assert set(draws.flatten().tolist()) <= {2, 3}
    assert sampling.sample(logits, sampling.SamplingParams()).item() == 3


def test_no_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from skypilot_tpu_torch import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_an_unindexed_card_resolves_to_the_current_one(monkeypatch):
    """``"cuda"`` resolves to the current card's index, so an engine's
    device group compares equal to its tensors' devices; an index given
    stands, and the CPU stays unindexed."""
    from skypilot_tpu_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert resolve_device("cuda") == torch.device("cuda", 2)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 2)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


# (max_len, the JAX engine's block = the port's on the CPU, the port's
# on the card). The card's is the largest divisor no larger than 256
# that K1's wgmma multi-row body reads (8, 16, 32 or a multiple of 64);
# 1001 has none, so the JAX engine's block stands there.
_BLOCKS = [(1064, 152, 8), (872, 218, 8), (168, 168, 8), (1024, 256, 256),
           (1280, 256, 256), (96, 96, 32), (48, 48, 16), (1001, 143, 143)]


@pytest.mark.parametrize("max_len,cpu,card", _BLOCKS,
                         ids=[str(b[0]) for b in _BLOCKS])
def test_kv_block_len(models, max_len, cpu, card):
    jcfg, tcfg, jp, tp = models
    ref = je.InferenceEngine(jp, jcfg, n_slots=1, max_len=max_len,
                             prompt_buckets=(16,), kv_block=256)
    e = te.InferenceEngine(tp, tcfg, n_slots=1, max_len=max_len,
                           prompt_buckets=(16,), kv_block=256,
                           device="cpu")
    assert e.kv_block == ref.kv_block == cpu
    assert te.kv_block_len(max_len, 256, False) == cpu
    assert te.kv_block_len(max_len, 256, True) == card
    assert max_len % card == 0
