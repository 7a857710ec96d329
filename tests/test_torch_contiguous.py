"""The port's contiguous KV layout against the JAX package's on the CPU, in
float32 at llama3-tiny: ``kvcache.init_cache``, ``decode_step`` and
``commit_tokens`` (both layouts), the prefix pool (``init_prefix_pool``,
``pool_store``, ``pool_load``) and ``claim_slot``, the explicit drop of
rows at or past ``max_len`` (the trash slot), and the engine with
``kv_block=0``: greedy tokens equal to the JAX contiguous engine's on the
workloads of ``tests/test_paged_kv.py::_pair``, ``test_prefix_cache.py``,
``test_span_attn.py::test_span_parity_matrix[contig-*]``,
``test_spec_decode.py::test_spec_parity_layouts_and_dtypes[contiguous-*]``
and ``test_adapters.py``'s ``kv_block=0`` solo engine; the paged twin's
tokens; ``step()``/``step_decode_once``; the paged-only features answered
as the reference's; recovery, warm-up, the drafter and the server.

Both contiguous engines read the big cache through the gather, so their
tokens are compared exactly. The port's paged engine reads through K1,
whose float32 value product parts from the gather's bfloat16-rounded
weights by ~4e-3 of the logits' max: the paged twin's tokens agree
wherever the plain top-2 gap exceeds 1e-2 (``PERF.md`` §2).
"""

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
from skypilot_tpu.infer import draft as jd
from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import adapters as tad
from skypilot_tpu_torch.infer import draft as td
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import qos as tq
from skypilot_tpu_torch.infer import sampling as tsamp
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import flight as flight_lib

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

# Logits and rows of the port's programs against the JAX programs on the
# same inputs: float32 summation-order noise.
RTOL = 1e-5
# The plain top-2 gap below which the kernel and the gather may part.
GAP = 1e-2


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _first_gap(params, cfg, prompt, got, want):
    """(step, the plain path's top-2 logit gap there) at the first step
    where ``got`` and ``want`` part, or None where they agree."""
    t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if t is None:
        return None
    ctx = list(prompt) + list(want[:t])
    _, logits = tkv.prefill_batch(params, torch.tensor([ctx]),
                                  torch.tensor([len(ctx)]), cfg,
                                  plain_attention=True)
    top = logits[0].topk(2).values
    return t, (top[0] - top[1]).item()


def _assert_gap_rule(params, cfg, prompts, got, want):
    for p, g, w in zip(prompts, got, want):
        assert len(g) == len(w)
        part = _first_gap(params, cfg, p, g, w)
        assert part is None or part[1] <= GAP, (part, g, w)


# -- the contiguous cache -----------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_init_cache_matches_reference(models, kv_int8):
    """The reference's arrays with one more slot (the trash slot), the
    same dtypes, all zero; ``length``/``last_token`` cover the served
    slots only."""
    jcfg, tcfg, _, _ = models
    jc = jkv.init_cache(jcfg, 3, 32, kv_int8=kv_int8)
    tc = tkv.init_cache(tcfg, 3, 32, kv_int8=kv_int8, device="cpu")
    assert set(tc) == set(jc)
    for name, want in jc.items():
        got = tc[name]
        shape = list(want.shape)
        if name not in ("length", "last_token"):
            shape[1] += 1                              # the trash slot
        assert list(got.shape) == shape, name
        assert str(got.dtype).removeprefix("torch.") == (
            {"int32": "int32"}.get(str(want.dtype), str(want.dtype))
            if name != "last_token" else "int64"), name
        assert not got.any()
    assert tc["k"].shape == (tcfg.n_layers, 4, 32, tcfg.n_kv_heads,
                             tcfg.head_dim)


def _filled(models, kv_int8, paged):
    """JAX and port caches (3 slots, max_len 32) holding three prefilled
    prompts of 5, 9 and 2 tokens, pending tokens 7, 8, 9. Paged: blocks
    of 8, each slot its own 4 blocks (the table returned too)."""
    jcfg, tcfg, jp, _ = models
    S, ML, BL = 3, 32, 8
    if paged:
        nb = ML // BL
        table = np.full((S, nb + 1), S * nb, np.int32)
        for s in range(S):
            table[s, :nb] = np.arange(nb) + s * nb
        jc = jkv.init_paged_cache(jcfg, S, S * nb, BL, kv_int8=kv_int8)
        tc = tkv.init_paged_cache(tcfg, S, S * nb, BL, "cpu",
                                  kv_int8=kv_int8)
        jt, tt = jnp.asarray(table), torch.from_numpy(table)
    else:
        jc = jkv.init_cache(jcfg, S, ML, kv_int8=kv_int8)
        tc = tkv.init_cache(tcfg, S, ML, kv_int8=kv_int8, device="cpu")
        jt = tt = None
    rng = np.random.default_rng(0)
    for slot, n in enumerate((5, 9, 2)):
        toks = rng.integers(1, jcfg.vocab_size, 16)
        pref, _ = jkv.prefill(jp, jnp.asarray(toks, jnp.int32),
                              jnp.int32(n), jcfg)
        jc = jkv.insert(jc, pref, jnp.int32(slot), jnp.int32(n),
                        jnp.int32(7 + slot), table=jt)
        tkv.insert(tc, {"k": torch.from_numpy(np.array(pref["k"])),
                        "v": torch.from_numpy(np.array(pref["v"]))},
                   slot, n, 7 + slot, tt)
    return jc, tc, jt, tt


def _assert_rows_equal(jc, tc, n_slots, rtol=RTOL):
    """The caches' rows and scales: float rows within ``rtol`` of their
    max (float32 noise by default), int8 rows off by one step on at most
    1 in 1000 values, scales within one bf16 ulp
    (``tests/test_torch_quant.py``'s rule)."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in jc:
            continue
        want = _np(jc[name])
        got = _np(tc[name][:, :n_slots] if want.shape[1] == n_slots
                  else tc[name][:, :want.shape[1]])
        if name in ("k", "v") and tc[name].dtype == torch.int8:
            diff = np.abs(got - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=rtol * np.abs(want).max())
    np.testing.assert_array_equal(_np(tc["length"]), _np(jc["length"]))


def _jax_decode_kernel_read(jp, jc, jcfg, table):
    """The reference's ``decode_step`` with its big-cache read through its
    Pallas paged kernel (interpret mode on the CPU) merged with the
    self-term by its online-softmax combine: the port's paged
    ``decode_step``, composed from the reference's own pieces. Returns
    (logits, the pending K rows [L, B, G, hd] as stored)."""
    B = jc["length"].shape[0]
    G, hd = jcfg.n_kv_heads, jcfg.head_dim
    rep = jcfg.n_heads // G
    scale = hd ** -0.5
    quant = "k_scale" in jc
    pos = jc["length"]
    x = jp["embed"].astype(jcfg.dtype)[jc["last_token"][:, None]]
    cos, sin = jl.rope_frequencies(jcfg, pos[:, None])
    rows = []
    for i in range(jcfg.n_layers):
        layer = jax.tree.map(lambda w: w[i], jp["blocks"])
        q, k, v = jkv._decode_qkv(jcfg, layer, None, x, cos, sin)
        if quant:
            kq, ks = jkv.quantize_rows(k[:, 0])
            vq, vs = jkv.quantize_rows(v[:, 0])
            ks, vs = ks.astype(jnp.bfloat16), vs.astype(jnp.bfloat16)
            k_new = kq.astype(jnp.bfloat16)
            v_new = vq.astype(jnp.float32) * vs.astype(jnp.float32)[..., None]
            rows.append(kq)
        else:
            k_new = k[:, 0].astype(jnp.bfloat16)
            v_new = v[:, 0].astype(jnp.float32)
            rows.append(k[:, 0])
        qh = q[:, 0].reshape(B, G, rep, hd).astype(jnp.bfloat16)
        s_self = jnp.einsum("bgrk,bgk->bgr", qh, k_new,
                            preferred_element_type=jnp.float32) * scale
        if quant:
            s_self = s_self * ks.astype(jnp.float32)[:, :, None]
        acc, m, l = jkv._paged_attn_stats(jc, jnp.int32(i), table, qh, pos,
                                          None)
        alpha, w_s, l_tot = jkv._merge_attn_parts(acc, m, l,
                                                  s_self[..., None])
        o = (acc * alpha[..., None]
             + w_s * v_new[:, :, None, :]) / l_tot[..., None]
        x = jkv._decode_out_ffn(jcfg, layer, None, False, x, o)
    return jkv._decode_head(jcfg, jp, None, x), jnp.stack(rows)


@pytest.mark.parametrize("span", [None, 16], ids=["full", "span16"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_decode_step_contiguous_matches_reference(models, kv_int8, span):
    """Three single steps with commits between (one slot inactive after
    the first): logits within 1e-5 of the reference's max at every step,
    and the pending rows written equal."""
    jcfg, tcfg, jp, tp = models
    jc, tc, _, _ = _filled(models, kv_int8, paged=False)
    for step in range(3):
        jc, jlog = jkv.decode_step(jp, jc, jcfg, span=span)
        tlog = tkv.decode_step(tp, tc, tcfg, None, span=span)
        want = _np(jlog)
        np.testing.assert_allclose(_np(tlog), want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
        _assert_rows_equal(jc, tc, 3)
        toks = jnp.argmax(jlog, -1).astype(jnp.int32)
        act = np.array([True, True, step == 0])
        jc = jkv.commit_tokens(jc, toks, jnp.asarray(act))
        tkv.commit_tokens(tc, torch.from_numpy(np.array(toks)).long(),
                          torch.from_numpy(act))
        np.testing.assert_array_equal(_np(tc["last_token"]),
                                      _np(jc["last_token"]))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_decode_step_paged_matches_reference(models, kv_int8):
    """On a paged cache the big-cache read is K1 (its plain version on
    the CPU): logits within 1e-5 of the reference's kernel read merged
    with the self-term, within 1e-2 of its gather ``decode_step`` (which
    rounds the weights to bf16 before the value product), and the
    pending rows written through the table equal."""
    jcfg, tcfg, jp, tp = models
    jc, tc, jt, tt = _filled(models, kv_int8, paged=True)
    kern, krows = _jax_decode_kernel_read(jp, jc, jcfg, jt)
    kern, krows = _np(kern), _np(krows)
    pos = tc["length"].tolist()
    _, jlog = jkv.decode_step(jp, jc, jcfg, table=jt)
    tlog = _np(tkv.decode_step(tp, tc, tcfg, tt))
    np.testing.assert_allclose(tlog, kern, rtol=0,
                               atol=RTOL * np.abs(kern).max())
    gather = _np(jlog)
    assert np.abs(tlog - gather).max() <= GAP * np.abs(gather).max()
    # The pending rows landed through the table at each slot's length.
    got = np.stack([_np(tc["k"][:, tt[b, p // 8], p % 8])
                    for b, p in enumerate(pos)], axis=1)
    if kv_int8:
        assert np.abs(got - krows).max() <= 1
    else:
        np.testing.assert_allclose(got, krows, rtol=0,
                                   atol=RTOL * np.abs(krows).max())


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_pool_store_load_and_claim_match_reference(models, kv_int8):
    """``pool_store`` (slot 1 -> row 0), ``pool_load`` (row 0 -> slot 2,
    claimed at max_len) and ``claim_slot`` (slot 0) leave the reference's
    pool rows, cache rows and lengths."""
    jcfg, tcfg, _, _ = models
    jc, tc, _, _ = _filled(models, kv_int8, paged=False)
    jpool = jkv.init_prefix_pool(jcfg, 2, 32, kv_int8=kv_int8)
    tpool = tkv.init_prefix_pool(tcfg, 2, 32, kv_int8=kv_int8,
                                 device="cpu")
    assert {n: tuple(v.shape) for n, v in tpool.items()} == {
        n: tuple(v.shape) for n, v in jpool.items()}
    jpool = jkv.pool_store(jpool, jc, jnp.int32(1), jnp.int32(0))
    tkv.pool_store(tpool, tc, 1, 0)
    for name in jpool:
        np.testing.assert_array_equal(_np(tpool[name]), _np(jpool[name]))
    jc = jkv.pool_load(jc, jpool, jnp.int32(0), jnp.int32(2), jnp.int32(32))
    tkv.pool_load(tc, tpool, 0, 2, 32)
    jc = jkv.claim_slot(jc, jnp.int32(0), jnp.int32(32))
    tkv.claim_slot(tc, 0, 32)
    _assert_rows_equal(jc, tc, 3)
    assert tc["length"].tolist() == [32, 9, 32]


def test_claimed_slot_keeps_its_rows_through_interleaved_bursts(models):
    """The explicit drop: a slot claimed at ``length = max_len`` keeps the
    rows its chunks wrote while bursts for the other slots write a row
    at every slot's length; those writes, and a verify window running
    past max_len, land in the trash slot. The reference drops them.
    Rows past the first layer come from the gather's bf16-rounded
    weights, where a float32 ulp of the softmax can move a weight by one
    bf16 ulp: they are held within one bf16 ulp (2^-8) of their max."""
    jcfg, tcfg, jp, tp = models
    jc, tc, _, _ = _filled(models, False, paged=False)
    jc = jkv.claim_slot(jc, jnp.int32(2), jnp.int32(32))
    tkv.claim_slot(tc, 2, 32)
    chunk = np.arange(1, 9)
    jc, _, _ = jkv.prefill_chunk(
        jp, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(0), jnp.int32(8),
        jnp.int32(2), jnp.int32(32), jax.random.key(0), jcfg,
        jsamp_params(), final=False)
    tkv.prefill_chunk(tp, tc, torch.from_numpy(chunk), 0, 8, 2, 32, tcfg,
                      tsamp.SamplingParams(), None, final=False)
    rows = tc["k"][:, 2].clone()
    active = np.array([True, True, False])
    jc, _, jtoks = jkv.decode_burst_staged(
        jp, jc, jax.random.key(1), jnp.asarray(active), 4, jcfg,
        jsamp_params())
    ttoks = tkv.decode_burst_staged(tp, tc, torch.from_numpy(active), 4,
                                    tcfg, tsamp.SamplingParams(), None)
    assert torch.equal(tc["k"][:, 2], rows)
    assert tc["k"][:, 3].abs().sum() > 0          # the trash slot took them
    np.testing.assert_array_equal(ttoks.numpy()[:, :2],
                                  np.asarray(jtoks)[:, :2])
    _assert_rows_equal(jc, tc, 3, rtol=2 ** -8)
    # Slot 1 within K rows of max_len: its verify window runs past it.
    jc = jkv.sync_slots(jc, jnp.asarray([False, True, False]),
                        jnp.asarray([30, 30, 30]), jnp.asarray([5, 5, 5]))
    tkv.sync_slots(tc, torch.tensor([False, True, False]),
                   torch.tensor([30, 30, 30]), torch.tensor([5, 5, 5]))
    draft = np.array([[1, 2, 3]] * 3)
    n_draft = np.array([0, 3, 0])
    jc, jv, jn = jkv.verify_draft_staged(
        jp, jc, jnp.asarray(draft, jnp.int32), jnp.asarray(n_draft,
                                                            jnp.int32),
        jnp.asarray(active), 3, jcfg)
    tv, tn = tkv.verify_draft_staged(
        tp, tc, torch.from_numpy(draft), torch.from_numpy(n_draft),
        torch.from_numpy(active), 3, tcfg, None)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tv[:2].tolist() == np.asarray(jv)[:2].tolist()
    assert torch.equal(tc["k"][:, 2], rows)
    _assert_rows_equal(jc, tc, 3, rtol=2 ** -8)


def jsamp_params():
    from skypilot_tpu.infer import sampling as js
    return js.SamplingParams()


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_prefill_chunk_contiguous_matches_reference(models, kv_int8):
    """A 20-token prompt in chunks of 8 into slot 1 (the last chunk
    partial, its window past row 20), read through the gather at the
    span rung of each offset: the first token equal, and every row
    within one bf16 ulp of its max (rows past the first layer come from
    the gather's bf16-rounded weights)."""
    jcfg, tcfg, jp, tp = models
    jc, tc, _, _ = _filled(models, kv_int8, paged=False)
    prompt = np.random.default_rng(5).integers(1, jcfg.vocab_size, 20)
    rng = jax.random.key(3)
    for start in (0, 8, 16):
        n = min(8, 20 - start)
        final = start + n >= 20
        chunk = np.zeros(8, np.int64)
        chunk[:n] = prompt[start:start + n]
        span = 16 if start <= 16 else None
        new_len = 20 if final else 32
        jc, rng, jtok = jkv.prefill_chunk(
            jp, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(start),
            jnp.int32(n), jnp.int32(1), jnp.int32(new_len), rng, jcfg,
            jsamp_params(), final=final, span=span)
        ttok = tkv.prefill_chunk(
            tp, tc, torch.from_numpy(chunk), start, n, 1, new_len, tcfg,
            tsamp.SamplingParams(), None, final=final, span=span)
        assert int(ttok) == int(jtok)
        _assert_rows_equal(jc, tc, 3, rtol=2 ** -8)


# -- the engine ---------------------------------------------------------------

def _mixed_prompts(vocab, lengths=(5, 12, 30, 9), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def _spec_prompts(vocab, n=3, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).tolist() for _ in range(n)]


PAIR = dict(n_slots=4, max_len=64, prompt_buckets=(16, 48),
            prefill_chunk=8, prefix_pool=4)
PAIR_PROMPTS = [[3, 17, 42, 7, 99], list(range(1, 29)), [5, 9, 31],
                list(range(40, 60))]
INT8_PROMPTS = [list(range(1, 25)), [3, 1, 4], list(range(30, 48))]
SPAN = dict(n_slots=4, max_len=64, prompt_buckets=(16, 32),
            prefill_chunk=8, prefix_pool=2)
SPEC = dict(n_slots=4, max_len=128, prompt_buckets=(32,))

# (engine knobs, prompts (None: the span or spec workload), new tokens)
WORKLOADS = {
    "pair-fp32": (dict(PAIR), PAIR_PROMPTS, 6),
    "pair-int8": (dict(PAIR, kv_int8=True), INT8_PROMPTS, 8),
    "span-fp32-spec-off": (dict(SPAN), "span", 20),
    "span-fp32-spec-on": (dict(SPAN, spec_k=3), "span", 20),
    "span-int8-spec-off": (dict(SPAN, kv_int8=True), "span", 20),
    "span-int8-spec-on": (dict(SPAN, kv_int8=True, spec_k=3), "span", 20),
    "spec-fp32": (dict(SPEC, spec_k=4), "spec", 24),
    "spec-int8": (dict(SPEC, spec_k=4, kv_int8=True), "spec", 24),
}


def _workload(name, vocab):
    kw, prompts, new = WORKLOADS[name]
    if prompts == "span":
        prompts = _mixed_prompts(vocab)
    elif prompts == "spec":
        prompts = _spec_prompts(vocab)
    return dict(kw), prompts, new


def _port(tp, tcfg, **kw):
    return te.InferenceEngine(tp, tcfg, device="cpu", **kw)


def _jax(jp, jcfg, **kw):
    kw.setdefault("prefix_pool", 0)
    kw.setdefault("spec_k", 0)
    return je.InferenceEngine(jp, jcfg, **kw)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_contiguous_engine_matches_jax_contiguous(models, name):
    """The reference tests' workloads on ``kv_block=0``: the port's
    greedy tokens equal the JAX contiguous engine's, and (span rows)
    span-on equals the full view with some burst reading fewer than
    max_len rows, (spec rows) spec-on equals spec-off."""
    jcfg, tcfg, jp, tp = models
    kw, prompts, new = _workload(name, jcfg.vocab_size)
    want = _jax(jp, jcfg, kv_block=0, **kw).generate(prompts, new)
    e = _port(tp, tcfg, kv_block=0, **kw)
    assert not e.paged and e.block_table is None
    got = e.generate(prompts, new)
    assert got == want
    assert e.blocks_used() == 0 and sorted(e.free_slots) == [0, 1, 2, 3]
    if name.startswith("span"):
        spans = [s for kind, *_, s in e.decode_programs
                 if kind in ("burst", "verify") and s is not None]
        assert spans and min(spans) < e.max_len
        full = _port(tp, tcfg, kv_block=0, span_buckets=0, **kw)
        assert full.generate(prompts, new) == got
    if name.startswith("spec"):
        off = dict(kw, spec_k=0)
        assert _port(tp, tcfg, kv_block=0, **off).generate(
            prompts, new) == got
        assert e.verify_calls > 0


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_prefix_hit_warm_equals_cold_and_jax(models, kv_int8):
    """The prefix cache on the contiguous layout (``test_paged_kv.py``'s
    warm/cold workload, ``test_prefix_cache.py``'s guarantee): a hit
    loads the pool row and prefills the suffix alone (``cached_len`` 16,
    one chunk), and its tokens equal the cold run's and the JAX
    engine's. A pool of one row evicts LRU."""
    jcfg, tcfg, jp, tp = models
    system = list(range(5, 21))
    pa, pb = system + [31, 32, 33, 34], system + [41, 42, 43]
    kw = dict(PAIR, kv_block=0, kv_int8=kv_int8)
    e = _port(tp, tcfg, **kw)
    j = _jax(jp, jcfg, **kw)
    assert e.generate([pa], 6) == j.generate([pa], 6)
    e.finished.clear()
    j.finished.clear()
    warm = e.generate([pb], 6)[0]
    (req,) = e.finished
    assert (req.cached_len, req.n_chunks) == (16, 1)
    assert warm == j.generate([pb], 6)[0]
    assert j.finished[0].cached_len == 16
    e.finished.clear()
    e.clear_prefix_cache()
    assert e.generate([pb], 6)[0] == warm
    assert e.finished[0].cached_len == 0
    # One pool row: a second prefix evicts the first.
    one = _port(tp, tcfg, **dict(kw, prefix_pool=1))
    one.generate([pa, list(range(60, 80))], 4)
    assert one.prefix_evictions >= 1
    assert len(one._prefix_index.payloads()) == 1


def test_adapter_solo_engine_matches_jax(models):
    """``test_adapters.py``'s ``kv_block=0`` solo engine: one slot, a
    fine-tune from the catalog, the tokens of the JAX engine."""
    jcfg, tcfg, jp, tp = models
    rank = 4

    def mk(seed):
        r = np.random.default_rng(seed)
        out = {}
        for t, (sa, sb) in tad.target_shapes(tcfg, rank).items():
            out[t] = {"a": r.normal(size=(tcfg.n_layers,) + sa).astype(
                np.float32) * 0.05,
                      "b": r.normal(size=(tcfg.n_layers,) + sb).astype(
                np.float32) * 0.05}
        return out

    tcat = tad.AdapterCatalog(tcfg, n_adapters=4, rank=rank, device="cpu")
    jcat = jad.AdapterCatalog(jcfg, n_adapters=4, rank=rank)
    for i in range(3):
        tcat.register(f"ft-{i}", params=mk(100 + i))
        jcat.register(f"ft-{i}", params=mk(100 + i))
    kw = dict(n_slots=1, max_len=64, prompt_buckets=(16,), kv_block=0,
              prefill_chunk=0)
    prompt = [3, 17, 42]
    out = []
    for e in (_port(tp, tcfg, adapters=tcat, **kw),
              _jax(jp, jcfg, adapters=jcat, **kw)):
        rid = e.add_request(prompt, 5, adapter="ft-0")
        e.run_to_completion()
        out.append([r.tokens for r in e.finished if r.rid == rid][0])
    assert out[0] == out[1]
    base = _port(tp, tcfg, **kw).generate([prompt], 5)[0]
    assert out[0] != base


@pytest.mark.parametrize("name", ["pair-fp32", "pair-int8",
                                  "span-fp32-spec-on", "spec-fp32"])
def test_paged_twin_agrees_with_contiguous(models, name):
    """The reference's acceptance bar, across read paths: the port's paged
    engine (K1) and its contiguous twin (the gather) give the same greedy
    tokens wherever the plain top-2 gap exceeds 1e-2 (int8: the gap on
    the float32 model, as the plain path reads it)."""
    jcfg, tcfg, _, tp = models
    kw, prompts, new = _workload(name, jcfg.vocab_size)
    paged = _port(tp, tcfg, kv_block=8, **kw).generate(prompts, new)
    contig = _port(tp, tcfg, kv_block=0, **kw).generate(prompts, new)
    _assert_gap_rule(tp, tcfg, prompts, paged, contig)


@pytest.mark.parametrize("kv_block", [0, 8], ids=["contig", "paged"])
def test_step_matches_the_burst_path(models, kv_block):
    """``step()`` (admission with every chunk drained, then one token a
    slot) gives the burst path's tokens, dispatches program key
    ``decode1[span=...]`` and records ``("decode1", 1, span)`` and a
    ``decode1`` flight record; on the contiguous layout the JAX engine's
    ``step()`` gives the same tokens."""
    jcfg, tcfg, jp, tp = models
    prompts = PAIR_PROMPTS
    kw = dict(PAIR, kv_block=kv_block)
    rec = flight_lib.FlightRecorder()
    e = _port(tp, tcfg, flight_recorder=rec, **kw)
    for p in prompts:
        e.add_request(p, 6)
    while e.waiting or e.chunking or e.slot_req:
        e.step()
    got = [r.tokens for r in sorted(e.finished, key=lambda r: r.rid)]
    burst = _port(tp, tcfg, **kw).generate(prompts, 6)
    _assert_gap_rule(tp, tcfg, prompts, got, burst)
    assert any(k[0] == "decode1" and k[1] == 1 for k in e.decode_programs)
    assert any(k.startswith("decode1[span=")
               for k in e.compile_watch.summary())
    recs = [r for r in rec.tail() if r["burst"] == "decode1"]
    assert recs and all(r["program"]["layout"] == e._layout
                        and r["program"]["k"] == 1 for r in recs)
    assert e.step_decode_once() == {}
    if kv_block == 0:
        j = _jax(jp, jcfg, **kw)
        for p in prompts:
            j.add_request(p, 6)
        while j.waiting or j.chunking or j.slot_req:
            j.step()
        assert got == [r.tokens
                       for r in sorted(j.finished, key=lambda r: r.rid)]


def test_step_decode_once_raises_when_the_lazy_pool_is_wedged(models):
    """A lazy paged engine whose every active slot needs a block the pool
    cannot give: the single step raises the typed wedge instead of
    spinning (the reference's rule)."""
    _, tcfg, _, tp = models
    e = _port(tp, tcfg, n_slots=2, max_len=64, prompt_buckets=(16,),
              kv_block=8, kv_blocks=8, kv_lazy=True, prefill_chunk=0)
    e.add_request([1, 2, 3, 4, 5, 6, 7], 40)
    e.add_request([9, 8, 7, 6, 5, 4, 3], 40)
    e.admit()
    with pytest.raises(te.EngineDispatchError) as exc:
        for _ in range(40):
            e.step_decode_once()
    assert isinstance(exc.value.cause, te.KvPoolWedgedError)


def test_contiguous_answers_the_paged_only_features(models, capsys):
    """As the reference's: ``kv_lazy`` dropped, ``kv_kernel`` answered by
    the typed ``engine.kv_kernel_fallback`` event, no KV quota, no
    blocks, no handoff export (None) or import (0), flight records and
    program keys of layout ``contig`` with the gather's attention."""
    _, tcfg, _, tp = models
    qos = tq.FairScheduler(tq.QosConfig(
        enabled=True, tenants={"free": tq.TenantSpec(max_kv_blocks=1)}))
    rec = flight_lib.FlightRecorder()
    e = _port(tp, tcfg, kv_block=0, kv_lazy=True, kv_kernel=True, qos=qos,
              flight_recorder=rec, **PAIR)
    err = capsys.readouterr().err
    ev = [json.loads(line) for line in err.splitlines()
          if "kv_kernel_fallback" in line]
    assert ev and ev[0]["attrs"] == {"reason": "contiguous_layout"}
    assert not e.kv_lazy and e._kernel is False
    assert e.kv_block is None and e.n_kv_blocks == 0
    assert e.table_device() is None
    e.check_kv_quota("free", 30, 30)        # no quota on this layout
    prompt = list(range(1, 29))
    assert not e.handoff_eligible(prompt, 4)
    rid = e.add_request(prompt, 4, tenant="free")
    e.run_to_completion()
    req = [r for r in e.finished if r.rid == rid][0]
    assert len(req.tokens) == 4 and e.blocks_used() == 0
    assert e.export_prefix_for(req) is None
    paged = _port(tp, tcfg, kv_block=8, **PAIR)
    paged.generate([prompt], 2)
    export = paged.export_prefix_for(paged.finished[0])
    assert export is not None
    assert e.import_prefix(prompt + [1], export) == 0
    layouts = {r["program"].get("layout") for r in rec.tail()}
    assert layouts == {"contig"}
    attn = {r["program"].get("attn") for r in rec.tail()
            if r["burst"] in ("decode", "verify", "chunk")}
    assert attn == {"gather"}
    paged_ev = _port(tp, tcfg, kv_block=8, kv_kernel=True, **PAIR)
    assert "kv_kernel_fallback" not in capsys.readouterr().err
    assert paged_ev._kernel


def test_recover_rebuilds_the_contiguous_engine(models):
    """``recover()`` mid-flight (residents, a chunking request, the
    queue) re-admits every victim through the resume path on the
    contiguous cache and pool: the tokens equal an uninterrupted run's
    (or part only at a near-tie)."""
    jcfg, tcfg, _, tp = models
    prompts = [list(range(1, 21)), list(range(30, 47)), [5, 9, 31, 4],
               list(range(60, 90))]
    kw = dict(PAIR, kv_block=0, n_slots=2)
    want = _port(tp, tcfg, **kw).generate(prompts, 10)
    e = _port(tp, tcfg, **kw)
    ids = [e.add_request(p, 10) for p in prompts]
    for _ in range(3):
        e.step_burst(4)
    assert e.slot_req or e.chunking
    assert e.recover() > 0
    assert not e._prefix_index.payloads()
    e.run_to_completion()
    by = {r.rid: r.tokens for r in e.finished}
    _assert_gap_rule(tp, tcfg, prompts, [by[i] for i in ids], want)
    assert sum(r.recoveries for r in e.finished) > 0


def test_warm_programs_on_the_contiguous_engine(models):
    """``warm_programs`` dispatches the grid (``decode1``, the pool's load
    and store, no block programs) against a free slot, leaves a resident
    prefix row as it was, and a warmed engine serves with no unexpected
    compile and the cold engine's tokens."""
    jcfg, tcfg, _, tp = models
    system = list(range(5, 21))
    kw = dict(PAIR, kv_block=0)
    e = _port(tp, tcfg, **kw)
    e.generate([system + [1, 2]], 3)
    row = {n: v.clone() for n, v in e.pool.items()}
    n = e.warm_programs(max_burst=8)
    keys = set(e.compile_watch.summary())
    assert n > 0 and {"pool_load", "pool_store", "claim"} <= keys
    assert not any(k.startswith(("copy_block", "export_blocks",
                                 "import_blocks")) for k in keys)
    assert any(k.startswith("decode1") for k in keys)
    for name, v in row.items():
        assert torch.equal(e.pool[name], v)
    e.declare_warmup_complete()
    prompts = [system + [7, 8, 9], [3, 1, 4, 1, 5], list(range(40, 60))]
    got = e.generate(prompts, 6)
    assert not e.compile_watch.unexpected
    assert got == _port(tp, tcfg, **kw).generate(prompts, 6)


def test_draft_engine_contiguous_matches_reference(models):
    """``DraftEngine(kv_block=0)`` behind a contiguous target: the JAX
    and port drafters read their caches through the gather, so tokens,
    spec counts and the drafter's counters are equal; spec-on equals
    spec-off."""
    jcfg, tcfg, jp, tp = models
    jt, jdp, jdc = jd.self_distilled_pair(jp, jcfg, 1)
    tt, tdp, tdc = td.self_distilled_pair(tp, tcfg, 1)
    prompts = _spec_prompts(jcfg.vocab_size)
    kw = dict(SPEC, kv_block=0, spec_k=4)
    jde = jd.DraftEngine(jdp, jdc, n_slots=4, max_len=128, kv_block=0)
    tde = td.DraftEngine(tdp, tdc, n_slots=4, max_len=128, kv_block=0,
                         device="cpu")
    assert not tde.paged and tde.table_device() is None
    assert tde.cache["k"].shape[1] == 5 and tde.blocks_used == 0
    j = _jax(jt, jcfg, draft_engine=jde, spec_pipeline=True, **kw)
    t = _port(tt, tcfg, draft_engine=tde, spec_pipeline=True, **kw)
    want = j.generate(prompts, 24)
    got = t.generate(prompts, 24)
    assert got == want
    per = lambda e: [(r.spec_drafted, r.spec_accepted, r.spec_mode)
                     for r in sorted(e.finished, key=lambda r: r.rid)]
    assert per(t) == per(j)
    assert tde.rollouts == jde.rollouts and tde.reuse_hits == jde.reuse_hits
    off = _port(tt, tcfg, **dict(kw, spec_k=0)).generate(prompts, 24)
    assert got == off


# -- the server ---------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_main_passes_kv_block_0(monkeypatch):
    """``--kv-block 0`` reaches ``make_engine``; unset, the engine reads
    ``SKYTPU_KV_BLOCK``."""
    made = []

    class Stop(Exception):
        pass

    def fake_make_engine(config, **kw):
        made.append(kw)
        raise Stop

    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    for argv, want in ((["--kv-block", "0"], 0), ([], None)):
        with pytest.raises(Stop):
            ts.main(["--config", "llama3-tiny", "--device", "cpu"] + argv)
        assert made[-1]["kv_block"] == want
    monkeypatch.setenv("SKYTPU_KV_BLOCK", "0")
    e = te.InferenceEngine(*_tiny_params(), n_slots=2, max_len=64,
                           device="cpu")
    assert not e.paged


def _tiny_params():
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32)
    g = torch.Generator()
    g.manual_seed(0)
    return tl.init_params(cfg, g, device="cpu", dtype=torch.float32), cfg


def test_server_on_a_contiguous_replica(models):
    """``make_engine(kv_block=0)`` serves ``/generate``; ``/prefill`` answers
    the typed 409 ``handoff_ineligible``; ``/handoff`` with a paged
    replica's export resumes cold and finishes with the tokens
    ``/generate`` gives."""
    _, tcfg, _, tp = models
    engine = ts.make_engine("llama3-tiny", slots=2, max_len=64,
                            kv_block=0, prefill_chunk=8, prefix_pool=2,
                            spec_k=0, device="cpu")
    assert not engine.paged and engine.pool is not None
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert model._ready.wait(timeout=300)
        url = f"http://127.0.0.1:{port}"
        prompt = list(range(1, 21))
        code, gen = _post(f"{url}/generate",
                          {"tokens": prompt, "max_new_tokens": 5})
        assert code == 200 and len(gen["tokens"]) == 5
        code, out = _post(f"{url}/prefill",
                          {"tokens": prompt, "max_new_tokens": 5})
        assert code == 409
        assert out["error"]["type"] == "handoff_ineligible"
        donor = ts.make_engine("llama3-tiny", slots=2, max_len=64,
                               kv_block=8, prefill_chunk=8, prefix_pool=2,
                               spec_k=0, device="cpu")
        donor.generate([prompt], 1)
        wire = ts.encode_export(donor.export_prefix_for(donor.finished[0]))
        code, out = _post(f"{url}/handoff", {
            "tokens": prompt, "max_new_tokens": 5,
            "committed": gen["tokens"][:1], "export": wire})
        assert code == 200
        assert out["tokens"] == gen["tokens"]
    finally:
        model.shutdown()
        httpd.shutdown()
        httpd.server_close()
