"""The port's paged serving programs against the JAX package's on the
CPU in float32: wave prefill logits and K/V rows, the paged insert, the
staged decode burst's tokens and flushed cache — with a spare slot
whose table row is all sentinel and rows past a slot's allocation,
whose writes must drop — and chunked prefill, chunk by chunk against
the JAX chunk program (kernel path) and as a whole against the
monolithic wave prefill."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.infer import sampling as jsamp
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import sampling as tsamp
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

MAX_LEN, BL, N_BLOCKS, S = 32, 8, 6, 16
NB = MAX_LEN // BL


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    rng = np.random.default_rng(0)
    # Slot 0: 13 rows in 2 blocks (a burst of 4 runs past its
    # allocation); slot 1: 9 rows in 3 blocks; slot 2: the spare, all
    # sentinel (a dummy wave row targets it).
    table = np.full((3, NB + 1), N_BLOCKS, np.int32)
    table[0, :2] = [4, 1]
    table[1, :3] = [0, 5, 2]
    lens = np.array([13, 9, 1], np.int64)
    tokens = np.zeros((3, S), np.int64)
    for w, n in enumerate(lens):
        tokens[w, :n] = rng.integers(1, tcfg.vocab_size, n)
    return jcfg, tcfg, jp, tp, table, tokens, lens


def _jax_prefilled(setup):
    jcfg, _, jp, _, table, tokens, lens = setup
    prefix, logits = jkv.prefill_batch(jp, jnp.asarray(tokens),
                                       jnp.asarray(lens), jcfg)
    cache = jkv.init_paged_cache(jcfg, 3, N_BLOCKS, BL)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    for w in range(3):
        cache = jkv.insert(cache, {"k": prefix["k"][:, w],
                                   "v": prefix["v"][:, w]}, w,
                           jnp.asarray(lens[w]), first[w],
                           table=jnp.asarray(table))
    cache["length"] = cache["length"].at[2].set(0)      # spare
    return prefix, logits, cache


def _torch_prefilled(setup):
    _, tcfg, _, tp, table, tokens, lens = setup
    prefix, logits = tkv.prefill_batch(tp, torch.from_numpy(tokens),
                                       torch.from_numpy(lens), tcfg)
    cache = tkv.init_paged_cache(tcfg, 3, N_BLOCKS, BL, "cpu")
    first = tsamp.argmax_tokens(logits)
    tt = torch.from_numpy(table)
    for w in range(3):
        tkv.insert(cache, {"k": prefix["k"][:, w], "v": prefix["v"][:, w]},
                   w, int(lens[w]), first[w], tt)
    cache["length"][2] = 0
    return prefix, logits, cache


def _assert_cache_equal(tc, jc, atol):
    # Real blocks only: the port's extra trash block (id N_BLOCKS) is
    # where the JAX scatter's dropped writes go.
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, :N_BLOCKS].numpy(),
                                   np.asarray(jc[name]), atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    np.testing.assert_array_equal(tc["last_token"].numpy(),
                                  np.asarray(jc["last_token"]))


def test_prefill_batch_and_insert_match(setup):
    jprefix, jlogits, jcache = _jax_prefilled(setup)
    tprefix, tlogits, tcache = _torch_prefilled(setup)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tprefix[name].numpy(),
                                   np.asarray(jprefix[name]), atol=1e-5)
    _assert_cache_equal(tcache, jcache, atol=1e-5)
    # Block 3 is in no table: every write (the spare's dummy row, the
    # padding rows past an allocation) dropped.
    assert not tcache["k"][:, 3].any()


@pytest.mark.parametrize("span", [None, 16], ids=["full", "span16"])
def test_decode_burst_staged_matches(setup, span):
    jcfg, tcfg, jp, tp, table, _, _ = setup
    _, _, jcache = _jax_prefilled(setup)
    _, _, tcache = _torch_prefilled(setup)
    active = np.array([True, True, False])
    k = 4
    sp = jsamp.SamplingParams()
    jcache, _, jtoks = jkv.decode_burst_staged(
        jp, jcache, jax.random.key(0), jnp.asarray(active), k, jcfg, sp,
        table=jnp.asarray(table), span=span, kv_kernel=True)
    before = tcache["k"][:, 3].clone()
    ttoks = tkv.decode_burst_staged(
        tp, tcache, torch.from_numpy(active), k, tcfg,
        tsamp.SamplingParams(), torch.from_numpy(table), span=span)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _assert_cache_equal(tcache, jcache, atol=1e-5)
    # Slot 0's row 16 and the spare's rows routed to the sentinel.
    assert torch.equal(tcache["k"][:, 3], before)
    assert tcache["k"][:, N_BLOCKS].any()


def test_merge_attn_parts_annihilates_empty_slot():
    acc = torch.full((1, 1, 2, 4), 7.0)
    m = torch.full((1, 1, 2), -1e30)
    l = torch.full((1, 1, 2), 3.0)
    ss = torch.tensor([[[[0.5, -1e30], [1.0, 2.0]]]])
    alpha, w_s, l_tot = tkv._merge_attn_parts(acc, m, l, ss)
    ja, jw, jl_ = jkv._merge_attn_parts(
        jnp.asarray(acc.numpy()), jnp.asarray(m.numpy()),
        jnp.asarray(l.numpy()), jnp.asarray(ss.numpy()))
    assert torch.all(alpha == 0)
    np.testing.assert_allclose(w_s.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(l_tot.numpy(), np.asarray(jl_), rtol=1e-6)


def test_block_allocator_matches_reference():
    ja, ta = jkv.BlockAllocator(5), tkv.BlockAllocator(5)
    got = [ta.alloc() for _ in range(3)]
    assert got == [ja.alloc() for _ in range(3)] == [0, 1, 2]
    ta.incref(1)
    ta.decref(1)
    assert ta.writable(1) and ta.used == 3 and ta.available == 2
    ta.decref(0)
    with pytest.raises(RuntimeError):
        ta.decref(0)
    assert ta.alloc() == 0


# -- chunked prefill ---------------------------------------------------------

# Slot 1 of three prefills a prompt in chunks; its table holds scattered
# blocks and, past its allocation, the sentinel. (prompt length, chunk):
# chunks of 8 start at block boundaries (0, 8, 16); chunks of 12 start
# mid-block (12) and end past max_len (rows 24..35), whose rows must land
# only in the trash block.
_CHUNK_CASES = {"aligned": (21, 8, [5, 0, 3]), "mid-block": (30, 12,
                                                            [5, 0, 3, 2])}


def _chunk_setup(setup, case):
    jcfg, tcfg, jp, tp, _, _, _ = setup
    n, C, blocks = _CHUNK_CASES[case]
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, tcfg.vocab_size, n)
    table = np.full((3, NB + 1), N_BLOCKS, np.int32)
    table[1, :len(blocks)] = blocks
    table[0, :1] = [1]
    # Garbage in every block: rows no mask admits must not leak.
    shape = (tcfg.n_layers, N_BLOCKS, BL, tcfg.n_kv_heads, tcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jcache = jkv.init_paged_cache(jcfg, 3, N_BLOCKS, BL)
    jcache["k"], jcache["v"] = jnp.asarray(k0), jnp.asarray(v0)
    tcache = tkv.init_paged_cache(tcfg, 3, N_BLOCKS, BL, "cpu")
    tcache["k"][:, :N_BLOCKS] = torch.from_numpy(k0)
    tcache["v"][:, :N_BLOCKS] = torch.from_numpy(v0)
    return prompt, C, table, jcache, tcache


def _rung(start):
    """The engine's span for a chunk at ``start``: the default ladder's
    smallest rung covering it (None for the full view)."""
    return next((s for s in (4, 8, 16) if start <= s), None)


@pytest.mark.parametrize("case", list(_CHUNK_CASES))
@pytest.mark.parametrize("span", ["full", "rung"])
def test_prefill_chunk_matches_jax_chunk_program(setup, case, span):
    jcfg, tcfg, jp, tp, _, _, _ = setup
    prompt, C, table, jcache, tcache = _chunk_setup(setup, case)
    slot = 1
    jcache = jkv.claim_slot(jcache, slot, MAX_LEN)
    tkv.claim_slot(tcache, slot, MAX_LEN)
    assert tcache["length"].tolist() == np.asarray(jcache["length"]).tolist()
    sp = jsamp.SamplingParams()
    rng = jax.random.key(0)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    start = 0
    while start < len(prompt):
        n_valid = min(C, len(prompt) - start)
        final = start + n_valid >= len(prompt)
        chunk = np.zeros((C,), np.int64)
        chunk[:n_valid] = prompt[start:start + n_valid]
        new_len = len(prompt) if final else MAX_LEN
        sp_arg = _rung(start) if span == "rung" else None
        jcache, rng, jtok = jkv.prefill_chunk(
            jp, jcache, jnp.asarray(chunk, jnp.int32), start, n_valid, slot,
            new_len, rng, jcfg, sp, final=final, table=jt, span=sp_arg,
            kv_kernel=True)
        trash = tcache["k"][:, N_BLOCKS].clone()
        ttok = tkv.prefill_chunk(
            tp, tcache, torch.from_numpy(chunk), start, n_valid, slot,
            new_len, tcfg, tsamp.SamplingParams(), tt, final=final,
            span=sp_arg)
        # Rows (real blocks; the JAX scatter dropped what the port's
        # trash block took), the stamped length and, on the final chunk,
        # the first token.
        _assert_cache_equal(tcache, jcache, atol=1e-5)
        assert int(ttok) == int(jtok)
        overflow = start + C > MAX_LEN
        assert bool((tcache["k"][:, N_BLOCKS] != trash).any()) == overflow
        start += n_valid
    assert tcache["length"][slot] == len(prompt)
    assert tcache["last_token"][slot] == int(jtok)
    # Blocks outside slot 1's table were never written.
    for b in set(range(N_BLOCKS)) - set(table[1].tolist()):
        np.testing.assert_array_equal(tcache["k"][:, b].numpy(),
                                      np.asarray(jcache["k"])[:, b])


def _run_chunks(prog, cache, prompt, C):
    """Every chunk of ``prompt`` through ``prog(cache, chunk, start,
    n_valid, new_len, final)``, which returns the new cache (or None for
    an in-place update); returns the last cache."""
    n = len(prompt)
    for start in range(0, n, C):
        nv = min(C, n - start)
        chunk = np.zeros((C,), np.int64)
        chunk[:nv] = prompt[start:start + nv]
        final = start + nv >= n
        out = prog(cache, chunk, start, nv, n if final else MAX_LEN, final)
        cache = cache if out is None else out
    return cache


@pytest.mark.parametrize("case", list(_CHUNK_CASES))
def test_chunked_equals_monolithic_prefill(setup, case, monkeypatch):
    """Chunked prefill against the wave prefill + insert of the same
    prompt: the K/V rows and the first token's logits. The chunk program
    rounds q and the chunk's own K/V to bf16 for its intra-chunk block,
    as the JAX program does (a plain bf16 product, left to XLA there),
    and the monolith does not, so even in float32 the two differ by
    what that rounding carries (up to ~6e-3 in the logits, ~1.5e-2 in
    layer-1 rows, in the JAX package's own programs). Held: the port's
    chunked-minus-monolithic difference equals the JAX package's within
    1e-4, layer-0 rows (before any attention) agree within 1e-5, and
    the greedy token is the monolith's."""
    jcfg, tcfg, jp, tp, _, _, _ = setup
    prompt, C, table, jcache, tcache = _chunk_setup(setup, case)
    n = len(prompt)
    logits = {}
    real_t, real_j = tsamp.sample, jsamp.sample
    monkeypatch.setattr(tkv.sampling_mod, "sample", lambda lg, *a: (
        logits.__setitem__("torch", lg.numpy()[0]) or real_t(lg, *a)))
    monkeypatch.setattr(jkv.sampling_mod, "sample", lambda lg, *a: (
        logits.__setitem__("jax", np.asarray(lg)) or real_j(lg, *a)))
    tt, jt = torch.from_numpy(table), jnp.asarray(table)
    rng = [jax.random.key(0)]

    def jprog(cache, chunk, start, nv, new_len, final):
        cache, rng[0], _ = jkv.prefill_chunk(
            jp, cache, jnp.asarray(chunk, jnp.int32), start, nv, 1,
            new_len, rng[0], jcfg, jsamp.SamplingParams(), final=final,
            table=jt, kv_kernel=True)
        return cache

    def tprog(cache, chunk, start, nv, new_len, final):
        logits["tok"] = tkv.prefill_chunk(
            tp, cache, torch.from_numpy(chunk), start, nv, 1, new_len,
            tcfg, tsamp.SamplingParams(), tt, final=final)

    tkv.claim_slot(tcache, 1, MAX_LEN)
    _run_chunks(tprog, tcache, prompt, C)
    jcache = _run_chunks(jprog, jkv.claim_slot(jcache, 1, MAX_LEN),
                         prompt, C)
    toks = np.zeros((1, 32), np.int64)
    toks[0, :n] = prompt
    tprefix, tmono = tkv.prefill_batch(tp, torch.from_numpy(toks),
                                       torch.tensor([n]), tcfg)
    jprefix, jmono = jkv.prefill_batch(jp, jnp.asarray(toks),
                                       jnp.asarray([n]), jcfg)
    tdiff = logits["torch"] - tmono.numpy()[0]
    jdiff = logits["jax"] - np.asarray(jmono)[0]
    np.testing.assert_allclose(tdiff, jdiff, atol=1e-4)
    assert int(logits["tok"]) == int(tmono.argmax())
    blk, off = tkv._phys(tcache, tt, 1, torch.arange(n))
    jk = {name: np.asarray(jcache[name])[:, blk.numpy(), off.numpy()]
          for name in ("k", "v")}
    for name in ("k", "v"):
        rows = tcache[name][:, blk, off].numpy()
        mono = tprefix[name][:, 0, :n].numpy()
        np.testing.assert_allclose(rows[0], mono[0], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(
            rows - mono, jk[name] - np.asarray(jprefix[name])[:, 0, :n],
            atol=1e-4, err_msg=name)
