"""The port's int8 recipe against the JAX package's on the CPU: the
quantizers and the w8a8 product bit for bit, the ``torch._int_mm``
padding helper, the int8-KV programs (``insert``, ``prefill_chunk``,
``decode_burst_staged``, ``verify_draft_staged``) on int8 pools with and
without w8a8 weights, ``copy_block``'s scales, and the engine's greedy
tokens with ``kv_int8`` (and w8a8) on the reference's own workloads.

The JAX functions run under ``jax.jit``, as every reference program
does: there XLA folds the ``/ 127`` of each scale into a multiply by the
float32 reciprocal, which the port reproduces (``kvcache._scale``), so
quantized values and scales are held bit for bit. The programs' K/V
rows come out of each side's own float32 forward, equal to ~1e-6; a row
value that lands that close to a rounding boundary may quantize one step
apart, so the programs' int8 rows are held to at most one step on at
most 1 element in 1000, their bfloat16 scales to one bfloat16 ulp, and
their tokens, lengths and last tokens exactly. The JAX side runs the
Pallas paged kernel in interpret mode (``kv_kernel=True``), the program
the port's kernel path is held to."""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.infer import sampling as jsamp
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import sampling as tsamp
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def qweights(models):
    """The JAX package's w8a8 tree of the shared weights (jitted, as the
    JAX engine builds it) and the port's copy of it through numpy."""
    jcfg, _, jp, _ = models
    jq = jax.jit(lambda p: {"blocks": jkv.quantize_block_weights(p),
                            "head": jkv.quantize_head(p, jcfg)})(jp)
    return jq, tkv.qweights_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x) \
        if isinstance(x, torch.Tensor) else np.asarray(
            x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _equal(got: torch.Tensor, want) -> None:
    """Bit equality: same dtype family, same values (bf16 compared
    widened, which is exact)."""
    np.testing.assert_array_equal(_np(got), _np(want))


def _seeded(shape, seed, scale=3.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * scale
    x.flat[::7] = 0.0                        # exact zeros
    if x.ndim > 1:
        x[..., 0, :] = 0.0                   # an all-zero row
    return x.astype(dtype)


_DTYPES = pytest.mark.parametrize(
    "dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


# -- the quantizers ----------------------------------------------------------

@_DTYPES
@pytest.mark.parametrize("shape", [(5, 2, 32), (3, 4, 2, 128), (1, 8)])
def test_quantize_rows_bit_equal(shape, dtype):
    j, t = _pair(_seeded(shape, 0), dtype)
    jq, js = jax.jit(jkv.quantize_rows)(j)
    tq, ts = tkv.quantize_rows(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _equal(tq, jq)
    _equal(ts, js)
    for out in (jnp.float32, jnp.bfloat16):
        want = jax.jit(functools.partial(jkv.dequantize_rows,
                                         dtype=out))(jq, js)
        got = tkv.dequantize_rows(tq, ts, getattr(torch, out.__name__))
        _equal(got, want)


@_DTYPES
@pytest.mark.parametrize("n_contract", [1, 2])
def test_act_quant_bit_equal(n_contract, dtype):
    j, t = _pair(_seeded((2, 3, 4, 32), 1), dtype)
    jq, js = jax.jit(jkv._act_quant, static_argnums=1)(j, n_contract)
    tq, ts = tkv._act_quant(t, n_contract)
    _equal(tq, jq)
    _equal(ts, js)


@_DTYPES
@pytest.mark.parametrize("shape,nd", [((64, 4, 32), 1), ((4, 32, 64), 2),
                                      ((128, 256), 1)])
def test_quantize_weight_bit_equal(shape, nd, dtype):
    j, t = _pair(_seeded(shape, 2, scale=0.1), dtype)
    want = jax.jit(jkv.quantize_weight, static_argnums=1)(j, nd)
    got = tkv.quantize_weight(t, nd)
    # Stored output-major: the product's 2-D view [K, N] is column-major.
    k = int(np.prod(shape[:nd]))
    assert got["w"].reshape(k, -1).t().is_contiguous()
    _equal(got["w"], want["w"])
    _equal(got["s"], want["s"])


def test_block_and_head_quantization_bit_equal(models, qweights):
    """The stacked per-layer quantization (a loop over layers in the
    port, a vmap in the reference) and the head's, on the model's
    weights; the contraction map is the reference's."""
    _, tcfg, _, tp = models
    jq, _ = qweights
    assert tkv.QUANT_CONTRACT == jkv.QUANT_CONTRACT
    got = {"blocks": tkv.quantize_block_weights(tp),
           "head": tkv.quantize_head(tp, tcfg)}
    assert jax.tree.structure(jax.tree.map(np.asarray, jq)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
    for name in tkv.QUANT_CONTRACT:
        for part in ("w", "s"):
            _equal(got["blocks"][name][part], jq["blocks"][name][part])
    _equal(got["head"]["w"], jq["head"]["w"])
    _equal(got["head"]["s"], jq["head"]["s"])
    slim = tkv.slim_params(tp)
    assert set(slim) == {"embed", "final_norm", "blocks"}
    assert set(slim["blocks"]) == {"ln1", "ln2"}


# The einsum each block weight is consumed by in the reference, with the
# activation shape the tiny model gives it.
_QEINSUMS = {"wq": ("bsd,dhk->bshk", (2, 3, 128)),
             "wk": ("bsd,dhk->bshk", (2, 3, 128)),
             "wv": ("bsd,dhk->bshk", (2, 3, 128)),
             "wo": ("bshk,hkd->bsd", (2, 3, 4, 32)),
             "w_gate": ("bsd,df->bsf", (2, 3, 128)),
             "w_up": ("bsd,df->bsf", (2, 3, 128)),
             "w_down": ("bsf,fd->bsd", (2, 3, 256))}


@_DTYPES
@pytest.mark.parametrize("name", list(_QEINSUMS) + ["head", "head-1d",
                                                    "head-decode"])
def test_qeinsum_bit_equal(models, qweights, name, dtype):
    """Every QUANT_CONTRACT entry's product (layer 1) and the head's three
    forms (wave ``wd,dv->wv``, chunk ``d,dv->v``, decode ``bsd,dv->bsv``)
    give the reference's bits, out in the activation dtype for the
    blocks and float32 for the head."""
    jq, tq = qweights
    if name.startswith("head"):
        eq, shape = {"head": ("wd,dv->wv", (5, 128)),
                     "head-1d": ("d,dv->v", (128,)),
                     "head-decode": ("bsd,dv->bsv", (4, 1, 128))}[name]
        jw, tw, nd, out = jq["head"], tq["head"], 1, "float32"
    else:
        eq, shape = _QEINSUMS[name]
        jw = jax.tree.map(lambda a: a[1], jq["blocks"][name])
        tw = tkv.qlayer_slice(tq, 1)[name]
        nd, out = tkv.QUANT_CONTRACT[name], dtype
    j, t = _pair(_seeded(shape, 3), dtype)
    want = jax.jit(jkv.qeinsum, static_argnums=(0, 3, 4))(
        eq, j, jw, nd, getattr(jnp, out))
    got = tkv.qeinsum(t, tw, nd, getattr(torch, out))
    assert got.shape == tuple(want.shape)
    _equal(got, want)


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int8_matmul_pads_rows_and_is_exact(rows):
    """The padding helper at 1 row (a final chunk's head), 16 (a 16-slot
    decode step) and 17 and 40 (no padding): the int32 product of an
    exact int32 reference, bit for bit, and the same rows' bits whatever
    rows sit beside them."""
    g = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 64), generator=g, dtype=torch.int8)
    b = tkv.int8_layout(torch.randint(-127, 128, (64, 24), generator=g,
                                      dtype=torch.int8), 1)
    got = tkv.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (rows, 24)
    assert torch.equal(got, a.int() @ b.int())
    assert torch.equal(tkv.int8_matmul(a[:1], b), got[:1])


def test_int8_matmul_refuses_what_the_card_refuses():
    a = torch.zeros((4, 12), dtype=torch.int8)
    with pytest.raises(ValueError):
        tkv.int8_matmul(a, torch.zeros((12, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        tkv.int8_matmul(torch.zeros((4, 16), dtype=torch.int8),
                        torch.zeros((16, 12), dtype=torch.int8))


def test_random_quantized_params_has_the_reference_tree():
    """The port's random w8a8 tree has the reference's keys, shapes and
    dtypes (its numbers are torch's draws, not JAX's)."""
    jcfg, tcfg = jl.CONFIGS["llama3-tiny"], tl.CONFIGS["llama3-tiny"]
    jp, jq = jkv.random_quantized_params(jcfg)
    tp, tq = tkv.random_quantized_params(tcfg, seed=0, device="cpu")

    def sig(tree):
        return jax.tree.map(lambda a: (tuple(a.shape),
                                       np.dtype(_np(a).dtype).name
                                       if a.dtype != jnp.bfloat16
                                       and a.dtype != torch.bfloat16
                                       else "bfloat16"), tree)

    assert sig((tp, tq)) == sig((jp, jq))
    assert int(tq["blocks"]["wq"]["w"].abs().max()) <= 127
    again = tkv.random_quantized_params(tcfg, seed=0, device="cpu")[1]
    assert torch.equal(again["head"]["w"], tq["head"]["w"])


# -- the programs on int8 pools ----------------------------------------------

MAX_LEN, BL, N_BLOCKS, K = 32, 8, 8, 4
NB = MAX_LEN // BL


def _assert_int8_cache_close(tc, jc):
    """Real blocks only (the port's trash block takes what the JAX
    scatters dropped): int8 rows within one step on at most 1 element in
    1000, scales within one bfloat16 ulp, lengths and last tokens
    exact."""
    for name in ("k", "v"):
        got = tc[name][:, :N_BLOCKS].numpy().astype(np.int32)
        want = np.asarray(jc[name]).astype(np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(
            _np(tc[name][:, :N_BLOCKS]), _np(jc[name]), rtol=2 ** -8,
            atol=0, err_msg=name)
    for name in ("length", "last_token"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jc[name]))


def _dequant_rows(cache, table, slot, n):
    """Slot ``slot``'s logical rows [0, n) of every layer, dequantized."""
    tbl = np.asarray(table)
    rows = np.arange(n)
    blk, off = tbl[slot, rows // BL], rows % BL
    out = []
    for name in ("k", "v"):
        q = _np(cache[name])[:, blk, off].astype(np.float32)
        s = _np(cache[name + "_scale"])[:, blk, :, off]   # [n, L, G]
        out.append(q * np.moveaxis(s, 0, 1)[..., None])
    return out


_W8 = pytest.mark.parametrize("w8", [False, True], ids=["fp-w", "w8a8"])


@pytest.fixture(scope="module")
def int8_setup(models):
    """Three slots on int8 pools: slot 0 (13 rows) and slot 1 (9 rows)
    active, slot 2 inactive with a stale length; table rows past each
    allocation are the sentinel. Both caches hold the same inserted
    rows (the JAX prefill's, through numpy), so insert is held bit for
    bit."""
    jcfg, tcfg, jp, _ = models
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
    jcache = jkv.init_paged_cache(jcfg, 3, N_BLOCKS, BL, kv_int8=True)
    tcache = tkv.init_paged_cache(tcfg, 3, N_BLOCKS, BL, "cpu",
                                  kv_int8=True)
    jinsert = jax.jit(jkv.insert)
    tt = torch.from_numpy(table)
    for w in range(3):
        row = {n: prefix[n][:, w] for n in ("k", "v")}
        jcache = jinsert(jcache, row, w, jnp.asarray(lens[w]), first[w],
                         jnp.asarray(table))
        tkv.insert(tcache, {n: torch.from_numpy(np.array(r))
                            for n, r in row.items()},
                   w, int(lens[w]), int(first[w]), tt)
    return table, jcache, tcache


def _clone(cache):
    return {n: t.clone() for n, t in cache.items()}


def test_int8_cache_layout(models):
    _, tcfg, _, _ = models
    c = tkv.init_paged_cache(tcfg, 2, N_BLOCKS, BL, "cpu", kv_int8=True)
    L, G, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert c["k"].shape == (L, N_BLOCKS + 1, BL, G, hd)
    assert c["k_scale"].dtype == torch.bfloat16
    assert c["k_scale"].shape == c["v_scale"].shape == \
        (L, N_BLOCKS + 1, G, BL)


def test_insert_int8_bit_equal(int8_setup):
    """The same prefix rows through both inserts: every int8 row and
    bfloat16 scale of the real blocks equal, bit for bit (the spare's
    rows past its allocation land in the port's trash block)."""
    _, jcache, tcache = int8_setup
    for name in ("k", "v", "k_scale", "v_scale", "length", "last_token"):
        _equal(tcache[name][:, :N_BLOCKS] if tcache[name].dim() > 1
               else tcache[name], jcache[name])
    assert tcache["k_scale"][:, 3].abs().sum() == 0     # in no table


def _jit_burst(jcfg, k, span, jq):
    return jax.jit(functools.partial(
        jkv.decode_burst_staged, k=k, cfg=jcfg,
        sp=jsamp.SamplingParams(), span=span, kv_kernel=True,
        qweights=jq))


@_W8
@pytest.mark.parametrize("span", [None, 16], ids=["full", "span16"])
def test_decode_burst_staged_int8_matches_jax(models, qweights,
                                              int8_setup, span, w8):
    jcfg, tcfg, jp, tp = models
    table, jcache, tcache0 = int8_setup
    tcache = _clone(tcache0)
    jq, tq = qweights if w8 else (None, None)
    active = np.array([True, True, False])
    jcache, _, jtoks = _jit_burst(jcfg, K, span, jq)(
        jp, jcache, jax.random.key(0), jnp.asarray(active),
        table=jnp.asarray(table))
    ttoks = tkv.decode_burst_staged(
        tp, tcache, torch.from_numpy(active), K, tcfg,
        tsamp.SamplingParams(), torch.from_numpy(table), span=span,
        qweights=tq)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _assert_int8_cache_close(tcache, jcache)
    for slot in (0, 1):
        n = int(tcache["length"][slot])
        for got, want in zip(_dequant_rows(tcache, table, slot, n),
                             _dequant_rows(jcache, table, slot, n)):
            np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


@_W8
@pytest.mark.parametrize("case", ["oracle", "partial", "short"])
def test_verify_draft_staged_int8_matches_jax(models, qweights, int8_setup,
                                              case, w8):
    """The same cache, draft, n_draft and active mask through both verify
    programs on int8 pools: equal window tokens and n_commit, and the
    flushed rows and scales as above. ``oracle`` drafts the JAX burst's
    continuation; ``partial`` breaks slot 1's third draft token;
    ``short``: slot 0 drafts 2 tokens, slot 1 none."""
    jcfg, tcfg, jp, tp = models
    table, jcache, tcache0 = int8_setup
    tcache = _clone(tcache0)
    jq, tq = qweights if w8 else (None, None)
    _, _, cont = _jit_burst(jcfg, K + 1, None, jq)(
        jp, jcache, jax.random.key(0), jnp.asarray([True, True, False]),
        table=jnp.asarray(table))
    cont = np.asarray(cont).T
    draft = np.zeros((3, K), np.int64)
    draft[:2] = cont[:2, :K]
    n_draft = np.array([K, K, K], np.int64)
    if case == "partial":
        draft[1, 2] = (draft[1, 2] + 1) % tcfg.vocab_size
    if case == "short":
        n_draft[:] = [2, 0, 0]
    active = np.array([True, True, False])
    jverify = jax.jit(functools.partial(
        jkv.verify_draft_staged, k=K, cfg=jcfg, kv_kernel=True,
        qweights=jq))
    jcache, jtoks, jcommit = jverify(
        jp, jcache, jnp.asarray(draft, jnp.int32),
        jnp.asarray(n_draft, jnp.int32), jnp.asarray(active),
        table=jnp.asarray(table))
    ttoks, tcommit = tkv.verify_draft_staged(
        tp, tcache, torch.from_numpy(draft), torch.from_numpy(n_draft),
        torch.from_numpy(active), K, tcfg, torch.from_numpy(table),
        qweights=tq)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tcommit.numpy(), np.asarray(jcommit))
    assert tcommit.tolist() == {"oracle": [K + 1, K + 1, 0],
                                "partial": [K + 1, 3, 0],
                                "short": [3, 1, 0]}[case]
    _assert_int8_cache_close(tcache, jcache)


@_W8
@pytest.mark.parametrize("C", [8, 12], ids=["aligned", "mid-block"])
def test_prefill_chunk_int8_matches_jax(models, qweights, C, w8):
    """A 30-token prompt in chunks of C into slot 1 of an int8 cache
    whose blocks hold int8 garbage (rows no mask admits must not leak):
    after every chunk the rows, scales and length match the JAX chunk
    program's, and the final chunk's first token is the JAX one's."""
    jcfg, tcfg, jp, tp = models
    jq, tq = qweights if w8 else (None, None)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, tcfg.vocab_size, 30)
    table = np.full((3, NB + 1), N_BLOCKS, np.int32)
    table[1, :4] = [5, 0, 3, 2]
    table[0, :1] = [1]
    L, G, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    jcache = jkv.init_paged_cache(jcfg, 3, N_BLOCKS, BL, kv_int8=True)
    tcache = tkv.init_paged_cache(tcfg, 3, N_BLOCKS, BL, "cpu",
                                  kv_int8=True)
    for name in ("k", "v"):
        g = rng.integers(-127, 128, (L, N_BLOCKS, BL, G, hd), dtype=np.int8)
        jcache[name] = jnp.asarray(g)
        tcache[name][:, :N_BLOCKS] = torch.from_numpy(g)
    for name in ("k_scale", "v_scale"):
        g = jnp.asarray(rng.uniform(1e-3, 2e-2, (L, N_BLOCKS, G, BL)),
                        jnp.bfloat16)
        jcache[name] = g
        tcache[name][:, :N_BLOCKS] = torch.from_numpy(
            np.array(g.astype(jnp.float32))).to(torch.bfloat16)
    jcache = jkv.claim_slot(jcache, 1, MAX_LEN)
    tkv.claim_slot(tcache, 1, MAX_LEN)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    rng_key = jax.random.key(0)
    start = 0
    while start < len(prompt):
        n_valid = min(C, len(prompt) - start)
        final = start + n_valid >= len(prompt)
        chunk = np.zeros((C,), np.int64)
        chunk[:n_valid] = prompt[start:start + n_valid]
        new_len = len(prompt) if final else MAX_LEN
        jchunk = jax.jit(functools.partial(
            jkv.prefill_chunk, cfg=jcfg, sp=jsamp.SamplingParams(),
            final=final, qweights=jq, kv_kernel=True))
        jcache, rng_key, jtok = jchunk(
            jp, jcache, jnp.asarray(chunk, jnp.int32), start, n_valid, 1,
            new_len, rng_key, table=jt)
        ttok = tkv.prefill_chunk(
            tp, tcache, torch.from_numpy(chunk), start, n_valid, 1,
            new_len, tcfg, tsamp.SamplingParams(), tt, final=final,
            qweights=tq)
        _assert_int8_cache_close(tcache, jcache)
        assert int(ttok) == int(jtok)
        start += n_valid
    assert int(tcache["last_token"][1]) == int(jtok)


def test_copy_block_copies_the_scales():
    """Copy-on-write of an int8 block: values and both scales move, as in
    the JAX ``copy_block``; a float cache has no scales to move."""
    rng = np.random.default_rng(0)
    q = {n: rng.integers(-127, 128, (2, 5, 8, 2, 16), dtype=np.int8)
         for n in ("k", "v")}
    s = {n: rng.uniform(1e-3, 1.0, (2, 5, 2, 8)).astype(np.float32)
         for n in ("k_scale", "v_scale")}
    jcache = {**{n: jnp.asarray(a) for n, a in q.items()},
              **{n: jnp.asarray(a, jnp.bfloat16) for n, a in s.items()}}
    tcache = {n: torch.from_numpy(np.array(_np(a))) for n, a in
              jcache.items()}
    for n in s:
        tcache[n] = tcache[n].to(torch.bfloat16)
    for src, dst in ((3, 1), (0, 4)):
        jcache = jkv.copy_block(jcache, jnp.asarray(src), jnp.asarray(dst))
        tkv.copy_block(tcache, src, dst)
    for name in jcache:
        _equal(tcache[name], jcache[name])
    assert torch.equal(tcache["k_scale"][:, 1],
                       tcache["k_scale"][:, 3])
    assert not torch.equal(tcache["v_scale"][:, 1],
                           torch.from_numpy(s["v_scale"][:, 1]).to(
                               torch.bfloat16))


# -- the engine on the reference's workloads ---------------------------------

def _jax_engine(jp, jcfg, **kw):
    return je.InferenceEngine(jp, jcfg, kv_kernel=True, **kw)


def _torch_engine(tp, tcfg, **kw):
    return te.InferenceEngine(tp, tcfg, device="cpu", **kw)


def _parity_kw(spec_k):
    """``tests/test_paged_attention.py``'s engine (4 slots, max_len 64,
    bucket 32, blocks of 16, chunks of 8, prefix pool 4)."""
    return dict(n_slots=4, max_len=64, prompt_buckets=(32,), kv_block=16,
                prefill_chunk=8, prefix_pool=4, spec_k=spec_k,
                kv_int8=True)


def _parity_prompts(vocab):
    """Its pinned workload: lengths (5, 11, 3, 20), seed 1."""
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, n).tolist() for n in (5, 11, 3, 20)]


def _span_kw(spec_k, span_buckets=None):
    """``tests/test_span_attn.py``'s paged engine (4 slots, max_len 64,
    blocks of 8, buckets 16/32, chunks of 8, prefix pool 2)."""
    return dict(n_slots=4, max_len=64, kv_block=8, span_buckets=span_buckets,
                prompt_buckets=(16, 32), prefill_chunk=8, prefix_pool=2,
                spec_k=spec_k, kv_int8=True)


def _span_prompts(vocab, lengths=(5, 12, 30, 9)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


_PATHS = pytest.mark.parametrize("plain", [False, True],
                                 ids=["kernel", "plain"])


@pytest.fixture(scope="module")
def jax_parity(models):
    """The JAX engine's tokens on the pinned parity workload, one run per
    (spec_k, weights_int8), shared by the kernel and plain cases."""
    jcfg, _, jp, _ = models
    cache = {}

    def get(spec_k, weights_int8=False):
        if (spec_k, weights_int8) not in cache:
            cache[spec_k, weights_int8] = _jax_engine(
                jp, jcfg, weights_int8=weights_int8,
                **_parity_kw(spec_k)).generate(
                    _parity_prompts(jcfg.vocab_size), max_new_tokens=8)
        return cache[spec_k, weights_int8]

    return get


@_PATHS
@pytest.mark.parametrize("spec_k", [0, 3], ids=["spec0", "spec3"])
def test_engine_int8_kv_matches_jax_engine(models, jax_parity, spec_k,
                                           plain):
    """``test_engine_parity_matrix``'s int8 cells: the port's fp32 greedy
    tokens on an int8 KV cache equal the JAX int8 engine's."""
    _, tcfg, _, tp = models
    want = jax_parity(spec_k)
    e = _torch_engine(tp, tcfg, plain_attention=plain, **_parity_kw(spec_k))
    assert e.cache["k"].dtype == torch.int8
    assert e.generate(_parity_prompts(tcfg.vocab_size),
                      max_new_tokens=8) == want
    assert e.blocks_used() == sum(len(p) for p in
                                  e._prefix_index.payloads())


@pytest.mark.parametrize("spec_k", [0, 3], ids=["spec-off", "spec-on"])
def test_engine_span_int8_matches_jax_engine(models, spec_k):
    """``test_span_parity_matrix``'s paged int8 cells: the same tokens as
    the JAX int8 engine with the span ladder and with the full view."""
    jcfg, tcfg, jp, tp = models
    prompts = _span_prompts(tcfg.vocab_size)
    want = _jax_engine(jp, jcfg, **_span_kw(spec_k)).generate(
        prompts, max_new_tokens=20)
    for buckets in (None, 0):
        e = _torch_engine(tp, tcfg, **_span_kw(spec_k, buckets))
        assert e.generate(prompts, max_new_tokens=20) == want


def test_engine_w8a8_random_weights_match_jax_engine(models):
    """``test_span_parity_weights_int8``: the reference's
    ``random_quantized_params`` (slim fp tree + int8 tree) carried across
    through numpy; a w8a8 engine on an int8 cache gives the JAX engine's
    tokens with the span ladder and with the full view."""
    jcfg, tcfg, _, _ = models
    jp, jq = jkv.random_quantized_params(jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    tq = tkv.qweights_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    prompts = _span_prompts(tcfg.vocab_size)
    want = _jax_engine(jp, jcfg, qweights=jq, **_span_kw(0)).generate(
        prompts, max_new_tokens=16)
    for buckets in (None, 0):
        e = _torch_engine(tp, tcfg, qweights=tq, **_span_kw(0, buckets))
        assert set(e.params["blocks"]) == {"ln1", "ln2"}
        assert e.generate(prompts, max_new_tokens=16) == want


@_PATHS
def test_engine_weights_int8_quantizes_once_and_slims(models, jax_parity,
                                                      plain):
    """``weights_int8=True`` quantizes the given float tree on the
    engine's device, keeps only the slim tree, and gives the JAX w8a8
    int8-KV engine's tokens (spec on, the reference server's default)."""
    _, tcfg, _, tp = models
    prompts = _parity_prompts(tcfg.vocab_size)
    want = jax_parity(3, weights_int8=True)
    e = _torch_engine(tp, tcfg, weights_int8=True, plain_attention=plain,
                      **_parity_kw(3))
    assert set(e.params) == {"embed", "final_norm", "blocks"}
    assert set(e.params["blocks"]) == {"ln1", "ln2"}
    assert e.qweights["head"]["w"].dtype == torch.int8
    assert e.generate(prompts, max_new_tokens=8) == want


@_PATHS
def test_int8_prefix_hit_warm_equals_cold(models, plain):
    """An int8 prefix hit (chunks of 8 over blocks of 16: a 24-token
    stored prefix ends mid-block, so storing and the hit each copy the
    partial block, scales included): warm equals its cold rerun and the
    JAX int8 engine's warm tokens."""
    jcfg, tcfg, jp, tp = models
    system = list(range(5, 29))
    pa, pb = system + [31, 32, 33], system + [41, 42]
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(16, 48),
              prefill_chunk=8, prefix_pool=4, kv_block=16, spec_k=0,
              kv_int8=True)
    ref = _jax_engine(jp, jcfg, **kw)
    e = _torch_engine(tp, tcfg, plain_attention=plain, **kw)
    for eng in (ref, e):
        eng.generate([pa], max_new_tokens=6)
        eng.finished.clear()
    want = ref.generate([pb], max_new_tokens=6)[0]
    warm = e.generate([pb], max_new_tokens=6)[0]
    assert e.finished[0].cached_len == ref.finished[0].cached_len == 24
    assert e.cow_copies == 2
    e.finished.clear()
    e.clear_prefix_cache()
    assert warm == want == e.generate([pb], max_new_tokens=6)[0]


# -- the server --------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_serves_the_int8_recipe_on_the_cpu():
    """``--kv-int8 --weights-int8`` through ``main``: the server comes up
    and answers /generate with the budget's tokens."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "skypilot_tpu_torch.infer.server",
         "--config", "llama3-tiny", "--device", "cpu", "--port",
         str(port), "--slots", "2", "--max-len", "64", "--kv-block", "16",
         "--prefill-chunk", "16", "--kv-int8", "--weights-int8"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    if json.loads(r.read())["status"] == "ok":
                        break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.time() < deadline, "server never became healthy"
            time.sleep(0.2)
        for tokens in ([3, 17, 42], list(range(1, 30))):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"tokens": tokens,
                                 "max_new_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            assert r.status == 200 and len(out["tokens"]) == 4
        assert out["prefill_chunks"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_make_engine_passes_the_int8_flags(monkeypatch):
    """``main`` hands ``--kv-int8`` and ``--weights-int8`` to the engine,
    and the engine it builds holds an int8 cache and the slim tree."""
    from skypilot_tpu_torch.infer import server as ts
    seen = []

    class Stop(Exception):
        pass

    real = ts.make_engine

    def fake_make_engine(config, **kw):
        seen.append((kw["kv_int8"], kw["weights_int8"]))
        if kw["kv_int8"]:
            e = real(config, **{**kw, "slots": 1, "max_len": 32,
                                "kv_block": 16})
            seen.append((e.cache["k"].dtype, set(e.params["blocks"])))
        raise Stop

    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    with pytest.raises(Stop):
        ts.main(["--config", "llama3-tiny", "--device", "cpu"])
    with pytest.raises(Stop):
        ts.main(["--config", "llama3-tiny", "--device", "cpu",
                 "--kv-int8", "--weights-int8"])
    assert seen == [(False, False), (True, True),
                    (torch.int8, {"ln1", "ln2"})]
