"""The paged decode-attention kernel (K1): the port's plain version
against the JAX package's Pallas kernel in interpret mode, on the fuzz
of ``tests/test_paged_attention.py`` (float and int8 pools, length-0
slots, partial final blocks, scattered block ids, sentinel entries, a
layer index > 0, span-bounded sweeps), and at the chunk path's
multi-row shapes (``C * rep`` rows per kv-head, float and int8 pools)
over the engine's pool layout, whose sentinel is the trash block inside
the pool. The CUDA kernel's card tests are in
``test_torch_kernels_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch.ops import paged_attention as tpa

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

L, N_BLOCKS, BL, G, HD = 2, 12, 8, 2, 16
B, R, NB = 4, 3, 5


def _pools(quant, rng):
    shape = (L, N_BLOCKS, BL, G, HD)
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        # Scales as the cache stores them: bf16 (both sides read the
        # same bf16 values).
        ks = torch.from_numpy((rng.random((L, N_BLOCKS, G, BL)) * 0.02
                               + 1e-3).astype(np.float32)).bfloat16()
        vs = torch.from_numpy((rng.random((L, N_BLOCKS, G, BL)) * 0.02
                               + 1e-3).astype(np.float32)).bfloat16()
        return kp, vp, ks, vs
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    return kp, vp, None, None


def _trial(rng):
    q = rng.standard_normal((B, G, R, HD)).astype(np.float32)
    table = np.full((B, NB + 1), N_BLOCKS, np.int32)
    lengths = np.zeros((B,), np.int32)
    for b in range(B):
        # 0 rows, partial final blocks, full allocations, scattered
        # physical ids, sentinel tails.
        n = int(rng.integers(0, NB * BL + 1))
        have = -(-n // BL)
        table[b, :have] = rng.choice(N_BLOCKS, size=have, replace=False)
        lengths[b] = n
    lengths[0] = 0                     # always one empty slot
    span = int(rng.integers(1, NB * BL + 1))
    layer = int(rng.integers(1, L))    # a layer index > 0
    return q, table, lengths, span, layer


def _jnp_scale(s):
    return None if s is None else jnp.asarray(s.float().numpy(),
                                              jnp.bfloat16)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("trial", range(4))
def test_plain_matches_pallas_interpret(quant, trial):
    rng = np.random.default_rng(100 * trial + quant)
    kp, vp, ks, vs = _pools(quant, rng)
    q, table, lengths, span, layer = _trial(rng)
    sb = -(-span // BL)
    want = jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), _jnp_scale(ks),
        _jnp_scale(vs), jnp.asarray(table), jnp.asarray(lengths),
        jnp.int32(layer), span_blocks=sb, interpret=True)
    got = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        ks, vs, torch.from_numpy(table), torch.from_numpy(lengths), layer,
        span_blocks=sb)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)
    # The length-0 slot is annihilated by the merge: m=-1e30, l=0.
    assert np.all(got[1].numpy()[0] == np.float32(-1e30))
    assert np.all(got[2].numpy()[0] == 0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("span", [None, 5, 8, 21])
def test_gather_matches_jax_gather(quant, span):
    rng = np.random.default_rng(7)
    kp, vp, ks, vs = _pools(quant, rng)
    _, table, _, _, layer = _trial(rng)
    cache = {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}
    if quant:
        cache["k_scale"] = _jnp_scale(ks)
        cache["v_scale"] = _jnp_scale(vs)
    want = jkv._gather_kv_layer(cache, layer, jnp.asarray(table), span)
    tt = torch.from_numpy(table)
    got = [tpa.gather_kv_layer(torch.from_numpy(kp), layer, tt, span),
           tpa.gather_kv_layer(torch.from_numpy(vp), layer, tt, span)]
    if quant:
        got += [tpa.gather_kv_layer(ks, layer, tt, span),
                tpa.gather_kv_layer(vs, layer, tt, span)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(3)
    kp, vp, _, _ = _pools(False, rng)
    q, table, lengths, _, layer = _trial(rng)
    before = tpa.paged_attention.launches
    tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        None, None, torch.from_numpy(table), torch.from_numpy(lengths),
        layer, span_blocks=NB)
    assert tpa.paged_attention.launches == before



# -- the chunk path's multi-row shapes ---------------------------------------

# llama3-tiny's geometry (2 kv-heads, rep 2, head_dim 32) at max_len 64:
# a chunk of C tokens puts C * rep query rows on each kv-head.
M_L, M_G, M_REP, M_HD, M_MAX_LEN = 2, 2, 2, 32, 64
# Slot lengths (the chunk's start): empty, mid-block, block-aligned at
# both block lengths, and the whole span.
_M_LENGTHS = (0, 11, 16, 40, 64)


def _rows_trial(rng, C, bl, quant=False):
    """Inputs laid out as the engine lays them: every slot's allocated
    blocks scattered over the pool, the rest of its table (and the
    sentinel column) pointing at the trash block, id n_real, which lies
    inside the pool and holds large values no mask may admit. ``quant``:
    int8 pools with bf16 scales, as ``_pools`` builds them (the trash
    block's scales are 1)."""
    nb = M_MAX_LEN // bl
    B = len(_M_LENGTHS)
    alloc = [min(nb, -(-(n + 8) // bl)) for n in _M_LENGTHS]
    n_real = sum(alloc)
    shape = (M_L, n_real + 1, bl, M_G, M_HD)
    ks = vs = None
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        sshape = (M_L, n_real + 1, M_G, bl)
        ks, vs = ((rng.random(sshape) * 0.02 + 1e-3).astype(np.float32)
                  for _ in range(2))
        ks[:, n_real] = vs[:, n_real] = 1.0
        ks, vs = (torch.from_numpy(x).bfloat16() for x in (ks, vs))
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    kp[:, n_real] = 100
    vp[:, n_real] = 100
    table = np.full((B, nb + 1), n_real, np.int32)
    ids = rng.permutation(n_real)
    for b, have in enumerate(alloc):
        table[b, :have] = ids[:have]
        ids = ids[have:]
    q = rng.standard_normal((B, M_G, C * M_REP, M_HD)).astype(np.float32)
    return q, kp, vp, ks, vs, table, np.array(_M_LENGTHS, np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("bl", [8, 16])
@pytest.mark.parametrize("span", [None, 32], ids=["full", "span32"])
def test_rows_plain_matches_pallas_interpret(C, bl, span, quant):
    rng = np.random.default_rng(C * 100 + bl)
    q, kp, vp, ks, vs, table, lengths = _rows_trial(rng, C, bl, quant)
    sb = -(-(span or M_MAX_LEN) // bl)
    layer = 1
    want = jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), _jnp_scale(ks),
        _jnp_scale(vs), jnp.asarray(table), jnp.asarray(lengths),
        jnp.int32(layer), span_blocks=sb, interpret=True)
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            ks, vs, torch.from_numpy(table), torch.from_numpy(lengths),
            layer)
    # On CPU tensors both entry points run the plain version.
    for fn in (tpa.paged_attention_rows, tpa.paged_attention):
        got = fn(*args, span_blocks=sb)
        for name, g, w in zip(("acc", "m", "l"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       err_msg=name)
        # The length-0 slot: exactly the empty stats, as the kernel's.
        assert np.all(got[1].numpy()[0] == np.float32(-1e30))
        assert np.all(np.asarray(want[1])[0] == np.float32(-1e30))
        assert np.all(got[2].numpy()[0] == 0) and np.all(
            got[0].numpy()[0] == 0)


def test_rows_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(5)
    q, kp, vp, _, _, table, lengths = _rows_trial(rng, 32, 16)
    before = (tpa.paged_attention.launches,
              tpa.paged_attention_rows.launches,
              tpa.paged_attention_rows.mma_launches)
    tpa.paged_attention_rows(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        None, None, torch.from_numpy(table), torch.from_numpy(lengths), 0,
        span_blocks=4)
    assert (tpa.paged_attention.launches,
            tpa.paged_attention_rows.launches,
            tpa.paged_attention_rows.mma_launches) == before


@pytest.mark.parametrize("q_dtype,kv_dtype,bl,wgmma", [
    (torch.bfloat16, torch.bfloat16, 8, True),
    (torch.bfloat16, torch.bfloat16, 16, True),
    (torch.bfloat16, torch.bfloat16, 32, True),
    (torch.bfloat16, torch.bfloat16, 64, True),
    (torch.bfloat16, torch.bfloat16, 256, True),
    (torch.bfloat16, torch.int8, 8, True),
    (torch.bfloat16, torch.int8, 256, True),
    (torch.bfloat16, torch.bfloat16, 24, False),
    (torch.bfloat16, torch.bfloat16, 48, False),
    (torch.bfloat16, torch.int8, 48, False),
    (torch.bfloat16, torch.float32, 256, False),
    (torch.float32, torch.float32, 256, False),
    (torch.float32, torch.bfloat16, 256, False),
    (torch.float32, torch.int8, 256, False)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_rows_body_is_picked_by_dtype_and_block_length(q_dtype, kv_dtype,
                                                       bl, wgmma):
    """The multi-row dispatch reads the dtypes and the block length and
    nothing else: the wgmma body takes a bfloat16 q on bfloat16 or int8
    pools with blocks of 8, 16, 32 or a multiple of 64; every other case
    goes to the mma.sync body (float) or raises (int8). The card tests
    check that the counter of the body picked here moves."""
    q = torch.zeros((1, 2, 64, 32), dtype=q_dtype)
    kp = torch.zeros((2, 3, bl, 2, 32), dtype=kv_dtype)
    assert tpa._tma_body(q, kp) == wgmma
