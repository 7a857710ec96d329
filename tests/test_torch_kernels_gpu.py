"""The port's CUDA kernels (K1 paged attention, its decode and multi-row
bodies; K2 flash forward; K3/K4 flash backward) against their plain
versions on the card.

Every test here carries the ``gpu`` marker and skips inside the test
when no card is present. The file imports neither jax nor the JAX
package, so the card's machine, which has no jax, runs it without the
suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.ops import paged_attention as tpa


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def _ulp_close(got, want):
    """bf16: within one bf16 ulp of the plain value plus 1e-3 of its
    largest magnitude (a flipped rounding costs one ulp)."""
    w = want.float()
    _, e = torch.frexp(w)
    tol = torch.ldexp(torch.ones_like(w), e - 8) + 1e-3 * w.abs().max()
    worst = ((got.float() - w).abs() / tol).max().item()
    assert worst <= 1.0, f"|got - want| / tolerance reaches {worst:.3f}"


# -- K2: flash-attention forward --------------------------------------------

def _flash_inputs(dev, dtype, S, segments, D=128, hkv=2, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, H = 2, 4
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, hkv, D), generator=gen, device=dev).to(dtype)
    seg = None
    if segments:
        cuts = torch.rand((B, S), generator=gen, device=dev) < 0.02
        seg = cuts.int().cumsum(dim=1).to(torch.int32)
    return q, k, v, seg


# Shapes the tensor-core bodies must cover besides the main path's:
# sequences shorter than a tile and not a multiple of one (197: ViT's
# 196 patches and the class token), every head dim, GQA groups of 1, 2
# and 4 (4 q-heads over 4, 2 or 1 kv-heads), and attention without the
# causal mask at groups of 2 and of 1 (ViT's).
_DIMS = pytest.mark.parametrize("D", [32, 64, 128])
_SEQS = pytest.mark.parametrize("S", [1, 16, 128, 197, 200, 512, 1000])
_DTYPES = pytest.mark.parametrize("dtype,segments", [
    (torch.bfloat16, False), (torch.bfloat16, True),
    (torch.float32, False), (torch.float32, True)])
_VARIANTS = pytest.mark.parametrize("hkv,causal", [
    (2, True), (4, True), (1, True), (2, False), (4, False)])


@pytest.mark.gpu
@_DIMS
@_SEQS
@_DTYPES
@_VARIANTS
def test_flash_kernel_matches_plain(S, dtype, segments, D, hkv, causal):
    dev = _cuda()
    q, k, v, seg = _flash_inputs(dev, dtype, S, segments, D, hkv)
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, seg, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, seg, causal)
    if dtype == torch.bfloat16:
        _ulp_close(o, ro)
    else:
        _close(o, ro, 1e-4)
    _close(lse, rlse, 1e-4)     # float32 on both sides


@pytest.mark.gpu
def test_flash_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    q = torch.zeros((1, 64, 4, 96), device=dev)    # head_dim 96
    k = torch.zeros((1, 64, 2, 96), device=dev)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k)
    h = torch.zeros((1, 64, 4, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):                  # fp16
        tfa.flash_attention_fwd(h, h[:, :, :2].contiguous(),
                                h[:, :, :2].contiguous())
    with pytest.raises(ValueError):                 # not contiguous
        t = torch.zeros((1, 4, 64, 64), device=dev).transpose(1, 2)
        tfa.flash_attention_fwd(t, t, t)


# -- K3 / K4: flash-attention backward --------------------------------------

def _bwd_inputs(dev, dtype, S, segments, D, hkv, causal):
    q, k, v, seg = _flash_inputs(dev, dtype, S, segments, D, hkv)
    gen = torch.Generator(device=dev).manual_seed(1)
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    o, lse = tfa.flash_attention_fwd(q, k, v, seg, causal)
    return q, k, v, seg, do, o, lse, tfa.attention_delta(o, do)


@pytest.mark.gpu
@_DIMS
@_SEQS
@_DTYPES
@_VARIANTS
def test_flash_bwd_kernels_match_plain(S, dtype, segments, D, hkv, causal):
    dev = _cuda()
    q, k, v, seg, do, o, lse, delta = _bwd_inputs(dev, dtype, S, segments,
                                                  D, hkv, causal)
    before = (tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg,
                                         causal)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, seg, causal)
    for name, g, w in zip("QKV", (dq, dk, dv), want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if S == 1 and name != "V":
            # One key per query: P = 1, O = V and dS = dP - delta = 0 in
            # exact arithmetic, so dQ and dK are the fp32 rounding residue
            # of dP - delta on both sides. Held to zero within 1e-5 of the
            # largest term they sum (D products |dO| |V|, times |Q| or |K|
            # and the 1/sqrt(D) scale).
            term = (D ** 0.5 * do.float().abs().max() * v.float().abs().max()
                    * max(q.float().abs().max(), k.float().abs().max()))
            for x in (g, w):
                assert x.float().abs().max() <= 1e-5 * term
        elif dtype == torch.bfloat16:
            _ulp_close(g, w)
        else:
            _close(g, w, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [False, True])
def test_flash_bwd_dkv_bf16_is_deterministic(segments):
    """K3 sums each group's q-heads in registers with no atomics: two
    runs on the same inputs give the same bits (the resumed training run
    relies on it)."""
    dev = _cuda()
    q, k, v, seg, do, _, lse, delta = _bwd_inputs(
        dev, torch.bfloat16, 1000, segments, 128, 1, True)
    first = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg)
    second = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [False, True])
def test_flash_bwd_dq_bf16_is_deterministic(segments):
    """K4 owns each q tile's dQ rows and sums them in registers with no
    atomics: two runs on the same inputs give the same bits."""
    dev = _cuda()
    q, k, v, seg, do, _, lse, delta = _bwd_inputs(
        dev, torch.bfloat16, 1000, segments, 128, 1, True)
    first = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg)
    second = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [False, True])
def test_flash_bwd_bf16_at_training_geometry(segments):
    """K3 and K4 at llama3-1b's attention geometry (S 2048, 16 q-heads
    over 8 kv-heads, head_dim 128), batch 1, under the bf16-ulp rule."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, H, Hkv, D = 1, 2048, 16, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, k, v, do = randn(B, S, H, D), randn(B, S, Hkv, D), \
        randn(B, S, Hkv, D), randn(B, S, H, D)
    seg = None
    if segments:
        cuts = torch.rand((B, S), generator=gen, device=dev) < 4.0 / S
        seg = cuts.int().cumsum(dim=1).to(torch.int32)
    o, lse = tfa.flash_attention_fwd(q, k, v, seg)
    delta = tfa.attention_delta(o, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg)
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv),
                    tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, seg)):
        _ulp_close(g, w)


def _einsum_attention(q, k, v, segment_ids=None):
    """Causal attention by einsum on GQA-expanded K/V; autograd
    differentiates it, independently of the kernels' formula."""
    rep = q.shape[2] // k.shape[2]
    return tattn.xla_attention(q, tattn.repeat_kv(k, rep),
                               tattn.repeat_kv(v, rep), causal=True,
                               segment_ids=segment_ids)


@pytest.mark.gpu
def test_flash_attention_function_runs_the_kernels_on_card():
    """FlashAttention's backward through K3/K4 against autograd through
    einsum attention, float32 on the card."""
    dev = _cuda()
    q, k, v, seg = _flash_inputs(dev, torch.float32, 256, True, 64)
    g = torch.randn(q.shape, device=dev)
    grads = {}
    for ref in (False, True):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        counts = (tfa.flash_attention_bwd_dkv.launches,
                  tfa.flash_attention_bwd_dq.launches)
        if ref:
            _einsum_attention(*xs, seg).backward(g)
        else:
            tfa.FlashAttention.apply(*xs, seg, True).backward(g)
        ran = (tfa.flash_attention_bwd_dkv.launches > counts[0],
               tfa.flash_attention_bwd_dq.launches > counts[1])
        assert ran == ((False, False) if ref else (True, True))
        grads[ref] = [x.grad for x in xs]
    for a, b in zip(grads[False], grads[True]):
        _close(a, b, 1e-4)


@pytest.mark.gpu
def test_flash_bwd_wrappers_raise_instead_of_falling_back():
    dev = _cuda()
    q, k, v, _ = _flash_inputs(dev, torch.float32, 128, False, 64)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    delta = tfa.attention_delta(o, o)
    with pytest.raises(TypeError):                  # f16 lse
        tfa.flash_attention_bwd_dq(q, k, v, o, lse.half(), delta)
    with pytest.raises(ValueError):                 # strided dO
        t = torch.zeros((2, 4, 128, 64), device=dev).transpose(1, 2)
        tfa.flash_attention_bwd_dkv(q, k, v, t, lse, delta)
    with pytest.raises(ValueError):                 # dO of another dtype
        tfa.flash_attention_bwd_dkv(q, k, v, o.bfloat16(), lse, delta)


@pytest.mark.gpu
def test_train_step_gradients_match_plain_path_on_card():
    """llama3-tiny in float32 on the card: a packed batch's loss and
    gradients through the kernels equal those of autograd through
    einsum attention within 1e-4 of each gradient's largest magnitude."""
    import dataclasses
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.train import trainer as tt
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=torch.float32,
                              xent_chunk=32)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    docs = ip.synthetic_doc_stream(40, cfg.vocab_size, mean_len=30)
    batch = ip.to_device(next(ip.packed_batches(docs, 2, 128)), dev)

    got = tt.grads_of(params, batch, cfg)
    want = tt.grads_of(params, batch, cfg, attention=_einsum_attention)
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * want[0].item()
    for a, b in zip(got[2], want[2]):
        _close(a, b, 1e-4)


@pytest.mark.gpu
def test_qlora_step_gradients_match_plain_path_on_card():
    """One float32 QLoRA step at llama3-8b width (2 layers, 32/8 heads,
    head_dim 128) over a random int8 base, a packed batch of 2 x 2048,
    rank-16 adapters with B drawn nonzero: the loss through the kernels
    within 1e-5 relative of autograd through einsum attention, each
    adapter gradient within 1e-4 of its largest magnitude; the step
    then updates the adapters in place on the card."""
    import dataclasses
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.train import lora as tlora
    from skypilot_tpu_torch.train import qlora as tqlora
    from skypilot_tpu_torch.train import trainer as tt
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-8b"], n_layers=2,
                              dtype=torch.float32, xent_chunk=512)
    lc = tlora.LoRAConfig(rank=16)
    gen = torch.Generator(device=dev).manual_seed(0)
    tc = tt.TrainConfig(warmup_steps=1, total_steps=4)
    state = tqlora.create_qlora_state(cfg, lc, tc, dev)
    for ab in state["params"].values():
        ab["b"].normal_(0.0, 0.01, generator=gen)
    fp, qw = tkv.random_quantized_params(cfg, seed=0, device=dev)
    docs = ip.synthetic_doc_stream(64, cfg.vocab_size, mean_len=600)
    batch = ip.to_device(next(ip.packed_batches(docs, 2, 2048)), dev)

    def grads(attention):
        return tt.value_and_grads(state["params"], lambda a: tqlora.loss_fn(
            qw, fp, a, batch, cfg, lc, attention=attention))

    got, want = grads(None), grads(_einsum_attention)
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * want[0].item()
    for a, b in zip(got[2], want[2]):
        _close(a, b, 1e-4)
    before = tfa.flash_attention_bwd_dq.launches
    step = tqlora.make_qlora_train_step(cfg, lc, tc)
    for _ in range(2):          # the first step's learning rate is 0
        state, m = step(state, qw, fp, batch)
    assert tfa.flash_attention_bwd_dq.launches - before == 4
    assert state["step"] == 2 and torch.isfinite(m["grad_norm"])
    assert abs(m["loss"].item() - got[0].item()) <= 1e-5 * got[0].item()


# -- K1: paged attention ----------------------------------------------------

# Slot lengths of the K1 cases: empty, one row, partial, one long enough
# to span many of the kernel's chunks, and one whose table holds a
# sentinel inside its length (_PAGED_HOLE: slot, table column).
_PAGED_LENGTHS = (0, 1, 300, 4100, 2000)
_PAGED_HOLE = (4, 3)


def _paged_inputs(dev, kv_dtype, hd=128, R=4, bl=64, seed=0, G=2,
                  lengths=_PAGED_LENGTHS):
    """Inputs of K1 over a 2-layer pool of ``G`` kv-heads holding every
    slot's blocks in scattered order; the table's last column is the
    sentinel."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = 2
    lengths = list(lengths)
    B = len(lengths)
    nb = -(-max(lengths) // bl)
    n = sum(-(-m // bl) for m in lengths) + 1
    shape = (L, n, bl, G, hd)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = (torch.rand((L, n, G, bl), generator=gen, device=dev)
              * 0.02 + 1e-3).bfloat16()
        vs = (torch.rand((L, n, G, bl), generator=gen, device=dev)
              * 0.02 + 1e-3).bfloat16()
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    q = torch.randn((B, G, R, hd), generator=gen, device=dev).to(q_dtype)
    perm = torch.randperm(n, generator=gen, device=dev).tolist()
    table = torch.full((B, nb + 1), n, dtype=torch.int32)
    for b, m in enumerate(lengths):
        have = -(-m // bl)
        table[b, :have] = torch.tensor(perm[:have])
        perm = perm[have:]
    table[_PAGED_HOLE] = n
    return (q, kp, vp, ks, vs, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


_POOLS = pytest.mark.parametrize(
    "kv_dtype", [torch.float32, torch.bfloat16, torch.int8],
    ids=["f32", "bf16", "int8"])


@pytest.mark.gpu
@_POOLS
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("bl", [16, 64, 256])
@pytest.mark.parametrize("span", ["full", "short"])
def test_paged_kernel_matches_plain(kv_dtype, hd, R, bl, span):
    """K1 against its plain version: the full span, or one that stops
    short of the longer slots' lengths; length-0 slots exactly."""
    dev = _cuda()
    args = _paged_inputs(dev, kv_dtype, hd, R, bl)
    span_blocks = -(-(max(_PAGED_LENGTHS) if span == "full" else 1000)
                    // bl)
    layer = 1
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args, layer, span_blocks=span_blocks)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    want = tpa.paged_attention_ref(*args, layer, span_blocks)
    live = args[-1] > 0
    for g, w in zip(got, want):
        _close(g[live], w[live], 2e-3)
    assert torch.all(got[0][~live] == 0)
    assert torch.all(got[1][~live] == -1e30)
    assert torch.all(got[2][~live] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_kernel_is_deterministic(kv_dtype):
    """The chunks of a slot are merged in chunk order whichever finishes
    last: two calls give the same bits."""
    dev = _cuda()
    args = _paged_inputs(dev, kv_dtype, 128, 4, 256)
    span_blocks = -(-max(_PAGED_LENGTHS) // 256)
    first = tpa.paged_attention(*args, 0, span_blocks=span_blocks)
    second = tpa.paged_attention(*args, 0, span_blocks=span_blocks)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_paged_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    q, kp, vp, _, _, table, lengths = _paged_inputs(dev, torch.bfloat16)
    with pytest.raises(TypeError):                  # int64 table
        tpa.paged_attention(q, kp, vp, None, None, table.long(), lengths,
                            0, span_blocks=1)
    with pytest.raises(ValueError):                 # int8 without scales
        tpa.paged_attention(q, kp.to(torch.int8), vp.to(torch.int8), None,
                            None, table, lengths, 0, span_blocks=1)
    with pytest.raises(ValueError):                 # a CPU table
        tpa.paged_attention(q, kp, vp, None, None, table.cpu(), lengths,
                            0, span_blocks=1)
    with pytest.raises(ValueError):                 # layer out of range
        tpa.paged_attention(q, kp, vp, None, None, table, lengths,
                            kp.shape[0], span_blocks=1)


# -- K1 on the engine's layout: the trash block, shared prefix blocks --------

def _shared_inputs(dev, kv_dtype, hd, R, bl, lengths, shared, seed=0):
    """K1 inputs in the engine's layout with prefix sharing: a 2-layer
    pool of real blocks plus the trash block (id ``n``, the sentinel of
    every table entry past a slot's allocation, filled with 100.0, so a
    leak shows at once); slots 0 and 1 map the same first ``shared``
    physical blocks (two requests on one cached prefix), each with its
    own blocks after them; every slot's allocation covers its length
    plus 64 rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, G = 2, 2
    alloc = [-(-(m + 64) // bl) for m in lengths]
    own = [a - (shared if b < 2 else 0) for b, a in enumerate(alloc)]
    n = shared + sum(own)
    shape = (L, n + 1, bl, G, hd)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks, vs = ((torch.rand((L, n + 1, G, bl), generator=gen, device=dev)
                   * 0.02 + 1e-3).bfloat16() for _ in range(2))
        ks[:, n] = 1.0
        vs[:, n] = 1.0
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    kp[:, n] = 100
    vp[:, n] = 100
    q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    q = torch.randn((len(lengths), G, R, hd), generator=gen,
                    device=dev).to(q_dtype)
    perm = torch.randperm(n, generator=gen, device=dev).tolist()
    prefix, perm = perm[:shared], perm[shared:]
    nb = max(alloc) + 2
    table = torch.full((len(lengths), nb + 1), n, dtype=torch.int32)
    for b, have in enumerate(own):
        row = (prefix if b < 2 else []) + perm[:have]
        perm = perm[have:]
        table[b, :len(row)] = torch.tensor(row)
    return (q, kp, vp, ks, vs, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


# Slots 0 and 1 share a cached prefix (both past it: decoding after a
# warm hit), slot 2 is empty, slot 3 holds one row, slot 4 spans many of
# the decode body's chunks.
_SHARED_LENGTHS = (600, 530, 0, 1, 4100)


@pytest.mark.gpu
@_POOLS
@pytest.mark.parametrize("hd,R", [(32, 2), (128, 4), (64, 8)])
@pytest.mark.parametrize("bl", [16, 64, 256])
def test_paged_decode_on_the_engine_layout_with_shared_blocks(kv_dtype, hd,
                                                              R, bl):
    """K1's decode body on the engine's own layout: the sentinel is the
    trash block inside the pool (filled with 100.0 past every slot's
    allocation) and two slots' table rows name the same physical blocks;
    the full span and a short one, against the plain version under K1's
    rule, length-0 slots exactly, equal bits on a second call (the
    per-(slot, kv-head) merge counters do not care that blocks alias)."""
    dev = _cuda()
    shared = 512 // bl
    args = _shared_inputs(dev, kv_dtype, hd, R, bl, _SHARED_LENGTHS, shared)
    assert torch.equal(args[5][0, :shared], args[5][1, :shared])
    assert int(args[5][0, -1]) == args[1].shape[1] - 1     # the trash id
    for span_blocks in (args[5].shape[1] - 1, -(-1000 // bl)):
        before = tpa.paged_attention.launches
        got = tpa.paged_attention(*args, 1, span_blocks=span_blocks)
        again = tpa.paged_attention(*args, 1, span_blocks=span_blocks)
        torch.cuda.synchronize()
        assert tpa.paged_attention.launches == before + 2
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        want = tpa.paged_attention_ref(*args, 1, span_blocks)
        live = args[-1] > 0
        for g, w in zip(got, want):
            _close(g[live], w[live], 2e-3)
        assert torch.all(got[0][~live] == 0)
        assert torch.all(got[1][~live] == -1e30)
        assert torch.all(got[2][~live] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.int8)], ids=["bf16", "bf16q-f32kv", "int8"])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("bl", [16, 64, 256])
def test_paged_rows_at_a_warm_start_over_shared_blocks(q_dtype, kv_dtype,
                                                       hd, bl):
    """K1's multi-row bodies at a warm chunk's start: two slots whose
    first blocks are one cached prefix, each starting its suffix chunk at
    row 512 (a hit on a 512-token prefix), the trash block filled with
    100.0 past the allocations; each slot alone (the chunk path's one-row
    table) and both in one call, against the plain version under K1's
    rule, on the body the dtypes and block length pick."""
    dev = _cuda()
    shared = 512 // bl
    args = _shared_inputs(dev, kv_dtype, hd, 512, bl, (512, 512), shared)
    q, kp, vp, ks, vs, table, lengths = args
    if q_dtype != q.dtype:
        q = q.to(q_dtype)
    span_blocks = 512 // bl
    _check_rows((q, kp, vp, ks, vs, table, lengths), 0, span_blocks)
    for slot in (0, 1):
        one = (q[slot:slot + 1].contiguous(), kp, vp, ks, vs,
               table[slot:slot + 1].contiguous(), lengths[slot:slot + 1])
        _check_rows(one, 0, span_blocks)


# -- K1's multi-row bodies (chunked prefill) --------------------------------

# The engine's layout at max_len 1024: a pool of real blocks plus the trash
# block, whose id is the sentinel of every table entry past a slot's
# allocation. Slot 0 holds the chunk's resident rows (its length is the
# chunk's start) and allocated rows past them; slot 1 is empty; slot 2's
# length runs past the span.
_ROWS_MAX_LEN = 1024
_ROWS_SPAN = 512


def _rows_inputs(dev, q_dtype, kv_dtype, hd, R, bl, start, seed=0,
                 max_len=_ROWS_MAX_LEN, G=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = 2
    nb = max_len // bl
    lengths = [start, 0, 700]
    alloc = [-(-(start + 64) // bl), 2, -(-700 // bl)]
    n = sum(alloc)
    trash = n
    shape = (L, n + 1, bl, G, hd)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        sshape = (L, n + 1, G, bl)
        ks = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              + 1e-3).bfloat16()
        vs = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              + 1e-3).bfloat16()
        ks[:, trash] = 1.0
        vs[:, trash] = 1.0
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    # Rows no mask admits hold large values: a leak shows at once.
    kp[:, trash] = 100
    vp[:, trash] = 100
    q = torch.randn((len(lengths), G, R, hd), generator=gen,
                    device=dev).to(q_dtype)
    perm = torch.randperm(n, generator=gen, device=dev).tolist()
    table = torch.full((len(lengths), nb + 1), trash, dtype=torch.int32)
    for b, have in enumerate(alloc):
        table[b, :have] = torch.tensor(perm[:have])
        perm = perm[have:]
    return (q, kp, vp, ks, vs, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


_ROWS_DTYPES = pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.bfloat16, torch.int8)],
    ids=["bf16", "bf16q-f32kv", "f32", "int8"])


def _rows_launches():
    return (tpa.paged_attention_rows.launches,
            tpa.paged_attention_rows.mma_launches)


def _check_rows(args, layer, span_blocks):
    """One multi-row call against the plain version under K1's rule;
    length-0 slots exactly; one launch, of the body the dtypes and the
    block length pick (the wgmma body for bf16 q on bf16 or int8 pools
    with blocks of 8, 16, 32 or a multiple of 64, else mma.sync)."""
    before = _rows_launches()
    got = tpa.paged_attention_rows(*args, layer, span_blocks=span_blocks)
    torch.cuda.synchronize()
    q, kp = args[0], args[1]
    bl = kp.shape[2]
    tma = (q.dtype == torch.bfloat16 and kp.dtype != torch.float32
           and (bl % 64 == 0 or bl in (8, 16, 32)))
    after = _rows_launches()
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((1, 0) if tma else (0, 1))
    want = tpa.paged_attention_ref(*args, layer, span_blocks)
    live = args[-1] > 0
    for g, w in zip(got, want):
        _close(g[live], w[live], 2e-3)
    assert torch.all(got[0][~live] == 0)
    assert torch.all(got[1][~live] == -1e30)
    assert torch.all(got[2][~live] == 0)


@pytest.mark.gpu
@_ROWS_DTYPES
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("R", [64, 512, 1052, 2048])
@pytest.mark.parametrize("bl", [8, 16, 32, 64, 256])
@pytest.mark.parametrize("start", [0, 1, 255, 256, 512])
def test_paged_rows_kernel_matches_plain(q_dtype, kv_dtype, hd, R, bl,
                                         start):
    """The multi-row bodies against the plain version under K1's rule,
    at every head dim they take (32 is llama3-tiny's) and every block
    length the wgmma body loads (8, 16 and 32 several blocks a 64-key
    tile, 64 and 256 one), the engine's sentinel (the trash block,
    inside the pool) past every length, R not a multiple of the 128-row
    tile (1052, the 775-token prompt's last chunk); length-0 slots
    exactly."""
    dev = _cuda()
    args = _rows_inputs(dev, q_dtype, kv_dtype, hd, R, bl, start)
    _check_rows(args, 1, _ROWS_SPAN // bl)


@pytest.mark.gpu
@_ROWS_DTYPES
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("R", [64, 2048])
def test_paged_rows_kernel_matches_plain_long_span(q_dtype, kv_dtype, hd,
                                                   R):
    """A long prompt's chunk: start 3584 over a 4096-row span of blocks
    of 256 (the engine's rung at max_len 8192)."""
    dev = _cuda()
    args = _rows_inputs(dev, q_dtype, kv_dtype, hd, R, 256, 3584,
                        max_len=8192)
    _check_rows(args, 1, 4096 // 256)


@pytest.mark.gpu
@_ROWS_DTYPES
@pytest.mark.parametrize("start,span", [(512, 512), (3584, 4096)],
                         ids=["serve", "long"])
def test_paged_rows_kernel_is_deterministic(q_dtype, kv_dtype, start,
                                            span):
    """No split across the sweep and no atomics: equal bits on a second
    call at the serve chunk's row count, at the serve chunk and at a
    long prompt's."""
    dev = _cuda()
    args = _rows_inputs(dev, q_dtype, kv_dtype, 128, 2048, 256, start,
                        max_len=max(_ROWS_MAX_LEN, 2 * span))
    first = tpa.paged_attention_rows(*args, 0, span_blocks=span // 256)
    second = tpa.paged_attention_rows(*args, 0, span_blocks=span // 256)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_paged_attention_dispatches_by_rows():
    """paged_attention keeps the decode body up to R*hd 4096 and runs
    the multi-row bodies above it, each counting its own launches; an
    int8 pool above it runs the wgmma body and matches the plain
    version, and a float32 q on an int8 pool raises the typed error."""
    dev = _cuda()
    for R, rows in ((32, False), (33, True)):
        args = _rows_inputs(dev, torch.bfloat16, torch.bfloat16, 128, R,
                            64, 255)
        d0 = tpa.paged_attention.launches
        r0 = tpa.paged_attention_rows.launches
        got = tpa.paged_attention(*args, 0, span_blocks=8)
        want = tpa.paged_attention_ref(*args, 0, 8)
        torch.cuda.synchronize()
        assert (tpa.paged_attention.launches - d0,
                tpa.paged_attention_rows.launches - r0) == \
            ((0, 1) if rows else (1, 0))
        live = args[-1] > 0
        for g, w in zip(got, want):
            _close(g[live], w[live], 2e-3)
    args = _rows_inputs(dev, torch.bfloat16, torch.int8, 128, 64, 64, 255)
    r0 = tpa.paged_attention_rows.launches
    got = tpa.paged_attention(*args, 0, span_blocks=8)
    want = tpa.paged_attention_ref(*args, 0, 8)
    torch.cuda.synchronize()
    assert tpa.paged_attention_rows.launches - r0 == 1
    live = args[-1] > 0
    for g, w in zip(got, want):
        _close(g[live], w[live], 2e-3)
    q, *rest = args
    with pytest.raises(tpa.Int8RowsUnsupportedError):
        tpa.paged_attention(q.float(), *rest, 0, span_blocks=8)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype,bl,body", [
    (torch.bfloat16, torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, torch.int8, 8, "wgmma"),
    (torch.bfloat16, torch.int8, 32, "wgmma"),
    (torch.bfloat16, torch.int8, 256, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 48, "mma"),
    (torch.bfloat16, torch.bfloat16, 24, "mma"),
    (torch.bfloat16, torch.bfloat16, 96, "mma"),
    (torch.bfloat16, torch.float32, 64, "mma"),
    (torch.bfloat16, torch.float32, 256, "mma"),
    (torch.float32, torch.float32, 256, "mma"),
    (torch.float32, torch.bfloat16, 256, "mma")],
    ids=lambda v: str(v).replace("torch.", ""))
def test_paged_rows_dispatch_by_dtype_and_block_length(q_dtype, kv_dtype,
                                                       bl, body):
    """Which multi-row body runs, by dtypes and block length alone, and
    which counter moves: the wgmma body for a bf16 q on bf16 or int8
    pools with blocks of 8, 16, 32 or a multiple of 64; the mma.sync
    body for float32 pools, a float32 q and any other block length
    (48, 24, 96). Each result matches the plain version."""
    dev = _cuda()
    args = _rows_inputs(dev, q_dtype, kv_dtype, 64, 512, bl, 255)
    before = _rows_launches()
    got = tpa.paged_attention_rows(*args, 0, span_blocks=_ROWS_SPAN // bl)
    torch.cuda.synchronize()
    after = _rows_launches()
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((1, 0) if body == "wgmma" else (0, 1))
    want = tpa.paged_attention_ref(*args, 0, _ROWS_SPAN // bl)
    live = args[-1] > 0
    for g, w in zip(got, want):
        _close(g[live], w[live], 2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,bl", [
    (torch.float32, 64), (torch.float32, 256), (torch.bfloat16, 48),
    (torch.bfloat16, 24)], ids=["f32q-bl64", "f32q-bl256", "bl48", "bl24"])
def test_paged_rows_int8_without_a_body_raises(q_dtype, bl):
    """An int8 pool that no multi-row body takes (a float32 q, or a
    block length the wgmma body refuses) raises the typed error and
    launches nothing; no body stands in for the other."""
    dev = _cuda()
    args = _rows_inputs(dev, q_dtype, torch.int8, 64, 512, bl, 255)
    before = _rows_launches()
    with pytest.raises(tpa.Int8RowsUnsupportedError):
        tpa.paged_attention_rows(*args, 0, span_blocks=_ROWS_SPAN // bl)
    assert _rows_launches() == before


# -- the engine on the card -------------------------------------------------

@pytest.mark.gpu
def test_engine_kernel_path_matches_plain_path_on_card():
    """llama3-tiny in float32 on the card: the kernel engine's greedy
    tokens equal the plain-attention engine's, and both kernels ran."""
    import dataclasses
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 11, 3, 20, 30, 9, 17)]
    out = {}
    for plain in (False, True):
        e = te.InferenceEngine(params, cfg, n_slots=4, max_len=64,
                               prompt_buckets=(16, 32), kv_block=16,
                               max_wave=2, device=dev,
                               plain_attention=plain)
        f0 = tfa.flash_attention_fwd.launches
        p0 = tpa.paged_attention.launches
        out[plain] = e.generate(prompts, max_new_tokens=10)
        ran = (tfa.flash_attention_fwd.launches > f0,
               tpa.paged_attention.launches > p0)
        assert ran == ((False, False) if plain else (True, True))
    assert out[False] == out[True]


@pytest.mark.gpu
def test_moe_engine_kernel_path_matches_plain_path_on_card():
    """moe-tiny in float32 on the card (capacity 1.25, so tokens drop):
    the kernel engine's greedy tokens equal the plain-attention engine's
    over waves, chunks of 128 (256 query rows a kv-head: K1's multi-row
    body) and n-gram verify rounds, with the trash block filled with
    100.0 (a read past a slot's rows shows at once); K1's decode and
    ``mma.sync`` multi-row bodies and K2 ran."""
    import dataclasses
    from skypilot_tpu_torch.models import moe as tm
    dev = _cuda()
    cfg = dataclasses.replace(tm.CONFIGS["moe-tiny"], dtype=torch.float32)
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 11, 3, 20, 30, 9, 200, 300)]
    prompts.append(prompts[0] + [7, 8, 9] + prompts[0])
    out = {}
    for plain in (False, True):
        e = te.InferenceEngine(params, cfg, n_slots=4, max_len=512,
                               prompt_buckets=(32, 128, 512), kv_block=16,
                               prefill_chunk=128, spec_k=4, max_wave=2,
                               device=dev, plain_attention=plain)
        _fill_trash(e)
        before = (tfa.flash_attention_fwd.launches,
                  tpa.paged_attention.launches,
                  tpa.paged_attention_rows.mma_launches)
        out[plain] = e.generate(prompts, max_new_tokens=10)
        ran = (tfa.flash_attention_fwd.launches > before[0],
               tpa.paged_attention.launches > before[1],
               tpa.paged_attention_rows.mma_launches > before[2])
        assert ran == ((False,) * 3 if plain else (True,) * 3)
    assert out[False] == out[True]


# llama3-tiny's bf16 logits differ from its float32 ones by at most ~0.05
# on these prompts (the plain path on the CPU); the kernel and plain bf16
# paths round at mostly the same places and differ by less. A broken
# kernel parts the paths at the first token, on gaps of order 1.
_BF16_TIE_GAP = 0.1


def _first_divergence(params, cfg, dev, prompt, got, want):
    """The first step where greedy tokens ``got`` and ``want`` differ,
    with the plain path's top-2 logit gap on the context they share
    there: (step, gap), or (None, None) when they agree throughout."""
    for t, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        ctx = list(prompt) + list(want[:t])
        toks = torch.tensor([ctx], dtype=torch.long, device=dev)
        lens = torch.tensor([len(ctx)], device=dev)
        _, logits = tkv.prefill_batch(params, toks, lens, cfg,
                                      plain_attention=True)
        top2 = logits[0].float().topk(2).values
        return t, (top2[0] - top2[1]).item()
    return None, None


def _int8_plain_logits(params, qweights, cfg, dev, ctx, bl=256):
    """The plain path's logits after ``ctx`` as an int8 KV engine's decode
    reads them: ``ctx[:-1]`` prefilled and inserted (quantized) into a
    one-slot int8 cache, then ``kvcache.step_logits`` for ``ctx[-1]``."""
    n, nb = len(ctx) - 1, -(-len(ctx) // bl)
    cache = tkv.init_paged_cache(cfg, 1, nb, bl, dev, kv_int8=True)
    table = torch.arange(nb + 1, dtype=torch.int32, device=dev)[None]
    prefix, _ = tkv.prefill_batch(
        params, torch.tensor([ctx[:-1]], device=dev),
        torch.tensor([n], device=dev), cfg, plain_attention=True,
        qweights=qweights)
    tkv.insert(cache, {k: prefix[k][:, 0] for k in ("k", "v")}, 0, n,
               ctx[-1], table)
    return tkv.step_logits(params, cache, cfg, table, plain_attention=True,
                           qweights=qweights)


def _plain_gap(params, qweights, cfg, dev, ctx):
    """The int8 KV plain path's top-2 logit gap after ``ctx`` and its
    noise floor: 0 on float weights; on w8a8 ones the logits' largest
    shift when the embedding moves by two float32 ulps (w8a8 rounds every
    projection's activations to int8, so noise of summation-order size
    flips some roundings and moves its logits by this much)."""
    out = [_int8_plain_logits(dict(params, embed=params["embed"] * s),
                              qweights, cfg, dev, ctx)
           for s in ((1.0, 1 + 2.0 ** -22) if qweights else (1.0,))]
    top2 = out[0][0].topk(2).values
    noise = (out[-1] - out[0]).abs().max().item()
    return (top2[0] - top2[1]).item(), noise


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_engine_chunk_path_matches_plain_path_on_card(dtype):
    """llama3-tiny (head_dim 32) with chunks of 128 (R = 128 * rep rows a
    kv-head): the kernel engine's chunk counts equal the plain-attention
    engine's, and its chunks run the multi-row body its pools pick, the
    mma.sync body on float32 pools and the wgmma body on bf16 ones. In
    float32 the greedy tokens are equal. In bf16 the two paths round
    other intermediates to bf16 (the flash forward kernel rounds P), so
    they may part on a near-tie: the tokens agree up to the first step
    where they differ, and there the plain logits' top-2 gap is at most
    _BF16_TIE_GAP."""
    import dataclasses
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (200, 40, 129, 256 - 8, 90)]
    out = {}
    for plain in (False, True):
        e = te.InferenceEngine(params, cfg, n_slots=3, max_len=256,
                               prompt_buckets=(64, 256), kv_block=16,
                               prefill_chunk=128, device=dev,
                               plain_attention=plain)
        r0 = _rows_launches()
        toks = e.generate(prompts, max_new_tokens=8)
        r1 = _rows_launches()
        moved = (r1[0] > r0[0], r1[1] > r0[1])
        if plain:
            assert moved == (False, False)
        else:
            assert moved == ((False, True) if dtype == torch.float32
                             else (True, False))
        out[plain] = (toks, sorted((r.rid, r.n_chunks) for r in e.finished))
    assert out[False][1] == out[True][1]
    assert [c for _, c in out[True][1]] == [2, 0, 2, 2, 0]
    if dtype == torch.float32:
        assert out[False][0] == out[True][0]
        return
    for p, got, want in zip(prompts, out[False][0], out[True][0]):
        t, gap = _first_divergence(params, cfg, dev, p, got, want)
        assert t is None or gap <= _BF16_TIE_GAP, (t, gap)


def _replay_drafter(outputs):
    """An oracle drafter: replays each prompt's known continuation."""

    class Replay:
        def __init__(self, req):
            self.out = outputs[tuple(req.prompt)]
            self.seen = 0

        def catch_up(self, prompt, generated):
            self.seen = len(generated)

        def draft(self, k):
            return list(self.out[self.seen:self.seen + k])

    return Replay


@pytest.mark.gpu
def test_engine_spec_and_prefix_on_card(monkeypatch):
    """llama3-tiny in float32 on the card, kernel path: with an oracle
    drafter every verify position accepts, and the spec tokens equal the
    spec-off tokens (where they part, only on a near-tie: the plain top-2
    gap at most 1e-2, the smoke's rule; a verify round splits the staged
    and cached columns at other rows than a plain burst); the verify
    rounds launch K1's decode body and never its plain version. A warm
    prefix hit (chunks of 128 over blocks of 16, the hit at row 128)
    gives the cold run's tokens exactly."""
    import dataclasses
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 90, 13)]

    def engine(**kw):
        return te.InferenceEngine(params, cfg, n_slots=3, max_len=256,
                                  prompt_buckets=(64, 256), kv_block=16,
                                  prefill_chunk=128, device=dev, **kw)

    want = engine().generate(prompts, max_new_tokens=24)
    oracle = {tuple(p): w for p, w in zip(prompts, want)}
    plain_calls = []
    real_ref = tpa.paged_attention_ref
    monkeypatch.setattr(tpa, "paged_attention_ref",
                        lambda *a, **kw: plain_calls.append(1)
                        or real_ref(*a, **kw))
    e = engine(spec_k=4, spec_drafter=_replay_drafter(oracle))
    d0 = tpa.paged_attention.launches
    got = e.generate(prompts, max_new_tokens=24)
    assert e.verify_calls > 0 and not plain_calls
    assert tpa.paged_attention.launches - d0 >= \
        e.verify_calls * 5 * cfg.n_layers
    for p, g, w in zip(prompts, got, want):
        t, gap = _first_divergence(params, cfg, dev, p, g, w)
        assert t is None or gap <= 1e-2, (t, gap)
    if got == want:
        assert e._spec_accepted_total == e._spec_drafted_total > 0

    system = rng.integers(1, cfg.vocab_size, 150).tolist()
    pa, pb = system + [5, 6, 7], system + [9, 10]
    e = engine(prefix_pool=4)
    e.generate([pa], max_new_tokens=16)
    e.finished.clear()
    r0 = _rows_launches()
    warm = e.generate([pb], max_new_tokens=16)[0]
    assert e.finished[0].cached_len == 128 and e.prefix_hits == 1
    assert _rows_launches()[1] - r0[1] == cfg.n_layers     # one chunk
    e.finished.clear()
    e.clear_prefix_cache()
    assert warm == e.generate([pb], max_new_tokens=16)[0]
    assert not plain_calls


# -- the int8 recipe on the card --------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows,k,n", [(16, 4096, 14336), (16, 14336, 4096),
                                      (16, 4096, 1024), (1, 4096, 128256),
                                      (17, 4096, 4096), (32, 4096, 6144),
                                      (3, 128, 64), (512, 256, 512)],
                         ids=["decode-gate", "decode-down", "decode-kv",
                              "head-1row", "17rows", "32rows", "tiny-kv",
                              "tiny-chunk"])
def test_int8_matmul_on_card_is_exact(rows, k, n):
    """``torch._int_mm`` through the port's padding helper at llama3-8b's
    shapes: a 16-slot decode step's projections (16 rows, padded to 17),
    a final chunk's head (1 row over the 128256-token vocabulary) and
    unpadded row counts, on a weight that is one layer of a stacked
    tensor stored output-major, as the engine passes it; the int32
    product equals a float64 product of the same integers (exact below
    2**53) bit for bit."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(rows + k)
    a = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = tkv.int8_layout(torch.randint(-127, 128, (2, k, n), generator=gen,
                                      device=dev, dtype=torch.int8), 1, 1)
    got = tkv.int8_matmul(a, w[1])
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    want = (a.double() @ w[1].double()).long()
    assert torch.equal(got.long(), want)
    assert torch.equal(tkv.int8_matmul(a[:1], w[1]), got[:1])


def _hd128_config(dtype):
    """llama3-tiny's proportions at head_dim 128 (the served models'):
    d_model 512, 4 q-heads over 2 kv-heads, 2 layers."""
    import dataclasses
    return dataclasses.replace(tl.CONFIGS["llama3-tiny"], d_model=512,
                               n_heads=4, n_kv_heads=2, d_ff=512,
                               max_seq_len=1024, dtype=dtype)


def _fill_trash(engine):
    """The trash block (every table entry past an allocation) holds
    100.0: a row that leaks into a read shows at once."""
    n = engine.n_kv_blocks
    for name in ("k", "v"):
        engine.cache[name][:, n] = 100
        if name + "_scale" in engine.cache:
            engine.cache[name + "_scale"][:, n] = 100.0


@pytest.mark.gpu
@pytest.mark.parametrize("w8", [False, True], ids=["f32-weights", "w8a8"])
def test_engine_int8_chunk_and_burst_path_on_card(w8):
    """The int8 recipe's path at head_dim 128 with blocks of 256 on the
    engine's own layout (the trash block filled with 100.0): a 600-token
    prompt stores its first 512 tokens, a second prompt sharing them hits
    (two slots' tables name the same two blocks) and prefills its suffix
    at start 512. On that live cache K1's decode body (int8 pools) and
    its wgmma multi-row body (bf16 q on int8 pools) run as their dtypes
    pick them, equal bits on a second call and K1's rule against the
    plain version; the mma.sync body never runs. Then the kernel
    engine's float32 greedy tokens (int8 KV, spec K 4 with an oracle
    drafter, so verify rounds run) equal the plain-attention engine's
    spec-off tokens, or part only where the plain top-2 gap is at most
    1e-2 on float32 weights; on w8a8 weights at most the larger of 1e-2
    and the plain logits' own shift under two float32 ulps of input
    noise (``_plain_gap``; w8a8's activation rounding turns that noise
    into logit shifts of ~0.1)."""
    dev = _cuda()
    cfg = _hd128_config(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    qw = slim = None
    if w8:
        qw = {"blocks": tkv.quantize_block_weights(params),
              "head": tkv.quantize_head(params, cfg)}
        slim = tkv.slim_params(params)
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, 600).tolist()
    pa = system + rng.integers(1, cfg.vocab_size, 60).tolist()
    pb = system + rng.integers(1, cfg.vocab_size, 40).tolist()
    short = rng.integers(1, cfg.vocab_size, 90).tolist()

    def engine(plain, **kw):
        e = te.InferenceEngine(slim or params, cfg, n_slots=3, max_len=1024,
                               prompt_buckets=(128, 1024), kv_block=256,
                               prefill_chunk=512, prefix_pool=4,
                               kv_int8=True, qweights=qw, device=dev,
                               plain_attention=plain, **kw)
        _fill_trash(e)
        return e

    e = engine(False)
    assert e.cache["k"].dtype == torch.int8
    assert e.cache["k_scale"].dtype == torch.bfloat16
    e.add_request(pa, max_new_tokens=8)
    e.admit()
    while e.chunking:                 # pa stores its 512-token prefix
        e.prefill_chunk_step()
    e.add_request(pb, max_new_tokens=8)
    e.add_request(short, max_new_tokens=8)
    r0 = _rows_launches()
    e.admit()
    while e.chunking:
        e.prefill_chunk_step()
    assert _rows_launches()[0] - r0[0] == cfg.n_layers    # one warm chunk
    by_prompt = {len(r.prompt): r for r in e.slot_req.values()}
    cold, warm = by_prompt[len(pa)], by_prompt[len(pb)]
    assert warm.cached_len == 512 and e.cow_copies == 0
    table = e.table_device()
    lengths = e.cache["length"].clone()
    assert torch.equal(table[cold.slot, :2], table[warm.slot, :2])
    G, hd, rep = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    pools = (e.cache["k"], e.cache["v"], e.cache["k_scale"],
             e.cache["v_scale"])
    q = torch.randn((3, G, rep, hd), generator=gen, device=dev).bfloat16()
    qr = torch.randn((1, G, 512 * rep, hd), generator=gen,
                     device=dev).bfloat16()
    for fn, args, launches in (
            (tpa.paged_attention, (q, *pools, table, lengths),
             lambda: tpa.paged_attention.launches),
            (tpa.paged_attention_rows,
             (qr, *pools, table[warm.slot:warm.slot + 1].contiguous(),
              torch.full((1,), 512, dtype=torch.int32, device=dev)),
             lambda: _rows_launches()[0])):
        before, mma = launches(), _rows_launches()[1]
        got = fn(*args, 1, span_blocks=4)
        again = fn(*args, 1, span_blocks=4)
        torch.cuda.synchronize()
        assert launches() - before == 2 and _rows_launches()[1] == mma
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        want = tpa.paged_attention_ref(*args, 1, 4)
        live = args[-1] > 0
        for g, w in zip(got, want):
            _close(g[live], w[live], 2e-3)
    e.run_to_completion()
    assert not e.slot_req and not e.chunking

    prompts = [pa, pb, short]
    e = engine(True)
    want = [e.generate([p], max_new_tokens=24)[0] for p in prompts]
    assert e.prefix_hits == 1
    oracle = {tuple(p): w for p, w in zip(prompts, want)}
    e = engine(False, spec_k=4, spec_drafter=_replay_drafter(oracle))
    r0, d0 = _rows_launches(), tpa.paged_attention.launches
    got = [e.generate([p], max_new_tokens=24)[0] for p in prompts]
    r1 = _rows_launches()
    assert (r1[0] > r0[0], r1[1] > r0[1],
            tpa.paged_attention.launches > d0) == (True, False, True)
    assert e.prefix_hits == 1 and e.verify_calls > 0
    for p, g, w in zip(prompts, got, want):
        t = next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is not None:
            gap, noise = _plain_gap(slim or params, qw, cfg, dev, p + w[:t])
            assert gap <= max(1e-2, noise), (t, gap, noise)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16-kv", "int8-kv"])
def test_engine_at_max_len_1064_chunks_on_the_wgmma_body(kv_int8):
    """At max_len 1064 (prompts of up to 1024 tokens, 32 new, 8 spare:
    the serving bench's mixed prompts) the JAX engine's block is 152
    rows, which K1's wgmma multi-row body does not read: bf16 chunks
    would run the mma.sync body and int8 chunks would raise. On the card
    the engine takes blocks of 8, so a 900-token prompt prefills in two
    chunks of 512 through the wgmma body only, on bf16 pools (bf16
    weights) and on int8 pools (float32 weights, q cast to bf16 for the
    chunks). On int8 pools the greedy tokens equal the plain-attention
    engine's, or part only where the plain top-2 gap is at most 1e-2."""
    import dataclasses
    dev = _cuda()
    cfg = _hd128_config(torch.float32 if kv_int8 else torch.bfloat16)
    cfg = dataclasses.replace(cfg, max_seq_len=1064)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    prompt = np.random.default_rng(4).integers(
        1, cfg.vocab_size, 900).tolist()

    def engine(plain):
        e = te.InferenceEngine(params, cfg, n_slots=2, max_len=1064,
                               prompt_buckets=(512, 1024), kv_block=256,
                               prefill_chunk=512, kv_int8=kv_int8,
                               device=dev, plain_attention=plain)
        assert e.kv_block == 8 and e.blocks_per_slot == 133
        return e

    r0 = _rows_launches()
    got = engine(False).generate([prompt], max_new_tokens=32)[0]
    r1 = _rows_launches()
    assert (r1[0] - r0[0], r1[1] - r0[1]) == (2 * cfg.n_layers, 0)
    assert len(got) == 32
    if not kv_int8:
        return
    want = engine(True).generate([prompt], max_new_tokens=32)[0]
    t = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if t is not None:
        gap, _ = _plain_gap(params, None, cfg, dev, prompt + want[:t])
        assert gap <= 1e-2, (t, gap)


@pytest.mark.gpu
def test_engine_refuses_int8_kv_where_no_block_suits_k1():
    """A max_len that is not a multiple of 8 has no divisor that K1's
    wgmma multi-row body reads, the only body that reads int8 pools: the
    engine refuses an int8 KV cache there when it is built, not at its
    first chunk. A bf16 cache keeps the JAX engine's block."""
    dev = _cuda()
    cfg = _hd128_config(torch.bfloat16)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=cfg.dtype)
    kw = dict(n_slots=1, max_len=1001, prompt_buckets=(512,), kv_block=256,
              device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        te.InferenceEngine(params, cfg, kv_int8=True, **kw)
    assert te.InferenceEngine(params, cfg, **kw).kv_block == 143


# -- the cross-replica KV handoff on the card ---------------------------------

def _handoff_setup(dtype):
    """Weights at head_dim 128 in ``dtype``, a 600-token prompt, and a
    maker of one tier of a two-tier service: max_len 1024 over blocks
    of 256, chunks of 512, a prefix pool."""
    dev = _cuda()
    cfg = _hd128_config(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(4)

    def tier(plain=False, **kw):
        return te.InferenceEngine(params, cfg, n_slots=2, max_len=1024,
                                  prompt_buckets=(128, 1024), kv_block=256,
                                  prefill_chunk=512, prefix_pool=4,
                                  device=dev, plain_attention=plain, **kw)

    return dev, cfg, params, tier, rng.integers(1, cfg.vocab_size,
                                                600).tolist()


def _prefill_export(engine, prompt):
    """The prefill tier's half: one committed token, then the export
    through the wire (encoded, as JSON text, decoded)."""
    import json
    from skypilot_tpu_torch.infer import server as ts
    engine.add_request(prompt, 1)
    engine.run_to_completion()
    (req,) = engine.finished
    engine.finished.clear()
    export = engine.export_prefix_for(req)
    wire = ts.decode_export(json.loads(json.dumps(
        ts.encode_export(export))))
    return req.tokens, export, wire


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16-kv", "int8-kv"])
def test_handoff_wire_round_trip_is_bit_exact_on_card(kv_int8):
    """A 600-token prompt's stored 512-row prefix, exported from a bf16
    or int8 pool on the card, through the reference's wire (bf16 widened
    to float32; int8 rows with float32 scales) and imported into a
    second engine's pool: the imported blocks hold the prefill tier's
    bits, scales included."""
    dev, _, _, tier, prompt = _handoff_setup(torch.bfloat16)
    p, d = tier(kv_int8=kv_int8), tier(kv_int8=kv_int8)
    committed, export, wire = _prefill_export(p, prompt)
    assert (export["cached_len"], export["n_blocks"]) == (512, 2)
    want = {"k": "int8" if kv_int8 else "float32"}
    assert {n: str(a.dtype) for n, a in wire["tensors"].items()} == (
        {"k": want["k"], "v": want["k"], "k_scale": "float32",
         "v_scale": "float32"} if kv_int8 else
        {"k": "float32", "v": "float32"})
    assert d.import_prefix(prompt + committed, wire) == 512
    src = torch.tensor(p._prefix_index.lookup(prompt)[0], device=dev)
    dst = torch.tensor(d._prefix_index.lookup(prompt)[0], device=dev)
    assert d.blocks_used() == 2
    for name in p.cache:
        if name in ("length", "last_token"):
            continue
        assert d.cache[name].dtype == p.cache[name].dtype
        assert torch.equal(d.cache[name][:, dst], p.cache[name][:, src])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_resume_over_imported_blocks_on_card(dtype, monkeypatch):
    """The decode tier's resume over imported blocks, the trash block
    filled with 100.0: every K1 call of the resume (its final chunk on
    the multi-row body the pools pick, then decode on the decode body)
    agrees with K1's plain version on the same inputs under K1's rule
    (2e-3 of the largest magnitude, live slots); the resume reused the
    512 imported rows; in float32 its greedy tokens equal the
    plain-attention engine's resume, and the single-tier run's tokens
    or part from them only where the plain top-2 gap is at most 1e-2
    (the resume samples the committed token's successor from a chunk
    program, the single-tier run from a decode step)."""
    dev, cfg, params, tier, prompt = _handoff_setup(dtype)
    p = tier()
    committed, _, wire = _prefill_export(p, prompt)
    real = tkv._paged_attn_stats
    checked = []

    def held(cache, i, table, qh, lengths, span, plain=False):
        out = real(cache, i, table, qh, lengths, span, plain)
        if not plain:
            want = real(cache, i, table, qh, lengths, span, True)
            live = lengths > 0
            for g, w in zip(out, want):
                _close(g[live], w[live], 2e-3)
            checked.append(qh.shape[2])
        return out

    monkeypatch.setattr(tkv, "_paged_attn_stats", held)
    out = {}
    for plain in (False, True):
        d = tier(plain)
        _fill_trash(d)
        assert d.import_prefix(prompt + committed, wire) == 512
        r0, d0 = _rows_launches(), tpa.paged_attention.launches
        d.add_request(prompt, 24, committed=committed)
        d.run_to_completion()
        (req,) = d.finished
        assert req.resumed_len == 512 and d.prefix_hits == 1
        assert req.n_chunks == 1
        r1 = _rows_launches()
        ran = (r1[0] > r0[0], r1[1] > r0[1],
               tpa.paged_attention.launches > d0)
        assert ran == ((False, False, False) if plain else
                       (dtype == torch.bfloat16, dtype == torch.float32,
                        True))
        out[plain] = req.tokens
    rep = cfg.n_heads // cfg.n_kv_heads
    assert set(checked) == {512 * rep, rep}, set(checked)
    if dtype == torch.float32:
        assert out[False] == out[True]
        single = p.generate([prompt], 24)[0]
        t, gap = _first_divergence(params, cfg, dev, prompt, out[False],
                                   single)
        assert t is None or gap <= 1e-2, (t, gap)


# -- QoS preemption and lazy KV growth on the card ----------------------------

def _held_k1(checked, tag):
    """A ``kvcache._paged_attn_stats`` that runs the kernel and holds
    every kernel call with a slot of length > 0 (a first chunk at start
    0 reads nothing) to the plain version on the same inputs under K1's
    rule (2e-3 of the largest magnitude, those slots), recording
    (tag(), R, longest length) per call."""
    real = tkv._paged_attn_stats

    def held(cache, i, table, qh, lengths, span, plain=False):
        out = real(cache, i, table, qh, lengths, span, plain)
        live = lengths > 0
        if not plain and live.any():
            want = real(cache, i, table, qh, lengths, span, True)
            for g, w in zip(out, want):
                _close(g[live], w[live], 2e-3)
            checked.append((tag(), qh.shape[2], int(lengths.max())))
        return out

    return held


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_preempt_resume_on_card(dtype, monkeypatch):
    """A 600-token low-priority request on a one-slot QoS engine (max_len
    1024, blocks of 256, chunks of 512, a prefix pool) is preempted
    mid-decode by a priority-1 request: its committed rows retire into
    the prefix cache (512 rows, two blocks shared by reference) and it
    resumes with one chunk at start 512 over them. The trash
    block holds 100.0; every K1 call, the resume chunk's multi-row call
    included, agrees with the plain version under K1's rule; in float32
    the kernel engine's tokens equal the plain-attention engine's."""
    from skypilot_tpu_torch.infer import qos as tq
    dev = _cuda()
    cfg = _hd128_config(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size,
                                               600).tolist()
    phase = {"v": "admit"}
    checked = []
    monkeypatch.setattr(tkv, "_paged_attn_stats",
                        _held_k1(checked, lambda: phase["v"]))
    out = {}
    for plain in (False, True):
        e = te.InferenceEngine(
            params, cfg, n_slots=1, max_len=1024, prompt_buckets=(128, 1024),
            kv_block=256, kv_blocks=8, prefill_chunk=512, prefix_pool=4,
            device=dev, plain_attention=plain, qos=tq.FairScheduler())
        _fill_trash(e)
        rid = e.add_request(prompt, 24)
        while not e.slot_req:
            e.step_burst(max_burst=4)
        e.decode_burst(max_burst=4)
        e.add_request([3, 1, 4], 4, priority=1)
        phase["v"] = "preempted"
        e.run_to_completion(max_burst=4)
        phase["v"] = "admit"
        low = {r.rid: r for r in e.finished}[rid]
        assert (low.preemptions, low.resumed_len) == (1, 512)
        e.clear_prefix_cache()
        assert e.blocks_used() == 0
        out[plain] = low.tokens
    rep = cfg.n_heads // cfg.n_kv_heads
    resume = [c for c in checked if c[0] == "preempted" and c[1] > rep]
    assert resume and resume[0][2] == 512, checked
    if dtype == torch.float32:
        assert out[False] == out[True]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lazy_growth_on_card(dtype, monkeypatch):
    """Lazy KV growth on a pool of 16 blocks of 16 rows (max_len 256):
    a 190-token request grows its table burst by burst until the pool is
    dry and sits bursts out (its device length unchanged) while a
    20-token request finishes, then grows again. The trash block holds
    100.0; every K1 decode call, those of the bursts with a slot sitting
    out included, agrees with the plain version under K1's rule on the
    grown tables; no active slot has a row below its length without a
    block; in float32 the lazy tokens equal the eager engine's (bursts
    of one token, so sitting out moves no token between the staged and
    the cached columns)."""
    dev = _cuda()
    cfg = _hd128_config(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (190, 20)]
    burst = {"v": 0}
    checked = []
    monkeypatch.setattr(tkv, "_paged_attn_stats",
                        _held_k1(checked, lambda: burst["v"]))
    out, sat_out = {}, []
    for lazy in (True, False):
        e = te.InferenceEngine(
            params, cfg, n_slots=2, max_len=256, prompt_buckets=(256,),
            kv_block=16, kv_blocks=16, kv_lazy=lazy, device=dev)
        _fill_trash(e)
        for p, n in zip(prompts, (50, 20)):
            e.add_request(p, max_new_tokens=n)
        while e.waiting or e.slot_req:
            e.admit()
            burst["v"] += 1
            lens = e.cache["length"].clone()
            e.decode_burst(max_burst=1)
            for slot in e.slot_req:
                n = int(e.cache["length"][slot])
                if lazy and n == int(lens[slot]):
                    sat_out.append(burst["v"])
                have = int((e.block_table[slot] < e.n_kv_blocks).sum())
                assert have * e.kv_block >= n
        assert e.blocks_used() == 0
        out[lazy] = [r.tokens for r in sorted(e.finished,
                                              key=lambda r: r.rid)]
    rep = cfg.n_heads // cfg.n_kv_heads
    assert sat_out
    assert any(b in sat_out and r == rep for b, r, _ in checked), checked
    if dtype == torch.float32:
        assert out[True] == out[False]


# -- multi-LoRA adapters on the card ------------------------------------------

def _held_k2(checked):
    """An ``ops.attention.gqa_attention`` that runs K2 and holds each
    causal call to its plain version under K2's rule (float32: 1e-4 of
    the largest magnitude; bf16: one bf16 ulp plus 1e-3 of it)."""
    real = tattn.gqa_attention

    def held(q, k, v, causal=True, segment_ids=None):
        out = real(q, k, v, causal, segment_ids)
        if causal and segment_ids is None:
            want = tfa.flash_attention_fwd_ref(q, k, v)[0]
            if q.dtype == torch.float32:
                _close(out, want, 1e-4)
            else:
                _ulp_close(out, want)
            checked.append(tuple(q.shape))
        return out

    return held


def _adapter_catalog(cfg, dev, n_adapters=4, register=3, rank=8):
    from skypilot_tpu_torch.infer import adapters as tad
    cat = tad.AdapterCatalog(cfg, n_adapters=n_adapters, rank=rank,
                             device=dev)
    for i in range(register):
        r = np.random.default_rng(100 + i)
        cat.register(f"ft-{i}", params={
            t: {"a": r.normal(size=(cfg.n_layers,) + sa).astype(
                np.float32) * 0.05,
                "b": r.normal(size=(cfg.n_layers,) + sb).astype(
                    np.float32) * 0.05}
            for t, (sa, sb) in tad.target_shapes(cfg, rank).items()})
    return cat


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adapter_engine_on_card(dtype, monkeypatch):
    """A mixed-adapter batch (two fine-tunes, the base, a third on a
    chunked 150-token prompt) on the card, head_dim 128, 2 layers,
    rank 8, the trash block at 100.0: every K1 call (decode and the
    chunk's multi-row body) and every K2 wave call agrees with its
    plain version under its rule on the adapters' inputs. In float32 a
    zero-adapter batch equals the adapterless engine's tokens, and the
    mixed batch equals the per-request sequential runs."""
    dev = _cuda()
    cfg = _hd128_config(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (12, 20, 9, 150)]
    names = ["ft-0", "ft-1", None, "ft-2"]
    k1, k2 = [], []
    monkeypatch.setattr(tkv, "_paged_attn_stats",
                        _held_k1(k1, lambda: "adapters"))
    monkeypatch.setattr(tattn, "gqa_attention", _held_k2(k2))

    def engine(cat):
        e = te.InferenceEngine(
            params, cfg, n_slots=4, max_len=256, prompt_buckets=(32, 256),
            kv_block=64, prefill_chunk=64, prefix_pool=2, spec_k=2,
            device=dev, adapters=cat)
        _fill_trash(e)
        return e

    base = engine(None).generate(prompts, 8)
    zero = engine(_adapter_catalog(cfg, dev)).generate(prompts, 8)
    e = engine(_adapter_catalog(cfg, dev))
    ids = [e.add_request(p, 8, adapter=n) for p, n in zip(prompts, names)]
    e.run_to_completion()
    mixed = {r.rid: r.tokens for r in e.finished}
    assert all(r.error is None for r in e.finished)
    rep = cfg.n_heads // cfg.n_kv_heads
    assert any(r > rep for _, r, _ in k1) and any(r == rep for _, r, _ in k1)
    assert k2
    if dtype == torch.float32:
        assert zero == base
        for i, (p, n) in enumerate(zip(prompts, names)):
            solo = engine(_adapter_catalog(cfg, dev))
            rid = solo.add_request(p, 8, adapter=n)
            solo.run_to_completion()
            assert solo.finished[0].tokens == mixed[ids[i]], n
        assert mixed[ids[0]] != base[0]


@pytest.mark.gpu
def test_adapter_installs_keep_the_pool_addresses_on_card():
    """Five fine-tunes hot-load through a 2-slot pool on the card: the
    pool's tensors keep their addresses, slot 0 stays zero, and each
    resident slot holds its adapter's alpha-scaled weights."""
    dev = _cuda()
    cfg = _hd128_config(torch.bfloat16)
    cat = _adapter_catalog(cfg, dev, n_adapters=3, register=5)
    from skypilot_tpu_torch.infer import adapters as tad
    cat.bind_loader(tad.pool_install)
    ptrs = [ab[k].data_ptr() for ab in cat.pool.values() for k in ab]
    for i in range(5):
        slot = cat.acquire(f"ft-{i}")
        cat.release(slot)
        ent = cat._registry[f"ft-{i}"]
        want = cat._stack(ent.params, ent.alpha, 8)
        torch.testing.assert_close(
            cat.pool["wq"]["b"][:, slot].float().cpu(),
            want["wq"]["b"].to(torch.bfloat16).float())
    assert cat.loads == 5 and cat.evictions == 3
    assert [ab[k].data_ptr() for ab in cat.pool.values() for k in ab] \
        == ptrs
    assert all(not ab[k][:, 0].any() for ab in cat.pool.values()
               for k in ab)


# -- the draft model on the card ----------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_kernel_on_two_streams_at_once(kv_dtype):
    """K1 decode launches on two CUDA streams, enqueued in turn so that
    they overlap: each stream counts off its own ticket counters, so
    every result equals its plain version (counters shared between the
    streams would merge one launch's chunks into the other's)."""
    dev = _cuda()
    lengths = (4100, 3000, 4096, 2500, 1, 0, 3900, 4000) * 4
    cases = [_paged_inputs(dev, kv_dtype, 128, 4, 64, seed=s,
                           lengths=lengths) for s in (1, 2)]
    span_blocks = -(-max(lengths) // 64)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(8):
        for i, (stream, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                got[i].append(tpa.paged_attention(*args, 1,
                                                  span_blocks=span_blocks))
    torch.cuda.synchronize()
    q_dev = cases[0][0].device
    keys = {k for k in tpa._tickets if k[0] == q_dev}
    assert {(q_dev, s.cuda_stream) for s in streams} <= keys
    for args, outs in zip(cases, got):
        want = tpa.paged_attention_ref(*args, 1, span_blocks)
        live = args[-1] > 0
        for out in outs:
            for g, w in zip(out, want):
                _close(g[live], w[live], 2e-3)
            assert torch.all(out[1][~live] == -1e30)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_kernel_at_the_400m_draft_shapes(kv_dtype):
    """K1 at the shapes a llama3-400m draft model gives it (4 kv-heads
    of head_dim 128, 3 q-heads each, blocks of 256 at max_len 1024):
    the rollout's decode body at R = 3 and the ingest chunk's multi-row
    body at R = 256 * 3 = 768, starts 0, 256 and 512, on the wgmma body
    (bf16 q on bf16 or int8 pools; the multi-row cases with the trash
    block at 100.0)."""
    dev = _cuda()
    args = _paged_inputs(dev, kv_dtype, 128, 3, 256, G=4,
                         lengths=(900, 0, 1, 300, 1023, 512) * 3)
    span_blocks = 4
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args, 1, span_blocks=span_blocks)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    want = tpa.paged_attention_ref(*args, 1, span_blocks)
    live = args[-1] > 0
    for g, w in zip(got, want):
        _close(g[live], w[live], 2e-3)
    for start in (0, 256, 512):
        rows = _rows_inputs(dev, torch.bfloat16, kv_dtype, 128, 768, 256,
                            start, G=4)
        _check_rows(rows, 1, -(-max(start, 1) // 256))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_draft_engine_on_card(kv_int8, monkeypatch):
    """A self-distilled pair at head_dim 128 in float32 on the card (its
    draft the target's first layer; a second, random 1-layer draft),
    pipelined and synchronous, on float32 or int8 pools: every K1 call
    of the target's and the draft's programs agrees with its plain
    version (the trash blocks at 100.0); the draft's rollouts run the
    decode body and its ingest chunks the multi-row one; tokens equal
    spec-off wherever the plain top-2 gap exceeds 1e-2; the distilled
    draft accepts > 0.9 and reuses predrafts when pipelined; the random
    one rolls back; both pools drain."""
    from skypilot_tpu_torch.infer import draft as td
    import dataclasses
    dev = _cuda()
    cfg = _hd128_config(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    target, dparams, dcfg = td.self_distilled_pair(params, cfg, 1)
    rcfg = dataclasses.replace(cfg, n_layers=1)
    rparams = tl.init_params(rcfg, gen, device=dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 300, 13)]
    checked = []
    monkeypatch.setattr(tkv, "_paged_attn_stats",
                        _held_k1(checked, lambda: None))

    def engine(**kw):
        e = te.InferenceEngine(target, cfg, n_slots=3, max_len=512,
                               prompt_buckets=(64, 512), kv_block=64,
                               prefill_chunk=128, kv_int8=kv_int8,
                               device=dev, **kw)
        _fill_trash(e)
        return e

    want = engine().generate(prompts, max_new_tokens=24)
    for dp, dc, pipeline in ((dparams, dcfg, True), (dparams, dcfg, False),
                             (rparams, rcfg, True)):
        de = td.DraftEngine(dp, dc, n_slots=3, max_len=512, kv_block=64,
                            kv_int8=kv_int8, device=dev)
        _fill_trash(de)
        e = engine(spec_k=4, draft_engine=de, spec_pipeline=pipeline)
        d0, r0 = tpa.paged_attention.launches, _rows_launches()
        got = e.generate(prompts, max_new_tokens=24)
        assert tpa.paged_attention.launches > d0
        assert sum(_rows_launches()) > sum(r0)
        for p, g, w in zip(prompts, got, want):
            t, gap = _first_divergence(target, cfg, dev, p, g, w)
            assert t is None or gap <= 1e-2, (t, gap)
        rate = e._spec_accepted_total / max(e._spec_drafted_total, 1)
        if dp is dparams:
            assert rate > 0.9
            assert all(r.spec_mode == "model" for r in e.finished)
            if pipeline:
                assert de.reuse_hits > 0
        else:
            assert de.rollbacks > 0
        assert de.blocks_used == 0 and e.blocks_used() == 0
    rep = cfg.n_heads // cfg.n_kv_heads
    assert any(r == rep for _, r, _ in checked)
    assert any(r == 128 * rep for _, r, _ in checked)


# -- crash recovery on the card -----------------------------------------------

def _drive_recovering(e, crashed):
    """Drain ``e``, recovering through each dispatch crash (its seam
    appended to ``crashed``) as the server does."""
    while e.waiting or e.chunking or e.slot_req:
        try:
            e.step_burst(max_burst=4)
        except te.EngineDispatchError as ex:
            crashed.append(ex.seam)
            e.recover(ex)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seam", ["chunk", "verify"])
def test_recover_on_card(dtype, seam, monkeypatch):
    """A seeded fault at the second prefill chunk or the second verify
    round on a two-slot engine (max_len 1024, blocks of 256, chunks of
    512, a prefix pool, n-gram spec K 4) with a 600-token and a
    300-token request: the engine resets and re-admits both through the
    resume path. The trash block holds 100.0; every K1 call, the resume
    chunks' multi-row calls over cached rows included, agrees with the
    plain version under K1's rule; a victim counts its recovery, the
    pool drains, and in float32 the recovered tokens equal the
    uninterrupted run's or part only where the plain top-2 gap is at
    most 1e-2."""
    from skypilot_tpu_torch import chaos
    dev = _cuda()
    cfg = _hd128_config(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (600, 300)]
    phase = {"v": "run"}
    checked = []
    monkeypatch.setattr(tkv, "_paged_attn_stats",
                        _held_k1(checked, lambda: phase["v"]))
    e = te.InferenceEngine(
        params, cfg, n_slots=2, max_len=1024, prompt_buckets=(512, 1024),
        kv_block=256, prefill_chunk=512, prefix_pool=4, spec_k=4,
        device=dev)
    out = {}
    for fault in (None, seam):
        e.reset()
        e.clear_prefix_cache()
        _fill_trash(e)
        ids = [e.add_request(p, max_new_tokens=24) for p in prompts]
        chaos.configure({"seed": 0, "faults": [
            {"point": "engine.dispatch", "match": {"seam": fault},
             "after": 1, "times": 1}] if fault else []})
        crashed = []
        real = e.recover

        def recover(ex):
            n = real(ex)
            phase["v"] = "recovered"
            return n

        e.recover = recover
        try:
            _drive_recovering(e, crashed)
        finally:
            chaos.deactivate()
            del e.recover
            phase["v"] = "run"
        reqs = {r.rid: r for r in e.finished}
        assert crashed == ([fault] if fault else [])
        assert all(len(reqs[i].tokens) == 24 for i in ids)
        if fault:
            assert any(reqs[i].recoveries == 1 for i in ids)
        e.clear_prefix_cache()
        assert e.blocks_used() == 0
        out[fault] = [reqs[i].tokens for i in ids]
    rep = cfg.n_heads // cfg.n_kv_heads
    assert any(t == "recovered" and r > rep and n > 0
               for t, r, n in checked), checked
    if dtype == torch.float32:
        # Equal, or parting only at a near-tie of the plain path (a
        # victim re-prefills its context where the twin decoded it).
        for p, got, want in zip(prompts, out[seam], out[None]):
            t = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
            if t is None:
                continue
            ctx = p + want[:t]
            _, logits = tkv.prefill_batch(
                params, torch.tensor([ctx], device=dev),
                torch.tensor([len(ctx)], device=dev), cfg,
                plain_attention=True)
            top2 = logits[0].topk(2).values
            assert (top2[0] - top2[1]).item() <= 1e-2, (t, got, want)


# -- observability on the card ------------------------------------------------

def _observed_engine(dev, **kw):
    """A bf16 engine at head dim 128 (K1's and K2's kernel shapes) with
    its own flight recorder, driven through waves, chunks and n-gram
    verifies."""
    from skypilot_tpu_torch.observability import flight as flight_lib
    cfg = _hd128_config(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tl.init_params(cfg, gen, device=dev)
    e = te.InferenceEngine(
        params, cfg, n_slots=3, max_len=1024, prompt_buckets=(128, 1024),
        kv_block=256, prefill_chunk=512, prefix_pool=4, spec_k=4,
        device=dev, flight_recorder=flight_lib.FlightRecorder(), **kw)
    rng = np.random.default_rng(3)
    phrase = rng.integers(1, cfg.vocab_size, 8).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, 40).tolist(), phrase * 12,
               rng.integers(1, cfg.vocab_size, 700).tolist()]
    return e, prompts


@pytest.mark.gpu
def test_calibrator_cuda_bracket_on_card():
    """The calibrator brackets a sampled dispatch with CUDA events on the
    card (never the host wall): each program's first estimate is
    positive and no larger than the host wall of the record whose
    dispatch it timed."""
    from skypilot_tpu_torch.observability import flight as flight_lib
    dev = _cuda()
    e, prompts = _observed_engine(dev)
    assert e.devtime.device.type == "cuda"
    for _ in range(2):
        e.generate(prompts, max_new_tokens=16)
    firsts = {}
    for r in e.flight.tail():
        if r.get("dev_ms_est") is not None:
            firsts.setdefault(flight_lib.program_label(r), r)
    assert {"wave", "chunk", "decode"} <= {r["burst"]
                                           for r in firsts.values()}
    for label, r in firsts.items():
        assert 0 < r["dev_ms_est"] <= r["dur_s"] * 1e3 + 1e-3, (label, r)
    assert e.devtime.samples > 0


@pytest.mark.gpu
def test_hbm_cross_check_on_card():
    """On the card the HBM ledger's cross-check reads the caching
    allocator and publishes ``bytes_in_use``; the resident ledger fits
    inside it."""
    import gc

    from skypilot_tpu_torch.observability import attribution
    dev = _cuda()
    e, _ = _observed_engine(dev)
    # Earlier tests' cyclic garbage holds card tensors: collected between
    # the two reads below, it would move the allocator's count.
    gc.collect()
    stats = e.hbm_ledger.cross_check(dev)
    assert stats["bytes_in_use"] == torch.cuda.memory_stats(dev)[
        "allocated_bytes.all.current"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        dev).total_memory
    assert attribution.HBM_DEVICE_IN_USE.labels().value == \
        stats["bytes_in_use"]
    led = e.hbm_ledger.snapshot()
    assert led["weights"] + led["kv_pool"] <= stats["bytes_in_use"]


@pytest.mark.gpu
def test_unwarmed_engine_records_first_dispatch_walls_on_card():
    """An engine that was never warmed records a first-dispatch host
    wall for every program key it ran, each attached to the flight
    record of the burst that paid for it; a warmed twin then serves the
    same traffic with no new key and the same tokens."""
    dev = _cuda()
    e, prompts = _observed_engine(dev)
    cold = e.generate(prompts, max_new_tokens=16)
    summ = e.compile_watch.summary()
    assert summ and all(v > 0 for v in summ.values())
    compiled = [k for r in e.flight.tail() for k in r.get("compiled", ())]
    assert sorted(compiled) == sorted(summ)
    assert {k.split("[")[0] for k in summ} >= {
        "admit_wave", "prefill_chunk", "decode_burst", "verify", "claim"}
    w, _ = _observed_engine(dev)
    assert w.warm_programs(max_burst=8) > 0
    w.declare_warmup_complete()
    assert w.generate(prompts, max_new_tokens=16) == cold
    assert w.compile_watch.unexpected == []
    w.clear_prefix_cache()
    assert w.blocks_used() == 0


@pytest.mark.gpu
def test_train_goodput_ledger_on_card(tmp_path, monkeypatch):
    """llama3-tiny on the card, 4 steps at --log-every 1: every record's
    phases partition its wall exactly, ``compute`` (which ends on the
    step's completion at a fetch step) is the largest phase of every
    warm step, and the losses and step-4 state are bit-equal with the
    recorder off."""
    import contextlib
    import io
    from skypilot_tpu_torch.train import checkpoints as tck
    from skypilot_tpu_torch.train import run as trun
    _cuda()
    monkeypatch.setenv("SKYTPU_EVENTS_DIR", str(tmp_path / "ev"))
    monkeypatch.setenv("SKYTPU_CALLBACK_LOG_DIR", str(tmp_path / "cb"))
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    argv = ["--config", "llama3-tiny", "--steps", "4", "--seq", "256",
            "--log-every", "1", "--ckpt-every", "4"]

    def go(goodput, d):
        monkeypatch.setenv("SKYTPU_GOODPUT", goodput)
        with contextlib.redirect_stdout(io.StringIO()):
            return trun.main(argv + ["--ckpt-dir", str(tmp_path / d)])

    on = go("1", "on")
    recs = on["records"]
    assert [r["warm"] for r in recs] == [False, True, True, True]
    for r in recs:
        assert abs(sum(r["phases"].values()) - r["dur_s"] * 1e3) <= 0.05
    for r in recs[1:]:
        ph = dict(r["phases"])
        assert max(ph, key=ph.get) == "compute", ph
        assert r["dev_ms_est"] > 0
    off = go("0", "off")
    assert off["records"] == [] and off["losses"] == on["losses"]
    a = tck.CheckpointManager(str(tmp_path / "on")).restore(step=4)
    b = tck.CheckpointManager(str(tmp_path / "off")).restore(step=4)

    def equal(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k])
                                                for k in x)
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return x == y

    assert equal(a, b)


# -- head-dim routing and the contiguous layout on the card ---------------

def _vit_grads(cfg, params, batch):
    """(loss, {name: gradient}) of ``vit.loss_fn`` by autograd; the
    stacked per-layer tensors under ``blocks/``."""
    from skypilot_tpu_torch.models import vit as tv

    def leaf(v):
        return v.detach().clone().requires_grad_()

    params = {k: ({n: leaf(w) for n, w in v.items()}
                  if isinstance(v, dict) else leaf(v))
              for k, v in params.items()}
    loss, _ = tv.loss_fn(params, batch, cfg)
    loss.backward()
    flat = {}
    for k, v in params.items():
        for n, w in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"{k}/{n}" if n else k] = w.grad
    return loss.detach(), flat


def _tree_to(tree, dev):
    return {k: (_tree_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


@pytest.mark.gpu
def test_vit_tiny_trains_on_card_through_the_plain_route():
    """``vit-tiny`` (head dim 16, which the kernels do not take) in
    float32: ``gqa_attention`` routes it to plain attention by shape, so
    its loss and every gradient on the card match the CPU's within 1e-4
    of each max, and no flash kernel launches."""
    import dataclasses
    from skypilot_tpu_torch.models import vit as tv
    dev = _cuda()
    cfg = dataclasses.replace(tv.CONFIGS["vit-tiny"], dtype=torch.float32)
    assert cfg.d_model // cfg.n_heads == 16
    assert tattn.attention_route(16) == "plain"
    params = tv.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    batch = tv.synthetic_batch(cfg, 4, device="cpu")
    want_loss, want = _vit_grads(cfg, params, batch)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkv.launches)
    got_loss, got = _vit_grads(cfg, _tree_to(params, dev),
                               {k: v.to(dev) for k, v in batch.items()})
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkv.launches) == before
    _close(got_loss.cpu(), want_loss, 1e-4)
    for name, g in want.items():
        _close(got[name].cpu(), g, 1e-4)


@pytest.mark.gpu
def test_head_dim_64_vit_still_launches_k2():
    """A ViT of head dim 64 (vit-s16's) runs K2 forward and K3/K4 backward
    on the card, and its loss matches the CPU's plain path."""
    import dataclasses
    from skypilot_tpu_torch.models import vit as tv
    dev = _cuda()
    cfg = dataclasses.replace(tv.CONFIGS["vit-tiny"], d_model=128,
                              n_heads=2, dtype=torch.float32)
    params = tv.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    batch = tv.synthetic_batch(cfg, 4, device="cpu")
    want_loss, _ = _vit_grads(cfg, params, batch)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    got_loss, _ = _vit_grads(cfg, _tree_to(params, dev),
                             {k: v.to(dev) for k, v in batch.items()})
    after = (tfa.flash_attention_fwd.launches,
             tfa.flash_attention_bwd_dkv.launches,
             tfa.flash_attention_bwd_dq.launches)
    assert all(a > b for a, b in zip(after, before))
    _close(got_loss.cpu(), want_loss, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_contiguous_engine_matches_paged_on_card(kv_int8):
    """llama3-tiny in float32 on the card: the contiguous engine (the
    gather; K2 for its waves, K1 never) gives the paged engine's greedy
    tokens (K1) over waves, chunks, a warm prefix hit and spec rounds,
    wherever the plain top-2 gap exceeds 1e-2; ``step()`` gives the
    burst path's."""
    import dataclasses
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    rng = np.random.default_rng(1)
    system = rng.integers(1, cfg.vocab_size, 32).tolist()
    prompts = ([rng.integers(1, cfg.vocab_size, n).tolist()
                for n in (5, 11, 3, 20, 30, 9)]
               + [system + [7, 8, 9], system + [4, 5]])
    out = {}
    for kv_block in (16, 0):
        e = te.InferenceEngine(params, cfg, n_slots=4, max_len=128,
                               prompt_buckets=(16, 32, 128),
                               kv_block=kv_block,
                               prefill_chunk=16, prefix_pool=2, spec_k=3,
                               kv_int8=kv_int8, max_wave=2, device=dev)
        f0 = tfa.flash_attention_fwd.launches
        p0 = (tpa.paged_attention.launches,
              tpa.paged_attention_rows.launches
              + tpa.paged_attention_rows.mma_launches)
        # The warm prompt after the cold one has stored its prefix.
        out[kv_block] = (e.generate(prompts[:-1], max_new_tokens=12)
                         + e.generate(prompts[-1:], max_new_tokens=12))
        assert tfa.flash_attention_fwd.launches > f0
        k1 = (tpa.paged_attention.launches,
              tpa.paged_attention_rows.launches
              + tpa.paged_attention_rows.mma_launches)
        assert (k1 != p0) == bool(kv_block)
        assert e.prefix_hits >= 1
    for p, got, want in zip(prompts, out[16], out[0]):
        t, gap = _first_divergence(params, cfg, dev, p, got, want)
        assert t is None or gap <= _gather_floor(params, cfg, dev, p,
                                                 want[:t]), (t, gap)
    e = te.InferenceEngine(params, cfg, n_slots=4, max_len=128,
                           prompt_buckets=(16, 32, 128), kv_block=0,
                           prefill_chunk=16, kv_int8=kv_int8, device=dev)
    for p in prompts[:4]:
        e.add_request(p, 6)
    while e.waiting or e.chunking or e.slot_req:
        e.step()
    got = [r.tokens for r in sorted(e.finished, key=lambda r: r.rid)]
    for p, g, w in zip(prompts, got, [o[:6] for o in out[0]]):
        t, gap = _first_divergence(params, cfg, dev, p, g, w)
        assert t is None or gap <= _gather_floor(params, cfg, dev, p,
                                                 w[:t]), (t, gap)


def _gather_floor(params, cfg, dev, prompt, toks):
    """The bound where the gather (the contiguous read, which rounds its
    softmax weights to bf16) may part from K1: the larger of 1e-2 and
    twice the gather's own shift from the plain logits after ``prompt``
    and ``toks``."""
    ctx = list(prompt) + list(toks)
    n = len(ctx) - 1
    _, plain = tkv.prefill_batch(
        params, torch.tensor([ctx], device=dev),
        torch.tensor([len(ctx)], device=dev), cfg, plain_attention=True)
    cache = tkv.init_cache(cfg, 1, len(ctx), device=dev)
    prefix, _ = tkv.prefill_batch(
        params, torch.tensor([ctx[:-1]], device=dev),
        torch.tensor([n], device=dev), cfg, plain_attention=True)
    tkv.insert(cache, {k: prefix[k][:, 0] for k in ("k", "v")}, 0, n,
               ctx[-1])
    gather = tkv.step_logits(params, cache, cfg, None)
    return max(1e-2, 2 * (gather - plain).abs().max().item())


# -- the trainer over a one-rank NCCL mesh -------------------------------------

@pytest.mark.gpu
def test_one_rank_mesh_step_equals_plain_step_on_card():
    """llama3-tiny in float32 over a one-rank NCCL mesh
    (``parallel.mesh.make_mesh``): two steps equal the plain steps
    (losses, grad norms, parameters) and the mesh leg reaches K2, K3
    and K4 on its local shards: forward and recompute 4 launches a
    step at 2 layers, dK/dV and dQ 2 each."""
    import dataclasses

    import torch.distributed as dist

    from skypilot_tpu_torch.parallel import mesh as tmesh
    from skypilot_tpu_torch.train import trainer as tt
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=torch.float32)
    tc = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    batch = tt.synthetic_batch(cfg, 2, 64, seed=1, device=dev)
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh(tmesh.MeshShape(), dev)
    try:
        assert dist.get_backend() == "nccl"
        plain = tt.create_train_state(cfg, tc, dev, seed=3)
        sharded = tt.create_train_state(cfg, tc, dev, seed=3, mesh=mesh)
        step_plain, step_mesh = (tt.make_train_step(cfg, tc),
                                 tt.make_train_step(cfg, tc, mesh=mesh))
        kernels = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv,
                   tfa.flash_attention_bwd_dq)
        for _ in range(2):
            _, mp = step_plain(plain, batch)
            for f in kernels:
                f.launches = 0
            _, mm = step_mesh(sharded, batch)
            assert [f.launches for f in kernels] == [4, 2, 2]
            for k in ("loss", "grad_norm"):
                torch.testing.assert_close(mm[k], mp[k], rtol=1e-5,
                                           atol=0)
        worst = max((a - b.full_tensor()).abs().max().item()
                    for a, b in zip(tt._layer_leaves(plain["params"]),
                                    tt._layer_leaves(sharded["params"])))
        assert worst <= 1e-5, worst
    finally:
        dist.destroy_process_group()


# -- context and pipeline parallelism -----------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["ring", "zigzag", "ulysses"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_context_parallel_loopback_against_flash_on_card(scheme, dtype):
    """The ring, the zigzag ring and Ulysses over 4 virtual sp ranks in
    one process (sequence 1024, 8 q over 4 kv heads, hd 128, packed
    segments), by ``loopback`` (the distributed ring loop with its
    transport a hand-over in one process): outputs and dQ/dK/dV against
    K2 over the whole sequence and K3/K4, within 2e-2 of the reference's
    max in bf16 and 1e-4 in float32; Ulysses launches K2, K3 and K4."""
    from skypilot_tpu_torch.parallel import ring_attention as ra
    dev = _cuda()
    n, S = 4, 1024
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(1, S, h, 128, generator=gen,
                               device=dev).to(dtype) for h in (8, 4, 4, 8))
    seg = ((torch.rand((1, S), generator=gen, device=dev) < 0.01)
           .int().cumsum(dim=1).to(torch.int32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tattn.gqa_attention(*leaves, causal=True, segment_ids=seg)
    want = (o.detach(),) + torch.autograd.grad(o, leaves, grad_outputs=do)
    kernels = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv,
               tfa.flash_attention_bwd_dq)
    for f in kernels:
        f.launches = 0
    got = ra.loopback(scheme, q, k, v, do, seg, n)
    if scheme == "ulysses":
        # The n ranks' head groups stacked on the batch dim: one launch
        # of each.
        assert [f.launches for f in kernels] == [1, 1, 1]
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        _close(g, w, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_tiny_pipeline_step_launches_the_flash_kernels_on_card(schedule):
    """A pp-tiny pipeline step (2 stages of 2 layers, 4 microbatches of
    one row, bf16, head dim 32) on the card: K2 32 launches (4 layers x
    4 microbatches, forward and remat recompute), K3 and K4 16 each; the loss within 1e-2 of the
    plain llama stack's on the same weights, and equal between the
    schedules within 1e-2."""
    import dataclasses

    from skypilot_tpu_torch.parallel import pipeline as tpl
    from skypilot_tpu_torch.train import trainer as tt
    dev = _cuda()
    cfg = dataclasses.replace(tpl.CONFIGS["pp-tiny"], schedule=schedule)
    tc = tt.TrainConfig(warmup_steps=1, total_steps=4)
    state = tt.create_train_state(cfg, tc, dev, seed=0, model=tpl)
    batch = tt.synthetic_batch(cfg, 4, 128, seed=1, device=dev)
    lcfg = tl.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tl.LlamaConfig)})
    p = state["params"]
    flat = dict(p, blocks={k: w.reshape(-1, *w.shape[2:])
                           for k, w in p["blocks"].items()})
    with torch.no_grad():
        want = float(tl.loss_fn(flat, batch, lcfg)[0])
    kernels = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dkv,
               tfa.flash_attention_bwd_dq)
    for f in kernels:
        f.launches = 0
    _, m = tt.make_train_step(cfg, tc, model=tpl)(state, batch)
    assert [f.launches for f in kernels] == [32, 16, 16]
    assert abs(float(m["loss"]) - want) <= 1e-2 * abs(want)


# -- one shard of a tensor-parallel engine ------------------------------------
# llama3-70b at tp 4: each shard serves 16 q-heads over 2 kv heads (a GQA
# group of 8), head dim 128. A decode step and each verify position hand
# K1 R = 8 rows of a kv head (the port scans a verify window position by
# position); a 512-token chunk R = 4096; K2 a wave at 16 over 2.

@pytest.mark.gpu
@_POOLS
@pytest.mark.parametrize("bl", [16, 256])
def test_paged_decode_at_a_70b_tp_shard(kv_dtype, bl):
    """K1's decode body at a shard's group of 8: R = 8 over 2 kv heads,
    hd 128, on float32, bf16 and int8 pools; length-0 slots exactly."""
    dev = _cuda()
    args = _paged_inputs(dev, kv_dtype, hd=128, R=8, bl=bl, G=2)
    span_blocks = -(-max(_PAGED_LENGTHS) // bl)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args, 1, span_blocks=span_blocks)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    want = tpa.paged_attention_ref(*args, 1, span_blocks)
    live = args[-1] > 0
    for g, w in zip(got, want):
        _close(g[live], w[live], 2e-3)
    assert torch.all(got[1][~live] == -1e30)


@pytest.mark.gpu
@_ROWS_DTYPES
@pytest.mark.parametrize("R", [40, 4096])
@pytest.mark.parametrize("start", [0, 512])
def test_paged_rows_at_a_70b_tp_shard(q_dtype, kv_dtype, R, start):
    """K1's multi-row bodies at a shard's group of 8 (2 kv heads, hd
    128, blocks of 256): a chunk's 512 x 8 = 4096 rows, and the 40 rows
    a one-pass verify window of K + 1 = 5 at rep 8 would hand it
    (40 x 128 = 5120 is past the decode body's 4096)."""
    dev = _cuda()
    args = _rows_inputs(dev, q_dtype, kv_dtype, 128, R, 256, start, G=2)
    _check_rows(args, 1, _ROWS_SPAN // 256)
    if R * 128 > 4096:
        before = _rows_launches()
        tpa.paged_attention(*args, 1, span_blocks=_ROWS_SPAN // 256)
        assert _rows_launches() != before      # dispatched to a rows body


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [128, 512])
def test_flash_at_a_70b_tp_shard(dtype, S):
    """K2 at a shard's wave: 16 q-heads over 2 kv heads, hd 128, causal."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, S, 16, 128), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, S, 2, 128), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, S, 2, 128), generator=gen, device=dev).to(dtype)
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, None, True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, None, True)
    if dtype == torch.bfloat16:
        _ulp_close(o, ro)
    else:
        _close(o, ro, 1e-4)
    _close(lse, rlse, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "w8a8-int8kv"])
@pytest.mark.parametrize("kv_block", [None, 0], ids=["paged", "contig"])
def test_tp2_engine_on_card_matches_tp1(quant, kv_block):
    """A llama3-tiny engine over two shards of the card against the
    one-shard engine, float32: the same greedy tokens through waves,
    chunks, the prefix pool and verify rounds, with K1 and K2 on each
    shard's heads (w8a8 + int8 KV: exact under any split)."""
    import dataclasses
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.float32)
    prompts = [list(range(1, 40)), [5, 6, 7, 8] * 6, [3, 1, 4]]
    kw = dict(n_slots=4, max_len=128, prompt_buckets=(16, 128),
              prefill_chunk=16, prefix_pool=4, spec_k=3, kv_block=kv_block,
              weights_int8=quant, kv_int8=quant)

    def run(**more):
        e = te.InferenceEngine(params, cfg, **kw, **more)
        return e.generate(prompts, 24) + e.generate(prompts[:1], 24), e

    want, _ = run(device=dev)
    k1 = tpa.paged_attention.launches
    k2 = tfa.flash_attention_fwd.launches
    got, e = run(mesh=[dev, dev])
    assert got == want
    assert e.prefix_hits >= 1
    assert tfa.flash_attention_fwd.launches > k2
    if kv_block is None:
        assert tpa.paged_attention.launches > k1


@pytest.mark.gpu
def test_tp2_engine_on_card_with_adapters_and_a_draft():
    """Float32 llama3-tiny over two shards of the card with an adapter
    catalog (the pool whole on the card, each shard reading its heads'
    slices) and a self-distilled one-layer draft whole beside it: the
    one-shard engine's tokens, the drafts accepted."""
    import dataclasses

    import numpy as np

    from skypilot_tpu_torch.infer import adapters as tad
    from skypilot_tpu_torch.infer import draft as td
    dev = _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.float32)
    target, dparams, dcfg = td.self_distilled_pair(params, cfg, 1)
    rng = np.random.default_rng(0)
    tree = {t: {"a": rng.normal(size=(cfg.n_layers,) + sa) * 0.05,
                "b": rng.normal(size=(cfg.n_layers,) + sb) * 0.05}
            for t, (sa, sb) in tad.target_shapes(cfg, 4).items()}
    prompts = [list(range(1, 40)), [5, 6, 7, 8] * 6]

    def run(**more):
        cat = tad.AdapterCatalog(cfg, n_adapters=2, rank=4, device=dev)
        cat.register("ft", params=tree)
        draft = td.DraftEngine(dparams, dcfg, n_slots=4, max_len=128,
                               device=dev)
        e = te.InferenceEngine(target, cfg, n_slots=4, max_len=128,
                               prompt_buckets=(16, 128), prefill_chunk=16,
                               spec_k=3, adapters=cat, draft_engine=draft,
                               **more)
        ids = [e.add_request(p, 16, adapter=a)
               for p, a in zip(prompts, ("ft", None))]
        e.run_to_completion()
        by_rid = {r.rid: r.tokens for r in e.finished}
        return [by_rid[i] for i in ids], e

    want, _ = run(device=dev)
    got, e = run(mesh=[dev, dev])
    assert got == want
    assert e.verify_calls > 0


@pytest.mark.gpu
def test_sharded_init_with_an_unindexed_card_mesh():
    """``sharded_init`` over ``["cuda"] * 2`` and an engine over the same
    string mesh: the shards' devices (``cuda:0``) are the group's, and
    the engine serves."""
    import dataclasses
    _cuda()
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"], dtype=torch.float32)
    mesh = ["cuda"] * 2
    params = te.InferenceEngine.sharded_init(cfg, mesh, seed=0)
    e = te.InferenceEngine(params, cfg, mesh=mesh, n_slots=2, max_len=64,
                           prompt_buckets=(16, 64))
    assert e.devices == [torch.device("cuda", torch.cuda.current_device())
                         ] * 2
    out = e.generate([[1, 2, 3, 4]], 8)
    assert len(out[0]) == 8
    assert all(0 <= t < cfg.vocab_size for t in out[0])
