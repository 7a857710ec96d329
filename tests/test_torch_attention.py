"""The flash-attention forward (K2): the port's plain version against
the JAX package's Pallas kernel in interpret mode and its XLA einsum
attention, on the CPU in float32 (the CUDA kernel's card tests are in
``test_torch_kernels_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jattn
from skypilot_tpu.ops import flash_attention as jfa
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.ops import flash_attention as tfa

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

B, S, H, D = 2, 256, 4, 32


def _inputs(hkv, segments, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    seg = None
    if segments:
        # Packed documents of uneven length, ids ascending per row.
        cuts = np.sort(rng.choice(np.arange(1, S), 3, replace=False))
        seg = np.zeros((B, S), np.int32)
        for c in cuts:
            seg[:, c:] += 1
        seg[1] = np.roll(seg[1], 17).cumsum() % 5   # a second layout
    return q, k, v, seg


CASES = [("causal-mha", H, False), ("causal-gqa", 2, False),
         ("segments-mha", H, True), ("segments-gqa", 1, True)]


@pytest.mark.parametrize("name,hkv,segments", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(name, hkv, segments):
    q, k, v, seg = _inputs(hkv, segments)
    rep = H // hkv
    kx, vx = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    jseg = None if seg is None else jnp.asarray(seg)
    want_o = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), causal=True,
        segment_ids=jseg, interpret=True))
    bs = min(jfa.DEFAULT_BLOCK_Q, S)
    _, want_lse = jfa._fwd(
        *(jnp.asarray(x).swapaxes(1, 2) for x in (q, kx, vx)), jseg,
        causal=True, block_q=bs, block_k=bs, interpret=True)
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tseg, causal=True)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=1e-5)


@pytest.mark.parametrize("name,hkv,segments", CASES,
                         ids=[c[0] for c in CASES])
def test_gqa_attention_matches_xla_attention(name, hkv, segments):
    q, k, v, seg = _inputs(hkv, segments, seed=1)
    rep = H // hkv
    jseg = None if seg is None else jnp.asarray(seg)
    want = np.asarray(jattn.xla_attention(
        jnp.asarray(q), jattn.repeat_kv(jnp.asarray(k), rep),
        jattn.repeat_kv(jnp.asarray(v), rep), causal=True,
        segment_ids=jseg))
    tseg = None if seg is None else torch.from_numpy(seg)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tattn.gqa_attention(tq, tk, tv, causal=True, segment_ids=tseg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got_x = tattn.xla_attention(tq, tattn.repeat_kv(tk, rep),
                                tattn.repeat_kv(tv, rep), causal=True,
                                segment_ids=tseg)
    np.testing.assert_allclose(got_x.numpy(), want, atol=1e-5)


def test_repeat_kv_matches():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(k), 3)))


def test_cpu_tensors_run_the_plain_version():
    q, k, v, _ = _inputs(2, False)
    before = tfa.flash_attention_fwd.launches
    tfa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    assert tfa.flash_attention_fwd.launches == before



@pytest.mark.parametrize("hd,route", [(16, "plain"), (24, "plain"),
                                      (32, "flash"), (64, "flash"),
                                      (128, "flash"), (256, "plain")])
def test_gqa_attention_routes_by_head_dim(monkeypatch, hd, route):
    """The route is chosen from the head dim before any launch: the
    kernels' head dims go through ``FlashAttention`` (K2), every other
    one through plain attention over ``repeat_kv``, with no device and
    no launch attempted; both match the JAX package's ``gqa_attention``
    (which sends these CPU shapes to its XLA path) within 1e-5 of the
    max, causal and not, forward and backward."""
    assert tattn.attention_route(hd) == route
    calls = []
    real = tfa.FlashAttention.apply
    monkeypatch.setattr(tfa.FlashAttention, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((2, 16, 4, hd)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, hd)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, hd)).astype(np.float32)
    for causal in (True, False):
        tq = torch.from_numpy(q).requires_grad_()
        got = tattn.gqa_attention(tq, torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
        got.sum().backward()
        assert tq.grad is not None and torch.isfinite(tq.grad).all()
        want = np.asarray(jattn.gqa_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            impl="xla"))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert len(calls) == (2 if route == "flash" else 0)
    # A direct call of the kernel's wrapper still refuses the head dims
    # the kernel does not take.
    if route == "plain":
        with pytest.raises(ValueError):
            tfa._check(torch.zeros(1, 4, 1, hd), torch.zeros(1, 4, 1, hd),
                       torch.zeros(1, 4, 1, hd), None)
