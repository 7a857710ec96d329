"""The flash-attention backward (K3 dK/dV, K4 dQ) on the CPU: the port's
plain backward against ``jax.grad`` of the JAX package's Pallas kernel
in interpret mode, ``FlashAttention`` against autograd through the
plain einsum attention, and ``gradcheck`` of the plain path in float64.
The CUDA kernels' card tests are in ``test_torch_kernels_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as jfa
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.ops import flash_attention as tfa

H, HKV, D = 4, 2, 32


def _inputs(S, segments, seed=0, B=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    seg = None
    if segments:
        # Three packed documents of uneven length per row.
        seg = np.ones((B, S), np.int32)
        for b in range(B):
            for c in np.sort(rng.choice(np.arange(1, S), 2, replace=False)):
                seg[b, c:] += 1
    return q, k, v, g, seg


# (S, block, segments): the Pallas segment mask needs 128-lane kv blocks.
CASES = [(128, 64, False), (256, 128, False), (256, 128, True)]


@pytest.mark.parametrize("S,block,segments", CASES,
                         ids=[f"S{c[0]}-b{c[1]}-seg{int(c[2])}"
                              for c in CASES])
def test_plain_backward_matches_pallas_grad(S, block, segments):
    """The JAX grads are taken through the Pallas custom_vjp (the K3/K4
    kernels in interpret mode) on K/V expanded with ``repeat``, so they
    arrive summed over each group; fp32 both sides, so the tolerance is
    1e-5 of each gradient's largest magnitude (summation order)."""
    q, k, v, g, seg = _inputs(S, segments)
    rep = H // HKV
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jfa.flash_attention(
            q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
            causal=True, segment_ids=jseg, block_q=block, block_k=block,
            interpret=True)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tseg = None if seg is None else torch.from_numpy(seg)
    to, lse = tfa.flash_attention_fwd(tq, tk, tv, tseg)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-5)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, to, lse, tg, tseg)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("segments", [False, True], ids=["causal", "seg"])
def test_flash_attention_function_matches_autograd(segments):
    """FlashAttention's backward (the wrappers' plain versions on CPU
    tensors) against autograd through the port's einsum attention."""
    q, k, v, g, seg = _inputs(96, segments, seed=1, B=2)
    tseg = None if seg is None else torch.from_numpy(seg)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.FlashAttention.apply(*a, tseg, True)
    out.backward(torch.from_numpy(g))
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    rep = H // HKV
    ref = tattn.xla_attention(b[0], tattn.repeat_kv(b[1], rep),
                              tattn.repeat_kv(b[2], rep), causal=True,
                              segment_ids=tseg)
    ref.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    for name, x, y in zip("qkv", a, b):
        np.testing.assert_allclose(
            x.grad.numpy(), y.grad.numpy(),
            atol=1e-5 * y.grad.abs().max().item(), err_msg=f"d{name}")


def test_gqa_attention_is_differentiable_through_the_wrappers():
    """gqa_attention goes through FlashAttention: a backward on CPU
    tensors runs the plain versions and counts no kernel launch."""
    q, k, v, g, _ = _inputs(64, False, seed=2)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    counts = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dkv,
                                   tfa.flash_attention_bwd_dq)]
    tattn.gqa_attention(*a).backward(torch.from_numpy(g))
    assert all(x.grad is not None and x.grad.shape == x.shape for x in a)
    assert counts == [f.launches for f in (tfa.flash_attention_fwd,
                                           tfa.flash_attention_bwd_dkv,
                                           tfa.flash_attention_bwd_dq)]


@pytest.mark.parametrize("segments", [False, True], ids=["causal", "seg"])
def test_plain_path_gradcheck_float64(segments):
    """The plain forward/backward computes in float64 for float64
    inputs, so gradcheck holds it to finite differences."""
    q, k, v, _, seg = _inputs(12, segments, seed=3)
    tseg = None if seg is None else torch.from_numpy(seg)
    args = [torch.from_numpy(x[..., :8].copy()).double().requires_grad_()
            for x in (q, k, v)]

    def f(q, k, v):
        return tfa.FlashAttention.apply(q, k, v, tseg, True)

    assert torch.autograd.gradcheck(f, args)


def test_wrappers_split_the_plain_backward():
    """flash_attention_bwd_dkv / _dq on CPU return exactly the plain
    backward's pieces, in the inputs' dtypes."""
    q, k, v, g, seg = _inputs(64, True, seed=4)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    tseg = torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, tseg)
    dq, dk, dv = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tg, tseg)
    delta = tfa.attention_delta(o, tg)
    assert delta.shape == (1, H, 64) and delta.dtype == torch.float32
    got_k, got_v = tfa.flash_attention_bwd_dkv(tq, tk, tv, tg, lse, delta,
                                               tseg)
    got_q = tfa.flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, tseg)
    for a, b in ((got_q, dq), (got_k, dk), (got_v, dv)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
