"""Causal flash attention: the forward and backward CUDA kernels, their
plain versions, their launch counts and the autograd function over them.

Counterpart of ``skypilot_tpu/ops/flash_attention.py``:

- ``csrc/flash_fwd.cu`` (K2) replaces the Pallas ``_fwd_kernel`` (via
  ``_fwd``). Under the causal mask a wave prefill at S = 1024 is bound
  by operations (at S = 512, by bytes).
- ``csrc/flash_bwd.cu`` replaces ``_bwd_dkv_kernel`` (K3, dK and dV)
  and ``_bwd_dq_kernel`` (K4, dQ), both via ``_bwd``. Both are bound by
  operations at the training shapes.
- :class:`FlashAttention` replaces the ``_flash`` ``custom_vjp``: K2
  forward, then ``delta = rowsum(dO * O)`` in plain torch (the JAX
  package leaves it to XLA) and K3 + K4.

Dispatch is by dtype only. bf16 inputs, the served and trained path,
reach the Hopper bodies of K2, K3 and K4: wgmma products on TMA-loaded
shared tiles (``csrc/sm90.cuh``), P and dS entering their products as
two bf16 parts so that only the order of fp32 sums differs from the
plain versions. The float32 bodies of all three multiply with fp32 FMA
on CUDA cores, so float32 stays exact fp32 arithmetic. Each source
notes its design and what bounds it.

Layouts follow the JAX package's public function: q ``[B, S, H, D]``,
k/v ``[B, S, Hkv, D]`` (not GQA-expanded: the kernel reads kv-head
``h // (H // Hkv)``), segment ids ``[B, S]`` int32; the kernel returns O
in the input dtype and the logsumexp ``[B, H, S]`` in float32; the
backward takes dO in q's layout and lse/delta ``[B, H, S]`` float32, and
returns dQ, dK, dV in the dtypes and layouts of q, k, v.

Each wrapper (:func:`flash_attention_fwd`,
:func:`flash_attention_bwd_dkv`, :func:`flash_attention_bwd_dq`)
launches its kernel for CUDA tensors (or raises on what the kernel does
not take) and runs the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The head dims the kernels take (``ops/attention.gqa_attention`` routes
# every other one to plain attention before any launch).
HEAD_DIMS = (32, 64, 128)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions compute in float32, or in float64 for float64
    inputs (so ``gradcheck`` can hold them to float64 precision)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mask(S: int, causal: bool, segment_ids: Optional[torch.Tensor],
          device) -> torch.Tensor:
    """[1 or B, 1, S, S] bool: which (q, k) pairs attend."""
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None]
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = mask & same
    return mask


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            segment_ids: Optional[torch.Tensor] = None,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the kernel's arithmetic in float32 (q scaled
    by 1/sqrt(D), scores, softmax and the weighted sum), O cast to the
    input dtype."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    qf = _wide(q) * (1.0 / math.sqrt(D))
    kf = _wide(k).repeat_interleave(rep, dim=2)
    vf = _wide(v).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _mask(S, causal, segment_ids, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _launcher(source: str, symbol: str, n_ptrs: int):
    """The C launch function ``symbol`` of ``csrc/<source>.cu``, built
    on first use: ``n_ptrs`` pointers, then B, S, H, Hkv, D, causal and
    dtype, then the stream."""
    fn = getattr(_build.load(source), symbol)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, segment_ids) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,S,H,D], k/v [B,S,Hkv,D] "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError("flash_attention: k/v shape does not match q")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v of "
                        f"one dtype expected, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not supported "
                         f"by the kernel (32, 64 or 128)")
    tensors = [q, k, v] + ([segment_ids] if segment_ids is not None else [])
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: all inputs must be on the "
                             "same CUDA device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: inputs must be contiguous")
    if segment_ids is not None and (segment_ids.dtype != torch.int32
                                    or segment_ids.shape != (B, S)):
        raise TypeError("flash_attention: segment_ids must be int32 [B, S]")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segment_ids: Optional[torch.Tensor] = None,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B, S, H, D] in q's dtype, lse [B, H, S] float32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, segment_ids, causal)
    _check(q, k, v, segment_ids)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher("flash_fwd", "flash_fwd_launch", 6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segment_ids.data_ptr() if segment_ids is not None else None,
            o.data_ptr(), lse.data_ptr(), B, S, H, k.shape[2], D,
            int(causal), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


# Kernel launches since the count was last set to 0.
flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S, Hkv, D] -> O [B, S, H, D]."""
    return flash_attention_fwd(q, k, v, segment_ids, causal)[0]


# ---------------------------------------------------------------------------
# Backward: K3 (dK, dV) and K4 (dQ)
# ---------------------------------------------------------------------------

def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, [B, S, H, D] -> [B, H, S]."""
    return (_wide(do) * _wide(o)).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, segment_ids, causal):
    """K3's and K4's arithmetic in float32: P = exp(S - lse) under the
    mask, dS = P * (dP - delta); dQ, and dK/dV summed over each group's
    q-heads, all float32 (float64 for float64 inputs)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = _wide(q) * scale
    kf = _wide(k).repeat_interleave(rep, dim=2)
    vf = _wide(v).repeat_interleave(rep, dim=2)
    dof = _wide(do)
    mask = _mask(S, causal, segment_ids, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale

    def group_sum(x):
        return x.reshape(B, S, Hkv, rep, D).sum(dim=3)

    return dq, group_sum(dk), group_sum(dv)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            segment_ids: Optional[torch.Tensor] = None,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The plain version of the backward, (dQ, dK, dV) in the dtypes of
    q, k and v: delta from O and dO, then K3's and K4's arithmetic in
    float32 on unexpanded K/V."""
    dq, dk, dv = _bwd_plain(q, k, v, do, lse, attention_delta(o, do),
                            segment_ids, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, do, lse, delta) -> None:
    B, S, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention: dO must match q, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} must be float32 "
                            f"[B, H, S], got {tuple(t.shape)} {t.dtype}")
    for t in (do, lse, delta):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: all inputs must be on the "
                             "same CUDA device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: inputs must be contiguous")


def _bwd_pointers(q, k, v, do, lse, delta, segment_ids):
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            segment_ids.data_ptr() if segment_ids is not None else None]


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            segment_ids: Optional[torch.Tensor] = None,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dK, dV), [B, S, Hkv, D] in k's dtype, summed over each
    kv-head's group of q-heads."""
    if q.device.type == "cpu":
        _, dk, dv = _bwd_plain(q, k, v, do, lse, delta, segment_ids, causal)
        return dk.to(k.dtype), dv.to(v.dtype)
    _check(q, k, v, segment_ids)
    _check_bwd(q, do, lse, delta)
    B, S, H, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher("flash_bwd", "flash_bwd_dkv_launch", 9)(
            *_bwd_pointers(q, k, v, do, lse, delta, segment_ids),
            dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], D,
            int(causal), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


# Kernel launches since the count was last set to 0.
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           segment_ids: Optional[torch.Tensor] = None,
                           causal: bool = True) -> torch.Tensor:
    """K4: dQ [B, S, H, D] in q's dtype."""
    if q.device.type == "cpu":
        dq, _, _ = _bwd_plain(q, k, v, do, lse, delta, segment_ids, causal)
        return dq.to(q.dtype)
    _check(q, k, v, segment_ids)
    _check_bwd(q, do, lse, delta)
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher("flash_bwd", "flash_bwd_dq_launch", 8)(
            *_bwd_pointers(q, k, v, do, lse, delta, segment_ids),
            dq.data_ptr(), B, S, H, k.shape[2], D, int(causal),
            _DTYPES[q.dtype], stream)
    _build.check(err, "flash_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


# Kernel launches since the count was last set to 0.
flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, in place of the JAX package's
    ``_flash`` ``custom_vjp``. ``apply(q, k, v, segment_ids, causal)``
    (positional) -> O; the forward saves q, k, v, O and the logsumexp,
    the backward forms delta in plain torch and runs K3 and K4."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids=None, causal=True):
        o, lse = flash_attention_fwd(q, k, v, segment_ids, causal)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        # Autograd may hand over a strided gradient; the kernels take
        # contiguous rows.
        do = do.contiguous()
        delta = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg,
                                         ctx.causal)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, seg, ctx.causal)
        return dq, dk, dv, None, None
