"""Attention ops: grouped-query attention through the flash kernel, and
the plain einsum attention it is held against.

Counterpart of ``skypilot_tpu/ops/attention.py``. The JAX module picked
the Pallas kernel only on a TPU, at ``seq >= 1024`` and for head dims
that are multiples of 128, and fell back to XLA on any error. The port
has no such gates and no fallback: :func:`gqa_attention` always goes
through ``FlashAttention`` (``ops/flash_attention.py``), whose wrappers
launch the CUDA kernels (forward, and under autograd the backward) for
CUDA tensors at every sequence length and raise on what the kernels do
not take; only CPU tensors run the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] for grouped-query attention."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Plain einsum attention (the JAX package's ``xla_attention``).
    q: [B, S, H, D]; k/v: [B, S, H, D] (already expanded). ``segment_ids``
    [B, S]: a position attends only within its own segment."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        scores = torch.where(mask, scores, neg)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = torch.where(same, scores, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Grouped-query attention. q: [B, S, Hq, D]; k/v: [B, S, Hkv, D],
    unexpanded: the flash kernels read kv-head ``h // (Hq / Hkv)``.
    Differentiable: the backward runs K3 and K4."""
    return fa.FlashAttention.apply(q, k, v, segment_ids, causal)
