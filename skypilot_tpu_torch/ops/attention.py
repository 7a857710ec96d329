"""Attention ops: grouped-query attention through the flash kernel, and
the plain einsum attention it is held against.

Counterpart of ``skypilot_tpu/ops/attention.py``. The JAX module picked
the Pallas kernel only on a TPU, at ``seq >= 1024`` and for head dims
that are multiples of 128, and fell back to XLA on any error. The port
has no sequence gate and no fallback on error: :func:`gqa_attention`
chooses its route from the head dim alone, before any launch. Head dims
the kernels take (32, 64, 128: ``flash_attention.HEAD_DIMS``) go through
``FlashAttention`` (``ops/flash_attention.py``), whose wrappers launch
the CUDA kernels (forward, and under autograd the backward) for CUDA
tensors at every sequence length and run the plain versions only for CPU
tensors; every other head dim (a ViT-tiny's 16) runs
:func:`xla_attention` over :func:`repeat_kv`, as the reference does for
every head dim that is not a multiple of 128.

Under a device mesh (q, k and v are DTensors, ``parallel/``),
:func:`gqa_attention` runs on each rank's local shard: the batch split
over (dp, fsdp) and the heads over tp, by the activation rules, so K2,
K3 and K4 (or the plain route) see plain local tensors and never a
DTensor. Where tp splits the q heads but not the kv heads (the
divisibility guard: llama3-tiny at tp 4), each rank hands the kernel
the kv heads its q heads read, and their gradients are partial sums
over tp. The reference gets both from GSPMD.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial

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
                  segment_ids: Optional[torch.Tensor] = None,
                  rules=None) -> torch.Tensor:
    """Grouped-query attention. q: [B, S, Hq, D]; k/v: [B, S, Hkv, D],
    unexpanded: the flash kernels read kv-head ``h // (Hq / Hkv)``.
    Differentiable: the backward runs K3 and K4. A head dim the kernels
    do not take runs the plain attention (:func:`attention_route`).
    DTensor inputs run on their local shards, laid out by the
    activation ``rules`` (default ``sharding.ACT_RULES``; module
    docstring)."""
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal, segment_ids, rules)
    if attention_route(q.shape[-1]) == "plain":
        n_rep = q.shape[2] // k.shape[2]
        return xla_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                             causal=causal, segment_ids=segment_ids)
    return fa.FlashAttention.apply(q, k, v, segment_ids, causal)


def attention_route(head_dim: int) -> str:
    """The route :func:`gqa_attention` takes for a head dim: ``"flash"``
    (K2, with K3/K4 backward) for the kernels' head dims, ``"plain"``
    otherwise. A function of the shape alone, never of a launch's
    outcome: a kernel that fails on a head dim it takes still raises."""
    return "flash" if head_dim in fa.HEAD_DIMS else "plain"


def _rank_kv_heads(kv: torch.Tensor, rank: int, n_local: int,
                   rep: int) -> torch.Tensor:
    """The kv heads that q heads ``[rank * n_local, (rank + 1) *
    n_local)`` read (q head h reads kv head ``h // rep``), laid out so
    the kernel's own rule (local q head j reads local kv head
    ``j // (n_local / kv_local)``) finds them: a contiguous run of kv
    heads when the q heads cover whole groups or lie inside one, else
    one kv head per q head."""
    lo = rank * n_local // rep
    if n_local % rep == 0 or rep % n_local == 0:
        hi = ((rank + 1) * n_local - 1) // rep + 1
        return kv[:, :, lo:hi].contiguous()
    idx = torch.arange(rank * n_local, (rank + 1) * n_local,
                       device=kv.device) // rep
    return kv[:, :, idx].contiguous()


def _sharded_attention(q, k, v, causal: bool, segment_ids, rules=None):
    """:func:`gqa_attention` over DTensors: q/k/v laid out by the
    activation rules (batch over dp and fsdp, heads over tp), the local
    attention on each rank's shard, O returned as a DTensor in q's
    layout. Differentiable through ``to_local``/``from_local``.

    Where the rules' sequence axis is above 1 and divides the sequence,
    the sequence is context-parallel: ring attention over that axis
    (``parallel/ring_attention.py``), the zigzag ring when the rules
    carry ``seq_layout: zigzag``. A sequence the ring does not divide
    falls through to local attention on a replicated sequence, the
    reference's divisibility fallback."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import ring_attention as ra
    from skypilot_tpu_torch.parallel import sharding as sh
    mesh = q.device_mesh
    sizes = mesh_lib.mesh_shape(mesh)
    rules = sh.ACT_RULES if rules is None else rules
    seq_axis = rules.get("seq")
    if (isinstance(seq_axis, str) and sizes.as_dict()[seq_axis] > 1
            and q.shape[1] % sizes.as_dict()[seq_axis] == 0):
        heads_axis = rules.get("heads")
        kw = dict(axis=seq_axis, batch_axes=rules.get("batch"),
                  heads_axis=heads_axis if isinstance(heads_axis, str)
                  else None, segment_ids=segment_ids)
        if rules.get("seq_layout") == "zigzag":
            return ra.zigzag_ring_attention(q, k, v, mesh, **kw)
        return ra.ring_attention(q, k, v, mesh, causal=causal, **kw)
    q_spec = sh.spec_for(("batch", "seq", "heads", "head_dim"), rules,
                         mesh, q.shape)
    kv_spec = sh.spec_for(("batch", "seq", "kv_heads", "head_dim"), rules,
                          mesh, k.shape)
    q_pl = sh.placements(q_spec, mesh)
    kv_pl = sh.placements(kv_spec, mesh)
    axes = mesh_lib.axes_of(mesh)
    split_q = "tp" in axes and q_pl[axes.index("tp")] != kv_pl[
        axes.index("tp")]
    kv_grad = kv_pl
    if split_q:
        # A rank that reads a slice of replicated kv heads holds a
        # partial sum of their gradient.
        tp = axes.index("tp")
        kv_grad = kv_pl[:tp] + (Partial(),) + kv_pl[tp + 1:]
    ql = sh.distribute(q, mesh, q_spec).to_local().contiguous()
    kl, vl = (sh.distribute(t, mesh, kv_spec).to_local(
        grad_placements=kv_grad) for t in (k, v))
    if split_q:
        n_local = q.shape[2] // sizes.tp
        rep = q.shape[2] // k.shape[2]
        r = mesh.get_local_rank("tp")
        kl, vl = (_rank_kv_heads(t, r, n_local, rep) for t in (kl, vl))
    else:
        kl, vl = kl.contiguous(), vl.contiguous()
    seg = None
    if segment_ids is not None:
        seg = sh.distribute(segment_ids, mesh, q_spec[:2]).to_local()
    o = gqa_attention(ql, kl, vl, causal=causal,
                      segment_ids=None if seg is None else seg.contiguous())
    return DTensor.from_local(o, mesh, q_pl, run_check=False)
