"""Context parallelism: ring attention, the zigzag ring and Ulysses
all-to-all attention over the ``sp`` mesh axis.

Counterpart of ``skypilot_tpu/parallel/ring_attention.py``, with its
schemes, names and numbers:

* **Ring attention** (:func:`ring_attention`): each rank keeps its query
  rows while the K/V blocks (and their segment ids) travel around the
  ``sp`` ring; the softmax accumulates online, so no rank holds more
  than one remote K/V block. A second ring in the backward carries the
  dK/dV accumulators with their K/V blocks. GQA is native: the
  unrepeated kv heads travel.
* **The zigzag ring** (:func:`zigzag_ring_attention`): causal only, in
  the zigzag layout (rank i holds chunks ``i`` and ``2n-1-i``), where
  every step but the first needs one maskless half-block product.
* **Ulysses** (:func:`ulysses_attention`): an all-to-all turns the
  sequence split into a head split, :func:`ops.attention.gqa_attention`
  runs on the whole sequence for ``H/n`` heads (the flash kernels K2,
  and K3/K4 in the backward, on the card), and a second all-to-all
  turns it back.

Where the reference runs a ``shard_map`` over global arrays, the port
runs an ``autograd.Function`` over each rank's local shard: inputs are
DTensors (or whole tensors, the same on every rank) laid out by
:func:`_qkv_specs`, the output a DTensor in q's layout.

The arithmetic of one ring step is a function of local tensors and the
integers ``(my_idx, kv_idx, n)`` alone (:func:`ring_fwd_step`,
:func:`ring_bwd_step`, :func:`zigzag_fwd_step`, :func:`zigzag_bwd_step`);
the transport (:class:`Ring`'s ``shift``, ``batch_isend_irecv`` on the
``sp`` group) is separate, so the distributed ring loop (:func:`_fwd`,
:func:`_bwd`, :func:`_ulysses_body`) also runs in one process over
blocks held side by side, its transport a hand-over of tensors
(:func:`loopback`). The block bodies are the reference's
plain einsums (it runs no Pallas kernel in them), in float32 products
of the inputs' values: the reference's ``preferred_element_type``.

The zigzag layout (:func:`zigzag_indices`, :func:`apply_zigzag_layout`)
is the reference's; a model opts in through the activation rule
``seq_layout: zigzag`` and permutes once after the embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sh

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Shared pieces of the step bodies
# ---------------------------------------------------------------------------

def _dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` in float32 of the operands' values (bf16 values are
    exact in float32): the reference's ``preferred_element_type``."""
    return torch.einsum(eq, a.float(), b.float())


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, Hq, D] -> [B, S, Hkv, G, D] with G = Hq // Hkv."""
    B, S, Hq, D = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, D)


def _block_mask(my_idx: int, kv_idx: int, s_q: int, s_k: int, device):
    """Causal mask between the global positions of two ring blocks."""
    q_pos = my_idx * s_q + torch.arange(s_q, device=device)
    k_pos = kv_idx * s_k + torch.arange(s_k, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _seg_mask(q_seg: torch.Tensor, k_seg: torch.Tensor) -> torch.Tensor:
    """[B, 1, 1, Sq, Sk] same-segment mask."""
    return q_seg[:, None, None, :, None] == k_seg[:, None, None, None, :]


def _allowed_mask(causal: bool, has_seg: bool, my_idx: int, kv_idx: int,
                  s_q: int, s_k: int, q_seg, k_seg):
    """The causal and segment mask, broadcastable to [B, Hkv, G, Sq, Sk];
    None when everything is allowed."""
    allowed = None
    if causal:
        allowed = _block_mask(my_idx, kv_idx, s_q, s_k, q_seg.device)
    if has_seg:
        same = _seg_mask(q_seg, k_seg)
        allowed = same if allowed is None else allowed & same
    return allowed


def _online_update(o, m, l, s, v, allowed):
    """One online-softmax accumulation of scores ``s`` [B, Hkv, G, Sq,
    Sk] against values ``v`` [B, Sk, Hkv, D]. o [B, Sq, Hkv, G, D], m
    and l [B, Hkv, G, Sq]; returns the new (o, m, l)."""
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    pv = _dot("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    o_new = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
    return o_new, m_new, l_new


def init_acc(q: torch.Tensor, n_kv: int):
    """Zero accumulators (o, m, l) of one rank's queries q [B, S, Hq, D]:
    o [B, S, Hkv, G, D], m (at -1e30) and l [B, Hkv, G, S], float32."""
    B, S, Hq, D = q.shape
    G = Hq // n_kv
    o = torch.zeros((B, S, n_kv, G, D), dtype=torch.float32,
                    device=q.device)
    m = torch.full((B, n_kv, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    return o, m, torch.zeros_like(m)


def finish(acc, dtype):
    """(o, m, l) -> (O [B, S, Hq, D] in ``dtype``, lse [B, Hkv, G, S])."""
    o, m, l = acc
    B, S, Hkv, G, D = o.shape
    l_safe = l.clamp_min(1e-30)
    o = (o / l_safe.permute(0, 3, 1, 2)[..., None]).to(dtype)
    return o.reshape(B, S, Hkv * G, D), m + torch.log(l_safe)


def backward_prep(q, o, do, n_kv: int):
    """(q5, do5, delta) for the backward steps: q and dO grouped
    [B, S, Hkv, G, D], delta = rowsum(dO * O) [B, Hkv, G, S] float32."""
    q5, do5 = _group(q, n_kv), _group(do, n_kv)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do5.float(),
                         _group(o, n_kv).float())
    return q5, do5, delta


def _block_grads(qp, dop, lsep, deltap, kp, vp, allowed, scale, q_dtype):
    """dQ, dK and dV parts (float32) of one sub-block."""
    s = _dot("bqhgd,bkhd->bhgqk", qp, kp) * scale
    p = torch.exp(s - lsep[..., None])
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    dv = _dot("bhgqk,bqhgd->bkhd", p.to(dop.dtype), dop)
    dp = _dot("bqhgd,bkhd->bhgqk", dop, vp)
    ds = (p * (dp - deltap[..., None]) * scale).to(q_dtype)
    dq = _dot("bhgqk,bkhd->bqhgd", ds, kp)
    dk = _dot("bhgqk,bqhgd->bkhd", ds, qp)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The step bodies: local tensors and (my_idx, kv_idx, n), no transport
# ---------------------------------------------------------------------------

def ring_fwd_step(acc, q5, k, v, seg, kseg, my_idx: int, kv_idx: int,
                  causal: bool, has_seg: bool):
    """One forward ring step: rank ``my_idx``'s queries q5 [B, S, Hkv, G,
    D] (segment ids ``seg``) against K/V block ``kv_idx`` (k/v [B, Sk,
    Hkv, D], ids ``kseg``). Returns the new accumulators."""
    scale = q5.shape[-1] ** -0.5
    s = _dot("bqhgd,bkhd->bhgqk", q5, k) * scale
    allowed = _allowed_mask(causal, has_seg, my_idx, kv_idx, q5.shape[1],
                            k.shape[1], seg, kseg)
    return _online_update(*acc, s, v, allowed)


def ring_bwd_step(dq, dk, dv, q5, do5, lse, delta, k, v, seg, kseg,
                  my_idx: int, kv_idx: int, causal: bool, has_seg: bool):
    """One backward ring step: adds block ``kv_idx``'s parts into the
    float32 accumulators dq [B, S, Hkv, G, D] (the rank's own) and dk/dv
    [B, Sk, Hkv, D] (the block's, travelling with it), in place."""
    allowed = _allowed_mask(causal, has_seg, my_idx, kv_idx, q5.shape[1],
                            k.shape[1], seg, kseg)
    dq_p, dk_p, dv_p = _block_grads(q5, do5, lse, delta, k, v, allowed,
                                    q5.shape[-1] ** -0.5, q5.dtype)
    dq += dq_p
    dk += dk_p
    dv += dv_p


def _zz_positions(my_idx: int, n: int, c: int, device):
    """Global positions of a zigzag rank's 2c rows."""
    lo = my_idx * c + torch.arange(c, device=device)
    hi = (2 * n - 1 - my_idx) * c + torch.arange(c, device=device)
    return torch.cat([lo, hi])


def zigzag_fwd_step(acc, q5, k, v, seg, kseg, my_idx: int, kv_idx: int,
                    n: int, has_seg: bool):
    """One forward step of the zigzag ring (causal). The rank's own block
    takes the zigzag-position mask; a block from a lower rank
    (``my_idx > kv_idx``) gives all queries its low chunk, maskless; a
    block from a higher rank gives the high-chunk queries all of it,
    maskless, and leaves the low rows' accumulators as they were."""
    scale = q5.shape[-1] ** -0.5
    o, m, l = acc
    c = q5.shape[1] // 2
    if kv_idx == my_idx:
        pos = _zz_positions(my_idx, n, c, q5.device)
        allowed = pos[:, None] >= pos[None, :]
        if has_seg:
            allowed = allowed & _seg_mask(seg, kseg)
        s = _dot("bqhgd,bkhd->bhgqk", q5, k) * scale
        return _online_update(o, m, l, s, v, allowed)
    if my_idx > kv_idx:
        s = _dot("bqhgd,bkhd->bhgqk", q5, k[:, :c]) * scale
        allowed = _seg_mask(seg, kseg[:, :c]) if has_seg else None
        return _online_update(o, m, l, s, v[:, :c], allowed)
    s = _dot("bqhgd,bkhd->bhgqk", q5[:, c:], k) * scale
    allowed = _seg_mask(seg[:, c:], kseg) if has_seg else None
    o_hi, m_hi, l_hi = _online_update(o[:, c:], m[..., c:], l[..., c:], s,
                                      v, allowed)
    return (torch.cat([o[:, :c], o_hi], dim=1),
            torch.cat([m[..., :c], m_hi], dim=-1),
            torch.cat([l[..., :c], l_hi], dim=-1))


def zigzag_bwd_step(dq, dk, dv, q5, do5, lse, delta, k, v, seg, kseg,
                    my_idx: int, kv_idx: int, n: int, has_seg: bool):
    """One backward step of the zigzag ring, the forward's three cases:
    adds the parts into dq (the rank's) and dk/dv (the block's), in
    place."""
    scale = q5.shape[-1] ** -0.5
    c = q5.shape[1] // 2
    if kv_idx == my_idx:
        pos = _zz_positions(my_idx, n, c, q5.device)
        allowed = pos[:, None] >= pos[None, :]
        if has_seg:
            allowed = allowed & _seg_mask(seg, kseg)
        parts = _block_grads(q5, do5, lse, delta, k, v, allowed, scale,
                             q5.dtype)
        for acc, p in zip((dq, dk, dv), parts):
            acc += p
    elif my_idx > kv_idx:
        allowed = _seg_mask(seg, kseg[:, :c]) if has_seg else None
        dq_p, dk_p, dv_p = _block_grads(q5, do5, lse, delta, k[:, :c],
                                        v[:, :c], allowed, scale, q5.dtype)
        dq += dq_p
        dk[:, :c] += dk_p
        dv[:, :c] += dv_p
    else:
        allowed = _seg_mask(seg[:, c:], kseg) if has_seg else None
        dq_p, dk_p, dv_p = _block_grads(q5[:, c:], do5[:, c:], lse[..., c:],
                                        delta[..., c:], k, v, allowed, scale,
                                        q5.dtype)
        dq[:, c:] += dq_p
        dk += dk_p
        dv += dv_p


# ---------------------------------------------------------------------------
# The transport and the autograd function over one rank's shard
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ring:
    """This rank's place in the ring over one mesh axis: the axis's
    process group (None for a ring of one), its index and size."""
    group: Optional[object]
    my_idx: int
    n: int

    @staticmethod
    def of(mesh, axis: str) -> "Ring":
        n = mesh_lib.mesh_shape(mesh).as_dict()[axis]
        if n == 1:
            return Ring(None, 0, 1)
        return Ring(mesh.get_group(axis), mesh.get_local_rank(axis), n)

    def shift(self, blocks=(), accs=()):
        """The K/V block tensors ``blocks`` and the accumulators ``accs``
        that travel with them, each sent to the next rank of the ring and
        replaced by the previous rank's (one ``batch_isend_irecv``).
        Returns (blocks, accs)."""
        nxt = dist.get_global_rank(self.group, (self.my_idx + 1) % self.n)
        prv = dist.get_global_rank(self.group, (self.my_idx - 1) % self.n)
        outs, ops = [], []
        for t in tuple(blocks) + tuple(accs):
            t = t.contiguous()
            o = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, nxt, self.group))
            ops.append(dist.P2POp(dist.irecv, o, prv, self.group))
            outs.append(o)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(outs[:len(blocks)]), tuple(outs[len(blocks):])


class _LoopbackRing:
    """Rank ``my_idx``'s view of a ring of n ranks held in one process
    (:func:`loopback`): :meth:`shift` hands over the previous block's
    tensors from ``blocks`` (block j: (k, v, segment ids)); the
    accumulators that would travel with a block are added into
    ``sums[j]``, and zeros travel on, so after every rank has run,
    ``sums`` holds each block's total."""

    def __init__(self, my_idx: int, n: int, blocks: list, sums: dict):
        self.my_idx, self.n = my_idx, n
        self._blocks, self._sums = blocks, sums
        self._held = my_idx

    def shift(self, blocks=(), accs=()):
        if accs:
            got = self._sums.get(self._held)
            self._sums[self._held] = (tuple(accs) if got is None else
                                      tuple(g + a for g, a in zip(got, accs)))
            accs = tuple(torch.zeros_like(a) for a in accs)
        self._held = (self._held - 1) % self.n
        return (self._blocks[self._held] if blocks else ()), accs


def _fwd(ring, zigzag: bool, causal: bool, has_seg: bool, q, k, v, seg):
    """The forward ring over one rank's shard: (O, lse)."""
    n_kv = k.shape[2]
    q5 = _group(q, n_kv)
    acc = init_acc(q, n_kv)
    kk, vv, ks = k, v, seg
    for i in range(ring.n):
        kv_idx = (ring.my_idx - i) % ring.n
        if zigzag:
            acc = zigzag_fwd_step(acc, q5, kk, vv, seg, ks, ring.my_idx,
                                  kv_idx, ring.n, has_seg)
        else:
            acc = ring_fwd_step(acc, q5, kk, vv, seg, ks, ring.my_idx,
                                kv_idx, causal, has_seg)
        if i < ring.n - 1:
            (kk, vv, ks), _ = ring.shift((kk, vv, ks))
    return finish(acc, q.dtype)


def _bwd(ring, zigzag: bool, causal: bool, has_seg: bool,
         q, k, v, o, lse, seg, do):
    """The backward ring: dK/dV accumulators travel with their blocks
    and are home after ``n`` shifts."""
    n_kv = k.shape[2]
    q5, do5, delta = backward_prep(q, o, do, n_kv)
    dq = torch.zeros(q5.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    kk, vv, ks = k, v, seg
    for i in range(ring.n):
        kv_idx = (ring.my_idx - i) % ring.n
        if zigzag:
            zigzag_bwd_step(dq, dk, dv, q5, do5, lse, delta, kk, vv, seg, ks,
                            ring.my_idx, kv_idx, ring.n, has_seg)
        else:
            ring_bwd_step(dq, dk, dv, q5, do5, lse, delta, kk, vv, seg, ks,
                          ring.my_idx, kv_idx, causal, has_seg)
        if ring.n > 1:
            blocks = (kk, vv, ks) if i < ring.n - 1 else ()
            blocks, (dk, dv) = ring.shift(blocks, (dk, dv))
            if blocks:
                kk, vv, ks = blocks
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def loopback(kind: str, q, k, v, do, seg, n: int, causal: bool = True):
    """Context parallelism's forward and backward for n ranks held side by
    side in one process, through the distributed path's own code with
    the transport replaced: ``kind`` "ring" or "zigzag" runs each rank's
    :func:`_fwd` and :func:`_bwd` over a :class:`_LoopbackRing`, each
    block's dK/dV summed over the ranks' parts; "ulysses" runs
    :func:`_ulysses_body` for the n ranks stacked on the batch dim, the
    all-to-all a reshuffle of their chunks (:func:`_loopback_all_to_all`),
    its backward by autograd. q/k/v/dO [B, S, H, D] and segment ids [B,
    S] (None: unpacked) in the contiguous layout; returns (O, dQ, dK,
    dV) in it."""
    has_seg = seg is not None
    if kind == "ulysses":
        return _ulysses_loopback(q, k, v, do, seg, n, causal)
    zigzag = kind == "zigzag"
    if not has_seg:
        seg = _dummy_seg(q)
    perm = (lambda t: zigzag_permute(t, n)) if zigzag else (lambda t: t)
    qq, kk, vv, ss, dd = (perm(t) for t in (q, k, v, seg, do))
    s = q.shape[1] // n

    def blk(t, i):
        return t[:, i * s:(i + 1) * s]

    blocks = [(blk(kk, j), blk(vv, j), blk(ss, j)) for j in range(n)]
    sums: dict = {}
    outs, dqs = [], []
    for r in range(n):
        q_r = blk(qq, r)
        o, lse = _fwd(_LoopbackRing(r, n, blocks, sums), zigzag, causal,
                      has_seg, q_r, *blocks[r])
        dq, _, _ = _bwd(_LoopbackRing(r, n, blocks, sums), zigzag, causal,
                        has_seg, q_r, blocks[r][0], blocks[r][1], o, lse,
                        blocks[r][2], blk(dd, r))
        outs.append(o)
        dqs.append(dq)
    back = (lambda t: zigzag_unpermute(t, n)) if zigzag else (lambda t: t)
    dk = [sums[j][0].to(k.dtype) for j in range(n)]
    dv = [sums[j][1].to(v.dtype) for j in range(n)]
    return tuple(back(torch.cat(t, 1)) for t in (outs, dqs, dk, dv))


class _RingAttention(torch.autograd.Function):
    """O of the ring (or zigzag ring) over local shards; the backward
    runs the second ring (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, ring, zigzag, causal, has_seg):
        o, lse = _fwd(ring, zigzag, causal, has_seg, q, k, v, seg)
        ctx.save_for_backward(q, k, v, o, lse, seg)
        ctx.cfg = (ring, zigzag, causal, has_seg)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = _bwd(*ctx.cfg, q, k, v, o, lse, seg, do.contiguous())
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# Ulysses: all-to-all over the ring's group
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks along dim 0: chunk j goes to
    rank j, slot j holds rank j's chunk. It is its own adjoint, so the
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    # Contiguous in and out: the collective reads and writes flat memory
    # (a gradient may arrive as a permuted view).
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


def seq_to_heads(x: torch.Tensor, n: int, exchange=None) -> torch.Tensor:
    """[B, s, H, D] (a sequence block) -> [B, n*s, H/n, D] (the whole
    sequence for head group ``my_idx``): the heads split into n groups,
    group j to rank j, the blocks concatenated in rank order.
    ``exchange`` moves the [n, ...] chunks (the all-to-all)."""
    B, s, H, D = x.shape
    x = x.reshape(B, s, n, H // n, D).permute(2, 0, 1, 3, 4).contiguous()
    x = exchange(x) if exchange is not None else x
    return x.permute(1, 0, 2, 3, 4).reshape(B, n * s, H // n, D)


def heads_to_seq(o: torch.Tensor, n: int, exchange=None) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`: [B, n*s, H/n, D] ->
    [B, s, H, D]."""
    B, S, h, D = o.shape
    o = o.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4).contiguous()
    o = exchange(o) if exchange is not None else o
    return o.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


def _ulysses_body(q, k, v, seg_full, n: int, exchange, causal: bool,
                  has_seg: bool):
    """Ulysses over local sequence blocks [B, S/n, H, D]: the head split
    (:func:`seq_to_heads` through ``exchange``), attention over the whole
    sequence on H/n heads (``seg_full``: its segment ids), and back."""
    from skypilot_tpu_torch.ops import attention as attn_ops
    q, k, v = (seq_to_heads(t, n, exchange) for t in (q, k, v))
    o = attn_ops.gqa_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               segment_ids=seg_full if has_seg else None)
    return heads_to_seq(o, n, exchange)


def _ulysses(ring: Ring, causal: bool, has_seg: bool, q, k, v, seg):
    """One rank's Ulysses attention, the exchanges ``all_to_all_single``
    over the ring's group and the segment ids gathered whole."""
    n = ring.n
    exchange = None
    seg_full = seg
    if n > 1:
        exchange = lambda t: _AllToAll.apply(t, ring.group)   # noqa: E731
        if has_seg:
            parts = [torch.empty_like(seg) for _ in range(n)]
            dist.all_gather(parts, seg.contiguous(), group=ring.group)
            seg_full = torch.cat(parts, dim=1)
    return _ulysses_body(q, k, v, seg_full, n, exchange, causal, has_seg)


def _loopback_all_to_all(t: torch.Tensor, n: int) -> torch.Tensor:
    """The all-to-all of n ranks stacked on dim 1 (rank-major) of
    [n chunks, n * B, ...]: rank r's chunk j lands in rank j's slot r."""
    return t.reshape(n, n, t.shape[1] // n, *t.shape[2:]).transpose(
        0, 1).reshape(t.shape)


def _ulysses_loopback(q, k, v, do, seg, n: int, causal: bool):
    """:func:`loopback`'s Ulysses: the n ranks' blocks [B, S/n, ...]
    stacked on the batch dim, :func:`_ulysses_body` with the reshuffle
    for exchange (so ``gqa_attention`` runs once over the n head groups),
    dQ/dK/dV by autograd."""
    B, S = q.shape[:2]
    has_seg = seg is not None
    for name, t in (("q", q), ("kv", k)):
        if t.shape[2] % n:
            raise ValueError(f"{name} heads = {t.shape[2]} not divisible "
                             f"by {n} ranks")

    def stack(t):
        return t.reshape(B, n, S // n, *t.shape[2:]).transpose(0, 1).reshape(
            n * B, S // n, *t.shape[2:])

    def unstack(t):
        return t.reshape(n, B, S // n, *t.shape[2:]).transpose(0, 1).reshape(
            B, S, *t.shape[2:])

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = unstack(_ulysses_body(
        *(stack(t) for t in leaves), seg.repeat(n, 1) if has_seg else None,
        n, lambda t: _loopback_all_to_all(t, n), causal, has_seg))
    return (o.detach(),) + torch.autograd.grad(o, leaves, grad_outputs=do)


# ---------------------------------------------------------------------------
# Layouts and the public functions (DTensors or whole tensors in, a
# DTensor in q's layout out)
# ---------------------------------------------------------------------------

def _batch_spec(batch_axes, mesh, b: int):
    """The largest prefix of ``batch_axes`` whose product divides b
    (else None)."""
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    sizes = mesh_lib.mesh_shape(mesh).as_dict()
    keep, prod = [], 1
    for a in batch_axes or ():
        prod *= sizes[a]
        if b % prod != 0:
            break
        keep.append(a)
    return tuple(keep) if keep else None


def _qkv_specs(mesh, axis: str, batch_axes, heads_axis, q, k):
    """Specs with ``spec_for``'s divisibility fallback: a dim the mapped
    axis does not divide is replicated. Heads are split all or nothing
    across q and kv: splitting q heads over kv heads left whole would
    pair grouped heads with the wrong kv head."""
    sizes = mesh_lib.mesh_shape(mesh).as_dict()
    bspec = _batch_spec(batch_axes, mesh, q.shape[0])
    hspec = heads_axis
    if (heads_axis is None or q.shape[2] % sizes[heads_axis] != 0
            or k.shape[2] % sizes[heads_axis] != 0):
        hspec = None
    return ((bspec, axis, hspec, None), (bspec, axis, hspec, None),
            (bspec, axis))


def _local(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's shard of ``x`` laid out by ``spec`` (differentiable)."""
    return sh.distribute(x, mesh, spec).to_local().contiguous()


def _dummy_seg(q):
    return torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)


def _apply(kind: str, q, k, v, mesh, causal: bool, axis: str, batch_axes,
           heads_axis, segment_ids):
    q_spec, kv_spec, seg_spec = _qkv_specs(mesh, axis, batch_axes,
                                           heads_axis, q, k)
    has_seg = segment_ids is not None
    seg = segment_ids if has_seg else _dummy_seg(q)
    ql = _local(q, mesh, q_spec)
    kl, vl = _local(k, mesh, kv_spec), _local(v, mesh, kv_spec)
    segl = _local(seg, mesh, seg_spec)
    ring = Ring.of(mesh, axis)
    if kind == "ulysses":
        o = _ulysses(ring, causal, has_seg, ql, kl, vl, segl)
    else:
        o = _RingAttention.apply(ql, kl, vl, segl, ring, kind == "zigzag",
                                 causal, has_seg)
    return DTensor.from_local(o, mesh, sh.placements(q_spec, mesh),
                              run_check=False)


def _check_heads(q, k) -> None:
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")


def ring_attention(q, k, v, mesh, causal: bool = True, axis: str = "sp",
                   batch_axes=("dp", "fsdp"), heads_axis: Optional[str] = "tp",
                   segment_ids=None) -> DTensor:
    """Ring attention over ``axis``. q [B, S, Hq, D]; k/v [B, S, Hkv, D]
    (GQA: Hq % Hkv == 0, the unrepeated kv heads travel); segment ids
    [B, S] mask packed documents. Inputs are DTensors on ``mesh`` or
    whole tensors (the same on every rank)."""
    n = mesh_lib.mesh_shape(mesh).as_dict()[axis]
    if q.shape[1] % n != 0:
        raise ValueError(f"seq {q.shape[1]} not divisible by {axis}={n}")
    _check_heads(q, k)
    return _apply("ring", q, k, v, mesh, causal, axis, batch_axes,
                  heads_axis, segment_ids)


def zigzag_ring_attention(q, k, v, mesh, axis: str = "sp",
                          batch_axes=("dp", "fsdp"),
                          heads_axis: Optional[str] = "tp",
                          segment_ids=None) -> DTensor:
    """The load-balanced causal ring over ``axis``. Inputs must be in the
    zigzag layout (:func:`zigzag_permute` along the sequence, with their
    positions and segment ids); the output stays in it."""
    n = mesh_lib.mesh_shape(mesh).as_dict()[axis]
    if q.shape[1] % (2 * n) != 0:
        raise ValueError(f"zigzag needs seq divisible by 2*{axis}={2 * n}, "
                         f"got {q.shape[1]}")
    _check_heads(q, k)
    return _apply("zigzag", q, k, v, mesh, True, axis, batch_axes,
                  heads_axis, segment_ids)


def ulysses_attention(q, k, v, mesh, causal: bool = True, axis: str = "sp",
                      batch_axes=("dp", "fsdp"),
                      heads_axis: Optional[str] = "tp",
                      segment_ids=None) -> DTensor:
    """All-to-all (Ulysses) sequence parallelism over ``axis``: the
    per-shard q and kv head counts must be divisible by its size."""
    sizes = mesh_lib.mesh_shape(mesh).as_dict()
    n = sizes[axis]
    if q.shape[1] % n != 0:
        raise ValueError(f"seq {q.shape[1]} not divisible by {axis}={n}")
    q_spec, _, _ = _qkv_specs(mesh, axis, batch_axes, heads_axis, q, k)
    tp = sizes[heads_axis] if q_spec[2] is not None else 1
    for name, arr in (("q", q), ("kv", k)):
        local_heads = arr.shape[2] // (tp if arr.shape[2] % tp == 0 else 1)
        if local_heads % n != 0:
            raise ValueError(
                f"{name} heads/shard = {local_heads} not divisible by "
                f"{axis}={n}; use ring_attention instead")
    return _apply("ulysses", q, k, v, mesh, causal, axis, batch_axes,
                  heads_axis, segment_ids)


def context_parallel_attention(q, k, v, mesh, causal: bool = True,
                               impl: str = "ring", **kw) -> DTensor:
    """Dispatch: ``impl`` in {"ring", "ulysses"}."""
    if impl == "ulysses":
        return ulysses_attention(q, k, v, mesh, causal=causal, **kw)
    return ring_attention(q, k, v, mesh, causal=causal, **kw)


# ---------------------------------------------------------------------------
# The zigzag layout
# ---------------------------------------------------------------------------

def zigzag_indices(seq_len: int, n: int):
    """Global row order of the zigzag layout: shard i holds chunks
    (i, 2n-1-i). Returns (permute_idx, unpermute_idx), int32 arrays."""
    if seq_len % (2 * n) != 0:
        raise ValueError(f"seq {seq_len} not divisible by 2*{n}")
    c = seq_len // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * n - 1 - i) * c, (2 * n - i) * c))
    perm = np.asarray(order, dtype=np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len, dtype=np.int32)
    return perm, inv


def _take(x: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    """``x`` reordered along ``axis`` by ``idx``. A DTensor split along
    that axis is gathered there, reordered, and split again (the
    sequence moves between ranks)."""
    if not isinstance(x, DTensor):
        return x.index_select(axis, torch.from_numpy(idx).long().to(
            x.device))
    mesh, pl = x.device_mesh, x.placements
    whole = [Replicate() if isinstance(p, Shard) and p.dim == axis else p
             for p in pl]
    local = x.redistribute(mesh, whole).to_local()
    out = local.index_select(axis, torch.from_numpy(idx).long().to(
        local.device))
    return DTensor.from_local(out, mesh, whole,
                              run_check=False).redistribute(mesh, pl)


def zigzag_permute(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    perm, _ = zigzag_indices(x.shape[axis], n)
    return _take(x, perm, axis)


def zigzag_unpermute(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    _, inv = zigzag_indices(x.shape[axis], n)
    return _take(x, inv, axis)


def apply_zigzag_layout(x, positions, segment_ids, mesh, rules):
    """The model side of the zigzag layout, shared by the decoder models:
    the layout applies when the rules ask for it (``seq_layout:
    zigzag``), the sequence's mesh axis is above 1 and S divides 2n;
    then the activations x [B, S, ...], positions ([S] or [B, S]) and
    segment ids are permuted once. Where it does not apply the layout
    key is dropped, so the attention dispatch agrees with the layout.

    Returns ``(x, positions, segment_ids, layer_rules, use_zigzag,
    n_sp)``; with ``use_zigzag`` the caller unpermutes its final hidden
    states with ``zigzag_unpermute(x, n_sp)``."""
    use_zigzag, n_sp = False, 1
    if (mesh is not None and rules is not None
            and rules.get("seq_layout") == "zigzag"):
        S = x.shape[1]
        seq_axis = rules.get("seq")
        n_sp = (mesh_lib.mesh_shape(mesh).as_dict().get(seq_axis, 1)
                if isinstance(seq_axis, str) else 1)
        use_zigzag = n_sp > 1 and S % (2 * n_sp) == 0
        if use_zigzag:
            x = zigzag_permute(x, n_sp)
            positions = zigzag_permute(positions, n_sp,
                                       axis=positions.dim() - 1)
            if segment_ids is not None:
                segment_ids = zigzag_permute(segment_ids, n_sp)
    layer_rules = rules
    if (rules is not None and rules.get("seq_layout") == "zigzag"
            and not use_zigzag):
        layer_rules = {k: v for k, v in rules.items() if k != "seq_layout"}
    return x, positions, segment_ids, layer_rules, use_zigzag, n_sp
