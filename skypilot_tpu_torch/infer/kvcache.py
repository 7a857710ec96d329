"""Paged KV cache: wave prefill, insert, chunked prefill and the staged
decode burst.

Counterpart of the paged serving subset of
``skypilot_tpu/infer/kvcache.py``: the block pool
``[L, n_blocks, block_len, G, hd]``, a per-slot block table mapping
logical block j to a physical block id, wave prefill
(:func:`prefill_batch` + :func:`insert`), chunked prefill
(:func:`claim_slot` + :func:`prefill_chunk`), the prefix cache's
copy-on-write (:func:`copy_block`), the draft engine's lockstep write
(:func:`sync_slots`), the staged decode burst
(:func:`decode_burst_staged`) and the speculative verify round
(:func:`verify_draft_staged`). The chunk's, the burst's and the verify
round's big-cache attention goes through the paged-attention kernel and
merges with the columns they hold outside the cache (the chunk's own
rows, the staged rows).

The int8 recipe (the reference's ``--kv-int8 --weights-int8``): an int8
cache stores each K/V row as int8 values with one bfloat16 absmax scale
per (row, kv-head) (:func:`quantize_rows`), and w8a8 weights run every
block projection and the LM head as an s8 x s8 -> s32 product of
per-output-channel int8 weights (:func:`quantize_weight`) and per-token
int8 activations (:func:`qeinsum`). Both give the reference's bits on
the same inputs: see :func:`_scale`.

Two differences from the JAX module, both about mutation:

* JAX donated the cache buffers and got updated copies back; the port
  updates the cache dict's tensors **in place** (``index_put_`` and
  slice assignment) and returns nothing from the writers.
* JAX scatters drop out-of-bounds updates, and the engine relies on it:
  table entries equal to ``n_blocks`` are sentinels, and writes of
  padding rows, dead slots and rows past a slot's allocation route
  there. Torch raises on such an index instead, so the pool holds one
  **trash block** past the ``n_blocks`` the allocator hands out: the
  sentinel id addresses it, sentinel writes land there, and no read
  ever admits its rows (they lie past every slot's length). Table
  columns past the sentinel column clamp to it, as JAX gathers clamp.

Layer loops are Python loops over the stacked ``[L, ...]`` weights where
JAX used ``lax.scan``. Attention runs the CUDA kernels on CUDA tensors
(their plain versions on CPU tensors); ``plain_attention=True`` runs the
plain versions on any device, as the reference the kernels are held to.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.infer import adapters as adapters_lib
from skypilot_tpu_torch.infer import sampling as sampling_mod
from skypilot_tpu_torch.models import llama, moe
from skypilot_tpu_torch.ops import attention as attn_ops
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.ops import paged_attention as paged_attn_ops

Cache = Dict[str, torch.Tensor]
QWeights = Dict[str, Dict]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# int8 weights and activations (w8a8) and int8 KV rows
# ---------------------------------------------------------------------------
# Weights are quantized per OUTPUT channel once, at engine init;
# activations per token inside every program; a product rescales its
# int32 accumulator by (activation scale x weight scale). Prefill runs
# the same w8a8 path as decode, so a w8a8 engine keeps no float copy of
# the seven block matrices or of the head (:func:`slim_params`).

def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """The int8 scale of an absmax: ``max(absmax, 1e-8) / 127``. The
    reference's programs run under ``jax.jit``, where XLA folds the
    division by the constant 127 into a multiply by its float32
    reciprocal; the port multiplies by the same float32 number, so every
    scale has the reference's bits. The values are then divided by the
    scale (a true division, as in the reference)."""
    return absmax.clamp_min(1e-8) * (1.0 / 127.0)


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to +-127: ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def int8_layout(w: torch.Tensor, contract_ndim: int,
                lead_ndim: int = 0) -> torch.Tensor:
    """``w`` (``[lead..., contract..., out...]``) with the same shape and
    values, stored output-major: memory order ``[lead..., out...,
    contract...]``, so each product's 2-D weight view ``[K, N]`` is
    column-major. That is the int8 GEMM's native layout in cuBLASLt,
    which ``torch._int_mm`` calls: with a row-major weight it reports
    CUBLAS_STATUS_NOT_SUPPORTED at some shapes."""
    n = w.dim()
    c = range(lead_ndim, lead_ndim + contract_ndim)
    o = range(lead_ndim + contract_ndim, n)
    order = [*range(lead_ndim), *o, *c]
    inverse = [order.index(i) for i in range(n)]
    return w.permute(order).contiguous().permute(inverse)


def quantize_weight(w: torch.Tensor, contract_ndim: int
                    ) -> Dict[str, torch.Tensor]:
    """Per-output-channel absmax int8. ``contract_ndim``: how many
    LEADING dims the consuming product contracts; the rest are output
    channels. Returns {"w": int8 like ``w`` (stored output-major,
    :func:`int8_layout`), "s": float32 [out...]}."""
    wf = w.float()
    s = _scale(wf.abs().amax(dim=tuple(range(contract_ndim))))
    return {"w": int8_layout(_to_int8(wf, s), contract_ndim), "s": s}


# How many leading dims (after the layer dim) each block weight
# contracts in its consuming product.
QUANT_CONTRACT = {"wq": 1, "wk": 1, "wv": 1, "wo": 2,
                  "w_gate": 1, "w_up": 1, "w_down": 1}


@torch.no_grad()
def quantize_block_weights(params: llama.Params) -> Dict[str, Dict]:
    """int8 copies of the stacked per-layer matmul weights (the norms and
    the embedding stay float), quantized one layer at a time on the
    weights' device, so the float32 temporaries stay one layer's size."""
    blocks = params["blocks"]
    out = {}
    for name, nd in QUANT_CONTRACT.items():
        w = blocks[name]
        L = w.shape[0]
        q = int8_layout(torch.empty(w.shape, dtype=torch.int8,
                                    device=w.device), nd, lead_ndim=1)
        s = torch.empty((L,) + tuple(w.shape[1 + nd:]),
                        dtype=torch.float32, device=w.device)
        for i in range(L):
            one = quantize_weight(w[i], nd)
            q[i], s[i] = one["w"], one["s"]
        out[name] = {"w": q, "s": s}
    return out


@torch.no_grad()
def quantize_head(params: llama.Params, cfg: llama.LlamaConfig
                  ) -> Dict[str, torch.Tensor]:
    return quantize_weight(llama.lm_head(params, cfg), 1)


def slim_params(params: llama.Params) -> llama.Params:
    """Drop the float copies of quantized weights: blocks keep only the
    norms; the head is the quantized one."""
    return {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "blocks": {"ln1": params["blocks"]["ln1"],
                   "ln2": params["blocks"]["ln2"]},
    }


@torch.no_grad()
def random_quantized_params(cfg: llama.LlamaConfig, seed: int = 0,
                            device: DeviceLike = None
                            ) -> Tuple[llama.Params, QWeights]:
    """(slim float params, qweights) with random int8 weights, drawn from
    a ``torch.Generator`` on ``device`` without ever materializing the
    float tree (the reference's recipe for an 8B benchmark). The
    distributions are the reference's (int8 uniform in [-127, 127],
    scales 0.02 / 127, embedding N(0, 0.02) in bfloat16); the draws are
    torch's, not JAX's."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def q(shape, out_ndim):
        w = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        lead = 1 if len(shape) > out_ndim + 1 else 0       # layer dim
        w = int8_layout(w, len(shape) - out_ndim - lead, lead)
        return {"w": w, "s": torch.full(shape[:lead] + shape[-out_ndim:],
                                        0.02 / 127.0, dtype=torch.float32,
                                        device=device)}

    blocks = {
        "wq": q((L, d, nh, hd), 2),
        "wk": q((L, d, nkv, hd), 2),
        "wv": q((L, d, nkv, hd), 2),
        "wo": q((L, nh, hd, d), 1),
        "w_gate": q((L, d, ff), 1),
        "w_up": q((L, d, ff), 1),
        "w_down": q((L, ff, d), 1),
    }
    params = {
        "embed": (torch.randn((v, d), generator=gen, device=device,
                              dtype=torch.bfloat16) * 0.02),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "blocks": {"ln1": torch.ones((L, d), dtype=torch.float32,
                                     device=device),
                   "ln2": torch.ones((L, d), dtype=torch.float32,
                                     device=device)},
    }
    return params, {"blocks": blocks, "head": q((d, v), 1)}


def qweights_from_numpy(tree: Dict, device: DeviceLike = None
                        ) -> QWeights:
    """A JAX qweights tree (``{"blocks": {name: {"w", "s"}}, "head":
    {"w", "s"}}`` of numpy arrays) -> the port's tensors: int8 values
    (stored output-major, :func:`int8_layout`) and float32 scales, the
    values copied one to one (the counterpart of ``models/llama.py``
    ``params_from_numpy``)."""
    device = resolve_device(device)

    def conv(x, nd=None, lead=0):
        t = torch.from_numpy(np.array(x)).to(device)
        return t if nd is None else int8_layout(t, nd, lead)

    blocks = {name: {"w": conv(qw["w"], QUANT_CONTRACT[name], 1),
                     "s": conv(qw["s"])}
              for name, qw in tree["blocks"].items()}
    head = {"w": conv(tree["head"]["w"], 1), "s": conv(tree["head"]["s"])}
    return {"blocks": blocks, "head": head}


def qlayer_slice(qweights: Optional[QWeights], i: int) -> Optional[Dict]:
    """Layer ``i`` of the stacked int8 block weights (views), or None."""
    if qweights is None:
        return None
    return {name: {"w": qw["w"][i], "s": qw["s"][i]}
            for name, qw in qweights["blocks"].items()}


# The CUDA build of ``torch._int_mm`` takes more than 16 rows and K and N
# that are multiples of 8.
_INT_MM_MIN_ROWS = 17


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s8 ``a`` [M, K] @ s8 ``b`` [K, N] -> s32 [M, N] through
    ``torch._int_mm``, the one place the port calls it. Fewer than 17
    rows are padded with zero rows (a zero row changes no other row: the
    scales are per row) and sliced off; K and N must be multiples of 8
    on every device, so a shape the card's build would refuse fails on
    the CPU too. ``b`` is expected column-major (:func:`int8_layout`).
    There is no float fallback."""
    M, K = a.shape
    if K % 8 or b.shape[1] % 8:
        raise ValueError(f"int8_matmul: K={K} and N={b.shape[1]} must be "
                         f"multiples of 8")
    if M < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - M, K))])
    return torch._int_mm(a.contiguous(), b)[:M]


def _act_quant(x: torch.Tensor, n_contract: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8: absmax over the TRAILING ``n_contract`` dims.
    Returns (int8 like ``x``, float32 scales ``x.shape[:-n_contract]``)."""
    xf = x.float()
    dims = tuple(range(x.dim() - n_contract, x.dim()))
    s = _scale(xf.abs().amax(dim=dims))
    return _to_int8(xf, s[(...,) + (None,) * n_contract]), s


def qeinsum(x: torch.Tensor, qw: Dict[str, torch.Tensor], n_contract: int,
            out_dtype) -> torch.Tensor:
    """w8a8 product: x's trailing ``n_contract`` dims against the int8
    weight's leading ones (the reference's ``bsd,dhk->bshk``,
    ``bshk,hkd->bsd``, ``bsd,df->bsf``, ``d,dv->v`` ... all have that
    form), as one :func:`int8_matmul` over 2-D views. The int32
    accumulator widens to float32 and is multiplied by the scale product
    ``sx (x) s``, formed first, then cast: the reference's order, and so
    its bits."""
    xq, sx = _act_quant(x, n_contract)
    w, s = qw["w"], qw["s"]
    lead = x.shape[:x.dim() - n_contract]
    out = w.shape[n_contract:]
    k = math.prod(w.shape[:n_contract])
    acc = int8_matmul(xq.reshape(-1, k), w.reshape(k, -1))
    acc = acc.reshape(*lead, *out).float()
    scale = sx[(...,) + (None,) * s.dim()] * s
    return (acc * scale).to(out_dtype)


def proj(x: torch.Tensor, layer: Dict, qlayer: Optional[Dict], name: str,
         n_contract: int, dtype) -> torch.Tensor:
    """One weight product: w8a8 (:func:`qeinsum`) when ``qlayer`` holds
    the weights, else x's trailing ``n_contract`` dims against
    ``layer[name]`` in ``dtype``. Prefill and decode share it, so a w8a8
    engine needs no float copy of the block matrices."""
    if qlayer is not None:
        return qeinsum(x, qlayer[name], n_contract, dtype)
    w = layer[name].to(dtype)
    lead = x.shape[:x.dim() - n_contract]
    k = math.prod(w.shape[:n_contract])
    y = x.reshape(*lead, k) @ w.reshape(k, -1)
    return y.reshape(*lead, *w.shape[n_contract:])


def _head(cfg: llama.LlamaConfig, params: llama.Params,
          qweights: Optional[QWeights], x: torch.Tensor) -> torch.Tensor:
    """LM head on final-norm hidden states [..., D] -> float32 logits:
    w8a8 with ``qweights``, else :func:`llama.logits`."""
    if qweights is not None:
        return qeinsum(x, qweights["head"], 1, torch.float32)
    return llama.logits(x, params, cfg)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., G, hd] -> (int8 values, float32 [..., G] absmax scales)."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=-1))
    return _to_int8(xf, s[..., None]), s


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Paged block-pool layout
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: llama.LlamaConfig, n_slots: int, n_blocks: int,
                     block_len: int, device: torch.device,
                     kv_int8: bool = False) -> Cache:
    """Block-pool decode state: ``n_blocks`` physical blocks of
    ``block_len`` rows shared by ``n_slots`` slots, plus the trash
    block (id ``n_blocks``) that sentinel writes land in. ``kv_int8``:
    int8 pools with bfloat16 scales ``[L, n_blocks + 1, G, block_len]``
    (the row dim last, as the reference lays them out and the kernel
    reads them), whatever ``cfg.dtype`` is."""
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (L, n_blocks + 1, block_len, G, hd)
    kdt = torch.int8 if kv_int8 else cfg.dtype
    cache = {
        "length": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "last_token": torch.zeros((n_slots,), dtype=torch.long,
                                  device=device),
        "k": torch.zeros(shape, dtype=kdt, device=device),
        "v": torch.zeros(shape, dtype=kdt, device=device),
    }
    if kv_int8:
        sshape = (L, n_blocks + 1, G, block_len)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)
    return cache


class BlockAllocator:
    """Host-side ref-counted allocator over the paged block pool.

    Pure bookkeeping — no device state. Invariants: a block is FREE xor
    referenced; alloc hands out ref==1 blocks in ascending id order
    (deterministic); incref requires a live block; decref of a free
    block raises (double-free guard); a block is writable only at
    ref==1.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self.reset()

    def reset(self) -> None:
        # Popped from the end: blocks hand out in ascending id order.
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._ref = [0] * self.n_blocks

    @property
    def used(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def incref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(f"incref of free block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    def ref(self, block: int) -> int:
        return self._ref[block]

    def writable(self, block: int) -> bool:
        """Safe to scatter into: exactly one owner."""
        return self._ref[block] == 1


@torch.no_grad()
def copy_block(cache: Cache, src: int, dst: int) -> None:
    """Copy-on-write (in place): duplicate physical block ``src``'s rows,
    and on an int8 cache their scales, into block ``dst`` in every layer.
    All ``block_len`` rows copy; rows past the shared prefix are garbage
    in both blocks and stay unreadable until the new owner overwrites
    them."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in cache:
            cache[name][:, dst] = cache[name][:, src]


def export_blocks(cache: Cache, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather the physical blocks ``ids`` ([nb] int) out of the paged
    pool: ``k``/``v`` as [L, nb, block_len, G, hd] and, on an int8
    cache, ``k_scale``/``v_scale`` as [L, nb, G, block_len] — the
    device half of a cross-replica KV handoff.

    Deliberate difference from the reference: it gathers a fixed-width
    id vector padded with the sentinel (one jitted program whatever the
    block count) and the host slices ``[:, :nb]`` before the wire. Eager
    torch compiles nothing, and the port's sentinel is a real block (the
    trash block), so only the ``nb`` real ids are gathered; the wire is
    the same."""
    return {name: cache[name][:, ids]
            for name in ("k", "v", "k_scale", "v_scale") if name in cache}


def import_blocks(cache: Cache, ids: torch.Tensor,
                  vals: Dict[str, torch.Tensor]) -> None:
    """Scatter exported block rows into the freshly allocated physical
    blocks ``ids`` ([nb] int), in place, cast to each pool's dtype — the
    receive half of a cross-replica KV handoff. As in
    :func:`export_blocks`, only the ``nb`` real ids are written (the
    reference pads with the sentinel and drops those writes)."""
    for name, v in vals.items():
        cache[name][:, ids] = v.to(cache[name].dtype)


@torch.no_grad()
def sync_slots(cache: Cache, active: torch.Tensor, lengths: torch.Tensor,
               tokens: torch.Tensor) -> None:
    """Force the selected slots' ``length`` and ``last_token`` to the
    given values, in place, in one batched write: the draft engine's
    lockstep and rollback seam (``infer/draft.py``).

    A mispredicted draft rollout's rows lie past the committed length by
    construction (the free rollback the verify window's rows have too),
    so rolling a draft slot back to the verifier's commit point, or
    pointing its pending token at the correction token, is this
    bookkeeping write alone: no K/V row and no block moves. ``active``
    [slots] bool masks the slots that sync; the rest keep their values.
    """
    cache["length"].copy_(torch.where(active, lengths.to(torch.int32),
                                      cache["length"]))
    cache["last_token"].copy_(torch.where(
        active, tokens.to(cache["last_token"].dtype), cache["last_token"]))


def _logical_rows(cache: Cache, table: torch.Tensor) -> int:
    """Rows a slot's attention spans: blocks_per_slot * block_len (the
    table's last column is the sentinel and holds no rows)."""
    return (table.shape[1] - 1) * cache["k"].shape[2]


def _phys(cache: Cache, table: torch.Tensor, slots, idx: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, logical row) -> (physical block, row in block) through the
    block table. Logical rows past the table clamp to its sentinel
    column, whose id addresses the trash block."""
    bl = cache["k"].shape[2]
    col = (idx // bl).clamp(max=table.shape[1] - 1)
    return table[slots, col].long(), idx % bl


Rows = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
             Optional[torch.Tensor]]


def _stored_rows(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Rows:
    """K/V rows ``[..., G, hd]`` in the cache's storage: ``(k, v, k_scale,
    v_scale)``, int8 values with bfloat16 scales ``[..., G]`` on an int8
    cache (:func:`quantize_rows`), the pool's dtype and no scales on a
    float one."""
    if "k_scale" not in cache:
        return k.to(cache["k"].dtype), v.to(cache["v"].dtype), None, None
    sdt = cache["k_scale"].dtype
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    return kq, vq, ks.to(sdt), vs.to(sdt)


def _write_rows(cache: Cache, blk: torch.Tensor, off: torch.Tensor,
                rows: Rows) -> None:
    """In-place scatter of every layer's stored rows (:func:`_stored_rows`):
    k/v ``[L, *blk.shape, G, hd]`` land at ``[:, blk, off]``, scales
    ``[L, *blk.shape, G]`` at ``[:, blk, :, off]``."""
    k, v, ks, vs = rows
    cache["k"][:, blk, off] = k
    cache["v"][:, blk, off] = v
    if ks is not None:
        # Non-adjacent advanced indices put the broadcast dims first:
        # the update is [*blk.shape, L, G].
        cache["k_scale"][:, blk, :, off] = ks.movedim(0, -2)
        cache["v_scale"][:, blk, :, off] = vs.movedim(0, -2)


def _paged_attn_stats(cache: Cache, i: int, table: torch.Tensor,
                      qh: torch.Tensor, lengths: torch.Tensor,
                      span: Optional[int], plain: bool = False):
    """Big-cache attention stats of layer ``i`` through the paged
    kernel: per (slot, kv-head) it walks the slot's block table over
    ``ceil(span / block_len)`` blocks and masks ``col < lengths``; on an
    int8 cache it folds the rows' scales in. Returns the unnormalized
    ``(acc, m, l)`` for :func:`_merge_attn_parts`."""
    bl = cache["k"].shape[2]
    M = span if span is not None else _logical_rows(cache, table)
    fn = (paged_attn_ops.paged_attention_ref if plain
          else paged_attn_ops.paged_attention)
    return fn(qh, cache["k"], cache["v"], cache.get("k_scale"),
              cache.get("v_scale"), table, lengths, i,
              span_blocks=-(-M // bl))


def _merge_attn_parts(acc, m, l, ss):
    """Two-block online-softmax combine: fold the staged-columns block
    (masked scores ``ss`` [..., W], masked at -1e30) into the kernel's
    big-cache stats. Returns (alpha, w_s, l_tot); the output is
    ``(acc * alpha + w_s @ v_staged) / l_tot``. A slot with no valid
    cache rows reports m == -1e30 and ``alpha`` underflows to 0."""
    m_tot = torch.maximum(m, ss.amax(dim=-1))
    alpha = torch.exp(m - m_tot)
    w_s = torch.exp(ss - m_tot[..., None])
    l_tot = (l * alpha + w_s.sum(dim=-1)).clamp_min(1e-30)
    return alpha, w_s, l_tot


def _bf16_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 einsum with float32 accumulation (the JAX programs'
    ``preferred_element_type=float32``): inputs round to bf16, then
    multiply in float32, where a product of two bf16 values is exact."""
    return torch.einsum(eq, a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# Multi-LoRA adapter deltas (infer/adapters.py)
# ---------------------------------------------------------------------------
# Every program below takes an optional ``lora`` pool (per target {"a":
# [L, N, d_in..., r], "b": [L, N, r, d_out...]}) and an ``aid`` vector
# of per-row adapter-pool slots. The delta is the factored pair
# x @ A[aid] @ B[aid] (alpha/rank already folded into B at load), added
# to the base projection in ``cfg.dtype`` (after the w8a8 product on an
# int8 engine, as the reference's ``_layer_parts`` combines them): one
# gather per layer per target, so requests for different fine-tunes
# share one call. The reference leaves these products to XLA, so they
# stay torch here. Pool slot 0 is all zeros: a base-model row adds an
# exact-zero delta. A call without ``lora`` runs the code it ran before
# adapters existed.

def _lora_in_delta(h: torch.Tensor, ab: Dict[str, torch.Tensor],
                   aid: torch.Tensor) -> torch.Tensor:
    """Per-row delta for an embed->heads/kv target. h: [B, S, D]; ab:
    ONE layer's pool slice {"a": [N, D, r], "b": [N, r, H, hd]}; aid:
    [B] pool slots."""
    a = ab["a"][aid].to(h.dtype)                       # [B, D, r]
    b = ab["b"][aid].to(h.dtype)                       # [B, r, H, hd]
    u = torch.bmm(h, a)                                # [B, S, r]
    B, r, H, hd = b.shape
    return torch.bmm(u, b.reshape(B, r, H * hd)).reshape(
        *h.shape[:2], H, hd)


def _lora_out_delta(o: torch.Tensor, ab: Dict[str, torch.Tensor],
                    aid: torch.Tensor) -> torch.Tensor:
    """Per-row delta for the wo target. o (the attention output before
    the projection): [B, S, H, hd]; a: [N, H, hd, r]; b: [N, r, D]."""
    a = ab["a"][aid].to(o.dtype)                       # [B, H, hd, r]
    b = ab["b"][aid].to(o.dtype)                       # [B, r, D]
    B, H, hd, r = a.shape
    u = torch.bmm(o.reshape(B, -1, H * hd), a.reshape(B, H * hd, r))
    return torch.bmm(u, b)                             # [B, S, D]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_batch(params: llama.Params, tokens: torch.Tensor,
                  true_lens: torch.Tensor, cfg: llama.LlamaConfig,
                  plain_attention: bool = False,
                  qweights: Optional[QWeights] = None,
                  lora: Optional[Dict] = None,
                  aid: Optional[torch.Tensor] = None
                  ) -> Tuple[Cache, torch.Tensor]:
    """Causal forward over a WAVE of right-padded prompts.

    tokens: [W, S_bucket] int64, true_lens: [W]. Returns ({"k","v"}:
    [L, W, S_bucket, G, hd] post-rope rows, logits at each request's
    last real position [W, vocab] float32). Attention is the flash
    kernel (``ops/attention.py``), or with ``plain_attention`` its
    plain version. With ``qweights`` the block products and the head
    run w8a8, so ``params`` may be the slim tree (embedding and norms
    only). ``lora``/``aid``: the adapter pool and each wave row's pool
    slot."""
    attention = attn_ops.gqa_attention
    if plain_attention:
        def attention(q, k, v):
            return flash_ops.flash_attention_fwd_ref(q, k, v)[0]
    W, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    cos, sin = llama.rope_frequencies(
        cfg, torch.arange(S, device=tokens.device))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = llama.layer_slice(params, i)
        qlayer = qlayer_slice(qweights, i)
        llayer = adapters_lib.lora_layer(lora, i)
        q, k, v = _decode_qkv(cfg, layer, qlayer, x, cos, sin, llayer, aid)
        x = _decode_out_ffn(cfg, layer, qlayer, x, attention(q, k, v),
                            llayer, aid)
        ks.append(k)
        vs.append(v)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(W, device=x.device), true_lens.long() - 1]
    return ({"k": torch.stack(ks), "v": torch.stack(vs)},
            _head(cfg, params, qweights, last))


@torch.no_grad()
def insert(cache: Cache, prefix: Cache, slot: int, true_len,
           first_token, table: torch.Tensor) -> None:
    """Install a prefilled prompt into decode slot ``slot`` (in place).

    prefix k/v: [L, S_bucket, G, hd]; the rows scatter through the
    slot's block table, quantized first on an int8 cache. Rows >=
    true_len are padding but harmless — decode masks by ``length``; rows
    past the slot's allocation land in the trash block."""
    S = prefix["k"].shape[1]
    blk, off = _phys(cache, table, slot,
                     torch.arange(S, device=prefix["k"].device))
    _write_rows(cache, blk, off,
                _stored_rows(cache, prefix["k"], prefix["v"]))
    cache["length"][slot] = true_len
    cache["last_token"][slot] = first_token


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def claim_slot(cache: Cache, slot: int, claim_len: int) -> None:
    """Claim a slot for a cold chunked prefill (in place): its length is
    stamped to ``claim_len`` (max_len), so the rows that interleaved
    decode bursts flush for every slot, active or not, at index
    ``length`` fall past the table and land in the trash block instead
    of over rows a finished chunk already wrote."""
    cache["length"][slot] = claim_len


@torch.no_grad()
def prefill_chunk(params: llama.Params, cache: Cache,
                  tokens_c: torch.Tensor, start: int, n_valid: int,
                  slot: int, new_len: int, cfg: llama.LlamaConfig,
                  sp: sampling_mod.SamplingParams, table: torch.Tensor, *,
                  final: bool, span: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  plain_attention: bool = False,
                  qweights: Optional[QWeights] = None,
                  lora: Optional[Dict] = None,
                  aid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One chunk of an incremental prefill into decode slot ``slot``.

    tokens_c: [C] right-padded chunk; ``start``: the chunk's first row
    in the slot's sequence (rows below it, earlier chunks, are in the
    cache); ``n_valid``: its real tokens; ``new_len``: the length to
    stamp (max_len mid-prompt, the true total on the final chunk).
    Attention is the big-cache block over the slot's rows below
    ``start`` (the paged kernel with the chunk's ``C * rep`` query rows
    per kv-head, through its block table, ``span``-bounded) merged with
    the causal intra-chunk block, which stays a plain bf16 product as
    the JAX program leaves it to XLA. The chunk's rows then scatter
    through the table (rows past max_len land in the trash block) and
    ``length`` is stamped, in place. On an int8 cache the big-cache read
    folds the stored rows' scales in, the intra-chunk block scores the
    chunk's own unquantized rows (as the reference does), and the rows
    are quantized as they are written. ``qweights``: w8a8 products and
    head. ``lora``/``aid``: the adapter pool and the per-slot pool
    slots, of which the chunk reads ``aid[slot]``. Returns the first
    token sampled at the last valid position on the ``final`` chunk,
    else 0 (device tensors)."""
    C = tokens_c.shape[0]
    G, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // G
    scale = hd ** -0.5
    dev = tokens_c.device
    x = params["embed"].to(cfg.dtype)[tokens_c][None]          # [1, C, D]
    cos, sin = llama.rope_frequencies(
        cfg, start + torch.arange(C, device=dev))
    j = torch.arange(C, device=dev)
    # Padding columns (>= n_valid) are masked out of the intra-chunk
    # scores; padding rows compute rows past the prompt's length, which
    # no read admits.
    intra = (j[None, :] <= j[:, None]) & (j[None, :] < n_valid)
    tbl = table[slot:slot + 1]
    lens = torch.full((1,), start, dtype=torch.int32, device=dev)
    # The chunk runs ONE slot: its adapter id, aligned with x's batch.
    aid_b = aid[slot:slot + 1] if lora is not None else None
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = llama.layer_slice(params, i)
        qlayer = qlayer_slice(qweights, i)
        llayer = adapters_lib.lora_layer(lora, i)
        q, k, v = _decode_qkv(cfg, layer, qlayer, x, cos, sin, llayer,
                              aid_b)
        kr, vr = k[0], v[0]                                    # [C, G, hd]
        ks.append(kr)
        vs.append(vr)
        qh = q[0].reshape(C, G, rep, hd).to(torch.bfloat16)
        ss = _bf16_dot("cgrk,jgk->cgrj", qh, kr) * scale
        ss = ss.masked_fill(~intra[:, None, None, :], NEG_INF)
        # The chunk's C * rep rows of each kv-head in one (slot,
        # kv-head) cell of the kernel, masked below ``start``.
        q_k = qh.permute(1, 0, 2, 3).reshape(1, G, C * rep, hd)
        acc, m, l = _paged_attn_stats(cache, i, tbl, q_k.contiguous(),
                                      lens, span, plain_attention)
        acc = acc.reshape(G, C, rep, hd).permute(1, 0, 2, 3)
        m = m.reshape(G, C, rep).permute(1, 0, 2)
        l = l.reshape(G, C, rep).permute(1, 0, 2)
        alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, ss)
        o = acc * alpha[..., None] + _bf16_dot("cgrj,jgk->cgrk", w_s, vr)
        x = _decode_out_ffn(cfg, layer, qlayer, x, o / l_tot[..., None],
                            llayer, aid_b)
    if final:
        x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _head(cfg, params, qweights, x[:, n_valid - 1])
        tok = sampling_mod.sample(logits, sp, generator)[0]
    else:
        tok = torch.zeros((), dtype=torch.long, device=dev)
    blk, off = _phys(cache, table, slot, start + j)
    _write_rows(cache, blk, off,
                _stored_rows(cache, torch.stack(ks), torch.stack(vs)))
    cache["length"][slot] = new_len
    if final:
        cache["last_token"][slot] = tok
    return tok


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_qkv(cfg, layer, qlayer, x, cos, sin, llayer=None, aid=None):
    """Layer front half: norm + q/k/v projections (w8a8 with ``qlayer``)
    + rope. x: [B, S, D]. ``llayer``/``aid``: one layer's adapter-pool
    slice and the rows' pool slots; each row's delta is added before
    rope, exactly as a merged weight would be."""
    dt = cfg.dtype
    h = llama.rms_norm(x, layer["ln1"], cfg.norm_eps)
    q = proj(h, layer, qlayer, "wq", 1, dt)
    k = proj(h, layer, qlayer, "wk", 1, dt)
    v = proj(h, layer, qlayer, "wv", 1, dt)
    if llayer is not None:
        q = q + _lora_in_delta(h, llayer["wq"], aid)
        k = k + _lora_in_delta(h, llayer["wk"], aid)
        v = v + _lora_in_delta(h, llayer["wv"], aid)
    return llama.apply_rope(q, cos, sin), llama.apply_rope(k, cos, sin), v


def _decode_out_ffn(cfg, layer, qlayer, x, o, llayer=None, aid=None):
    """Layer back half: output projection (plus the rows' adapter delta
    with ``llayer``/``aid``) + residual + FFN: the dense SwiGLU (w8a8
    with ``qlayer``), or on an MoE config the expert FFN
    (``moe.moe_ffn``, its aux loss dropped; the reference's ``_ffn``).
    x: [B, S, D]; o: the attention output, B * S rows of every head.

    The expert FFN's capacity is per batch row and a function of S, so
    the grouping is the reference's in every program: a wave's rows at
    the padded bucket length, a chunk as one row of its C tokens, a
    burst or verify step as one row of S = 1 per slot (top-k distinct
    experts always fit there). Padding rows sit after a row's real
    tokens, and capacity goes in position order, so they never take a
    real token's slot."""
    dt = cfg.dtype
    o = o.reshape(*x.shape[:2], cfg.n_heads, cfg.head_dim).to(dt)
    y = proj(o, layer, qlayer, "wo", 2, dt)
    if llayer is not None:
        y = y + _lora_out_delta(o, llayer["wo"], aid)
    x = x + y
    h = llama.rms_norm(x, layer["ln2"], cfg.norm_eps)
    if hasattr(cfg, "n_experts"):
        return x + moe.moe_ffn(cfg, h, layer)[0]
    g = proj(h, layer, qlayer, "w_gate", 1, dt)
    u = proj(h, layer, qlayer, "w_up", 1, dt)
    return x + proj(F.silu(g) * u, layer, qlayer, "w_down", 1, dt)


def _decode_head(cfg, params, qweights, x):
    """Final norm + LM head: x [B, 1, D] -> logits [B, vocab] float32."""
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(cfg, params, qweights, x[:, 0])


def _staged_attn_layer(cfg, cache, table, layer, qlayer, x, cos, sin, i,
                       s, stage, stage_valid, span, pos0, plain=False,
                       llayer=None, aid=None):
    """One decoder layer of a staged-burst step: the step's K/V rows land
    in the staging buffers ``stage = (sk, sv, sks, svs)`` ([L, B, k, G,
    hd], and on an int8 cache int8 with bfloat16 scales [L, B, k, G]; in
    place), attention runs as the big-cache stats of the paged kernel
    (rows below the burst-start lengths ``pos0``, ``span``-bounded)
    merged with the staged-columns dot (columns masked by
    ``stage_valid``), and the big cache stays untouched. On an int8
    cache the staged columns are quantized too: their K scales multiply
    the staged scores before the mask, their V scales the staged weights
    after the merge. The one body the burst and the verify round run
    (:func:`decode_burst_staged`, :func:`verify_draft_staged`), as
    ``kvcache.py:1307-1331`` of the JAX package asks of its burst and
    verify programs, so an accepted verify position sees the inputs a
    plain decode step would. ``llayer``/``aid``: the layer's adapter
    pool slice and each slot's pool slot. Returns x'."""
    B = x.shape[0]
    G, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // G
    scale = hd ** -0.5
    sk, sv, sks, svs = stage
    q, kk, v = _decode_qkv(cfg, layer, qlayer, x, cos, sin, llayer, aid)
    kq, vq, ksc, vsc = _stored_rows(cache, kk[:, 0], v[:, 0])
    sk[i, :, s] = kq
    sv[i, :, s] = vq
    if sks is not None:
        sks[i, :, s] = ksc
        svs[i, :, s] = vsc
    lk, lv = sk[i], sv[i]                              # [B, k, G, hd]
    qh = q[:, 0].reshape(B, G, rep, hd).to(torch.bfloat16).contiguous()
    ss = _bf16_dot("bgrk,bjgk->bgrj", qh, lk) * scale
    if sks is not None:
        ss = ss * sks[i].transpose(1, 2)[:, :, None, :].float()
    ss = ss.masked_fill(~stage_valid[:, None, None, :], NEG_INF)
    acc, m, l = _paged_attn_stats(cache, i, table, qh, pos0, span, plain)
    alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, ss)
    if svs is not None:
        w_s = w_s * svs[i].transpose(1, 2)[:, :, None, :].float()
    o = acc * alpha[..., None] + _bf16_dot("bgrj,bjgk->bgrk", w_s, lv)
    o = o / l_tot[..., None]
    return _decode_out_ffn(cfg, layer, qlayer, x, o, llayer, aid)


def _staging(cache: Cache, B: int, W: int):
    """Zeroed staging buffers for ``W`` rows of ``B`` slots in every
    layer, in the cache's storage: (k, v, k_scale, v_scale), the scales
    None on a float cache."""
    L, _, _, G, hd = cache["k"].shape
    dev = cache["k"].device
    sk = torch.zeros((L, B, W, G, hd), dtype=cache["k"].dtype, device=dev)
    if "k_scale" not in cache:
        return sk, torch.zeros_like(sk), None, None
    sks = torch.zeros((L, B, W, G), dtype=cache["k_scale"].dtype,
                      device=dev)
    return sk, torch.zeros_like(sk), sks, torch.zeros_like(sks)


def _flush_staged_rows(cache: Cache, table: torch.Tensor,
                       pos0: torch.Tensor, stage: Rows) -> None:
    """One scatter per cache array: every staged row (and scale) lands at
    logical [b, pos0[b] + j] through the block table (rows of dead slots
    or past an allocation land in the trash block). The caller updates
    length/last_token."""
    B, W = stage[0].shape[1], stage[0].shape[2]
    dev = pos0.device
    idx = pos0.long()[:, None] + torch.arange(W, device=dev)[None, :]
    blk, off = _phys(cache, table,
                     torch.arange(B, device=dev)[:, None], idx)
    _write_rows(cache, blk, off, stage)


def _staged_step(cfg, params, qweights, layers, qlayers, cache, table, tok,
                 pos0, s, stage, stage_valid, span, plain, llayers=None,
                 aid=None):
    """Step ``s`` of a staged burst or verify round: ``tok`` [B] enters at
    row ``pos0 + s`` of every slot through every layer
    (:func:`_staged_attn_layer`, ``layers``/``qlayers``/``llayers`` the
    per-layer slices; ``llayers`` None without adapters). Returns the
    logits [B, vocab] float32."""
    x = params["embed"][tok].to(cfg.dtype)[:, None]
    cos, sin = llama.rope_frequencies(cfg, (pos0 + s)[:, None])
    for i in range(cfg.n_layers):
        x = _staged_attn_layer(cfg, cache, table, layers[i], qlayers[i], x,
                               cos, sin, i, s, stage, stage_valid, span,
                               pos0, plain,
                               llayers[i] if llayers else None, aid)
    return _decode_head(cfg, params, qweights, x)


def _lora_layers(cfg, lora):
    """Per-layer adapter pool slices, or None without a pool."""
    if lora is None:
        return None
    return [adapters_lib.lora_layer(lora, i) for i in range(cfg.n_layers)]


@torch.no_grad()
def step_logits(params: llama.Params, cache: Cache, cfg: llama.LlamaConfig,
                table: torch.Tensor, span: Optional[int] = None,
                plain_attention: bool = False,
                qweights: Optional[QWeights] = None,
                lora: Optional[Dict] = None,
                aid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logits [slots, vocab] of the next decode step of every slot
    (its ``last_token`` at row ``length``), as a staged burst computes
    them, without writing the cache: the logits the engine's next token
    is read from. ``lora``/``aid``: the adapter pool and each slot's
    pool slot."""
    B = cache["length"].shape[0]
    pos0 = cache["length"].clone()
    valid = torch.ones((1, 1), dtype=torch.bool, device=pos0.device)
    layers = range(cfg.n_layers)
    return _staged_step(
        cfg, params, qweights, [llama.layer_slice(params, i) for i in layers],
        [qlayer_slice(qweights, i) for i in layers], cache, table,
        cache["last_token"], pos0, 0, _staging(cache, B, 1), valid, span,
        plain_attention, _lora_layers(cfg, lora), aid)


@torch.no_grad()
def decode_burst_staged(params: llama.Params, cache: Cache,
                        active: torch.Tensor, k: int,
                        cfg: llama.LlamaConfig,
                        sp: sampling_mod.SamplingParams,
                        table: torch.Tensor, span: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        plain_attention: bool = False,
                        qweights: Optional[QWeights] = None,
                        lora: Optional[Dict] = None,
                        aid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """k decode steps with one cache flush per burst. Returns the
    sampled tokens [k, slots]; the cache is updated in place (rows,
    ``length += k`` on active slots, ``last_token``).

    Within the burst each step's K/V rows land in a small staging
    buffer [L, slots, k, G, hd] (int8 with scales on an int8 cache) and
    attention runs as big-cache stats (rows below the burst-start
    lengths, a constant mask) merged with the staged columns (cols <=
    step), so the big cache is read-only until the flush. Inactive
    slots compute rows that are never committed. ``span``: the big-cache
    read covers the first ``span`` logical rows — valid whenever every
    active slot's burst-start length is at most ``span``. ``qweights``:
    w8a8 products and head. ``lora``/``aid``: the adapter pool and each
    slot's pool slot."""
    B = cache["length"].shape[0]
    L = cfg.n_layers
    dev = cache["k"].device
    pos0 = cache["length"].clone()                     # burst-start rows
    stage = _staging(cache, B, k)
    last = cache["last_token"].clone()
    layers = [llama.layer_slice(params, i) for i in range(L)]
    qlayers = [qlayer_slice(qweights, i) for i in range(L)]
    llayers = _lora_layers(cfg, lora)
    toks = []
    for s in range(k):
        stage_valid = (torch.arange(k, device=dev) <= s)[None, :]
        logits = _staged_step(cfg, params, qweights, layers, qlayers, cache,
                              table, last, pos0, s, stage, stage_valid,
                              span, plain_attention, llayers, aid)
        tok = sampling_mod.sample(logits, sp, generator)
        last = torch.where(active, tok, last)
        toks.append(tok)
    _flush_staged_rows(cache, table, pos0, stage)
    cache["length"] += k * active.to(torch.int32)
    cache["last_token"].copy_(last)
    return torch.stack(toks)


@torch.no_grad()
def verify_draft_staged(params: llama.Params, cache: Cache,
                        draft: torch.Tensor, n_draft: torch.Tensor,
                        active: torch.Tensor, k: int,
                        cfg: llama.LlamaConfig, table: torch.Tensor,
                        span: Optional[int] = None,
                        plain_attention: bool = False,
                        qweights: Optional[QWeights] = None,
                        lora: Optional[Dict] = None,
                        aid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify: score ``k`` drafted tokens per slot plus the
    correction position in one call; the cache is updated in place.

    draft: [B, k] proposed tokens; n_draft: [B] real draft tokens per
    slot (the rest pad and never match). The window is ``k + 1``
    positions: position 0 consumes the slot's pending ``last_token``,
    positions 1..k the draft. The K+1 positions scan one after another
    through :func:`_staged_attn_layer`, as a plain burst's steps do
    (big-cache stats below the round-start lengths, merged with the
    staged columns), with the window's tokens in place of sampled
    feedback and greedy argmax outputs. ``lora``/``aid``: the adapter
    pool and each slot's pool slot.

    Acceptance: out[s] is the argmax after consuming window position
    s; the matched run is the longest prefix over which out[s] ==
    draft[s] at real draft positions, and ``n_commit = n_match + 1`` on
    active slots (the matched draft tokens plus the correction or bonus
    token), 0 on the rest. All K+1 window rows flush at rows
    length..length+k, but ``length`` advances by ``n_commit`` only:
    rejected rows sit past the committed length, unread, until the next
    round overwrites them. ``last_token`` becomes out[n_match].

    Returns (toks [B, k+1], the window's argmax outputs, whose first
    ``n_commit[b]`` of row b are committed; n_commit [B] int32)."""
    B = cache["length"].shape[0]
    W = k + 1
    L = cfg.n_layers
    dev = cache["k"].device
    pos0 = cache["length"].clone()                     # round-start rows
    window = torch.cat([cache["last_token"][:, None], draft.long()], dim=1)
    stage = _staging(cache, B, W)
    layers = [llama.layer_slice(params, i) for i in range(L)]
    qlayers = [qlayer_slice(qweights, i) for i in range(L)]
    llayers = _lora_layers(cfg, lora)
    toks = []
    for s in range(W):
        stage_valid = (torch.arange(W, device=dev) <= s)[None, :]
        toks.append(sampling_mod.argmax_tokens(_staged_step(
            cfg, params, qweights, layers, qlayers, cache, table,
            window[:, s], pos0, s, stage, stage_valid, span,
            plain_attention, llayers, aid)))
    toks = torch.stack(toks, dim=1)                    # [B, W]
    # Padding positions (>= n_draft) never match: a pad that equals the
    # argmax must not commit a token computed from a garbage input.
    match = ((toks[:, :k] == draft.long())
             & (torch.arange(k, device=dev)[None, :]
                < n_draft.long()[:, None]))
    n_match = match.int().cumprod(dim=1).sum(dim=1)
    n_commit = torch.where(active, n_match + 1,
                           torch.zeros_like(n_match)).int()
    _flush_staged_rows(cache, table, pos0, stage)
    cache["length"] += n_commit
    last = toks[torch.arange(B, device=dev), n_match.long()]
    cache["last_token"].copy_(torch.where(active, last,
                                          cache["last_token"]))
    return toks, n_commit
