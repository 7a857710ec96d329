"""KV cache programs: wave prefill, insert, chunked prefill, the
single-step decode and the staged decode burst, over two storage
layouts.

Counterpart of ``skypilot_tpu/infer/kvcache.py``. Two layouts share
every program, as in the reference; each program takes a ``table``:

* **Paged** (a block table): the block pool ``[L, n_blocks, block_len,
  G, hd]`` and a per-slot table mapping logical block j to a physical
  block id (:func:`init_paged_cache`). The chunk's, the burst's, the
  verify round's and the single step's big-cache attention goes through
  the paged-attention kernel (K1) and merges with the columns they hold
  outside the cache (the chunk's own rows, the staged rows, the pending
  row).
* **Contiguous** (``table=None``): one ``max_len`` row per slot,
  ``[L, slots + 1, max_len, G, hd]`` (:func:`init_cache`). Big-cache
  reads are the reference's gather: the slot-major rows sliced to the
  span, a bf16 einsum, one softmax over [cache | own columns]. The
  reference runs that read as plain XLA, not a Pallas kernel, so plain
  torch is its port. A contiguous prefix cache is a separate pool of
  rows copied whole (:func:`init_prefix_pool`, :func:`pool_store`,
  :func:`pool_load`).

The programs: wave prefill (:func:`prefill_batch` + :func:`insert`),
chunked prefill (:func:`claim_slot` + :func:`prefill_chunk`), the
single decode step (:func:`decode_step` + :func:`commit_tokens`), the
prefix cache's copy-on-write (:func:`copy_block`, paged), the draft
engine's lockstep write (:func:`sync_slots`), the staged decode burst
(:func:`decode_burst_staged`) and the speculative verify round
(:func:`verify_draft_staged`).

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
  The contiguous layout relies on the same drop at row ``max_len``: a
  slot claimed for a chunked prefill has its length stamped to
  ``max_len``, so the interleaved bursts' writes for it fall there, and
  verify windows and final chunks run past ``max_len``. Its cache holds
  one **trash slot** past the ``slots`` the engine serves (index
  ``slots``, the reference's spare slot, so the bytes are the
  reference's): :func:`_phys` sends every row at or past ``max_len`` to
  it, and no read admits it.

Tensor-parallel serving (``InferenceEngine(mesh=...)``): every program
and cache op also takes ``params``, ``qweights``, ``cache`` and ``pool``
as :class:`parallel.sharding.Shards`, one tree per shard of a tp group,
split by :func:`qweight_logical_axes`, :func:`cache_logical_axes`,
:func:`pool_logical_axes` and ``llama.param_logical_axes`` under
``sharding.INFER_TP_RULES``. Where the reference lets XLA partition
the unchanged programs, the port runs each layer shard by shard and
joins the shards at the Megatron points on the first shard's device
(:class:`_Group`): rope and attention (K1, K2) run over each shard's
own heads and cache slice; the wo and w_down partial products are summed
in float32 in rank order and cast once (w8a8: one activation scale over
every shard's slice, and the int32 partials summed before the one
rescale, exact under any split); the vocab-split embedding's per-shard
lookups (zeros outside a shard's rows) are summed, and the head's
float32 logit columns concatenated in vocab order. The residual, the
norms and sampling run once, on the joined hidden state. With one shard
every join is the identity, so a whole tree runs as before.

Layer loops are Python loops over the stacked ``[L, ...]`` weights where
JAX used ``lax.scan``. Attention runs the CUDA kernels on CUDA tensors
(their plain versions on CPU tensors); ``plain_attention=True`` runs the
plain versions on any device, as the reference the kernels are held to.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

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
from skypilot_tpu_torch.parallel import sharding

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


def quantize_weight(w: torch.Tensor, contract_ndim: int,
                    absmax: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Per-output-channel absmax int8. ``contract_ndim``: how many
    LEADING dims the consuming product contracts; the rest are output
    channels. ``absmax``: each channel's, where ``w`` is a tp shard's
    slice of a longer contraction (the whole weight's absmax). Returns
    {"w": int8 like ``w`` (stored output-major, :func:`int8_layout`),
    "s": float32 [out...]}."""
    wf = w.float()
    s = _scale(wf.abs().amax(dim=tuple(range(contract_ndim)))
               if absmax is None else absmax)
    return {"w": int8_layout(_to_int8(wf, s), contract_ndim), "s": s}


# How many leading dims (after the layer dim) each block weight
# contracts in its consuming product.
QUANT_CONTRACT = {"wq": 1, "wk": 1, "wv": 1, "wo": 2,
                  "w_gate": 1, "w_up": 1, "w_down": 1}


@torch.no_grad()
def quantize_block_weights(params: llama.Params,
                           absmax: Optional[Dict[str, torch.Tensor]] = None
                           ) -> Dict[str, Dict]:
    """int8 copies of the stacked per-layer matmul weights (the norms and
    the embedding stay float), quantized one layer at a time on the
    weights' device, so the float32 temporaries stay one layer's size.
    ``absmax``: {name: [L, out...]} channel absmaxes to quantize those
    weights by (:func:`quantize_weight`)."""
    blocks = params["blocks"]
    absmax = absmax or {}
    out = {}
    for name, nd in QUANT_CONTRACT.items():
        w = blocks[name]
        L = w.shape[0]
        q = int8_layout(torch.empty(w.shape, dtype=torch.int8,
                                    device=w.device), nd, lead_ndim=1)
        s = torch.empty((L,) + tuple(w.shape[1 + nd:]),
                        dtype=torch.float32, device=w.device)
        am = absmax.get(name)
        for i in range(L):
            one = quantize_weight(w[i], nd, None if am is None
                                  else am[i].to(w.device))
            q[i], s[i] = one["w"], one["s"]
        out[name] = {"w": q, "s": s}
    return out


@torch.no_grad()
def quantize_head(params: llama.Params, cfg: llama.LlamaConfig
                  ) -> Dict[str, torch.Tensor]:
    return quantize_weight(llama.lm_head(params, cfg), 1)


@torch.no_grad()
def quantize_weights(params, cfg: llama.LlamaConfig):
    """The w8a8 tree ``{"blocks": ..., "head": ...}`` of a whole float
    tree (:func:`quantize_block_weights`, :func:`quantize_head`) or of a
    split one, shard by shard. Where the tp group splits a weight's
    contraction (wo over the heads, w_down over mlp), each output
    channel's scale is the absmax over every shard's rows, so each shard
    holds its slice of the whole weight's quantization, as the reference
    quantizes before it shards."""
    shards = sharding.shards_of(params)
    axes = qweight_logical_axes(cfg)["blocks"]
    absmax = {}
    for name, nd in QUANT_CONTRACT.items():
        if len(shards) == 1 or sharding.tp_dim(axes[name]["w"]) not in \
                range(1, 1 + nd):
            continue
        ws = [p["blocks"][name] for p in shards]
        dev = ws[0].device
        absmax[name] = torch.stack([functools.reduce(torch.maximum, [
            w[i].float().abs().amax(dim=tuple(range(nd))).to(dev)
            for w in ws]) for i in range(ws[0].shape[0])])
    return _tree([{"blocks": quantize_block_weights(p, absmax),
                   "head": quantize_head(p, cfg)} for p in shards])


def slim_params(params):
    """Drop the float copies of quantized weights: blocks keep only the
    norms; the head is the quantized one. A split tree slims shard by
    shard."""
    return _tree([{
        "embed": p["embed"],
        "final_norm": p["final_norm"],
        "blocks": {"ln1": p["blocks"]["ln1"], "ln2": p["blocks"]["ln2"]},
    } for p in sharding.shards_of(params)])


def qweight_logical_axes(cfg: llama.LlamaConfig) -> Dict[str, Dict]:
    """Logical axes of the ``{"blocks": ..., "head": ...}`` qweights tree
    (the float tree's names, so one rule set splits both): ``w`` mirrors
    its float tensor; ``s`` keeps ("layer",) and the output axes."""
    full = llama.param_logical_axes(cfg)["blocks"]
    blocks = {name: {"w": full[name], "s": ("layer",) + full[name][1 + nd:]}
              for name, nd in QUANT_CONTRACT.items()}
    return {"blocks": blocks,
            "head": {"w": ("embed", "vocab"), "s": ("vocab",)}}


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


def _act_quant(x: torch.Tensor, n_contract: int,
               absmax: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8: absmax over the TRAILING ``n_contract`` dims (or
    the given ``absmax``, a tp group's over every shard's slice).
    Returns (int8 like ``x``, float32 scales ``x.shape[:-n_contract]``)."""
    xf = x.float()
    dims = tuple(range(x.dim() - n_contract, x.dim()))
    s = _scale(xf.abs().amax(dim=dims) if absmax is None else absmax)
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
    return _qeinsum_parts([x], [qw], n_contract, out_dtype)


def _qeinsum_parts(xs: List[torch.Tensor], qws: List[Dict], n_contract: int,
                   out_dtype) -> torch.Tensor:
    """:func:`qeinsum` over a contraction the tp group splits: shard r's
    slice ``xs[r]`` against its rows ``qws[r]``. One activation scale
    from the absmax over every slice, the shards' int32 accumulators
    summed on the first shard's device in rank order, then the one
    rescale (the weight scales are whole on every shard): the same bits
    as the unsplit product."""
    dev = xs[0].device
    absmax = None
    if len(xs) > 1:
        dims = tuple(range(xs[0].dim() - n_contract, xs[0].dim()))
        absmax = functools.reduce(torch.maximum, [
            x.float().abs().amax(dim=dims).to(dev) for x in xs])
    acc = sx = None
    for x, qw in zip(xs, qws):
        xq, sxr = _act_quant(x, n_contract, None if absmax is None
                             else absmax.to(x.device))
        w = qw["w"]
        k = math.prod(w.shape[:n_contract])
        part = int8_matmul(xq.reshape(-1, k), w.reshape(k, -1))
        acc, sx = (part, sxr) if acc is None else (acc + part.to(dev), sx)
    s = qws[0]["s"]
    x = xs[0]
    acc = acc.reshape(*x.shape[:x.dim() - n_contract],
                      *qws[0]["w"].shape[n_contract:]).float()
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


def _proj_join(xs: List[torch.Tensor], layers: List[Dict],
               qlayers: List[Optional[Dict]], name: str, n_contract: int,
               dtype) -> torch.Tensor:
    """:func:`proj` of a weight whose contraction the tp group splits (wo,
    w_down): shard r's slice ``xs[r]`` against its rows, the partial
    products summed in float32 in rank order on the first shard's device
    and cast once (w8a8: :func:`_qeinsum_parts`). One shard: :func:`proj`
    itself."""
    if qlayers[0] is not None:
        return _qeinsum_parts(xs, [q[name] for q in qlayers], n_contract,
                              dtype)
    return _join_sum([proj(x, layer, None, name, n_contract, dtype)
                      for x, layer in zip(xs, layers)], dtype)


def _head(cfg: llama.LlamaConfig, params: List[llama.Params],
          qweights: List[Optional[QWeights]], x: torch.Tensor
          ) -> torch.Tensor:
    """LM head on final-norm hidden states [..., D] -> float32 logits:
    w8a8 with ``qweights``, else :func:`llama.logits`; over a tp group
    (``params`` and ``qweights`` one per shard) each shard's vocab
    columns, concatenated in vocab order on ``x``'s device."""
    parts = []
    for p, q in zip(params, qweights):
        xr = x.to(p["final_norm"].device)
        part = (qeinsum(xr, q["head"], 1, torch.float32) if q is not None
                else llama.logits(xr, p, cfg))
        parts.append(part.to(x.device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., G, hd] -> (int8 values, float32 [..., G] absmax scales)."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=-1))
    return _to_int8(xf, s[..., None]), s


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Tensor parallelism: a program's shards and their joins
# ---------------------------------------------------------------------------

def _tree(parts: list):
    """One shard's tree as itself, several as :class:`sharding.Shards`."""
    return parts[0] if len(parts) == 1 else sharding.Shards(parts)


def _to(v, device: torch.device):
    """A tensor argument on ``device``; a Python number as it is."""
    return v.to(device) if isinstance(v, torch.Tensor) else v


def _join_sum(parts: List[torch.Tensor], dtype) -> torch.Tensor:
    """The shards' partial sums added in float32 in rank order on the
    first shard's device and cast once to ``dtype``; one part as it is."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(dev).float()
    return acc.to(dtype)


class _Group:
    """A program's tp group: the shards' params, qweights and caches in
    rank order (one each for a whole tree) and the shards' devices.
    Tensors the program makes on the first shard's device reach each
    shard through :meth:`rep`."""

    def __init__(self, params, qweights=None, cache=None):
        self.params = sharding.shards_of(params)
        n = len(self.params)
        self.qweights = ([None] * n if qweights is None
                         else sharding.shards_of(qweights))
        self.caches = ([None] * n if cache is None
                       else sharding.shards_of(cache))
        self.devs = [p["final_norm"].device for p in self.params]

    def rep(self, t: Optional[torch.Tensor]) -> list:
        """``t`` on every shard's device (the same tensor where a device
        is ``t``'s own)."""
        return [None if t is None else t.to(d) for d in self.devs]

    def layer(self, i: int) -> Tuple[List[Dict], List[Optional[Dict]]]:
        """Layer ``i``'s float and int8 slices, one per shard."""
        return ([llama.layer_slice(p, i) for p in self.params],
                [qlayer_slice(q, i) for q in self.qweights])

    def lora(self, llayer: Optional[Dict]) -> list:
        """One layer of the adapter pool (``adapters.lora_layer``, whole
        on the first device) as each shard reads it: B of the wq, wk and
        wv deltas cut to the shard's heads and kv heads, A of the wo
        delta to its heads, on the shard's device."""
        n = len(self.params)
        if llayer is None or n == 1:
            return [llayer] * n
        return [{t: {"a": (ab["a"].chunk(n, dim=1)[r] if t == "wo"
                           else ab["a"]).to(dev),
                     "b": (ab["b"] if t == "wo"
                           else ab["b"].chunk(n, dim=2)[r]).to(dev)}
                 for t, ab in llayer.items()}
                for r, dev in enumerate(self.devs)]

    def layer_step(self, cfg, i: int, x: torch.Tensor, cos: list,
                   sin: list, attend: Callable, llayer: Optional[Dict] = None,
                   aid: Optional[list] = None, layers=None) -> torch.Tensor:
        """Decoder layer ``i`` over the group on x [B, S, D] (on the first
        shard's device): each shard's q, k and v on its own columns
        (:func:`_decode_qkv`), ``attend(r, i, q, k, v)`` its attention
        output, and the join at wo and w_down (:func:`_decode_out_ffn`).
        ``cos``, ``sin`` and ``aid`` are per shard (:meth:`rep`),
        ``llayer`` the adapter pool's layer ``i`` (whole), ``layers``
        the layer's slices where the caller holds them. Returns x after
        the layer."""
        layers, qlayers = self.layer(i) if layers is None else layers
        lls = self.lora(llayer)
        aid = aid or [None] * len(self.devs)
        os = [attend(r, i, *_decode_qkv(cfg, layers[r], qlayers[r], xr,
                                        cos[r], sin[r], lls[r], aid[r]))
              for r, xr in enumerate(self.rep(x))]
        return _decode_out_ffn(cfg, layers, qlayers, x, os, lls, aid)


def _embed(params: List[llama.Params], tokens: torch.Tensor,
           dtype) -> torch.Tensor:
    """Token ids -> ``dtype`` hidden states on the first shard's device.
    Over a vocab-split embedding each shard looks the ids up in its own
    rows and writes zeros for the rest, and the shards' lookups are
    summed: exactly one is not zero."""
    if len(params) == 1:
        return params[0]["embed"][tokens].to(dtype)
    parts, first = [], 0
    for p in params:
        e = p["embed"]
        ids = tokens.to(e.device) - first
        inside = (ids >= 0) & (ids < e.shape[0])
        rows = e[ids.clamp(0, e.shape[0] - 1)].to(dtype)
        parts.append(torch.where(inside[..., None], rows,
                                 torch.zeros((), dtype=dtype,
                                             device=e.device)))
        first += e.shape[0]
    return _join_sum(parts, dtype)


# ---------------------------------------------------------------------------
# Contiguous layout
# ---------------------------------------------------------------------------

def init_cache(cfg: llama.LlamaConfig, n_slots: int, max_len: int,
               kv_int8: bool = False, device: DeviceLike = None,
               kv_heads: Optional[int] = None) -> Cache:
    """Contiguous decode state: one ``max_len`` row of K/V per slot,
    ``[L, n_slots + 1, max_len, G, hd]``, the last slot (index
    ``n_slots``) the trash slot that rows at or past ``max_len`` land
    in (:func:`_phys`). ``kv_int8``: int8 rows with bfloat16 scales
    ``[L, n_slots + 1, G, max_len]`` (the paged scale layout with one
    block of ``max_len`` rows a slot), whatever ``cfg.dtype`` is.
    ``length`` and ``last_token`` cover the ``n_slots`` served slots.
    ``kv_heads``: a tp shard's kv heads (default all of them)."""
    device = resolve_device(device)
    L, G, hd = cfg.n_layers, kv_heads or cfg.n_kv_heads, cfg.head_dim
    shape = (L, n_slots + 1, max_len, G, hd)
    kdt = torch.int8 if kv_int8 else cfg.dtype
    cache = {
        "length": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "last_token": torch.zeros((n_slots,), dtype=torch.long,
                                  device=device),
        "k": torch.zeros(shape, dtype=kdt, device=device),
        "v": torch.zeros(shape, dtype=kdt, device=device),
    }
    if kv_int8:
        sshape = (L, n_slots + 1, G, max_len)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)
    return cache


def init_prefix_pool(cfg: llama.LlamaConfig, rows: int, max_len: int,
                     kv_int8: bool = False, device: DeviceLike = None,
                     kv_heads: Optional[int] = None) -> Cache:
    """K/V rows reserved for a contiguous engine's prefix cache
    (``rows`` resident prefixes, one ``max_len`` row each): the decode
    cache's per-row layout and scales, so a row copy is a plain copy
    with no requantization and cached generation stays bit-identical to
    cold. ``kv_heads``: a tp shard's kv heads (default all of them)."""
    device = resolve_device(device)
    L, G, hd = cfg.n_layers, kv_heads or cfg.n_kv_heads, cfg.head_dim
    kdt = torch.int8 if kv_int8 else cfg.dtype
    pool = {"k": torch.zeros((L, rows, max_len, G, hd), dtype=kdt,
                             device=device)}
    pool["v"] = torch.zeros_like(pool["k"])
    if kv_int8:
        pool["k_scale"] = torch.zeros((L, rows, G, max_len),
                                      dtype=torch.bfloat16, device=device)
        pool["v_scale"] = torch.zeros_like(pool["k_scale"])
    return pool


@torch.no_grad()
def pool_store(pool: Cache, cache: Cache, slot: int, row: int) -> None:
    """Copy a slot's K/V rows (all ``max_len`` of them, with the scales)
    into pool row ``row``, in place. Rows past the prompt are garbage
    but harmless: the host index records the cached prefix length, and
    a load's suffix prefill overwrites everything past it before decode
    reads it. Split trees copy shard by shard."""
    for p, c in zip(sharding.shards_of(pool), sharding.shards_of(cache)):
        for name in p:
            p[name][:, row] = c[name][:, slot]


@torch.no_grad()
def pool_load(cache: Cache, pool: Cache, row: int, slot: int,
              claim_len: int) -> None:
    """Copy pool row ``row`` into decode slot ``slot`` and claim the slot
    for a chunked prefill, in place: the length is stamped to
    ``claim_len`` (``max_len``), so the rows interleaved bursts write for
    every slot at ``length`` land in the trash slot instead of over rows
    a finished chunk already wrote (:func:`claim_slot`)."""
    for c, p in zip(sharding.shards_of(cache), sharding.shards_of(pool)):
        for name in p:
            c[name][:, slot] = p[name][:, row]
        c["length"][slot] = claim_len


def cache_logical_axes(cache: Optional[Cache] = None) -> Dict[str, Tuple]:
    """Logical axes of a cache's arrays (the reference's names; an int8
    cache adds its scales, None is the float layout). Both layouts use
    the same names: the paged block dim takes "batch" and its rows
    "seq_cache", so ``kv_heads`` is dim 3 of k/v either way and dim 2 of
    the scales; ``length`` and ``last_token`` replicate."""
    axes = {
        "k": ("layer", "batch", "seq_cache", "kv_heads", "head_dim"),
        "v": ("layer", "batch", "seq_cache", "kv_heads", "head_dim"),
        "length": ("batch",),
        "last_token": ("batch",),
    }
    if cache is not None and "k_scale" in cache:
        axes["k_scale"] = ("layer", "batch", "kv_heads", "seq_cache")
        axes["v_scale"] = ("layer", "batch", "kv_heads", "seq_cache")
    return axes


def pool_logical_axes(pool: Cache) -> Dict[str, Tuple]:
    """Logical axes of a contiguous prefix pool: the cache's names (the
    row dim takes "batch"), so one rule set splits both."""
    axes = cache_logical_axes(pool)
    return {name: axes[name] for name in pool}


# ---------------------------------------------------------------------------
# Paged block-pool layout
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: llama.LlamaConfig, n_slots: int, n_blocks: int,
                     block_len: int, device: torch.device,
                     kv_int8: bool = False,
                     kv_heads: Optional[int] = None) -> Cache:
    """Block-pool decode state: ``n_blocks`` physical blocks of
    ``block_len`` rows shared by ``n_slots`` slots, plus the trash
    block (id ``n_blocks``) that sentinel writes land in. ``kv_int8``:
    int8 pools with bfloat16 scales ``[L, n_blocks + 1, G, block_len]``
    (the row dim last, as the reference lays them out and the kernel
    reads them), whatever ``cfg.dtype`` is. ``kv_heads``: a tp shard's
    kv heads (default all of them)."""
    L, G, hd = cfg.n_layers, kv_heads or cfg.n_kv_heads, cfg.head_dim
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
    for c in sharding.shards_of(cache):
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in c:
                c[name][:, dst] = c[name][:, src]


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
    the same. A split cache exports every kv head, the shards' slices
    joined in rank order on ``ids``' device: the reference's full-head
    wire, whatever the tp degree of either side."""
    caches = sharding.shards_of(cache)
    parts = [{name: c[name][:, ids.to(c["k"].device)]
              for name in ("k", "v", "k_scale", "v_scale") if name in c}
             for c in caches]
    if len(parts) == 1:
        return parts[0]
    return sharding.gather_tree(sharding.Shards(parts),
                                cache_logical_axes(caches[0]),
                                ids.device)


def import_blocks(cache: Cache, ids: torch.Tensor,
                  vals: Dict[str, torch.Tensor]) -> None:
    """Scatter exported block rows into the freshly allocated physical
    blocks ``ids`` ([nb] int), in place, cast to each pool's dtype — the
    receive half of a cross-replica KV handoff. As in
    :func:`export_blocks`, only the ``nb`` real ids are written (the
    reference pads with the sentinel and drops those writes). A split
    cache takes the full-head wire and writes each shard its kv heads."""
    caches = sharding.shards_of(cache)
    if len(caches) > 1:
        vals = sharding.split_tree(vals, cache_logical_axes(caches[0]),
                                   [c["k"].device for c in caches])
    for c, part in zip(caches, sharding.shards_of(vals)):
        dev_ids = ids.to(c["k"].device)
        for name, v in part.items():
            c[name][:, dev_ids] = v.to(c[name].dtype)


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
    for c in sharding.shards_of(cache):
        dev = c["length"].device
        act = active.to(dev)
        c["length"].copy_(torch.where(act, lengths.to(dev, torch.int32),
                                      c["length"]))
        c["last_token"].copy_(torch.where(
            act, tokens.to(dev, c["last_token"].dtype), c["last_token"]))


def _logical_rows(cache: Cache, table: Optional[torch.Tensor]) -> int:
    """Rows a slot's attention spans: ``max_len`` (contiguous) or
    blocks_per_slot * block_len (paged; the table's last column is the
    sentinel and holds no rows)."""
    if table is None:
        return cache["k"].shape[2]
    return (table.shape[1] - 1) * cache["k"].shape[2]


def _phys(cache: Cache, table: Optional[torch.Tensor], slots,
          idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, logical row) -> the cache's two row-addressing indices.
    Paged: (physical block, row in block) through the block table;
    logical rows past the table clamp to its sentinel column, whose id
    addresses the trash block. Contiguous (``table`` None): the identity
    below ``max_len``; a row at or past it goes to the trash slot (the
    explicit form of the reference's dropped out-of-bounds scatter)."""
    bl = cache["k"].shape[2]
    if table is None:
        slots = torch.as_tensor(slots, device=idx.device)
        trash = cache["k"].shape[1] - 1
        return torch.where(idx < bl, slots, trash), idx % bl
    col = (idx // bl).clamp(max=table.shape[1] - 1)
    return table[slots, col].long(), idx % bl


def _gather_kv_layer(cache: Cache, i: int, span: Optional[int]):
    """Layer ``i``'s contiguous rows of the served slots: k/v [B, M, G,
    hd], scales [B, G, M] (None on a float cache), ``M = span`` or
    ``max_len``: the slot-major rows read directly, a prefix of the full
    view in the same order (the reference's ``_gather_kv_layer`` with
    ``table=None``)."""
    B = cache["length"].shape[0]
    M = span if span is not None else cache["k"].shape[2]
    ks = cache.get("k_scale")
    vs = cache.get("v_scale")
    return (cache["k"][i, :B, :M], cache["v"][i, :B, :M],
            None if ks is None else ks[i, :B, :, :M],
            None if vs is None else vs[i, :B, :, :M])


def _gather_slot_kv_layer(cache: Cache, i: int, slot: int,
                          span: Optional[int]):
    """One contiguous slot's rows of layer ``i``: k/v [M, G, hd], scales
    [G, M] (the chunk's read)."""
    M = span if span is not None else cache["k"].shape[2]
    ks = cache.get("k_scale")
    vs = cache.get("v_scale")
    return (cache["k"][i, slot, :M], cache["v"][i, slot, :M],
            None if ks is None else ks[i, slot, :, :M],
            None if vs is None else vs[i, slot, :, :M])


def _gather_attn(eqs: Tuple[str, str, str], qh: torch.Tensor, ck, cv,
                 cks, cvs, valid: torch.Tensor, ss: torch.Tensor,
                 v_own: torch.Tensor,
                 own_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's gather read (the contiguous layout): cache scores
    ``q . k`` as a bf16 einsum with float32 accumulation (K's scales
    multiply the scores), masked by ``valid``, one softmax over [cache
    columns | the program's own columns ``ss``], then the weights (V's
    scales folded in) against the cache rows and the own rows ``v_own``,
    each a bf16 einsum. ``eqs``: the score, cache-value and own-value
    einsums; scales are [..., G, M] and multiply over the query-row
    axis; ``own_scale``: the own columns' V scales (staged int8 rows),
    else None. Returns the normalized output."""
    eq_s, eq_v, eq_own = eqs
    sm = _bf16_dot(eq_s, qh, ck) * qh.shape[-1] ** -0.5
    if cks is not None:
        sm = sm * cks.float().unsqueeze(-2)
    sm = sm.masked_fill(~valid, NEG_INF)
    M = sm.shape[-1]
    w = torch.softmax(torch.cat([sm, ss], dim=-1), dim=-1)
    wm, ws = w[..., :M], w[..., M:]
    if cvs is not None:
        wm = wm * cvs.float().unsqueeze(-2)
    if own_scale is not None:
        ws = ws * own_scale
    return _bf16_dot(eq_v, wm, cv) + _bf16_dot(eq_own, ws, v_own)


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
    slot. Over a tp group the rows come back per shard, each shard's kv
    heads (:func:`wave_row` picks one prompt's)."""
    attention = attn_ops.gqa_attention
    if plain_attention:
        def attention(q, k, v):
            return flash_ops.flash_attention_fwd_ref(q, k, v)[0]
    g = _Group(params, qweights)
    W, S = tokens.shape
    x = _embed(g.params, tokens, cfg.dtype)
    cos, sin = llama.rope_frequencies(
        cfg, torch.arange(S, device=tokens.device))
    coss, sins, aids = g.rep(cos), g.rep(sin), g.rep(aid)
    ks = [[] for _ in g.params]
    vs = [[] for _ in g.params]

    def attend(r, i, q, k, v):
        ks[r].append(k)
        vs[r].append(v)
        return attention(q, k, v)

    for i in range(cfg.n_layers):
        x = g.layer_step(cfg, i, x, coss, sins, attend,
                         adapters_lib.lora_layer(lora, i), aids)
    x = llama.rms_norm(x, g.params[0]["final_norm"], cfg.norm_eps)
    last = x[torch.arange(W, device=x.device), true_lens.long() - 1]
    return (_tree([{"k": torch.stack(k), "v": torch.stack(v)}
                   for k, v in zip(ks, vs)]),
            _head(cfg, g.params, g.qweights, last))


def wave_row(prefix, w: int):
    """Prompt ``w``'s rows of a wave's prefix (:func:`prefill_batch`), in
    the form :func:`insert` takes, shard by shard over a tp group."""
    return _tree([{"k": p["k"][:, w], "v": p["v"][:, w]}
                  for p in sharding.shards_of(prefix)])


@torch.no_grad()
def insert(cache: Cache, prefix: Cache, slot: int, true_len,
           first_token, table: Optional[torch.Tensor] = None) -> None:
    """Install a prefilled prompt into decode slot ``slot`` (in place).

    prefix k/v: [L, S_bucket, G, hd]; the rows scatter through the
    slot's block table (contiguous: into the slot's row), quantized
    first on an int8 cache. Rows >= true_len are padding but harmless —
    decode masks by ``length``; rows past the slot's allocation land in
    the trash block (contiguous: past ``max_len``, the trash slot). A
    split cache takes the prefix's shard of kv heads on each shard."""
    for c, p in zip(sharding.shards_of(cache), sharding.shards_of(prefix)):
        dev = c["k"].device
        blk, off = _phys(c, None if table is None else table.to(dev), slot,
                         torch.arange(p["k"].shape[1], device=dev))
        _write_rows(c, blk, off, _stored_rows(c, p["k"], p["v"]))
        c["length"][slot] = _to(true_len, dev)
        c["last_token"][slot] = _to(first_token, dev)


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def claim_slot(cache: Cache, slot: int, claim_len: int) -> None:
    """Claim a slot for a cold chunked prefill (in place): its length is
    stamped to ``claim_len`` (max_len), so the rows that interleaved
    decode bursts flush for every slot, active or not, at index
    ``length`` fall past the table and land in the trash block (the
    trash slot, contiguous) instead of over rows a finished chunk
    already wrote."""
    for c in sharding.shards_of(cache):
        c["length"][slot] = claim_len


@torch.no_grad()
def prefill_chunk(params: llama.Params, cache: Cache,
                  tokens_c: torch.Tensor, start: int, n_valid: int,
                  slot: int, new_len: int, cfg: llama.LlamaConfig,
                  sp: sampling_mod.SamplingParams,
                  table: Optional[torch.Tensor], *,
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
    the JAX program leaves it to XLA. With ``table`` None (contiguous)
    the big-cache block is the reference's gather over the slot's row
    (:func:`_gather_attn`), one softmax with the intra-chunk columns.
    The chunk's rows then scatter through the table (rows past max_len
    land in the trash block or slot) and ``length`` is stamped, in
    place. On an int8 cache the big-cache read
    folds the stored rows' scales in, the intra-chunk block scores the
    chunk's own unquantized rows (as the reference does), and the rows
    are quantized as they are written. ``qweights``: w8a8 products and
    head. ``lora``/``aid``: the adapter pool and the per-slot pool
    slots, of which the chunk reads ``aid[slot]``. Returns the first
    token sampled at the last valid position on the ``final`` chunk,
    else 0 (device tensors)."""
    g = _Group(params, qweights, cache)
    C = tokens_c.shape[0]
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    scale = hd ** -0.5
    dev = tokens_c.device
    x = _embed(g.params, tokens_c, cfg.dtype)[None]          # [1, C, D]
    cos, sin = llama.rope_frequencies(
        cfg, start + torch.arange(C, device=dev))
    j = torch.arange(C, device=dev)
    # Padding columns (>= n_valid) are masked out of the intra-chunk
    # scores; padding rows compute rows past the prompt's length, which
    # no read admits.
    intra = (j[None, :] <= j[:, None]) & (j[None, :] < n_valid)
    tbl = table[slot:slot + 1] if table is not None else None
    lens = torch.full((1,), start, dtype=torch.int32, device=dev)
    # The chunk runs ONE slot: its adapter id, aligned with x's batch.
    aid_b = aid[slot:slot + 1] if lora is not None else None
    coss, sins, js, intras, tables, tbls, lenss, aids = map(
        g.rep, (cos, sin, j, intra, table, tbl, lens, aid_b))

    ks = [[] for _ in g.params]
    vs = [[] for _ in g.params]

    def attend(r, i, q, k, v):
        """Shard r's attention of layer i: its kv heads' rows."""
        c = g.caches[r]
        kr, vr = k[0], v[0]                                    # [C, G, hd]
        ks[r].append(kr)
        vs[r].append(vr)
        G = kr.shape[1]
        qh = q[0].reshape(C, G, rep, hd).to(torch.bfloat16)
        ss = _bf16_dot("cgrk,jgk->cgrj", qh, kr) * scale
        ss = ss.masked_fill(~intras[r][:, None, None, :], NEG_INF)
        if table is None:
            ck, cv, cks, cvs = _gather_slot_kv_layer(c, i, slot, span)
            valid = torch.arange(ck.shape[0], device=kr.device) < start
            return _gather_attn(("cgrk,mgk->cgrm", "cgrm,mgk->cgrk",
                                 "cgrj,jgk->cgrk"), qh, ck, cv, cks, cvs,
                                valid, ss, vr)
        # The chunk's C * rep rows of each kv-head in one (slot, kv-head)
        # cell of the kernel, masked below ``start``.
        q_k = qh.permute(1, 0, 2, 3).reshape(1, G, C * rep, hd)
        acc, m, l = _paged_attn_stats(c, i, tbls[r], q_k.contiguous(),
                                      lenss[r], span, plain_attention)
        acc = acc.reshape(G, C, rep, hd).permute(1, 0, 2, 3)
        m = m.reshape(G, C, rep).permute(1, 0, 2)
        l = l.reshape(G, C, rep).permute(1, 0, 2)
        alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, ss)
        return (acc * alpha[..., None]
                + _bf16_dot("cgrj,jgk->cgrk", w_s, vr)) / l_tot[..., None]

    for i in range(cfg.n_layers):
        x = g.layer_step(cfg, i, x, coss, sins, attend,
                         adapters_lib.lora_layer(lora, i), aids)
    if final:
        x = llama.rms_norm(x, g.params[0]["final_norm"], cfg.norm_eps)
        logits = _head(cfg, g.params, g.qweights, x[:, n_valid - 1])
        tok = sampling_mod.sample(logits, sp, generator)[0]
    else:
        tok = torch.zeros((), dtype=torch.long, device=dev)
    for r, c in enumerate(g.caches):
        blk, off = _phys(c, tables[r], slot, start + js[r])
        _write_rows(c, blk, off,
                    _stored_rows(c, torch.stack(ks[r]), torch.stack(vs[r])))
        c["length"][slot] = new_len
        if final:
            c["last_token"][slot] = tok.to(g.devs[r])
    return tok


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_qkv(cfg, layer, qlayer, x, cos, sin, llayer=None, aid=None):
    """Layer front half: norm + q/k/v projections (w8a8 with ``qlayer``)
    + rope. x: [B, S, D]. ``llayer``/``aid``: one layer's adapter-pool
    slice and the rows' pool slots; each row's delta is added before
    rope, exactly as a merged weight would be. Over a tp group each
    shard runs it on its own columns: its heads and kv heads."""
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


def _decode_out_ffn(cfg, layers, qlayers, x, os, llayers=None, aids=None):
    """Layer back half: output projection (plus the rows' adapter delta
    with ``llayers``/``aids``) + residual + FFN: the dense SwiGLU (w8a8
    with ``qlayers``), or on an MoE config the expert FFN
    (``moe.moe_ffn``, its aux loss dropped; the reference's ``_ffn``).
    x: [B, S, D] on the first shard's device; ``layers``, ``qlayers``,
    ``os`` (the attention output, B * S rows of a shard's heads),
    ``llayers`` (:meth:`_Group.lora`) and ``aids`` one per shard. The tp
    group joins at wo (the adapter deltas' partials summed alike) and at
    w_down (:func:`_proj_join`); the residual and ln2 run once on the
    joined state, w_gate and w_up on each shard's mlp columns.

    The expert FFN's capacity is per batch row and a function of S, so
    the grouping is the reference's in every program: a wave's rows at
    the padded bucket length, a chunk as one row of its C tokens, a
    burst or verify step as one row of S = 1 per slot (top-k distinct
    experts always fit there). Padding rows sit after a row's real
    tokens, and capacity goes in position order, so they never take a
    real token's slot."""
    dt = cfg.dtype
    os = [o.reshape(*x.shape[:2], -1, cfg.head_dim).to(dt) for o in os]
    y = _proj_join(os, layers, qlayers, "wo", 2, dt)
    if llayers is not None and llayers[0] is not None:
        y = y + _join_sum([_lora_out_delta(o, ll["wo"], a)
                           for o, ll, a in zip(os, llayers, aids)], dt)
    x = x + y
    h = llama.rms_norm(x, layers[0]["ln2"], cfg.norm_eps)
    if hasattr(cfg, "n_experts"):
        return x + moe.moe_ffn(cfg, h, layers[0])[0]
    acts = []
    for layer, qlayer in zip(layers, qlayers):
        hr = h.to(layer["ln2"].device)
        gate = proj(hr, layer, qlayer, "w_gate", 1, dt)
        u = proj(hr, layer, qlayer, "w_up", 1, dt)
        acts.append(F.silu(gate) * u)
    return x + _proj_join(acts, layers, qlayers, "w_down", 1, dt)


def _decode_head(cfg, g: _Group, x):
    """Final norm + LM head: x [B, 1, D] -> logits [B, vocab] float32."""
    x = llama.rms_norm(x, g.params[0]["final_norm"], cfg.norm_eps)
    return _head(cfg, g.params, g.qweights, x[:, 0])


def _staged_attn(cache, table, q, kk, v, i, s, stage, stage_valid, span,
                 pos0, plain=False):
    """One shard's attention in one decoder layer of a staged-burst step
    (q [B, 1, heads, hd], kk and v [B, 1, G, hd] after rope): the step's
    K/V rows land in the staging buffers ``stage = (sk, sv, sks, svs)``
    ([L, B, k, G, hd], and on an int8 cache int8 with bfloat16 scales
    [L, B, k, G]; in place), attention runs as the big-cache stats of
    the paged kernel (rows below the burst-start lengths ``pos0``,
    ``span``-bounded) merged with the staged-columns dot (columns masked
    by ``stage_valid``), and the big cache stays untouched. On an int8
    cache the staged columns are quantized too: their K scales multiply
    the staged scores before the mask, their V scales the staged weights
    after the merge. With ``table`` None (contiguous) the big-cache
    block is the reference's gather instead (:func:`_gather_attn`, rows
    below ``pos0`` of the first ``span`` rows). The one body the burst
    and the verify round run (:func:`decode_burst_staged`,
    :func:`verify_draft_staged`), as ``kvcache.py:1307-1331`` of the JAX
    package asks of its burst and verify programs, so an accepted verify
    position sees the inputs a plain decode step would. Returns the
    normalized output [B, G, rep, hd]."""
    B = q.shape[0]
    G, hd = kk.shape[2], kk.shape[3]
    rep = q.shape[2] // G
    scale = hd ** -0.5
    sk, sv, sks, svs = stage
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
    own_scale = (svs[i].transpose(1, 2)[:, :, None, :].float()
                 if svs is not None else None)
    if table is None:
        ck, cv, cks, cvs = _gather_kv_layer(cache, i, span)
        valid = (torch.arange(ck.shape[1], device=pos0.device)[None, :]
                 < pos0[:, None])
        return _gather_attn(("bgrk,bmgk->bgrm", "bgrm,bmgk->bgrk",
                             "bgrj,bjgk->bgrk"), qh, ck, cv, cks, cvs,
                            valid[:, None, None, :], ss, lv, own_scale)
    acc, m, l = _paged_attn_stats(cache, i, table, qh, pos0, span, plain)
    alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, ss)
    if own_scale is not None:
        w_s = w_s * own_scale
    o = acc * alpha[..., None] + _bf16_dot("bgrj,bjgk->bgrk", w_s, lv)
    return o / l_tot[..., None]


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


class _Staged:
    """The per-shard state of a staged burst or verify round over ``W``
    window rows: the shards' burst-start lengths, staging buffers and
    tables, and every layer's slices."""

    def __init__(self, g: _Group, cfg, table, W: int):
        self.g = g
        self.pos0 = [c["length"].clone() for c in g.caches]
        B = self.pos0[0].shape[0]
        self.stage = [_staging(c, B, W) for c in g.caches]
        self.tables = g.rep(table)
        self.layers = [g.layer(i) for i in range(cfg.n_layers)]

    def flush(self, n_commit: torch.Tensor, last: torch.Tensor) -> None:
        """Every shard's staged rows into its cache, then ``length +=
        n_commit`` and ``last_token = last``."""
        for r, c in enumerate(self.g.caches):
            _flush_staged_rows(c, self.tables[r], self.pos0[r],
                               self.stage[r])
            c["length"] += n_commit.to(c["length"].device, torch.int32)
            c["last_token"].copy_(last)


def _staged_step(cfg, st: _Staged, tok, s, stage_valid, span, plain,
                 llayers=None, aid=None):
    """Step ``s`` of a staged burst or verify round: ``tok`` [B] enters at
    row ``pos0 + s`` of every slot through every layer
    (:func:`_staged_attn` on each shard, ``llayers`` the per-layer
    adapter slices, None without adapters). Returns the logits [B,
    vocab] float32."""
    g = st.g
    x = _embed(g.params, tok, cfg.dtype)[:, None]
    cos, sin = llama.rope_frequencies(cfg, (st.pos0[0] + s)[:, None])
    coss, sins, valids, aids = map(g.rep, (cos, sin, stage_valid, aid))

    def attend(r, i, q, kk, v):
        return _staged_attn(g.caches[r], st.tables[r], q, kk, v, i, s,
                            st.stage[r], valids[r], span, st.pos0[r], plain)

    for i in range(cfg.n_layers):
        x = g.layer_step(cfg, i, x, coss, sins, attend,
                         llayers[i] if llayers else None, aids,
                         st.layers[i])
    return _decode_head(cfg, g, x)


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
    g = _Group(params, qweights, cache)
    st = _Staged(g, cfg, table, 1)
    valid = torch.ones((1, 1), dtype=torch.bool, device=st.pos0[0].device)
    return _staged_step(cfg, st, g.caches[0]["last_token"], 0, valid, span,
                        plain_attention, _lora_layers(cfg, lora), aid)


@torch.no_grad()
def decode_step(params: llama.Params, cache: Cache, cfg: llama.LlamaConfig,
                table: Optional[torch.Tensor] = None,
                span: Optional[int] = None, plain_attention: bool = False,
                qweights: Optional[QWeights] = None,
                lora: Optional[Dict] = None,
                aid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token for every slot: each slot's ``last_token`` enters at row
    ``length``. Returns the logits [slots, vocab] float32; every layer's
    pending K/V row is written at ``length`` once, after the layers (in
    place; :func:`commit_tokens` advances the lengths).

    Stored rows are strictly below ``length``; the pending token joins
    attention as a self-term, one more column whose score uses the
    values a read-back would see (quantized on an int8 cache), as in the
    reference. The big-cache block reads the first ``span`` rows (None:
    the full view): on a contiguous cache (``table`` None) through the
    reference's gather, one softmax over [cache | self]; on a paged cache
    through the paged-attention kernel (its plain version with
    ``plain_attention``), whose stats merge with the self-term by the
    online-softmax combine. ``qweights``: w8a8 products and head;
    ``lora``/``aid``: the adapter pool and each slot's pool slot."""
    g = _Group(params, qweights, cache)
    c0 = g.caches[0]
    B = c0["length"].shape[0]
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    scale = hd ** -0.5
    pos = c0["length"].clone()
    x = _embed(g.params, c0["last_token"], cfg.dtype)[:, None]
    cos, sin = llama.rope_frequencies(cfg, pos[:, None])
    coss, sins, poss, tables, aids = map(g.rep, (cos, sin, pos, table, aid))
    quant = "k_scale" in c0

    ys = [[] for _ in g.caches]

    def attend(r, i, q, k, v):
        """Shard r's attention of layer i over its kv heads; the step's
        rows as the cache stores them kept for the write after the
        layers."""
        c, dev = g.caches[r], g.devs[r]
        rows = _stored_rows(c, k[:, 0], v[:, 0])
        ys[r].append(rows)
        kq, vq, ksc, vsc = rows
        G = kq.shape[1]
        k_new = kq.to(torch.bfloat16)           # exact for int8 values
        v_new = vq.float()
        qh = q[:, 0].reshape(B, G, rep, hd).to(torch.bfloat16).contiguous()
        s_self = _bf16_dot("bgrk,bgk->bgr", qh, k_new) * scale
        if quant:
            v_new = v_new * vsc.float()[..., None]
            s_self = s_self * ksc.float()[:, :, None]
        if table is None:
            ck, cv, cks, cvs = _gather_kv_layer(c, i, span)
            valid = (torch.arange(ck.shape[1], device=dev)[None, :]
                     < poss[r][:, None])
            sm = _bf16_dot("bgrk,bmgk->bgrm", qh, ck) * scale
            if quant:
                sm = sm * cks.float()[:, :, None, :]
            sm = sm.masked_fill(~valid[:, None, None, :], NEG_INF)
            w = torch.softmax(torch.cat([sm, s_self[..., None]], dim=-1),
                              dim=-1)
            M = sm.shape[-1]
            wm, w_self = w[..., :M], w[..., M]
            if quant:
                wm = wm * cvs.float()[:, :, None, :]
            return (_bf16_dot("bgrm,bmgk->bgrk", wm, cv)
                    + w_self[..., None] * v_new[:, :, None, :])
        acc, m, l = _paged_attn_stats(c, i, tables[r], qh, poss[r], span,
                                      plain_attention)
        alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, s_self[..., None])
        return (acc * alpha[..., None]
                + w_s * v_new[:, :, None, :]) / l_tot[..., None]

    for i in range(cfg.n_layers):
        x = g.layer_step(cfg, i, x, coss, sins, attend,
                         adapters_lib.lora_layer(lora, i), aids)
    logits = _decode_head(cfg, g, x)
    for r, c in enumerate(g.caches):
        stacked = tuple(None if ys[r][0][j] is None
                        else torch.stack([row[j] for row in ys[r]])
                        for j in range(4))
        blk, off = _phys(c, tables[r], torch.arange(B, device=g.devs[r]),
                         poss[r].long())
        _write_rows(c, blk, off, stacked)
    return logits


@torch.no_grad()
def commit_tokens(cache: Cache, tokens: torch.Tensor,
                  active: torch.Tensor) -> None:
    """Append sampled tokens on active slots, in place: bump their
    lengths and set their pending tokens."""
    for c in sharding.shards_of(cache):
        dev = c["length"].device
        act = active.to(dev)
        c["length"] += act.to(torch.int32)
        c["last_token"].copy_(torch.where(
            act, tokens.to(dev, c["last_token"].dtype), c["last_token"]))


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
    g = _Group(params, qweights, cache)
    st = _Staged(g, cfg, table, k)
    dev = st.pos0[0].device
    last = g.caches[0]["last_token"].clone()
    llayers = _lora_layers(cfg, lora)
    toks = []
    for s in range(k):
        stage_valid = (torch.arange(k, device=dev) <= s)[None, :]
        logits = _staged_step(cfg, st, last, s, stage_valid, span,
                              plain_attention, llayers, aid)
        tok = sampling_mod.sample(logits, sp, generator)
        last = torch.where(active, tok, last)
        toks.append(tok)
    st.flush(k * active.to(torch.int32), last)
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
    through :func:`_staged_attn`, as a plain burst's steps do
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
    g = _Group(params, qweights, cache)
    W = k + 1
    st = _Staged(g, cfg, table, W)
    B = st.pos0[0].shape[0]
    dev = st.pos0[0].device
    c0 = g.caches[0]
    window = torch.cat([c0["last_token"][:, None], draft.long()], dim=1)
    llayers = _lora_layers(cfg, lora)
    toks = []
    for s in range(W):
        stage_valid = (torch.arange(W, device=dev) <= s)[None, :]
        toks.append(sampling_mod.argmax_tokens(_staged_step(
            cfg, st, window[:, s], s, stage_valid, span, plain_attention,
            llayers, aid)))
    toks = torch.stack(toks, dim=1)                    # [B, W]
    # Padding positions (>= n_draft) never match: a pad that equals the
    # argmax must not commit a token computed from a garbage input.
    match = ((toks[:, :k] == draft.long())
             & (torch.arange(k, device=dev)[None, :]
                < n_draft.long()[:, None]))
    n_match = match.int().cumprod(dim=1).sum(dim=1)
    n_commit = torch.where(active, n_match + 1,
                           torch.zeros_like(n_match)).int()
    last = toks[torch.arange(B, device=dev), n_match.long()]
    st.flush(n_commit, torch.where(active, last, c0["last_token"]))
    return toks, n_commit
