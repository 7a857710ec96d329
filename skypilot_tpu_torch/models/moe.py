"""Sparse mixture-of-experts decoder (Mixtral-family proportions) in
PyTorch.

Counterpart of ``skypilot_tpu/models/moe.py``: a Llama block whose dense
FFN is a top-k expert FFN. Routing is the JAX module's
capacity-based dispatch through one-hot products (the Switch
formulation): each batch row gives every expert ``C`` slots
(:func:`expert_capacity`, a function of the row's length S), the
(token, choice) pairs claim them in position order, then choice rank,
and a pair past ``C`` is dropped (its combine weight is 0). The router
runs in float32; dispatch and combine are built in ``cfg.dtype``.

Parameters keep the JAX layout: per-layer tensors stacked on a leading
layer axis under the same names (``w_router [L, d, E]``, ``we_gate`` and
``we_up [L, E, d, ff]``, ``we_down [L, E, ff, d]``), so a JAX tree
converts one to one (:func:`params_from_numpy`).

Two deliberate differences from the JAX module: MoE does not run over a
mesh yet, so it has no ``constrain`` hook, and its zigzag layout hook
(``llama.sequence_layout``, as in the JAX forward) is the identity
until it does; and ``lax.top_k``'s order on ties
(the lower expert index first) is kept by a stable descending sort,
since ``torch.topk`` promises no order among equal values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import ring_attention

Params = llama.Params


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    """Llama-style decoder where every FFN is a sparse top-k MoE."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    def num_params(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        moe = self.n_experts * 3 * d * ff + d * self.n_experts
        norms = 2 * d
        per_layer = attn + moe + norms
        emb = v * d if self.tie_embeddings else 2 * v * d
        return self.n_layers * per_layer + emb + d

    def num_active_params(self) -> int:
        """Params touched per token (for MFU accounting of sparse FLOPs)."""
        d, ff = self.d_model, self.d_ff
        dense = super().num_params() - self.n_layers * 3 * d * ff
        return dense + self.n_layers * (self.top_k * 3 * d * ff
                                        + d * self.n_experts)


# The same keys and values as the JAX package's CONFIGS.
CONFIGS: Dict[str, MoEConfig] = {
    # Mixtral-8x7B proportions (32 layers, 8 experts, top-2).
    "mixtral-8x7b": MoEConfig(vocab_size=32_000, d_model=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, d_ff=14_336,
                              n_experts=8, top_k=2),
    "moe-small": MoEConfig(vocab_size=32_768, d_model=1024, n_layers=8,
                           n_heads=8, n_kv_heads=4, d_ff=4096,
                           n_experts=8, top_k=2, max_seq_len=4096),
    "moe-tiny": MoEConfig(vocab_size=512, d_model=128, n_layers=2,
                          n_heads=4, n_kv_heads=2, d_ff=256,
                          n_experts=4, top_k=2, max_seq_len=256),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: MoEConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters (the JAX init's distributions) drawn from
    ``generator``, which must live on ``device``; ``dtype`` defaults to
    ``cfg.param_dtype`` (serving passes ``cfg.dtype``)."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    d, ff, v, L, E = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers,
                      cfg.n_experts)
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
        return w.mul_(std)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    params: Params = {
        "embed": normal((v, d), 0.02),
        "blocks": {
            "ln1": ones((L, d)),
            "ln2": ones((L, d)),
            "wq": normal((L, d, nh, hd), d ** -0.5),
            "wk": normal((L, d, nkv, hd), d ** -0.5),
            "wv": normal((L, d, nkv, hd), d ** -0.5),
            "wo": normal((L, nh, hd, d), (nh * hd) ** -0.5),
            "w_router": normal((L, d, E), d ** -0.5),
            "we_gate": normal((L, E, d, ff), d ** -0.5),
            "we_up": normal((L, E, d, ff), d ** -0.5),
            "we_down": normal((L, E, ff, d), ff ** -0.5),
        },
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v), d ** -0.5)
    return params


# A JAX parameter tree (numpy leaves) -> the port's tensors, copied one
# to one: llama's converter walks any nested tree.
params_from_numpy = llama.params_from_numpy


# ---------------------------------------------------------------------------
# The expert FFN
# ---------------------------------------------------------------------------

def expert_capacity(cfg: MoEConfig, seq_len: int) -> int:
    """Per-expert per-row token capacity (static)."""
    cap = math.ceil(cfg.capacity_factor * cfg.top_k * seq_len / cfg.n_experts)
    return max(int(cap), 1)


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values, equal
    values in index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: MoEConfig, h: torch.Tensor, w_router: torch.Tensor):
    """The router (float32) and the capacity assignment. h: [B, S, D].
    Returns (probs [B, S, E], gate_vals [B, S, K] renormalised over the
    k choices, gate_idx [B, S, K], keep [B, S, K, E] int64: 1 where the
    (token, choice) pair holds a slot of its expert, pos [B, S, K, E]:
    its slot in that expert's buffer, 0-based)."""
    B, S, _ = h.shape
    E, K = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, S)
    probs = torch.softmax(h.float() @ w_router.float(), dim=-1)
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(
        dim=-1, keepdim=True).clamp_min(1e-9)
    # Priority: position first, then choice rank. The cumulative sum over
    # each row's flattened (S, K) axis gives each pair its slot in the
    # chosen expert's buffer; a slot >= C drops the pair.
    expert_mask = F.one_hot(gate_idx, E)
    flat = expert_mask.reshape(B, S * K, E)
    pos = (flat.cumsum(dim=1) - flat).reshape(B, S, K, E)
    keep = expert_mask * (pos < C)
    return probs, gate_vals, gate_idx, keep, pos


def moe_ffn(cfg: MoEConfig, h: torch.Tensor,
            layer: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-dispatched expert FFN. h: [B, S, D] (post-norm).
    Returns (out [B, S, D] in h's dtype, aux loss, a float32 scalar)."""
    E, C, dt = cfg.n_experts, expert_capacity(cfg, h.shape[1]), cfg.dtype

    probs, gate_vals, gate_idx, keep, pos = route(cfg, h,
                                                  layer["w_router"])

    # Aux load-balancing loss (Switch-style, over first choices). f_e:
    # the share of tokens whose first choice is e; p_e: the mean router
    # probability of e. Balanced routing gives E * sum(f p) = 1.
    f = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (f * probs.mean(dim=(0, 1))).sum()

    # Dispatch and combine, in cfg.dtype.
    gates = gate_vals[..., None] * keep                         # [B,S,K,E]
    # one_hot(pos, C): a slot >= C (a dropped pair) is all zeros.
    pos_oh = (pos[..., None] == torch.arange(C, device=h.device)).to(dt)
    dispatch = (keep[..., None].to(dt) * pos_oh).sum(dim=2)     # [B,S,E,C]
    combine = (gates[..., None].to(dt) * pos_oh).sum(dim=2)

    # Expert compute.
    xe = torch.einsum("bsd,bsec->becd", h, dispatch)            # [B,E,C,D]
    g = torch.einsum("becd,edf->becf", xe, layer["we_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", xe, layer["we_up"].to(dt))
    y = torch.einsum("becf,efd->becd", F.silu(g) * u,
                     layer["we_down"].to(dt))
    out = torch.einsum("becd,bsec->bsd", y, combine)            # [B,S,D]
    return out, aux.float()


def decoder_layer(cfg: MoEConfig, x: torch.Tensor, layer: Params,
                  cos: torch.Tensor, sin: torch.Tensor,
                  attention: Optional[Callable] = None,
                  segment_ids: Optional[torch.Tensor] = None):
    """One pre-norm MoE decoder block: llama's attention half, then the
    expert FFN. Returns (x', aux)."""
    x, _, _ = llama.attention_block(cfg, x, layer, cos, sin, attention,
                                    segment_ids)
    h = llama.rms_norm(x, layer["ln2"], cfg.norm_eps)
    m, aux = moe_ffn(cfg, h, layer)
    return x + m, aux


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                   *, positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   attention: Optional[Callable] = None,
                   constrain: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (final-norm hidden [B, S, D], aux loss summed
    over the layers and divided by their number). ``positions`` and
    ``segment_ids`` [B, S]: packed sequences, as in
    ``llama.forward_hidden``. With ``cfg.remat`` and grad enabled each
    layer runs under ``llama.remat``, its aux an output of the
    checkpointed block. ``constrain`` carries the mesh and rules the
    zigzag layout reads (``llama.sequence_layout``); without one the
    layout is the identity."""
    S = tokens.shape[1]
    x = F.embedding(tokens, params["embed"].to(cfg.dtype))
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    x, positions, segment_ids, attention, use_zigzag, n_sp = \
        llama.sequence_layout(x, positions, segment_ids, attention,
                              constrain)
    cos, sin = llama.rope_frequencies(cfg, positions)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = llama.remat(cfg, decoder_layer, cfg, x,
                             llama.layer_slice(params, i), cos, sin,
                             attention, segment_ids)
        aux_sum = aux_sum + aux
    if use_zigzag:
        x = ring_attention.zigzag_unpermute(x, n_sp)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_sum / cfg.n_layers


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] ids -> (logits [B, S, vocab] float32, mean aux loss). The
    head product in ``cfg.dtype``, then widened, as in the JAX module."""
    with torch.no_grad():
        x, aux = forward_hidden(params, tokens, cfg)
        head = llama.lm_head(params, cfg).to(cfg.dtype)
        return (x @ head).float(), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: MoEConfig,
            attention: Optional[Callable] = None):
    """Next-token cross-entropy plus ``aux_loss_weight`` times the aux
    load-balancing loss; honours ``cfg.xent_chunk`` through llama's
    ``xent_metrics``. Returns (loss, {"loss", "xent", "aux_loss",
    "accuracy", "tokens"})."""
    tokens = batch["tokens"]
    h, aux = forward_hidden(params, tokens, cfg,
                            positions=batch.get("positions"),
                            segment_ids=batch.get("segment_ids"),
                            attention=attention)
    xent, acc, denom = llama.xent_metrics(
        params, h, tokens, llama.packed_loss_mask(batch), cfg)
    loss = xent + cfg.aux_loss_weight * aux
    return loss, {"loss": loss, "xent": xent, "aux_loss": aux,
                  "accuracy": acc, "tokens": denom}
