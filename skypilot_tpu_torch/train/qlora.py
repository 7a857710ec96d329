"""QLoRA fine-tuning: LoRA adapters over a frozen int8 base.

Counterpart of ``skypilot_tpu/train/qlora.py`` on one card. The base
lives on the card as int8 weights with per-output-channel float32
scales (``infer/kvcache.py``'s layout: each weight stored output-major,
``int8_layout``), about 7.5 GB at llama3-8b; each product dequantizes
its layer's weight (``w * s``, then the activation dtype) and the
adapters ride as separate low-rank products beside it:

    y = x @ dequant(Wq) + (alpha/r) * (x @ A) @ B

Only A and B get gradients; backprop flows through the dequantized
products, which are linear in x (the w8a8 serving path's activation
rounding would zero them). The dequantized weights, the adapters'
products and the head are plain matrix products (``torch.matmul``), as
the reference leaves them to XLA; attention goes through
``ops/attention.gqa_attention``: K2 forward, K3 and K4 in the backward.

The layers run one by one; under ``cfg.remat`` each runs under
``torch.utils.checkpoint`` with the model's policy (``llama.remat``,
the reference's ``lax.scan`` under ``jax.checkpoint``), so only the
layer being recomputed holds its dequantized weights. The head is
dequantized once per step, outside the cross-entropy's chunks.

The train state is LoRA's (``train/lora.py``): one definition, so a
``--qlora --resume`` restores what a fresh run creates. The reference's
zigzag layout hook (``ra.apply_zigzag_layout``) is
``llama.sequence_layout`` here: QLoRA trains on one card (as in the
reference), where the layout is the identity.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from skypilot_tpu_torch import DeviceLike
from skypilot_tpu_torch.infer import kvcache
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import ring_attention
from skypilot_tpu_torch.ops import attention as attn_ops
from skypilot_tpu_torch.train import lora, trainer
from skypilot_tpu_torch.train.lora import LoRAConfig

Params = Dict[str, Any]


def dequant_weight(qw: Dict[str, torch.Tensor], n_contract: int,
                   dtype) -> torch.Tensor:
    """int8 ``{w, s}`` -> a ``dtype`` weight of ``w``'s shape. ``s``
    spans the output dims (``w``'s trailing ``ndim - n_contract``) and
    broadcasts over the contracted ones; the product is float32, then
    cast, as the reference's. The result keeps ``w``'s output-major
    strides, so the products' 2-D views of it are views, not copies.
    Linear in ``w`` and constant under grad."""
    return (qw["w"] * qw["s"][(None,) * n_contract]).to(dtype)


def _matmul(x: torch.Tensor, w: torch.Tensor, n_contract: int
            ) -> torch.Tensor:
    """x's trailing ``n_contract`` dims against ``w``'s leading ones, as
    one product over 2-D views."""
    lead = x.shape[:x.dim() - n_contract]
    k = w.shape[:n_contract].numel()
    y = x.reshape(*lead, k) @ w.reshape(k, -1)
    return y.reshape(*lead, *w.shape[n_contract:])


def _lora_in(h: torch.Tensor, ab: Dict[str, torch.Tensor], scale: float
             ) -> torch.Tensor:
    """Delta of an embed -> heads/kv projection. h: [B, S, D]; a [D, r],
    b [r, H, hd], cast to h's dtype."""
    u = h @ ab["a"].to(h.dtype)
    return scale * _matmul(u, ab["b"].to(h.dtype), 1)


def _lora_out(o: torch.Tensor, ab: Dict[str, torch.Tensor], scale: float
              ) -> torch.Tensor:
    """Delta of the heads -> embed (wo) projection. o: [B, S, H, hd]; a
    [H, hd, r], b [r, D], cast to o's dtype."""
    u = _matmul(o, ab["a"].to(o.dtype), 2)
    return scale * (u @ ab["b"].to(o.dtype))


def _qdecoder_layer(cfg: llama.LlamaConfig, lc: LoRAConfig,
                    x: torch.Tensor, qlayer: Params, norms: Params,
                    adapters: Params, cos: torch.Tensor, sin: torch.Tensor,
                    attention: Callable,
                    segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """One pre-norm decoder block off int8 weights + factored LoRA."""
    dt = cfg.dtype

    def proj(name, h, n_contract):
        return _matmul(h, dequant_weight(qlayer[name], n_contract, dt),
                       n_contract)

    h = llama.rms_norm(x, norms["ln1"], cfg.norm_eps)
    q = proj("wq", h, 1)
    k = proj("wk", h, 1)
    v = proj("wv", h, 1)
    sc = lc.scale
    if "wq" in adapters:
        q = q + _lora_in(h, adapters["wq"], sc)
    if "wk" in adapters:
        k = k + _lora_in(h, adapters["wk"], sc)
    if "wv" in adapters:
        v = v + _lora_in(h, adapters["wv"], sc)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)
    if segment_ids is None:
        o = attention(q, k, v)
    else:
        o = attention(q, k, v, segment_ids=segment_ids)
    y = proj("wo", o, 2)
    if "wo" in adapters:
        y = y + _lora_out(o, adapters["wo"], sc)
    x = x + y

    h = llama.rms_norm(x, norms["ln2"], cfg.norm_eps)
    g = proj("w_gate", h, 1)
    u = proj("w_up", h, 1)
    m = (F.silu(g) * u) @ dequant_weight(qlayer["w_down"], 1, dt)
    return x + m


def forward_hidden(qweights: Params, fp_params: Params, adapters: Params,
                   tokens: torch.Tensor, cfg: llama.LlamaConfig,
                   lc: LoRAConfig, positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   attention: Optional[Callable] = None,
                   constrain: Optional[Callable] = None) -> torch.Tensor:
    """Token ids [B, S] -> final-norm hidden states, int8 base.

    ``fp_params`` is the slim tree (embed + norms,
    ``kvcache.slim_params``' layout); ``qweights["blocks"]`` the stacked
    int8 block weights. ``attention`` defaults to
    ``attn_ops.gqa_attention`` (the kernels on the card). ``constrain``
    carries the mesh and rules the zigzag layout reads
    (``llama.sequence_layout``); without one the layout is the
    identity."""
    S = tokens.shape[1]
    x = F.embedding(tokens, fp_params["embed"].to(cfg.dtype))
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    x, positions, segment_ids, attention, use_zigzag, n_sp = \
        llama.sequence_layout(x, positions, segment_ids, attention,
                              constrain)
    if attention is None:
        attention = attn_ops.gqa_attention
    cos, sin = llama.rope_frequencies(cfg, positions)
    blocks = fp_params["blocks"]
    for i in range(cfg.n_layers):
        norms = {"ln1": blocks["ln1"][i], "ln2": blocks["ln2"][i]}
        ab = {t: {"a": p["a"][i], "b": p["b"][i]}
              for t, p in adapters.items()}
        x = llama.remat(cfg, _qdecoder_layer, cfg, lc, x,
                        kvcache.qlayer_slice(qweights, i), norms, ab, cos,
                        sin, attention, segment_ids)
    if use_zigzag:
        x = ring_attention.zigzag_unpermute(x, n_sp)
    return llama.rms_norm(x, fp_params["final_norm"], cfg.norm_eps)


def loss_fn(qweights: Params, fp_params: Params, adapters: Params,
            batch: Dict[str, torch.Tensor], cfg: llama.LlamaConfig,
            lc: LoRAConfig, attention: Optional[Callable] = None):
    """Next-token cross-entropy off the int8 base + adapters: (loss,
    {"loss", "accuracy", "tokens"}), 0-dim float32 tensors."""
    tokens = batch["tokens"]
    h = forward_hidden(qweights, fp_params, adapters, tokens, cfg, lc,
                       positions=batch.get("positions"),
                       segment_ids=batch.get("segment_ids"),
                       attention=attention)
    head = dequant_weight(qweights["head"], 1, cfg.dtype)
    loss, acc, denom = llama.xent_metrics(
        fp_params, h, tokens, llama.packed_loss_mask(batch), cfg, head=head)
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def make_qlora_train_step(cfg: llama.LlamaConfig, lc: LoRAConfig,
                          tc: trainer.TrainConfig) -> Callable:
    """step(state, qweights, fp_params, batch) -> (state, metrics). The
    step UPDATES ``state`` IN PLACE, as ``lora.make_lora_train_step``
    does; the int8 base and the slim float tree are frozen inputs."""
    update = trainer.make_optimizer(tc)

    def step(state, qweights, fp_params, batch):
        _, metrics, grads = trainer.value_and_grads(
            state["params"],
            lambda a: loss_fn(qweights, fp_params, a, batch, cfg, lc))
        metrics["grad_norm"] = update(grads, state["opt_state"],
                                      state["params"])
        state["step"] += 1
        return state, metrics

    return step


def create_qlora_state(cfg: llama.LlamaConfig, lc: LoRAConfig,
                       tc: trainer.TrainConfig, device: DeviceLike = None,
                       seed: int = 0) -> trainer.TrainState:
    """The adapter train state is LoRA's (``lora.create_lora_state``)."""
    return lora.create_lora_state(cfg, lc, tc, device, seed)
