"""LoRA fine-tuning: low-rank adapters over frozen base weights.

Counterpart of ``skypilot_tpu/train/lora.py`` on one card. The model
code is untouched: each step merges the adapters into a derived weight
tree (``w + (alpha/r) * A @ B`` on the targeted projections), so the
forward runs the base model's code (and its attention kernels) while
gradients reach only A and B. Optimizer state exists only for the
adapters: the train state is the dense trainer's ``{"params",
"opt_state": {"count", "mu", "nu"}, "step"}`` over the adapter tree
``{target: {"a": [L, d_in..., r], "b": [L, r, d_out...]}}``, updated in
place by ``trainer.make_optimizer``'s chain (optax's clip and AdamW,
weight decay on the adapters too: the reference passes no mask).

The step merges one layer at a time (:func:`merged_layers`): the
merged weights are per-layer tensors, so a layer's backward writes its
own gradient instead of a zero-padded copy of the whole stack;
:func:`merge` builds the reference's stacked tree from the same
products.

Not ported now: the mesh and sharding functions
(``lora_state_shardings``, ``base_param_shardings``, ``lora_logical_axes``
and the sharded branch of ``make_lora_train_step``). They wait for the
port's mesh (``parallel/*``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import trainer

Params = Dict[str, Any]

# Adapter geometry, the reference's single source of truth: per target,
# the base weight's (input axes, output axes) after the leading layer
# axis.
_TARGETS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "wq": (("embed",), ("heads", "head_dim")),
    "wk": (("embed",), ("kv_heads", "head_dim")),
    "wv": (("embed",), ("kv_heads", "head_dim")),
    "wo": (("heads", "head_dim"), ("embed",)),
}


def _dim(cfg: llama.LlamaConfig, axis: str) -> int:
    return {"embed": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim}[axis]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f"LoRA rank must be positive, got {self.rank}")
        for t in self.targets:
            if t not in _TARGETS:
                raise ValueError(f"unknown LoRA target {t!r}; "
                                 f"supported: {sorted(_TARGETS)}")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _shapes(cfg: llama.LlamaConfig, lc: LoRAConfig
            ) -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Per target, the stacked (a, b) shapes."""
    L = cfg.n_layers
    out = {}
    for t in lc.targets:
        in_axes, out_axes = _TARGETS[t]
        in_dims = tuple(_dim(cfg, a) for a in in_axes)
        out_dims = tuple(_dim(cfg, a) for a in out_axes)
        out[t] = ((L, *in_dims, lc.rank), (L, lc.rank, *out_dims))
    return out


def init_lora_params(cfg: llama.LlamaConfig, lc: LoRAConfig,
                     generator: torch.Generator,
                     device: DeviceLike = None) -> Params:
    """A ~ N(0, 1/d_in), B = 0, float32, drawn from ``generator`` (on
    ``device``) target by target: the adapted model equals the base
    model at init. The draws are torch's, not JAX's."""
    device = resolve_device(device)
    adapters: Params = {}
    for t, (a_shape, b_shape) in _shapes(cfg, lc).items():
        d_in = math.prod(a_shape[1:-1])
        a = torch.randn(a_shape, generator=generator, device=device,
                        dtype=torch.float32)
        adapters[t] = {"a": a * (d_in ** -0.5),
                       "b": torch.zeros(b_shape, dtype=torch.float32,
                                        device=device)}
    return adapters


def _delta(t: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B for one target, stacked ([L, ...]) or one layer's: the
    reference's einsums ``ldr,lrhk->ldhk`` and ``lhkr,lrd->lhkd``."""
    if len(_TARGETS[t][0]) == 1:
        return torch.einsum("...dr,...rhk->...dhk", a, b)
    return torch.einsum("...hkr,...rd->...hkd", a, b)


def merge(base: Params, adapters: Params, lc: LoRAConfig) -> Params:
    """base params + scaled A@B deltas on the targeted projections, cast
    to the base weights' dtype (a new tree; the base is untouched)."""
    blocks = dict(base["blocks"])
    for t, ab in adapters.items():
        delta = lc.scale * _delta(t, ab["a"], ab["b"])
        blocks[t] = blocks[t] + delta.to(blocks[t].dtype)
    return {**base, "blocks": blocks}


def merged_layers(base: Params, adapters: Params, lc: LoRAConfig) -> Params:
    """:func:`merge` one layer at a time: each targeted block weight
    becomes a list of per-layer merged tensors (``llama.layer_slice``
    reads either form)."""
    blocks = dict(base["blocks"])
    for t, ab in adapters.items():
        w = blocks[t]
        blocks[t] = [w[i] + (lc.scale * _delta(t, ab["a"][i], ab["b"][i])
                             ).to(w.dtype) for i in range(w.shape[0])]
    return {**base, "blocks": blocks}


def loss_fn(adapters: Params, base_params: Params,
            batch: Dict[str, torch.Tensor], cfg: llama.LlamaConfig,
            lc: LoRAConfig, attention: Optional[Callable] = None):
    """The base model's loss (``llama.loss_fn``) over the merged
    weights: (loss, {"loss", "accuracy", "tokens"})."""
    return llama.loss_fn(merged_layers(base_params, adapters, lc), batch,
                         cfg, attention=attention)


def create_lora_state(cfg: llama.LlamaConfig, lc: LoRAConfig,
                      tc: trainer.TrainConfig, device: DeviceLike = None,
                      seed: int = 0) -> trainer.TrainState:
    """Fresh adapters from ``seed`` (drawn on ``device``), zero Adam
    moments, step 0."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    adapters = init_lora_params(cfg, lc, gen, device)
    return {"params": adapters,
            "opt_state": trainer.init_opt_state(adapters, tc), "step": 0}


def lora_state_from_numpy(jax_state: Dict[str, Any],
                          device: DeviceLike = None) -> trainer.TrainState:
    """A JAX LoRA train state with its leaves as numpy (``jax.tree.map(
    np.asarray, state)``) -> the port's (float32 adapters; the Adam
    entry of the optax chain, ``trainer.opt_state_from_numpy``)."""
    device = resolve_device(device)
    adapters = {t: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                    for k, v in ab.items()}
                for t, ab in jax_state["params"].items()}
    return {"params": adapters,
            "opt_state": trainer.opt_state_from_numpy(
                jax_state["opt_state"], device),
            "step": int(np.asarray(jax_state["step"]))}


def make_lora_train_step(cfg: llama.LlamaConfig, lc: LoRAConfig,
                         tc: trainer.TrainConfig) -> Callable:
    """step(state, base_params, batch) -> (state, metrics). The step
    UPDATES ``state`` IN PLACE (adapters, moments, count and step) and
    returns the same dict; metrics are 0-dim tensors ("loss",
    "accuracy", "tokens", "grad_norm" before clipping). The base
    parameters are a frozen input: no gradient, never written."""
    update = trainer.make_optimizer(tc)

    def step(state, base_params, batch):
        _, metrics, grads = trainer.value_and_grads(
            state["params"],
            lambda a: loss_fn(a, base_params, batch, cfg, lc))
        metrics["grad_norm"] = update(grads, state["opt_state"],
                                      state["params"])
        state["step"] += 1
        return state, metrics

    return step


def num_trainable_params(cfg: llama.LlamaConfig, lc: LoRAConfig) -> int:
    return sum(math.prod(a) + math.prod(b)
               for a, b in _shapes(cfg, lc).values())
