"""Vision Transformer (ViT) classifier in PyTorch.

Counterpart of ``skypilot_tpu/models/vit.py``: patchify -> encoder stack
-> class-token head, with the JAX module's parameter layout (per-layer
tensors stacked on a leading layer axis under the same names, so a JAX
tree converts one to one through :func:`params_from_numpy`) and its
arithmetic: layer norm statistics in float32, GELU in its tanh form
(``jax.nn.gelu``'s default), bidirectional attention through the flash
kernels (``gqa_attention(causal=False)``, every head its own kv-head),
per-layer remat.

Plugs into ``train/trainer.py`` through ``model=vit`` (``init_params``,
``params_from_numpy``, ``loss_fn``); a batch is ``{"images": [B, H, W,
C] float, "labels": [B] int}``.

One deliberate difference: the flash kernels take head dims 32, 64 and
128, so ``vit-tiny`` (head dim 16) runs on the CPU only and raises on
the card (``vit-s16`` and ``vit-b16`` have head dim 64).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attn_ops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    channels: int = 3
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "none"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        attn = 4 * d * d
        mlp = 2 * d * ff + ff + d      # weights + b_up + b_down
        per_layer = attn + mlp + 4 * d  # + ln scales/biases
        patch = self.patch_size ** 2 * self.channels * d + d
        return (self.n_layers * per_layer + patch
                + (self.n_patches + 1) * d        # pos emb
                + 3 * d                           # cls token + final ln
                + d * self.num_classes + self.num_classes)


# The same keys and values as the JAX package's CONFIGS.
CONFIGS: Dict[str, ViTConfig] = {
    "vit-b16": ViTConfig(),
    "vit-s16": ViTConfig(d_model=384, n_layers=12, n_heads=6, d_ff=1536),
    "vit-tiny": ViTConfig(image_size=32, patch_size=8, num_classes=10,
                          d_model=64, n_layers=2, n_heads=4, d_ff=128),
}


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters (the JAX init's distributions) drawn from
    ``generator``, which must live on ``device``; ``dtype`` defaults to
    ``cfg.param_dtype``."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    p = cfg.patch_size ** 2 * cfg.channels

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
        return w.mul_(std)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "patch_embed": normal((p, d), p ** -0.5),
        "patch_bias": zeros((d,)),
        "pos_embed": normal((cfg.n_patches + 1, d), 0.02),
        "cls_token": zeros((d,)),
        "blocks": {
            "ln1": ones((L, d)),
            "ln1_b": zeros((L, d)),
            "wqkv": normal((L, d, 3, cfg.n_heads, cfg.head_dim), d ** -0.5),
            "wo": normal((L, cfg.n_heads, cfg.head_dim, d), d ** -0.5),
            "ln2": ones((L, d)),
            "ln2_b": zeros((L, d)),
            "w_up": normal((L, d, ff), d ** -0.5),
            "b_up": zeros((L, ff)),
            "w_down": normal((L, ff, d), ff ** -0.5),
            "b_down": zeros((L, d)),
        },
        "final_ln": ones((d,)),
        "final_ln_b": zeros((d,)),
        "head": normal((d, cfg.num_classes), d ** -0.5),
        "head_b": zeros((cfg.num_classes,)),
    }


# A JAX parameter tree (numpy leaves) -> the port's tensors, copied one
# to one: llama's converter walks any nested tree.
params_from_numpy = llama.params_from_numpy


def _layer_norm(x, scale, bias, eps):
    """Statistics in float32, the normalized values cast back to x's
    dtype, then scale and bias applied in that dtype."""
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(dtype) * scale.to(dtype) + bias.to(dtype)


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_patches, p*p*C] (unfold, no convolution)."""
    B, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def _bidirectional(q, k, v):
    return attn_ops.gqa_attention(q, k, v, causal=False)


def encoder_layer(cfg: ViTConfig, x: torch.Tensor, layer: Params,
                  attention: Optional[Callable] = None) -> torch.Tensor:
    """One pre-norm encoder block. ``attention(q, k, v)`` defaults to
    bidirectional attention through the flash kernels."""
    attention = attention or _bidirectional
    dt = cfg.dtype
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = _layer_norm(x, layer["ln1"], layer["ln1_b"], cfg.norm_eps)
    # "bsd,dthk->tbshk": q, k and v each come out as a contiguous
    # [B, S, H, hd] slice (the flash kernels take contiguous rows).
    qkv = (h @ layer["wqkv"].to(dt).reshape(d, 3 * H * hd)).reshape(
        B, S, 3, H, hd).permute(2, 0, 1, 3, 4).contiguous()
    o = attention(qkv[0], qkv[1], qkv[2])
    x = x + llama.project_out(o, layer["wo"].to(dt))
    h = _layer_norm(x, layer["ln2"], layer["ln2_b"], cfg.norm_eps)
    u = h @ layer["w_up"].to(dt) + layer["b_up"].to(dt)
    m = (F.gelu(u, approximate="tanh") @ layer["w_down"].to(dt)
         + layer["b_down"].to(dt))
    return x + m


def forward(params: Params, images: torch.Tensor, cfg: ViTConfig,
            attention: Optional[Callable] = None) -> torch.Tensor:
    """[B, H, W, C] float images -> logits [B, num_classes] float32."""
    dt = cfg.dtype
    x = patchify(images.to(dt), cfg)
    x = x @ params["patch_embed"].to(dt) + params["patch_bias"].to(dt)
    cls = params["cls_token"].to(dt).expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dt)
    for i in range(cfg.n_layers):
        x = llama.remat(cfg, encoder_layer, cfg, x,
                        llama.layer_slice(params, i), attention)
    x = _layer_norm(x, params["final_ln"], params["final_ln_b"],
                    cfg.norm_eps)
    logits = x[:, 0] @ params["head"].to(dt) + params["head_b"].to(dt)
    return logits.float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ViTConfig,
            attention: Optional[Callable] = None):
    """Softmax cross-entropy. batch: {"images", "labels"}. Returns (loss,
    {"loss", "accuracy", "tokens"}); ``tokens`` is the batch size."""
    logits = forward(params, batch["images"], cfg, attention)
    labels = batch["labels"].long()
    logps = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logps, -1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc,
                  "tokens": torch.tensor(float(labels.shape[0]),
                                         device=logits.device)}


def synthetic_batch(cfg: ViTConfig, batch_size: int, seed: int = 0,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Standard-normal images and uniform labels from a numpy generator."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch_size, cfg.image_size, cfg.image_size, cfg.channels),
        dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, (batch_size,), dtype=np.int32)
    device = resolve_device(device)
    return {"images": torch.from_numpy(images).to(device),
            "labels": torch.from_numpy(labels).to(device)}
