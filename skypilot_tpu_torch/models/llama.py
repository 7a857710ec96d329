"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``skypilot_tpu/models/llama.py``. Parameters keep the
JAX package's layout: per-layer weights are stacked on a leading layer
axis (``wq [L, d, nh, hd]``, ``wo [L, nh, hd, d]``, ...) under the same
names, so a JAX parameter tree converts one to one
(:func:`params_from_numpy`). Where JAX ran the layers as one
``lax.scan``, the port runs a Python loop over the stacked tensors.

Serving stores the weights in ``cfg.dtype`` (bf16): the JAX programs
cast fp32 parameters with ``.astype(cfg.dtype)`` inside every program,
and storing the cast result gives the same numbers without re-casting
the weights on every step. Training (:func:`loss_fn`) keeps
``cfg.param_dtype`` parameters and casts them in every step, as the JAX
package does; the trainer (``train/trainer.py``) holds them.

Over a device mesh (``parallel/``) the parameters are DTensors laid out
by :func:`param_logical_axes` and the functions take a ``constrain``
(``sharding.make_constrain``), which lays activations out at the
reference's points, as its ``with_sharding_constraint`` calls do; with
no mesh it is the identity and the one-card path runs as before. Its
mesh and rules also pick the attention: ring attention where the
sequence is split (sp), the zigzag layout where the rules ask for it
(``parallel/ring_attention.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.ops import attention as attn_ops
from skypilot_tpu_torch.parallel import ring_attention, sharding

Params = Dict[str, Any]

# The trainer runs this model over a device mesh (``parallel/``).
RUNS_ON_MESH = True


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model hyperparameters (Llama-3 family proportions)."""

    vocab_size: int = 128_256
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16       # activation / compute dtype
    param_dtype: Any = torch.float32  # storage dtype for parameters
    remat: bool = True
    remat_policy: str = "none"
    xent_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        """Exact parameter count."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        mlp = 3 * d * ff
        norms = 2 * d
        per_layer = attn + mlp + norms
        emb = v * d if self.tie_embeddings else 2 * v * d
        return self.n_layers * per_layer + emb + d


# The same keys and values as the JAX package's CONFIGS.
CONFIGS: Dict[str, LlamaConfig] = {
    "llama3-8b": LlamaConfig(vocab_size=128_256, d_model=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, d_ff=14_336),
    "llama3-70b": LlamaConfig(vocab_size=128_256, d_model=8192,
                              n_layers=80, n_heads=64, n_kv_heads=8,
                              d_ff=28_672, max_seq_len=8192),
    "llama3-1b": LlamaConfig(vocab_size=128_256, d_model=2048, n_layers=16,
                             n_heads=16, n_kv_heads=8, d_ff=8192),
    "llama3-tiny": LlamaConfig(vocab_size=512, d_model=128, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=256,
                               max_seq_len=256),
    "llama3-400m": LlamaConfig(vocab_size=32_768, d_model=1536, n_layers=12,
                               n_heads=12, n_kv_heads=4, d_ff=6144,
                               max_seq_len=4096),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters (the JAX init's distributions) drawn from
    ``generator``, which must live on ``device``. ``dtype`` defaults to
    ``cfg.param_dtype``; serving passes ``cfg.dtype`` so an 8B model is
    drawn straight into 16 GB of bf16."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
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
            "w_gate": normal((L, d, ff), d ** -0.5),
            "w_up": normal((L, d, ff), d ** -0.5),
            "w_down": normal((L, ff, d), ff ** -0.5),
        },
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v), d ** -0.5)
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """A JAX parameter tree (nested dicts of numpy arrays, bf16 arrays
    included) -> the port's tensors, copied one to one. ``dtype``
    defaults to ``cfg.param_dtype``."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(val) for k, val in x.items()}
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":     # ml_dtypes: widen exactly
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(
            device=device, dtype=dtype)

    return conv(tree)


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Logical axis names per parameter, same tree structure as params.

    Names are resolved to mesh axes by
    ``parallel.sharding.logical_to_sharding``."""
    axes: Params = {
        "embed": ("vocab", "embed"),
        "blocks": {
            "ln1": ("layer", "embed"),
            "ln2": ("layer", "embed"),
            "wq": ("layer", "embed", "heads", "head_dim"),
            "wk": ("layer", "embed", "kv_heads", "head_dim"),
            "wv": ("layer", "embed", "kv_heads", "head_dim"),
            "wo": ("layer", "heads", "head_dim", "embed"),
            "w_gate": ("layer", "embed", "mlp"),
            "w_up": ("layer", "embed", "mlp"),
            "w_down": ("layer", "mlp", "embed"),
        },
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


class Llama(nn.Module):
    """The model as a module: the stacked parameter tensors under the
    JAX names (``embed``, ``blocks.{ln1,ln2,wq,wk,wv,wo,w_gate,w_up,
    w_down}``, ``final_norm``, ``lm_head``) and :func:`forward`."""

    def __init__(self, cfg: LlamaConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.blocks = nn.ParameterDict(
            {k: nn.Parameter(w, requires_grad=False)
             for k, w in params["blocks"].items()})
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"],
                                        requires_grad=False)

    def params(self) -> Params:
        """The nested-dict view the functional code takes."""
        out: Params = {"embed": self.embed,
                       "blocks": dict(self.blocks.items()),
                       "final_norm": self.final_norm}
        if hasattr(self, "lm_head"):
            out["lm_head"] = self.lm_head
        return out

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * scale.to(dtype)


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables for rotary embeddings. positions: [B, S] or [S]."""
    hd = cfg.head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [B, S, hd/2] or [S, hd/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _seq_split(x: torch.Tensor) -> bool:
    """A DTensor whose sequence dim (1) is split over a mesh axis."""
    return isinstance(x, DTensor) and any(
        getattr(p, "dim", None) == 1 for p in x.placements
        if p.is_shard())


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, n]. Where the sequence is split over a mesh
    (sp), a batched product: DTensor's rule for ``x @ w`` folds B and S
    into one dim, split over two mesh axes, and plans that layout by a
    graph search that takes minutes an operator; ``bmm`` keeps the two
    dims apart."""
    if x.dim() == 3 and _seq_split(x):
        return torch.bmm(x, w.unsqueeze(0).expand(x.shape[0], -1, -1))
    return x @ w


def project_in(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bsd,dhk->bshk": h [B, S, d] @ w [d, H, hd] -> [B, S, H, hd]."""
    d, H, hd = w.shape
    return matmul(h, w.reshape(d, H * hd)).reshape(*h.shape[:-1], H, hd)


def project_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bshk,hkd->bsd": o [B, S, H, hd] @ w [H, hd, d] -> [B, S, d]."""
    H, hd, d = w.shape
    return matmul(o.reshape(*o.shape[:-2], H * hd), w.reshape(H * hd, d))


def ffn(h: torch.Tensor, layer: Params, dtype) -> torch.Tensor:
    """Dense SwiGLU FFN. h: [B, S, D]."""
    g = matmul(h, layer["w_gate"].to(dtype))
    u = matmul(h, layer["w_up"].to(dtype))
    return matmul(F.silu(g) * u, layer["w_down"].to(dtype))


def layer_slice(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked block tensors (views, no copies)."""
    return {k: w[i] for k, w in params["blocks"].items()}


def lm_head(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits(x: torch.Tensor, params: Params, cfg: LlamaConfig,
           constrain: Callable = sharding.identity) -> torch.Tensor:
    """Hidden states [..., D] in ``cfg.dtype`` -> float32 logits. The
    head's ``cfg.dtype`` values are multiplied and summed in float32
    and the result is not rounded back: the JAX programs round their
    logits to bf16, which at |logit| ~ 4 leaves a resolution of 1/32
    and ties that greedy decoding breaks by token id."""
    head = lm_head(params, cfg).to(cfg.dtype)
    return constrain(matmul(x.float(), head.float()),
                     ("batch", "seq", "vocab"))


def attention_block(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                    cos: torch.Tensor, sin: torch.Tensor,
                    attention: Optional[Callable] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    constrain: Callable = sharding.identity):
    """A block's attention half: x + wo(attention(rope(q), rope(k), v)).
    Returns (x', k, v) with the post-rope k and v rows [B, S, Hkv, hd].
    ``attention(q, k, v)`` defaults to causal grouped-query attention
    through the flash kernels; with ``segment_ids`` [B, S] it is called
    with ``segment_ids=`` as well (packed documents). The llama and MoE
    blocks share it."""
    if attention is None:
        attention = attn_ops.gqa_attention
    dt = cfg.dtype
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    q = apply_rope(project_in(h, layer["wq"].to(dt)), cos, sin)
    k = apply_rope(project_in(h, layer["wk"].to(dt)), cos, sin)
    v = project_in(h, layer["wv"].to(dt))
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    if segment_ids is None:
        o = attention(q, k, v)
    else:
        o = attention(q, k, v, segment_ids=segment_ids)
    o = project_out(o, layer["wo"].to(dt))
    return x + constrain(o, ("batch", "seq", "embed")), k, v


def decoder_layer(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
                  cos: torch.Tensor, sin: torch.Tensor,
                  attention: Optional[Callable] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  constrain: Callable = sharding.identity):
    """One pre-norm decoder block. x: [B, S, D] -> (x', k, v), with the
    layer's post-rope k and v rows [B, S, Hkv, hd] (what prefill
    caches); ``attention``, ``segment_ids`` and ``constrain`` as in
    :func:`attention_block`."""
    x, k, v = attention_block(cfg, x, layer, cos, sin, attention,
                              segment_ids, constrain)
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
    return x + constrain(ffn(h, layer, cfg.dtype),
                         ("batch", "seq", "embed")), k, v


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the output of every 2-D matrix product (``aten.mm``: the
    weight projections, whose activations fold into rows), recompute
    everything else, the attention ``autograd.Function`` and its batched
    products included: JAX's ``dots_with_no_batch_dims_saveable``."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: LlamaConfig, fn: Callable, *args):
    """``fn(*args)`` under per-layer ``torch.utils.checkpoint`` when
    ``cfg.remat`` is set and grad is enabled, else called as it is.
    ``cfg.remat_policy`` "none" keeps only the inputs (JAX's
    ``nothing_saveable``); "dots" keeps the 2-D products' outputs too
    (:func:`_dots_policy`). The llama and QLoRA forwards share it."""
    if cfg.remat_policy not in ("none", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"expected 'none' or 'dots'")
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   *, positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   attention: Optional[Callable] = None,
                   constrain: Optional[Callable] = None) -> torch.Tensor:
    """Token ids [B, S] -> final-norm hidden states [B, S, D].

    ``positions`` [B, S] and ``segment_ids`` [B, S] enable packed
    sequences (rope restarts per document, attention stays inside a
    document; see ``data/input_pipeline.py``). With ``cfg.remat`` and
    grad enabled, each layer runs under ``torch.utils.checkpoint`` with
    ``cfg.remat_policy`` (:func:`remat`): the backward recomputes what
    the policy did not keep. ``attention`` is passed to
    :func:`decoder_layer`. ``constrain`` lays out activations over a
    mesh (module docstring); it also lays out the token ids, positions,
    segment ids and rope tables, so every tensor a layer (and its
    recompute) sees is a DTensor. Where its rules split the sequence
    (sp), attention is ring attention, and with ``seq_layout: zigzag``
    the sequence runs in the zigzag layout (:func:`sequence_layout`),
    permuted once here and back before the final norm."""
    if constrain is None:
        constrain = sharding.identity
    S = tokens.shape[1]
    tokens = constrain(tokens, ("batch", "seq"))
    # The lookup-friendly table layout: vocab sharded, embed whole.
    table = constrain(params["embed"].to(cfg.dtype), ("vocab", "embed"))
    # F.embedding: a deterministic backward on the card (a sort, no
    # atomics), so a resumed run repeats an uninterrupted one bit for bit.
    x = constrain(_lookup(tokens, table), ("batch", "seq", "embed"))
    if positions is None:
        positions = torch.arange(S, device=x.device)
    x, positions, segment_ids, attention, use_zigzag, n_sp = sequence_layout(
        x, positions, segment_ids, attention, constrain)
    if positions.dim() == 1:
        cos, sin = (constrain(t, ("seq", None))
                    for t in rope_frequencies(cfg, positions))
    else:
        cos, sin = _rope_tables(cfg, constrain(positions, ("batch", "seq")))
    if segment_ids is not None:
        segment_ids = constrain(segment_ids, ("batch", "seq"))
    for i in range(cfg.n_layers):
        x = remat(cfg, _layer_hidden, cfg, x, layer_slice(params, i), cos,
                  sin, attention, segment_ids, constrain)
    if use_zigzag:
        x = constrain(ring_attention.zigzag_unpermute(x, n_sp),
                      ("batch", "seq", "embed"))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def sequence_layout(x, positions, segment_ids, attention, constrain):
    """The zigzag sequence layout over a mesh (``constrain.mesh`` and
    ``constrain.rules``; ``ring_attention.apply_zigzag_layout``): the
    activations, positions and segment ids permuted once, and the
    attention dispatched by the rules the layout leaves (the layout key
    dropped where it does not apply). Without a mesh, or without the
    layout key, everything comes back as it was. Returns ``(x,
    positions, segment_ids, attention, use_zigzag, n_sp)``; the llama,
    MoE and QLoRA forwards share it."""
    mesh = getattr(constrain, "mesh", None)
    rules = getattr(constrain, "rules", None)
    if mesh is None:
        return x, positions, segment_ids, attention, False, 1
    (x, positions, segment_ids, layer_rules, use_zigzag,
     n_sp) = ring_attention.apply_zigzag_layout(x, positions, segment_ids,
                                                mesh, rules)
    if attention is None:
        attention = functools.partial(attn_ops.gqa_attention,
                                      rules=layer_rules)
    return x, positions, segment_ids, attention, use_zigzag, n_sp


def _rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """:func:`rope_frequencies` of [B, S] positions; over a mesh, each
    rank's rows from its own positions, in their layout."""
    if not isinstance(positions, DTensor):
        return rope_frequencies(cfg, positions)
    return tuple(DTensor.from_local(t, positions.device_mesh,
                                    positions.placements, run_check=False)
                 for t in rope_frequencies(cfg, positions.to_local()))


def _lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if isinstance(table, DTensor):      # over a mesh: the vocab split
        return sharding.embedding(tokens, table)
    return F.embedding(tokens, table)


def _layer_hidden(cfg, x, layer, cos, sin, attention, segment_ids,
                  constrain=sharding.identity):
    return decoder_layer(cfg, x, layer, cos, sin, attention, segment_ids,
                         constrain)[0]


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, vocab] (float32)."""
    return logits(forward_hidden(params, tokens, cfg), params, cfg)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: LlamaConfig,
            attention: Optional[Callable] = None,
            constrain: Optional[Callable] = None):
    """Next-token cross-entropy. batch: {"tokens": [B, S] int, optionally
    "mask": [B, S] (1 = predict this position's next token),
    "positions" and "segment_ids" [B, S] (packed)}. Returns (loss,
    {"loss", "accuracy", "tokens"}), all 0-dim float32 tensors (DTensors
    over a mesh). ``constrain`` as in :func:`forward_hidden`."""
    constrain = constrain or sharding.identity
    batch = {k: constrain(v, ("batch", "seq")) for k, v in batch.items()}
    tokens = batch["tokens"]
    h = forward_hidden(params, tokens, cfg,
                       positions=batch.get("positions"),
                       segment_ids=batch.get("segment_ids"),
                       attention=attention, constrain=constrain)
    loss, acc, denom = xent_metrics(params, h, tokens,
                                    packed_loss_mask(batch), cfg,
                                    constrain=constrain)
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def packed_loss_mask(batch: Dict[str, torch.Tensor]):
    """Loss mask honoring packed segments: only within-document
    next-token transitions count (the last token of each segment has no
    target). Returns batch["mask"] unchanged when not packed."""
    mask = batch.get("mask")
    seg = batch.get("segment_ids")
    if seg is None:
        return mask
    same_next = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)
    seg_mask = F.pad(same_next, (0, 1))     # the last position: False
    return seg_mask if mask is None else mask * seg_mask.to(mask.dtype)


def _chunk_xent(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                m: torch.Tensor, constrain: Callable = sharding.identity):
    """Summed log-likelihood and correct predictions of one chunk: the
    head product in the activation dtype, then float32."""
    logits = constrain(matmul(h, head), ("batch", "seq", "vocab")).float()
    logps = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logps, -1, targets[..., None])[..., 0]
    correct = (_argmax(logits) == targets).to(m.dtype)
    return (ll * m).sum(), (correct * m).sum()


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """Each row's argmax over the last dim, the first of ties (as
    ``jnp.argmax``). Over a mesh it is the first index that reaches the
    row's ``amax``: where the vocab is split that costs two [B, c]
    all-reduces (max and min), while DTensor's own argmax over a split
    vocab miscomputes its gather's shape on a mesh of several dims."""
    if not isinstance(logits, DTensor):
        return logits.argmax(dim=-1)
    V = logits.shape[-1]
    mesh = logits.device_mesh
    iota = DTensor.from_local(
        torch.arange(V, dtype=torch.float32, device=logits.device), mesh,
        [Replicate()] * mesh.ndim, run_check=False)
    top = logits == logits.amax(dim=-1, keepdim=True)
    return torch.where(top, iota, float(V)).amin(dim=-1).long()


def xent_metrics(params: Params, h: torch.Tensor, tokens: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: LlamaConfig,
                 head: Optional[torch.Tensor] = None,
                 constrain: Callable = sharding.identity):
    """LM head + next-token cross-entropy over final-norm hidden states
    h [B, S, D]. Returns (loss, accuracy, denom). As in the JAX package,
    the head product is taken in ``cfg.dtype`` and then widened to
    float32 (serving's :func:`logits` multiplies in float32 instead).
    ``head`` overrides the [D, V] head matrix (QLoRA passes its
    dequantized head: the slim tree has no float one).

    With ``cfg.xent_chunk`` > 0 the sequence is cut into chunks padded
    with masked positions, and each chunk's [B, c, vocab] logits are
    recomputed in the backward (``torch.utils.checkpoint``), so the
    full logits tensor never exists. ``constrain`` lays each chunk's
    logits out over a mesh (vocab over tp), as the reference does.
    Where the sequence is split over sp, h keeps its rows in place and
    the targets shift instead; with chunks, h's rows are gathered once
    (the chunks slice the sequence)."""
    head = (lm_head(params, cfg) if head is None else head).to(cfg.dtype)
    B, S = tokens.shape
    if _seq_split(h):
        # The sequence split over sp: h keeps its S rows (S - 1 would
        # not split evenly), the targets shift left with the last
        # position masked, and the ids are gathered whole (a few bytes a
        # token) to shift them.
        targets = F.pad(sharding.whole(tokens)[:, 1:].long(), (0, 1))
        m = (torch.ones((B, S - 1), dtype=torch.float32, device=h.device)
             if mask is None else sharding.whole(mask)[:, :-1].float())
        # Chunks slice the sequence: then its rows are gathered once.
        lay = ("batch", None) if cfg.xent_chunk else ("batch", "seq")
        targets = constrain(targets, lay)
        m = constrain(F.pad(m, (0, 1)), lay)
        if cfg.xent_chunk:
            h = h.redistribute(h.device_mesh, [
                Replicate() if p.is_shard() and p.dim == 1 else p
                for p in h.placements])
    else:
        targets = tokens[:, 1:].long()
        m = (torch.ones((B, S - 1), dtype=torch.float32, device=h.device)
             if mask is None else mask[:, :-1].float())
        m = constrain(m, ("batch", "seq"))
        h = h[:, :-1]
    c = cfg.xent_chunk
    if not c:
        ll_sum, correct = _chunk_xent(h, head, targets, m, constrain)
    else:
        pad = (-h.shape[1]) % c
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad))
            m = F.pad(m, (0, pad))
        ll_sum = correct = torch.zeros((), dtype=torch.float32,
                                       device=h.device)
        for i in range(0, h.shape[1], c):
            part = (h[:, i:i + c], head, targets[:, i:i + c], m[:, i:i + c],
                    constrain)
            if torch.is_grad_enabled():
                ll, ok = checkpoint(_chunk_xent, *part, use_reentrant=False)
            else:
                ll, ok = _chunk_xent(*part)
            ll_sum = ll_sum + ll
            correct = correct + ok
    denom = m.sum().clamp_min(1.0)
    return -ll_sum / denom, correct / denom, denom
