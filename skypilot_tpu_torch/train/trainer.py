"""The training step: loss, gradients, global-norm clip and AdamW.

Counterpart of ``skypilot_tpu/train/trainer.py`` on one card. The JAX
trainer chains ``optax.clip_by_global_norm`` and ``optax.adamw`` under
a warmup-cosine schedule; :func:`make_optimizer` writes that chain out
by hand so that the port's step follows optax 0.2.6 operation for
operation:

- clip: gradients stay as they are when ``||g|| < grad_clip``, else
  ``g / ||g|| * grad_clip`` (no epsilon);
- Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the
  count incremented before the bias correction, the update
  ``mu_hat / (sqrt(nu_hat) + 1e-8)`` from the uncast ``mu``; only the
  stored ``mu`` is cast to ``mu_dtype`` (with a bf16 ``mu``, ``b1`` is
  rounded to bf16 first, as JAX's weak-typed scalar is);
- weight decay on every parameter (norms and embeddings included);
- the learning rate of the pre-increment count, so step 0 moves
  nothing (the schedule starts at 0).

The state is ``{"params", "opt_state": {"count", "mu", "nu"}, "step"}``
with the parameters in the JAX package's stacked layout. The step
updates parameters and moments in place (the JAX step returns new
arrays); it says so in its docstring.

The step's metric families (``skytpu_train_*``), its ``train.step``
span and the compile watch around it are the reference's
(``skypilot_tpu/train/trainer.py``), under the same names, types,
labels and help. The histogram records the host-side step call: on the
card an eager step returns while its kernels may still be queued, and
the launch queue's back-pressure, not donated state, carries the call
toward the device step time (the help text is the reference's).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import metrics as obs_metrics
from skypilot_tpu_torch.observability import tracing

STEP_SECONDS = obs_metrics.histogram(
    "skytpu_train_step_seconds",
    "Train step call latency (back-pressured by donated state to the "
    "device step time at steady state)")
TRAIN_STEPS = obs_metrics.counter(
    "skytpu_train_steps_total", "Train steps dispatched")
TRAIN_TOKENS = obs_metrics.counter(
    "skytpu_train_tokens_total", "Tokens dispatched to train steps")
TRAIN_TOKENS_PER_S = obs_metrics.gauge(
    "skytpu_train_tokens_per_second",
    "Dispatch-rate tokens/s, EMA over recent steps")
TRAIN_LOSS = obs_metrics.gauge(
    "skytpu_train_loss",
    "Most recently fetched training loss (see observe_loss)")
# Step-time regression pair for the SLO watchdog: the trailing median
# is the baseline, and the watchdog compares the windowed mean
# (histogram sum/count delta) against it.
TRAIN_STEP_LAST = obs_metrics.gauge(
    "skytpu_train_step_last_seconds",
    "Most recent post-compile train step wall time")
TRAIN_STEP_MEDIAN = obs_metrics.gauge(
    "skytpu_train_step_median_seconds",
    "Trailing median of recent post-compile step times (SLO regression "
    "baseline)")
_MEDIAN_WINDOW = 101


def observe_loss(loss: float) -> None:
    """Record a fetched loss into the gauge. Called where the train
    loop already pays the host sync (its logging cadence) — the step
    wrapper itself never forces a device fetch."""
    TRAIN_LOSS.set(float(loss))


def batch_tokens(batch) -> int:
    """Tokens in a batch (the ``tokens`` tensor's size; 0 without one)."""
    tokens = batch.get("tokens") if hasattr(batch, "get") else None
    return int(tokens.numel()) if isinstance(tokens, torch.Tensor) else 0


def _instrument_step(step_fn: Callable) -> Callable:
    ema = {"rate": 0.0, "warm": False}
    recent = collections.deque(maxlen=_MEDIAN_WINDOW)

    @functools.wraps(step_fn)
    def wrapper(state, batch):
        t0 = time.monotonic()
        t0_wall = time.time()
        out = step_fn(state, batch)
        dt = max(time.monotonic() - t0, 1e-9)
        TRAIN_STEPS.inc()
        tokens = batch_tokens(batch)
        if tokens:
            TRAIN_TOKENS.inc(tokens)
        if not ema["warm"]:
            # The first call pays the first-dispatch costs (kernel
            # library loads, cuBLAS handles, allocator growth); seeding
            # the EMA or the histogram with it would poison both.
            ema["warm"] = True
            return out
        STEP_SECONDS.observe(dt)
        recent.append(dt)
        TRAIN_STEP_LAST.set(dt)
        TRAIN_STEP_MEDIAN.set(statistics.median(recent))
        # Per-step trace span (joins an ambient trace when the run was
        # launched with one; the first call is skipped like above).
        tracing.record_span("train.step", t0_wall, t0_wall + dt,
                            attrs={"tokens": tokens} if tokens else None)
        if tokens:
            rate = tokens / dt
            ema["rate"] = (rate if ema["rate"] == 0.0
                           else 0.9 * ema["rate"] + 0.1 * rate)
            TRAIN_TOKENS_PER_S.set(ema["rate"])
        return out

    return wrapper

TrainState = Dict[str, Any]
_MU_DTYPES = {None: None, "bfloat16": torch.bfloat16,
              "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # Storage dtype for Adam's first moment ("bfloat16" halves that
    # buffer). None keeps the params' dtype.
    mu_dtype: Optional[str] = None


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup,
    max(total, warmup + 1, 1), 0.1 lr)`` as a host function of the
    count, in float32 arithmetic in optax's order."""
    f32 = np.float32
    peak, end = tc.learning_rate, tc.learning_rate * 0.1
    warmup = tc.warmup_steps
    decay = max(tc.total_steps, warmup + 1, 1) - warmup
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            # linear_schedule(0, peak, warmup): (0 - peak) * frac + peak.
            c = min(max(count, 0), warmup)
            frac = f32(1) - f32(c) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay),
                                          dtype=f32))
        return float(f32(peak) * (f32(1 - alpha) * cos + f32(alpha)))

    return schedule


def _layer_leaves(tree, like=None) -> List[torch.Tensor]:
    """Leaves of a parameter-shaped tree in the key order of ``like``
    (default: the tree's own), so moments, gradients and parameters pair
    up by name; each stacked ``blocks`` tensor [L, ...] gives its L rows
    (views), the unit that autograd and the optimizer work in."""
    like = tree if like is None else like
    leaves = []
    for k in like:
        if k == "blocks":
            for n in like[k]:
                w = tree[k][n]
                leaves.extend(w[i] for i in range(w.shape[0]))
        else:
            leaves.append(tree[k])
    return leaves


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params, tc: TrainConfig) -> Dict[str, Any]:
    mu_dtype = _MU_DTYPES[tc.mu_dtype]
    return {"count": 0,
            "mu": _tree_map(lambda p: torch.zeros_like(
                p, dtype=mu_dtype or p.dtype), params),
            "nu": _tree_map(torch.zeros_like, params)}


def make_optimizer(tc: TrainConfig):
    """update(grads, opt_state, params) -> grad_norm: the clip + AdamW
    chain applied in place to the ``params`` tree and ``opt_state``.
    ``grads`` lists one gradient per entry of ``_layer_leaves(params)``
    (each layer's row of a stacked tensor on its own). Returns the
    global norm before clipping."""
    schedule = lr_schedule(tc)
    mu_dtype = _MU_DTYPES[tc.mu_dtype]
    b1, b2, wd = tc.beta1, tc.beta2, tc.weight_decay

    @torch.no_grad()
    def update(grads: List[torch.Tensor], opt_state: Dict[str, Any],
               params) -> torch.Tensor:
        mus = _layer_leaves(opt_state["mu"], params)
        nus = _layer_leaves(opt_state["nu"], params)
        g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = g_norm >= tc.grad_clip     # optax keeps g when g_norm < max
        count = opt_state["count"]
        count_inc = count + 1
        bc1 = 1 - np.float32(b1) ** np.float32(count_inc)
        bc2 = 1 - np.float32(b2) ** np.float32(count_inc)
        step = -np.float32(schedule(count))
        for g, mu, nu, p in zip(grads, mus, nus, _layer_leaves(params)):
            g = torch.where(clip, (g / g_norm) * tc.grad_clip, g)
            # As the JAX program computes it: b1 takes mu's dtype (a
            # weak-typed scalar; 0.9 -> 0.8984375 for a bf16 mu), the
            # product stays float32, and m itself is not cast.
            b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
            m = (1 - b1) * g + b1_mu * mu.float()
            nu.copy_((1 - b2) * g.square() + b2 * nu)
            u = (m / float(bc1)) / (torch.sqrt(nu / float(bc2)) + 1e-8)
            u = (u + wd * p) * float(step)
            p.add_(u)
            mu.copy_(m if mu_dtype is None else m.to(mu_dtype))
        opt_state["count"] = count_inc
        return g_norm

    return update


def create_train_state(cfg: llama.LlamaConfig, tc: TrainConfig,
                       device: DeviceLike = None,
                       seed: int = 0) -> TrainState:
    """Random ``cfg.param_dtype`` parameters from ``seed`` (drawn on
    ``device``), zero Adam moments, step 0."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama.init_params(cfg, gen, device=device)
    return {"params": params, "opt_state": init_opt_state(params, tc),
            "step": 0}


def train_state_from_numpy(jax_state: Dict[str, Any],
                           cfg: llama.LlamaConfig,
                           device: DeviceLike = None) -> TrainState:
    """A JAX train state with its leaves as numpy (``jax.tree.map(
    np.asarray, state)``) -> the port's. The optax chain's state is
    searched for its Adam entry (the one with ``count``, ``mu`` and
    ``nu``); mu keeps its dtype (bf16 under ``mu_dtype="bfloat16"``)."""
    device = resolve_device(device)

    def find_adam(node):
        if all(hasattr(node, a) for a in ("count", "mu", "nu")):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find_adam(child)
                if found is not None:
                    return found
        return None

    adam = find_adam(jax_state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":    # ml_dtypes: widen exactly
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    return {"params": llama.params_from_numpy(jax_state["params"], cfg,
                                              device=device),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": _tree_map(leaf, adam.mu),
                          "nu": _tree_map(leaf, adam.nu)},
            "step": int(np.asarray(jax_state["step"]))}


def _grad_leaves(params) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """Leaf tensors for autograd, in the order of ``_layer_leaves``: the
    unstacked parameters as they are, and each stacked block tensor as
    one leaf per layer (views of its rows), so a layer's backward writes
    its own gradient instead of adding a zero-padded copy of the whole
    stack."""
    leaves: List[torch.Tensor] = []

    def leaf(w):
        t = w.detach().requires_grad_()
        leaves.append(t)
        return t

    view = {}
    for k, w in params.items():
        if k == "blocks":
            view[k] = {n: [leaf(w[i]) for i in range(w.shape[0])]
                       for n, w in w.items()}
        else:
            view[k] = leaf(w)
    return view, leaves


def grads_of(params, batch: Dict[str, torch.Tensor], cfg: llama.LlamaConfig,
             attention: Optional[Callable] = None):
    """(loss, metrics, grads): grads lists one tensor per entry of
    ``_layer_leaves(params)``, a stacked tensor's gradient per layer."""
    view, leaves = _grad_leaves(params)
    loss, metrics = llama.loss_fn(view, batch, cfg, attention=attention)
    grads = list(torch.autograd.grad(loss, leaves))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _batch_key_fn(args: tuple, kwargs: dict):
    """Shape-derived program identity for the trainer's compile watch:
    a new batch shape dispatches programs the warm-up never ran (new
    kernel tiles, new allocator blocks), and a mid-run shape change is
    exactly the silent first dispatch ``train.unexpected_compile``
    exists to expose."""
    batch = args[1] if len(args) > 1 else kwargs.get("batch")
    parts = []
    if hasattr(batch, "items"):
        for k in sorted(batch):
            shape = getattr(batch[k], "shape", None)
            if shape is not None:
                parts.append((k, "x".join(str(d) for d in shape)))
    return parts


def make_train_step(cfg: llama.LlamaConfig, tc: TrainConfig,
                    watch=None) -> Callable:
    """step(state, batch) -> (state, metrics). The step UPDATES
    ``state`` IN PLACE (parameters, moments, count and step) and
    returns the same dict; metrics are 0-dim tensors ("loss",
    "accuracy", "tokens", "grad_norm" before clipping).

    The step is instrumented (the ``skytpu_train_*`` families and the
    ``train.step`` span, never a device fetch). ``watch`` is an
    optional ``flight.CompileWatch`` (the trainer's own, with
    ``event_name="train.unexpected_compile"``): the step is wrapped so
    every distinct batch-shape identity registers as a program, and a
    new one after warm-up emits the typed event."""
    update = make_optimizer(tc)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _, metrics, grads = grads_of(state["params"], batch, cfg)
        metrics["grad_norm"] = update(grads, state["opt_state"],
                                      state["params"])
        state["step"] += 1
        return state, metrics

    if watch is not None:
        step = watch.wrap("train_step", step, key_fn=_batch_key_fn)
    return _instrument_step(step)


def synthetic_batch(cfg: llama.LlamaConfig, batch_size: int, seq_len: int,
                    seed: int = 0, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Uniform random tokens from a numpy generator."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len),
                          dtype=np.int32)
    return {"tokens": torch.from_numpy(tokens).to(resolve_device(device))}
